"""The bf16 attention backward's plan, the plain backwards at its tile
edges, and B4's chain as the card runs it, on the CPU.

``attention_bwd_plan`` (ops/block_attention.py) is the tiling that
csrc/attention_bwd.cuh's launcher mirrors: every query row and every key
must be owned by exactly one CTA of each kernel and streamed in exactly one
chunk, and a CTA must fit its shared memory. The kernel itself runs only on
the card (tests/test_torch_kernels.py::
test_attention_backward_packed_every_head_dim_and_tail and
test_attention_backward_flash_every_head_dim_and_tail).

The plain backwards the ops take on a CPU tensor are held to the JAX
package's Pallas backwards in interpret mode at the shapes where the
kernel's 64-row tiles and 64-key chunks end: 64 and 128 (whole tiles), 65
and 129 (a one-row tail), 99 (one ragged tile) and 257, at head dims 16, 32
and 64, and a cross-attention with nq ≠ nk both ways. B4's chain
(``_attn_half_bwd_chain``: dattn and dyln on the dyln product, which reads
the weights as they lie) runs with the launchers' plain stand-ins and is
held to ``_attn_half_bwd_defused``. float32 at atol 2e-5 / rtol 1e-4 for the
attention cores (the same sums in another order) and at the atol 5e-4 /
rtol 1e-3 of tests/test_flash_attention.py for the half-block, whose
parameter grads sum over every row.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mirage_tpu.ops.block_attention import (_attn_half_bwd_defused,
                                            _block_attn_bwd)
from mirage_tpu.ops.flash_attention import flash_attention_bwd_interpret
from mirage_tpu_torch.nn.attention import sdpa
from mirage_tpu_torch.nn.layers import layer_norm
from mirage_tpu_torch.ops import block_attention as ba
from mirage_tpu_torch.ops import runtime
from mirage_tpu_torch.ops.flash_attention import flash_attention_bwd_ref

TOL = dict(atol=2e-5, rtol=1e-4)
HALF_TOL = dict(atol=5e-4, rtol=1e-3)
SIZES = [1, 64, 65, 99, 128, 129, 257, 512, 769, 1025]
SHAPES = [(n, n) for n in SIZES] + [(256, 769), (70, 1100), (530, 64),
                                     (1, 35)]


@pytest.mark.parametrize("dh", [16, 32, 48, 64, 80, 96, 112, 128])
@pytest.mark.parametrize("nq,nk", SHAPES)
def test_plan_covers_every_query_and_key_once(dh, nq, nk):
    plan = ba.attention_bwd_plan(nq, nk, dh, 3, 2, 132)
    assert plan.dq_grid == (len(plan.query_tiles), 3, 2)
    assert plan.dkv_grid == (len(plan.key_tiles), 3, 2)
    for n, spans, step in [(nq, plan.query_tiles, 64),
                           (nk, plan.key_tiles, 64),
                           (nk, plan.key_chunks, 64),
                           (nq, plan.query_chunks, 64 if dh <= 64 else 32)]:
        rows = np.zeros(n, int)
        for i, (row0, count) in enumerate(spans):
            assert row0 == i * step and 0 < count <= step
            assert count == step or i == len(spans) - 1
            rows[row0:row0 + count] += 1
        assert (rows == 1).all()
    chunks = len(plan.key_chunks)
    assert plan.resident == (chunks <= plan.dq_stages)
    assert plan.dq_loads == (chunks if plan.resident else 2 * chunks)
    assert 2 <= plan.dq_stages <= 8 and 2 <= plan.dkv_stages <= 8
    assert max(plan.dq_smem_bytes, plan.dkv_smem_bytes) \
        <= ba.SMEM_PER_BLOCK
    assert plan.ctas_per_sm >= 2
    assert plan.box_cols * plan.boxes >= dh > plan.box_cols * (plan.boxes - 1)
    assert plan.swizzle_bytes == 2 * plan.box_cols in (32, 64, 128)
    assert plan.pv_width >= dh and plan.products == 7
    assert not plan.head_kernel and plan.head_grid is None


@pytest.mark.parametrize("dh", [16, 32, 48, 64, 80, 128])
@pytest.mark.parametrize("n", [1, 64, 99, 128, 129, 257])
def test_plan_takes_short_packed_heads_in_one_launch(dh, n):
    """The packed form at up to 128 tokens and head dims up to 64 is one
    persistent launch over the (batch, head) items, one CTA an SM."""
    plan = ba.attention_bwd_plan(n, n, dh, 12, 256, 132, packed=True)
    head = n <= 128 and dh <= 64
    assert plan.head_kernel == head
    assert plan.head_grid == ((132,) if head else None)
    assert plan.products == (5 if head else 7)
    if head:
        assert plan.head_smem_bytes <= ba.SMEM_PER_BLOCK
        assert ba.attention_bwd_plan(n, n, dh, 2, 3, 132,
                                     packed=True).head_grid == (6,)


@pytest.mark.parametrize("args,kw", [
    ((99, 99, 8, 12, 2), {}), ((99, 99, 24, 12, 2), {}),
    ((99, 99, 144, 12, 2), {}), ((0, 99, 64, 12, 2), {}),
    ((99, 0, 64, 12, 2), {}), ((99, 99, 64, 0, 2), {}),
    ((99, 99, 64, 12, 0), {}), ((513, 513, 64, 12, 2), {"packed": True}),
    ((99, 100, 64, 12, 2), {"packed": True})])
def test_plan_refuses_what_the_kernel_does_not_take(args, kw):
    with pytest.raises(ValueError):
        ba.attention_bwd_plan(*args, 132, **kw)
    with pytest.raises(ValueError):
        ba.attention_bwd_plan(99, 99, 64, 12, 2, 0)


def test_plan_mirrors_the_kernel_source():
    """The constants and per-dh layout the plan assumes are the header's."""
    src = (Path(__file__).resolve().parents[1] / "mirage_tpu_torch" / "csrc"
           / "attention_bwd.cuh").read_text()
    for pattern in (
            r"constexpr int ROWS = 64;", r"constexpr int THREADS = 128;",
            r"constexpr int KC = 64;",
            r"constexpr int SMEM_BUDGET = 72 \* 1024;",
            r"BOXC = \(DH == 16 \|\| DH == 32\) \? DH : 64;",
            r"QC = NPV <= 64 \? 64 : 32;",
            r"DQ_FIT = \(SMEM_BUDGET - 1024 - 2 \* TILE\) / \(2 \* TILE\);",
            r"KV_FIT = \(SMEM_BUDGET - 1024 - 2 \* TILE\) / \(2 \* QTILE\);",
            r"DQ_STAGES = DQ_FIT < 2 \? 2 : DQ_FIT > 8 \? 8 : DQ_FIT;",
            r"KV_STAGES = KV_FIT < 2 \? 2 : KV_FIT > 8 \? 8 : KV_FIT;",
            r"DQ_SMEM = 1024 \+ \(2 \+ 2 \* DQ_STAGES\) \* TILE \+ "
            r"8 \* \(2 \* DQ_STAGES \+ 1\);",
            r"KV_SMEM = 1024 \+ 2 \* TILE \+ 2 \* KV_STAGES \* QTILE \+ "
            r"8 \* \(2 \* KV_STAGES \+ 1\);",
            r"const bool resident = nch <= S;",
            r"constexpr int HEAD_ROWS = 2 \* ROWS;",
            r"constexpr int PLANE = HEAD_ROWS \* 128;",
            r"constexpr int HEAD_BUFS = 3;",
            r"P_IN_KV = 4 \* Geom<DH>::TILE >= 2 \* PLANE;",
            r"1024 \+ HEAD_BUFS \* INPUT \+ \(P_IN_KV \? 2 : 4\) \* PLANE \+ "
            r"8 \* HEAD_BUFS;",
            r"INPUT = 8 \* Geom<DH>::TILE;",
            r"static_assert\(G::NPV <= 64,",
            r"if \(stats && nq == nk && nq <= HEAD_ROWS\)",
            r"std::max\(1, std::min\(batch \* heads, sm_count\(\)\)\)",
            r"const dim3 grid_q\(\(nq \+ ROWS - 1\) / ROWS, heads, batch\);",
            r"dim3\(\(nk \+ ROWS - 1\) / ROWS, heads, batch\)"):
        assert re.search(pattern, src), pattern
    assert (ba.ATTN_BWD_ROWS, ba.ATTN_BWD_KEYS, ba.ATTN_BWD_THREADS,
            ba.ATTN_BWD_SMEM_BUDGET, ba.ATTN_BWD_HEAD_ROWS,
            ba.ATTN_BWD_PLANE, ba.ATTN_BWD_HEAD_BUFS) == (
                64, 64, 128, 72 * 1024, 128, 128 * 128, 3)
    for dh, box, dq_stages, dkv_stages in [(16, 16, 8, 8), (32, 32, 7, 7),
                                           (48, 64, 3, 3), (64, 64, 3, 3),
                                           (96, 64, 2, 2), (128, 64, 2, 2)]:
        plan = ba.attention_bwd_plan(257, 257, dh, 1, 1, 132)
        assert (plan.box_cols, plan.dq_stages, plan.dkv_stages) == \
            (box, dq_stages, dkv_stages)
    # the one launch: three buffers of Q, dO, K, V, T(dS) apart, T(P) in
    # the K and V tiles from head dim 48
    for dh, smem in [(16, 1024 + 3 * 16384 + 4 * 16384 + 24),
                     (32, 1024 + 3 * 32768 + 4 * 16384 + 24),
                     (64, 1024 + 3 * 65536 + 2 * 16384 + 24)]:
        assert ba.attention_bwd_plan(99, 99, dh, 1, 1, 132,
                                     packed=True).head_smem_bytes == smem


def _heads(x, h):
    b, n, d = x.shape
    return x.reshape(b, n, h, d // h).transpose(0, 2, 1, 3)


@pytest.mark.parametrize("dh", [16, 32, 64])
@pytest.mark.parametrize("n", [64, 65, 99, 128, 129, 257])
def test_packed_backward_at_tile_edges_matches_jax(n, dh):
    """B4's and B6's attention core: block_attention_bwd_ref against the
    JAX Pallas backward in interpret mode."""
    rng = np.random.default_rng(n * 3 + dh)
    b, h = 1, 2
    qkv = rng.standard_normal((b, n, 3 * h * dh)).astype(np.float32)
    dy = rng.standard_normal((b, n, h * dh)).astype(np.float32)
    scale = dh ** -0.5
    got = ba.block_attention_bwd_ref(torch.from_numpy(qkv),
                                     torch.from_numpy(dy), h, scale)
    want = _block_attn_bwd(jnp.asarray(qkv), jnp.asarray(dy), h, scale,
                           interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("nq,nk,dh", [(65, 65, 16), (129, 129, 32),
                                      (257, 257, 64), (65, 257, 64),
                                      (257, 99, 32)])
def test_flash_backward_at_tile_edges_matches_jax(nq, nk, dh):
    """B8's backward, self and cross (nq ≠ nk both ways):
    flash_attention_bwd_ref against flash_attention_bwd_interpret."""
    rng = np.random.default_rng(nq + 7 * nk + dh)
    b, h = 1, 2
    q, do = (rng.standard_normal((b, h, nq, dh)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.standard_normal((b, h, nk, dh)).astype(np.float32)
            for _ in range(2))
    scale = dh ** -0.5
    got = flash_attention_bwd_ref(*(torch.from_numpy(t) for t in (q, k, v, do)),
                                  scale)
    want = flash_attention_bwd_interpret(*(jnp.asarray(t) for t in
                                           (q, k, v, do)), scale)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def _plain_launchers(monkeypatch):
    """The launchers B4's chain calls, replaced by plain float32 PyTorch
    with the same signatures and layouts, so the chain's own wiring (which
    weight goes where, as it lies, in which type) runs on the CPU."""
    def attention(q, k, v, out, *, heads, dh, scale):
        # q, k, v are column windows: their first heads·dh columns
        o = sdpa(*(torch.from_numpy(_heads(
            t[..., :heads * dh].contiguous().numpy(), heads))
            for t in (q, k, v)), scale)
        out.copy_(o.transpose(1, 2).reshape(out.shape))

    def attention_bwd(qkv, dout, *, heads, dh, scale, partials=False):
        dqkv = ba.block_attention_bwd_ref(qkv, dout, heads, scale)
        b, n, w = dqkv.shape
        pad = torch.zeros(b, -(-n // 16) * 16 - n, w)
        part = torch.cat([dqkv, pad], 1).reshape(b, -1, 16, w).sum(2)
        return dqkv, part.reshape(-1, w)

    def layernorm_bwd(x2, ln_w, dyln, dy2):
        return ba.ln_bwd_ref(x2, dyln, ln_w, dy2)

    for name, fn in {
            "layernorm": lambda x, w, b: layer_norm(x, w, b),
            "gemm": lambda a, w, bias=None: a @ w.t() + (
                0 if bias is None else bias),
            "attention": attention,
            "mlp_bwd_dyln": lambda dh, w, out_dtype=torch.float32: (
                dh @ w).to(out_dtype),
            "attention_bwd": attention_bwd,
            "layernorm_bwd": layernorm_bwd}.items():
        monkeypatch.setattr(runtime, name, fn)


@pytest.mark.parametrize("b,n,d,h", [(2, 65, 64, 4), (1, 129, 64, 2)])
def test_b4_chain_matches_jax_kernel(monkeypatch, b, n, d, h):
    """_attn_half_bwd_chain as the card runs it (dattn = T(dy·Wproj) and
    dyln = dqkv·Wqkv, each weight read as it lies), with plain launchers,
    against _attn_half_bwd_defused in interpret mode, float32."""
    rng = np.random.default_rng(n + d + h)
    f = np.float32
    x, dy = (rng.standard_normal((b, n, d)).astype(f) for _ in range(2))
    g = (1 + 0.1 * rng.standard_normal(d)).astype(f)
    be = (0.05 * rng.standard_normal(d)).astype(f)
    wqkv = (rng.standard_normal((d, 3 * d)) / np.sqrt(d)).astype(f)
    bqkv = (0.02 * rng.standard_normal(3 * d)).astype(f)
    wp = (rng.standard_normal((d, d)) / np.sqrt(d)).astype(f)
    _plain_launchers(monkeypatch)
    t = torch.from_numpy
    dx, y, dqkv, attn, dy2, dgamma, dbeta, dbqkv = ba._attn_half_bwd_chain(
        t(x), t(dy), t(g), t(be), t(wqkv.T.copy()), t(bqkv), t(wp.T.copy()),
        h)
    got = [dx, dgamma, dbeta, (dqkv.t() @ y).t(),
           dbqkv.sum(0), (dy2.t() @ attn).t(), dy2.sum(0)]
    want = _attn_half_bwd_defused(
        jnp.asarray(x), jnp.asarray(dy), g, be, wqkv, bqkv, wp, h,
        (d // h) ** -0.5, interpret=True)
    names = ["dx", "dgamma", "dbeta", "dwqkv", "dbqkv", "dwproj", "dbproj"]
    for name, gg, ww in zip(names, got, want):
        ww = np.asarray(ww)
        np.testing.assert_allclose(gg.numpy().reshape(ww.shape), ww,
                                   err_msg=name, **HALF_TOL)
