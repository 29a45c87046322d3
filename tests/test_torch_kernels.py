"""The PyTorch port's CUDA kernels against their plain PyTorch versions.

Every test here needs a CUDA card (marked ``gpu``; each skips without one).
The file imports neither JAX nor the JAX package, so it also runs where JAX
is not installed; ``tests/conftest.py`` imports JAX, so on such a machine
run it without the conftest:

    python -m pytest -m gpu --noconftest -p no:cacheprovider tests/test_torch_kernels.py

float32 runs the FMA kernels against float32 math (atol 1e-4: the same sums
in another order); bf16 runs the tensor-core kernels against the plain
version computed in float32 from the same bf16 inputs (the kernels round
intermediates to bf16, 8 significant bits, as the TPU kernels do).
"""

import functools
import math
from collections import Counter

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mirage_tpu_torch.ops import runtime
from mirage_tpu_torch.ops.block_attention import (attn_half_block,
                                                  attn_half_block_ref,
                                                  xattn_half_block,
                                                  xattn_half_block_ref)
from mirage_tpu_torch.ops.fused_mlp import mlp_block, mlp_block_ref

pytestmark = pytest.mark.gpu

DTYPES = [(torch.float32, 1e-4), (torch.bfloat16, 5e-2)]

# the C entries each op's chain launches (runtime.launch_counts): B1's LN,
# qkv GEMM, attention and proj GEMM; B4's recompute, its two dyln products
# (dattn and dyln), the attention backward and the LN backward (its weight
# gradients are cuBLAS products); B5's LN, hidden stage, dyln and LN
# backward; B9's stash forward and its backward less its two products
B1 = Counter(layernorm=1, gemm=2, attention=1)
B4 = Counter(layernorm=1, gemm=1, attention=1, mlp_bwd_dyln=2,
             attention_bwd=1, layernorm_bwd=1)
B5 = Counter(layernorm=1, mlp_bwd_hidden=1, mlp_bwd_dyln=1, layernorm_bwd=1)
B9_FWD = Counter(layernorm=1, gemm_stash=1, gemm=1)
B9_BWD = Counter(layernorm=1, layernorm_bwd=1, wgrad=2, colsum=2)
# the LN stage of a bench half in each mode (block_attention.ln_mode)
LN_MODE = {"two_pass": Counter(layernorm=1),
           "onepass": Counter(layernorm_onepass=1), "skip": Counter()}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run `python -m pytest -m gpu "
                    "--noconftest tests/test_torch_kernels.py` on a machine "
                    "with one")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _params(rng, d, hidden_mult, n_fused):
    """LN scale/shift, a (n_fused·d, d) projection and a (d, hidden_mult·d)
    output projection in torch Linear layout, float32 numpy."""
    f = np.float32
    return {"g": (1 + 0.1 * rng.standard_normal(d)).astype(f),
            "be": (0.05 * rng.standard_normal(d)).astype(f),
            "w1": (rng.standard_normal((n_fused * d, d)) / np.sqrt(d)).astype(f),
            "b1": (0.02 * rng.standard_normal(n_fused * d)).astype(f),
            "w2": (rng.standard_normal((d, hidden_mult * d))
                   / np.sqrt(hidden_mult * d)).astype(f),
            "b2": (0.02 * rng.standard_normal(d)).astype(f)}


def _on(a, dev, dtype):
    return None if a is None else torch.from_numpy(a).to(dev, dtype)


def _max_err(got, want):
    return (got.float() - want.float()).abs().max().item()


# (batch, tokens, width, heads): head dims 16, 32, 48 and 64, ragged N
ATTN_CASES = [(2, 33, 64, 4), (2, 33, 64, 2), (1, 257, 96, 2),
              (2, 17, 192, 4), (2, 257, 1024, 16)]


@pytest.mark.parametrize("dtype,atol", DTYPES)
@pytest.mark.parametrize("b,n,d,h", ATTN_CASES)
def test_attn_half_kernel_matches_plain(cuda, dtype, atol, b, n, d, h):
    rng = np.random.default_rng(7)
    p = _params(rng, d, 1, 3)
    args = [_on(a, cuda, dtype) for a in (
        rng.standard_normal((b, n, d)).astype(np.float32), p["g"], p["be"],
        p["w1"], p["b1"], p["w2"], p["b2"])]
    before = runtime.launch_counts()
    got = attn_half_block(*args, h)
    assert runtime.launch_counts() - before == B1
    want = attn_half_block_ref(*[a.float() for a in args], h)
    assert _max_err(got, want) <= atol


@pytest.mark.parametrize("dtype,atol", DTYPES)
@pytest.mark.parametrize("residual", [True, False])
@pytest.mark.parametrize("b,n,d", [(2, 33, 64), (2, 257, 1024), (3, 256, 256)])
def test_mlp_kernel_matches_plain(cuda, dtype, atol, residual, b, n, d):
    rng = np.random.default_rng(8)
    p = _params(rng, d, 4, 4)
    args = [_on(a, cuda, dtype) for a in (
        rng.standard_normal((b, n, d)).astype(np.float32), p["g"], p["be"],
        p["w1"], p["b1"], p["w2"], p["b2"])]
    got = mlp_block(*args, residual=residual)
    want = mlp_block_ref(*[a.float() for a in args], residual=residual)
    assert _max_err(got, want) <= atol


@pytest.mark.parametrize("dtype,atol", DTYPES)
@pytest.mark.parametrize("residual", [True, False])
@pytest.mark.parametrize("b,nq,nc,d,h", [(2, 16, 33, 64, 4),
                                         (2, 256, 257, 256, 8)])
def test_xattn_kernel_matches_plain(cuda, dtype, atol, residual, b, nq, nc,
                                    d, h):
    rng = np.random.default_rng(9)
    pq, pc = _params(rng, d, 1, 1), _params(rng, d, 1, 2)
    args = [_on(a, cuda, dtype) for a in (
        rng.standard_normal((b, nq, d)).astype(np.float32),
        rng.standard_normal((b, nc, d)).astype(np.float32), pq["g"],
        pq["be"], pc["g"], pc["be"], pq["w1"], pq["b1"], pc["w1"], pc["b1"],
        pq["w2"], pq["b2"])]
    got = xattn_half_block(*args, h, residual=residual)
    want = xattn_half_block_ref(*[a.float() for a in args], h,
                                residual=residual)
    assert _max_err(got, want) <= atol


@pytest.mark.parametrize("dtype,atol", DTYPES)
@pytest.mark.parametrize("m,n,k,gelu,bias,res", [
    (33, 192, 64, False, True, True), (130, 264, 72, True, True, False),
    (514, 256, 1024, True, False, True), (1, 8, 8, False, True, False)])
def test_gemm_matches_plain(cuda, dtype, atol, m, n, k, gelu, bias, res):
    """Ragged M, N and K against the tile sizes; with and without each
    epilogue term."""
    g = torch.Generator(device="cuda").manual_seed(m + n + k)
    a = torch.randn(m, k, device=cuda, generator=g).to(dtype)
    w = (torch.randn(n, k, device=cuda, generator=g) * k ** -0.5).to(dtype)
    b = torch.randn(n, device=cuda, generator=g) * 0.1 if bias else None
    r = torch.randn(m, n, device=cuda, generator=g).to(dtype) if res else None
    want = F.linear(a.float(), w.float(), b)
    if gelu:
        want = F.gelu(want)
    if res:
        want = want + r.float()
    got = runtime.gemm(a, w, b, residual=r, gelu=gelu)
    assert got.dtype == dtype and _max_err(got, want) <= atol


@pytest.mark.parametrize("dtype,atol", DTYPES)
@pytest.mark.parametrize("b,nq,nk,h,dh", [
    (2, 33, 33, 4, 16), (2, 257, 257, 2, 48), (1, 100, 512, 2, 128),
    (2, 256, 257, 8, 32), (2, 65, 200, 3, 80), (1, 17, 64, 1, 96),
    (1, 70, 130, 2, 112), (3, 257, 257, 4, 64)])
def test_attention_reads_packed_columns_in_place(cuda, dtype, atol, b, nq,
                                                 nk, h, dh):
    """Every head dim the kernel takes, ragged query and key counts, q, k
    and v read as column windows of one packed tensor."""
    g = torch.Generator(device="cuda").manual_seed(nq * nk + dh)
    d = h * dh
    qkv = torch.randn(b, max(nq, nk), 3 * d, device=cuda, generator=g)
    qkv = qkv.to(dtype)
    q, k, v = qkv[:, :nq], qkv[:, :nk, d:], qkv[:, :nk, 2 * d:]
    out = torch.full((b, nq, d), float("nan"), device=cuda, dtype=dtype)
    runtime.attention(q, k, v, out, heads=h, dh=dh, scale=dh ** -0.5)

    def heads(t):
        return t[..., :d].float().reshape(b, t.shape[1], h, dh).transpose(1, 2)

    s = heads(q) @ heads(k).transpose(-1, -2) * dh ** -0.5
    want = (torch.softmax(s, -1) @ heads(v)).transpose(1, 2).reshape(b, nq, d)
    assert _max_err(out, want) <= atol


def _attn_core_ref(q, k, v, h, dh, scale):
    """float32 softmax(q kᵀ·scale) v of (B, rows, ≥ h·dh) column windows and
    the per-row log-sum-exp in log2 units, (B, h, nq)."""
    b, nq, nk = q.shape[0], q.shape[1], k.shape[1]

    def heads(t):
        return t[..., :h * dh].float().reshape(b, t.shape[1], h, dh) \
            .transpose(1, 2)

    s = heads(q) @ heads(k).transpose(-1, -2) * scale
    out = (torch.softmax(s, -1) @ heads(v)).transpose(1, 2).reshape(
        b, nq, h * dh)
    return out, torch.logsumexp(s, -1) / np.log(2.0)


# the Hopper forward (csrc/attention_fwd.cuh) at every head dim it takes and
# at the ragged shapes of its callers: a one-row query tail (257 = 4·64 + 1,
# 1025), a lone query, nq ≠ nk both ways (B3's 256 × 257, S7's masked keys
# nk < nq), keys in one chunk, and a long flash sequence
ATTN_FWD_TAILS = [(257, 257), (1, 35), (256, 257), (264, 257), (99, 99),
                  (129, 8), (1025, 1025), (70, 4097)]


@pytest.mark.parametrize("dh", [16, 32, 48, 64, 80, 96, 112, 128])
@pytest.mark.parametrize("nq,nk", ATTN_FWD_TAILS)
def test_attention_forward_every_head_dim_and_tail(cuda, dh, nq, nk):
    """bf16 output (max-abs 5e-2, rel-L2 1e-2, rows never written stay NaN
    past nq) and the flash entry's log-sum-exp (max-abs 1e-3 in log2 units:
    float scores from the same bf16 inputs) against float32 math; the
    packed entry too where it takes the key count."""
    g = torch.Generator(device="cuda").manual_seed(nq * 7 + nk + dh)
    b, h = 2, 3
    d = h * dh
    q_src = torch.randn(b, nq, d, device=cuda, generator=g).bfloat16()
    kv = torch.randn(b, nk, 2 * d, device=cuda, generator=g).bfloat16()
    k, v = kv[..., :d], kv[..., d:]
    scale = dh ** -0.5
    want, want_lse = _attn_core_ref(q_src, k, v, h, dh, scale)
    out = torch.full((b, nq + 1, d), float("nan"), device=cuda,
                     dtype=torch.bfloat16)
    lse = runtime.flash_attention(q_src, k, v, out[:, :nq], heads=h, dh=dh,
                                  scale=scale)
    torch.cuda.synchronize()
    assert torch.isnan(out[:, nq:]).all()
    err = (out[:, :nq].float() - want)
    assert err.abs().max().item() <= 5e-2
    assert (err.norm() / want.norm()).item() <= 1e-2
    assert (lse - want_lse).abs().max().item() <= 1e-3
    if nk <= runtime.MAX_KEYS:
        out2 = torch.empty(b, nq, d, device=cuda, dtype=torch.bfloat16)
        runtime.attention(q_src, k, v, out2, heads=h, dh=dh, scale=scale)
        assert torch.equal(out2, out[:, :nq])


def test_attention_raises_past_512_keys(cuda):
    x = torch.zeros(1, 513, 64, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="B8"):
        runtime.attention(x, x, x, torch.empty_like(x), heads=1, dh=64,
                          scale=0.125)


@pytest.mark.parametrize("wdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,d,offset", [
    (33, 72, 30.0), (5, 76, 0.0), (64, 256, 30.0), (16384, 256, 0.0),
    (7, 768, 30.0), (25344, 768, 0.0), (3, 1024, 30.0), (16448, 1024, 0.0)])
def test_layernorm_matches_plain(cuda, dtype, wdtype, m, d, offset):
    """The width classes 256, 768 and 1024 (and 72 in a class, masked),
    the generic kernel (76 in bf16), fewer rows than the grid, scale and
    shift in float32 or bf16, and a large mean (|mean| >> std), where the
    two-pass statistics stay exact; a rerun is bit-identical."""
    g = torch.Generator(device="cuda").manual_seed(m + d)
    x = (torch.randn(m, d, device=cuda, generator=g) + offset).to(dtype)
    w = (1 + 0.1 * torch.randn(d, device=cuda, generator=g)).to(wdtype)
    b = (0.05 * torch.randn(d, device=cuda, generator=g)).to(wdtype)
    want = F.layer_norm(x.float(), (d,), w.float(), b.float(), 1e-6)
    # one bf16 step of the O(1) output, or float32 sums in another order
    atol = 2e-2 if dtype == torch.bfloat16 else 1e-5
    got = runtime.layernorm(x, w, b)
    assert _max_err(got, want) <= atol
    assert torch.equal(got, runtime.layernorm(x, w, b))


# ---------------------------------------------------------------- backward
#
# Each backward op against its plain version on the same inputs (the plain
# version in float32 for bf16 inputs), every output compared: float32 at
# atol 1e-4 relative to the output's largest element (weight grads sum over
# every row), bf16 at a relative L2 error of 1e-2 (bf16 intermediates round
# at 2^-8, where the TPU kernels round).

from mirage_tpu_torch.nn.block import Block  # noqa: E402
from mirage_tpu_torch.ops import block_attention as ba  # noqa: E402
from mirage_tpu_torch.ops import fused_mlp as fm  # noqa: E402


def _check_grads(got, want, dtype):
    for i, (g, w) in enumerate(zip(got, want)):
        if w is None:
            assert g is None, i
            continue
        g, w = g.float(), w.float()
        if dtype == torch.float32:
            assert _max_err(g, w) <= 1e-4 * max(1.0, w.abs().max().item()), i
        else:
            assert ((g - w).norm() / w.norm()).item() <= 1e-2, i


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,n,d,h,bias", [
    (2, 33, 64, 4, True), (2, 99, 64, 2, False), (3, 99, 768, 12, True),
    (2, 256, 256, 8, True), (1, 17, 96, 2, True)])
def test_attn_half_backward_kernel_matches_plain(cuda, dtype, b, n, d, h,
                                                 bias):
    """Head dims 16, 32, 48 and 64, ragged N, no qkv bias."""
    rng = np.random.default_rng(n + d)
    p = _params(rng, d, 1, 3)
    x, dy = (_on(rng.standard_normal((b, n, d)).astype(np.float32), cuda,
                 dtype) for _ in range(2))
    args = [_on(a, cuda, dtype) for a in (p["g"], p["be"], p["w1"])] + [
        _on(p["b1"], cuda, dtype) if bias else None,
        _on(p["w2"], cuda, dtype)]
    before = runtime.launch_counts()
    got = ba._attn_half_bwd(x, dy, *args, h)
    assert runtime.launch_counts() - before == B4
    with runtime.plain_on_card():
        want = ba.attn_half_block_bwd_ref(
            x.float(), dy.float(), *[a.float() if a is not None else None
                                     for a in args], h)
    _check_grads(got, want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("residual", [True, False])
@pytest.mark.parametrize("shape", [(2, 33, 64), (2, 99, 768), (4, 256, 256)])
def test_mlp_backward_kernel_matches_plain(cuda, dtype, residual, shape):
    rng = np.random.default_rng(sum(shape))
    d = shape[-1]
    p = _params(rng, d, 4, 4)
    x, dy = (_on(rng.standard_normal(shape).astype(np.float32), cuda, dtype)
             for _ in range(2))
    args = [_on(p[k], cuda, dtype) for k in ("g", "be", "w1", "b1", "w2")]
    got = fm._mlp_bwd(x, dy, *args, residual=residual)
    with runtime.plain_on_card():
        want = fm.mlp_block_bwd_ref(x.float(), dy.float(),
                                    *[a.float() for a in args],
                                    residual=residual)
    _check_grads(got, want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,n,h,dh", [(2, 33, 4, 16), (2, 256, 8, 32),
                                      (3, 99, 12, 64), (1, 130, 2, 128),
                                      (1, 512, 2, 48)])
def test_block_attention_kernels_match_plain(cuda, dtype, b, n, h, dh):
    """B6 forward and backward: every head dim class, ragged N up to 512."""
    g = torch.Generator(device="cuda").manual_seed(n + dh)
    d = h * dh
    qkv = torch.randn(b, n, 3 * d, device=cuda, generator=g).to(dtype)
    dy = torch.randn(b, n, d, device=cuda, generator=g).to(dtype)
    scale = dh ** -0.5
    before = runtime.launch_counts()
    out = ba.block_attention(qkv, h, scale)
    dqkv = ba._block_attn_bwd(qkv, dy, h, scale)
    assert runtime.launch_counts() - before == {"attention": 1,
                                                "attention_bwd": 1}
    with runtime.plain_on_card():
        want = ba.block_attention_ref(qkv.float(), h, scale)
        want_d = ba.block_attention_bwd_ref(qkv.float(), dy.float(), h, scale)
    _check_grads([out, dqkv], [want, want_d], dtype)


@pytest.mark.parametrize("wdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,d,sub,with_dy,offset", [
    (33, 72, False, True, 3.0), (7, 76, False, False, 30.0),
    (65, 256, True, True, 3.0), (65536, 256, False, True, 0.0),
    (25344, 768, False, True, 3.0), (16448, 768, True, True, 0.0),
    (5, 1024, False, False, 30.0), (16448, 1024, False, True, 0.0)])
def test_layernorm_backward_matches_plain(cuda, dtype, wdtype, m, d, sub,
                                          with_dy, offset):
    """dx, dgamma and dbeta (finished on the card) at the width classes
    and the generic kernel (76), fewer rows than the grid, the scale in
    bf16, no residual cotangent, a large mean; a rerun is bit-identical."""
    g = torch.Generator(device="cuda").manual_seed(m + d)
    x = (torch.randn(m, d, device=cuda, generator=g) + offset).to(dtype)
    w = (1 + 0.1 * torch.randn(d, device=cuda, generator=g)).to(wdtype)
    dyln = torch.randn(m, d, device=cuda, generator=g)
    dy = torch.randn(m, d, device=cuda, generator=g).to(dtype)
    dy = dy if with_dy else None
    got = runtime.layernorm_bwd(x, w, dyln, dy, sub_dy=sub)
    again = runtime.layernorm_bwd(x, w, dyln, dy, sub_dy=sub)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    want_dx, want_g, want_b = ba.ln_bwd_ref(
        x.float(), dyln, w.float(),
        dy.float() if with_dy else torch.zeros_like(dyln))
    if sub:
        want_dx = want_dx.to(dtype).float() - dy.float()
    _check_grads(got, [want_dx, want_g, want_b], dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,n,k", [(33, 192, 64), (130, 264, 72),
                                   (514, 3072, 768)])
def test_gemm_float_output_and_gelu_backward(cuda, dtype, m, n, k):
    """csrc/gemm.cu's float32 output; the MLP backward's hidden stage
    (csrc/mlp_bwd.cu: dh, act and the 16-row column partials of db1 from y,
    dy and both weights as they lie; act bit-equal to B2's fc1 in bf16, a
    rerun bit-identical) and its dyln product, ragged M against the tiles."""
    g = torch.Generator(device="cuda").manual_seed(m + n)
    a = torch.randn(m, k, device=cuda, generator=g).to(dtype)
    w = (torch.randn(n, k, device=cuda, generator=g) * k ** -0.5).to(dtype)
    b = torch.randn(n, device=cuda, generator=g) * 0.1
    c = runtime.gemm(a, w, b, out_dtype=torch.float32)
    assert c.dtype == torch.float32
    assert _max_err(c, F.linear(a.float(), w.float(), b)) <= 1e-4 * k ** 0.5
    dy = torch.randn(m, k, device=cuda, generator=g).to(dtype)
    w2 = (torch.randn(k, n, device=cuda, generator=g) * n ** -0.5).to(dtype)
    dh, act, part = runtime.mlp_bwd_hidden(a, dy, w, b, w2)
    assert part.shape == (-(-m // 16), n) and part.dtype == torch.float32
    h = F.linear(a.float(), w.float(), b)
    grad = 0.5 * (1 + torch.erf(h / 2 ** 0.5)) \
        + h * torch.exp(-0.5 * h * h) / (2 * np.pi) ** 0.5
    want = (dy.float() @ w2.float()) * grad
    _check_grads([dh, act, part.sum(0)], [want, F.gelu(h), want.sum(0)],
                 dtype)
    if dtype == torch.bfloat16:
        assert torch.equal(act, runtime.gemm(a, w, b, gelu=True))
    assert all(torch.equal(x, y) for x, y in zip(
        (dh, act, part), runtime.mlp_bwd_hidden(a, dy, w, b, w2)))
    dyln = runtime.mlp_bwd_dyln(dh, w)
    assert dyln.dtype == torch.float32 and dyln.shape == (m, k)
    _check_grads([dyln], [dh.float() @ w.float()], dtype)


@pytest.mark.parametrize("n", [99, 256])
def test_block_training_gives_every_parameter_a_grad(cuda, n):
    """A CUDA forward under autograd keeps its graph: every parameter of a
    Block gets a gradient (B1/B4 at 99 tokens, block_attention at 256), and
    they agree with the plain path's."""
    torch.manual_seed(0)
    block = Block(256, 8, qkv_bias=True).to(cuda)
    for name, prm in block.named_parameters():
        torch.nn.init.normal_(prm, mean=float("norm" in name
                                            and name.endswith("weight")),
                              std=0.05)
    x = torch.randn(2, n, 256, device=cuda).to(torch.bfloat16)

    def grads():
        block.zero_grad()
        block(x, deterministic=False).float().square().sum().backward()
        return {k: p.grad.clone() for k, p in block.named_parameters()}

    got = grads()
    assert set(got) == {k for k, _ in block.named_parameters()}
    with runtime.plain_on_card():
        want = grads()
    for k, g in got.items():
        assert torch.isfinite(g).all(), k
        assert ((g - want[k]).norm() / want[k].norm()).item() <= 3e-2, k


def test_xattn_half_block_raises_under_autograd(cuda):
    rng = np.random.default_rng(1)
    pq, pc = _params(rng, 64, 1, 1), _params(rng, 64, 1, 2)
    args = [_on(a, cuda, torch.bfloat16) for a in (
        rng.standard_normal((2, 16, 64)).astype(np.float32),
        rng.standard_normal((2, 33, 64)).astype(np.float32), pq["g"],
        pq["be"], pc["g"], pc["be"], pq["w1"], pq["b1"], pc["w1"], pc["b1"],
        pq["w2"], pq["b2"])]
    args[6].requires_grad_()
    with pytest.raises(RuntimeError, match="no backward kernel"):
        xattn_half_block(*args, 4)


# ------------------------------------------------- segmentation: B8, B9
#
# Flash attention (B8) on packed self-attention and cross-attention views,
# every head-dim class, ragged and long sequences; the stash MLP pair (B9)
# and the kernels it chains (the stash and dgelu-multiply GEMM epilogues,
# the weight-gradient and column-sum kernels), each against its plain
# version, bf16 against float32 math from the same bf16 inputs.

from mirage_tpu_torch.ops import flash_attention as fa  # noqa: E402


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,nq,nk,dh,cross", [
    (1, 2, 1025, 1025, 64, False), (2, 3, 600, 600, 16, False),
    (1, 2, 513, 513, 128, False), (2, 8, 256, 769, 32, True),
    (1, 2, 70, 1100, 48, True), (1, 1, 17, 530, 96, True),
    (1, 2, 530, 64, 80, True), (1, 1, 600, 600, 112, False)])
def test_flash_attention_kernels_match_plain(cuda, dtype, b, h, nq, nk, dh,
                                             cross):
    g = torch.Generator(device="cuda").manual_seed(nq + nk + dh)
    d = h * dh
    if cross:
        q_src = torch.randn(b, nq, d, device=cuda, generator=g).to(dtype)
        kv_src = torch.randn(b, nk, 2 * d, device=cuda, generator=g).to(dtype)
    else:
        q_src = torch.randn(b, nq, 3 * d, device=cuda, generator=g).to(dtype)
        kv_src = None
    dy = torch.randn(b, nq, d, device=cuda, generator=g).to(dtype)
    scale = dh ** -0.5
    before = runtime.launch_counts()
    out, lse = fa._flash_fwd(q_src, kv_src, h, scale)
    grads = [t for t in fa._flash_bwd(q_src, kv_src, lse, dy, h, scale)
             if t is not None]
    assert runtime.launch_counts() - before == {"flash_fwd": 1,
                                                "flash_bwd": 1}
    f32 = [t.float() if t is not None else None for t in (q_src, kv_src)]
    with runtime.plain_on_card():
        want = fa._flash_fwd(f32[0], f32[1], h, scale)[0]
        want_g = [t for t in fa._flash_bwd(f32[0], f32[1], None, dy.float(),
                                           h, scale) if t is not None]
    _check_grads([out, *grads], [want, *want_g], dtype)


def test_flash_attention_op_trains_on_the_card(cuda):
    """Under autograd the op's Function keeps its graph: the gradient of a
    packed qkv through B8 equals the plain path's."""
    g = torch.Generator(device="cuda").manual_seed(0)
    qkv = torch.randn(2, 700, 3 * 128, device=cuda, generator=g)
    qkv = qkv.to(torch.bfloat16).requires_grad_()
    out = fa.flash_attention(qkv, num_heads=2, scale=64 ** -0.5)
    (got,) = torch.autograd.grad(out.float().square().sum(), qkv)
    with runtime.plain_on_card():
        out_p = fa.flash_attention(qkv, num_heads=2, scale=64 ** -0.5)
        (want,) = torch.autograd.grad(out_p.float().square().sum(), qkv)
    assert ((got.float() - want.float()).norm() / want.float().norm()) < 2e-2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,d", [(2048, 384), (65536, 384), (4096, 512),
                                 (8000, 384), (8100, 768)])
def test_stash_pair_kernels_match_plain(cuda, dtype, m, d):
    """B9 forward (out, act, GELU′) and backward (dx and every parameter
    grad, the weight grads from the wgrad kernel)."""
    rng = np.random.default_rng(m + d)
    p = _params(rng, d, 4, 4)
    x, dy = (_on(rng.standard_normal((m, d)).astype(np.float32), cuda, dtype)
             for _ in range(2))
    args = [_on(p[k], cuda, dtype) for k in ("g", "be", "w1", "b1", "w2",
                                             "b2")]
    before = runtime.launch_counts()
    out, act, dg = fm._mlp_fwd_stash(x, *args)
    grads = fm._mlp_bwd_stash(x, dy, act, dg, *args[:3], args[4])
    # the backward's two products read W as it lies: mtt_gemm_kn in bf16,
    # a transposed copy through mtt_gemm in float32
    kn = "gemm_kn" if dtype == torch.bfloat16 else "gemm"
    assert runtime.launch_counts() - before == B9_FWD + B9_BWD + Counter({kn: 2})
    assert torch.equal(out, fm.mlp_block(x, *args))  # B2's forward exactly
    with runtime.plain_on_card():
        pf = [a.float() for a in args]
        want = fm.mlp_block_fwd_stash_ref(x.float(), *pf)
        want_g = fm.mlp_block_bwd_stash_ref(x.float(), dy.float(),
                                            act.float(), dg.float(),
                                            *pf[:3], pf[4])
    _check_grads([out, act, dg, *grads], [*want, *want_g], dtype)


def test_stash_pair_reruns_bit_identical(cuda):
    """No atomics in B9's backward: two runs give the same bits."""
    rng = np.random.default_rng(3)
    p = _params(rng, 384, 4, 4)
    x, dy = (_on(rng.standard_normal((8192, 384)).astype(np.float32), cuda,
                 torch.bfloat16) for _ in range(2))
    args = [_on(p[k], cuda, torch.bfloat16)
            for k in ("g", "be", "w1", "b1", "w2", "b2")]
    _, act, dg = fm._mlp_fwd_stash(x, *args)
    one = fm._mlp_bwd_stash(x, dy, act, dg, *args[:3], args[4])
    two = fm._mlp_bwd_stash(x, dy, act, dg, *args[:3], args[4])
    assert all(torch.equal(a, b) for a, b in zip(one, two))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,n1,n2", [(33, 64, 72), (65536, 1536, 384),
                                     (5000, 200, 136), (128, 8, 8),
                                     (64, 3072, 768), (25344, 3072, 768),
                                     (16448, 768, 3072), (4161, 264, 1000)])
def test_weight_grad_and_colsum_kernels(cuda, dtype, m, n1, n2):
    """gᵀ·a over ragged row counts and widths against float math (bf16 on
    wgmma with both operands as they lie), at one row chunk and at several
    (runtime.wgrad_chunks), and the column sums; both bit-identical on a
    rerun."""
    gen = torch.Generator(device="cuda").manual_seed(m + n1)
    g = torch.randn(m, n1, device=cuda, generator=gen).to(dtype)
    a = torch.randn(m, n2, device=cuda, generator=gen).to(dtype)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    chunks, rows = runtime.wgrad_chunks(m, n1, n2, sms)
    assert (chunks == 1) == (m <= 64) and rows % 64 == 0
    got = runtime.weight_grad(g, a)
    want = g.double().t() @ a.double()
    assert got.dtype == torch.float32
    assert ((got.double() - want).norm() / want.norm()).item() < 1e-5
    assert torch.equal(got, runtime.weight_grad(g, a))
    cs = runtime.colsum(g)
    torch.testing.assert_close(cs.double(), g.double().sum(0), atol=1e-3,
                               rtol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,n,k", [(33, 192, 64), (65536, 1536, 384),
                                   (8000, 1536, 384), (8100, 3072, 768),
                                   (4100, 1000, 384)])
def test_gemm_stash_and_dgelu_epilogues(cuda, dtype, m, n, k):
    """csrc/gemm_stash.cu (act, dg) and the dgelu-multiply epilogue against
    float math; act bit-equal to B2's fc1 output, a rerun bit-identical."""
    gen = torch.Generator(device="cuda").manual_seed(m + n)
    a = torch.randn(m, k, device=cuda, generator=gen).to(dtype)
    w = (torch.randn(n, k, device=cuda, generator=gen) * k ** -0.5).to(dtype)
    b = torch.randn(n, device=cuda, generator=gen) * 0.1
    act, dg = runtime.gemm_gelu_stash(a, w, b)
    assert torch.equal(act, runtime.gemm(a, w, b, gelu=True))
    again = runtime.gemm_gelu_stash(a, w, b)
    assert torch.equal(act, again[0]) and torch.equal(dg, again[1])
    h = F.linear(a.float(), w.float(), b)
    grad = 0.5 * (1 + torch.erf(h / 2 ** 0.5)) \
        + h * torch.exp(-0.5 * h * h) / (2 * np.pi) ** 0.5
    _check_grads([act, dg], [F.gelu(h), grad], dtype)
    dh, part = runtime.gemm_dgelu_mul(a, w, dg)
    want = (a.float() @ w.float().t()) * dg.float()
    _check_grads([dh, part.sum(0)], [want, want.sum(0)], dtype)


# ----------------------------------------- B7 (accumulating) and B11

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("residual", [True, False])
@pytest.mark.parametrize("shape", [(3, 33, 48), (4, 257, 768), (2, 99, 768),
                                   (2, 256, 256)])
def test_mlp_accumulating_backward_matches_plain(cuda, dtype, residual,
                                                 shape):
    """B7's MLP half: dx and every parameter grad reduced by the wgrad and
    column-sum kernels; a rerun gives the same bits."""
    rng = np.random.default_rng(sum(shape) + 1)
    d = shape[-1]
    p = _params(rng, d, 4, 4)
    x, dy = (_on(rng.standard_normal(shape).astype(np.float32), cuda, dtype)
             for _ in range(2))
    args = [_on(p[k], cuda, dtype) for k in ("g", "be", "w1", "b1", "w2")]
    before = runtime.launch_counts()
    got = fm._mlp_bwd_acc(x, dy, *args, residual=residual)
    assert runtime.launch_counts() - before == B5 + Counter(wgrad=2, colsum=2)
    assert all(torch.equal(a, b) for a, b in zip(
        got, fm._mlp_bwd_acc(x, dy, *args, residual=residual)))
    with runtime.plain_on_card():
        want = fm.mlp_block_bwd_acc_ref(x.float(), dy.float(),
                                        *[a.float() for a in args],
                                        residual=residual)
    _check_grads(got, want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,n,d,h,bias", [
    (2, 33, 64, 4, True), (2, 99, 64, 2, False), (3, 99, 768, 12, True)])
def test_attn_accumulating_backward_matches_plain(cuda, dtype, b, n, d, h,
                                                  bias):
    """B7's attention half, with and without a qkv bias; a rerun gives the
    same bits."""
    rng = np.random.default_rng(n + d + 1)
    p = _params(rng, d, 1, 3)
    x, dy = (_on(rng.standard_normal((b, n, d)).astype(np.float32), cuda,
                 dtype) for _ in range(2))
    args = [_on(a, cuda, dtype) for a in (p["g"], p["be"], p["w1"])] + [
        _on(p["b1"], cuda, dtype) if bias else None,
        _on(p["w2"], cuda, dtype)]
    before = runtime.launch_counts()
    got = ba._attn_half_bwd_acc(x, dy, *args, h)
    assert runtime.launch_counts() - before == B4 + Counter(
        wgrad=2, colsum=2 if bias else 1)
    again = ba._attn_half_bwd_acc(x, dy, *args, h)
    assert all(torch.equal(a, c) for a, c in zip(got, again)
               if a is not None)
    with runtime.plain_on_card():
        want = ba.attn_half_block_bwd_acc_ref(
            x.float(), dy.float(), *[a.float() if a is not None else None
                                     for a in args], h)
    _check_grads(got, want, dtype)


def _adamw_state(cuda, shapes, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    g = [torch.randn(s, device=cuda, generator=gen) * 1e-2 for s in shapes]
    m = [torch.randn(s, device=cuda, generator=gen) * 1e-3 for s in shapes]
    n = [torch.rand(s, device=cuda, generator=gen) * 1e-5 for s in shapes]
    p = [torch.randn(s, device=cuda, generator=gen) for s in shapes]
    return g, m, n, p


def _table_update(gs, ms, ns, ps, lrs, wds, **scalars):
    """The update kernel over a leaf table of the leaves (the optimizer's
    route on the card), per-leaf lr and wd, with the scalars given."""
    from mirage_tpu_torch.ops.fused_adamw import LeafTable

    LeafTable(range(len(ps)), ms, ns, ps, lrs, wds).update_with(gs, **scalars)


@pytest.mark.parametrize("keep", [1.0, 0.0])
def test_fused_adamw_kernel_matches_plain(cuda, keep):
    """B11 over leaves of every alignment (lengths not a multiple of 4
    included) in one launch over a leaf table against its plain version
    (rtol 1e-6); keep = 0 leaves m, n and p bit for bit; a rerun gives the
    same bits."""
    from mirage_tpu_torch.ops.fused_adamw import fused_adamw

    shapes = [(768, 768), (3, 5, 7), (131075,), (2304, 768)]
    g, m, n, p = _adamw_state(cuda, shapes, 5)
    kw = dict(gscale=torch.tensor(0.5, device=cuda),
              c1=torch.tensor(1 - 0.9 ** 4, device=cuda),
              c2=torch.tensor(1 - 0.999 ** 4, device=cuda),
              keep=torch.tensor(keep, device=cuda), b1=0.9, b2=0.999,
              eps=1e-8)
    lrs, wds = [1e-3, 2e-3, 1e-4, 5e-4], [1e-2, 0.0, 1e-2, 5e-2]

    def run(plain=False):
        mm, nn_, pp = ([t.clone() for t in ts] for ts in (m, n, p))
        (fused_adamw if plain else _table_update)(g, mm, nn_, pp, lrs, wds,
                                                  **kw)
        return mm + nn_ + pp

    before = runtime.launch_counts()
    got = run()
    assert runtime.launch_counts() - before == {"adamw_tiles": 1}
    assert all(torch.equal(a, b) for a, b in zip(got, run()))
    want = run(plain=True)
    assert fused_adamw.last_routed_count == 4
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)
    if keep == 0.0:
        assert all(torch.equal(a, b) for a, b in zip(got, m + n + p))


def test_optimizer_with_the_fused_update_matches_foreach(cuda):
    """The optimizer's default route on the card (the leaf table: the norm
    and the update, every leaf) against MIRAGE_OPT_KERNEL=off (global_norm
    and the foreach chain) over two steps with clip_grad and skip_grad set
    and a changed lr (rtol 1e-6); then a step with an inf gradient leaves
    m, n, p and count bit for bit on both routes."""
    from mirage_tpu_torch.ops.fused_adamw import fused_adamw
    from mirage_tpu_torch.train.optim import GroupedOptimizer, OptimizerConfig

    shapes = {"a.weight": (512, 512), "b.weight": (300, 450), "c.bias": (7,)}
    g, _, _, p = _adamw_state(cuda, list(shapes.values()), 6)
    grads = dict(zip(shapes, g))
    bad = dict(grads, **{"b.weight": torch.full((300, 450), float("inf"),
                                                device=cuda)})
    out = []
    for switch in ("off", "on"):
        params = {k: t.clone() for k, t in zip(shapes, p)}
        opt = GroupedOptimizer(OptimizerConfig(clip_grad=1.0, skip_grad=1e3))
        state = opt.init(params)
        with runtime.switched({"MIRAGE_OPT_KERNEL": switch}):
            before = runtime.launch_counts()
            norms = [opt.update(grads, state, params, lr).item()
                     for lr in (1e-2, 5e-3)]
            assert runtime.launch_counts() - before == (
                {"adamw_norm": 2, "adamw_tiles": 2} if switch == "on" else {})
            if switch == "on":
                assert fused_adamw.last_routed_count == 3
            kept = [t.clone() for t in (*params.values(),
                                        *state["mu"].values(),
                                        *state["nu"].values())]
            gn = opt.update(bad, state, params, 1e-2)
        assert not math.isfinite(gn.item()) and int(state["count"]) == 2
        assert all(torch.equal(a, b) for a, b in zip(kept, (
            *params.values(), *state["mu"].values(), *state["nu"].values())))
        out.append((norms, params, state))
    np.testing.assert_allclose(out[1][0], out[0][0], rtol=1e-6)
    for key in shapes:
        torch.testing.assert_close(out[0][1][key], out[1][1][key],
                                   rtol=1e-6, atol=1e-7)
        for mom in ("mu", "nu"):
            torch.testing.assert_close(out[0][2][mom][key],
                                       out[1][2][mom][key], rtol=1e-6,
                                       atol=1e-7)


def _ragged_leaves(cuda, seed):
    """A ragged set of float32 leaves as a step's table meets them: 1, 3, 7
    and 131,075 elements, one of 4.19 M (MIRAGE-Large's fc1), 300 small
    ones, and two whose arrays start off the 16-byte vector (views at an
    offset of one element)."""
    rng = np.random.default_rng(seed)
    shapes = [(1,), (3,), (7,), (131075,), (4096, 1024)] + [
        (int(k),) for k in rng.integers(1, 3000, size=300)]
    g, m, n, p = _adamw_state(cuda, shapes, seed)
    for k in (1000, 8195):  # unaligned: g, m, n and p one element in
        for ts in (g, m, n, p):
            base = torch.randn(k + 1, device=cuda) * (1e-2 if ts is g
                                                      else 1e-3)
            if ts is n:
                base = base.abs() * 1e-2
            ts.append(base[1:])
    return g, m, n, p


def test_adamw_norm_kernel_matches_global_norm(cuda):
    """The norm kernel over the ragged leaves against global_norm (rtol
    1e-6), bit-identical on a rerun; its scalars (keep, gscale, c1, c2,
    count += keep) as the foreach route computes them, and with the norm
    handed in, only the scalars."""
    from mirage_tpu_torch.ops import fused_adamw as fa
    from mirage_tpu_torch.train.optim import global_norm

    g, m, n, p = _ragged_leaves(cuda, 8)
    table = fa.LeafTable(range(len(p)), m, n, p, [1.0] * len(p),
                         [0.0] * len(p))
    gs = table.write(g, 1e-3, 1.0)
    b1, b2 = 0.9, 0.95

    def norm(count, clip, skip, gnorm_in=None):
        out = None if gnorm_in is not None else torch.empty(
            (), device=cuda)
        runtime.adamw_norm(table.tiles, fa.TILE, table.leaves,
                           table.step_buf, table.slots, table.arrived, count,
                           table.scalars, gnorm_in=gnorm_in, gnorm_out=out,
                           clip=clip, skip=skip, b1=b1, b2=b2)
        return out, table.scalars.clone()

    count = torch.tensor(4, dtype=torch.int32, device=cuda)
    want = global_norm(g)
    got, sc = norm(count, 0.05, 1e3)
    again, _ = norm(count, 0.05, 1e3)
    torch.cuda.synchronize()
    assert torch.equal(got, again) and int(count) == 6
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
    cnt = torch.tensor(5.0, device=cuda)  # the count the first call left
    gscale = torch.clamp(0.05 / (got + 1e-6), max=1.0)
    want_sc = torch.stack([gscale, 1 - torch.pow(b1, cnt),
                           1 - torch.pow(b2, cnt), torch.tensor(1.0,
                                                                device=cuda)])
    assert torch.equal(sc, want_sc), (sc, want_sc)
    # skipped (the norm reaches skip): keep 0, the count stays
    _, sc = norm(count, None, float(want) / 2)
    assert sc[3].item() == 0.0 and sc[0].item() == 1.0 and int(count) == 6
    # the sharded steps hand the norm in: the scalars alone
    _, sc = norm(count, 1.0, None, gnorm_in=torch.tensor(4.0, device=cuda))
    assert sc[0].item() == torch.clamp(1.0 / (torch.tensor(4.0) + 1e-6),
                                       max=1.0).item()
    assert int(count) == 7 and sc[3].item() == 1.0
    del gs


@pytest.mark.parametrize("keep", [1.0, 0.0])
def test_adamw_tile_update_matches_plain(cuda, keep):
    """The tile-scheduled update over the ragged leaves (aligned and not)
    against fused_adamw_ref (rtol 1e-6), per-leaf lr and wd, bit-identical
    on a rerun; keep = 0 passes m, n and p through bit for bit."""
    from mirage_tpu_torch.ops.fused_adamw import fused_adamw

    g, m, n, p = _ragged_leaves(cuda, 9)
    rng = np.random.default_rng(10)
    lrs = (rng.random(len(p)) * 1e-3).tolist()
    wds = [0.05 if i % 3 else 0.0 for i in range(len(p))]
    kw = dict(gscale=torch.tensor(0.75, device=cuda),
              c1=torch.tensor(1 - 0.9 ** 7, device=cuda),
              c2=torch.tensor(1 - 0.95 ** 7, device=cuda),
              keep=torch.tensor(keep, device=cuda), b1=0.9, b2=0.95,
              eps=1e-8)

    def run(plain=False):
        mm, nn_, pp = ([t.clone() for t in ts] for ts in (m, n, p))
        (fused_adamw if plain else _table_update)(g, mm, nn_, pp, lrs, wds,
                                                  **kw)
        return mm + nn_ + pp

    got = run()
    assert all(torch.equal(a, b) for a, b in zip(got, run()))
    for a, b in zip(got, run(plain=True)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)
    if keep == 0.0:
        assert all(torch.equal(a, b) for a, b in zip(got, m + n + p))


def test_the_leaf_table_is_reused_and_rebuilt(cuda):
    """The optimizer builds one table for steps over one state; a
    load_state_dict that reallocates the parameters, and fresh moments,
    build it again; the steps after a rebuild update the new storage as a
    fresh optimizer would."""
    from mirage_tpu_torch.ops.fused_adamw import LeafTable
    from mirage_tpu_torch.train.optim import GroupedOptimizer, OptimizerConfig

    torch.manual_seed(11)
    model = torch.nn.Sequential(torch.nn.Linear(96, 80),
                                torch.nn.LayerNorm(80)).to(cuda)
    opt = GroupedOptimizer(OptimizerConfig())
    params = dict(model.named_parameters())
    state = opt.init(params)
    grads = {k: torch.randn_like(v) * 1e-2 for k, v in params.items()}
    builds = LeafTable.builds
    for _ in range(3):
        opt.update(grads, state, params, 1e-3)
    assert LeafTable.builds == builds + 1
    sd = {k: v.detach().clone() for k, v in model.state_dict().items()}
    model.load_state_dict(sd, assign=True)
    params = dict(model.named_parameters())
    opt.update(grads, state, params, 1e-3)
    assert LeafTable.builds == builds + 2
    # the same step from a fresh optimizer over copies of the same state
    twin = GroupedOptimizer(OptimizerConfig())
    p2 = {k: v.detach().clone() for k, v in params.items()}
    s2 = {"count": state["count"].clone(),
          **{k: {n: t.clone() for n, t in state[k].items()}
             for k in ("mu", "nu")}}
    opt.update(grads, state, params, 1e-3)
    twin.update(grads, s2, p2, 1e-3)
    assert LeafTable.builds == builds + 3  # the twin's own
    for k in params:
        assert torch.equal(params[k], p2[k])
    state = opt.init(params)
    opt.update(grads, state, params, 1e-3)
    assert LeafTable.builds == builds + 4


# B10: (batch, tokens, width, heads): head dims 16, 48, 32 and 64, ragged N;
# batch 5 at the encoder's shape (128-row tiles straddle batch elements)
# and batch 64 at the decoder's; head dim 128 with one head's K and V
# resident (257 tokens) and streamed (400)
FUSED_CASES = [(2, 33, 64, 4), (2, 17, 192, 4), (3, 256, 256, 8),
               (2, 257, 1024, 16), (5, 257, 1024, 16), (64, 256, 256, 8),
               (2, 257, 256, 2), (1, 400, 256, 2)]


def _fused_args(rng, b, n, d, dtype, dev, qkv_bias=True):
    pa, pm = _params(rng, d, 1, 3), _params(rng, d, 4, 4)
    pl = _params(rng, d, 1, 1)
    return [_on(a, dev, dtype) for a in (
        rng.standard_normal((b, n, d)).astype(np.float32), pa["g"], pa["be"],
        pa["w1"], pa["b1"] if qkv_bias else None, pa["w2"], pa["b2"],
        pl["g"], pl["be"], pm["w1"], pm["b1"], pm["w2"], pm["b2"])]


@pytest.mark.parametrize("dtype,atol", DTYPES)
@pytest.mark.parametrize("b,n,d,h", FUSED_CASES)
@pytest.mark.parametrize("qkv_bias", [True, False])
def test_fused_block_kernel_matches_plain(cuda, dtype, atol, b, n, d, h,
                                          qkv_bias):
    """The one-launch whole block against its plain version (the two
    halves' plain versions) on the same inputs; one launch counted."""
    from mirage_tpu_torch.ops.fused_block import fused_block, fused_block_ref

    rng = np.random.default_rng(12)
    args = _fused_args(rng, b, n, d, dtype, cuda, qkv_bias)
    before = runtime.launch_counts()
    got = fused_block(*args, h)
    assert runtime.launch_counts() - before == {"fused_block": 1}
    want = fused_block_ref(*[a.float() if a is not None else None
                             for a in args], h)
    assert _max_err(got, want) <= atol
    if dtype == torch.bfloat16:
        assert _rel_l2(got, want) <= 1e-2


@pytest.mark.parametrize("b,n,d,h", [(5, 257, 1024, 16), (3, 256, 256, 8)])
def test_fused_block_reruns_bit_identical_at_both_tile_widths(cuda, b, n, d,
                                                              h):
    """A rerun of the persistent grid gives the same bits (no atomics in
    the sums; the barrier counter is zeroed per launch), and the 128-wide
    GEMM tile, the plan's other setting, holds to the plain version too."""
    from mirage_tpu_torch.ops.fused_block import (fused_block_launch,
                                                  fused_block_ref)

    rng = np.random.default_rng(13)
    args = _fused_args(rng, b, n, d, torch.bfloat16, cuda)
    first = fused_block_launch(*args, h)
    assert torch.equal(fused_block_launch(*args, h), first)
    want = fused_block_ref(*[a.float() for a in args], h)
    narrow = fused_block_launch(*args, h, tile_n=128)
    for got in (first, narrow):
        assert _max_err(got, want) <= 5e-2 and _rel_l2(got, want) <= 1e-2


@pytest.mark.parametrize("shape", [(4, 257, 1024), (2048, 1024), (33, 64)])
def test_int8_mlp_kernels_match_plain(cuda, shape):
    """B12's four kernels against the plain int8 math on the same bf16
    inputs: at most 1e-3 of the int8 codes differ (a flip needs a value
    within a few float steps of a rounding boundary: the LN sums run in
    another order), the output within 1e-3 rel-L2, and a rerun gives the
    same bits."""
    from mirage_tpu_torch.ops import quant

    rng = np.random.default_rng(13)
    d = shape[-1]
    p = _params(rng, d, 4, 4)
    x = _on(rng.standard_normal(shape).astype(np.float32), cuda,
            torch.bfloat16)
    ln = [_on(p[k], cuda, torch.float32) for k in ("g", "be")]
    qp = quant.quantize_mlp_params(*[_on(p[k], cuda, torch.float32)
                                     for k in ("w1", "b1", "w2", "b2")])
    before = runtime.launch_counts()
    got = quant.mlp_block_q_kernel_parts(x, *ln, *qp)
    again = quant.mlp_block_q_kernel_parts(x, *ln, *qp)
    assert runtime.launch_counts() - before == {
        "ln_quant": 2, "gemm_s8": 4, "quant_rows": 2}
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    with runtime.plain_on_card():
        want = quant.mlp_block_q_parts(x, *ln, *qp)
    for i in (1, 3):
        assert (got[i] != want[i]).float().mean().item() <= 1e-3
    diff = (got[0].float() - want[0].float()).norm() / want[0].float().norm()
    assert diff.item() <= 1e-3


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("stash_flat", [False, True])
@pytest.mark.parametrize("residual", [True, False])
def test_stash3d_forward_equals_mlp_block(cuda, dtype, stash_flat, residual):
    """B9′ on B9's chain: out bit-equal to mlp_block's on the card, the
    stashes against the plain version, flat stashes as views."""
    from mirage_tpu_torch.ops.fused_mlp import (mlp_block_fwd_stash3d,
                                                mlp_block_fwd_stash3d_ref)

    rng = np.random.default_rng(14)
    b, n, d = 4, 99, 384
    p = _params(rng, d, 4, 4)
    args = [_on(a, cuda, dtype) for a in (
        rng.standard_normal((b, n, d)).astype(np.float32), p["g"], p["be"],
        p["w1"], p["b1"], p["w2"], p["b2"])]
    before = runtime.launch_counts()
    out, act, dg = mlp_block_fwd_stash3d(*args, residual=residual,
                                         stash_flat=stash_flat)
    assert runtime.launch_counts() - before == B9_FWD
    assert torch.equal(out, mlp_block(*args, residual=residual))
    want = mlp_block_fwd_stash3d_ref(*[a.float() for a in args],
                                     residual=residual,
                                     stash_flat=stash_flat)
    atol = 1e-4 if dtype == torch.float32 else 5e-2
    for g, w in zip((out, act, dg), want):
        assert g.shape == w.shape and _max_err(g, w) <= atol


# ------------------------------------------- the bench's A/B ops (S3, S4, S7)

@pytest.mark.parametrize("m,d", [(2 * 257, 1024), (33, 256), (130, 2048),
                                 (128, 512)])
def test_lnfold_kernel_matches_plain(cuda, m, d):
    """The fold (csrc/gemm_lnfold.cu: a cluster of d/256 CTAs) against its
    plain version in float32 from the same bf16 inputs; out bit-equal to
    B2's, whose fc2 runs the same main loop and epilogue rounding."""
    from mirage_tpu_torch.ops.fused_mlp import (mlp_block_lnfold,
                                                mlp_block_lnfold_ref)

    rng = np.random.default_rng(15)
    p = _params(rng, d, 4, 4)
    nxt = _params(rng, d, 1, 1)
    args = [_on(a, cuda, torch.bfloat16) for a in (
        rng.standard_normal((m, d)).astype(np.float32), p["g"], p["be"],
        p["w1"], p["b1"], p["w2"], p["b2"], nxt["g"], nxt["be"])]
    before = runtime.launch_counts()
    out, y = mlp_block_lnfold(*args)
    assert runtime.launch_counts() - before == {
        "layernorm": 1, "gemm": 1, "gemm_lnfold": 1}
    want_out, want_y = mlp_block_lnfold_ref(*[a.float() for a in args])
    assert _max_err(out, want_out) <= 5e-2
    assert _max_err(y, want_y) <= 5e-2
    assert torch.equal(out, mlp_block(*args[:7]))
    # y against the LN of the kernel's own out: one bf16 step at most
    y_of_out = F.layer_norm(out.float(), (d,), args[7].float(),
                            args[8].float(), 1e-6)
    assert _max_err(y, y_of_out) <= 2 ** -7 * y_of_out.abs().max().item()


@pytest.mark.parametrize("d,dtype", [(320, torch.bfloat16),
                                     (2304, torch.bfloat16),
                                     (256, torch.float32)])
def test_lnfold_kernel_refuses_what_it_does_not_take(cuda, d, dtype):
    from mirage_tpu_torch.ops.fused_mlp import mlp_block_lnfold

    rng = np.random.default_rng(16)
    p = _params(rng, d, 4, 4)
    args = [_on(a, cuda, dtype) for a in (
        rng.standard_normal((8, d)).astype(np.float32), p["g"], p["be"],
        p["w1"], p["b1"], p["w2"], p["b2"], p["g"], p["be"])]
    with pytest.raises(ValueError, match="gemm_lnfold"):
        mlp_block_lnfold(*args)


@pytest.mark.parametrize("m,k,n", [(33, 64, 40), (16384, 1024, 4096),
                                   (257, 4096, 1024)])
def test_gemm_s8_s32_is_exact(cuda, m, k, n):
    from mirage_tpu_torch.ops.quant import gemm_s8, gemm_s8_ref

    g = torch.Generator(device="cuda").manual_seed(17)
    a = torch.randint(-127, 128, (m, k), generator=g, device=cuda,
                      dtype=torch.int8)
    w = torch.randint(-127, 128, (n, k), generator=g, device=cuda,
                      dtype=torch.int8)
    before = runtime.launch_counts()
    got = gemm_s8(a, w)
    assert runtime.launch_counts() - before == {"gemm_s8": 1}
    assert got.dtype == torch.int32 and torch.equal(got, gemm_s8_ref(a, w))


@pytest.mark.parametrize("b,n,d,h,n_valid", [(2, 264, 1024, 16, 257),
                                             (3, 40, 64, 4, 33),
                                             (2, 320, 256, 4, 257)])
def test_masked_attn_half_matches_plain(cuda, b, n, d, h, n_valid):
    """B1 with the keys past n_valid masked against its plain version; its
    first n_valid rows bit-equal to B1 at n_valid on those rows."""
    from mirage_tpu_torch.ops.block_attention import (
        attn_half_block_masked, attn_half_block_masked_ref)

    rng = np.random.default_rng(18)
    p = _params(rng, d, 1, 3)
    args = [_on(a, cuda, torch.bfloat16) for a in (
        rng.standard_normal((b, n, d)).astype(np.float32), p["g"], p["be"],
        p["w1"], p["b1"], p["w2"], p["b2"])]
    before = runtime.launch_counts()
    got = attn_half_block_masked(*args, h, n_valid)
    assert runtime.launch_counts() - before == B1
    want = attn_half_block_masked_ref(*[a.float() for a in args], h, n_valid)
    assert _max_err(got, want) <= 5e-2
    base = attn_half_block(args[0][:, :n_valid].contiguous(), *args[1:], h)
    assert torch.equal(got[:, :n_valid], base)


def test_prenormed_attn_half_matches_plain(cuda):
    from mirage_tpu_torch.nn.layers import layer_norm
    from mirage_tpu_torch.ops.block_attention import (
        attn_half_block_prenormed, attn_half_block_prenormed_ref)

    rng = np.random.default_rng(19)
    b, n, d, h = 2, 257, 1024, 16
    p = _params(rng, d, 1, 3)
    x, g, be, wqkv, bqkv, wp, bp = [_on(a, cuda, torch.bfloat16) for a in (
        rng.standard_normal((b, n, d)).astype(np.float32), p["g"], p["be"],
        p["w1"], p["b1"], p["w2"], p["b2"])]
    y = layer_norm(x, g, be)
    got = attn_half_block_prenormed(x, y, wqkv, bqkv, wp, bp, h)
    want = attn_half_block_prenormed_ref(
        *[t.float() for t in (x, y, wqkv, bqkv, wp, bp)], h)
    assert _max_err(got, want) <= 5e-2
    # from B1's own LN output, the same bits as B1
    assert torch.equal(got, attn_half_block(x, g, be, wqkv, bqkv, wp, bp, h))


# --------------------------------- the bench's S2, S5 and S6 kernels


def _rel_l2(got, want):
    return ((got.float() - want.float()).norm() / want.float().norm()).item()


@pytest.mark.parametrize("m,d,offset", [(33, 72, 0.0), (2 * 257, 1024, 0.0),
                                        (130, 256, 3.0)])
def test_layernorm_onepass_matches_plain(cuda, m, d, offset):
    """The LN kernel's one-pass mode (E[x²] − mean², clamped at 0) against
    its plain version in float32 on the same bf16 inputs."""
    from mirage_tpu_torch.ops.block_attention import ln_mode_ref

    rng = np.random.default_rng(30)
    x = _on((rng.standard_normal((m, d)) + offset).astype(np.float32), cuda,
            torch.bfloat16)
    g = _on((1 + 0.1 * rng.standard_normal(d)).astype(np.float32), cuda,
            torch.float32)
    be = _on((0.05 * rng.standard_normal(d)).astype(np.float32), cuda,
             torch.float32)
    got = runtime.layernorm(x, g, be, onepass=True)
    want = ln_mode_ref(x.float(), g, be, "onepass")
    assert _max_err(got, want) <= 5e-2


# (batch, tokens, width, heads, heads per group): head dims 16, 64, 128, 48;
# a group of 8 at dh 64 (a cluster of 4); dh 128 at 400 keys, where one
# head's K and V do not fit a CTA (the staging branch)
PHASED_CASES = [(2, 33, 64, 4, 2), (2, 257, 1024, 16, 16),
                (2, 257, 1024, 16, 4), (1, 100, 256, 2, 1),
                (2, 17, 192, 4, 4), (2, 257, 512, 8, 8),
                (2, 400, 256, 2, 2)]


@pytest.mark.parametrize("smax", ["exp", "exp2", "nomax", "skip"])
@pytest.mark.parametrize("b,n,d,h,group", PHASED_CASES)
def test_phased_attention_kernel_matches_plain(cuda, smax, b, n, d, h,
                                               group):
    """csrc/attention_phased.cu on a packed bf16 qkv against its plain
    version in float32: normalised at the bf16 bars ("exp" also against
    B1's attention kernel); "skip" (the raw scores as P) before the division,
    where the unnormalised outputs reach O(10): rel-L2 1e-2 and max-abs 2 %
    of the largest element (a bf16 step at 16 is 0.06)."""
    from mirage_tpu_torch.ops.block_attention import phased_attention_ref

    rng = np.random.default_rng(31)
    dh = d // h
    qkv = _on(rng.standard_normal((b, n, 3 * d)).astype(np.float32), cuda,
              torch.bfloat16)
    divide = smax != "skip"
    out = qkv.new_empty(b, n, d)
    runtime.attention_phased(qkv, qkv[:, :, d:], qkv[:, :, 2 * d:], out,
                             heads=h, dh=dh, group=group, scale=dh ** -0.5,
                             smax=smax, divide=divide)
    want = phased_attention_ref(qkv.float(), h, smax, divide)
    assert bool(torch.isfinite(out.float()).all())
    if divide:
        assert _max_err(out, want) <= 5e-2 and _rel_l2(out, want) <= 1e-2
    else:
        assert _rel_l2(out, want) <= 1e-2
        assert _max_err(out, want) <= 2e-2 * want.abs().max().item()
    if smax == "exp":
        base = qkv.new_empty(b, n, d)
        runtime.attention(qkv, qkv[:, :, d:], qkv[:, :, 2 * d:], base,
                          heads=h, dh=dh, scale=dh ** -0.5)
        assert _max_err(out, base) <= 5e-2


@pytest.mark.parametrize("ln", ["two_pass", "onepass", "skip"])
def test_phased_attn_half_matches_plain(cuda, ln):
    from mirage_tpu_torch.ops.block_attention import (
        attn_half_block_phased, attn_half_block_phased_ref)

    rng = np.random.default_rng(32)
    b, n, d, h = 2, 257, 1024, 16
    p = _params(rng, d, 1, 3)
    args = [_on(a, cuda, torch.bfloat16) for a in (
        rng.standard_normal((b, n, d)).astype(np.float32), p["g"], p["be"],
        p["w1"], p["b1"], p["w2"], p["b2"])]
    before = runtime.launch_counts()
    got = attn_half_block_phased(*args, h, 16, ln=ln)
    assert runtime.launch_counts() - before == LN_MODE[ln] + Counter(
        gemm=2, attention_phased=1)
    want = attn_half_block_phased_ref(*[a.float() for a in args], h, 16, ln)
    assert _max_err(got, want) <= 5e-2 and _rel_l2(got, want) <= 1e-2


@pytest.mark.parametrize("act", ["as26", "bf16", "hastings"])
@pytest.mark.parametrize("m,n,k", [(130, 264, 72), (2 * 257, 4096, 1024)])
def test_gemm_gelu_modes_match_plain(cuda, act, m, n, k):
    """The GELU epilogue's other erf formulas against their plain versions
    on the float product of the same bf16 operands, at the bf16 bars."""
    from mirage_tpu_torch.ops.fused_mlp import gelu_mode_ref

    rng = np.random.default_rng(33)
    a = _on(rng.standard_normal((m, k)).astype(np.float32), cuda,
            torch.bfloat16)
    w = _on((rng.standard_normal((n, k)) / np.sqrt(k)).astype(np.float32),
            cuda, torch.bfloat16)
    bias = _on((0.02 * rng.standard_normal(n)).astype(np.float32), cuda,
               torch.float32)
    got = runtime.gemm_gelu_mode(a, w, bias, mode=act)
    want = gelu_mode_ref(a.float() @ w.float().t() + bias, act)
    assert _max_err(got, want) <= 5e-2 and _rel_l2(got, want) <= 1e-2


@pytest.mark.parametrize("ln,act", [("two_pass", "as26"), ("onepass", "bf16"),
                                    ("skip", "hastings"), ("two_pass", "skip")])
def test_mlp_block_modes_match_plain(cuda, ln, act):
    from mirage_tpu_torch.ops.fused_mlp import (mlp_block_modes,
                                                mlp_block_modes_ref)

    rng = np.random.default_rng(34)
    b, n, d = 2, 257, 1024
    p = _params(rng, d, 4, 4)
    args = [_on(a, cuda, torch.bfloat16) for a in (
        rng.standard_normal((b, n, d)).astype(np.float32), p["g"], p["be"],
        p["w1"], p["b1"], p["w2"], p["b2"])]
    before = runtime.launch_counts()
    got = mlp_block_modes(*args, ln=ln, act=act)
    assert runtime.launch_counts() - before == LN_MODE[ln] + (
        Counter(gemm=2) if act == "skip"
        else Counter(gemm_gelu_mode=1, gemm=1))
    want = mlp_block_modes_ref(*[a.float() for a in args], ln, act)
    assert _max_err(got, want) <= 5e-2 and _rel_l2(got, want) <= 1e-2


@pytest.mark.parametrize("rows_per_cluster", [1, 2])
@pytest.mark.parametrize("b,n,d", [(2, 257, 1024), (3, 33, 256), (1, 130, 512),
                                   (2, 100, 768), (1, 257 * 3, 1024)])
def test_mlp_chunked_kernel_matches_plain(cuda, b, n, d, rows_per_cluster):
    """csrc/mlp_chunked.cu (the hidden on chip, operand slices multicast
    across clusters of 1 or 2 row tiles; 257·3 rows are 7 tiles, so at R = 2
    the last cluster's second tile is empty) against its plain version in
    float32 and against B2 at the bf16 bars; another chunk count gives the
    same bits, and so does the other R."""
    from mirage_tpu_torch.ops.fused_mlp import (mlp_block_chunked,
                                                mlp_block_chunked_ref)

    rng = np.random.default_rng(35)
    p = _params(rng, d, 4, 4)
    args = [_on(a, cuda, torch.bfloat16) for a in (
        rng.standard_normal((b, n, d)).astype(np.float32), p["g"], p["be"],
        p["w1"], p["b1"], p["w2"], p["b2"])]
    before = runtime.launch_counts()
    got = mlp_block_chunked(*args, 4, rows_per_cluster=rows_per_cluster)
    assert runtime.launch_counts() - before == {"layernorm": 1,
                                                "mlp_chunked": 1}
    want = mlp_block_chunked_ref(*[a.float() for a in args], 4)
    assert _max_err(got, want) <= 5e-2 and _rel_l2(got, want) <= 1e-2
    assert _max_err(got, mlp_block(*args)) <= 5e-2
    assert torch.equal(got, mlp_block_chunked(
        *args, 2, rows_per_cluster=rows_per_cluster))
    assert torch.equal(got, mlp_block_chunked(
        *args, 4, rows_per_cluster=3 - rows_per_cluster))


def test_mlp_chunked_refuses_what_it_does_not_take(cuda):
    from mirage_tpu_torch.ops.fused_mlp import mlp_block_chunked

    x = torch.zeros(2, 8, 320, device=cuda, dtype=torch.bfloat16)
    w1 = torch.zeros(1280, 320, device=cuda, dtype=torch.bfloat16)
    w2 = torch.zeros(320, 1280, device=cuda, dtype=torch.bfloat16)
    v = torch.zeros(320, device=cuda)
    with pytest.raises(ValueError, match="multiple of 256"):
        mlp_block_chunked(x, v, v, w1, torch.zeros(1280, device=cuda), w2, v,
                          2)


# ---------------------------------- the Hopper attention backward
#
# csrc/attention_bwd.cuh behind both entries (mtt_attention_bwd, the packed
# qkv of up to 512 tokens; mtt_flash_bwd, q and kv apart at any length) at
# every head dim it takes and at the tails of its tiles: 64-row CTAs and
# 64-key (dQ) or 64/32-query (dK/dV) chunks, a one-row tail (65, 129, 257,
# 1025), a lone query, one chunk (99), nq ≠ nk both ways. bf16 against the
# float32 plain version from the same inputs at _check_grads's bars
# (rel-L2 1e-2), and a rerun bit for bit the same (no atomics).

ATTN_BWD_PACKED = [1, 64, 65, 99, 129, 257, 512]
ATTN_BWD_FLASH = [(1025, 1025), (256, 769), (70, 1100), (530, 64), (1, 35)]


@pytest.mark.parametrize("dh", [16, 32, 48, 64, 80, 96, 112, 128])
@pytest.mark.parametrize("n", ATTN_BWD_PACKED)
def test_attention_backward_packed_every_head_dim_and_tail(cuda, dh, n):
    """dqkv and the 16-row partials' column sums (dbqkv) of the packed form."""
    g = torch.Generator(device="cuda").manual_seed(n * 3 + dh)
    b, h = 2, 3
    d = h * dh
    qkv = torch.randn(b, n, 3 * d, device=cuda, generator=g).bfloat16()
    dy = torch.randn(b, n, d, device=cuda, generator=g).bfloat16()
    scale = dh ** -0.5
    before = runtime.launch_counts()
    dqkv, part = runtime.attention_bwd(qkv, dy, heads=h, dh=dh, scale=scale,
                                       partials=True)
    again = runtime.attention_bwd(qkv, dy, heads=h, dh=dh, scale=scale,
                                  partials=True)
    assert runtime.launch_counts() - before == {"attention_bwd": 2}
    assert torch.equal(dqkv, again[0]) and torch.equal(part, again[1])
    with runtime.plain_on_card():
        want = ba.block_attention_bwd_ref(qkv.float(), dy.float(), h, scale)
    _check_grads([dqkv, part.sum(0)], [want, want.sum((0, 1))],
                 torch.bfloat16)


@pytest.mark.parametrize("dh", [16, 32, 48, 64, 80, 96, 112, 128])
@pytest.mark.parametrize("nq,nk", ATTN_BWD_FLASH)
def test_attention_backward_flash_every_head_dim_and_tail(cuda, dh, nq, nk):
    """dq and dkv of the flash form on a (B, nq, D) q and a packed kv."""
    g = torch.Generator(device="cuda").manual_seed(nq * 5 + nk + dh)
    b, h = 2, 2
    d = h * dh
    q = torch.randn(b, nq, d, device=cuda, generator=g).bfloat16()
    kv = torch.randn(b, nk, 2 * d, device=cuda, generator=g).bfloat16()
    dy = torch.randn(b, nq, d, device=cuda, generator=g).bfloat16()
    scale = dh ** -0.5
    _, lse = fa._flash_fwd(q, kv, h, scale)
    before = runtime.launch_counts()
    got = fa._flash_bwd(q, kv, lse, dy, h, scale)
    again = fa._flash_bwd(q, kv, lse, dy, h, scale)
    assert runtime.launch_counts() - before == {"flash_bwd": 2}
    assert all(torch.equal(a, c) for a, c in zip(got, again))
    with runtime.plain_on_card():
        want = fa._flash_bwd(q.float(), kv.float(), None, dy.float(), h,
                             scale)
    _check_grads(got, want, torch.bfloat16)


# ------------------------ the ping-pong GEMM (csrc/gemm_pingpong.cuh)

# ragged M, N and K against the 128 × 128 tiles; the last has more tiles than
# SMs, so CTAs run two and three tiles (both consumers, an odd count too)
GEMM_EDGES = [(1, 8, 8), (63, 264, 72), (65, 8, 1000), (129, 264, 64),
              (17985, 136, 72)]
GEMM_EPIS = ["none", "bias", "gelu", "res", "f32", "dgelu", "as26", "bf16",
             "hastings", "kn_dgelu", "kn_f32"]


@pytest.mark.parametrize("m,n,k", GEMM_EDGES)
@pytest.mark.parametrize("epi", GEMM_EPIS)
def test_pingpong_gemm_every_epilogue(cuda, m, n, k, epi):
    """Every epilogue of the bf16 instantiation against float32 math from
    the same bf16 inputs (the bf16 bars; the float output 1e-4·√K, the
    dgelu multiply and its column sums rel-L2 1e-2), a rerun bit-identical;
    W read as it lies ((K, N), ``w_kn``) bit-equal to W read transposed."""
    from mirage_tpu_torch.ops.quant import _erf_as

    g = torch.Generator(device="cuda").manual_seed(m + n + k)
    a = torch.randn(m, k, device=cuda, generator=g).bfloat16()
    w = (torch.randn(n, k, device=cuda, generator=g) * k ** -0.5).bfloat16()
    b = torch.randn(n, device=cuda, generator=g) * 0.1
    r = torch.randn(m, n, device=cuda, generator=g).bfloat16()
    dg = torch.randn(m, n, device=cuda, generator=g).bfloat16()
    wt = w.t().contiguous()
    run = {"none": lambda: runtime.gemm(a, w),
           "bias": lambda: runtime.gemm(a, w, b),
           "gelu": lambda: runtime.gemm(a, w, b, gelu=True),
           "res": lambda: runtime.gemm(a, w, b, residual=r),
           "f32": lambda: runtime.gemm(a, w, b, out_dtype=torch.float32),
           "dgelu": lambda: runtime.gemm_dgelu_mul(a, w, dg),
           "kn_dgelu": lambda: runtime.gemm_dgelu_mul(a, wt, dg, w_kn=True),
           "kn_f32": lambda: runtime.gemm(a, wt, b, out_dtype=torch.float32,
                                          w_kn=True)}
    for mode in ("as26", "bf16", "hastings"):
        run[mode] = functools.partial(runtime.gemm_gelu_mode, a, w, b,
                                      mode=mode)
    before = runtime.launch_counts()
    got, again = run[epi](), run[epi]()
    entry = ("gemm_gelu_mode" if epi in ("as26", "bf16", "hastings")
             else "gemm_kn" if epi.startswith("kn_") else "gemm")
    assert runtime.launch_counts() - before == {entry: 2}
    pairs = list(zip(got, again)) if isinstance(got, tuple) else [(got, again)]
    assert all(torch.equal(x, y) for x, y in pairs)
    acc = a.float() @ w.float().t()
    h = acc + b
    if epi in ("dgelu", "kn_dgelu"):
        want = acc * dg.float()
        _check_grads([got[0], got[1].sum(0)], [want, want.sum(0)],
                     torch.bfloat16)
        if epi == "kn_dgelu":
            assert all(torch.equal(x, y) for x, y in zip(got, run["dgelu"]()))
        return
    if epi in ("f32", "kn_f32"):
        assert got.dtype == torch.float32
        assert _max_err(got, h) <= 1e-4 * k ** 0.5
        if epi == "kn_f32":
            assert torch.equal(got, run["f32"]())
        return
    want = {"none": acc, "bias": h, "gelu": F.gelu(h), "res": h + r.float(),
            "as26": 0.5 * h * (1 + _erf_as(h / 2 ** 0.5)),
            "bf16": F.gelu(h), "hastings": F.gelu(h)}[epi]
    assert got.dtype == torch.bfloat16
    assert _max_err(got, want) <= 5e-2 and _rel_l2(got, want) <= 1e-2


@pytest.mark.parametrize("m,n,k", [(17, 8, 16), (63, 264, 80),
                                   (129, 40, 1008), (17985, 136, 144)])
def test_pingpong_gemm_s8_is_exact_and_dequantises(cuda, m, n, k):
    """The int8 instantiation: the s32 product equals torch._int_mm's; fc1
    (h = GELU(acc·rs·s + b) within rel-L2 1e-5 of float32 math, exp2f within
    2 ulp, and the rows' abs-max of its own h exactly) and fc2 in both
    working types (the bf16 bars; float32 1e-5) against the plain math on
    the same codes; every output reruns bit-identical."""
    from mirage_tpu_torch.ops import quant

    g = torch.Generator(device="cuda").manual_seed(m + n + k)
    a = torch.randint(-127, 128, (m, k), generator=g, device=cuda,
                      dtype=torch.int8)
    w = torch.randint(-127, 128, (n, k), generator=g, device=cuda,
                      dtype=torch.int8)
    rs = torch.rand(m, generator=g, device=cuda) * 0.05 + 1e-3
    s = torch.rand(n, generator=g, device=cuda) * 1e-3 + 1e-5
    b = torch.randn(n, generator=g, device=cuda) * 0.02
    s32 = runtime.gemm_s8_s32(a, w)
    assert torch.equal(s32, torch._int_mm(a, w.t()))
    assert torch.equal(s32, runtime.gemm_s8_s32(a, w))
    v = s32.float() * rs[:, None] * s + b
    hid, amax = runtime.gemm_s8_fc1(a, w, rs, s, b)
    want = 0.5 * v * (1.0 + quant._erf_as(v / 2 ** 0.5))
    assert _rel_l2(hid, want) <= 1e-5
    assert torch.equal(amax, hid.abs().amax(-1))
    again = runtime.gemm_s8_fc1(a, w, rs, s, b)
    assert torch.equal(hid, again[0]) and torch.equal(amax, again[1])
    for dtype, tol in ((torch.bfloat16, 5e-2), (torch.float32, 1e-5)):
        x = torch.randn(m, n, generator=g, device=cuda).to(dtype)
        out = runtime.gemm_s8_fc2(a, w, rs, s, b, x)
        assert torch.equal(out, runtime.gemm_s8_fc2(a, w, rs, s, b, x))
        want = x.float() + v.to(dtype).float()
        assert _max_err(out, want) <= tol * max(1.0, want.abs().max().item())


# ------------------------------------------------- the task-strided kernels

def _split(t, tasks):
    return [c.contiguous() for c in t.chunk(tasks)]


@pytest.mark.parametrize("tasks,m,d", [(3, 16448, 256), (2, 300, 768),
                                       (3, 65, 1024)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_task_layernorm_equals_one_task_launches(cuda, tasks, m, d, dtype):
    """csrc/layernorm.cu over a task stack (gamma/beta (T, D)): the forward
    and the backward's dx bit-equal to T one-task launches, dgamma/dbeta
    (T, D) within float rounding of theirs (another grid: another sum
    order), reruns bit-identical."""
    g = torch.Generator(device="cuda").manual_seed(m + d)
    x = torch.randn(tasks * m, d, generator=g, device=cuda).to(dtype)
    w = 1 + 0.1 * torch.randn(tasks, d, generator=g, device=cuda)
    b = 0.1 * torch.randn(tasks, d, generator=g, device=cuda)
    dyln = torch.randn(tasks * m, d, generator=g, device=cuda)
    dy = torch.randn(tasks * m, d, generator=g, device=cuda).to(dtype)
    before = runtime.launch_counts()
    y = runtime.layernorm(x, w, b)
    assert runtime.launch_counts() - before == {"layernorm_tasks": 1}
    assert torch.equal(y, torch.cat([runtime.layernorm(xt, w[i], b[i])
                                     for i, xt in enumerate(_split(x, tasks))]))
    got = runtime.layernorm_bwd(x, w, dyln, dy)
    again = runtime.layernorm_bwd(x, w, dyln, dy)
    assert all(torch.equal(p, q) for p, q in zip(got, again))
    one = [runtime.layernorm_bwd(xt, w[i], gt, dt) for i, (xt, gt, dt) in
           enumerate(zip(_split(x, tasks), _split(dyln, tasks),
                         _split(dy, tasks)))]
    assert torch.equal(got[0], torch.cat([o[0] for o in one]))
    for k in (1, 2):
        want = torch.stack([o[k] for o in one])
        assert got[k].shape == (tasks, d)
        assert _max_err(got[k], want) <= 1e-5 * max(1.0,
                                                     want.abs().max().item())


@pytest.mark.parametrize("m,n,k", [(16448, 512, 256), (16384, 1024, 256),
                                   (16384, 256, 1024), (100, 264, 72)])
@pytest.mark.parametrize("epi", ["bias", "gelu", "res", "f32"])
def test_task_gemm_equals_one_task_launches(cuda, m, n, k, epi):
    """mtt_gemm_tasks (W (T, N, K), bias (T, N)) bit-equal to T launches of
    mtt_gemm at ragged M, N and K, every epilogue; a rerun bit-identical."""
    tasks = 3
    g = torch.Generator(device="cuda").manual_seed(m + n + k)
    a = torch.randn(tasks * m, k, generator=g, device=cuda).bfloat16()
    w = (torch.randn(tasks, n, k, generator=g, device=cuda)
         / k ** 0.5).bfloat16()
    b = 0.02 * torch.randn(tasks, n, generator=g, device=cuda)
    r = torch.randn(tasks * m, n, generator=g, device=cuda).bfloat16()
    kw = {"bias": {}, "gelu": {"gelu": True}, "res": {"residual": r},
          "f32": {"out_dtype": torch.float32}}[epi]

    def one(i):
        kwi = dict(kw)
        if epi == "res":
            kwi["residual"] = _split(r, tasks)[i]
        return runtime.gemm(_split(a, tasks)[i], w[i], b[i], **kwi)

    before = runtime.launch_counts()
    got = runtime.gemm(a, w, b, **kw)
    assert runtime.launch_counts() - before == {"gemm_tasks": 1}
    assert torch.equal(got, runtime.gemm(a, w, b, **kw))
    assert torch.equal(got, torch.cat([one(i) for i in range(tasks)]))


@pytest.mark.parametrize("m,d,h", [(65536, 256, 1024), (1000, 264, 1056)])
def test_task_mlp_bwd_equals_one_task_launches(cuda, m, d, h):
    """csrc/mlp_bwd.cu's two products over a task stack (W1 (T, H, D), W2
    (T, D, H), b1 (T, H)): dh, act, the 16-row partials of db1 (T,
    ceil(M/16), H) and dyln (float and bf16) bit-equal to T one-task
    launches."""
    tasks = 3
    g = torch.Generator(device="cuda").manual_seed(m + d)
    y = torch.randn(tasks * m, d, generator=g, device=cuda).bfloat16()
    dy = torch.randn(tasks * m, d, generator=g, device=cuda).bfloat16()
    w1 = (torch.randn(tasks, h, d, generator=g, device=cuda)
          / d ** 0.5).bfloat16()
    w2 = (torch.randn(tasks, d, h, generator=g, device=cuda)
          / h ** 0.5).bfloat16()
    b1 = 0.02 * torch.randn(tasks, h, generator=g, device=cuda)
    dh, act, part = runtime.mlp_bwd_hidden(y, dy, w1, b1, w2)
    assert part.shape == (tasks, -(-m // 16), h)
    one = [runtime.mlp_bwd_hidden(yt, dt, w1[i], b1[i], w2[i]) for i, (yt, dt)
           in enumerate(zip(_split(y, tasks), _split(dy, tasks)))]
    assert torch.equal(dh, torch.cat([o[0] for o in one]))
    assert torch.equal(act, torch.cat([o[1] for o in one]))
    assert torch.equal(part, torch.stack([o[2] for o in one]))
    for out_dtype in (torch.float32, torch.bfloat16):
        got = runtime.mlp_bwd_dyln(dh, w1, out_dtype=out_dtype)
        want = torch.cat([runtime.mlp_bwd_dyln(t, w1[i], out_dtype=out_dtype)
                          for i, t in enumerate(_split(dh, tasks))])
        assert torch.equal(got, want)


@pytest.mark.parametrize("m,n1,n2", [(65536, 1024, 256), (4160, 264, 776)])
def test_task_wgrad_and_colsum_match_one_task_launches(cuda, m, n1, n2):
    """csrc/wgrad.cu over a task stack: one (N1, N2) gradient and one row of
    column sums a task, within float rounding of T one-task launches (the
    chunking may differ: another sum order) and of float32 math; reruns
    bit-identical."""
    tasks = 3
    g = torch.Generator(device="cuda").manual_seed(m + n1)
    a = torch.randn(tasks * m, n1, generator=g, device=cuda).bfloat16()
    b = torch.randn(tasks * m, n2, generator=g, device=cuda).bfloat16()
    got = runtime.weight_grad(a, b, tasks)
    assert got.shape == (tasks, n1, n2)
    assert torch.equal(got, runtime.weight_grad(a, b, tasks))
    want = torch.bmm(a.double().view(tasks, m, n1).transpose(1, 2),
                     b.double().view(tasks, m, n2))
    one = torch.stack([runtime.weight_grad(x, y) for x, y in
                       zip(_split(a, tasks), _split(b, tasks))])
    for t in range(tasks):
        assert _rel_l2(got[t].double(), want[t]) < 1e-5
        assert _rel_l2(got[t].double(), one[t].double()) < 1e-5
    cs = runtime.colsum(b, tasks)
    assert cs.shape == (tasks, n2)
    assert torch.equal(cs, runtime.colsum(b, tasks))
    torch.testing.assert_close(cs.double(),
                               b.double().view(tasks, m, n2).sum(1),
                               atol=1e-3, rtol=1e-5)
