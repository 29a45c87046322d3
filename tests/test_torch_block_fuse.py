"""The port's whole-block op (B10), its route under MIRAGE_BLOCK_FUSE, the
int8 MLP half (B12) and the 3-D stash forward (B9′) against the JAX package.

On the CPU each op runs its plain PyTorch version; these tests hold it to
the JAX Pallas kernel run in interpret mode and to the JAX package's XLA
version on the same float32 inputs made with numpy, at atol 3e-5 / rtol
1e-4 (tests/test_flash_attention.py's bar for fused_block and the stash
forward) and atol 2e-5 / rtol 1e-4 for the int8 half (tests/test_quant.py's
bar). tests/test_torch_kernels.py holds the CUDA kernels to the plain
versions on a card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mirage_tpu.nn import block as jax_block
from mirage_tpu.ops import runtime as jax_rt
from mirage_tpu.ops.fused_block import fused_block as jax_fused_block
from mirage_tpu.ops.fused_mlp import _mlp_block_fwd_stash3d
from mirage_tpu.ops.quant import (mlp_block_q as jax_mlp_block_q,
                                  mlp_block_q_xla, quantize_mlp_params,
                                  quantize_weight as jax_quantize_weight)
from mirage_tpu_torch.nn import block as port_block
from mirage_tpu_torch.nn.block import Block
from mirage_tpu_torch.ops import fused_block as fb
from mirage_tpu_torch.ops import fused_mlp as fm
from mirage_tpu_torch.ops import quant as q
from mirage_tpu_torch.ops import runtime


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The tiny blocks run no faster on more threads, and the suite runs
    several test processes on the same cores: the float64 gradcheck's many
    small forwards took 1008 s on the default threads under six workers
    (17 s alone on one thread)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


TOL = dict(atol=3e-5, rtol=1e-4)
Q_TOL = dict(atol=2e-5, rtol=1e-4)


def _t(a):
    return torch.from_numpy(np.array(a))


def _port_block(p, d, heads):
    """A port Block holding the JAX block parameters p."""
    blk = Block(d, heads, qkv_bias="b" in p["attn"]["qkv"])
    sd = {"norm1.weight": p["norm1"]["scale"], "norm1.bias": p["norm1"]["bias"],
          "attn.qkv.weight": np.asarray(p["attn"]["qkv"]["w"]).T,
          "attn.proj.weight": np.asarray(p["attn"]["proj"]["w"]).T,
          "attn.proj.bias": p["attn"]["proj"]["b"],
          "norm2.weight": p["norm2"]["scale"], "norm2.bias": p["norm2"]["bias"],
          "mlp.fc1.weight": np.asarray(p["mlp"]["fc1"]["w"]).T,
          "mlp.fc1.bias": p["mlp"]["fc1"]["b"],
          "mlp.fc2.weight": np.asarray(p["mlp"]["fc2"]["w"]).T,
          "mlp.fc2.bias": p["mlp"]["fc2"]["b"]}
    if "b" in p["attn"]["qkv"]:
        sd["attn.qkv.bias"] = p["attn"]["qkv"]["b"]
    blk.load_state_dict({k: _t(v) for k, v in sd.items()}, strict=True)
    return blk


def _block_args(blk):
    a, m = blk.attn, blk.mlp
    return (blk.norm1.weight, blk.norm1.bias, a.qkv.weight, a.qkv.bias,
            a.proj.weight, a.proj.bias, blk.norm2.weight, blk.norm2.bias,
            m.fc1.weight, m.fc1.bias, m.fc2.weight, m.fc2.bias)


# ------------------------------------------------------------------ B10

@pytest.mark.parametrize("b,n,h,d", [(2, 33, 4, 64), (1, 257, 8, 128)])
@pytest.mark.parametrize("qkv_bias", [True, False])
def test_fused_block_ref_matches_jax(b, n, h, d, qkv_bias):
    """fused_block_ref against the interpreted Pallas kernel and the XLA
    block path, at tests/test_flash_attention.py:199's shapes; without a
    qkv bias the JAX op adds zeros (fused_block.py:169-171)."""
    p = jax_block.block_init(jax.random.PRNGKey(0), d, qkv_bias=qkv_bias)
    x = np.random.default_rng(n * d).standard_normal((b, n, d)).astype(
        np.float32)
    blk = _port_block(p, d, h)
    with torch.no_grad():
        got = fb.fused_block_ref(_t(x), *_block_args(blk), h).numpy()
        op = fb.fused_block(_t(x), *_block_args(blk), h).numpy()
    np.testing.assert_array_equal(op, got)
    want_k = jax_fused_block(jnp.asarray(x), p, h, interpret=True)
    want_x = jax_block.block_apply(p, jnp.asarray(x), h, impl="xla")
    np.testing.assert_allclose(got, np.asarray(want_k), **TOL)
    np.testing.assert_allclose(got, np.asarray(want_x), **TOL)


@pytest.mark.parametrize("switch", ["off", "decoder", "all"])
@pytest.mark.parametrize("shape,heads", [((2, 257, 256), 8),
                                         ((1, 33, 512), 8)])
def test_block_under_the_switch_matches_jax(monkeypatch, switch, shape,
                                            heads):
    """The port's Block under each MIRAGE_BLOCK_FUSE value against JAX
    block_apply with the same value in interpret mode (tests/
    test_flash_attention.py:208-236): the decoder-width block fuses under
    decoder and all, the encoder-width one only under all."""
    d = shape[-1]
    p = jax_block.block_init(jax.random.PRNGKey(d), d, qkv_bias=True)
    x = np.random.default_rng(d).standard_normal(shape).astype(np.float32)
    blk = _port_block(p, d, heads)
    calls = []
    monkeypatch.setattr(port_block, "fused_block", lambda *a: calls.append(
        1) or fb.fused_block(*a))
    with runtime.switched({"MIRAGE_BLOCK_FUSE": switch}), torch.no_grad():
        got = blk(_t(x)).numpy()
    monkeypatch.setattr(jax_block, "_BLOCK_FUSE", switch)
    with jax_rt.forced("interpret"):
        want = jax_block.block_apply(p, jnp.asarray(x), heads)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    fused = switch == "all" or (switch == "decoder" and d <= 256)
    assert len(calls) == int(fused)


# reconstruct-forward routes of a tiny model: encoder 320 wide (above the
# decoder switch's 256), decoders 32 wide, depths 2 and 1, three domains
ROUTE_ARGS = dict(model="miragepre_tiny", num_global_tokens=1,
                  in_domains=["bscan", "slo", "bscanlayermap"],
                  out_domains=["bscan", "slo", "bscanlayermap"],
                  dim_tokens=320, depth=2, num_heads=4, decoder_dim=32,
                  decoder_depth=1, decoder_num_heads=2)


@pytest.mark.parametrize("switch,want", [
    ("off", {"attn_half_block": 5, "mlp_block": 8, "xattn_half_block": 3,
             "fused_block": 0}),
    ("decoder", {"attn_half_block": 2, "mlp_block": 5, "xattn_half_block": 3,
                 "fused_block": 3}),
    ("all", {"attn_half_block": 0, "mlp_block": 3, "xattn_half_block": 3,
             "fused_block": 5})])
def test_reconstruct_routes_and_launch_counts_on_the_cpu(monkeypatch, switch,
                                                         want):
    """The ops one reconstruct forward calls under each switch value (the
    step-3 table of the slice at a tiny size: per encoder block B1 + B2 or
    B10, per decoder B3 + B2 then its blocks); on the CPU no op counts a
    launch, since none launches a kernel."""
    from mirage_tpu_torch.adapters import spatial_output
    from mirage_tpu_torch.api.wrapper import build_model
    from mirage_tpu_torch.ops import block_attention as ba

    model = build_model("miragepre_tiny", ROUTE_ARGS,
                        ROUTE_ARGS["in_domains"], 256, 16,
                        generator=torch.Generator().manual_seed(0)).eval()
    calls = {k: 0 for k in want}
    for mod, name in ((port_block, "attn_half_block"),
                      (port_block, "mlp_block"), (port_block, "fused_block"),
                      (spatial_output, "xattn_half_block"),
                      (spatial_output, "mlp_block")):
        def spy(*a, _orig=getattr(mod, name), _name=name, **k):
            calls[_name] += 1
            return _orig(*a, **k)
        monkeypatch.setattr(mod, name, spy)
    counters = [(fb.fused_block, "launches"), (ba.attn_half_block, "launches"),
                (fm.mlp_block, "launches"), (ba.xattn_half_block, "launches")]
    before = [getattr(f, a) for f, a in counters]
    x = {"bscan": torch.rand(2, 1, 256, 256,
                             generator=torch.Generator().manual_seed(1)),
         "slo": torch.zeros(2, 1, 256, 256),
         "bscanlayermap": torch.zeros(2, 128, 128, dtype=torch.long)}
    with runtime.switched({"MIRAGE_BLOCK_FUSE": switch}), \
            torch.inference_mode():
        out = model(x, absent_tasks=("slo", "bscanlayermap"))
    assert calls == want
    assert [getattr(f, a) for f, a in counters] == before
    assert all(torch.isfinite(v).all() for v in out.values())


def test_the_switch_is_read_at_import_and_validated():
    import subprocess
    import sys

    assert runtime.SWITCHES["MIRAGE_BLOCK_FUSE"][0] == "off"
    with pytest.raises(ValueError):
        runtime.set_switch("MIRAGE_BLOCK_FUSE", "encoder")
    code = ("from mirage_tpu_torch.ops import runtime; "
            "print(runtime.switches['MIRAGE_BLOCK_FUSE'])")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={**__import__("os").environ,
                              "MIRAGE_BLOCK_FUSE": "decoder"})
    assert out.returncode == 0 and out.stdout.strip() == "decoder", out.stderr
    bad = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={**__import__("os").environ,
                              "MIRAGE_BLOCK_FUSE": "both"})
    assert bad.returncode != 0 and "refusing to fall back" in bad.stderr


def test_fused_block_gradient_is_the_plain_versions():
    """Under autograd the op's backward is autograd through the plain
    version (the JAX custom VJP's _block_bwd_vjp); float64 gradcheck."""
    rng = np.random.default_rng(3)
    d, h = 32, 2

    def r(*s, scale=1.0):
        return torch.tensor(rng.standard_normal(s) * scale,
                            dtype=torch.float64, requires_grad=True)

    args = (r(2, 5, d), 1 + r(d, scale=0.1), r(d, scale=0.1),
            r(3 * d, d, scale=d ** -0.5), None, r(d, d, scale=d ** -0.5),
            r(d, scale=0.1), 1 + r(d, scale=0.1), r(d, scale=0.1),
            r(4 * d, d, scale=d ** -0.5), r(4 * d, scale=0.1),
            r(d, 4 * d, scale=(4 * d) ** -0.5), r(d, scale=0.1))
    args = tuple(a.detach().requires_grad_() if a is not None else None
                 for a in args)
    assert torch.autograd.gradcheck(
        lambda *a: fb.fused_block(*a, h), args, eps=1e-6, atol=1e-6)


@pytest.mark.parametrize("shape,heads", [((1, 513, 64), 4), ((1, 8, 64), 8),
                                         ((1, 8, 288), 2)])
def test_fused_block_refuses_shapes_the_kernel_does_not_take(shape, heads):
    d = shape[-1]
    blk = Block(d, heads)
    with pytest.raises(ValueError):
        fb.fused_block(torch.zeros(shape), *_block_args(blk), heads)


# B10's plan on an H100's 132 SMs: (width, hidden, heads) of MIRAGE-Large's
# encoder and its 256-wide decoder
LARGE, DECODER = (1024, 4096, 16), (256, 1024, 8)


@pytest.mark.parametrize("sms,blocks", [(132, 1), (132, 2), (114, 1)])
@pytest.mark.parametrize("batch", [1, 64, 256])
def test_fused_block_plan_grid_never_exceeds_the_resident_ctas(sms, blocks,
                                                               batch):
    """The grid is the CTAs the card holds at once, whatever the batch."""
    plan = fb.fused_block_plan(batch, 257, *LARGE, sms, blocks)
    assert plan["grid"] == sms * blocks


@pytest.mark.parametrize("batch", [1, 3, 64, 256])
@pytest.mark.parametrize("n", [17, 257, 512])
def test_fused_block_plan_covers_every_item_once(batch, n):
    """Walked by every CTA of the grid, each stage covers every row (LN),
    every (row, column tile) of B·N rows (GEMMs) and every (batch element,
    head, query pass) (attention) exactly once."""
    d, hidden, heads = LARGE
    plan = fb.fused_block_plan(batch, n, d, hidden, heads, 132, 1)
    m = batch * n
    for stage in fb.STAGES:
        cells = [c for cta in range(plan["grid"])
                 for c in fb.fused_block_items(plan, stage, cta)]
        if stage in ("ln1", "ln2"):
            assert sorted(cells) == [(r,) for r in range(m)]
        elif stage == "attention":
            qp = plan["query_pass"]
            passes = [(b, h, q0, min(q0 + qp, n)) for b in range(batch)
                      for h in range(heads) for q0 in range(0, n, qp)]
            assert sorted(cells) == passes
        else:  # the tiles partition the (B·N, cols) matrix
            cols, tn = plan["cols"][stage], plan["tile_n"]
            tiles = [(r0, min(r0 + 128, m), c0, min(c0 + tn, cols))
                     for r0 in range(0, m, 128) for c0 in range(0, cols, tn)]
            assert sorted(cells) == tiles
            # the whole batch pads less than one tile: < 1 % at 64 × 257
            pad = -(-m // 128) * 128 - m
            assert pad < 128 and (m < 64 * 257 or pad / m < 0.01)


@pytest.mark.parametrize("shape", [LARGE, DECODER])
@pytest.mark.parametrize("tile_n,dtype", [(256, "bf16"), (128, "bf16"),
                                          (256, "float32")])
def test_fused_block_plan_takes_the_decoder_and_large(shape, tile_n, dtype):
    """Both widths the route sends plan at both tile widths and in float32
    (FMA tiles of 64 × 64); the batch-64 encoder's qkv stage is 129 row
    tiles (the batch's 16448 rows) by 3D / tile_n columns."""
    d, hidden, heads = shape
    plan = fb.fused_block_plan(64, 257, d, hidden, heads, 132, 1, tile_n,
                               dtype)
    tm, tn = (128, tile_n) if dtype == "bf16" else (64, 64)
    assert (plan["tile_m"], plan["tile_n"]) == (tm, tn)
    rows = -(-64 * 257 // tm)
    assert plan["items"]["qkv"] == rows * -(-3 * d // tn)
    assert plan["items"]["fc1"] == rows * -(-hidden // tn)
    assert plan["items"]["attention"] == 64 * heads


@pytest.mark.parametrize("n,dh,want", [(257, 64, 2), (256, 32, 2),
                                       (512, 64, 1), (257, 128, 1),
                                       (400, 128, 0)])
def test_fused_block_plan_keeps_k_and_v_resident_where_they_fit(n, dh, want):
    """The attention stage keeps two heads' K and V in shared memory at
    MIRAGE's encoder and decoder shapes (the next item's load overlaps this
    one's products), one where only one fits, and streams them in key
    chunks at head dim 128 above ≈ 380 tokens."""
    plan = fb.fused_block_plan(2, n, 2 * dh, 8 * dh, 2, 132, 1)
    assert plan["attention_buffers"] == want
    assert plan["query_pass"] == (16 if want else 128)


@pytest.mark.parametrize("batch,want", [(1, 128), (64, 256)])
def test_fused_block_plan_widens_the_tile_once_the_grid_is_full(batch, want):
    """The op's tile width: 256 once the qkv stage's 256-wide tiles fill
    the grid (batch 64: 1548 tiles on 132 CTAs), else 128 (batch 1: 36), the
    faster one in chip_smoke.py's sweep at each of those batches."""
    plan = fb.fused_block_plan(batch, 257, *LARGE, 132, 1)
    assert plan["tile_n"] == want


@pytest.mark.parametrize("kw,match", [({"tile_n": 64}, "tile_n"),
                                      ({"blocks_per_sm": 0}, "blocks per SM")])
def test_fused_block_plan_refuses_what_the_kernel_does_not_take(kw, match):
    args = dict(batch=2, n=17, d=64, hidden=256, heads=4, sms=132,
                blocks_per_sm=1)
    with pytest.raises(ValueError, match=match):
        fb.fused_block_plan(**{**args, **kw})


# ------------------------------------------------------------------ B12

@pytest.mark.parametrize("shape", [(64, 128), (256, 48)])
def test_quantize_weight_equals_jax(shape):
    """Per-output-channel int8 of the port's (out, in) weight equals the JAX
    package's on wᵀ, bit for bit."""
    w = np.random.default_rng(7).standard_normal(shape).astype(np.float32)
    w[3] = 0.0  # a zero channel takes scale 1
    wq, s = q.quantize_weight(_t(w))
    jwq, js = jax_quantize_weight(jnp.asarray(w.T))
    np.testing.assert_array_equal(wq.numpy(), np.asarray(jwq).T)
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


def _jax_quant_case(shape, seed=0):
    d = shape[-1]
    p = jax_block.block_init(jax.random.PRNGKey(seed), d, qkv_bias=True)
    jq = quantize_mlp_params(p["mlp"])
    port_q = q.quantize_mlp_params(
        _t(np.asarray(p["mlp"]["fc1"]["w"]).T), _t(p["mlp"]["fc1"]["b"]),
        _t(np.asarray(p["mlp"]["fc2"]["w"]).T), _t(p["mlp"]["fc2"]["b"]))
    return p, jq, port_q


@pytest.mark.parametrize("shape", [(12, 64), (2, 7, 64), (2, 16, 64)])
def test_mlp_block_q_matches_jax(shape):
    """mlp_block_q_ref against the interpreted Pallas kernel and
    mlp_block_q_xla at tests/test_quant.py:41's shapes; the int8 codes of
    both quantisations equal the JAX math's."""
    p, jq, port_q = _jax_quant_case(shape)
    x = np.random.default_rng(7).standard_normal(shape).astype(np.float32)
    ln = (_t(p["norm2"]["scale"]), _t(p["norm2"]["bias"]))
    got = q.mlp_block_q(_t(x), *ln, *port_q).numpy()
    np.testing.assert_array_equal(
        got, q.mlp_block_q_ref(_t(x), *ln, *port_q).numpy())
    want_k = jax_mlp_block_q(jnp.asarray(x), p["norm2"], jq, interpret=True)
    want_x = mlp_block_q_xla(jnp.asarray(x), p["norm2"], jq)
    np.testing.assert_allclose(got, np.asarray(want_k), **Q_TOL)
    np.testing.assert_allclose(got, np.asarray(want_x), **Q_TOL)


def test_mlp_block_q_codes_match_the_jax_math():
    """The LN output's and the hidden's int8 codes and row scales, step by
    step against the JAX package's _quant_rows on the same values."""
    from mirage_tpu.ops.quant import _quant_rows

    p, _, port_q = _jax_quant_case((33, 128), seed=1)
    x = np.random.default_rng(8).standard_normal((33, 128)).astype(
        np.float32)
    ln = (_t(p["norm2"]["scale"]), _t(p["norm2"]["bias"]))
    _, yq, rs, aq, as_ = q.mlp_block_q_parts(_t(x), *ln, *port_q)
    x32 = jnp.asarray(x)
    mean = jnp.mean(x32, -1, keepdims=True)
    var = jnp.maximum(jnp.mean(jnp.square(x32), -1, keepdims=True)
                      - jnp.square(mean), 0.0)
    y = (x32 - mean) * jax.lax.rsqrt(var + 1e-6) * p["norm2"]["scale"] \
        + p["norm2"]["bias"]
    jyq, jrs = _quant_rows(y)
    np.testing.assert_array_equal(yq.numpy(), np.asarray(jyq))
    np.testing.assert_allclose(rs.numpy(), np.asarray(jrs)[:, 0], rtol=1e-6)
    assert aq.dtype == torch.int8 and as_.shape == (33,)


def test_mlp_block_q_is_close_to_the_float_block():
    """The int8 half approximates the float half within 2 % of the branch
    (tests/test_quant.py:53's contract)."""
    from mirage_tpu_torch.ops.fused_mlp import mlp_block_ref

    p, _, port_q = _jax_quant_case((33, 128), seed=1)
    x = _t(np.random.default_rng(1).standard_normal((33, 128)).astype(
        np.float32))
    ln = (_t(p["norm2"]["scale"]), _t(p["norm2"]["bias"]))
    got = q.mlp_block_q(x, *ln, *port_q)
    want = mlp_block_ref(x, *ln, _t(np.asarray(p["mlp"]["fc1"]["w"]).T),
                         _t(p["mlp"]["fc1"]["b"]),
                         _t(np.asarray(p["mlp"]["fc2"]["w"]).T),
                         _t(p["mlp"]["fc2"]["b"]))
    rel = ((got - want).norm() / (want - x).norm()).item()
    assert rel < 0.02, rel


def test_mlp_block_q_is_forward_only():
    _, _, port_q = _jax_quant_case((4, 64))
    x = torch.zeros(4, 64, requires_grad=True)
    with pytest.raises(RuntimeError, match="forward only"):
        q.mlp_block_q(x, torch.ones(64), torch.zeros(64), *port_q)


# ------------------------------------------------------------------ B9′

@pytest.mark.parametrize("stash_flat", [False, True])
@pytest.mark.parametrize("residual", [True, False])
def test_stash3d_matches_jax(stash_flat, residual):
    """mlp_block_fwd_stash3d's plain version against the interpreted
    _mlp_block_fwd_stash3d (B9′) on unaligned 3-D input, every output."""
    rng = np.random.default_rng(11)
    b, n, d = 4, 11, 48
    f = np.float32
    x = rng.standard_normal((b, n, d)).astype(f)
    g = (1 + 0.1 * rng.standard_normal(d)).astype(f)
    be = (0.1 * rng.standard_normal(d)).astype(f)
    w1 = (0.1 * rng.standard_normal((d, 4 * d))).astype(f)
    b1 = (0.1 * rng.standard_normal(4 * d)).astype(f)
    w2 = (0.1 * rng.standard_normal((4 * d, d))).astype(f)
    b2 = (0.1 * rng.standard_normal(d)).astype(f)
    got = fm.mlp_block_fwd_stash3d(_t(x), _t(g), _t(be), _t(w1.T), _t(b1),
                                   _t(w2.T), _t(b2), residual=residual,
                                   stash_flat=stash_flat)
    want = _mlp_block_fwd_stash3d(*[jnp.asarray(a) for a in (
        x, g, be, w1, b1, w2, b2)], interpret=True, residual=residual,
        stash_flat=stash_flat)
    hshape = (b * n, 4 * d) if stash_flat else (b, n, 4 * d)
    for name, gg, ww, shape in zip(("out", "act", "dgelu"), got, want,
                                   ((b, n, d), hshape, hshape)):
        assert tuple(gg.shape) == shape == tuple(ww.shape), name
        np.testing.assert_allclose(gg.numpy(), np.asarray(ww), **TOL,
                                   err_msg=name)
    plain = fm.mlp_block_ref(_t(x), _t(g), _t(be), _t(w1.T), _t(b1),
                             _t(w2.T), _t(b2), residual=residual)
    np.testing.assert_allclose(got[0].numpy(), plain.numpy(), **TOL)
