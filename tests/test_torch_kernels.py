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
    before = attn_half_block.launches
    got = attn_half_block(*args, h)
    assert attn_half_block.launches == before + 1
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


def test_attention_raises_past_512_keys(cuda):
    x = torch.zeros(1, 513, 64, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="B8"):
        runtime.attention(x, x, x, torch.empty_like(x), heads=1, dh=64,
                          scale=0.125)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,d,offset", [(33, 72, 30.0), (5, 76, 0.0),
                                        (64, 256, 30.0), (16448, 1024, 0.0)])
def test_layernorm_matches_plain(cuda, dtype, m, d, offset):
    """Widths read in 16-byte vectors (72 in bf16, 256, 1024) and element by
    element (76, 72 in float32), and a large mean (|mean| >> std), where the
    two-pass statistics stay exact."""
    g = torch.Generator(device="cuda").manual_seed(m + d)
    x = (torch.randn(m, d, device=cuda, generator=g) + offset).to(dtype)
    w = 1 + 0.1 * torch.randn(d, device=cuda, generator=g)
    b = 0.05 * torch.randn(d, device=cuda, generator=g)
    want = F.layer_norm(x.float(), (d,), w, b, 1e-6)
    # one bf16 step of the O(1) output, or float32 sums in another order
    atol = 2e-2 if dtype == torch.bfloat16 else 1e-5
    assert _max_err(runtime.layernorm(x, w, b), want) <= atol


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
    before = ba.attn_half_block.bwd_launches
    got = ba._attn_half_bwd(x, dy, *args, h)
    assert ba.attn_half_block.bwd_launches == before + 1
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
    fwd0, bwd0 = ba.block_attention.launches, ba.block_attention.bwd_launches
    out = ba.block_attention(qkv, h, scale)
    dqkv = ba._block_attn_bwd(qkv, dy, h, scale)
    assert (ba.block_attention.launches, ba.block_attention.bwd_launches) \
        == (fwd0 + 1, bwd0 + 1)
    with runtime.plain_on_card():
        want = ba.block_attention_ref(qkv.float(), h, scale)
        want_d = ba.block_attention_bwd_ref(qkv.float(), dy.float(), h, scale)
    _check_grads([out, dqkv], [want, want_d], dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,d,sub", [(33, 72, False), (65, 256, True),
                                     (25344, 768, False)])
def test_layernorm_backward_matches_plain(cuda, dtype, m, d, sub):
    g = torch.Generator(device="cuda").manual_seed(m + d)
    x = (torch.randn(m, d, device=cuda, generator=g) + 3.0).to(dtype)
    w = 1 + 0.1 * torch.randn(d, device=cuda, generator=g)
    dyln = torch.randn(m, d, device=cuda, generator=g)
    dy = torch.randn(m, d, device=cuda, generator=g).to(dtype)
    dx, dgamma, dbeta = runtime.layernorm_bwd(x, w, dyln, dy, sub_dy=sub)
    want_dx, want_g, want_b = ba.ln_bwd_ref(x.float(), dyln, w, dy.float())
    if sub:
        want_dx = want_dx.to(dtype).float() - dy.float()
    _check_grads([dx, dgamma, dbeta], [want_dx, want_g, want_b], dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,n,k", [(33, 192, 64), (130, 264, 72),
                                   (514, 3072, 768)])
def test_gemm_float_output_and_gelu_backward(cuda, dtype, m, n, k):
    """The float32 output and the GELU-backward epilogue (dh, act and the
    16-row column partials of db1), ragged M against the tiles."""
    g = torch.Generator(device="cuda").manual_seed(m + n)
    a = torch.randn(m, k, device=cuda, generator=g).to(dtype)
    w = (torch.randn(n, k, device=cuda, generator=g) * k ** -0.5).to(dtype)
    b = torch.randn(n, device=cuda, generator=g) * 0.1
    c = runtime.gemm(a, w, b, out_dtype=torch.float32)
    assert c.dtype == torch.float32
    assert _max_err(c, F.linear(a.float(), w.float(), b)) <= 1e-4 * k ** 0.5
    h = torch.randn(m, n, device=cuda, generator=g) * 2
    dh, act, db1 = runtime.gemm_gelu_bwd(a, w, h)
    acc = a.float() @ w.float().t()
    grad = 0.5 * (1 + torch.erf(h / 2 ** 0.5)) \
        + h * torch.exp(-0.5 * h * h) / (2 * np.pi) ** 0.5
    _check_grads([dh, act, db1], [acc * grad, F.gelu(h), (acc * grad).sum(0)],
                 dtype)


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
    fwd0, bwd0 = fa.flash_attention.launches, fa.flash_attention.bwd_launches
    out, lse = fa._flash_fwd(q_src, kv_src, h, scale)
    grads = [t for t in fa._flash_bwd(q_src, kv_src, lse, dy, h, scale)
             if t is not None]
    assert (fa.flash_attention.launches, fa.flash_attention.bwd_launches) \
        == (fwd0 + 1, bwd0 + 1)
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
@pytest.mark.parametrize("m,d", [(2048, 384), (65536, 384), (4096, 512)])
def test_stash_pair_kernels_match_plain(cuda, dtype, m, d):
    """B9 forward (out, act, GELU′) and backward (dx and every parameter
    grad, the weight grads from the wgrad kernel)."""
    rng = np.random.default_rng(m + d)
    p = _params(rng, d, 4, 4)
    x, dy = (_on(rng.standard_normal((m, d)).astype(np.float32), cuda, dtype)
             for _ in range(2))
    args = [_on(p[k], cuda, dtype) for k in ("g", "be", "w1", "b1", "w2",
                                             "b2")]
    fwd0, bwd0 = fm.mlp_block.stash_launches, fm.mlp_block.stash_bwd_launches
    out, act, dg = fm._mlp_fwd_stash(x, *args)
    grads = fm._mlp_bwd_stash(x, dy, act, dg, *args[:3], args[4])
    assert (fm.mlp_block.stash_launches, fm.mlp_block.stash_bwd_launches) \
        == (fwd0 + 1, bwd0 + 1)
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
                                     (5000, 200, 136), (128, 8, 8)])
def test_weight_grad_and_colsum_kernels(cuda, dtype, m, n1, n2):
    """gᵀ·a over ragged row counts and widths against float math, and the
    column sums; both bit-identical on a rerun."""
    gen = torch.Generator(device="cuda").manual_seed(m + n1)
    g = torch.randn(m, n1, device=cuda, generator=gen).to(dtype)
    a = torch.randn(m, n2, device=cuda, generator=gen).to(dtype)
    got = runtime.weight_grad(g, a)
    want = g.double().t() @ a.double()
    assert got.dtype == torch.float32
    assert ((got.double() - want).norm() / want.norm()).item() < 1e-5
    assert torch.equal(got, runtime.weight_grad(g, a))
    cs = runtime.colsum(g)
    torch.testing.assert_close(cs.double(), g.double().sum(0), atol=1e-3,
                               rtol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,n,k", [(33, 192, 64), (65536, 1536, 384)])
def test_gemm_stash_and_dgelu_epilogues(cuda, dtype, m, n, k):
    gen = torch.Generator(device="cuda").manual_seed(m + n)
    a = torch.randn(m, k, device=cuda, generator=gen).to(dtype)
    w = (torch.randn(n, k, device=cuda, generator=gen) * k ** -0.5).to(dtype)
    b = torch.randn(n, device=cuda, generator=gen) * 0.1
    act, dg = runtime.gemm_gelu_stash(a, w, b)
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
    before = fm.mlp_block.acc_bwd_launches
    got = fm._mlp_bwd_acc(x, dy, *args, residual=residual)
    assert fm.mlp_block.acc_bwd_launches == before + 1
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
    before = ba.attn_half_block.acc_bwd_launches
    got = ba._attn_half_bwd_acc(x, dy, *args, h)
    assert ba.attn_half_block.acc_bwd_launches == before + 1
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


@pytest.mark.parametrize("keep", [1.0, 0.0])
def test_fused_adamw_kernel_matches_plain(cuda, keep):
    """B11 over leaves of every alignment (lengths not a multiple of 4
    included) in one launch against its plain version (rtol 1e-6); keep = 0
    leaves m, n and p bit for bit; a rerun gives the same bits."""
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
        if plain:
            with runtime.plain_on_card():
                fused_adamw(g, mm, nn_, pp, lrs, wds, **kw)
        else:
            fused_adamw(g, mm, nn_, pp, lrs, wds, **kw)
        return mm + nn_ + pp

    before = fused_adamw.launches
    got = run()
    assert fused_adamw.launches == before + 1
    assert fused_adamw.last_routed_count == 4
    assert all(torch.equal(a, b) for a, b in zip(got, run()))
    want = run(plain=True)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)
    if keep == 0.0:
        assert all(torch.equal(a, b) for a, b in zip(got, m + n + p))


def test_optimizer_with_the_fused_update_matches_foreach(cuda):
    """The optimizer's two routes on the card, from the same grads: the
    fused update (MIRAGE_OPT_KERNEL=on) and the foreach route."""
    from mirage_tpu_torch.ops.fused_adamw import fused_adamw
    from mirage_tpu_torch.train.optim import GroupedOptimizer, OptimizerConfig

    shapes = {"a.weight": (512, 512), "b.weight": (300, 450), "c.bias": (7,)}
    g, _, _, p = _adamw_state(cuda, list(shapes.values()), 6)
    grads = dict(zip(shapes, g))
    out = []
    for switch in ("off", "on"):
        params = {k: t.clone() for k, t in zip(shapes, p)}
        opt = GroupedOptimizer(OptimizerConfig(clip_grad=1.0, skip_grad=1e3))
        state = opt.init(params)
        with runtime.switched({"MIRAGE_OPT_KERNEL": switch}):
            for lr in (1e-2, 5e-3):
                opt.update(grads, state, params, lr)
        out.append((params, state))
    assert fused_adamw.last_routed_count == 2
    for key in ("a.weight", "b.weight", "c.bias"):
        torch.testing.assert_close(out[0][0][key], out[1][0][key], rtol=1e-6,
                                   atol=1e-7)
        for mom in ("mu", "nu"):
            torch.testing.assert_close(out[0][1][mom][key],
                                       out[1][1][mom][key], rtol=1e-6,
                                       atol=1e-7)


# B10: (batch, tokens, width, heads): head dims 16, 48, 32 and 64, ragged N
FUSED_CASES = [(2, 33, 64, 4), (2, 17, 192, 4), (3, 256, 256, 8),
               (2, 257, 1024, 16)]


@pytest.mark.parametrize("dtype,atol", DTYPES)
@pytest.mark.parametrize("b,n,d,h", FUSED_CASES)
@pytest.mark.parametrize("qkv_bias", [True, False])
def test_fused_block_kernel_matches_plain(cuda, dtype, atol, b, n, d, h,
                                          qkv_bias):
    """The one-launch whole block against its plain version (the two
    halves' plain versions) on the same inputs; one launch counted."""
    from mirage_tpu_torch.ops.fused_block import fused_block, fused_block_ref

    rng = np.random.default_rng(12)
    pa, pm = _params(rng, d, 1, 3), _params(rng, d, 4, 4)
    pl = _params(rng, d, 1, 1)
    args = [_on(a, cuda, dtype) for a in (
        rng.standard_normal((b, n, d)).astype(np.float32), pa["g"], pa["be"],
        pa["w1"], pa["b1"] if qkv_bias else None, pa["w2"], pa["b2"],
        pl["g"], pl["be"], pm["w1"], pm["b1"], pm["w2"], pm["b2"])]
    before = fused_block.launches
    got = fused_block(*args, h)
    assert fused_block.launches == before + 1
    want = fused_block_ref(*[a.float() if a is not None else None
                             for a in args], h)
    assert _max_err(got, want) <= atol


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
    before = quant.mlp_block_q.launches
    got = quant.mlp_block_q_kernel_parts(x, *ln, *qp)
    again = quant.mlp_block_q_kernel_parts(x, *ln, *qp)
    assert quant.mlp_block_q.launches == before + 2
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
    before = mlp_block_fwd_stash3d.launches
    out, act, dg = mlp_block_fwd_stash3d(*args, residual=residual,
                                         stash_flat=stash_flat)
    assert mlp_block_fwd_stash3d.launches == before + 1
    assert torch.equal(out, mlp_block(*args, residual=residual))
    want = mlp_block_fwd_stash3d_ref(*[a.float() for a in args],
                                     residual=residual,
                                     stash_flat=stash_flat)
    atol = 1e-4 if dtype == torch.float32 else 5e-2
    for g, w in zip((out, act, dg), want):
        assert g.shape == w.shape and _max_err(g, w) <= atol
