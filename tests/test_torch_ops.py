"""The PyTorch port's ops (mirage_tpu_torch/ops) against the JAX package.

On the CPU each op runs its plain PyTorch version; these tests hold that
version to the JAX Pallas kernel run in interpret mode and to the JAX
package's XLA reference, on the same float32 inputs made with numpy, at
atol 3e-5 / rtol 1e-4 (the tolerance tests/test_flash_attention.py uses for
the kernel-vs-XLA comparisons). tests/test_torch_kernels.py holds each CUDA
kernel to its plain version on a card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mirage_tpu.ops.block_attention import (_attn_half_fwd, _attn_half_xla,
                                            _xattn_half_xla, xattn_half_block)
from mirage_tpu.ops.fused_mlp import _mlp_block_xla
from mirage_tpu.ops.fused_mlp import mlp_block as jax_mlp_block
from mirage_tpu_torch.ops import runtime
from mirage_tpu_torch.ops import block_attention as port_attn
from mirage_tpu_torch.ops.block_attention import (attn_half_block,
                                                  attn_half_block_ref)
from mirage_tpu_torch.ops.fused_mlp import mlp_block
from mirage_tpu_torch.ops.patch_embed import patchify, unpatchify

TOL = dict(atol=3e-5, rtol=1e-4)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _params(rng, d, hidden_mult, n_fused, bias=True):
    """LN scale/shift + a fused (d, n_fused·d) projection + (d, d) output
    projection, JAX (in, out) layout, float32."""
    f = np.float32
    p = {"g": (1 + 0.1 * rng.standard_normal(d)).astype(f),
         "be": (0.05 * rng.standard_normal(d)).astype(f),
         "w1": (rng.standard_normal((d, n_fused * d)) / np.sqrt(d)).astype(f),
         "b1": (0.02 * rng.standard_normal(n_fused * d)).astype(f),
         "w2": (rng.standard_normal((hidden_mult * d, d))
                / np.sqrt(hidden_mult * d)).astype(f),
         "b2": (0.02 * rng.standard_normal(d)).astype(f)}
    if not bias:
        p["b1"] = np.zeros_like(p["b1"])
    return p


def _input(rng, shape, large_mean=False):
    x = rng.standard_normal(shape).astype(np.float32)
    if large_mean:  # per-channel offsets up to ~30: mean^2/var ~ 1e3
        x += (30.0 * rng.standard_normal(shape[-1])).astype(np.float32)
    return x


# (batch, tokens, width, heads): head dims 16, 32 and 48, ragged N
ATTN_CASES = [(2, 33, 64, 4), (2, 33, 64, 2), (1, 257, 96, 2),
              (2, 17, 192, 4)]


@pytest.mark.parametrize("b,n,d,h", ATTN_CASES)
@pytest.mark.parametrize("large_mean", [False, True])
def test_attn_half_block_matches_jax(b, n, d, h, large_mean):
    rng = np.random.default_rng(n * d + h)
    p = _params(rng, d, 1, 3)
    x = _input(rng, (b, n, d), large_mean)
    jargs = [jnp.asarray(a) for a in (x, p["g"], p["be"], p["w1"], p["b1"],
                                      p["w2"], p["b2"])]
    scale = (d // h) ** -0.5
    got = attn_half_block(_t(x), _t(p["g"]), _t(p["be"]), _t(p["w1"].T),
                          _t(p["b1"]), _t(p["w2"].T), _t(p["b2"]), h).numpy()
    np.testing.assert_allclose(
        got, np.asarray(_attn_half_xla(*jargs, h, scale)), **TOL)
    # the Pallas kernel computes its LN variance in one pass (E[x²]-mean²),
    # which loses digits when |mean| >> std; the port's LN takes two passes
    kernel_tol = dict(atol=2e-3, rtol=1e-3) if large_mean else TOL
    np.testing.assert_allclose(
        got, np.asarray(_attn_half_fwd(*jargs, num_heads=h, scale=scale,
                                       interpret=True)), **kernel_tol)


@pytest.mark.parametrize("b,n,d", [(2, 33, 64), (1, 257, 96), (3, 16, 32)])
@pytest.mark.parametrize("residual", [True, False])
@pytest.mark.parametrize("large_mean", [False, True])
def test_mlp_block_matches_jax(b, n, d, residual, large_mean):
    rng = np.random.default_rng(n * d + residual)
    p = _params(rng, d, 4, 4)
    x = _input(rng, (b, n, d), large_mean)
    jp = ({"scale": jnp.asarray(p["g"]), "bias": jnp.asarray(p["be"])},
          {"fc1": {"w": jnp.asarray(p["w1"]), "b": jnp.asarray(p["b1"])},
           "fc2": {"w": jnp.asarray(p["w2"]), "b": jnp.asarray(p["b2"])}})
    got = mlp_block(_t(x), _t(p["g"]), _t(p["be"]), _t(p["w1"].T),
                    _t(p["b1"]), _t(p["w2"].T), _t(p["b2"]),
                    residual=residual).numpy()
    want = np.asarray(_mlp_block_xla(jnp.asarray(x), p["g"], p["be"],
                                     p["w1"], p["b1"], p["w2"], p["b2"]))
    if not residual:
        want = want - x
    np.testing.assert_allclose(got, want, atol=1e-4 if large_mean else 3e-5,
                               rtol=1e-4)
    kernel_tol = dict(atol=2e-3, rtol=1e-3) if large_mean else TOL
    np.testing.assert_allclose(
        got, np.asarray(jax_mlp_block(jnp.asarray(x), *jp, interpret=True,
                                      residual=residual)), **kernel_tol)


@pytest.mark.parametrize("b,nq,nc,d,h", [(2, 16, 33, 64, 4), (1, 33, 29, 64, 2),
                                         (1, 24, 17, 96, 2)])
@pytest.mark.parametrize("bias", [True, False])
def test_xattn_half_block_matches_jax(b, nq, nc, d, h, bias):
    rng = np.random.default_rng(nq * nc + d)
    f = np.float32
    pq = _params(rng, d, 1, 1, bias)   # q projection + output projection
    pc = _params(rng, d, 1, 2, bias)   # context LN + kv projection
    x, ctx = _input(rng, (b, nq, d)), _input(rng, (b, nc, d))
    jcross = {"q": {"w": jnp.asarray(pq["w1"])},
              "kv": {"w": jnp.asarray(pc["w1"])},
              "proj": {"w": jnp.asarray(pq["w2"]), "b": jnp.asarray(pq["b2"])}}
    if bias:
        jcross["q"]["b"] = jnp.asarray(pq["b1"])
        jcross["kv"]["b"] = jnp.asarray(pc["b1"])
    qn = {"scale": jnp.asarray(pq["g"]), "bias": jnp.asarray(pq["be"])}
    cn = {"scale": jnp.asarray(pc["g"]), "bias": jnp.asarray(pc["be"])}
    targs = (_t(x), _t(ctx), _t(pq["g"]), _t(pq["be"]), _t(pc["g"]),
             _t(pc["be"]), _t(pq["w1"].T), _t(pq["b1"]) if bias else None,
             _t(pc["w1"].T), _t(pc["b1"]) if bias else None, _t(pq["w2"].T),
             _t(pq["b2"]), h)
    got = port_attn.xattn_half_block(*targs).numpy()
    zeros = np.zeros
    want = _xattn_half_xla(
        jnp.asarray(x), jnp.asarray(ctx), pq["g"], pq["be"], pc["g"],
        pc["be"], pq["w1"], pq["b1"] if bias else zeros(d, f), pc["w1"],
        pc["b1"] if bias else zeros(2 * d, f), pq["w2"], pq["b2"], h,
        (d // h) ** -0.5)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    np.testing.assert_allclose(
        got, np.asarray(xattn_half_block(jnp.asarray(x), qn, cn, jcross,
                                         jnp.asarray(ctx), h,
                                         interpret=True)), **TOL)
    # residual=False: the decoder's form, the same branch without x
    branch = port_attn.xattn_half_block(*targs, residual=False).numpy()
    np.testing.assert_allclose(branch, np.asarray(want) - x, **TOL)


def test_ops_take_the_plain_version_on_cpu():
    """On a CPU tensor an op is exactly its plain version and launches
    nothing."""
    rng = np.random.default_rng(0)
    p = _params(rng, 32, 1, 3)
    x = _t(_input(rng, (2, 9, 32)))
    args = (x, _t(p["g"]), _t(p["be"]), _t(p["w1"].T), None, _t(p["w2"].T),
            _t(p["b2"]), 2)
    before = attn_half_block.launches
    assert torch.equal(attn_half_block(*args), attn_half_block_ref(*args))
    assert attn_half_block.launches == before
    assert not runtime.use_kernel(x)


def test_patchify_unpatchify_round_trip():
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 3, 8, 12)).astype(np.float32))
    p = patchify(x, 4, 4)
    assert p.shape == (2, 6, 48)
    assert torch.equal(unpatchify(p, 2, 3, 4, 4, 3), x)


def test_resolve_device_cuda_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        runtime.resolve_device("cuda")
    assert runtime.resolve_device("cpu") == torch.device("cpu")


# ------------------------------------------------------------ backward ops
#
# Each plain backward (the function a CPU tensor's backward runs, and the
# card's reference) against the JAX Pallas backward kernel in interpret mode
# and against torch.autograd.grad of the plain forward, float32, at the
# atol 5e-4 / rtol 1e-3 tests/test_flash_attention.py holds the Pallas
# backwards to (their parameter grads sum over every row).

from mirage_tpu.ops.block_attention import (_attn_half_bwd_defused,  # noqa: E402
                                            _block_attn_bwd)
from mirage_tpu.ops.fused_mlp import _mlp_block_bwd_defused  # noqa: E402
from mirage_tpu_torch.ops.block_attention import (  # noqa: E402
    attn_half_block_bwd_ref, block_attention, block_attention_bwd_ref,
    block_attention_ref)
from mirage_tpu_torch.ops.fused_mlp import (mlp_block_bwd_ref,  # noqa: E402
                                            mlp_block_ref)

BWD_TOL = dict(atol=5e-4, rtol=1e-3)
ATTN_NAMES = ["dx", "dgamma", "dbeta", "dwqkv", "dbqkv", "dwproj", "dbproj"]
MLP_NAMES = ["dx", "dgamma", "dbeta", "dw1", "db1", "dw2", "db2"]


def _close(got, want, names, transposed, tol, **kw):
    """got: torch (torch layout), want: JAX (JAX layout)."""
    for name, g, w in zip(names, got, want):
        w = np.asarray(w)
        if name in transposed:
            w = w.T
        np.testing.assert_allclose(g.detach().numpy().reshape(w.shape), w,
                                   err_msg=f"{name} {kw}", **tol)


# (batch, tokens, width, heads): head dims 16 and 32, ragged N 33 and 99
BWD_ATTN_CASES = [(2, 33, 64, 4), (2, 33, 64, 2), (1, 99, 64, 2)]


@pytest.mark.parametrize("b,n,d,h", BWD_ATTN_CASES)
@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("large_mean", [False, True])
def test_attn_half_block_bwd_matches_jax_kernel(b, n, d, h, bias, large_mean):
    rng = np.random.default_rng(n * d + h + 7 * bias)
    p = _params(rng, d, 1, 3, bias)
    x, dy = _input(rng, (b, n, d), large_mean), _input(rng, (b, n, d))
    got = attn_half_block_bwd_ref(
        _t(x), _t(dy), _t(p["g"]), _t(p["be"]), _t(p["w1"].T),
        _t(p["b1"]) if bias else None, _t(p["w2"].T), h)
    want = _attn_half_bwd_defused(
        jnp.asarray(x), jnp.asarray(dy), p["g"], p["be"], p["w1"], p["b1"],
        p["w2"], h, (d // h) ** -0.5, interpret=True)
    if not bias:
        assert got[4] is None  # no qkv bias, no bias grad
        got, want = got[:4] + got[5:], want[:4] + want[5:]
    names = [nm for nm in ATTN_NAMES if bias or nm != "dbqkv"]
    # the Pallas kernel's one-pass LN variance loses digits at |mean| >> std
    # (ROADMAP queue C, fault 2); the port takes two passes
    tol = dict(atol=1e-2, rtol=1e-2) if large_mean else BWD_TOL
    _close(got, want, names, {"dwqkv", "dwproj"}, tol, b=b, n=n, h=h)


@pytest.mark.parametrize("m,d", [(66, 64), (99, 32)])
@pytest.mark.parametrize("residual", [True, False])
@pytest.mark.parametrize("large_mean", [False, True])
def test_mlp_block_bwd_matches_jax_kernel(m, d, residual, large_mean):
    rng = np.random.default_rng(m * d + residual)
    p = _params(rng, d, 4, 4)
    x, dy = _input(rng, (m, d), large_mean), _input(rng, (m, d))
    got = mlp_block_bwd_ref(_t(x), _t(dy), _t(p["g"]), _t(p["be"]),
                            _t(p["w1"].T), _t(p["b1"]), _t(p["w2"].T),
                            residual=residual)
    want = list(_mlp_block_bwd_defused(
        jnp.asarray(x), jnp.asarray(dy), p["g"], p["be"], p["w1"], p["b1"],
        p["w2"], interpret=True))
    if not residual:  # fused_mlp.py:_mlp_block_nores_bwd_vjp
        want[0] = want[0] - dy
    tol = dict(atol=1e-2, rtol=1e-2) if large_mean else BWD_TOL
    _close(got, want, MLP_NAMES, {"dw1", "dw2"}, tol, m=m, residual=residual)


@pytest.mark.parametrize("b,n,d,h", [(2, 33, 64, 4), (2, 99, 64, 2),
                                     (1, 17, 96, 3)])
def test_block_attention_bwd_matches_jax_kernel(b, n, d, h):
    rng = np.random.default_rng(n + d)
    qkv, dy = _input(rng, (b, n, 3 * d)), _input(rng, (b, n, d))
    scale = (d // h) ** -0.5
    got = block_attention_bwd_ref(_t(qkv), _t(dy), h, scale).numpy()
    want = _block_attn_bwd(jnp.asarray(qkv), jnp.asarray(dy), h, scale,
                           interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), atol=2e-5, rtol=1e-4)


def _grads_of(fn, args, dy):
    args = [a.clone().requires_grad_() if torch.is_tensor(a) else a
            for a in args]
    out = fn(*args)
    tensors = [a for a in args if torch.is_tensor(a)]
    return torch.autograd.grad(out, tensors, dy)


@pytest.mark.parametrize("bias", [True, False])
def test_backward_refs_match_autograd_of_the_forward(bias):
    """The plain backwards are the exact gradients of the plain forwards
    (float32: the backwards round nothing there)."""
    rng = np.random.default_rng(3)
    b, n, d, h = 2, 33, 64, 4
    p = _params(rng, d, 1, 3)
    x, dy = _t(_input(rng, (b, n, d))), _t(_input(rng, (b, n, d)))
    args = [x, _t(p["g"]), _t(p["be"]), _t(p["w1"].T),
            _t(p["b1"]) if bias else None, _t(p["w2"].T), _t(p["b2"])]
    want = _grads_of(lambda *a: attn_half_block_ref(*a, h), args, dy)
    got = [g for g in attn_half_block_bwd_ref(x, dy, *args[1:6], h)
           if g is not None]
    for name, g, w in zip([nm for nm in ATTN_NAMES if bias or nm != "dbqkv"],
                          got, want):
        torch.testing.assert_close(g, w, atol=2e-5, rtol=1e-4, msg=name)

    p = _params(rng, d, 4, 4)
    margs = [x, _t(p["g"]), _t(p["be"]), _t(p["w1"].T), _t(p["b1"]),
             _t(p["w2"].T), _t(p["b2"])]
    for residual in (True, False):
        want = _grads_of(lambda *a: mlp_block_ref(*a, residual=residual),
                         margs, dy)
        got = mlp_block_bwd_ref(x, dy, *margs[1:6], residual=residual)
        for name, g, w in zip(MLP_NAMES, got, want):
            torch.testing.assert_close(g, w, atol=2e-5, rtol=1e-4, msg=name)

    qkv = _t(_input(rng, (b, n, 3 * d)))
    (want,) = _grads_of(lambda t: block_attention_ref(t, h, 0.25), [qkv], dy)
    torch.testing.assert_close(block_attention_bwd_ref(qkv, dy, h, 0.25),
                               want, atol=2e-5, rtol=1e-4)


def _f64(rng, *shape, scale=1.0):
    return torch.from_numpy(rng.standard_normal(shape) * scale).requires_grad_()


@pytest.mark.parametrize("op", ["attn_half_block", "mlp_block",
                                "mlp_block_nores", "block_attention"])
def test_autograd_functions_gradcheck(op):
    """The autograd wiring of each op (argument order, the None bias, the
    residual forms) by finite differences in float64 at a tiny size; on the
    CPU the Functions' backwards are the plain backwards."""
    rng = np.random.default_rng(11)
    if op == "attn_half_block":
        args = [_f64(rng, 1, 5, 8), 1 + _f64(rng, 8, scale=0.1),
                _f64(rng, 8, scale=0.1), _f64(rng, 24, 8, scale=0.3), None,
                _f64(rng, 8, 8, scale=0.3), _f64(rng, 8, scale=0.1)]
        fn = lambda *a: attn_half_block(*a, 2)  # noqa: E731
    elif op == "block_attention":
        args = [_f64(rng, 2, 5, 24)]
        fn = lambda t: block_attention(t, 2, 0.5)  # noqa: E731
    else:
        args = [_f64(rng, 1, 5, 8), 1 + _f64(rng, 8, scale=0.1),
                _f64(rng, 8, scale=0.1), _f64(rng, 32, 8, scale=0.3),
                _f64(rng, 32, scale=0.1), _f64(rng, 8, 32, scale=0.3),
                _f64(rng, 8, scale=0.1)]
        fn = lambda *a: mlp_block(  # noqa: E731
            *a, residual=op == "mlp_block")
    args = [a.detach().requires_grad_() if a is not None else None
            for a in args]
    assert torch.autograd.gradcheck(fn, args)


# ---------------------------------------------- the accumulating backwards
#
# B7's plain versions against the JAX package's accumulating Pallas
# backwards run in interpret mode, at the same atol 5e-4 / rtol 1e-3. The
# JAX MLP backward reads its switch (_MLP_BWD_IMPL) while tracing, so the
# test sets it with monkeypatch and clears JAX's caches around the call.

from mirage_tpu.ops.block_attention import _attn_half_bwd_pallas  # noqa: E402
from mirage_tpu_torch.ops.block_attention import (  # noqa: E402
    attn_half_block_bwd_acc_ref)
from mirage_tpu_torch.ops.fused_mlp import mlp_block_bwd_acc_ref  # noqa: E402


@pytest.mark.parametrize("shape", [(3, 33, 48), (2, 16, 64), (96, 48)])
@pytest.mark.parametrize("residual", [True, False])
def test_mlp_block_bwd_acc_matches_jax_kernel(monkeypatch, shape, residual):
    """(3, 33, 48) takes the per-element 3-D route (99 rows admit no block,
    144 padded rows are not a multiple of 1024), (2, 16, 64) the aligned
    flatten, (96, 48) the 2-D rows."""
    import jax

    from mirage_tpu.ops import fused_mlp as jfm

    d = shape[-1]
    rng = np.random.default_rng(d + len(shape) + residual)
    p = _params(rng, d, 4, 4)
    x, dy = _input(rng, shape), _input(rng, shape)
    monkeypatch.setattr(jfm, "_MLP_BWD_IMPL", "accumulate")
    jax.clear_caches()
    try:
        want = list(jfm._mlp_block_bwd_pallas(
            jnp.asarray(x), jnp.asarray(dy), p["g"], p["be"], p["w1"],
            p["b1"], p["w2"], interpret=True))
    finally:
        jax.clear_caches()
    if not residual:  # fused_mlp.py:_mlp_block_nores_bwd_vjp
        want[0] = want[0] - dy
    got = mlp_block_bwd_acc_ref(_t(x), _t(dy), _t(p["g"]), _t(p["be"]),
                                _t(p["w1"].T), _t(p["b1"]), _t(p["w2"].T),
                                residual=residual)
    _close(got, want, MLP_NAMES, {"dw1", "dw2"}, BWD_TOL, shape=shape,
           residual=residual)


@pytest.mark.parametrize("b,n,d,h", [(4, 24, 64, 4), (2, 33, 64, 2)])
@pytest.mark.parametrize("reg_batch", [False, True])
def test_attn_half_block_bwd_acc_matches_jax_kernel(b, n, d, h, reg_batch):
    """Both accumulation orders of the TPU kernel (reg_batch) against the
    one plain version: they sum the same terms."""
    rng = np.random.default_rng(n * d + h + reg_batch)
    p = _params(rng, d, 1, 3)
    x, dy = _input(rng, (b, n, d)), _input(rng, (b, n, d))
    want = _attn_half_bwd_pallas(
        jnp.asarray(x), jnp.asarray(dy), p["g"], p["be"], p["w1"], p["b1"],
        p["w2"], h, (d // h) ** -0.5, interpret=True, reg_batch=reg_batch)
    got = attn_half_block_bwd_acc_ref(
        _t(x), _t(dy), _t(p["g"]), _t(p["be"]), _t(p["w1"].T), _t(p["b1"]),
        _t(p["w2"].T), h)
    _close(got, want, ATTN_NAMES, {"dwqkv", "dwproj"}, BWD_TOL, b=b, n=n,
           reg_batch=reg_batch)


@pytest.mark.parametrize("switch", ["accumulate", "reg_batch", "defused"])
def test_attn_half_backward_follows_the_switch(monkeypatch, switch):
    """MIRAGE_ATTN_BWD picks the attention half's backward: B4 under
    defused, B7 under accumulate and reg_batch; the gradients agree."""
    from mirage_tpu_torch.ops import block_attention as ba

    calls = []
    for name in ("_attn_half_bwd", "_attn_half_bwd_acc"):
        orig = getattr(ba, name)

        def spy(*a, _orig=orig, _name=name):
            calls.append(_name)
            return _orig(*a)
        monkeypatch.setattr(ba, name, spy)
    rng = np.random.default_rng(21)
    p = _params(rng, 32, 1, 3)
    args = [_t(_input(rng, (2, 9, 32))).requires_grad_()] + [
        _t(p[k] if k in ("g", "be", "b1", "b2") else p[k].T).requires_grad_()
        for k in ("g", "be", "w1", "b1", "w2", "b2")]
    with runtime.switched({"MIRAGE_ATTN_BWD": switch}):
        out = attn_half_block(*args, 2)
        grads = torch.autograd.grad(out.square().sum(), args)
    assert calls == ["_attn_half_bwd" if switch == "defused"
                     else "_attn_half_bwd_acc"]
    want = _grads_of(lambda *a: attn_half_block_ref(*a, 2), args,
                     2 * attn_half_block_ref(*args, 2).detach())
    for g, w in zip(grads, want):
        torch.testing.assert_close(g, w, atol=2e-5, rtol=1e-4)


def test_switches_validate_and_restore():
    """The four switches keep the JAX package's names, values and
    defaults; an unknown value raises, as mirage_tpu/utils/envflags.py
    does; switched() restores the old values."""
    from mirage_tpu.utils.envflags import env_choice as jax_env_choice

    for name, (default, allowed) in runtime.SWITCHES.items():
        assert runtime.switches[name] == jax_env_choice(name, default,
                                                        allowed)
    assert runtime.SWITCHES == {
        "MIRAGE_OPT_KERNEL": ("off", ("on", "off")),
        "MIRAGE_MLP_BWD": ("defused", ("accumulate", "defused")),
        "MIRAGE_ATTN_BWD": ("defused", ("accumulate", "reg_batch",
                                        "defused")),
        "MIRAGE_BLOCK_FUSE": ("off", ("off", "decoder", "all"))}
    with pytest.raises(ValueError, match="MIRAGE_MLP_BWD"):
        runtime.set_switch("MIRAGE_MLP_BWD", "acumulate")
    before = dict(runtime.switches)
    with runtime.switched({"MIRAGE_OPT_KERNEL": "on",
                           "MIRAGE_ATTN_BWD": "reg_batch"}):
        assert runtime.switches["MIRAGE_OPT_KERNEL"] == "on"
    assert runtime.switches == before
