"""MLP half-block: out = x + fc2(GELU_erf(fc1(LN(x)))).

Replaces ``mirage_tpu/ops/fused_mlp.py:_mlp_block_fwd`` / ``_mlp_kernel``
(B2, the Pallas kernel that keeps the whole half-block in VMEM) and, as its
backward, ``_mlp_block_bwd_defused`` / ``_mlp_bwd_dx_kernel`` (B5). On the
card the forward runs as three CUDA kernels: LayerNorm (csrc/layernorm.cu),
fc1 with bias and GELU in the epilogue, then fc2 with bias and the residual
in the epilogue (csrc/gemm.cu, wgmma). The backward recomputes LN and
h = y·W1ᵀ + b1 (float output), runs dact = dy·W2 with the GELU backward in
its epilogue (dh = T(dact·GELU′(h)), act = T(GELU(h)), float partials of db1
from the unrounded dh), then dyln = dh·W1 (float output) and the LN
backward; dW1, dW2 and db2 are contractions outside, as in the JAX package
(:511-523). Bound: operations (2·M·D·4D·2 FLOPs forward, twice that and the
recompute backward). This first version writes the LN output, the (M, 4D)
hidden (and, backward, h in float, dh and act) to device memory between the
kernels — the first traffic a later PR fuses away. The products with a
non-transposed weight pass it transposed (a copy per call).
``residual=False`` drops the skip-add; its backward is the residual one
minus the pass-through cotangent (dx = T(dx_res) − dy, fused_mlp.py:976-981).

``stash=True`` (the ConvNeXt head of segmentation tuning) takes the stash
pair where the JAX package's ``_stash_route`` admits the shape (2-D rows,
d ≥ 384, a row count with a backward block): B9, replacing
``_mlp_block_fwd_stash`` / ``_mlp_fwd_stash_kernel`` and
``_mlp_block_bwd_stash`` / ``_mlp_bwd_stash_kernel``. Its forward is B2's
chain with the stash epilogue on fc1, which also writes act = T(GELU(h))
and dg = T(GELU′(h)) for the backward (csrc/gemm.cu); its backward runs no
recompute and no transcendental: dact = dy·W2 with the epilogue dh =
T(dact·dg) and float 16-row partials of db1, dyln = dh·W1 in float, LN
recomputed for y and the LN backward (csrc/layernorm.cu), and dW1 = dhᵀ·y,
dW2 = dyᵀ·act, db2 = Σ dy and the reductions of the partials in the wgrad
kernels (csrc/wgrad.cu: fixed row chunks, fixed order), since the TPU
kernel sums them in its own body (:713-727). Bound: operations (2·M·D·4D·2
FLOPs forward, twice that backward). Without a gradient it is B2's forward,
as the JAX custom VJP's primal is (:814-817).
"""

import torch

from mirage_tpu_torch.nn.layers import acc_dtype, gelu, layer_norm, linear
from mirage_tpu_torch.ops import runtime
from mirage_tpu_torch.ops.block_attention import _needs_grad, ln_bwd_ref

_INV_SQRT2 = 0.7071067811865476
_INV_SQRT_2PI = 0.3989422804014327


def mlp_block_ref(x, ln_w, ln_b, w1, b1, w2, b2, residual=True):
    """Plain PyTorch version (mirage_tpu/ops/fused_mlp.py:_mlp_block_xla)."""
    h = linear(gelu(linear(layer_norm(x, ln_w, ln_b), w1, b1)), w2, b2)
    return x + h if residual else h


def mlp_block_bwd_ref(x, dy, ln_w, ln_b, w1, b1, w2, residual=True):
    """Plain PyTorch backward, step by step as _mlp_bwd_rows: y = T(LN(x)),
    h = y·W1ᵀ + b1 in float, act = T(GELU(h)); dact = dy·W2 in float,
    dh = dact·GELU′(h) (db1 from it), dyln = T(dh)·W1 in float; the LN
    backward. Returns (dx, dgamma, dbeta, dw1, db1, dw2, db2) as
    _mlp_block_bwd_defused does, parameter grads in float and in torch
    layout (dw1 (4D, D), dw2 (D, 4D))."""
    dt, acc = x.dtype, acc_dtype(x)
    w1c, w2c = w1.to(dt).to(acc), w2.to(dt).to(acc)
    y = layer_norm(x, ln_w, ln_b)
    h = y.to(acc) @ w1c.t() + b1.to(acc)
    e = torch.erf(h * _INV_SQRT2)
    act = (0.5 * h * (1.0 + e)).to(dt)
    dy32 = dy.to(acc)
    dh = (dy32 @ w2c) * (0.5 * (1.0 + e)
                         + h * torch.exp(-0.5 * h * h) * _INV_SQRT_2PI)
    dims = tuple(range(x.ndim - 1))
    dh_c = dh.to(dt).to(acc)
    dx, dgamma, dbeta = ln_bwd_ref(x, dh_c @ w1c, ln_w, dy)
    dx = dx.to(dt)
    if not residual:
        dx = dx - dy
    rows = lambda t: t.reshape(-1, t.shape[-1])  # noqa: E731
    return (dx, dgamma, dbeta, rows(dh_c).t() @ rows(y.to(acc)), dh.sum(dims),
            rows(dy32).t() @ rows(act.to(acc)), dy32.sum(dims))


def _mlp_fwd(x, ln_w, ln_b, w1, b1, w2, b2, residual):
    if not runtime.use_kernel(x):
        return mlp_block_ref(x, ln_w, ln_b, w1, b1, w2, b2, residual)
    runtime.check("x", x, x)
    x2 = x.view(-1, x.shape[-1])
    y = runtime.layernorm(x2, ln_w, ln_b)
    h = runtime.gemm(y, w1.to(x.dtype), b1, gelu=True)
    out = runtime.gemm(h, w2.to(x.dtype), b2,
                       residual=x2 if residual else None)
    mlp_block.launches += 1
    return out.view(x.shape)


def _mlp_bwd(x, dy, ln_w, ln_b, w1, b1, w2, residual=True):
    """B5 on the card: the recompute, the GELU backward (in the dact GEMM's
    epilogue) and the LN backward as CUDA kernels; dW1, dW2, db2 outside."""
    if not runtime.use_kernel(x):
        return mlp_block_bwd_ref(x, dy, ln_w, ln_b, w1, b1, w2, residual)
    runtime.check("x", x, x)
    d = x.shape[-1]
    x2, dy2 = x.view(-1, d), dy.contiguous().view(-1, d)
    w1c = w1.to(x.dtype).contiguous()
    y = runtime.layernorm(x2, ln_w, ln_b)
    h = runtime.gemm(y, w1c, b1, out_dtype=torch.float32)
    dh, act, db1 = runtime.gemm_gelu_bwd(
        dy2, w2.to(x.dtype).t().contiguous(), h)
    del h
    dyln = runtime.gemm(dh, w1c.t().contiguous(), out_dtype=torch.float32)
    dx, dgamma, dbeta = runtime.layernorm_bwd(x2, ln_w, dyln, dy2,
                                              sub_dy=not residual)
    mlp_block.bwd_launches += 1
    return (dx.view(x.shape), dgamma, dbeta, runtime.wgrad(dh, y), db1,
            runtime.wgrad(dy2, act), dy2.float().sum(0))


class _MlpBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ln_w, ln_b, w1, b1, w2, b2, residual):
        ctx.save_for_backward(x, ln_w, ln_b, w1, b1, w2)
        ctx.residual = residual
        return _mlp_fwd(x, ln_w, ln_b, w1, b1, w2, b2, residual)

    @staticmethod
    def backward(ctx, dy):
        x, *params = ctx.saved_tensors
        return (*_mlp_bwd(x, dy, *params, ctx.residual), None)


# ------------------------------------------------------------------ B9

def _pick_bwd_block(m, d, hdim, live_bytes_per_row_unit, fixed_bytes,
                    budget=48 * 2 ** 20, ceiling=58 * 2 ** 20):
    """The JAX package's row block for its sequential backward grid
    (mirage_tpu/ops/fused_mlp.py:287-307), kept so the port stashes exactly
    where it does: the largest divisor of m within the VMEM budget, then
    within the ceiling, else None (no divisor: ragged m)."""
    for cand in (4096, 2048, 1024, 512, 256, 128, 64, 32, 16, 8):
        if m % cand == 0 and cand * hdim * live_bytes_per_row_unit \
                + fixed_bytes < budget:
            return cand
    for cand in (512, 256, 128, 64, 32, 16, 8):
        if m % cand == 0 and cand * hdim * live_bytes_per_row_unit \
                + fixed_bytes < ceiling:
            return cand
    return None


def _stash_viable(m, d, hdim):
    """(mirage_tpu/ops/fused_mlp.py:781-786)"""
    return _pick_bwd_block(m, d, hdim, 14, 12 * d * hdim) is not None


def stash_route(x, hdim):
    """"2d" where the JAX package stashes (mirage_tpu/ops/fused_mlp.py:
    789-811: 2-D rows at d ≥ 384 with a viable backward block), else None
    (the recompute backward, B5)."""
    d = x.shape[-1]
    if d < 384 or x.ndim != 2:
        return None
    return "2d" if _stash_viable(x.shape[0], d, hdim) else None


def mlp_block_fwd_stash_ref(x, ln_w, ln_b, w1, b1, w2, b2):
    """Plain stash forward, as _mlp_fwd_stash_kernel: (out, act, dg) with
    h = T(LN(x))·W1ᵀ + b1 in float, act = T(GELU(h)), dg = T(GELU′(h)), out =
    x + T(act·W2ᵀ + b2); out equals mlp_block's."""
    dt, acc = x.dtype, acc_dtype(x)
    y = layer_norm(x, ln_w, ln_b)
    h = y.to(acc) @ w1.to(dt).to(acc).t() + b1.to(acc)
    e = torch.erf(h * _INV_SQRT2)
    act = (0.5 * h * (1.0 + e)).to(dt)
    dg = (0.5 * (1.0 + e) + h * torch.exp(-0.5 * h * h) * _INV_SQRT_2PI).to(dt)
    o = act.to(acc) @ w2.to(dt).to(acc).t() + b2.to(acc)
    return x + o.to(dt), act, dg


def mlp_block_bwd_stash_ref(x, dy, act, dg, ln_w, ln_b, w1, w2):
    """Plain stash backward, step by step as _mlp_bwd_stash_kernel: dact =
    dy·W2, dh = dact·dg in float (db1 from it), dyln = T(dh)·W1 in float, the
    LN backward, dW1 = T(dh)ᵀ·y, dW2 = dyᵀ·act, db2 = Σ dy. Returns (dx,
    dgamma, dbeta, dw1, db1, dw2, db2), parameter grads in float and torch
    layout."""
    dt, acc = x.dtype, acc_dtype(x)
    y = layer_norm(x, ln_w, ln_b).to(acc)
    dy32 = dy.to(acc)
    dh = (dy32 @ w2.to(dt).to(acc)) * dg.to(acc)
    dh_c = dh.to(dt).to(acc)
    dx, dgamma, dbeta = ln_bwd_ref(x, dh_c @ w1.to(dt).to(acc), ln_w, dy)
    return (dx.to(dt), dgamma, dbeta, dh_c.t() @ y, dh.sum(0),
            dy32.t() @ act.to(acc), dy32.sum(0))


def _mlp_fwd_stash(x, ln_w, ln_b, w1, b1, w2, b2):
    """B9 forward on the card: LN, fc1 with the stash epilogue, fc2 with
    bias and residual."""
    if not runtime.use_kernel(x):
        return mlp_block_fwd_stash_ref(x, ln_w, ln_b, w1, b1, w2, b2)
    runtime.check("x", x, x)
    y = runtime.layernorm(x, ln_w, ln_b)
    act, dg = runtime.gemm_gelu_stash(y, w1.to(x.dtype), b1)
    out = runtime.gemm(act, w2.to(x.dtype), b2, residual=x)
    mlp_block.stash_launches += 1
    return out, act, dg


def _mlp_bwd_stash(x, dy, act, dg, ln_w, ln_b, w1, w2):
    """B9 backward on the card: every product and every sum a CUDA kernel."""
    if not runtime.use_kernel(x):
        return mlp_block_bwd_stash_ref(x, dy, act, dg, ln_w, ln_b, w1, w2)
    runtime.check("x", x, x)
    dy = dy.contiguous()
    dh, db1 = runtime.gemm_dgelu_mul(dy, w2.to(x.dtype).t().contiguous(), dg)
    dyln = runtime.gemm(dh, w1.to(x.dtype).t().contiguous(),
                        out_dtype=torch.float32)
    y = runtime.layernorm(x, ln_w, ln_b)
    dx, dgamma, dbeta = runtime.layernorm_bwd(x, ln_w, dyln, dy,
                                              partials=True)
    grads = (dx, runtime.colsum(dgamma), runtime.colsum(dbeta),
             runtime.weight_grad(dh, y), runtime.colsum(db1),
             runtime.weight_grad(dy, act), runtime.colsum(dy))
    mlp_block.stash_bwd_launches += 1
    return grads


class _MlpBlockStash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ln_w, ln_b, w1, b1, w2, b2):
        out, act, dg = _mlp_fwd_stash(x, ln_w, ln_b, w1, b1, w2, b2)
        ctx.save_for_backward(x, ln_w, ln_b, w1, w2, act, dg)
        return out

    @staticmethod
    def backward(ctx, dy):
        x, ln_w, ln_b, w1, w2, act, dg = ctx.saved_tensors
        return _mlp_bwd_stash(x, dy, act, dg, ln_w, ln_b, w1, w2)


def mlp_block(x, ln_w, ln_b, w1, b1, w2, b2, residual=True, stash=False):
    """x: (..., D); w1 (4D, D), w2 (D, 4D) torch Linear layout.
    Differentiable (B5 backward on the card, or with ``stash`` the B9 pair
    where stash_route admits x); weights of another dtype than x are cast
    to it."""
    if _needs_grad(x, ln_w, ln_b, w1, b1, w2, b2):
        if stash and residual and stash_route(x, w1.shape[0]) == "2d":
            return _MlpBlockStash.apply(x, ln_w, ln_b, w1, b1, w2, b2)
        return _MlpBlock.apply(x, ln_w, ln_b, w1, b1, w2, b2, residual)
    return _mlp_fwd(x, ln_w, ln_b, w1, b1, w2, b2, residual)


mlp_block.launches = 0
mlp_block.bwd_launches = 0
mlp_block.stash_launches = 0
mlp_block.stash_bwd_launches = 0
