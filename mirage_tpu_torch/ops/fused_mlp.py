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
as the JAX custom VJP's primal is (:814-817). ``mlp_block_fwd_stash3d``
(B9′, ``_mlp_block_fwd_stash3d``: the stash forward on unaligned 3-D input,
which no JAX route reaches) is B9's forward chain on the flattened rows.

The accumulating backward (B7, MLP half) replaces ``_mlp_block_bwd_pallas``
/ ``_mlp_bwd_kernel`` (:240-273, :311-429), which emits dx and every
parameter gradient in float32, summed in its own body over a sequential
grid. The backward takes it where the JAX package does: under
``MIRAGE_MLP_BWD=accumulate`` always, and under the default ``defused`` for
the per-element 3-D route alone (an unaligned (B, N, D) whose flat and
padded row counts both admit no block, ``_route_unaligned_bwd``). On the
card it is B5's chain (recompute, the GELU backward in the dact GEMM's
epilogue, the LN backward) whose reductions all run in hand-written
kernels, as the TPU kernel computes them in its own body: dW1 = T(dh)ᵀ·y
and dW2 = dyᵀ·act in csrc/wgrad.cu (fixed row chunks summed in a fixed
order: Hopper's blocks run in no order, so the TPU's sequential
accumulator becomes chunk partials and a second pass), db1 from the float
16-row partials of the unrounded dh, db2 = Σ dy and dγ, dβ from the LN
backward's partials in its column-sum kernel. No atomics, so a rerun is
bit-identical. The rows need no padding: the TPU pads only for its tiling,
and a zero-cotangent row adds nothing. Bound: operations (the recompute
2·M·D·4D and the backward 8·M·D·4D FLOPs).
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


# The accumulating backward (B7) computes what _mlp_bwd_rows computes over
# every row, with the parameter grads summed: B5's function and rounding
# (db1 from the float dh, dW1 = T(dh)ᵀ·y, dW2 = dyᵀ·T(act)), so its plain
# version is B5's.
mlp_block_bwd_acc_ref = mlp_block_bwd_ref


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


def _mlp_bwd_chain(x, dy, ln_w, ln_b, w1, b1, w2, residual):
    """The kernels B5 and B7 share: the recompute, the GELU backward in the
    dact GEMM's epilogue and the LN backward. Returns dx, the (M, ·) rows
    y, dh, act and dy, and the float partials of dgamma, dbeta (32-row)
    and db1 (16-row, of the unrounded dh)."""
    runtime.check("x", x, x)
    d = x.shape[-1]
    x2, dy2 = x.view(-1, d), dy.contiguous().view(-1, d)
    w1c = w1.to(x.dtype).contiguous()
    y = runtime.layernorm(x2, ln_w, ln_b)
    h = runtime.gemm(y, w1c, b1, out_dtype=torch.float32)
    dh, act, db1 = runtime.gemm_gelu_bwd(
        dy2, w2.to(x.dtype).t().contiguous(), h, partials=True)
    del h
    dyln = runtime.gemm(dh, w1c.t().contiguous(), out_dtype=torch.float32)
    dx, dgamma, dbeta = runtime.layernorm_bwd(
        x2, ln_w, dyln, dy2, sub_dy=not residual, partials=True)
    return dx.view(x.shape), y, dh, act, dy2, dgamma, dbeta, db1


def _mlp_bwd(x, dy, ln_w, ln_b, w1, b1, w2, residual=True):
    """B5 on the card: the shared chain; dW1, dW2, db2 and the partial sums
    outside, as the JAX package leaves them to XLA."""
    if not runtime.use_kernel(x):
        return mlp_block_bwd_ref(x, dy, ln_w, ln_b, w1, b1, w2, residual)
    dx, y, dh, act, dy2, dgamma, dbeta, db1 = _mlp_bwd_chain(
        x, dy, ln_w, ln_b, w1, b1, w2, residual)
    mlp_block.bwd_launches += 1
    return (dx, dgamma.sum(0), dbeta.sum(0), runtime.wgrad(dh, y), db1.sum(0),
            runtime.wgrad(dy2, act), dy2.float().sum(0))


def _mlp_bwd_acc(x, dy, ln_w, ln_b, w1, b1, w2, residual=True):
    """B7 (MLP half) on the card: the shared chain with every reduction in
    the wgrad and column-sum kernels."""
    if not runtime.use_kernel(x):
        return mlp_block_bwd_acc_ref(x, dy, ln_w, ln_b, w1, b1, w2, residual)
    dx, y, dh, act, dy2, dgamma, dbeta, db1 = _mlp_bwd_chain(
        x, dy, ln_w, ln_b, w1, b1, w2, residual)
    mlp_block.acc_bwd_launches += 1
    return (dx, runtime.colsum(dgamma), runtime.colsum(dbeta),
            runtime.weight_grad(dh, y), runtime.colsum(db1),
            runtime.weight_grad(dy2, act), runtime.colsum(dy2))


class _MlpBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ln_w, ln_b, w1, b1, w2, b2, residual):
        ctx.save_for_backward(x, ln_w, ln_b, w1, b1, w2)
        ctx.residual = residual
        return _mlp_fwd(x, ln_w, ln_b, w1, b1, w2, b2, residual)

    @staticmethod
    def backward(ctx, dy):
        x, *params = ctx.saved_tensors
        bwd = (_mlp_bwd_acc if takes_accumulating_bwd(x, params[2].shape[0])
               else _mlp_bwd)
        return (*bwd(x, dy, *params, ctx.residual), None)


# ------------------------------------- the backward routes; B9

def _pick_bwd_block(m, d, hdim, live_bytes_per_row_unit, fixed_bytes,
                    budget=48 * 2 ** 20, ceiling=58 * 2 ** 20):
    """The JAX package's row block for its sequential backward grid
    (mirage_tpu/ops/fused_mlp.py:287-307), kept so the port stashes and
    accumulates exactly where it does: the largest divisor of m within the
    VMEM budget, then within the ceiling, else None (no divisor: ragged
    m)."""
    for cand in (4096, 2048, 1024, 512, 256, 128, 64, 32, 16, 8):
        if m % cand == 0 and cand * hdim * live_bytes_per_row_unit \
                + fixed_bytes < budget:
            return cand
    for cand in (512, 256, 128, 64, 32, 16, 8):
        if m % cand == 0 and cand * hdim * live_bytes_per_row_unit \
                + fixed_bytes < ceiling:
            return cand
    return None


# the de-fused backward's VMEM row coefficient (mirage_tpu/ops/fused_mlp.py:
# 284); with fixed term 4·d·hdim it decides the unaligned routes under the
# default switch (:362-368)
_DEFUSED_ROW_UNIT = 40


def _route_unaligned_bwd(b, n, d, hdim, row_unit=18, fixed_mult=12):
    """'flat' | 'pad' | None for an unaligned (B, N, D) backward, as
    mirage_tpu/ops/fused_mlp.py:888-904 decides: fewest grid programs,
    ties to flat; None where neither admits a block (the per-element 3-D
    route, which runs the accumulating kernel whatever the switch)."""
    n_pad = -(-n // 16) * 16
    blk_flat = _pick_bwd_block(b * n, d, hdim, row_unit, fixed_mult * d * hdim)
    blk_pad = (_pick_bwd_block(b * n_pad, d, hdim, row_unit,
                               fixed_mult * d * hdim)
               if (b * n_pad) % 1024 == 0 else None)
    progs_flat = (b * n) // blk_flat if blk_flat else None
    progs_pad = (b * n_pad) // blk_pad if blk_pad else None
    if progs_flat is not None and (progs_pad is None
                                   or progs_flat <= progs_pad):
        return "flat"
    return "pad" if progs_pad is not None else None


def takes_accumulating_bwd(x, hdim) -> bool:
    """Does mlp_block's backward at x's shape run the accumulating kernel
    (B7) in the JAX package? Under MIRAGE_MLP_BWD=accumulate always; under
    defused only on the per-element 3-D route (fused_mlp.py:385-406)."""
    if runtime.switches["MIRAGE_MLP_BWD"] == "accumulate":
        return True
    if x.ndim != 3 or x.shape[1] % 16 == 0:
        return False
    b, n, d = x.shape
    return _route_unaligned_bwd(b, n, d, hdim, _DEFUSED_ROW_UNIT, 4) is None


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


def mlp_block_fwd_stash_ref(x, ln_w, ln_b, w1, b1, w2, b2, residual=True):
    """Plain stash forward, as _mlp_fwd_stash_kernel: (out, act, dg) with
    h = T(LN(x))·W1ᵀ + b1 in float, act = T(GELU(h)), dg = T(GELU′(h)), out =
    x + T(act·W2ᵀ + b2) (without x when not ``residual``); out equals
    mlp_block's."""
    dt, acc = x.dtype, acc_dtype(x)
    y = layer_norm(x, ln_w, ln_b)
    h = y.to(acc) @ w1.to(dt).to(acc).t() + b1.to(acc)
    e = torch.erf(h * _INV_SQRT2)
    act = (0.5 * h * (1.0 + e)).to(dt)
    dg = (0.5 * (1.0 + e) + h * torch.exp(-0.5 * h * h) * _INV_SQRT_2PI).to(dt)
    o = (act.to(acc) @ w2.to(dt).to(acc).t() + b2.to(acc)).to(dt)
    return x + o if residual else o, act, dg


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


def _stash_chain(x, ln_w, ln_b, w1, b1, w2, b2, residual=True):
    """LN, fc1 with the stash epilogue, fc2 with bias (and residual) over
    the rows of x (M, D): (out, act, dg)."""
    runtime.check("x", x, x)
    y = runtime.layernorm(x, ln_w, ln_b)
    act, dg = runtime.gemm_gelu_stash(y, w1.to(x.dtype), b1)
    out = runtime.gemm(act, w2.to(x.dtype), b2,
                       residual=x if residual else None)
    return out, act, dg


def _mlp_fwd_stash(x, ln_w, ln_b, w1, b1, w2, b2):
    """B9 forward on the card: the stash chain with the residual."""
    if not runtime.use_kernel(x):
        return mlp_block_fwd_stash_ref(x, ln_w, ln_b, w1, b1, w2, b2)
    out = _stash_chain(x, ln_w, ln_b, w1, b1, w2, b2)
    mlp_block.stash_launches += 1
    return out


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


# ----------------------------------------------------------------- B9′

def mlp_block_fwd_stash3d_ref(x, ln_w, ln_b, w1, b1, w2, b2, residual=True,
                              stash_flat=False):
    """Plain version of :func:`mlp_block_fwd_stash3d`."""
    b, n, d = x.shape
    out, act, dg = mlp_block_fwd_stash_ref(x.reshape(b * n, d), ln_w, ln_b,
                                           w1, b1, w2, b2, residual)
    shape = (b * n, -1) if stash_flat else (b, n, -1)
    return out.view(b, n, d), act.view(shape), dg.view(shape)


def mlp_block_fwd_stash3d(x, ln_w, ln_b, w1, b1, w2, b2, residual=True,
                          stash_flat=False):
    """The stash forward on unaligned 3-D input, x (B, N, D): (out (B, N,
    D), act, dg), the stashes (B, N, H), or (B·N, H) with ``stash_flat``.
    Replaces ``mirage_tpu/ops/fused_mlp.py:_mlp_block_fwd_stash3d`` (B9′;
    ``_mlp_fwd_stash_kernel`` over a per-batch-element grid), which no JAX
    route reaches (``_stash_route`` refuses 3-D shapes). On the card it is
    B9's stash chain on the flattened rows: the port tiles rows with no
    8-row alignment, so the flat stashes are views, not copies.
    ``residual=False`` drops the skip-add from fc2's epilogue. ``out`` is
    bit-equal to mlp_block's. Forward only (the stash backward takes the
    flat rows)."""
    if not runtime.use_kernel(x):
        return mlp_block_fwd_stash3d_ref(x, ln_w, ln_b, w1, b1, w2, b2,
                                         residual, stash_flat)
    b, n, d = x.shape
    out, act, dg = _stash_chain(x.view(b * n, d), ln_w, ln_b, w1, b1, w2, b2,
                                residual)
    mlp_block_fwd_stash3d.launches += 1
    shape = (b * n, -1) if stash_flat else (b, n, -1)
    return out.view(b, n, d), act.view(shape), dg.view(shape)


mlp_block_fwd_stash3d.launches = 0


def mlp_block(x, ln_w, ln_b, w1, b1, w2, b2, residual=True, stash=False):
    """x: (..., D); w1 (4D, D), w2 (D, 4D) torch Linear layout.
    Differentiable (B5 backward on the card, B7 where
    takes_accumulating_bwd says so, or with ``stash`` the B9 pair where
    stash_route admits x); weights of another dtype than x are cast
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
mlp_block.acc_bwd_launches = 0
