"""MLP half-block: out = x + fc2(GELU_erf(fc1(LN(x)))).

Replaces ``mirage_tpu/ops/fused_mlp.py:_mlp_block_fwd`` / ``_mlp_kernel``
(B2, the Pallas kernel that keeps the whole half-block in VMEM) and, as its
backward, ``_mlp_block_bwd_defused`` / ``_mlp_bwd_dx_kernel`` (B5). On the
card the forward runs as three CUDA kernels: LayerNorm (csrc/layernorm.cu),
fc1 with bias and GELU in the epilogue, then fc2 with bias and the residual
in the epilogue (csrc/gemm.cu, wgmma). The backward recomputes LN, then
runs the hidden stage in one launch (csrc/mlp_bwd.cu: h = y·W1ᵀ + b1 and
dact = dy·W2 as two accumulators of one tile, never stored; its epilogue
writes dh = T(dact·GELU′(h)), act = T(GELU(h)) and the float 16-row
partials of db1 from the unrounded dh), then dyln = dh·W1 (float output,
csrc/mlp_bwd.cu) and the LN backward; dW1, dW2 and db2 are contractions
outside, as in the JAX package (:511-523). Both kernels read W2 and W1 as
they lie (wgmma's transposed operands), so no weight is copied. Bound:
operations (2·M·D·4D·2 FLOPs forward, twice that and the recompute
backward). The forward writes the LN output and the (M, 4D) hidden to
device memory between its kernels, and the backward dh and act, as the
JAX package's defused backward does. ``mlp_bwd_plan`` gives the backward
kernels' tiles and grids. ``residual=False`` drops the skip-add; its
backward is the residual one minus the pass-through cotangent (dx =
T(dx_res) − dy, fused_mlp.py:976-981).

``stash=True`` (the ConvNeXt head of segmentation tuning) takes the stash
pair where the JAX package's ``_stash_route`` admits the shape (2-D rows,
d ≥ 384, a row count with a backward block): B9, replacing
``_mlp_block_fwd_stash`` / ``_mlp_fwd_stash_kernel`` and
``_mlp_block_bwd_stash`` / ``_mlp_bwd_stash_kernel``. Its forward is B2's
chain with the stash epilogue on fc1, which also writes act = T(GELU(h))
and dg = T(GELU′(h)) for the backward (csrc/gemm_stash.cu); its backward
runs no recompute and no transcendental: dact = dy·W2 with the epilogue dh
= T(dact·dg) and float 16-row partials of db1, dyln = dh·W1 in float (both
products read W2 and W1 as they lie, ``runtime.gemm(..., w_kn=True)``, so
no weight is copied), LN
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
card it is B5's chain (LN, the hidden stage, dyln, the LN backward) whose
reductions all run in hand-written kernels, as the TPU kernel computes
them in its own body: dW1 = T(dh)ᵀ·y and dW2 = dyᵀ·act in csrc/wgrad.cu
(wgmma on both operands as they lie; fixed row chunks summed in a fixed
order: Hopper's blocks run in no order, so the TPU's sequential
accumulator becomes chunk partials and a second pass), db1 from the float
16-row partials of the unrounded dh and db2 = Σ dy in its column-sum
kernel, dγ and dβ from the LN backward, which finishes them itself. No
atomics, so a rerun is bit-identical. The rows need no padding: the TPU
pads only for its tiling, and a zero-cotangent row adds nothing. Bound:
operations (the recompute 2·M·D·4D and the backward 8·M·D·4D FLOPs).

``mlp_block_lnfold`` (an A/B case of the port's bench, scripts/
bench_lnfold.py) is B2 with the next block's LN1 folded into fc2's
epilogue (csrc/gemm_lnfold.cu). ``mlp_block_modes`` (S5, scripts/
bench_vpu.py) is B2's chain with the LN in two passes, one pass or skipped
and the GELU's erf from the A&S polynomials or skipped (csrc/layernorm.cu's
and csrc/gemm.cu's modes); ``mlp_block_chunked`` (S6, scripts/
bench_overlap.py) is LN, then fc1 → GELU → fc2 in one launch with the
hidden kept on chip (csrc/mlp_chunked.cu).
"""

from collections import namedtuple

import torch

from mirage_tpu_torch.nn.layers import acc_dtype, gelu, layer_norm, linear
from mirage_tpu_torch.ops import runtime
from mirage_tpu_torch.ops.block_attention import (LN_MODES, _forward_only,
                                                  _needs_grad, ln_bwd_ref,
                                                  ln_mode, ln_mode_ref)
from mirage_tpu_torch.ops.quant import _erf_as

_INV_SQRT2 = 0.7071067811865476
_INV_SQRT_2PI = 0.3989422804014327


def mlp_block_ref(x, ln_w, ln_b, w1, b1, w2, b2, residual=True):
    """Plain PyTorch version (mirage_tpu/ops/fused_mlp.py:_mlp_block_xla)."""
    h = linear(gelu(linear(layer_norm(x, ln_w, ln_b), w1, b1)), w2, b2)
    return x + h if residual else h


def mlp_bwd_hidden_ref(y, dy, w1, b1, w2):
    """Plain version of the hidden stage (csrc/mlp_bwd.cu's first launch),
    as _mlp_bwd_rows computes it: h = y·W1ᵀ + b1 and dact = dy·W2 in float,
    e = erf(h/√2), act = T(½·h·(1 + e)), dh = dact·(½·(1 + e) + h·φ(h)).
    Returns (T(dh), act, db1): db1 the float column sums of the unrounded
    dh over every row."""
    dt, acc = y.dtype, acc_dtype(y)
    h = y.to(acc) @ w1.to(dt).to(acc).t() + b1.to(acc)
    e = torch.erf(h * _INV_SQRT2)
    act = (0.5 * h * (1.0 + e)).to(dt)
    dh = (dy.to(acc) @ w2.to(dt).to(acc)) * (
        0.5 * (1.0 + e) + h * torch.exp(-0.5 * h * h) * _INV_SQRT_2PI)
    return dh.to(dt), act, dh.sum(tuple(range(dh.ndim - 1)))


def mlp_block_bwd_ref(x, dy, ln_w, ln_b, w1, b1, w2, residual=True):
    """Plain PyTorch backward, step by step as _mlp_bwd_rows: y = T(LN(x)),
    the hidden stage (:func:`mlp_bwd_hidden_ref`: dh, act and db1 from the
    unrounded dh), dyln = T(dh)·W1 in float; the LN backward. Returns (dx,
    dgamma, dbeta, dw1, db1, dw2, db2) as _mlp_block_bwd_defused does,
    parameter grads in float and in torch layout (dw1 (4D, D), dw2 (D,
    4D))."""
    dt, acc = x.dtype, acc_dtype(x)
    y = layer_norm(x, ln_w, ln_b)
    dh, act, db1 = mlp_bwd_hidden_ref(y, dy, w1, b1, w2)
    dy32, dh_c = dy.to(acc), dh.to(acc)
    dx, dgamma, dbeta = ln_bwd_ref(x, dh_c @ w1.to(dt).to(acc), ln_w, dy)
    dx = dx.to(dt)
    if not residual:
        dx = dx - dy
    rows = lambda t: t.reshape(-1, t.shape[-1])  # noqa: E731
    return (dx, dgamma, dbeta, rows(dh_c).t() @ rows(y.to(acc)), db1,
            rows(dy32).t() @ rows(act.to(acc)),
            dy32.sum(tuple(range(x.ndim - 1))))


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
    runtime.count(mlp_block)
    return out.view(x.shape)


def _mlp_bwd_chain(x, dy, ln_w, ln_b, w1, b1, w2, residual):
    """The kernels B5 and B7 share: LN, the hidden stage (recompute and
    dact in one launch), dyln and the LN backward. Returns dx, the (M, ·)
    rows y, dh, act and dy, the float dgamma and dbeta, and the float
    16-row partials of db1 (of the unrounded dh)."""
    runtime.check("x", x, x)
    d = x.shape[-1]
    x2, dy2 = x.view(-1, d), dy.contiguous().view(-1, d)
    w1c = w1.to(x.dtype).contiguous()
    y = runtime.layernorm(x2, ln_w, ln_b)
    dh, act, db1 = runtime.mlp_bwd_hidden(y, dy2, w1c, b1,
                                          w2.to(x.dtype).contiguous())
    dyln = runtime.mlp_bwd_dyln(dh, w1c)
    dx, dgamma, dbeta = runtime.layernorm_bwd(x2, ln_w, dyln, dy2,
                                              sub_dy=not residual)
    return dx.view(x.shape), y, dh, act, dy2, dgamma, dbeta, db1


def _mlp_bwd(x, dy, ln_w, ln_b, w1, b1, w2, residual=True):
    """B5 on the card: the shared chain; dW1, dW2, db2 and the partial sums
    outside, as the JAX package leaves them to XLA."""
    if not runtime.use_kernel(x):
        return mlp_block_bwd_ref(x, dy, ln_w, ln_b, w1, b1, w2, residual)
    dx, y, dh, act, dy2, dgamma, dbeta, db1 = _mlp_bwd_chain(
        x, dy, ln_w, ln_b, w1, b1, w2, residual)
    runtime.count(mlp_block, "bwd_launches")
    return (dx, dgamma, dbeta, runtime.wgrad(dh, y), db1.sum(0),
            runtime.wgrad(dy2, act), dy2.sum(0, dtype=torch.float32))


def _mlp_bwd_acc(x, dy, ln_w, ln_b, w1, b1, w2, residual=True):
    """B7 (MLP half) on the card: the shared chain with every reduction in
    the wgrad and column-sum kernels."""
    if not runtime.use_kernel(x):
        return mlp_block_bwd_acc_ref(x, dy, ln_w, ln_b, w1, b1, w2, residual)
    dx, y, dh, act, dy2, dgamma, dbeta, db1 = _mlp_bwd_chain(
        x, dy, ln_w, ln_b, w1, b1, w2, residual)
    runtime.count(mlp_block, "acc_bwd_launches")
    return (dx, dgamma, dbeta, runtime.weight_grad(dh, y),
            runtime.colsum(db1), runtime.weight_grad(dy2, act),
            runtime.colsum(dy2))


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


PingPongPlan = namedtuple("PingPongPlan", [
    "tile", "tiles", "grid", "tiles_per_cta", "ktiles", "stages",
    "smem_bytes", "cluster", "group"], defaults=(1, 1))


def _pingpong_plan(name, m, n, k, sms, tile, stages, smem_bytes, cluster=1,
                   bk=64, group=1):
    """A persistent kernel of two consumer warpgroups in ping-pong over a
    (m, n) output, K = k in slices of ``bk``: ``tile`` tiles in row-major
    order (``group`` > 1: grouped, :func:`tile_order`), each taken by a
    cluster of ``cluster`` CTAs (one CTA per SM), cluster c taking tiles c,
    c + clusters, ... (the most a cluster takes is ``tiles_per_cta``) and
    each CTA handing its rows of them to its two consumers in turn;
    ``grid`` counts CTAs."""
    if m <= 0 or n <= 0 or k <= 0 or sms <= 0:
        raise ValueError(f"{name}: empty product ({m}, {n}, {k}) on {sms} "
                         f"SMs")
    tiles_m = -(-m // tile[0])
    tiles = tiles_m * -(-n // tile[1])
    clusters = min(tiles, sms // cluster)
    return PingPongPlan(tile=tile, tiles=tiles, grid=clusters * cluster,
                        tiles_per_cta=-(-tiles // clusters),
                        ktiles=-(-k // bk), stages=stages,
                        smem_bytes=smem_bytes, cluster=cluster,
                        group=min(tiles_m, group))


# csrc/gemm_pingpong.cuh's tiling (the bf16 GEMM of csrc/gemm.cu and the
# int8 GEMM of csrc/quant.cu): each consumer warpgroup's tile is 128 × 128,
# K-slices of 128 bytes (64 bf16, 128 int8) in a ring of five stages (A's
# and W's 128 rows), clusters of two CTAs along M sharing W's slices by
# multicast (a cluster tile is 256 × 128), cluster tile rows grouped so a
# group spans eight tile rows; per warp, up to two column vectors of the
# tile (bf16: the bias; int8: the weight scales and the bias) and a staging
# tile of 16 × 72 four-byte elements
GEMM_TILE, GEMM_STAGES, GEMM_CLUSTER, GEMM_GROUP = (128, 128), 5, 2, 8


def _gemm_smem(vecs):
    stage = (GEMM_TILE[0] + GEMM_TILE[1]) * 128
    return (1024 + GEMM_STAGES * stage + 16 * GEMM_STAGES
            + 8 * (vecs * GEMM_TILE[1] * 4 + 16 * 72 * 4))


def _gemm_plan(name, m, n, k, sms, bk, vecs):
    return _pingpong_plan(name, m, n, k, sms,
                          (GEMM_TILE[0] * GEMM_CLUSTER, GEMM_TILE[1]),
                          GEMM_STAGES, _gemm_smem(vecs), cluster=GEMM_CLUSTER,
                          bk=bk, group=GEMM_GROUP // GEMM_CLUSTER)


def gemm_plan(m, n, k, sms):
    """How csrc/gemm.cu's bf16 kernel runs a (m, k) · (n, k)ᵀ product on
    ``sms`` SMs (:func:`_pingpong_plan` over cluster tiles of 256 × 128,
    two CTAs of 128 × 128 tiles a cluster, five stages of K-slices of 64).
    Raises ValueError for a shape the kernel refuses (K or N not a multiple
    of 8: TMA rows of 16 bytes)."""
    if k % 8 or n % 8:
        raise ValueError(f"gemm_plan: bf16 needs K and N multiples of 8, got "
                         f"K={k}, N={n}")
    return _gemm_plan("gemm_plan", m, n, k, sms, 64, 1)


def gemm_s8_plan(m, n, k, sms):
    """How csrc/quant.cu's int8 kernel runs a (m, k) · (n, k)ᵀ product
    (:func:`gemm_plan`'s tiling, K-slices of 128). Raises ValueError unless
    K is a multiple of 16 (TMA rows of 16 bytes) and N of 8."""
    if k % 16 or n % 8:
        raise ValueError(f"gemm_s8_plan: int8 needs K % 16 == 0 and N % 8 == "
                         f"0, got K={k}, N={n}")
    return _gemm_plan("gemm_s8_plan", m, n, k, sms, 128, 2)


def tile_order(t, tiles_m, tiles_n, group):
    """(tile row, tile column) of tile t in the grouped raster of
    csrc/gemm_pingpong.cuh:tile_coords: ``group`` tile rows at a time, down
    the group's rows column by column."""
    per_group = group * tiles_n
    first = t // per_group * group
    rows = min(tiles_m - first, group)
    r = t % per_group
    return first + r % rows, r // rows


def pingpong_schedule(plan, m, n):
    """Each CTA's tiles in the order it runs them, as [(tile row, tile
    column, consumer)]: cluster c (CTAs c·cluster, ...) takes cluster tiles
    c, c + clusters, ... in :func:`tile_order`, its CTA of rank r the r-th
    tile row of each (a row past m: zero-filled, nothing stored), and each
    CTA hands its g-th tile to consumer g % 2."""
    tiles_mc, tiles_n = -(-m // plan.tile[0]), -(-n // plan.tile[1])
    clusters = plan.grid // plan.cluster
    sched = []
    for b in range(plan.grid):
        c, r = divmod(b, plan.cluster)
        tiles = [tile_order(t, tiles_mc, tiles_n, plan.group)
                 for t in range(c, plan.tiles, clusters)]
        sched.append([(tm * plan.cluster + r, tn, g % 2)
                      for g, (tm, tn) in enumerate(tiles)])
    return sched


# csrc/gemm_stash.cu's tiling: each consumer warpgroup's tile is 64 × 256,
# K-slices of 64 in a ring of four stages (A's 64 and W's 256 rows), and a
# per-warp epilogue scratch (the bias, then act's and dg's staging tiles)
STASH_TILE_M, STASH_TILE_N, STASH_BK, STASH_STAGES = 64, 256, 64, 4
STASH_SMEM = (1024 + STASH_STAGES * (STASH_TILE_M + STASH_TILE_N) * STASH_BK * 2
              + 16 * STASH_STAGES + 8 * (STASH_TILE_N * 4 + 2 * 16 * 72 * 2))


def gemm_stash_plan(m, n, k, sms):
    """How csrc/gemm_stash.cu's bf16 kernel runs a (m, k) · (n, k)ᵀ
    product on ``sms`` SMs (:func:`_pingpong_plan`: 64 × 256 tiles, four
    stages)."""
    return _pingpong_plan("gemm_stash_plan", m, n, k, sms,
                          (STASH_TILE_M, STASH_TILE_N), STASH_STAGES,
                          STASH_SMEM)


# csrc/mlp_bwd.cu's tilings. The hidden stage: a cluster of two CTAs takes a
# 128 × 128 tile of the hidden, each CTA 64 rows of it, a consumer's with
# two accumulators; a stage holds a K-slice of 64 of y's and dy's 64 rows,
# W1's 128 rows and W2's 64 × 128 block (48 KB: half of the weights'
# multicast by the partner), four stages; per warp, the bias and act's and
# dh's staging tiles of 16 × 32 (rows padded to 40). dyln: a consumer's
# tile is 64 × 256 of (M, D); a stage holds dh's 64 rows and W1's 64 × 256
# block (40 KB), four stages; per warp, a float staging tile of 16 × 32
# (rows padded to 40).
MLP_BWD_HIDDEN_TILE, MLP_BWD_DYLN_TILE = (128, 128), (64, 256)
MLP_BWD_STAGES = 4
MLP_BWD_HIDDEN_SMEM = (1024 + MLP_BWD_STAGES * (2 * 64 + 128 + 128) * 64 * 2
                       + 16 * MLP_BWD_STAGES + 8 * (128 * 4 + 2 * 16 * 40 * 2))
MLP_BWD_DYLN_SMEM = (1024 + MLP_BWD_STAGES * (64 + 256) * 64 * 2
                     + 16 * MLP_BWD_STAGES + 8 * 16 * 40 * 4)

MlpBwdPlan = namedtuple("MlpBwdPlan", ["hidden", "dyln"])


def mlp_bwd_plan(m, d, hdim, sms):
    """How csrc/mlp_bwd.cu's bf16 kernels run the MLP backward over m rows
    of width d with a hidden of ``hdim`` on ``sms`` SMs: ``hidden``, the
    recompute and dact products (M, hdim) at K = d in clusters of two CTAs,
    and ``dyln``, the (M, d) product at K = hdim, each a
    :class:`PingPongPlan`. Raises ValueError for an empty product."""
    return MlpBwdPlan(
        hidden=_pingpong_plan("mlp_bwd_plan", m, hdim, d, sms,
                              MLP_BWD_HIDDEN_TILE, MLP_BWD_STAGES,
                              MLP_BWD_HIDDEN_SMEM, cluster=2),
        dyln=_pingpong_plan("mlp_bwd_plan", m, d, hdim, sms,
                            MLP_BWD_DYLN_TILE, MLP_BWD_STAGES,
                            MLP_BWD_DYLN_SMEM))


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
    runtime.count(mlp_block, "stash_launches")
    return out


def _mlp_bwd_stash(x, dy, act, dg, ln_w, ln_b, w1, w2):
    """B9 backward on the card: every product and every sum a CUDA kernel."""
    if not runtime.use_kernel(x):
        return mlp_block_bwd_stash_ref(x, dy, act, dg, ln_w, ln_b, w1, w2)
    runtime.check("x", x, x)
    dy = dy.contiguous()
    dh, db1 = runtime.gemm_dgelu_mul(dy, w2.to(x.dtype), dg, w_kn=True)
    dyln = runtime.gemm(dh, w1.to(x.dtype), out_dtype=torch.float32,
                        w_kn=True)
    y = runtime.layernorm(x, ln_w, ln_b)
    dx, dgamma, dbeta = runtime.layernorm_bwd(x, ln_w, dyln, dy)
    grads = (dx, dgamma, dbeta, runtime.weight_grad(dh, y),
             runtime.colsum(db1), runtime.weight_grad(dy, act),
             runtime.colsum(dy))
    runtime.count(mlp_block, "stash_bwd_launches")
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
    runtime.count(mlp_block_fwd_stash3d)
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


# ------------------------------------------ the bench's LN fold (S4)

def mlp_block_lnfold_ref(x, ln_w, ln_b, w1, b1, w2, b2, ln_next_w,
                         ln_next_b):
    """Plain version of :func:`mlp_block_lnfold`: (out, LN_next(out)), the
    LN taken in float from out rounded to x's dtype."""
    out = mlp_block_ref(x, ln_w, ln_b, w1, b1, w2, b2)
    return out, layer_norm(out, ln_next_w, ln_next_b)


def mlp_block_lnfold(x, ln_w, ln_b, w1, b1, w2, b2, ln_next_w, ln_next_b):
    """B2 that also writes y = LN_next(out), the next block's LN1 of its
    output: (out, y), both x's shape and dtype. Replaces
    scripts/bench_lnfold.py:_mlp_lnfold_kernel (the next layer's LN folded
    into the MLP kernel's tail, so the attention half that follows starts at
    its qkv product: ``attn_half_block_prenormed``).

    On the card: B2's chain up to fc2 (LN, fc1 with bias and GELU), then fc2
    with bias, the residual and LN_next in one epilogue (csrc/gemm_lnfold.cu:
    a thread-block cluster of D/256 CTAs along the columns, each CTA's row
    partial sums exchanged through distributed shared memory, the mean first
    and then the squared deviations, as the port's two-pass LN). bf16 only,
    D a multiple of 256 up to 2048; another shape or type raises. Forward
    only."""
    if not runtime.use_kernel(x):
        return mlp_block_lnfold_ref(x, ln_w, ln_b, w1, b1, w2, b2, ln_next_w,
                                    ln_next_b)
    _forward_only("mlp_block_lnfold", x, ln_w, ln_b, w1, b1, w2, b2,
                  ln_next_w, ln_next_b)
    runtime.check("x", x, x)
    x2 = x.view(-1, x.shape[-1])
    h = runtime.gemm(runtime.layernorm(x2, ln_w, ln_b), w1.to(x.dtype), b1,
                     gelu=True)
    out, y = runtime.gemm_lnfold(h, w2.to(x.dtype), b2, x2, ln_next_w,
                                 ln_next_b)
    runtime.count(mlp_block_lnfold)
    return out.view(x.shape), y.view(x.shape)


mlp_block_lnfold.launches = 0


# ---------------------------------------------- S5: the MLP half's modes

ACT_MODES = ("as26", "bf16", "hastings", "skip")
_SQRT2 = 1.4142135623730951
# A&S 7.1.28 (scripts/bench_vpu.py:255-256)
_HASTINGS = (0.0705230784, 0.0422820123, 0.0092705272, 0.0001520143,
             0.0002765672, 0.0000430638)


def gelu_mode_ref(h, act):
    """scripts/bench_vpu.py:_mlp_kernel_v's activation of the float h:
    "as26" 0.5·h·(1 + erf(h/√2)) with erf from A&S 7.1.26 (the script's
    default, ``_erf``), "bf16" the same in bf16 (every operation and
    constant rounded to bf16, as jnp evaluates a bf16 array), "hastings"
    A&S 7.1.28 (a division and a 16th power, no exp) or "skip" (h itself,
    wrong math kept for timing)."""
    if act == "skip":
        return h
    if act == "as26":
        return 0.5 * h * (1.0 + _erf_as(h / _SQRT2))
    if act == "hastings":
        z = h * (1.0 / _SQRT2)
        az = z.abs()
        a = _HASTINGS
        q = 1.0 + az * (a[0] + az * (a[1] + az * (a[2] + az * (
            a[3] + az * (a[4] + az * a[5])))))
        q8 = q.square().square().square()
        return 0.5 * h * (1.0 + torch.sign(z) * (1.0 - 1.0 / (q8 * q8)))
    if act != "bf16":
        raise ValueError(f"activation mode {act!r} not in {ACT_MODES}")

    def c(v):
        return torch.tensor(v, dtype=torch.bfloat16)

    hb = h.to(torch.bfloat16)
    x = hb / c(_SQRT2)
    ax = x.abs()
    t = c(1.0) / (c(1.0) + c(0.3275911) * ax)
    poly = t * (c(0.254829592) + t * (c(-0.284496736) + t * (
        c(1.421413741) + t * (c(-1.453152027) + t * c(1.061405429)))))
    e = torch.exp2(-(ax * ax) * c(1.4426950408889634))
    erf = torch.sign(x) * (c(1.0) - poly * e)
    return (c(0.5) * hb * (c(1.0) + erf)).to(h.dtype)


def _modes_args(ln, act):
    if ln not in LN_MODES:
        raise ValueError(f"LN mode {ln!r} not in {LN_MODES}")
    if act not in ACT_MODES:
        raise ValueError(f"activation mode {act!r} not in {ACT_MODES}")


def mlp_block_modes_ref(x, ln_w, ln_b, w1, b1, w2, b2, ln="two_pass",
                        act="as26"):
    """Plain version of :func:`mlp_block_modes`: y = LN_mode(x) in x's
    dtype, h = y·W1ᵀ + b1 in float, T(act(h)), out = x + T(·W2ᵀ + b2)."""
    _modes_args(ln, act)
    dt, acc = x.dtype, acc_dtype(x)
    y = ln_mode_ref(x, ln_w, ln_b, ln)
    h = y.to(acc) @ w1.to(dt).to(acc).t() + b1.to(acc)
    h = gelu_mode_ref(h, act).to(dt)
    o = (h.to(acc) @ w2.to(dt).to(acc).t() + b2.to(acc)).to(dt)
    return x + o


def mlp_block_modes(x, ln_w, ln_b, w1, b1, w2, b2, ln="two_pass",
                    act="as26"):
    """B2 with its stages that are not a product varied: x (..., D) ->
    x's shape. Replaces scripts/bench_vpu.py:_mlp_kernel_v (S5, ``ln``
    "two_pass" | "onepass" | "skip", ``act`` "as26" | "bf16" | "hastings" |
    "skip") and, at the defaults, _mlp_kernel_pipe2 (two elements per TPU
    program; the card overlaps elements across CTAs, so it is this chain).
    On the card: the LN kernel in its mode (none for "skip", where fc1 takes
    x), fc1 with bias and the GELU epilogue of the mode's formula
    (csrc/gemm.cu, instantiated per formula; no activation for "skip"), fc2
    with bias and residual. bf16 only on the card. Forward only."""
    _modes_args(ln, act)
    if not runtime.use_kernel(x):
        return mlp_block_modes_ref(x, ln_w, ln_b, w1, b1, w2, b2, ln, act)
    _forward_only("mlp_block_modes", x, ln_w, ln_b, w1, b1, w2, b2)
    runtime.check("x", x, x)
    x2 = x.view(-1, x.shape[-1])
    y = ln_mode(x2, ln_w, ln_b, ln)
    if act == "skip":
        h = runtime.gemm(y, w1.to(x.dtype), b1)
    else:
        h = runtime.gemm_gelu_mode(y, w1.to(x.dtype), b1, mode=act)
    out = runtime.gemm(h, w2.to(x.dtype), b2, residual=x2)
    runtime.count(mlp_block_modes)
    return out.view(x.shape)


mlp_block_modes.launches = 0


# --------------------------------------- S6: the MLP with the hidden on chip

# csrc/mlp_chunked.cu's tiling: a 128-row tile's D = 256·C output columns
# are C CTAs (C ≤ 4), 64·C hidden columns a sub-chunk, a ring of four
# stages of 256 × 64 bf16, and the hidden sub-chunk in rows padded by 8
MLP_CHUNK_TILE_M, MLP_CHUNK_TILE_N, MLP_CHUNK_COLS = 128, 256, 64
MLP_CHUNK_MAX_C, MLP_CHUNK_STAGES = 4, 4
MLP_CHUNK_SMEM = (1024 + MLP_CHUNK_STAGES * MLP_CHUNK_TILE_N * 64 * 2
                  + 16 * MLP_CHUNK_STAGES
                  + MLP_CHUNK_TILE_M * (MLP_CHUNK_COLS * MLP_CHUNK_MAX_C + 8) * 2)
# row tiles a cluster the op takes: the faster of R = 1 and 2 at the bench's
# shape (chip_smoke.py phase 9's sweep, PERF.md)
MLP_CHUNK_ROWS = 2

MlpChunkedPlan = namedtuple("MlpChunkedPlan", [
    "cluster", "grid", "sub_chunk", "stages", "smem_bytes", "l2_bytes",
    "l2_bytes_unicast"])


def mlp_chunk_width(d):
    """The hidden columns csrc/mlp_chunked.cu holds on chip at a time at
    width d: 64 per CTA of a row tile's d/256 CTAs."""
    return MLP_CHUNK_COLS * (d // MLP_CHUNK_TILE_N)


def mlp_chunked_plan(m, d, hidden, rows_per_cluster=MLP_CHUNK_ROWS):
    """How csrc/mlp_chunked.cu runs (m, d) rows with a hidden of ``hidden``:
    a cluster of (C, R) CTAs (C = d/256 columns of a 128-row tile, R =
    ``rows_per_cluster`` row tiles, at most 8 CTAs), the grid (C, R·⌈tiles/R⌉)
    (a last cluster's second tile may lie past m), the sub-chunk width, the
    ring's stages, the shared memory a CTA takes, and the bytes its operand
    loads read from L2: each y slice once per row tile (multicast to its C
    CTAs), each W1 and W2 slice once per cluster (multicast to its R rows),
    and, for the same tiling without multicast, every CTA reading its own
    (``l2_bytes_unicast``). Raises ValueError for a shape the kernel does not
    take."""
    c = d // MLP_CHUNK_TILE_N
    if d % MLP_CHUNK_TILE_N or not 0 < c <= MLP_CHUNK_MAX_C:
        raise ValueError(f"mlp_chunked needs D a multiple of {MLP_CHUNK_TILE_N}"
                         f" up to {MLP_CHUNK_TILE_N * MLP_CHUNK_MAX_C}, "
                         f"got D={d}")
    if rows_per_cluster not in (1, 2) or c * rows_per_cluster > 8:
        raise ValueError(f"mlp_chunked takes 1 or 2 row tiles a cluster of "
                         f"at most 8 CTAs, got {rows_per_cluster} at D={d}")
    sub = mlp_chunk_width(d)
    if hidden <= 0 or hidden % sub:
        raise ValueError(f"mlp_chunked needs the hidden width a multiple of "
                         f"{sub}, got {hidden}")
    if m <= 0:
        raise ValueError(f"mlp_chunked needs rows, got M={m}")
    tiles = -(-m // MLP_CHUNK_TILE_M)
    groups = -(-tiles // rows_per_cluster)
    subs, y_bytes = hidden // sub, m * d * 2
    w_bytes = (MLP_CHUNK_COLS * d + MLP_CHUNK_TILE_N * sub) * 2  # a CTA's W1, W2
    return MlpChunkedPlan(
        cluster=(c, rows_per_cluster), grid=(c, rows_per_cluster * groups),
        sub_chunk=sub, stages=MLP_CHUNK_STAGES, smem_bytes=MLP_CHUNK_SMEM,
        l2_bytes=subs * (y_bytes + groups * c * w_bytes),
        l2_bytes_unicast=subs * c * (y_bytes + tiles * w_bytes))


def mlp_block_chunked_ref(x, ln_w, ln_b, w1, b1, w2, b2, chunks):
    """Plain version of :func:`mlp_block_chunked`, as _mlp_kernel_chunked
    computes it: y = T(LN(x)); per chunk of hidden columns h = y·W1ᵀ + b1,
    T(GELU(h)), its float product with W2's columns; the float partials
    summed in order, + b2, out = x + T(·). The GELU takes torch's erf (the
    kernel's erff; the script's A&S erf is within 1.5e-7 of it)."""
    dt, acc = x.dtype, acc_dtype(x)
    hidden = w1.shape[0]
    if chunks <= 0 or hidden % chunks:
        raise ValueError(f"{chunks} chunks do not divide the hidden {hidden}")
    ck = hidden // chunks
    y = layer_norm(x, ln_w, ln_b).to(acc)
    w1c, w2c, b1c = w1.to(dt).to(acc), w2.to(dt).to(acc), b1.to(acc)
    o = None
    for c in range(chunks):
        cols = slice(c * ck, (c + 1) * ck)
        h = gelu(y @ w1c[cols].t() + b1c[cols]).to(dt).to(acc)
        part = h @ w2c[:, cols].t()
        o = part if o is None else o + part
    return x + (o + b2.to(acc)).to(dt)


def mlp_block_chunked(x, ln_w, ln_b, w1, b1, w2, b2, chunks,
                      rows_per_cluster=MLP_CHUNK_ROWS):
    """B2 with the (M, 4D) hidden never written to device memory: x (...,
    D) -> x's shape. Replaces scripts/bench_overlap.py:_mlp_kernel_chunked
    (S6: the hidden in ``chunks`` chunks of fc1 → GELU → fc2, the float
    partials summed). On the card: the LN kernel, then one launch of
    csrc/mlp_chunked.cu (D/256 CTAs per 128-row tile, ``rows_per_cluster``
    row tiles a cluster, as :func:`mlp_chunked_plan` says; fc1 + GELU of
    each sub-chunk of :func:`mlp_chunk_width` columns into the shared memory
    of the row tile's CTAs, fc2 accumulated over the sub-chunks in
    registers, the operand slices multicast across the cluster). The kernel
    walks the script's chunks in those sub-chunks, so ``chunks`` (which
    must divide the hidden) changes only where the plain version sums its
    partials, and ``rows_per_cluster`` changes no bit of the output. bf16
    only on the card, D a multiple of 256 up to 1024. Forward only."""
    if chunks <= 0 or w1.shape[0] % chunks:
        raise ValueError(f"{chunks} chunks do not divide the hidden "
                         f"{w1.shape[0]}")
    if not runtime.use_kernel(x):
        return mlp_block_chunked_ref(x, ln_w, ln_b, w1, b1, w2, b2, chunks)
    _forward_only("mlp_block_chunked", x, ln_w, ln_b, w1, b1, w2, b2)
    runtime.check("x", x, x)
    x2 = x.view(-1, x.shape[-1])
    out = runtime.mlp_chunked(runtime.layernorm(x2, ln_w, ln_b),
                              w1.to(x.dtype), b1, w2.to(x.dtype), b2, x2,
                              rows_per_cluster)
    runtime.count(mlp_block_chunked)
    return out.view(x.shape)


mlp_block_chunked.launches = 0
