"""Attention half-blocks and packed self-attention for up to 512 tokens.

``attn_half_block`` (out = x + proj(softmax(q kᵀ·dh^-½) v), qkv = LN1(x)·Wqkv
+ b) replaces ``mirage_tpu/ops/block_attention.py:_attn_half_fwd`` /
``_attn_half_kernel`` (B1) and, as its backward, ``_attn_half_bwd_defused``
/ ``_attn_half_bwd_dx_kernel`` (B4). ``block_attention`` (the attention core
on a packed qkv) replaces ``_block_attn_fwd`` / ``_block_attn_kernel`` and
``_block_attn_bwd`` / ``_block_attn_bwd_kernel`` (B6). ``xattn_half_block``
(queries from LN_q(x), keys and values from LN_c(context)) replaces
``_xattn_half_fwd`` / ``_xattn_half_kernel`` (B3); it has no backward, as the
JAX package has no Pallas one, and training never routes to it.

The TPU kernels hold the weights and per-head (N, N) score tiles in 64 MB of
VMEM; an SM has 227 KB, so on the card each op is a chain of CUDA kernels:

- B1: LN (csrc/layernorm.cu) -> qkv GEMM + bias (csrc/gemm.cu) -> attention
  read in place from the packed (B, N, 3D) qkv (csrc/attention.cu) ->
  proj GEMM + bias + residual.
- B4: recompute LN -> qkv -> attention; dattn = dy·Wproj (GEMM);
  the attention backward on the packed qkv (csrc/attention_bwd.cu), which
  also sums the float dqkv for dbqkv; dyln = dqkv·Wqkv (GEMM, float out);
  the LN backward (csrc/layernorm.cu) with dgamma/dbeta partials. dWqkv and
  dWproj are contractions outside, as in the JAX package (:628-640).
- B6: the attention kernel forward, csrc/attention_bwd.cu backward.
- B3: LN_q -> q GEMM; LN_c -> kv GEMM; attention over (B, Nq, D) queries
  and the packed (B, Nc, 2D) kv; proj GEMM + bias (+ residual).

Bound: operations (the projections and the attention products). The
projections run on wgmma, the attention products on mma.sync. This first
version writes the LN output, qkv, the attention output, dattn, dqkv and the
float dyln to device memory between kernels; fusing those away is the first
work of a later PR. The products with a non-transposed weight (dy·Wproj,
dqkv·Wqkv) pass the weight transposed (``w.t().contiguous()``, a copy per
call).

- B7 (attention half, ``MIRAGE_ATTN_BWD=accumulate`` or ``reg_batch``):
  replaces ``_attn_half_bwd_pallas`` / ``_attn_half_bwd_kernel``
  (:457-546), which sums every parameter gradient in float32 in its own
  body over a sequential grid. B4's chain, with dWqkv = T(dqkv)ᵀ·y and
  dWproj = dyᵀ·attn from csrc/wgrad.cu (fixed row chunks, then the chunks
  in a fixed order: Hopper's blocks run in no order) and dbqkv (from the
  float 16-row partials of the unrounded dqkv), dbproj = Σ dy and dγ, dβ
  from its column-sum kernel. ``reg_batch`` changes only when the TPU
  kernel writes its VMEM accumulators (:471-497), not what it sums, so both
  values take this one port. No atomics: a rerun is bit-identical.

Every op saves only its inputs for the backward and recomputes the rest,
as the TPU kernels do. Parameter gradients come back in float32, as the
JAX custom VJPs return them; on a CPU tensor the backward runs the plain
``*_bwd_ref`` functions, which mirror the TPU kernels step by step with the
rounding T(·) to the compute dtype where they round.
"""

import torch

from mirage_tpu_torch.nn.attention import (cross_attention, merge_heads,
                                           packed_attention)
from mirage_tpu_torch.nn.layers import LN_EPS, acc_dtype, layer_norm, linear
from mirage_tpu_torch.ops import runtime


def _needs_grad(*tensors):
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def _heads(t, num_heads, parts):
    """(B, N, parts·D) -> (parts, B, H, N, dh)."""
    b, n, w = t.shape
    dh = w // parts // num_heads
    return t.reshape(b, n, parts, num_heads, dh).permute(2, 0, 3, 1, 4)


def ln_bwd_ref(x, dyln, ln_w, dy):
    """The LayerNorm tail of the TPU backward kernels in the sums' type:
    dx (before rounding), dgamma, dbeta, from x, the float cotangent dyln
    of the LN output and the residual cotangent dy (block_attention.py:
    444-451, fused_mlp.py:227-234). Statistics in two passes."""
    acc = acc_dtype(x)
    x32 = x.to(acc)
    mean = x32.mean(-1, keepdim=True)
    inv = torch.rsqrt((x32 - mean).square().mean(-1, keepdim=True) + LN_EPS)
    yhat = (x32 - mean) * inv
    dims = tuple(range(x.ndim - 1))
    dyhat = dyln * ln_w.to(acc)
    dx = dy.to(acc) + inv * (dyhat - dyhat.mean(-1, keepdim=True)
                             - yhat * (dyhat * yhat).mean(-1, keepdim=True))
    return dx, (dyln * yhat).sum(dims), dyln.sum(dims)


def _flat(t):
    return t.reshape(-1, t.shape[-1])


# ------------------------------------------------------------------ B6

def block_attention_ref(qkv, num_heads, scale):
    """Plain PyTorch version (mirage_tpu/ops/block_attention.py:_attn_xla)."""
    return packed_attention(qkv, num_heads, scale)


def block_attention_bwd_ref(qkv, dout, num_heads, scale):
    """Plain PyTorch backward, step by step as _block_attn_bwd_kernel: P
    recomputed and normalised in float; dP = dO·Vᵀ; delta = rowsum(P∘dP);
    dS = T(P∘(dP − delta)·scale); dQ = dS·K, dK = dSᵀ·Q, dV = T(P)ᵀ·dO.
    Returns dqkv (B, N, 3D) in qkv's dtype."""
    dt, acc = qkv.dtype, acc_dtype(qkv)
    q, k, v = _heads(qkv, num_heads, 3).to(acc)
    do = _heads(dout, num_heads, 1)[0].to(acc)
    p = torch.softmax(q @ k.transpose(-1, -2) * scale, dim=-1)
    dp = do @ v.transpose(-1, -2)
    ds = (p * (dp - (p * dp).sum(-1, keepdim=True)) * scale).to(dt).to(acc)
    dq, dk = ds @ k, ds.transpose(-1, -2) @ q
    dv = p.to(dt).to(acc).transpose(-1, -2) @ do
    return torch.cat([merge_heads(t) for t in (dq, dk, dv)], -1).to(dt)


def _block_attn_fwd(qkv, num_heads, scale):
    if not runtime.use_kernel(qkv):
        return block_attention_ref(qkv, num_heads, scale)
    b, n, three_d = qkv.shape
    d = three_d // 3
    runtime.check("qkv", qkv, qkv)
    out = qkv.new_empty(b, n, d)
    runtime.attention(qkv, qkv[:, :, d:], qkv[:, :, 2 * d:], out,
                      heads=num_heads, dh=d // num_heads, scale=scale)
    block_attention.launches += 1
    return out


def _block_attn_bwd(qkv, dout, num_heads, scale):
    if not runtime.use_kernel(qkv):
        return block_attention_bwd_ref(qkv, dout, num_heads, scale)
    d = qkv.shape[-1] // 3
    dqkv, _ = runtime.attention_bwd(qkv, dout.contiguous(), heads=num_heads,
                                    dh=d // num_heads, scale=scale)
    block_attention.bwd_launches += 1
    return dqkv


class _BlockAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv, num_heads, scale):
        ctx.save_for_backward(qkv)
        ctx.num_heads, ctx.scale = num_heads, scale
        return _block_attn_fwd(qkv, num_heads, scale)

    @staticmethod
    def backward(ctx, dout):
        (qkv,) = ctx.saved_tensors
        return _block_attn_bwd(qkv, dout, ctx.num_heads, ctx.scale), None, None


def block_attention(qkv, num_heads, scale):
    """Multi-head self-attention over the packed (B, N, 3D) qkv (column
    order q|k|v × heads × dh) -> (B, N, D); differentiable (B6 forward and
    backward on the card)."""
    if _needs_grad(qkv):
        return _BlockAttention.apply(qkv, num_heads, scale)
    return _block_attn_fwd(qkv, num_heads, scale)


block_attention.launches = 0
block_attention.bwd_launches = 0


# ------------------------------------------------------------- B1 / B4

def attn_half_block_ref(x, ln_w, ln_b, wqkv, bqkv, wproj, bproj, num_heads):
    """Plain PyTorch version (mirage_tpu/ops/block_attention.py:
    _attn_half_xla)."""
    qkv = linear(layer_norm(x, ln_w, ln_b), wqkv, bqkv)
    return x + linear(packed_attention(qkv, num_heads), wproj, bproj)


def attn_half_block_bwd_ref(x, dy, ln_w, ln_b, wqkv, bqkv, wproj,
                            num_heads):
    """Plain PyTorch backward, step by step as _attn_half_bwd_rows: recompute
    y = T(LN(x)), qkv = T(y·Wqkv + b) and P (normalised, float), attn =
    T(T(P)·V); dattn = T(dy·Wproj); the attention backward with dbqkv from
    the float dqkv; dyln = T(dqkv)·Wqkv in float; the LN backward.

    Returns (dx, dgamma, dbeta, dwqkv, dbqkv, dwproj, dbproj) as
    _attn_half_bwd_defused does, the parameter grads in float and in torch
    layout (dwqkv (3D, D), dwproj (D, D)); dbqkv is None without a bias."""
    dt, acc = x.dtype, acc_dtype(x)
    b, n, d = x.shape
    scale = (d // num_heads) ** -0.5
    y = layer_norm(x, ln_w, ln_b)
    wq, wp = wqkv.to(dt).to(acc), wproj.to(dt).to(acc)
    qkv = y.to(acc) @ wq.t()
    if bqkv is not None:
        qkv = qkv + bqkv.to(acc)
    qkv = qkv.to(dt)
    q, k, v = _heads(qkv, num_heads, 3).to(acc)
    p = torch.softmax(q @ k.transpose(-1, -2) * scale, dim=-1)
    attn = merge_heads(p.to(dt).to(acc) @ v).to(dt)
    dy32 = dy.to(acc)
    dattn = (dy32 @ wp).to(dt)
    do = _heads(dattn, num_heads, 1)[0].to(acc)
    dp = do @ v.transpose(-1, -2)
    ds = (p * (dp - (p * dp).sum(-1, keepdim=True)) * scale).to(dt).to(acc)
    dqkv = torch.cat([merge_heads(t) for t in (
        ds @ k, ds.transpose(-1, -2) @ q,
        p.to(dt).to(acc).transpose(-1, -2) @ do)], -1)
    dbqkv = dqkv.sum((0, 1)) if bqkv is not None else None
    dqkv_c = dqkv.to(dt).to(acc)
    dx, dgamma, dbeta = ln_bwd_ref(x, dqkv_c @ wq, ln_w, dy)
    dwqkv = _flat(dqkv_c).t() @ _flat(y.to(acc))
    dwproj = _flat(dy32).t() @ _flat(attn.to(acc))
    return (dx.to(dt), dgamma, dbeta, dwqkv, dbqkv, dwproj,
            dy32.sum((0, 1)))


def _attn_half_fwd(x, ln_w, ln_b, wqkv, bqkv, wproj, bproj, num_heads):
    if not runtime.use_kernel(x):
        return attn_half_block_ref(x, ln_w, ln_b, wqkv, bqkv, wproj, bproj,
                                   num_heads)
    b, n, d = x.shape
    runtime.check("x", x, x)
    x2 = x.view(b * n, d)
    qkv = runtime.gemm(runtime.layernorm(x2, ln_w, ln_b), wqkv.to(x.dtype),
                       bqkv).view(b, n, 3 * d)
    attn = x.new_empty(b, n, d)
    dh = d // num_heads
    runtime.attention(qkv, qkv[:, :, d:], qkv[:, :, 2 * d:], attn,
                      heads=num_heads, dh=dh, scale=dh ** -0.5)
    out = runtime.gemm(attn.view(b * n, d), wproj.to(x.dtype), bproj,
                       residual=x2)
    attn_half_block.launches += 1
    return out.view(b, n, d)


def _attn_half_bwd_chain(x, dy, ln_w, ln_b, wqkv, bqkv, wproj, num_heads):
    """The kernels B4 and B7 share: the recompute (LN, qkv, attention),
    dattn, the attention backward and the LN backward. Returns dx, the rows
    y, dqkv, attn and dy, and the float partials of dgamma, dbeta (32-row)
    and dbqkv (16-row, of the unrounded dqkv)."""
    b, n, d = x.shape
    dh = d // num_heads
    scale = dh ** -0.5
    runtime.check("x", x, x)
    x2, dy2 = x.view(b * n, d), dy.contiguous().view(b * n, d)
    wq = wqkv.to(x.dtype).contiguous()
    y = runtime.layernorm(x2, ln_w, ln_b)
    qkv = runtime.gemm(y, wq, bqkv).view(b, n, 3 * d)
    attn = x.new_empty(b, n, d)
    runtime.attention(qkv, qkv[:, :, d:], qkv[:, :, 2 * d:], attn,
                      heads=num_heads, dh=dh, scale=scale)
    dattn = runtime.gemm(dy2, wproj.to(x.dtype).t().contiguous())
    dqkv, dbqkv = runtime.attention_bwd(qkv, dattn.view(b, n, d),
                                        heads=num_heads, dh=dh, scale=scale,
                                        partials=True)
    dqkv = dqkv.view(b * n, 3 * d)
    dyln = runtime.gemm(dqkv, wq.t().contiguous(), out_dtype=torch.float32)
    dx, dgamma, dbeta = runtime.layernorm_bwd(x2, ln_w, dyln, dy2,
                                              partials=True)
    return (dx.view(b, n, d), y, dqkv, attn.view(b * n, d), dy2, dgamma,
            dbeta, dbqkv)


def _attn_half_bwd(x, dy, ln_w, ln_b, wqkv, bqkv, wproj, num_heads):
    """B4 on the card: the shared chain; dWqkv, dWproj, dbproj and the
    partial sums outside, as the JAX package leaves them to XLA."""
    if not runtime.use_kernel(x):
        return attn_half_block_bwd_ref(x, dy, ln_w, ln_b, wqkv, bqkv, wproj,
                                       num_heads)
    dx, y, dqkv, attn, dy2, dgamma, dbeta, dbqkv = _attn_half_bwd_chain(
        x, dy, ln_w, ln_b, wqkv, bqkv, wproj, num_heads)
    attn_half_block.bwd_launches += 1
    return (dx, dgamma.sum(0), dbeta.sum(0), runtime.wgrad(dqkv, y),
            dbqkv.sum(0) if bqkv is not None else None,
            runtime.wgrad(dy2, attn), dy2.float().sum(0))


# The accumulating backward (B7) computes what _attn_half_bwd_rows computes
# over every batch element, with the parameter grads summed: B4's function
# and rounding (dbqkv from the float dqkv, dWqkv = T(dqkv)ᵀ·y, dWproj =
# dyᵀ·T(attn)), so its plain version is B4's.
attn_half_block_bwd_acc_ref = attn_half_block_bwd_ref


def _attn_half_bwd_acc(x, dy, ln_w, ln_b, wqkv, bqkv, wproj, num_heads):
    """B7 (attention half) on the card: the shared chain with every
    reduction in the wgrad and column-sum kernels."""
    if not runtime.use_kernel(x):
        return attn_half_block_bwd_acc_ref(x, dy, ln_w, ln_b, wqkv, bqkv,
                                           wproj, num_heads)
    dx, y, dqkv, attn, dy2, dgamma, dbeta, dbqkv = _attn_half_bwd_chain(
        x, dy, ln_w, ln_b, wqkv, bqkv, wproj, num_heads)
    attn_half_block.acc_bwd_launches += 1
    return (dx, runtime.colsum(dgamma), runtime.colsum(dbeta),
            runtime.weight_grad(dqkv, y),
            runtime.colsum(dbqkv) if bqkv is not None else None,
            runtime.weight_grad(dy2, attn), runtime.colsum(dy2))


class _AttnHalf(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ln_w, ln_b, wqkv, bqkv, wproj, bproj, num_heads):
        ctx.save_for_backward(x, ln_w, ln_b, wqkv, bqkv, wproj)
        ctx.num_heads = num_heads
        return _attn_half_fwd(x, ln_w, ln_b, wqkv, bqkv, wproj, bproj,
                              num_heads)

    @staticmethod
    def backward(ctx, dy):
        bwd = (_attn_half_bwd if runtime.switches["MIRAGE_ATTN_BWD"]
               == "defused" else _attn_half_bwd_acc)
        return (*bwd(*ctx.saved_tensors[:1], dy, *ctx.saved_tensors[1:],
                     ctx.num_heads), None)


def attn_half_block(x, ln_w, ln_b, wqkv, bqkv, wproj, bproj, num_heads):
    """x: (B, N, D); wqkv (3D, D), wproj (D, D) torch Linear layout; bqkv
    may be None (a qkv_bias=False model). Differentiable (B4 backward on
    the card, B7 under MIRAGE_ATTN_BWD=accumulate|reg_batch); weights of
    another dtype than x are cast to it."""
    if _needs_grad(x, ln_w, ln_b, wqkv, bqkv, wproj, bproj):
        return _AttnHalf.apply(x, ln_w, ln_b, wqkv, bqkv, wproj, bproj,
                               num_heads)
    return _attn_half_fwd(x, ln_w, ln_b, wqkv, bqkv, wproj, bproj, num_heads)


attn_half_block.launches = 0
attn_half_block.bwd_launches = 0
attn_half_block.acc_bwd_launches = 0


# ------------------------------------------------------------------ B3

def xattn_half_block_ref(x, context, lnq_w, lnq_b, lnc_w, lnc_b, wq, bq,
                         wkv, bkv, wproj, bproj, num_heads, residual=True):
    """Plain PyTorch version (mirage_tpu/ops/block_attention.py:
    _xattn_half_xla)."""
    out = cross_attention(
        wq, bq, wkv, bkv, wproj, bproj, layer_norm(x, lnq_w, lnq_b),
        layer_norm(context, lnc_w, lnc_b), num_heads)
    return x + out if residual else out


def xattn_half_block(x, context, lnq_w, lnq_b, lnc_w, lnc_b, wq, bq, wkv,
                     bkv, wproj, bproj, num_heads, residual=True):
    """x: (B, Nq, D) queries, context: (B, Nc, D); wq (D, D), wkv (2D, D),
    wproj (D, D) torch Linear layout; bq/bkv may be None. residual=False
    returns the cross-attention branch without the skip-add, which is what
    the reference decoder computes (SpatialOutputAdapter). Inference only on
    the card: under autograd a CUDA tensor raises (there is no kernel
    backward; training takes the plain cross-attention)."""
    if not runtime.use_kernel(x):
        return xattn_half_block_ref(x, context, lnq_w, lnq_b, lnc_w, lnc_b,
                                    wq, bq, wkv, bkv, wproj, bproj, num_heads,
                                    residual)
    if _needs_grad(x, context, lnq_w, lnq_b, lnc_w, lnc_b, wq, bq, wkv, bkv,
                   wproj, bproj):
        raise RuntimeError(
            "xattn_half_block has no backward kernel (the JAX package has no "
            "Pallas backward for it); call it without gradients, or use the "
            "plain cross-attention (nn.attention.cross_attention_apply)")
    b, nq, d = x.shape
    nc = context.shape[1]
    runtime.check("x", x, x)
    runtime.check("context", context, x, (b, nc, d))
    x2 = x.view(b * nq, d)
    q = runtime.gemm(runtime.layernorm(x2, lnq_w, lnq_b), wq.to(x.dtype), bq)
    kv = runtime.gemm(runtime.layernorm(context.view(b * nc, d), lnc_w,
                                        lnc_b), wkv.to(x.dtype), bkv)
    kv = kv.view(b, nc, 2 * d)
    attn = x.new_empty(b, nq, d)
    dh = d // num_heads
    runtime.attention(q.view(b, nq, d), kv, kv[:, :, d:], attn,
                      heads=num_heads, dh=dh, scale=dh ** -0.5)
    out = runtime.gemm(attn.view(b * nq, d), wproj.to(x.dtype), bproj,
                       residual=x2 if residual else None)
    xattn_half_block.launches += 1
    return out.view(b, nq, d)


xattn_half_block.launches = 0
