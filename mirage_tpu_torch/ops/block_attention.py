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
- B4: recompute LN -> qkv -> attention; dattn = T(dy·Wproj) and, after
  the attention backward on the packed qkv (csrc/attention_bwd.cu, which
  also sums the float dqkv for dbqkv), dyln = dqkv·Wqkv in float, both on
  csrc/mlp_bwd.cu's dyln product, which reads the weight as it lies (no
  transposed copy); the LN backward (csrc/layernorm.cu), which finishes
  dgamma and dbeta itself. dWqkv and dWproj are contractions outside, as
  in the JAX package (:628-640).
- B6: the attention kernel forward, csrc/attention_bwd.cu backward.
- B3: LN_q -> q GEMM; LN_c -> kv GEMM; attention over (B, Nq, D) queries
  and the packed (B, Nc, 2D) kv; proj GEMM + bias (+ residual).

Bound: operations (the projections and the attention products). The
projections, the attention forward (csrc/attention_fwd.cuh, tiled as
:func:`attention_plan` says) and its backward (csrc/attention_bwd.cuh, as
:func:`attention_bwd_plan` says) run on wgmma. The chains write the LN
output, qkv, the attention output, dattn, dqkv and the float dyln to device
memory between kernels; fusing those away is the first work of a later PR.

- B7 (attention half, ``MIRAGE_ATTN_BWD=accumulate`` or ``reg_batch``):
  replaces ``_attn_half_bwd_pallas`` / ``_attn_half_bwd_kernel``
  (:457-546), which sums every parameter gradient in float32 in its own
  body over a sequential grid. B4's chain, with dWqkv = T(dqkv)ᵀ·y and
  dWproj = dyᵀ·attn from csrc/wgrad.cu (fixed row chunks, then the chunks
  in a fixed order: Hopper's blocks run in no order) and dbqkv (from the
  float 16-row partials of the unrounded dqkv) and dbproj = Σ dy from its
  column-sum kernel, dγ and dβ from the LN backward. ``reg_batch``
  changes only when the TPU kernel writes its VMEM accumulators
  (:471-497), not what it sums, so both values take this one port. No
  atomics: a rerun is bit-identical.

Three forward-only halves are A/B cases of the port's bench
(``mirage_tpu_torch.bench``): ``attn_half_block_masked`` (keys past
n_valid masked, scripts/bench_pad264.py) and ``attn_half_block_prenormed``
(B1 from a pre-normed input, scripts/bench_lnfold.py) are B1's chain with
another key count or without its LN, and add no CUDA code;
``attn_half_block_phased`` (scripts/bench_attn_half.py, bench_vpu.py and
bench_overlap.py: S2, S5, S6) is B1 with its attention in three phases over
a group of heads (csrc/attention_phased.cu, tiled by :func:`phased_plan`),
its LN in two passes, one pass or skipped, and its softmax in one of four
modes.

Every op saves only its inputs for the backward and recomputes the rest,
as the TPU kernels do. Parameter gradients come back in float32, as the
JAX custom VJPs return them; on a CPU tensor the backward runs the plain
``*_bwd_ref`` functions, which mirror the TPU kernels step by step with the
rounding T(·) to the compute dtype where they round.
"""

import functools
from collections import namedtuple

import torch

from mirage_tpu_torch.nn.attention import (cross_attention, merge_heads,
                                           packed_attention, sdpa)
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


# ------------------------------------------- the attention forward's plan

# csrc/attention_fwd.cuh: query rows a consumer warpgroup owns, keys a ring
# stage holds, consumer warpgroups a CTA
ATTN_QROWS, ATTN_KEYS, ATTN_CONSUMERS = 64, 64, 2
AttentionPlan = namedtuple("AttentionPlan", [
    "grid", "query_tiles", "key_chunks", "tail_width", "box_cols", "boxes",
    "swizzle_bytes", "pv_width", "stages", "smem_bytes", "ctas_per_sm",
    "waves"])


@functools.lru_cache(maxsize=256)
def attention_plan(nq, nk, dh, heads, batch, sms):
    """How the bf16 attention forward (csrc/attention_fwd.cuh, behind
    :func:`runtime.attention` and :func:`runtime.flash_attention`) runs one
    call: an :class:`AttentionPlan`.

    The grid is (⌈nq/128⌉, heads, batch): a CTA holds two warpgroups of 64
    query rows (``query_tiles``: (first row, rows) of each warpgroup with
    rows, over one head; a warpgroup past nq exits). Keys stream in chunks of
    64 (``key_chunks``: (first key, issued width, keys)), the last issued
    ``tail_width`` = 8·⌈r/8⌉ wide for its r keys, through a ring of
    ``stages`` (K and V a stage; five where one 64-column box holds the head,
    so up to 320 keys are all in flight from the start). A head dim of 16 or
    32 is loaded in boxes of its own width (32- or 64-byte swizzle), the
    others in ``boxes`` 64-column boxes (128-byte swizzle) whose k-steps stop
    at dh; P·V runs ``pv_width`` wide. ``ctas_per_sm``: the kernel's launch
    bounds (two CTAs of 256 threads at a P·V width of 64 or less), ``waves``
    of them over ``sms`` SMs. A head dim outside 16..128 in steps of 16, or
    an empty dimension, raises ValueError."""
    if dh % 16 or not 16 <= dh <= 128:
        raise ValueError(f"head dim {dh} unsupported: need a multiple of 16 "
                         f"up to 128")
    if min(nq, nk, heads, batch, sms) <= 0:
        raise ValueError(f"attention_plan: empty shape nq={nq} nk={nk} "
                         f"heads={heads} batch={batch} sms={sms}")
    box = dh if dh in (16, 32) else 64
    boxes = -(-dh // box)
    pv_width = boxes * box
    tile = boxes * ATTN_KEYS * box * 2
    stages = 5 if box == 64 and boxes == 1 else 4
    smem = 1024 + (ATTN_CONSUMERS + 2 * stages) * tile + 8 * (2 * stages + 1)
    if smem > SMEM_PER_BLOCK:
        raise ValueError(f"attention_plan: {smem} bytes of shared memory")
    nch = -(-nk // ATTN_KEYS)
    tail = nk - (nch - 1) * ATTN_KEYS
    tail_width = -(-tail // 8) * 8
    chunks = tuple((c * ATTN_KEYS, ATTN_KEYS if c < nch - 1 else tail_width,
                    min(ATTN_KEYS, nk - c * ATTN_KEYS)) for c in range(nch))
    tiles = tuple((t * ATTN_QROWS, min(ATTN_QROWS, nq - t * ATTN_QROWS))
                  for t in range(-(-nq // ATTN_QROWS)))
    grid = (-(-nq // (ATTN_QROWS * ATTN_CONSUMERS)), heads, batch)
    ctas_per_sm = 2 if pv_width <= 64 else 1
    waves = grid[0] * heads * batch / (sms * ctas_per_sm)
    return AttentionPlan(grid, tiles, chunks, tail_width, box, boxes, 2 * box,
                         pv_width, stages, smem, ctas_per_sm, waves)


# ------------------------------------------- the attention backward's plan

# csrc/attention_bwd.cuh: rows of a CTA's one warpgroup (queries in the dQ
# kernel, keys in the dK/dV kernel), keys a dQ ring stage holds, threads a
# CTA, the shared memory a CTA is sized to (three an SM), and an SM's;
# tokens of head_kernel's items (two warpgroups a CTA), its bf16 P or dS
# plane of 64 keys and its input buffers
ATTN_BWD_ROWS, ATTN_BWD_KEYS, ATTN_BWD_THREADS = 64, 64, 128
ATTN_BWD_SMEM_BUDGET, SMEM_PER_SM = 72 * 1024, 233472
ATTN_BWD_HEAD_ROWS, ATTN_BWD_PLANE, ATTN_BWD_HEAD_BUFS = 128, 128 * 128, 3
AttentionBwdPlan = namedtuple("AttentionBwdPlan", [
    "head_kernel", "head_grid", "head_smem_bytes", "dq_grid", "dkv_grid",
    "query_tiles", "key_tiles", "key_chunks", "query_chunks", "box_cols",
    "boxes", "swizzle_bytes", "pv_width", "dq_stages", "dkv_stages",
    "resident", "dq_loads", "dq_smem_bytes", "dkv_smem_bytes", "ctas_per_sm",
    "products"])


def _stages(fit):
    return max(2, min(8, fit))


@functools.lru_cache(maxsize=256)
def attention_bwd_plan(nq, nk, dh, heads, batch, sms, packed=False):
    """How the bf16 attention backward (csrc/attention_bwd.cuh, behind
    :func:`runtime.attention_bwd` and :func:`runtime.flash_attention_bwd`)
    runs one call: an :class:`AttentionBwdPlan`.

    The packed form at up to 128 tokens and head dims up to 64
    (``head_kernel``, B4's core) is one persistent launch of ``head_grid``
    CTAs (one an SM of ``sms``, at most one an item) of two warpgroups,
    each CTA walking the (batch, head) items with three input buffers (two
    items loading ahead), every product once (``products`` 5),
    ``head_smem_bytes`` of shared memory.
    Otherwise there are two launches, each a CTA of one warpgroup of 128
    threads (``products`` 7, the head fields None). The dQ kernel's
    grid is (⌈nq/64⌉, heads, batch): a CTA owns 64 query rows
    (``query_tiles``: (first row, rows)), loads their Q and dO once and
    streams K and V in chunks of 64 keys (``key_chunks``: (first key, keys))
    through a ring of ``dq_stages`` twice, a pass for the row statistics and
    one for dQ; where every chunk fits the ring (``resident``), the second
    pass reads what the first loaded (``dq_loads`` chunk loads a CTA). The
    dK/dV kernel's grid is (⌈nk/64⌉, heads, batch): a CTA owns 64 keys
    (``key_tiles``), loads their K and V once and streams Q and dO in chunks
    of 64 queries, 32 above a head dim of 64 (``query_chunks``), through
    ``dkv_stages``. Head dims 16 and 32 load boxes of their own width, the
    others 64-column ``boxes``; the dQ, dK and dV products run ``pv_width``
    wide. The stages fill a CTA's shared memory up to 72 KB (2 to 8 of
    them), ``ctas_per_sm`` of the larger CTA fitting an SM's; ``products``
    (7) counts the matrix products a (query, key) pair costs. ``packed``:
    the packed qkv of mtt_attention_bwd, which takes nq = nk ≤ 512. A head
    dim outside 16..128 in steps of 16, an empty dimension or a packed shape
    the entry refuses raises ValueError."""
    if dh % 16 or not 16 <= dh <= 128:
        raise ValueError(f"head dim {dh} unsupported: need a multiple of 16 "
                         f"up to 128")
    if min(nq, nk, heads, batch, sms) <= 0:
        raise ValueError(f"attention_bwd_plan: empty shape nq={nq} nk={nk} "
                         f"heads={heads} batch={batch} sms={sms}")
    if packed and (nq != nk or nq > runtime.MAX_KEYS):
        raise ValueError(f"attention_bwd_plan: the packed backward takes "
                         f"nq = nk ≤ {runtime.MAX_KEYS}, got {nq}, {nk}")
    rows, kc = ATTN_BWD_ROWS, ATTN_BWD_KEYS
    box = dh if dh in (16, 32) else 64
    boxes = -(-dh // box)
    pv_width = boxes * box
    qc = 64 if pv_width <= 64 else 32
    tile, qtile = boxes * rows * 2 * box, boxes * qc * 2 * box
    budget = ATTN_BWD_SMEM_BUDGET - 1024 - 2 * tile
    dq_stages, dkv_stages = _stages(budget // (2 * tile)), _stages(
        budget // (2 * qtile))
    dq_smem = 1024 + (2 + 2 * dq_stages) * tile + 8 * (2 * dq_stages + 1)
    dkv_smem = 1024 + 2 * tile + 2 * dkv_stages * qtile \
        + 8 * (2 * dkv_stages + 1)
    nch = -(-nk // kc)
    resident = nch <= dq_stages
    head = packed and nq <= ATTN_BWD_HEAD_ROWS and pv_width <= 64
    p_in_kv = 4 * tile >= 2 * ATTN_BWD_PLANE  # T(P) where K and V were
    head_smem = (1024 + ATTN_BWD_HEAD_BUFS * 8 * tile
                 + (2 if p_in_kv else 4) * ATTN_BWD_PLANE
                 + 8 * ATTN_BWD_HEAD_BUFS)

    def spans(n, step):
        return tuple((i * step, min(step, n - i * step))
                     for i in range(-(-n // step)))

    return AttentionBwdPlan(
        head, (min(sms, batch * heads),) if head else None,
        head_smem if head else None,
        (-(-nq // rows), heads, batch), (-(-nk // rows), heads, batch),
        spans(nq, rows), spans(nk, rows), spans(nk, kc), spans(nq, qc), box,
        boxes, 2 * box, pv_width, dq_stages, dkv_stages, resident,
        nch if resident else 2 * nch, dq_smem, dkv_smem,
        SMEM_PER_SM // (max(dq_smem, dkv_smem) + 1024), 5 if head else 7)


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
    runtime.count(block_attention)
    return out


def _block_attn_bwd(qkv, dout, num_heads, scale):
    if not runtime.use_kernel(qkv):
        return block_attention_bwd_ref(qkv, dout, num_heads, scale)
    d = qkv.shape[-1] // 3
    dqkv, _ = runtime.attention_bwd(qkv, dout.contiguous(), heads=num_heads,
                                    dh=d // num_heads, scale=scale)
    runtime.count(block_attention, "bwd_launches")
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
    runtime.count(attn_half_block)
    return out.view(b, n, d)


def _attn_half_bwd_chain(x, dy, ln_w, ln_b, wqkv, bqkv, wproj, num_heads):
    """The kernels B4 and B7 share: the recompute (LN, qkv, attention),
    dattn, the attention backward and the LN backward. Returns dx, the rows
    y, dqkv, attn and dy, the float dgamma and dbeta, and the float 16-row
    partials of dbqkv (of the unrounded dqkv)."""
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
    # dattn = T(dy·Wproj) and dyln = dqkv·Wqkv (float) read both weights as
    # they lie (csrc/mlp_bwd.cu's dyln product: W MN-major, no copy)
    dattn = runtime.mlp_bwd_dyln(dy2, wproj.to(x.dtype).contiguous(),
                                 out_dtype=x.dtype)
    dqkv, dbqkv = runtime.attention_bwd(qkv, dattn.view(b, n, d),
                                        heads=num_heads, dh=dh, scale=scale,
                                        partials=True)
    dqkv = dqkv.view(b * n, 3 * d)
    dyln = runtime.mlp_bwd_dyln(dqkv, wq)
    dx, dgamma, dbeta = runtime.layernorm_bwd(x2, ln_w, dyln, dy2)
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
    runtime.count(attn_half_block, "bwd_launches")
    return (dx, dgamma, dbeta, runtime.wgrad(dqkv, y),
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
    runtime.count(attn_half_block, "acc_bwd_launches")
    return (dx, dgamma, dbeta, runtime.weight_grad(dqkv, y),
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
    runtime.count(xattn_half_block)
    return out.view(b, nq, d)


xattn_half_block.launches = 0


# ------------------------------------------------- the bench's A/B halves

def _forward_only(name, *tensors):
    if _needs_grad(*tensors):
        raise RuntimeError(f"{name} is forward only on the card (an A/B case "
                           f"of the bench); call it without gradients")


def attn_half_block_masked_ref(x, ln_w, ln_b, wqkv, bqkv, wproj, bproj,
                               num_heads, n_valid):
    """Plain version of :func:`attn_half_block_masked`: every query row,
    the keys and values of the first ``n_valid`` rows (a key masked to
    −1e30 before the softmax gets an exact zero)."""
    b, n, d = x.shape
    dh = d // num_heads
    qkv = linear(layer_norm(x, ln_w, ln_b), wqkv, bqkv)
    q, k, v = _heads(qkv, num_heads, 3)
    attn = merge_heads(sdpa(q, k[:, :, :n_valid], v[:, :, :n_valid],
                            dh ** -0.5))
    return x + linear(attn, wproj, bproj)


def attn_half_block_masked(x, ln_w, ln_b, wqkv, bqkv, wproj, bproj,
                           num_heads, n_valid):
    """B1 over N rows with the keys at index ≥ n_valid masked: x (B, N, D)
    -> (B, N, D). Replaces scripts/bench_pad264.py:_attn_half_masked_kernel
    (B1 at 264 tokens, keys past 257 masked to −1e30), the TPU's padding of
    257 tokens to its 8-row tiles. On the card it is B1's chain with every
    query row computed and the attention kernel given the first n_valid
    rows as its keys (csrc/attention.cu takes the key count apart from the
    query count and masks its ragged last key chunk): masked keys are never
    read, and the op adds no CUDA code. Forward only."""
    if not 0 < n_valid <= x.shape[1]:
        raise ValueError(f"n_valid {n_valid} not in 1..{x.shape[1]}")
    if not runtime.use_kernel(x):
        return attn_half_block_masked_ref(x, ln_w, ln_b, wqkv, bqkv, wproj,
                                          bproj, num_heads, n_valid)
    _forward_only("attn_half_block_masked", x, ln_w, ln_b, wqkv, bqkv, wproj,
                  bproj)
    b, n, d = x.shape
    runtime.check("x", x, x)
    x2 = x.view(b * n, d)
    qkv = runtime.gemm(runtime.layernorm(x2, ln_w, ln_b), wqkv.to(x.dtype),
                       bqkv).view(b, n, 3 * d)
    attn = x.new_empty(b, n, d)
    dh = d // num_heads
    runtime.attention(qkv, qkv[:, :n_valid, d:], qkv[:, :n_valid, 2 * d:],
                      attn, heads=num_heads, dh=dh, scale=dh ** -0.5)
    out = runtime.gemm(attn.view(b * n, d), wproj.to(x.dtype), bproj,
                       residual=x2)
    runtime.count(attn_half_block_masked)
    return out.view(b, n, d)


attn_half_block_masked.launches = 0


def attn_half_block_prenormed_ref(x, y, wqkv, bqkv, wproj, bproj, num_heads):
    """Plain version of :func:`attn_half_block_prenormed`."""
    qkv = linear(y, wqkv, bqkv)
    return x + linear(packed_attention(qkv, num_heads), wproj, bproj)


def attn_half_block_prenormed(x, y, wqkv, bqkv, wproj, bproj, num_heads):
    """B1 from a pre-normed y = LN1(x) (the folded MLP half's second output,
    :func:`mirage_tpu_torch.ops.fused_mlp.mlp_block_lnfold`), x kept for the
    residual: x + proj(attn(y·Wqkvᵀ + b)). Replaces scripts/bench_lnfold.py:
    _attn_prenormed_kernel. On the card it is B1's chain from the qkv GEMM
    on, so it needs no kernel of its own. Its attention kernel
    (csrc/attention.cu) takes the softmax in exp2 with the scale in log2
    units, as the TPU kernel and the production Pallas kernels do; the
    natural-units ``expf`` softmax is S5's "exp" mode
    (:func:`attn_half_block_phased`). Forward only."""
    if not runtime.use_kernel(x):
        return attn_half_block_prenormed_ref(x, y, wqkv, bqkv, wproj, bproj,
                                             num_heads)
    _forward_only("attn_half_block_prenormed", x, y, wqkv, bqkv, wproj, bproj)
    b, n, d = x.shape
    runtime.check("x", x, x)
    runtime.check("y", y, x, (b, n, d))
    x2 = x.view(b * n, d)
    qkv = runtime.gemm(y.view(b * n, d), wqkv.to(x.dtype),
                       bqkv).view(b, n, 3 * d)
    attn = x.new_empty(b, n, d)
    dh = d // num_heads
    runtime.attention(qkv, qkv[:, :, d:], qkv[:, :, 2 * d:], attn,
                      heads=num_heads, dh=dh, scale=dh ** -0.5)
    out = runtime.gemm(attn.view(b * n, d), wproj.to(x.dtype), bproj,
                       residual=x2)
    runtime.count(attn_half_block_prenormed)
    return out.view(b, n, d)


attn_half_block_prenormed.launches = 0


# ------------------------------------- S2, S5, S6: the phased attention half

LN_MODES = ("two_pass", "onepass", "skip")
SMAX_MODES = ("exp", "exp2", "nomax", "skip")
_LOG2E = 1.4426950408889634


def ln_mode_ref(x, ln_w, ln_b, ln):
    """scripts/bench_vpu.py:_ln in x's dtype: "two_pass" (the port's
    LayerNorm), "onepass" (E[x²] − mean², clamped at 0 as the kernel does)
    or "skip" (x itself, no scale or shift)."""
    if ln == "two_pass":
        return layer_norm(x, ln_w, ln_b)
    if ln == "skip":
        return x
    if ln != "onepass":
        raise ValueError(f"LN mode {ln!r} not in {LN_MODES}")
    acc = acc_dtype(x)
    x32 = x.to(acc)
    mean = x32.mean(-1, keepdim=True)
    var = torch.clamp(x32.square().mean(-1, keepdim=True) - mean.square(), min=0)
    y = (x32 - mean) * torch.rsqrt(var + LN_EPS)
    return (y * ln_w.to(acc) + ln_b.to(acc)).to(x.dtype)


def ln_mode(x2, ln_w, ln_b, ln):
    """The LN stage of a bench half on the card over the rows x2 (M, D): the
    LN kernel in two passes or one, or x2 itself ("skip": no launch)."""
    if ln == "skip":
        return x2
    return runtime.layernorm(x2, ln_w, ln_b, onepass=ln == "onepass")


def phased_attention_ref(qkv, num_heads, smax="exp", divide=True):
    """Plain version of the phased attention core on the packed (B, N, 3D)
    qkv, as _v2_kernel and _attn_kernel_v compute it: float scores ·
    dh^-½; "exp" e = exp(s − max), "exp2" e = exp2((s − max)·log2 e),
    "nomax" e = exp(s), "skip" e = s (wrong math, kept for timing); l = Σ e;
    out = T(T(e)·v / l) (without the division when not ``divide``). The
    head grouping does not change the function."""
    if smax not in SMAX_MODES:
        raise ValueError(f"softmax mode {smax!r} not in {SMAX_MODES}")
    dt, acc = qkv.dtype, acc_dtype(qkv)
    dh = qkv.shape[-1] // 3 // num_heads
    q, k, v = _heads(qkv, num_heads, 3).to(acc)
    s = q @ k.transpose(-1, -2) * dh ** -0.5
    if smax == "skip":
        e = s
    elif smax == "nomax":
        e = torch.exp(s)
    elif smax == "exp2":
        e = torch.exp2((s - s.amax(-1, keepdim=True)) * _LOG2E)
    else:
        e = torch.exp(s - s.amax(-1, keepdim=True))
    o = e.to(dt).to(acc) @ v
    if divide:
        o = o / e.sum(-1, keepdim=True)
    return merge_heads(o).to(dt)


PHASED_MAX_KEYS, PHASED_MAX_CLUSTER, SMEM_PER_BLOCK = 512, 8, 232448
PhasedPlan = namedtuple("PhasedPlan",
                        "heads_per_cta cluster qtile smem branch qsplit")


def _phased_resident_bytes(nk, dh, hpc, qt):
    """csrc/attention_phased.cu:resident_smem_bytes: K and V of hpc heads,
    hpc·qt float score rows of nk keys (padded to 16, + 4) and their sums,
    hpc·qt bf16 P rows (+ 8) and the double-buffered (qt, hpc·dh + 8) query
    tile."""
    nkp = -(-nk // 16) * 16
    return (4 * hpc * nkp * (dh + 8) + 4 * (hpc * qt * (nkp + 4) + hpc * qt)
            + 2 * hpc * qt * (nkp + 8) + 4 * qt * (hpc * dh + 8))


def _phased_staged_bytes(nk, dh, group):
    """csrc/attention_phased.cu:staged_smem_bytes: the float scores of 8
    queries × ``group`` heads, their sums, their bf16 P rows (+ 8), the
    queries and one head's K or V."""
    nkp = -(-nk // 16) * 16
    return (4 * (group * 8 * (nkp + 4) + group * 8) + 2 * group * 8 * (nkp + 8)
            + 2 * 8 * (group * dh + 8) + 2 * nkp * (dh + 8))


def phased_plan(nk, dh, heads, group, batch=1, sms=0, nq=None):
    """How csrc/attention_phased.cu tiles one call: a :class:`PhasedPlan`.

    The resident branch splits a group of ``group`` heads over a cluster of
    ``group / heads_per_cta`` CTAs (at most 8), each keeping its heads' K
    and V in shared memory and walking query tiles of ``qtile`` (16, or 8
    where 16 does not fit); heads_per_cta is the smallest divisor of the
    group from 2 up that fits (1 only where 2 does not divide or fit). When
    ``batch`` · heads / heads_per_cta CTAs leave some of the card's ``sms``
    SMs idle, the query tiles are split over ``qsplit`` = 2 clusters. Where
    no resident layout fits a block's shared memory, the staging branch
    holds the group's scores for 8 queries and stages each head's K and V
    (heads_per_cta = group, one CTA). A shape that fits neither raises
    ValueError."""
    if dh % 16 or not 16 <= dh <= 128:
        raise ValueError(f"head dim {dh} unsupported: need a multiple of 16 "
                         f"up to 128")
    if group <= 0 or heads % group:
        raise ValueError(f"group {group} does not divide {heads} heads")
    if not 0 < nk <= PHASED_MAX_KEYS:
        raise ValueError(f"{nk} keys: the phased kernel holds 1 to "
                         f"{PHASED_MAX_KEYS}")
    divs = [h for h in range(1, group + 1)
            if group % h == 0 and group // h <= PHASED_MAX_CLUSTER]
    for hpc in [h for h in divs if h >= 2] + [h for h in divs if h < 2]:
        for qt in (16, 8):
            smem = _phased_resident_bytes(nk, dh, hpc, qt)
            if smem <= SMEM_PER_BLOCK:
                tiles = -(-(nk if nq is None else nq) // qt)
                split = 2 if batch * heads // hpc < sms and tiles > 1 else 1
                return PhasedPlan(hpc, group // hpc, qt, smem, "resident",
                                  split)
    smem = _phased_staged_bytes(nk, dh, group)
    if smem <= SMEM_PER_BLOCK:
        return PhasedPlan(group, 1, 8, smem, "staging", 1)
    raise ValueError(
        f"{group} heads of {nk} keys at head dim {dh} fit neither branch of "
        f"the phased kernel: one head's K and V exceed a CTA's "
        f"{SMEM_PER_BLOCK} bytes of shared memory and the group's scores "
        f"need {smem}: take a smaller group")


def _phased_args(num_heads, group, ln, smax):
    if group <= 0 or num_heads % group:
        raise ValueError(f"group {group} does not divide {num_heads} heads")
    if ln not in LN_MODES:
        raise ValueError(f"LN mode {ln!r} not in {LN_MODES}")
    if smax not in SMAX_MODES:
        raise ValueError(f"softmax mode {smax!r} not in {SMAX_MODES}")


def attn_half_block_phased_ref(x, ln_w, ln_b, wqkv, bqkv, wproj, bproj,
                               num_heads, group, ln="two_pass", smax="exp"):
    """Plain version of :func:`attn_half_block_phased`: x + proj(core(qkv)),
    qkv = T(LN_mode(x)·Wqkvᵀ + b), rounded where the scripts round."""
    _phased_args(num_heads, group, ln, smax)
    qkv = linear(ln_mode_ref(x, ln_w, ln_b, ln), wqkv, bqkv)
    return x + linear(phased_attention_ref(qkv, num_heads, smax), wproj,
                      bproj)


def attn_half_block_phased(x, ln_w, ln_b, wqkv, bqkv, wproj, bproj,
                           num_heads, group, ln="two_pass", smax="exp"):
    """B1 with its attention in three phases over groups of ``group`` heads:
    x (B, N, D) -> (B, N, D). Replaces scripts/bench_attn_half.py:_v2_kernel
    (S2, all heads in one phase each), scripts/bench_vpu.py:_attn_kernel_v
    and _attn_kernel_pipe2 (S5: ``ln`` "two_pass" | "onepass" | "skip",
    ``smax`` "exp" | "exp2" | "nomax" | "skip") and scripts/bench_overlap.py:
    _attn_half_grouped (S6, groups of 2, 4 or 8). On the card: the LN kernel
    in its mode (none for "skip", where the qkv GEMM takes x), the qkv GEMM
    with bias, csrc/attention_phased.cu on the packed qkv (a cluster of CTAs
    per group and batch element, each holding its heads' K and V and walking
    the query tiles; :func:`phased_plan`), the proj GEMM with bias and
    residual. bf16 only on the card; a shape the plan cannot tile raises
    ValueError on the CPU too. Forward only."""
    _phased_args(num_heads, group, ln, smax)
    phased_plan(x.shape[1], x.shape[2] // num_heads, num_heads, group)
    if not runtime.use_kernel(x):
        return attn_half_block_phased_ref(x, ln_w, ln_b, wqkv, bqkv, wproj,
                                          bproj, num_heads, group, ln, smax)
    _forward_only("attn_half_block_phased", x, ln_w, ln_b, wqkv, bqkv, wproj,
                  bproj)
    b, n, d = x.shape
    runtime.check("x", x, x)
    x2 = x.view(b * n, d)
    qkv = runtime.gemm(ln_mode(x2, ln_w, ln_b, ln), wqkv.to(x.dtype),
                       bqkv).view(b, n, 3 * d)
    attn = x.new_empty(b, n, d)
    dh = d // num_heads
    runtime.attention_phased(qkv, qkv[:, :, d:], qkv[:, :, 2 * d:], attn,
                             heads=num_heads, dh=dh, group=group,
                             scale=dh ** -0.5, smax=smax)
    out = runtime.gemm(attn.view(b * n, d), wproj.to(x.dtype), bproj,
                       residual=x2)
    runtime.count(attn_half_block_phased)
    return out.view(b, n, d)


attn_half_block_phased.launches = 0
