"""The whole pre-LN transformer block in one launch (B10).

``fused_block`` computes h = x + proj(softmax(q kᵀ·dh^-½) v) with q|k|v =
LN1(x)·Wqkvᵀ + bqkv, then out = h + fc2(GELU(fc1(LN2(h)))), and replaces
``mirage_tpu/ops/fused_block.py:_block_fwd`` / ``_block_kernel``, which
runs both halves of a block as one Pallas kernel. ``nn/block.py`` routes a
deterministic block there under ``MIRAGE_BLOCK_FUSE=decoder`` (width ≤ 256)
or ``all``, as ``mirage_tpu/nn/block.py:93-101`` does.

On the card it is one launch of ``csrc/fused_block.cu``: a persistent,
cooperative grid of as many CTAs as the card holds at once (the occupancy
times the SM count, never the batch: ``fused_block_plan``), which walk
each stage's work items over the whole batch (LN rows, 128-row GEMM tiles
of all B·N rows on wgmma with TMA loads, (batch element, head) attention
items) and meet at a grid-wide barrier between the seven stages; the
intermediates go through a scratch the launcher allocates
(``runtime.fused_block``). The point of B10 is call fusion: the two halves'
chains (B1 + B2) take seven launches per block. The bf16 GEMM tile's width
(``tile_n``, 128 or 256) is the plan's knob: 256 where the qkv stage's
256-wide tiles fill the grid, else 128, the faster of the two in
``chip_smoke.py``'s sweep at batch 64 (encoder and decoder) and at batch 1.
Bound: operations (2·N·D·12D + 4·N²·D per batch element). The qkv bias is
zero when absent, as in the JAX package (:169-171).

Its gradient is autograd through the plain version, as the JAX custom VJP's
backward is ``jax.vjp`` of ``_block_xla`` (:155-157); the TPU kernel has no
backward kernel, and training routes keep the halves.
"""

import torch

from mirage_tpu_torch.ops import runtime
from mirage_tpu_torch.ops.block_attention import (_needs_grad,
                                                  attn_half_block_ref)
from mirage_tpu_torch.ops.fused_mlp import mlp_block_ref

MAX_TOKENS = 512
# the kernel's stages in order, the rows of a GEMM tile by working type and
# the warps of a CTA
STAGES = ("ln1", "qkv", "attention", "proj", "ln2", "fc1", "fc2")
TILE_M = {"bf16": 128, "float32": 64}
WARPS = 8
# the bytes of shared memory the bf16 attention stage may take: the GEMM
# ring (4 × (128 + 256) × 64 bf16) and the eight warps' epilogue scratch
ATTENTION_SMEM = 4 * (128 + 256) * 64 * 2 + WARPS * (256 * 4 + 16 * 72 * 2)


def attention_buffers(n, dh):
    """How many heads' K and V the bf16 attention stage keeps resident
    (csrc/fused_block.cu:attention_resident_bytes): 2 where two fit beside
    a 16-query tile per warp, 1 where one does, else 0 (streamed in key
    chunks)."""
    kc = 64 if dh <= 64 else 32
    tiles = 2 * WARPS * 16 * (dh + 8)
    kv = 4 * (-(-n // kc) * kc) * (dh + 8)
    return next((b for b in (2, 1) if tiles + b * kv <= ATTENTION_SMEM), 0)


def fused_block_ref(x, ln1_w, ln1_b, wqkv, bqkv, wproj, bproj, ln2_w, ln2_b,
                    w1, b1, w2, b2, num_heads):
    """Plain PyTorch version: the two halves' plain versions, as
    ``_block_xla`` composes ``_attn_half_xla`` and ``_mlp_block_xla``."""
    h = attn_half_block_ref(x, ln1_w, ln1_b, wqkv, bqkv, wproj, bproj,
                            num_heads)
    return mlp_block_ref(h, ln2_w, ln2_b, w1, b1, w2, b2)


def fused_block_plan(batch, n, d, hidden, heads, sms, blocks_per_sm,
                     tile_n=None, dtype="bf16"):
    """How one launch of csrc/fused_block.cu covers its work: the grid
    (``blocks_per_sm`` · ``sms`` CTAs, all resident at once) and each
    stage's items, which CTA c walks as c, c + grid, ... : LN rows (a warp
    a row, so CTA c's warps take rows c·8 + w, + 8·grid, ...), GEMM tiles of
    ``tile_m`` × ``tile_n`` over all B·N rows (row-major), and (batch
    element, head) attention items, each in tiles of ``query_pass``
    queries: 16 (a warp's) where ``attention_buffers`` heads' K and V stay
    resident, else passes of 128 (bf16) or 64 (float32) over streamed
    keys. ``dtype`` "bf16" (wgmma tiles 128 × tile_n; tile_n None: 256
    where the qkv stage's 256-wide tiles fill the grid, else 128) or
    "float32" (FMA tiles 64 × 64)."""
    if tile_n not in (None, 128, 256):
        raise ValueError(f"tile_n {tile_n}: the kernel takes 128 or 256")
    if dtype not in TILE_M:
        raise ValueError(f"dtype {dtype!r} not in {sorted(TILE_M)}")
    if sms <= 0 or blocks_per_sm <= 0:
        raise ValueError(f"{blocks_per_sm} blocks per SM on {sms} SMs: the "
                         f"kernel does not fit the card")
    m = batch * n
    tm = TILE_M[dtype]
    row_tiles = -(-m // tm)
    if dtype != "bf16":
        tn = 64
    elif tile_n is None:
        wide = row_tiles * -(-3 * d // 256)  # the qkv stage's 256-wide tiles
        tn = 256 if wide >= sms * blocks_per_sm else 128
    else:
        tn = tile_n

    def tiles(cols):
        return row_tiles * -(-cols // tn)

    buffers = attention_buffers(n, d // heads) if dtype == "bf16" else 0
    return {"grid": sms * blocks_per_sm, "rows": m, "tile_m": tm,
            "tile_n": tn, "attention_buffers": buffers,
            "query_pass": 16 if buffers else 128 if dtype == "bf16" else 64,
            "n": n, "heads": heads,
            "cols": {"qkv": 3 * d, "proj": d, "fc1": hidden, "fc2": d},
            "items": {"ln1": m, "qkv": tiles(3 * d),
                      "attention": batch * heads, "proj": tiles(d),
                      "ln2": m, "fc1": tiles(hidden), "fc2": tiles(d)}}


def fused_block_items(plan, stage, cta):
    """What CTA ``cta`` computes in ``stage`` under ``plan``, in the
    kernel's order: LN rows as (row,), GEMM tiles as (row0, row1, col0,
    col1) clipped to the matrix, attention passes as (batch element, head,
    query0, query1)."""
    grid, items = plan["grid"], plan["items"][stage]
    if stage in ("ln1", "ln2"):
        return [(r,) for w in range(WARPS)
                for r in range(cta * WARPS + w, items, grid * WARPS)]
    out = []
    if stage == "attention":
        n, qp = plan["n"], plan["query_pass"]
        for item in range(cta, items, grid):
            b, h = divmod(item, plan["heads"])
            out += [(b, h, q0, min(q0 + qp, n)) for q0 in range(0, n, qp)]
        return out
    cols, tm, tn = plan["cols"][stage], plan["tile_m"], plan["tile_n"]
    tiles_n = -(-cols // tn)
    for t in range(cta, items, grid):
        r0, c0 = t // tiles_n * tm, t % tiles_n * tn
        out.append((r0, min(r0 + tm, plan["rows"]), c0, min(c0 + tn, cols)))
    return out


def fused_block_launch(x, ln1_w, ln1_b, wqkv, bqkv, wproj, bproj, ln2_w,
                       ln2_b, w1, b1, w2, b2, num_heads, tile_n=None,
                       stamps=None):
    """One launch of the kernel on CUDA operands as ``runtime.fused_block``
    takes them, its grid and GEMM tile width (``tile_n`` None: the plan's
    choice) from :func:`fused_block_plan` at the card's SM count and the
    kernel's occupancy (no launch count: the op counts). ``stamps``: None,
    or an int64 tensor of 7 + grid for the stage timestamps
    (:func:`stage_us`)."""
    b, n, d = x.shape
    dtype = "bf16" if x.dtype == torch.bfloat16 else "float32"
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    blocks = runtime.fused_block_blocks_per_sm(n, d // num_heads, x.dtype,
                                               x.device)
    plan = fused_block_plan(b, n, d, w1.shape[0], num_heads, sms, blocks,
                            tile_n, dtype)
    return runtime.fused_block(
        x, ln1_w, ln1_b, wqkv, bqkv, wproj, bproj, ln2_w, ln2_b, w1, b1, w2,
        b2, heads=num_heads, grid=plan["grid"],
        tile_n=plan["tile_n"] if dtype == "bf16" else 256,  # float: unused
        attn_buffers=plan["attention_buffers"],
        scale=(d // num_heads) ** -0.5, stamps=stamps)


def stage_us(stamps):
    """Microseconds of each stage of one launch from its ``stamps``
    (:func:`fused_block_launch`): from the start (or the last barrier) to
    the next barrier's completion, the last stage to the latest CTA's end."""
    t = stamps.tolist()
    marks = t[:7] + [max(t[7:])]
    return {name: (marks[i + 1] - marks[i]) / 1e3
            for i, name in enumerate(STAGES)}


def _check_shape(x, num_heads):
    n, d = x.shape[1], x.shape[2]
    if n > MAX_TOKENS:
        raise ValueError(f"fused_block: {n} tokens; the kernel holds at most "
                         f"{MAX_TOKENS} (the route never sends more)")
    dh = d // num_heads
    if d % num_heads or dh % 16 or not 16 <= dh <= 128:
        raise ValueError(f"fused_block: head dim {d}/{num_heads} unsupported: "
                         f"need a multiple of 16 from 16 to 128")


def _fused_block_fwd(x, ln1_w, ln1_b, wqkv, bqkv, wproj, bproj, ln2_w, ln2_b,
                     w1, b1, w2, b2, num_heads):
    _check_shape(x, num_heads)
    if not runtime.use_kernel(x):
        return fused_block_ref(x, ln1_w, ln1_b, wqkv, bqkv, wproj, bproj,
                               ln2_w, ln2_b, w1, b1, w2, b2, num_heads)
    pdt = ln1_w.dtype
    vecs = [v if v is None or v.dtype == pdt else v.to(pdt)
            for v in (ln1_b, bqkv, bproj, ln2_w, ln2_b, b1, b2)]
    wts = [w.to(x.dtype).contiguous() for w in (wqkv, wproj, w1, w2)]
    out = fused_block_launch(x.contiguous(), ln1_w, vecs[0], wts[0],
                             vecs[1], wts[1], vecs[2], vecs[3], vecs[4],
                             wts[2], vecs[5], wts[3], vecs[6], num_heads)
    runtime.count(fused_block)
    return out


class _FusedBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, *args):
        ctx.save_for_backward(*[a for a in args[:-1] if a is not None], x)
        ctx.has_bqkv = args[3] is not None
        ctx.num_heads = args[-1]
        return _fused_block_fwd(x, *args)

    @staticmethod
    def backward(ctx, dy):
        *params, x = ctx.saved_tensors
        if not ctx.has_bqkv:
            params.insert(3, None)
        inputs = [t if t is None else t.detach().requires_grad_(need)
                  for t, need in zip([x, *params], ctx.needs_input_grad)]
        with torch.enable_grad():
            out = fused_block_ref(*inputs, ctx.num_heads)
            wrt = [t for t in inputs if t is not None and t.requires_grad]
            grads = iter(torch.autograd.grad(out, wrt, dy))
        return tuple(next(grads) if t is not None and t.requires_grad
                     else None for t in inputs) + (None,)


def fused_block(x, ln1_w, ln1_b, wqkv, bqkv, wproj, bproj, ln2_w, ln2_b, w1,
                b1, w2, b2, num_heads):
    """x: (B, N, D), N ≤ 512, head dim 16..128 in steps of 16; the weights
    in torch Linear layout (wqkv (3D, D), wproj (D, D), w1 (H, D), w2 (D,
    H)), cast to x's dtype; bqkv may be None. Differentiable through the
    plain version."""
    args = (ln1_w, ln1_b, wqkv, bqkv, wproj, bproj, ln2_w, ln2_b, w1, b1, w2,
            b2)
    if _needs_grad(x, *args):
        return _FusedBlock.apply(x, *args, num_heads)
    return _fused_block_fwd(x, *args, num_heads)


fused_block.launches = 0
