"""The whole pre-LN transformer block in one launch (B10).

``fused_block`` computes h = x + proj(softmax(q kᵀ·dh^-½) v) with q|k|v =
LN1(x)·Wqkvᵀ + bqkv, then out = h + fc2(GELU(fc1(LN2(h)))), and replaces
``mirage_tpu/ops/fused_block.py:_block_fwd`` / ``_block_kernel``, which
runs both halves of a block as one Pallas kernel. ``nn/block.py`` routes a
deterministic block there under ``MIRAGE_BLOCK_FUSE=decoder`` (width ≤ 256)
or ``all``, as ``mirage_tpu/nn/block.py:93-101`` does.

On the card it is one launch of ``csrc/fused_block.cu``: a thread-block
cluster per batch element whose CTAs split the heads and the projections'
columns and meet at cluster barriers, the intermediates in a scratch the
launcher allocates (``runtime.fused_block``); the cluster is as large as
one wave of CTAs allows (``cluster_size``: 2 at batch 64, 8 at batch 1 on
an H100's 132 SMs). The point of B10 is call fusion: the two halves'
chains (B1 + B2) take seven launches per block.
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
MAX_CLUSTER = 8


def fused_block_ref(x, ln1_w, ln1_b, wqkv, bqkv, wproj, bproj, ln2_w, ln2_b,
                    w1, b1, w2, b2, num_heads):
    """Plain PyTorch version: the two halves' plain versions, as
    ``_block_xla`` composes ``_attn_half_xla`` and ``_mlp_block_xla``."""
    h = attn_half_block_ref(x, ln1_w, ln1_b, wqkv, bqkv, wproj, bproj,
                            num_heads)
    return mlp_block_ref(h, ln2_w, ln2_b, w1, b1, w2, b2)


def cluster_size(heads: int, hidden: int, batch: int, sms: int) -> int:
    """CTAs per batch element: the largest divisor c of the head count, at
    most 8, that splits the hidden width into multiples of 16 and keeps
    batch · c CTAs within one wave of the card's ``sms`` SMs (one CTA runs
    per SM); 1 when even that is more than a wave. A cluster's stages run
    one after another, so more CTAs than SMs only queue, while fewer
    leave SMs idle."""
    fits = [c for c in range(1, min(MAX_CLUSTER, heads) + 1)
            if heads % c == 0 and hidden % c == 0 and (hidden // c) % 16 == 0
            and batch * c <= sms]
    return max(fits, default=1)


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
    b, d = x.shape[0], x.shape[-1]
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    out = runtime.fused_block(
        x.contiguous(), ln1_w, vecs[0], wts[0], vecs[1], wts[1], vecs[2],
        vecs[3], vecs[4], wts[2], vecs[5], wts[3], vecs[6], heads=num_heads,
        cluster=cluster_size(num_heads, w1.shape[0], b, sms),
        scale=(d // num_heads) ** -0.5)
    fused_block.launches += 1
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
