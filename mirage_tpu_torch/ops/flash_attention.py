"""Flash attention at 512 keys or more (B8).

``flash_attention`` (softmax(q kᵀ·scale) v over every head) replaces
``mirage_tpu/ops/flash_attention.py:_flash_fwd`` / ``_attn_kernel`` and, as
its backward, ``_flash_bwd`` / ``_attn_bwd_kernel``: the attention core the
JAX package runs through ``sdpa`` at 512 keys or more (the encoder at 1025
tokens in segmentation tuning; the decoders' cross-attention over the 769
context tokens of a three-modality request). It takes the packed (B, N, 3D)
qkv of a self-attention, or the (B, Nq, D) queries and the packed
(B, Nk, 2D) kv of a cross-attention, and reads q, k and v as column
windows of those, so nothing is transposed through device memory; its
backward writes the gradient of the packed tensors in the same layout.

On the card both directions are csrc/flash_attention.cu (FlashAttention-2:
keys streamed through shared memory with an online softmax, the per-row
log-sum-exp kept for the backward; the bf16 forward on wgmma, shared with
csrc/attention.cu as csrc/attention_fwd.cuh; the backward on mma.sync, a
dQ kernel and a dK/dV kernel with no atomics). Bound: operations (4·B·H·Nq·Nk·dh FLOPs
forward, 10 backward, against reading q, k, v once). On a CPU tensor the
plain versions below run; they follow the TPU kernels step by step: the
forward rounds the unnormalised exp(s − m) to the working type before P·V
and divides by the float row sum after it (flash_attention.py:52-58); the
backward recomputes P normalised in float, takes delta = rowsum(P∘dP),
rounds dS and P where the kernel does, and returns dq, dk and dv in the
working type.
"""

import torch

from mirage_tpu_torch.nn.layers import acc_dtype
from mirage_tpu_torch.ops import runtime
from mirage_tpu_torch.ops.block_attention import _heads, _needs_grad

# sdpa takes the flash kernel at this many keys or more
# (mirage_tpu/nn/attention.py:56-69)
FLASH_MIN_KEYS = 512


def flash_attention_ref(q, k, v, scale):
    """Plain version over (B, H, N, dh) tensors (mirage_tpu/ops/
    flash_attention.py:_attn_kernel): float scores, the row max over all
    keys, p = exp(s − m), o = T(p)·v / Σp."""
    acc = acc_dtype(q)
    s = torch.einsum("bhnd,bhmd->bhnm", q.to(acc), k.to(acc)) * scale
    p = torch.exp(s - s.amax(-1, keepdim=True))
    o = torch.einsum("bhnm,bhmd->bhnd", p.to(v.dtype).to(acc), v.to(acc))
    return (o / p.sum(-1, keepdim=True)).to(q.dtype)


def flash_attention_bwd_ref(q, k, v, do, scale):
    """Plain backward over (B, H, N, dh) tensors, step by step as
    _attn_bwd_kernel: P normalised in float, dP = dO·Vᵀ, delta = rowsum(P∘dP),
    dS = P∘(dP − delta)·scale; dq = T(dS)·K, dk = T(dS)ᵀ·Q, dv = T(P)ᵀ·dO, each
    summed in float and rounded once to the working type."""
    dt, acc = q.dtype, acc_dtype(q)
    q32, k32, v32, do32 = (t.to(acc) for t in (q, k, v, do))
    p = torch.softmax(q32 @ k32.transpose(-1, -2) * scale, dim=-1)
    dp = do32 @ v32.transpose(-1, -2)
    ds = (p * (dp - (p * dp).sum(-1, keepdim=True)) * scale).to(dt).to(acc)
    dq = ds @ k32
    dk = ds.transpose(-1, -2) @ q32
    dv = p.to(dt).to(acc).transpose(-1, -2) @ do32
    return dq.to(dt), dk.to(dt), dv.to(dt)


def _windows(q_src, kv_src):
    """(q, k, v) column windows and the model width of the packed qkv
    (kv_src None) or of the queries and the packed kv."""
    if kv_src is None:
        d = q_src.shape[-1] // 3
        return q_src[..., :d], q_src[..., d:2 * d], q_src[..., 2 * d:], d
    d = q_src.shape[-1]
    return q_src, kv_src[..., :d], kv_src[..., d:], d


def _merge(t):
    b, h, n, dh = t.shape
    return t.transpose(1, 2).reshape(b, n, h * dh)


def _flash_fwd(q_src, kv_src, num_heads, scale):
    """(out (B, Nq, D), lse or None)."""
    q, k, v, d = _windows(q_src, kv_src)
    if not runtime.use_kernel(q_src):
        split = (lambda t: _heads(t, num_heads, 1)[0])  # noqa: E731
        return _merge(flash_attention_ref(split(q), split(k), split(v),
                                          scale)), None
    out = q_src.new_empty(q.shape[0], q.shape[1], d)
    lse = runtime.flash_attention(q, k, v, out, heads=num_heads,
                                  dh=d // num_heads, scale=scale)
    return out, lse


def _flash_bwd(q_src, kv_src, lse, dout, num_heads, scale):
    """Gradients of the packed inputs: (dq_src, dkv_src or None)."""
    q, k, v, d = _windows(q_src, kv_src)
    if not runtime.use_kernel(q_src):
        split = (lambda t: _heads(t, num_heads, 1)[0])  # noqa: E731
        dq, dk, dv = (_merge(g) for g in flash_attention_bwd_ref(
            split(q), split(k), split(v), split(dout), scale))
        if kv_src is None:
            return torch.cat([dq, dk, dv], -1), None
        return dq, torch.cat([dk, dv], -1)
    d_q = torch.empty_like(q_src)
    d_kv = None if kv_src is None else torch.empty_like(kv_src)
    dq, dk, dv, _ = _windows(d_q, d_kv)
    runtime.flash_attention_bwd(q, k, v, dout.contiguous(), lse, dq, dk, dv,
                                heads=num_heads, dh=d // num_heads,
                                scale=scale)
    return d_q, d_kv


class _Flash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q_src, kv_src, num_heads, scale):
        out, lse = _flash_fwd(q_src, kv_src, num_heads, scale)
        ctx.save_for_backward(q_src, kv_src, lse)
        ctx.num_heads, ctx.scale = num_heads, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q_src, kv_src, lse = ctx.saved_tensors
        return (*_flash_bwd(q_src, kv_src, lse, dout, ctx.num_heads,
                            ctx.scale), None, None)


def flash_attention(q, kv=None, *, num_heads, scale):
    """Multi-head attention of any length -> (B, Nq, D). With ``kv`` None,
    q is the packed (B, N, 3D) qkv (column order q|k|v × heads × dh);
    otherwise q is (B, Nq, D) and kv the packed (B, Nk, 2D) keys and values.
    Differentiable (the kernel backward on the card)."""
    if _needs_grad(q, kv):
        return _Flash.apply(q, kv, num_heads, scale)
    return _flash_fwd(q, kv, num_heads, scale)[0]
