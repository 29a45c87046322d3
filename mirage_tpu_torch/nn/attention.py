"""Self- and cross-attention parameter holders and their plain versions.

``Attention`` (fused ``qkv`` + ``proj``) and ``CrossAttention`` (``q``,
fused ``kv``, ``proj``) carry the reference's state-dict keys. ``sdpa``,
``packed_attention`` and ``cross_attention`` are the plain PyTorch path the
ops' reference versions are built from. ``attention_apply`` and
``cross_attention_apply`` pick the attention core as the JAX package does
(mirage_tpu/nn/attention.py:56-69, :99-162): the packed ``block_attention``
(B6) up to 512 tokens, ``flash_attention`` (B8) at 512 keys or more, and
the plain path otherwise. Counterpart of ``mirage_tpu/nn/attention.py``.
"""

import torch
from torch import nn

from mirage_tpu_torch.nn.layers import Linear, acc_dtype, linear


class Attention(nn.Module):
    def __init__(self, dim, qkv_bias=False):
        super().__init__()
        self.qkv = Linear(dim, dim * 3, bias=qkv_bias, n_fused=3)
        self.proj = Linear(dim, dim)


class CrossAttention(nn.Module):
    def __init__(self, dim, qkv_bias=False):
        super().__init__()
        self.q = Linear(dim, dim, bias=qkv_bias)
        self.kv = Linear(dim, dim * 2, bias=qkv_bias, n_fused=2)
        self.proj = Linear(dim, dim)


def sdpa(q, k, v, scale):
    """softmax(q kᵀ·scale) v over (B, H, N, dh); float scores, probabilities
    cast to v's dtype before the product."""
    acc = acc_dtype(q)
    s = torch.einsum("bhnd,bhmd->bhnm", q.to(acc), k.to(acc)) * scale
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhnm,bhmd->bhnd", p.to(v.dtype), v)


def split_heads(x, num_heads):
    b, n, c = x.shape
    return x.reshape(b, n, num_heads, c // num_heads).transpose(1, 2)


def merge_heads(x):
    b, h, n, d = x.shape
    return x.transpose(1, 2).reshape(b, n, h * d)


def packed_attention(qkv, num_heads, scale=None):
    """Multi-head self-attention over the packed (B, N, 3D) qkv projection
    (column order q|k|v × heads × dh) -> (B, N, D)."""
    b, n, three_d = qkv.shape
    dh = three_d // 3 // num_heads
    q, k, v = qkv.reshape(b, n, 3, num_heads, dh).permute(2, 0, 3, 1, 4)
    return merge_heads(sdpa(q, k, v, dh ** -0.5 if scale is None else scale))


def cross_attention(q_w, q_b, kv_w, kv_b, proj_w, proj_b, x, context,
                    num_heads):
    """proj(SDPA(q(x), kv(context))) — queries from x, keys and values from
    the fused kv projection of context."""
    b, m, c = context.shape
    dh = c // num_heads
    q = split_heads(linear(x, q_w, q_b), num_heads)
    k, v = linear(context, kv_w, kv_b).reshape(
        b, m, 2, num_heads, dh).permute(2, 0, 3, 1, 4)
    return linear(merge_heads(sdpa(q, k, v, dh ** -0.5)), proj_w, proj_b)


# the packed block_attention kernel (B6) holds up to this many tokens
# (mirage_tpu/nn/attention.py:_use_block_kernel)
BLOCK_ATTN_TOKENS = 512


def attention_apply(attn: Attention, x, num_heads):
    """Self-attention when the block does not fuse its attention half: the
    qkv projection, the attention core on the packed qkv (``block_attention``,
    B6, up to 512 tokens; ``flash_attention``, B8, above, where there are
    512 keys or more), the output projection (mirage_tpu/nn/attention.py:
    attention_apply)."""
    from mirage_tpu_torch.ops import block_attention as ba
    from mirage_tpu_torch.ops.flash_attention import flash_attention

    qkv = linear(x, attn.qkv.weight, attn.qkv.bias)
    scale = (x.shape[-1] // num_heads) ** -0.5
    if x.shape[1] <= BLOCK_ATTN_TOKENS:
        out = ba.block_attention(qkv, num_heads, scale)
    else:
        out = flash_attention(qkv, num_heads=num_heads, scale=scale)
    return linear(out, attn.proj.weight, attn.proj.bias)


def cross_attention_apply(cross: CrossAttention, x, context, num_heads):
    """Cross-attention through sdpa (mirage_tpu/nn/attention.py:
    cross_attention_apply): ``flash_attention`` (B8) at 512 context tokens
    or more, the plain path below."""
    from mirage_tpu_torch.ops.flash_attention import (FLASH_MIN_KEYS,
                                                      flash_attention)

    if context.shape[1] < FLASH_MIN_KEYS:
        return cross_attention(cross.q.weight, cross.q.bias, cross.kv.weight,
                               cross.kv.bias, cross.proj.weight,
                               cross.proj.bias, x, context, num_heads)
    scale = (x.shape[-1] // num_heads) ** -0.5
    out = flash_attention(linear(x, cross.q.weight, cross.q.bias),
                          linear(context, cross.kv.weight, cross.kv.bias),
                          num_heads=num_heads, scale=scale)
    return linear(out, cross.proj.weight, cross.proj.bias)
