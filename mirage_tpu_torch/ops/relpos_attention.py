"""Attention with SAM's decomposed relative-position bias, over windows or
over the whole grid: the attention core of the SAM ViT image encoder
(``models/sam.py``).

``relpos_attention(qkv, qkv_bias, rel_pos_h, rel_pos_w, num_heads,
window)`` takes the packed qkv projection of the real tokens laid out on
their grid, (B, H, W, 3D) with column order q|k|v × heads × dh, and returns
(B, H, W, D): for each window of ``window`` × ``window`` positions (the
grid padded at the bottom and right to a multiple of it; ``window`` 0: the
whole grid as one window) and each head,

    softmax((q·dh^-½)·kᵀ + rel_h[..., :, None] + rel_w[..., None, :])·v,
    rel_h[i, kh] = q_i · rel_pos_h[y_i − kh + k_h − 1],
    rel_w[i, kw] = q_i · rel_pos_w[x_i − kw + k_w − 1],

with q unscaled in the bias (SAM's ``add_decomposed_rel_pos``). A padded
position's LayerNorm output is zero in SAM, so its query, key and value
are ``qkv_bias``: the padded keys and values take part in every edge
window's softmax, and the padded queries' outputs are dropped. Only the
real tokens' qkv is computed and handed in; the padded rows are made from
the bias here, never projected.

On a CUDA bf16 tensor with no gradient asked for, the op is
csrc/relpos_attention.cu: ``relpos_attn_bias_kernel`` (the products
q·Rh, q·Rw and q·b_k of every real query, in float) and
``relpos_attn_fwd_kernel`` (the attention forward of csrc/attention_fwd.cuh
with the bias added to each logits tile: window addressing by 4-D tensor
maps, so nothing is partitioned in device memory, the padded keys' scores
q·b_k and their value b_v put in for the zeros the maps read past the
grid). The kernel runs the forward whether or not a gradient is asked
for; where one is (the encoder trained, or its input adapter trained
through it), the backward recomputes the plain version
:func:`relpos_attention_ref` from the saved inputs and differentiates it:
no kernel computes that backward. On the CPU the plain version runs and
autograd takes its backward. Each call tallies its forward's route to the
open span (``utils/profiling.py``): ``relpos_attn_kernel`` or
``relpos_attn_plain``.
"""

import torch

from mirage_tpu_torch.nn.layers import acc_dtype
from mirage_tpu_torch.ops import runtime
from mirage_tpu_torch.utils import profiling


def rel_pos_table(size, rel_pos):
    """(size, size, C): row i, column j is rel_pos[i − j + size − 1]."""
    if rel_pos.shape[0] != 2 * size - 1:
        raise ValueError(f"a relative-position table of {rel_pos.shape[0]} "
                         f"rows for {size} positions: expected {2 * size - 1}")
    idx = torch.arange(size)
    return rel_pos[(idx[:, None] - idx[None, :] + size - 1).to(rel_pos.device)]


def _windows(t, ws):
    """(B, Hp, Wp, C) -> (B·nW, ws·ws, C), windows in row-major order."""
    b, hp, wp, c = t.shape
    t = t.reshape(b, hp // ws, ws, wp // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return t.reshape(-1, ws * ws, c)


def _unwindows(t, b, hp, wp, ws):
    c = t.shape[-1]
    t = t.reshape(b, hp // ws, wp // ws, ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return t.reshape(b, hp, wp, c)


def relpos_attention_ref(qkv, qkv_bias, rel_pos_h, rel_pos_w, num_heads,
                         window):
    """The plain version: the padded rows made from ``qkv_bias``, the
    windows partitioned, the bias materialised, the softmax in float, the
    output unpartitioned and cropped, in qkv's dtype. Differentiable."""
    b, h, w, three_d = qkv.shape
    d = three_d // 3
    dh = d // num_heads
    acc = acc_dtype(qkv)
    if window:
        hp, wp = -(-h // window) * window, -(-w // window) * window
        grid = qkv_bias.to(qkv.dtype).expand(b, hp, wp, three_d)
        grid = torch.cat([torch.cat([qkv, grid[:, :h, w:]], 2),
                          grid[:, h:]], 1)
        x, wh, ww = _windows(grid, window), window, window
    else:
        x, wh, ww = qkv.reshape(b, h * w, three_d), h, w
    n = wh * ww
    q, k, v = x.reshape(-1, n, 3, num_heads, dh).to(acc).permute(
        2, 0, 3, 1, 4)
    tab_h = rel_pos_table(wh, rel_pos_h.to(qkv.dtype).to(acc))
    tab_w = rel_pos_table(ww, rel_pos_w.to(qkv.dtype).to(acc))
    rq = q.reshape(*q.shape[:2], wh, ww, dh)
    rel_h = torch.einsum("bnyxc,ykc->bnyxk", rq, tab_h)
    rel_w = torch.einsum("bnyxc,xkc->bnyxk", rq, tab_w)
    logits = (q * dh ** -0.5) @ k.transpose(-1, -2)
    logits = (logits.reshape(*q.shape[:2], wh, ww, wh, ww)
              + rel_h[..., :, None] + rel_w[..., None, :])
    p = torch.softmax(logits.reshape(*q.shape[:2], n, n), dim=-1)
    out = (p @ v).transpose(1, 2).reshape(-1, n, d)
    if window:
        out = _unwindows(out, b, hp, wp, window)[:, :h, :w]
    return out.reshape(b, h, w, d).to(qkv.dtype)


def _kernel(qkv, qkv_bias, rel_pos_h, rel_pos_w, num_heads, window):
    dt = qkv.dtype
    return runtime.relpos_attention(
        qkv.contiguous(), qkv_bias.to(dt).contiguous(),
        rel_pos_h.to(dt).contiguous(), rel_pos_w.to(dt).contiguous(),
        heads=num_heads, window=window)


class _KernelForward(torch.autograd.Function):
    """The kernel's forward; the backward differentiates the plain version
    recomputed from the saved inputs."""

    @staticmethod
    def forward(ctx, qkv, qkv_bias, rel_pos_h, rel_pos_w, num_heads, window):
        ctx.save_for_backward(qkv, qkv_bias, rel_pos_h, rel_pos_w)
        ctx.layout = (num_heads, window)
        return _kernel(qkv, qkv_bias, rel_pos_h, rel_pos_w, num_heads, window)

    @staticmethod
    def backward(ctx, grad):
        wanted = ctx.needs_input_grad[:4]
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(w)
                      for t, w in zip(ctx.saved_tensors, wanted)]
            out = relpos_attention_ref(*leaves, *ctx.layout)
            # the qkv bias takes no part over the whole grid (no padding)
            got = iter(torch.autograd.grad(
                out, [t for t in leaves if t.requires_grad], grad,
                allow_unused=True))
        return (*(next(got) if w else None for w in wanted), None, None)


def relpos_attention(qkv, qkv_bias, rel_pos_h, rel_pos_w, num_heads,
                     window):
    """qkv (B, H, W, 3D) of the real tokens -> (B, H, W, D) (module
    docstring); ``window`` 0 attends over the whole grid."""
    args = (qkv, qkv_bias, rel_pos_h, rel_pos_w, num_heads, window)
    if not runtime.use_kernel(qkv):
        profiling.tally(relpos_attn_plain=1)
        return relpos_attention_ref(*args)
    profiling.tally(relpos_attn_kernel=1)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args[:4]):
        return _KernelForward.apply(*args)
    return _kernel(*args)
