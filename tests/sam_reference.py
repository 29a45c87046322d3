"""SAM's ViT image encoder and its neck in plain float32 ``torch``: the
reference the port's SAM encoder (``mirage_tpu_torch/models/sam.py``) is
held to.

Written from segment-anything (github.com/facebookresearch/segment-anything,
Apache-2.0; Kirillov et al., arXiv:2304.02643), ``modeling/image_encoder.py``
as ``build_sam.py:_build_sam`` configures it, and computed as that file
computes it: the patch embedding (a 16x16 stride-16 convolution) plus the
learned absolute ``pos_embed``, laid out (B, H, W, C); each block's pre-LN
attention over windows (the grid zero-padded at the bottom and right to a
multiple of the window, partitioned, attended, unpartitioned and cropped)
or, at the global indexes, over the whole grid, with the decomposed
relative-position bias materialised and added to the logits:

    A = (q · dh^-1/2) kᵀ + rel_h[..., :, None] + rel_w[..., None, :],
    rel_h = einsum("bhwc,hkc->bhwk", q, Rh),
    rel_w = einsum("bhwc,wkc->bhwk", q, Rw),
    Rh[i, j] = rel_pos_h[i - j + k_h - 1]

(q unscaled in the bias), softmax, ``proj``; then the exact-GELU MLP; then
the neck: a 1x1 convolution, LayerNorm2d, a 3x3 convolution (padding 1),
LayerNorm2d, no convolution bias, every LayerNorm at eps 1e-6. The padded
positions are not masked: their normalised input is zero, so their key and
value are the qkv bias, and they take part in every edge window's softmax.
The state dict is keyed as SAM's checkpoints are (``image_encoder.*``), and
the configuration uses ``build_sam.py``'s names (``encoder_embed_dim``,
``encoder_depth``, ``encoder_num_heads``, ``encoder_global_attn_indexes``,
``image_size``, ``vit_patch_size``, ``prompt_embed_dim``, ``window_size``,
``mlp_ratio``, ``in_chans``).

Departures from the published code, none in the arithmetic: every product
goes through ``mm`` (``a @ b`` by default; the convolutions as unfolded
products, the einsums as batched products), so a caller can put another
precision in; the position tables are never resized (a checkpoint's match
its grid and window); ``fault`` plants the faults a check has to catch:
``"no_bias"`` leaves the relative-position bias out, ``"mask_pad"`` masks
the padded keys out of the softmax, ``"global_windowed"`` runs the global
blocks over windows (their tables read at the window's offsets). It
imports nothing of the port and no JAX.
"""

import torch
import torch.nn.functional as F

LN_EPS = 1e-6
FAULTS = (None, "no_bias", "mask_pad", "global_windowed")


def strict_float32():
    """float32 products in float32: no TF32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def grid(cfg):
    return cfg["image_size"] // cfg["vit_patch_size"]


def window_of(cfg, i, fault=None):
    """Block i's window: 0 (global attention) at the global indexes."""
    glob = i in cfg["encoder_global_attn_indexes"]
    return 0 if glob and fault != "global_windowed" else cfg["window_size"]


def linear(x, sd, prefix, mm):
    y = mm(x, sd[f"{prefix}.weight"].t())
    bias = sd.get(f"{prefix}.bias")
    return y if bias is None else y + bias


def conv(x, weight, mm, stride=1, padding=0):
    """A convolution without bias of x (B, C, H, W) as an unfolded product:
    (B, O, H', W')."""
    b, _, h, w = x.shape
    o, _, kh, kw = weight.shape
    cols = F.unfold(x, (kh, kw), padding=padding, stride=stride)
    y = mm(cols.transpose(1, 2), weight.reshape(o, -1).t())
    ho = (h + 2 * padding - kh) // stride + 1
    wo = (w + 2 * padding - kw) // stride + 1
    return y.transpose(1, 2).reshape(b, o, ho, wo)


def layer_norm_2d(x, weight, bias):
    """SAM's LayerNorm2d over the channels of (B, C, H, W)."""
    u = x.mean(1, keepdim=True)
    s = (x - u).pow(2).mean(1, keepdim=True)
    x = (x - u) / torch.sqrt(s + LN_EPS)
    return weight[:, None, None] * x + bias[:, None, None]


def window_partition(x, ws):
    """(B, H, W, C) -> (B·nW, ws, ws, C) zero-padded windows, (Hp, Wp)."""
    b, h, w, c = x.shape
    pad_h, pad_w = (ws - h % ws) % ws, (ws - w % ws) % ws
    if pad_h or pad_w:
        x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    hp, wp = h + pad_h, w + pad_w
    x = x.view(b, hp // ws, ws, wp // ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).contiguous().view(-1, ws, ws, c), \
        (hp, wp)


def window_unpartition(windows, ws, pad_hw, hw):
    """The inverse of :func:`window_partition`, cropped to ``hw``."""
    hp, wp = pad_hw
    h, w = hw
    b = windows.shape[0] // (hp * wp // ws // ws)
    x = windows.view(b, hp // ws, wp // ws, ws, ws, -1)
    x = x.permute(0, 1, 3, 2, 4, 5).contiguous().view(b, hp, wp, -1)
    return x[:, :h, :w, :].contiguous()


def get_rel_pos(q_size, k_size, rel_pos):
    """(q_size, k_size, C): row i, column j is rel_pos[i - j + k_size - 1]
    (the published ``get_rel_pos`` at equal sizes, without its resize)."""
    if rel_pos.shape[0] != 2 * max(q_size, k_size) - 1:
        raise ValueError(f"a table of {rel_pos.shape[0]} rows for "
                         f"{q_size} x {k_size}: the reference never resizes")
    q_coords = torch.arange(q_size)[:, None] * max(k_size / q_size, 1.0)
    k_coords = torch.arange(k_size)[None, :] * max(q_size / k_size, 1.0)
    rel = (q_coords - k_coords) + (k_size - 1) * max(q_size / k_size, 1.0)
    return rel_pos[rel.long().to(rel_pos.device)]


def add_decomposed_rel_pos(attn, q, rel_pos_h, rel_pos_w, q_size, k_size, mm):
    """attn (B, q_h·q_w, k_h·k_w) plus rel_h over the key rows and rel_w
    over the key columns, from the unscaled q (B, q_h·q_w, C)."""
    q_h, q_w = q_size
    k_h, k_w = k_size
    rh = get_rel_pos(q_h, k_h, rel_pos_h)
    rw = get_rel_pos(q_w, k_w, rel_pos_w)
    b, _, dim = q.shape
    r_q = q.reshape(b, q_h, q_w, dim)
    # einsum("bhwc,hkc->bhwk") and einsum("bhwc,wkc->bhwk") as products
    # batched over the query row and the query column
    rel_h = mm(r_q.permute(1, 0, 2, 3).reshape(q_h, b * q_w, dim),
               rh.transpose(1, 2)).reshape(q_h, b, q_w, k_h).permute(
                   1, 0, 2, 3)
    rel_w = mm(r_q.permute(2, 0, 1, 3).reshape(q_w, b * q_h, dim),
               rw.transpose(1, 2)).reshape(q_w, b, q_h, k_w).permute(
                   1, 2, 0, 3)
    attn = (attn.view(b, q_h, q_w, k_h, k_w) + rel_h[:, :, :, :, None]
            + rel_w[:, :, :, None, :])
    return attn.view(b, q_h * q_w, k_h * k_w)


def attention(x, sd, prefix, heads, mm, fault=None, real=None):
    """SAM's Attention on x (B, H, W, dim); ``real`` (B, H·W) marks the
    positions that are not padding (the ``mask_pad`` fault's mask)."""
    b, h, w, _ = x.shape
    qkv = linear(x, sd, f"{prefix}.qkv", mm).reshape(
        b, h * w, 3, heads, -1).permute(2, 0, 3, 1, 4)
    q, k, v = qkv.reshape(3, b * heads, h * w, -1).unbind(0)
    scale = q.shape[-1] ** -0.5
    attn = mm(q * scale, k.transpose(-2, -1))
    if fault != "no_bias":
        tabs = [sd[f"{prefix}.rel_pos_{a}"] for a in "hw"]
        if fault == "global_windowed":  # a global block's tables, centred
            tabs = [t[(t.shape[0] + 1) // 2 - n:][:2 * n - 1]
                    for t, n in zip(tabs, (h, w))]
        attn = add_decomposed_rel_pos(attn, q, *tabs, (h, w), (h, w), mm)
    if fault == "mask_pad" and real is not None:
        keep = real.repeat_interleave(heads, 0)[:, None, :]
        attn = attn.masked_fill(~keep, float("-inf"))
    attn = attn.softmax(dim=-1)
    x = mm(attn, v).view(b, heads, h, w, -1).permute(0, 2, 3, 1, 4)
    return linear(x.reshape(b, h, w, -1), sd, f"{prefix}.proj", mm)


def block(x, sd, prefix, heads, window, mm, fault=None):
    """SAM's Block on x (B, H, W, dim)."""
    shortcut = x
    x = F.layer_norm(x, x.shape[-1:], sd[f"{prefix}.norm1.weight"],
                     sd[f"{prefix}.norm1.bias"], LN_EPS)
    real = None
    if window > 0:
        h, w = x.shape[1], x.shape[2]
        x, pad_hw = window_partition(x, window)
        ones = torch.ones(shortcut.shape[:3] + (1,), device=x.device)
        real = window_partition(ones, window)[0].reshape(x.shape[0], -1) > 0
    x = attention(x, sd, f"{prefix}.attn", heads, mm, fault, real)
    if window > 0:
        x = window_unpartition(x, window, pad_hw, (h, w))
    x = shortcut + x
    y = F.layer_norm(x, x.shape[-1:], sd[f"{prefix}.norm2.weight"],
                     sd[f"{prefix}.norm2.bias"], LN_EPS)
    y = linear(F.gelu(linear(y, sd, f"{prefix}.mlp.lin1", mm)), sd,
               f"{prefix}.mlp.lin2", mm)
    return x + y


def neck(x, sd, mm):
    """(B, H, W, dim) -> the image embedding (B, out, H, W)."""
    pre = "image_encoder.neck"
    x = conv(x.permute(0, 3, 1, 2), sd[f"{pre}.0.weight"], mm)
    x = layer_norm_2d(x, sd[f"{pre}.1.weight"], sd[f"{pre}.1.bias"])
    x = conv(x, sd[f"{pre}.2.weight"], mm, padding=1)
    return layer_norm_2d(x, sd[f"{pre}.3.weight"], sd[f"{pre}.3.bias"])


def encoder(cfg, sd, images, mm=torch.matmul, fault=None):
    """ImageEncoderViT's forward: images (B, in_chans, S, S) -> the image
    embedding (B, prompt_embed_dim, S / patch, S / patch)."""
    if fault not in FAULTS:
        raise ValueError(f"fault {fault!r}: one of {FAULTS}")
    pre = "image_encoder"
    p = cfg["vit_patch_size"]
    x = conv(images, sd[f"{pre}.patch_embed.proj.weight"], mm, stride=p)
    x = x + sd[f"{pre}.patch_embed.proj.bias"][:, None, None]
    x = x.permute(0, 2, 3, 1) + sd[f"{pre}.pos_embed"]
    for i in range(cfg["encoder_depth"]):
        x = block(x, sd, f"{pre}.blocks.{i}", cfg["encoder_num_heads"],
                  window_of(cfg, i, fault), mm, fault)
    return neck(x, sd, mm)
