"""SAM's ViT image encoder for the benchmark: the plain float32 reference
of the ``sam_vit_huge`` cell, with the ConvNeXt head, CE + Generalized
Dice and AdamW of ``benchmark/reference/seg.py`` and ``train.py``.

The encoder and its neck (from ``import torch`` down to :func:`encoder`)
are a copy of ``tests/sam_reference.py``, which says what they compute and
where they depart from the published code (segment-anything,
``modeling/image_encoder.py``; arXiv:2304.02643): none in the arithmetic;
the products go through ``mm``, here a
:class:`~benchmark.reference.numerics.Numerics`, so the same code is the
float32 reference and, with fp8 products, the control; ``fault`` plants
the faults the cell's limits are proved against. The tests hold the two
copies bit for bit. Below the copy: the seeded state dict in SAM's layout
(``image_encoder.*``) with the head's leaves (``output_adapters.semseg.*``),
and the reference's three training steps of the frozen encoder's head.
It imports nothing of the port and no JAX.
"""

import torch
import torch.nn.functional as F

LN_EPS = 1e-6
FAULTS = (None, "no_bias", "mask_pad", "global_windowed")


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


# ------------------------------------------------- the cell's reference

# the prompt encoder's and mask decoder's keys a SAM checkpoint holds
# beside the image encoder's; the loader drops them (two stand for all)
OTHER_KEYS = {"prompt_encoder.no_mask_embed.weight": (1, 256),
              "mask_decoder.iou_token.weight": (1, 256)}


def param_specs(cfg):
    """The leaves of the image encoder in SAM's layout, then the ConvNeXt
    head's over its embedding (``seg.param_specs``'s names)."""
    from benchmark.reference.mirage import Specs

    d, g, p = cfg["encoder_embed_dim"], grid(cfg), cfg["vit_patch_size"]
    dh = d // cfg["encoder_num_heads"]
    hid, out = int(d * cfg["mlp_ratio"]), cfg["prompt_embed_dim"]
    specs = Specs()
    pre = "image_encoder"
    specs.append((f"{pre}.patch_embed.proj.weight", (d, cfg["in_chans"], p, p),
                  "patch"))
    specs.append((f"{pre}.patch_embed.proj.bias", (d,), "bias"))
    specs.append((f"{pre}.pos_embed", (1, g, g, d), "token"))
    for i in range(cfg["encoder_depth"]):
        b = f"{pre}.blocks.{i}"
        k = window_of(cfg, i) or g
        specs.ln(f"{b}.norm1", d)
        specs.lin(f"{b}.attn.qkv", 3 * d, d)
        specs.lin(f"{b}.attn.proj", d, d)
        specs.append((f"{b}.attn.rel_pos_h", (2 * k - 1, dh), "rel_pos"))
        specs.append((f"{b}.attn.rel_pos_w", (2 * k - 1, dh), "rel_pos"))
        specs.ln(f"{b}.norm2", d)
        specs.lin(f"{b}.mlp.lin1", hid, d)
        specs.lin(f"{b}.mlp.lin2", d, hid)
    specs.append((f"{pre}.neck.0.weight", (out, d, 1, 1), "patch"))
    specs.ln(f"{pre}.neck.1", out)
    specs.append((f"{pre}.neck.2.weight", (out, out, 3, 3), "patch"))
    specs.ln(f"{pre}.neck.3", out)
    head = cfg["seg"]["head"]
    c = head["embed_dim"] // head["preds_per_patch"]
    hp = "output_adapters.semseg"
    specs.lin(f"{hp}.proj_dec", head["embed_dim"], out)
    for i in range(head["depth"]):
        b = f"{hp}.blocks.{i}"
        specs.append((f"{b}.dwconv.weight", (c, 1, 7, 7), "patch"))
        specs.append((f"{b}.dwconv.bias", (c,), "bias"))
        specs.ln(f"{b}.norm", c)
        specs.lin(f"{b}.pwconv1", 4 * c, c)
        specs.lin(f"{b}.pwconv2", c, 4 * c)
    specs.append((f"{hp}.final_layer.weight", (head["classes"], c, 1, 1),
                  "patch"))
    specs.append((f"{hp}.final_layer.bias", (head["classes"],), "bias"))
    return specs


def seeded(cfg, seed, device):
    """The state dict both sides are given: ``weights.make``'s draw over
    :func:`param_specs`, the relative-position tables then scaled from its
    0.02 to the configuration's ``rel_pos_std`` (SAM starts them at zero; a
    trained checkpoint's are not)."""
    from benchmark.reference import weights

    sd = weights.make(cfg, seed, torch.float32, device, specs=param_specs(cfg))
    for name, t in sd.items():
        if name.endswith((".rel_pos_h", ".rel_pos_w")):
            t.mul_(cfg["rel_pos_std"] / 0.02)
    return sd


def checkpoint(sd):
    """SAM's checkpoint of the seeded encoder: its ``image_encoder.*``
    leaves on the host, and zeros under :data:`OTHER_KEYS`."""
    out = {k: v.cpu() for k, v in sd.items() if k.startswith("image_encoder.")}
    out.update({k: torch.zeros(s) for k, s in OTHER_KEYS.items()})
    return out


def tokens(embedding):
    """The embedding (B, out, H, W) as the head's tokens (B, H·W, out)."""
    return embedding.flatten(2).transpose(1, 2)


def trainable(name):
    """The full freeze: the head alone trains."""
    return name.startswith("output_adapters.")


def reference(cfg, args, seed, device, pool, precision="float32",
              fault=None):
    """The reference's three steps of the head over the frozen encoder:
    (losses, the head's first gradients, the head's changes, each step's
    embedding (B, out, H, W))."""
    from benchmark.reference import seg
    from benchmark.reference import train as ref_train
    from benchmark.reference.numerics import Numerics, strict_float32

    strict_float32()
    num = Numerics(precision)
    params = ref_train.leaf_params(seeded(cfg, seed, device),
                                   trainable=trainable)
    opt = ref_train.AdamW(params, tuple(args.opt_betas), args.opt_eps,
                          args.weight_decay)
    names = [n for n, p in params.items() if p.requires_grad]
    task = cfg["seg"]["input"]
    losses, g1, feats = [], None, []
    for k in range(3):
        x, y = pool[k][task], pool[k]["semseg"]
        with torch.no_grad():
            feat = encoder(cfg, params, x, num.mm, fault)
        feats.append(feat)
        loss = seg.ce_gdice(seg.head_forward(num, cfg, params, tokens(feat)),
                            y)
        grads = dict(zip(names, torch.autograd.grad(
            loss, [params[n] for n in names])))
        losses.append(float(loss.detach()))
        if k == 0:
            g1 = grads
        opt.step(params, grads, args.lr)
    start = seeded(cfg, seed, device)
    change = {n: params[n].detach() - start[n] for n in g1}
    return losses, g1, change, feats
