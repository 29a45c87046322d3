"""The plain MIRAGE model: a float32 forward from a state dict.

MIRAGE (github.com/j-morano/MIRAGE) is a MultiMAE: per-modality patch
embeddings with fixed 2-D sin-cos positions, a pre-LN ViT encoder over the
visible tokens and one global token, and per-task cross-attention decoders
(context projection, mask tokens at the hidden positions, task and position
embeddings, a cross-attention half, its MLP, ``depth`` transformer blocks, a
linear to the patch's pixels). Everything here is plain ``torch`` on the
tensors it is handed: a state dict keyed as the reference checkpoints are
(``encoder.{i}.attn.qkv.weight``, ``output_adapters.{task}.proj_context``,
...), an input batch and explicit token masks. Every product goes through
a :class:`~benchmark.reference.numerics.Numerics`, so the same code is the
float32 reference and, with fp8 products, the control.

Departures from the published description: none in the arithmetic. LN eps
is 1e-6 and GELU is the erf form, as in the reference code.
"""

import math

import numpy as np
import torch
import torch.nn.functional as F

LN_EPS = 1e-6


# ------------------------------------------------------------ architecture

def grid(cfg, task):
    image, patch = cfg["domains"][task]["image"], cfg["domains"][task]["patch"]
    return image // patch, image // patch


def out_channels(cfg, task):
    """Channels of a task's reconstruction: its classes, else its image
    channels."""
    d = cfg["domains"][task]
    return d.get("classes") or d.get("channels", 1)


class Specs(list):
    """[(name, shape, kind)] of a state dict's leaves, in a fixed order.
    kind: 'linear' (fan-in, fan-out), 'patch' (a convolution's weight:
    fan-in over its input channels and window), 'bias', 'ln_w', 'ln_b',
    'token' (embeddings), 'zero' (the mask token) or 'posemb' (the fixed
    sin-cos positions)."""

    def lin(self, prefix, n_out, n_in, bias=True):
        self.append((f"{prefix}.weight", (n_out, n_in), "linear"))
        if bias:
            self.append((f"{prefix}.bias", (n_out,), "bias"))

    def ln(self, prefix, d):
        self.append((f"{prefix}.weight", (d,), "ln_w"))
        self.append((f"{prefix}.bias", (d,), "ln_b"))

    def block(self, prefix, d, ratio):
        self.ln(f"{prefix}.norm1", d)
        self.lin(f"{prefix}.attn.qkv", 3 * d, d)
        self.lin(f"{prefix}.attn.proj", d, d)
        self.ln(f"{prefix}.norm2", d)
        self.lin(f"{prefix}.mlp.fc1", int(d * ratio), d)
        self.lin(f"{prefix}.mlp.fc2", d, int(d * ratio))

    def encoder(self, cfg):
        for i in range(cfg["depth"]):
            self.block(f"encoder.{i}", cfg["dim_tokens"], cfg["mlp_ratio"])
        self.append(("global_tokens", (1, cfg["num_global_tokens"],
                                       cfg["dim_tokens"]), "token"))


def param_specs(cfg):
    """The leaves of the MIRAGE pretraining model's state dict."""
    D = cfg["dim_tokens"]
    dec = cfg["decoder"]
    specs = Specs()
    lin, ln, block = specs.lin, specs.ln, specs.block

    for task, dom in cfg["domains"].items():
        p = dom["patch"]
        gh, gw = grid(cfg, task)
        pre = f"input_adapters.{task}"
        specs.append((f"{pre}.pos_emb", (1, D, gh, gw), "posemb"))
        if dom.get("classes"):
            specs.append((f"{pre}.class_emb.weight",
                          (dom["classes"], dom["class_emb"]), "token"))
            specs.append((f"{pre}.proj.weight", (D, dom["class_emb"], p, p),
                          "patch"))
        else:
            specs.append((f"{pre}.proj.weight", (D, dom.get("channels", 1),
                                                 p, p), "patch"))
        specs.append((f"{pre}.proj.bias", (D,), "bias"))
    specs.encoder(cfg)
    d = dec["dim"]
    for task, dom in cfg["domains"].items():
        pre = f"output_adapters.{task}"
        for ctx in cfg["domains"]:
            specs.append((f"{pre}.task_embeddings.{ctx}", (1, 1, d), "token"))
        specs.append((f"{pre}.mask_token", (1, 1, d), "zero"))
        gh, gw = grid(cfg, task)
        specs.append((f"{pre}.pos_emb", (1, d, gh, gw), "posemb"))
        lin(f"{pre}.decoder.q", d, d)
        lin(f"{pre}.decoder.kv", 2 * d, d)
        lin(f"{pre}.decoder.proj", d, d)
        ln(f"{pre}.context_norm", d)
        ln(f"{pre}.query_norm", d)
        ln(f"{pre}.out_norm", d)
        lin(f"{pre}.mlp.fc1", d * dec["mlp_ratio"], d)
        lin(f"{pre}.mlp.fc2", d, d * dec["mlp_ratio"])
        for j in range(dec["depth"]):
            block(f"{pre}.decoder_transformer.{j}", d, dec["mlp_ratio"])
        p = dom["patch"]
        lin(f"{pre}.out_proj", out_channels(cfg, task) * p * p, d)
        lin(f"{pre}.proj_context", d, D)
    return specs


def sincos_posemb(h, w, dim, temperature=10000.0):
    """(1, dim, h, w) float32 2-D sin-cos positions, MoCo-v3 style, with
    the reference's layout: the grid built with meshgrid('ij') over (w, h)
    and the flattened rows then read as (h, w)."""
    gw, gh = np.meshgrid(np.arange(w, dtype=np.float32),
                         np.arange(h, dtype=np.float32), indexing="ij")
    pos_dim = dim // 4
    omega = 1.0 / (temperature ** (np.arange(pos_dim, dtype=np.float32)
                                   / pos_dim))
    out_w = np.einsum("m,d->md", gw.flatten(), omega)
    out_h = np.einsum("m,d->md", gh.flatten(), omega)
    pos = np.concatenate([np.sin(out_w), np.cos(out_w), np.sin(out_h),
                          np.cos(out_h)], axis=1)
    pos = pos.reshape(1, h, w, dim).transpose(0, 3, 1, 2)
    return torch.from_numpy(np.ascontiguousarray(pos, dtype=np.float32))


# -------------------------------------------------------------- the layers

def patchify(x, p):
    """(B, C, H, W) -> (B, (H/p)·(W/p), C·p·p), (c, ph, pw) flattened."""
    b, c, h, w = x.shape
    x = x.reshape(b, c, h // p, p, w // p, p).permute(0, 2, 4, 1, 3, 5)
    return x.reshape(b, (h // p) * (w // p), c * p * p)


def unpatchify(x, nh, nw, p, c):
    b = x.shape[0]
    x = x.reshape(b, nh, nw, c, p, p).permute(0, 3, 1, 4, 2, 5)
    return x.reshape(b, c, nh * p, nw * p)


def pos_tokens(pos_emb, nh, nw, mode):
    """(1, D, gh, gw) -> (1, nh·nw, D), resized when the grid differs."""
    if tuple(pos_emb.shape[-2:]) != (nh, nw):
        pos_emb = F.interpolate(pos_emb.float(), size=(nh, nw), mode=mode,
                                align_corners=False)
    return pos_emb.reshape(1, pos_emb.shape[1], nh * nw).transpose(1, 2)


def layer_norm(x, sd, prefix):
    return F.layer_norm(x, (x.shape[-1],), sd[f"{prefix}.weight"],
                        sd[f"{prefix}.bias"], LN_EPS)


def linear(num, x, sd, prefix, bias=True):
    y = num.mm(x, sd[f"{prefix}.weight"].t())
    return y + sd[f"{prefix}.bias"] if bias else y


def attention(num, q, k, v):
    """softmax(q·kᵀ/√dh)·v over (B, H, N, dh)."""
    s = num.mm(q, k.transpose(-1, -2)) * (q.shape[-1] ** -0.5)
    return num.mm(torch.softmax(s, dim=-1), v)


def heads(x, h):
    b, n, c = x.shape
    return x.reshape(b, n, h, c // h).transpose(1, 2)


def merge(x):
    b, h, n, d = x.shape
    return x.transpose(1, 2).reshape(b, n, h * d)


def block(num, x, sd, prefix, num_heads, drop=(1.0, 1.0)):
    """Pre-LN block: x + proj(attn(LN1 x)); x + fc2(GELU(fc1(LN2 x))).
    ``drop``: each branch's per-sample stochastic-depth scale (0 or
    1/keep, shaped (B, 1, 1)), or 1."""
    b, n, d = x.shape
    qkv = linear(num, layer_norm(x, sd, f"{prefix}.norm1"), sd,
                 f"{prefix}.attn.qkv")
    q, k, v = qkv.reshape(b, n, 3, num_heads, d // num_heads).permute(
        2, 0, 3, 1, 4)
    x = x + drop[0] * linear(num, merge(attention(num, q, k, v)), sd,
                             f"{prefix}.attn.proj")
    h = linear(num, layer_norm(x, sd, f"{prefix}.norm2"), sd,
               f"{prefix}.mlp.fc1")
    return x + drop[1] * linear(num, F.gelu(h), sd, f"{prefix}.mlp.fc2")


def embed(num, cfg, sd, task, x):
    """One modality's tokens (B, N, D): the patch projection of the image
    (or of the class embeddings of a label map) plus its positions."""
    dom = cfg["domains"][task]
    p, pre = dom["patch"], f"input_adapters.{task}"
    if dom.get("classes"):
        x = sd[f"{pre}.class_emb.weight"][x.long()].permute(0, 3, 1, 2)
        mode = "bilinear"
    else:
        mode = "bicubic"
    nh, nw = x.shape[-2] // p, x.shape[-1] // p
    w = sd[f"{pre}.proj.weight"]
    t = num.mm(patchify(x.float(), p), w.reshape(w.shape[0], -1).t())
    return t + sd[f"{pre}.proj.bias"] + pos_tokens(sd[f"{pre}.pos_emb"], nh,
                                                   nw, mode)


def encoder(num, cfg, sd, tokens):
    for i in range(cfg["depth"]):
        tokens = block(num, tokens, sd, f"encoder.{i}", cfg["num_heads"])
    return tokens


def decode(num, cfg, sd, task, enc, tasks, present, ids_keep=None,
           pixels=True):
    """The decoder of ``task`` over the encoder's output ``enc``
    (B, M + G, D). ``tasks``: every modality in token order with its token
    count; ``present``: the ones that were encoded whole (the static
    path), or None with ``ids_keep`` (B, M), the positions of the M
    encoded tokens among all of them (the masked path). Returns the
    reconstruction (B, C, H, W), or its patch tokens (B, N, C·p·p)."""
    dec = cfg["decoder"]
    pre = f"output_adapters.{task}"
    g = cfg["num_global_tokens"]
    b, d = enc.shape[0], dec["dim"]
    context = linear(num, enc, sd, f"{pre}.proj_context")
    body = context[:, :-g]
    mask_token = sd[f"{pre}.mask_token"].reshape(1, 1, d)
    total = sum(n for _, n in tasks)
    if ids_keep is None:
        chunks, off = [], 0
        for t, n in tasks:
            if t in present:
                chunks.append(body[:, off:off + n])
                off += n
            else:
                chunks.append(mask_token.expand(b, n, d))
        full = torch.cat(chunks, dim=1)
    else:
        full = mask_token.expand(b, total, d).scatter(
            1, ids_keep[..., None].expand(-1, -1, d), body)
    nh, nw = grid(cfg, task)
    pos = pos_tokens(sd[f"{pre}.pos_emb"], nh, nw, "bilinear")
    full = full + torch.cat([sd[f"{pre}.task_embeddings.{t}"] + pos
                             for t, _ in tasks], dim=1)
    starts = np.cumsum([0] + [n for _, n in tasks])
    i = [t for t, _ in tasks].index(task)
    x = full[:, starts[i]:starts[i + 1]]
    if ids_keep is None:
        visible = [full[:, starts[j]:starts[j + 1]]
                   for j, (t, _) in enumerate(tasks) if t in present]
    else:
        visible = [torch.gather(full, 1, ids_keep[..., None].expand(-1, -1,
                                                                    d))]
    ctx = torch.cat(visible + [context[:, -g:]], dim=1)
    h = dec["num_heads"]
    q = heads(linear(num, layer_norm(x, sd, f"{pre}.query_norm"), sd,
                     f"{pre}.decoder.q"), h)
    kv = linear(num, layer_norm(ctx, sd, f"{pre}.context_norm"), sd,
                f"{pre}.decoder.kv")
    k, v = kv.reshape(b, ctx.shape[1], 2, h, d // h).permute(2, 0, 3, 1, 4)
    x = linear(num, merge(attention(num, q, k, v)), sd, f"{pre}.decoder.proj")
    x = x + linear(num, F.gelu(linear(
        num, layer_norm(x, sd, f"{pre}.out_norm"), sd, f"{pre}.mlp.fc1")),
        sd, f"{pre}.mlp.fc2")
    for j in range(dec["depth"]):
        x = block(num, x, sd, f"{pre}.decoder_transformer.{j}", h)
    x = linear(num, x, sd, f"{pre}.out_proj")
    if not pixels:
        return x
    p = cfg["domains"][task]["patch"]
    return unpatchify(x, nh, nw, p, out_channels(cfg, task))


def token_counts(cfg):
    """[(task, tokens)] of every modality in the configuration's order."""
    return [(t, math.prod(grid(cfg, t))) for t in cfg["domains"]]


def reconstruct(num, cfg, sd, x):
    """The wrapper's contract: the modalities in ``x`` encoded whole, the
    others absent (their decoder positions mask tokens); returns task ->
    reconstruction (B, C, H, W) of every task."""
    tasks = token_counts(cfg)
    present = [t for t, _ in tasks if t in x]
    tokens = [embed(num, cfg, sd, t, x[t]) for t in present]
    b = tokens[0].shape[0]
    glob = sd["global_tokens"].expand(b, -1, -1)
    enc = encoder(num, cfg, sd, torch.cat(tokens + [glob], dim=1))
    return {t: decode(num, cfg, sd, t, enc, tasks, present)
            for t, _ in tasks}


def masked_forward(num, cfg, sd, batch, ids_keep):
    """The pretraining forward: every modality embedded, the tokens at
    ``ids_keep`` (B, M) and the global tokens encoded, every decoder's
    patch tokens (task -> (B, N, C·p·p))."""
    tasks = token_counts(cfg)
    tokens = torch.cat([embed(num, cfg, sd, t, batch[t]) for t, _ in tasks],
                       dim=1)
    d = tokens.shape[-1]
    enc = torch.gather(tokens, 1, ids_keep[..., None].expand(-1, -1, d))
    glob = sd["global_tokens"].expand(enc.shape[0], -1, -1)
    enc = encoder(num, cfg, sd, torch.cat([enc, glob], dim=1))
    return {t: decode(num, cfg, sd, t, enc, tasks, None, ids_keep,
                      pixels=False) for t, _ in tasks}
