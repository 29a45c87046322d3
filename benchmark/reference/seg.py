"""The plain segmentation-tuning step: MIRAGE's light forward with the
ConvNeXt head, CE + Generalized Dice, autograd, AdamW with layer decay.

The light forward embeds every given modality whole, runs the encoder
with stochastic depth (block i drops each branch of a sample with
probability linspace(0, rate, depth)[i]; the draws are uniform (B, 1, 1)
tensors from the step's generator, the attention branch's then the MLP's,
block by block, none where the rate is 0) and hands the main task's tokens
to the head: a linear to ``embed_dim`` channels, each patch's
``preds_per_patch`` sub-pixels laid out channels-last, ``depth`` ConvNeXt
blocks (depthwise 7x7, LN, pointwise MLP, residual), a 1x1 projection to
the classes and a bilinear resize to the image. The loss is 0.5 CE + 0.5
Generalized Dice (w = 1/|G|², an empty class taking the sample's largest
finite weight, smooth 1e-5). With a frozen encoder the encoder's weights
take no gradient, but the input adapters' do, through it.
"""

import math

import torch
import torch.nn.functional as F

from benchmark.reference import mirage


def geometry(cfg):
    """The segmentation model's configuration: the encoder of ``cfg`` over
    the segmentation input."""
    seg = cfg["seg"]
    return {**cfg, "domains": {seg["input"]: {
        "image": seg["image"], "patch": seg["patch"],
        "channels": seg.get("channels", 1)}}}


def param_specs(cfg):
    """The leaves of the segmentation model's state dict."""
    scfg, head = geometry(cfg), cfg["seg"]["head"]
    D = cfg["dim_tokens"]
    specs = mirage.Specs()
    for task, dom in scfg["domains"].items():
        gh, gw = mirage.grid(scfg, task)
        p = dom["patch"]
        pre = f"input_adapters.{task}"
        specs.append((f"{pre}.pos_emb", (1, D, gh, gw), "posemb"))
        specs.append((f"{pre}.proj.weight", (D, dom["channels"], p, p),
                      "patch"))
        specs.append((f"{pre}.proj.bias", (D,), "bias"))
    specs.encoder(cfg)
    pre = "output_adapters.semseg"
    c = head["embed_dim"] // head["preds_per_patch"]
    specs.lin(f"{pre}.proj_dec", head["embed_dim"], D)
    for i in range(head["depth"]):
        b = f"{pre}.blocks.{i}"
        specs.append((f"{b}.dwconv.weight", (c, 1, 7, 7), "patch"))
        specs.append((f"{b}.dwconv.bias", (c,), "bias"))
        specs.ln(f"{b}.norm", c)
        specs.lin(f"{b}.pwconv1", 4 * c, c)
        specs.lin(f"{b}.pwconv2", c, 4 * c)
    specs.append((f"{pre}.final_layer.weight", (head["classes"], c, 1, 1),
                  "patch"))
    specs.append((f"{pre}.final_layer.bias", (head["classes"],), "bias"))
    return specs


def drop_scales(cfg, rate, batch, gen):
    """Per block, the (attention, MLP) stochastic-depth scales of each
    sample at the top ``rate``, drawn from ``gen`` in the blocks' order."""
    rates = torch.linspace(0.0, rate, cfg["depth"])
    out = []
    for rate in rates.tolist():
        if rate == 0.0:
            out.append((1.0, 1.0))
            continue
        keep = 1.0 - rate
        pair = []
        for _ in range(2):
            u = torch.rand((batch, 1, 1), generator=gen, device=gen.device)
            pair.append(torch.where(u < keep, 1.0 / keep, 0.0))
        out.append(tuple(pair))
    return out


def head_forward(num, cfg, sd, tokens):
    """The ConvNeXt head over the main task's tokens (B, N, D)."""
    head = cfg["seg"]["head"]
    pre = "output_adapters.semseg"
    scfg = geometry(cfg)
    task = cfg["seg"]["input"]
    nh, nw = mirage.grid(scfg, task)
    sub = int(math.isqrt(head["preds_per_patch"]))
    c = head["embed_dim"] // head["preds_per_patch"]
    x = mirage.linear(num, tokens, sd, f"{pre}.proj_dec")
    b = x.shape[0]
    x = x.reshape(b, nh, nw, sub, sub, c).permute(0, 1, 3, 2, 4, 5)
    x = x.reshape(b, nh * sub, nw * sub, c)
    for i in range(head["depth"]):
        blk = f"{pre}.blocks.{i}"
        t = F.conv2d(x.permute(0, 3, 1, 2), sd[f"{blk}.dwconv.weight"],
                     sd[f"{blk}.dwconv.bias"], padding=3,
                     groups=c).permute(0, 2, 3, 1)
        h = mirage.linear(num, mirage.layer_norm(t, sd, f"{blk}.norm"), sd,
                          f"{blk}.pwconv1")
        x = x + mirage.linear(num, F.gelu(h), sd, f"{blk}.pwconv2")
    w = sd[f"{pre}.final_layer.weight"]
    x = num.mm(x, w.reshape(w.shape[0], -1).t()) + sd[f"{pre}.final_layer.bias"]
    image = scfg["domains"][task]["image"]
    return F.interpolate(x.permute(0, 3, 1, 2), size=(image, image),
                         mode="bilinear", align_corners=False)


def logits(num, cfg, sd, images, gen, drop_path):
    """The light forward with stochastic depth at ``drop_path`` from
    ``gen``: (B, classes, H, W)."""
    scfg = geometry(cfg)
    task = cfg["seg"]["input"]
    tokens = mirage.embed(num, scfg, sd, task, images)
    glob = sd["global_tokens"].expand(tokens.shape[0], -1, -1)
    x = torch.cat([tokens, glob], dim=1)
    for i, drop in enumerate(drop_scales(cfg, drop_path, x.shape[0], gen)):
        x = mirage.block(num, x, sd, f"encoder.{i}", cfg["num_heads"], drop)
    n = tokens.shape[1]
    return head_forward(num, cfg, sd, x[:, :n])


def ce_gdice(logits, target, smooth=1e-5):
    """0.5 · mean pixel cross-entropy + 0.5 · Generalized Dice."""
    c = logits.shape[1]
    logp = torch.log_softmax(logits, dim=1)
    ce = -logp.gather(1, target[:, None]).mean()
    probs = logp.exp()
    onehot = F.one_hot(target, c).permute(0, 3, 1, 2).float()
    inter = (onehot * probs).sum((2, 3))
    ground = onehot.sum((2, 3))
    denom = ground + probs.sum((2, 3))
    w = 1.0 / ground.square()
    finite = torch.isfinite(w)
    w0 = torch.where(finite, w, 0.0)
    w = torch.where(finite, w0, w0.amax(dim=1, keepdim=True))
    dice = 1.0 - (2.0 * (inter * w).sum(1) + smooth) / (
        (denom * w).sum(1) + smooth)
    return 0.5 * ce + 0.5 * dice.mean()


def trainable(name):
    """The encoder is frozen and the positions fixed; the rest trains."""
    parts = name.split(".")
    return not ("pos_emb" in parts or parts[0] == "encoder")


def lr_scale(cfg, layer_decay, name):
    """Layer decay: the input adapters and the global tokens at
    decay^(depth + 1), the head at 1 (the frozen blocks take none)."""
    if name.split(".")[0] in ("input_adapters", "global_tokens"):
        return layer_decay ** (cfg["depth"] + 1)
    return 1.0
