"""The plain pretraining step: token-space losses, autograd, AdamW written out.

The MultiMAE objective of MIRAGE pretraining on each decoder's patch tokens:
the masked MSE over the image tasks (optionally on standardised target
patches, ``norm_pix``) and the masked cross-entropy over the layer map's
classes, each a per-sample mean over its masked tokens and then a mean over
the samples that have any, summed over the tasks. The gradient is taken by
autograd in blocks of rows (every block's loss carries the whole batch's
normalisation, so the summed gradients are the batch's), and AdamW is
written out: decoupled weight decay, bias-corrected moments, no decay for
biases, 1-D leaves and the embeddings, the fixed positions frozen.
"""

import torch
import torch.nn.functional as F

from benchmark.reference import mirage

NO_DECAY = {"pos_emb", "class_emb", "global_tokens", "mask_token",
            "task_embeddings", "cls_emb"}


def leaf_rules(name, shape):
    """(weight decay applies, trainable) of a leaf, by its name."""
    parts = name.split(".")
    decay = not (parts[-1] == "bias" or len(shape) <= 1
                 or any(p in NO_DECAY for p in parts))
    return decay, "pos_emb" not in parts


def ids_keep_of(masks, order):
    """(B, M) positions of the visible tokens (mask 0) in ascending order
    over the tasks' concatenated tokens; every sample has M of them."""
    mask_all = torch.cat([masks[t] for t in order], dim=1)
    b = mask_all.shape[0]
    m = int((mask_all[0] == 0).sum())
    pos = torch.arange(mask_all.shape[1], device=mask_all.device)
    keyed = torch.where(mask_all == 0, pos, pos + mask_all.shape[1])
    return keyed.sort(dim=1).values[:, :m].reshape(b, m)


def per_sample_losses(cfg, conf, preds, batch, masks):
    """task -> (per-sample masked mean (B,), sample has masked tokens (B,))."""
    out = {}
    for task, pred in preds.items():
        c = conf[task]
        p = cfg["domains"][task]["patch"]
        m = masks[task].float()
        if c["loss"] == "ce":
            b, n, flat = pred.shape
            logp = F.log_softmax(pred.reshape(b, n, -1, p * p), dim=2)
            t = mirage.patchify(batch[task][:, None].float(), p).long()
            per_tok = -torch.gather(logp, 2, t[:, :, None]).squeeze(2).mean(-1)
        else:
            t = mirage.patchify(batch[task].float(), p)
            if c.get("norm_pix"):
                t = (t - t.mean(-1, keepdim=True)) / torch.sqrt(
                    t.var(-1, keepdim=True, unbiased=True) + 1e-6)
            per_tok = ((pred - t) ** 2).mean(-1)
        den = m.sum(1)
        out[task] = ((per_tok * m).sum(1) / den.clamp_min(1.0), den > 0)
    return out


def loss_and_grads(num, cfg, conf, params, batch, masks, rows):
    """The batch's loss (a float) and the gradient of every trainable leaf,
    by autograd over blocks of ``rows`` samples."""
    order = list(cfg["domains"])
    b = batch[order[0]].shape[0]
    valid = {t: (masks[t].sum(1) > 0).sum().clamp_min(1).float()
             for t in order}
    names = [n for n, p in params.items() if p.requires_grad]
    grads = {n: torch.zeros_like(params[n]) for n in names}
    total = 0.0
    for lo in range(0, b, rows):
        sl = slice(lo, min(b, lo + rows))
        mb = {t: batch[t][sl] for t in order}
        mm = {t: masks[t][sl] for t in order}
        preds = mirage.masked_forward(num, cfg, params, mb,
                                      ids_keep_of(mm, order))
        parts = per_sample_losses(cfg, conf, preds, mb, mm)
        loss = sum((torch.where(ok, per, 0.0).sum() / valid[t])
                   for t, (per, ok) in parts.items())
        gs = torch.autograd.grad(loss, [params[n] for n in names])
        for n, g in zip(names, gs):
            grads[n] += g
        total += float(loss.detach())
    return total, grads


class AdamW:
    """AdamW on named leaves: m, v in float32, bias corrections from the
    step count, decay lr·wd·p where the leaf takes decay, each leaf's lr
    times ``lr_scale(name)``."""

    def __init__(self, params, betas, eps, weight_decay, lr_scale=None):
        self.b1, self.b2 = betas
        self.eps, self.wd = eps, weight_decay
        self.lr_scale = lr_scale or (lambda name: 1.0)
        self.t = 0
        self.m = {n: torch.zeros_like(p) for n, p in params.items()
                  if p.requires_grad}
        self.v = {n: torch.zeros_like(params[n]) for n in self.m}

    @torch.no_grad()
    def step(self, params, grads, lr):
        self.t += 1
        c1 = 1 - self.b1 ** self.t
        c2 = 1 - self.b2 ** self.t
        for n, g in grads.items():
            p = params[n]
            self.m[n].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[n].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            upd = (self.m[n] / c1) / ((self.v[n] / c2).sqrt() + self.eps)
            if leaf_rules(n, tuple(p.shape))[0]:
                upd = upd + self.wd * p
            p.sub_(lr * self.lr_scale(n) * upd)


def leaf_params(sd, trainable=None):
    """The state dict as float32 leaves, the trainable ones (by default
    all but the fixed positions) requiring grad."""
    trainable = trainable or (lambda n: leaf_rules(n, ())[1])
    return {n: t.float().clone().requires_grad_(trainable(n))
            for n, t in sd.items()}
