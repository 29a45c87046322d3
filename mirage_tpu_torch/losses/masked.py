"""Masked reconstruction losses for MultiMAE pretraining.

Counterpart of ``mirage_tpu/losses/masked.py`` (reference
mirage/criterion.py). The token-space forms (``masked_mse_loss_tokens``,
``masked_ce_loss_tokens``, the losses of ``train/steps.py``) read the
decoders' pre-unpatchify patch tokens, which is algebraically the
pixel-space loss (every pixel of a patch carries the patch's mask value);
the pixel-space forms (``masked_mse_loss``, ``masked_ce_loss``), the
references the token forms are held to, read the reconstructions with the
token mask upsampled nearest to the pixels.
"""

from typing import Optional

import torch
import torch.nn.functional as F

from mirage_tpu_torch.nn.resize import resize2d
from mirage_tpu_torch.ops.patch_embed import patchify, unpatchify


def _upsample_mask(mask, nh: int, nw: int, h: int, w: int):
    """(B, nh·nw) token mask -> (B, H, W) float pixel mask, nearest."""
    m = mask.reshape(mask.shape[0], 1, nh, nw).float()
    return resize2d(m, (h, w), mode="nearest")[:, 0]


def _masked_mean(loss, mask):
    """Per-sample masked mean, then the mean over the samples whose mask is
    not empty; 0 if every mask is empty (criterion.py:36-47). The division
    takes a safe denominator, so an empty sample adds no NaN to the
    gradients."""
    num = loss.reshape(loss.shape[0], -1).sum(1)
    den = mask.reshape(mask.shape[0], -1).sum(1)
    valid = den > 0
    per_sample = num / den.clamp_min(1.0)
    total = torch.where(valid, per_sample, torch.zeros_like(per_sample)).sum()
    count = valid.sum()
    return torch.where(count > 0, total / count.clamp_min(1), total * 0.0)


def masked_mse_loss(pred, target, mask: Optional[torch.Tensor] = None,
                    patch_size: int = 16, stride: int = 1,
                    norm_pix: bool = False):
    """pred, target: (B, C, H, W); mask (B, N), 1 = masked. The squared
    error's channel mean, masked by the upsampled token mask; norm_pix
    standardises each target patch (unbiased variance)."""
    scale = patch_size // stride
    h, w = pred.shape[-2:]
    nh, nw = h // scale, w // scale
    if norm_pix:
        t = patchify(target, scale, scale)
        mean = t.mean(-1, keepdim=True)
        var = t.var(-1, keepdim=True, unbiased=True)
        t = (t - mean) / torch.sqrt(var + 1e-6)
        target = unpatchify(t, nh, nw, scale, scale, target.shape[1])
    loss = (pred - target) ** 2
    if mask is None:
        return loss.mean()
    mask_pix = _upsample_mask(mask, nh, nw, h, w)
    return _masked_mean(loss.mean(1) * mask_pix, mask_pix)


def masked_mse_loss_tokens(pred_tokens, target, mask: Optional[torch.Tensor]
                           = None, patch_size: int = 16, stride: int = 1,
                           norm_pix: bool = False):
    """pred_tokens: (B, N, C·p·p) in (c, ph, pw) order; target (B, C, H, W);
    mask (B, N), 1 = masked (the loss is taken there). norm_pix
    standardises each target patch (unbiased variance, as torch's var)."""
    scale = patch_size // stride
    t = patchify(target, scale, scale)
    if norm_pix:
        mean = t.mean(-1, keepdim=True)
        var = t.var(-1, keepdim=True, unbiased=True)
        t = (t - mean) / torch.sqrt(var + 1e-6)
    loss_p = ((pred_tokens - t) ** 2).mean(-1)
    if mask is None:
        return loss_p.mean()
    m = mask.to(loss_p.dtype)
    return _masked_mean(loss_p * m, m)


def masked_ce_loss_tokens(logits_tokens, target, mask: Optional[torch.Tensor]
                          = None, patch_size: int = 16, stride: int = 1,
                          label_smoothing: float = 0.0):
    """logits_tokens: (B, N, C·p·p) in (c, ph, pw) order; target (B, H, W)
    integer labels; mask (B, N), 1 = masked."""
    scale = patch_size // stride
    b, n, flat = logits_tokens.shape
    pix = scale * scale
    c = flat // pix
    logp = F.log_softmax(logits_tokens.reshape(b, n, c, pix).float(), dim=2)
    t = patchify(target[:, None], scale, scale).long()  # (B, N, p·p)
    nll = -torch.gather(logp, 2, t[:, :, None]).squeeze(2)
    if label_smoothing > 0.0:
        nll = (1.0 - label_smoothing) * nll \
            + label_smoothing * -logp.mean(dim=2)
    loss_p = nll.mean(-1)
    if mask is None:
        return loss_p.mean()
    m = mask.to(loss_p.dtype)
    return _masked_mean(loss_p * m, m)


def masked_ce_loss(logits, target, mask: Optional[torch.Tensor] = None,
                   patch_size: int = 16, stride: int = 1,
                   label_smoothing: float = 0.0):
    """logits (B, C, H, W); target (B, H, W) integer labels; mask (B, N),
    1 = masked. Per-pixel cross-entropy in float32 (label smoothing mixes
    in the mean over the classes), masked by the upsampled token mask; an
    all-empty mask gives 0."""
    scale = patch_size // stride
    h, w = logits.shape[-2:]
    nh, nw = h // scale, w // scale
    logp = F.log_softmax(logits.float(), dim=1)
    nll = -torch.gather(logp, 1, target[:, None].long()).squeeze(1)
    if label_smoothing > 0.0:
        nll = (1.0 - label_smoothing) * nll \
            + label_smoothing * -logp.mean(dim=1)
    if mask is None:
        return nll.mean()
    mask_pix = _upsample_mask(mask, nh, nw, h, w)
    return _masked_mean(nll * mask_pix, mask_pix)
