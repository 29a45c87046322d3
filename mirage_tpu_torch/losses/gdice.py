"""Segmentation and classification losses: cross-entropy (optionally
ignoring a label, label-smoothed, weighted) and cross-entropy + Generalized
Dice.

Counterpart of ``mirage_tpu/losses/gdice.py`` (reference mutils/gdice.py:
GeneralizedDiceLoss with w = 1/vol², infinite weights replaced by the
sample's largest finite one, smooth 1e-5; CEGDiceLoss = 0.5·CE + 0.5·GDice).
Sums in float32.
"""

from typing import Optional

import torch


def cross_entropy_loss(logits, target, *, ignore_index: Optional[int] = None,
                       label_smoothing: float = 0.0, weights=None,
                       normalize: bool = True):
    """logits (B, C, *spatial), target (B, *spatial) integer labels: the
    mean negative log-likelihood over the pixels whose label is not
    ``ignore_index`` (0 when there are none). A label outside [0, C) adds
    nothing to the likelihood term, as the JAX package's one-hot reduction.
    ``label_smoothing`` mixes in the mean −log p over the classes;
    ``weights`` (per sample, or broadcastable to target) weigh each pixel:
    loss = Σ w·nll / Σ w. ``normalize=False`` returns (Σ w·nll, Σ w), for a
    caller that sums both over shards before dividing."""
    c = logits.shape[1]
    logp = torch.log_softmax(logits.float(), dim=1)
    target = target.long()
    inside = (target >= 0) & (target < c)
    picked = logp.gather(1, target.clamp(0, c - 1).unsqueeze(1)).squeeze(1)
    nll = -torch.where(inside, picked, 0.0)
    if label_smoothing > 0.0:
        nll = (1.0 - label_smoothing) * nll \
            + label_smoothing * -logp.mean(dim=1)
    if ignore_index is None and weights is None:
        if not normalize:
            return nll.sum(), torch.tensor(float(nll.numel()),
                                           device=nll.device)
        return nll.mean()
    valid = torch.ones_like(nll)
    if ignore_index is not None:
        valid = valid * (target != ignore_index).float()
    if weights is not None:
        w = torch.as_tensor(weights, device=nll.device).float()
        if w.ndim == 1:  # per sample
            w = w.reshape(w.shape[0], *(1,) * (nll.ndim - 1))
        valid = valid * w.expand(nll.shape)
    if not normalize:
        return (nll * valid).sum(), valid.sum()
    return (nll * valid).sum() / valid.sum().clamp_min(1.0)


def generalized_dice_loss(logits, target, smooth: float = 1e-5):
    """The batch mean of 1 − (2 Σ_c w_c·|P_c ∩ G_c| + s) / (Σ_c w_c·(|G_c| +
    |P_c|) + s) per sample, w_c = 1/|G_c|² (an empty class takes the
    sample's largest finite weight)."""
    c = logits.shape[1]
    probs = torch.softmax(logits.float(), dim=1)
    target = target.long()
    inside = ((target >= 0) & (target < c)).unsqueeze(1)
    onehot = torch.zeros_like(probs).scatter_(
        1, target.clamp(0, c - 1).unsqueeze(1), 1.0) * inside
    dims = tuple(range(2, probs.ndim))
    intersection = (onehot * probs).sum(dims)
    ground = onehot.sum(dims)
    denominator = ground + probs.sum(dims)
    w = 1.0 / ground.square()
    finite = torch.isfinite(w)
    w0 = torch.where(finite, w, 0.0)
    w = torch.where(finite, w0, w0.amax(dim=1, keepdim=True))
    f = 1.0 - (2.0 * (intersection * w).sum(1) + smooth) / (
        (denominator * w).sum(1) + smooth)
    return f.mean()


def ce_gdice_loss(logits, target):
    """0.5·CE + 0.5·GDice (gdice.py:197-228)."""
    return 0.5 * cross_entropy_loss(logits, target) \
        + 0.5 * generalized_dice_loss(logits, target)
