"""Resizes with torch ``F.interpolate`` semantics.

Counterpart of ``mirage_tpu/nn/resize.py`` (which emulates torch's
``F.interpolate`` in JAX): ``resize2d`` runs ``F.interpolate`` (bicubic is
torch's A = -0.75); ``resize_matrix`` builds the same interpolation as a
dense host matrix (a numpy fork of the JAX package's ``_resize_matrix``),
which the data pipeline and the checkpoint position-embedding resize apply
on the host.
"""

import functools

import numpy as np
import torch.nn.functional as F


def _source_index(scale, dst, align_corners, cubic):
    """torch's area_pixel_compute_source_index."""
    if align_corners:
        return scale * dst
    src = scale * (dst + 0.5) - 0.5
    return src if cubic else np.maximum(src, 0.0)


def _scale(in_size, out_size, align_corners):
    if align_corners:
        return (in_size - 1) / (out_size - 1) if out_size > 1 else 0.0
    return in_size / out_size


def _cubic_weight(t, a=-0.75):
    t = np.abs(t)
    return np.where(
        t <= 1.0, ((a + 2.0) * t - (a + 3.0)) * t * t + 1.0,
        np.where(t < 2.0, (((a * t) - 5.0 * a) * t + 8.0 * a) * t - 4.0 * a,
                 0.0))


@functools.lru_cache(maxsize=256)
def resize_matrix(in_size: int, out_size: int, mode: str,
                  align_corners: bool = False):
    """Dense (out_size, in_size) float32 matrix of a 1-D resize with torch
    semantics: 'nearest', 'nearest-exact', 'bilinear' or 'bicubic'."""
    w = np.zeros((out_size, in_size), dtype=np.float64)
    dst = np.arange(out_size, dtype=np.float64)
    rows = np.arange(out_size)
    if mode in ("nearest", "nearest-exact"):
        shift = 0.5 if mode == "nearest-exact" else 0.0
        src = np.floor((dst + shift) * (in_size / out_size)).astype(np.int64)
        w[rows, np.minimum(src, in_size - 1)] = 1.0
    elif mode == "bilinear":
        src = _source_index(_scale(in_size, out_size, align_corners), dst,
                            align_corners, cubic=False)
        idx0 = np.clip(np.floor(src).astype(np.int64), 0, in_size - 1)
        idx1 = np.minimum(idx0 + 1, in_size - 1)
        lam1 = src - idx0
        np.add.at(w, (rows, idx0), 1.0 - lam1)
        np.add.at(w, (rows, idx1), lam1)
    elif mode == "bicubic":
        src = _source_index(_scale(in_size, out_size, align_corners), dst,
                            align_corners, cubic=True)
        base = np.floor(src).astype(np.int64)
        t = src - base
        for tap in range(-1, 3):
            np.add.at(w, (rows, np.clip(base + tap, 0, in_size - 1)),
                      _cubic_weight(tap - t))
    else:
        raise ValueError(f"Unsupported resize mode: {mode}")
    return w.astype(np.float32)


def resize2d(x, out_size, mode="bilinear", align_corners=False):
    """Resize the trailing two dims of x (B, C, H, W) to ``out_size``; the
    computation is float32, the result x's dtype."""
    out_size = tuple(out_size)
    if tuple(x.shape[-2:]) == out_size:
        return x
    kw = {} if mode.startswith("nearest") else {"align_corners": align_corners}
    return F.interpolate(x.float(), size=out_size, mode=mode, **kw).to(x.dtype)
