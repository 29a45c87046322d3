"""ctypes binding of the host fast-ops library (``csrc/fastops.cpp``).

Counterpart of ``mirage_tpu/utils/native.py``: the same five functions with
the same dtype gates (a dtype the library does not take returns None, and
the caller takes its numpy path). One deviation: the library is required.
It is built at first use by ``ops/_build.py:build_host`` into
``build/mirage_tpu_torch/libfastops.so``, and where it cannot be built or
loaded the call raises, instead of returning None for a numpy fallback to
take over, which would hide the library's loss on the card's machine.
"""

import ctypes
import threading
from typing import Optional

import numpy as np

from mirage_tpu_torch.ops import _build

_P, _L, _I, _F = ctypes.c_void_p, ctypes.c_long, ctypes.c_int, ctypes.c_float
# symbol -> argtypes; every entry returns nothing but fastops_version
_SIGNATURES = {
    "resize_bilinear_f32": [_P, _P, _L, _L, _L, _L, _L, _I],
    "resize_nearest_i32": [_P, _P, _L, _L, _L, _L, _L],
    "u8_to_f32_scaled": [_P, _P, _L, _F],
    "minmax_norm_f32": [_P, _L, _L],
    "affine_warp_f32": [_P, _P, _L, _L, _L, _P, _P, _I, _F],
}

_lib = None
_lock = threading.Lock()


def load() -> ctypes.CDLL:
    """The library, built and loaded at the first call; raises where the
    build or the load fails."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(_build.build_host()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = None
            lib.fastops_version.argtypes = []
            lib.fastops_version.restype = _I
            if lib.fastops_version() < 1:
                raise RuntimeError("libfastops.so is older than version 1")
            _lib = lib
        return _lib


def _planes(x: np.ndarray, out_hw=None):
    """x's (H, W) planes as one contiguous (B, H, W) view; raises on an
    empty plane or output size."""
    if x.ndim < 2 or x.shape[-2] < 1 or x.shape[-1] < 1:
        raise ValueError(f"need (..., H, W) with H, W >= 1, got {x.shape}")
    if out_hw is not None and (len(out_hw) != 2 or min(out_hw) < 1):
        raise ValueError(f"output size {out_hw}")
    return np.ascontiguousarray(x).reshape(-1, *x.shape[-2:])


def resize_bilinear(x: np.ndarray, out_hw, align_corners=False
                    ) -> Optional[np.ndarray]:
    """(..., H, W) float32 -> (..., oh, ow) with torch's bilinear
    ``F.interpolate``; None for another dtype."""
    if x.dtype != np.float32:
        return None
    lib = load()
    oh, ow = (int(v) for v in out_hw)
    xin = _planes(x, (oh, ow))
    out = np.empty((xin.shape[0], oh, ow), np.float32)
    lib.resize_bilinear_f32(xin.ctypes.data, out.ctypes.data, xin.shape[0],
                            xin.shape[1], xin.shape[2], oh, ow,
                            int(align_corners))
    return out.reshape(*x.shape[:-2], oh, ow)


def resize_nearest(x: np.ndarray, out_hw) -> Optional[np.ndarray]:
    """(..., H, W) integers -> (..., oh, ow) with torch's nearest
    ``F.interpolate`` (floor), through int32, in x's dtype; None for a
    non-integer dtype."""
    if not np.issubdtype(x.dtype, np.integer):
        return None
    lib = load()
    oh, ow = (int(v) for v in out_hw)
    xin = _planes(x.astype(np.int32), (oh, ow))
    out = np.empty((xin.shape[0], oh, ow), np.int32)
    lib.resize_nearest_i32(xin.ctypes.data, out.ctypes.data, xin.shape[0],
                           xin.shape[1], xin.shape[2], oh, ow)
    return out.reshape(*x.shape[:-2], oh, ow).astype(x.dtype)


def u8_to_f32(x: np.ndarray, scale: float = 1.0 / 255.0
              ) -> Optional[np.ndarray]:
    """uint8 -> float32 times ``scale``; None for another dtype."""
    if x.dtype != np.uint8:
        return None
    lib = load()
    xin = np.ascontiguousarray(x)
    out = np.empty(x.shape, np.float32)
    lib.u8_to_f32_scaled(xin.ctypes.data, out.ctypes.data, x.size, scale)
    return out


def affine_warp(x: np.ndarray, matrix: np.ndarray, offset: np.ndarray, *,
                order: int = 1, cval: float = 0.0) -> np.ndarray:
    """Each (H, W) plane of x warped by the inverse affine map scipy's
    ``ndimage.affine_transform`` takes: input (y, x) = matrix · output
    (y, x) + offset, with ``matrix`` [[m_yy, m_yx], [m_xy, m_xx]]; bilinear
    (order 1) or nearest (0), ``cval`` outside. Computed in float32;
    integer inputs are rounded back to their dtype."""
    if order not in (0, 1):
        raise ValueError(f"order {order}: the library warps with 0 or 1")
    lib = load()
    xin = _planes(np.asarray(x, np.float32))
    b, h, w = xin.shape
    mats = np.ascontiguousarray(np.broadcast_to(
        np.asarray(matrix, np.float64).reshape(4), (b, 4)))
    offs = np.ascontiguousarray(np.broadcast_to(
        np.asarray(offset, np.float64).reshape(2), (b, 2)))
    out = np.empty_like(xin)
    lib.affine_warp_f32(xin.ctypes.data, out.ctypes.data, b, h, w,
                        mats.ctypes.data, offs.ctypes.data, int(order),
                        float(cval))
    out = out.reshape(x.shape)
    if np.issubdtype(x.dtype, np.integer):
        return np.round(out).astype(x.dtype)
    return out.astype(x.dtype)


def minmax_norm_inplace(x: np.ndarray) -> Optional[np.ndarray]:
    """Each (H, W) plane of x min-max scaled to [0, 1] in place; None
    unless x is C-contiguous float32."""
    if x.dtype != np.float32 or not x.flags.c_contiguous:
        return None
    lib = load()
    _planes(x)
    plane = x.shape[-2] * x.shape[-1]
    lib.minmax_norm_f32(x.ctypes.data, x.size // plane, plane)
    return x
