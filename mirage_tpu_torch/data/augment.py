"""Host-side preprocessing for pretraining, segmentation and classification
tuning.

A fork of ``mirage_tpu/data/augment.py`` (reference
mutils/datasets_pretrain.py, mutils/datasets_semseg.py and
mutils/transforms.py): ``PretrainAugment`` is MultiMAE pretraining's
correlated flip, affine and intensity shift; ``resize_np`` resizes the
trailing two dims with torch ``F.interpolate`` semantics; ``SemSegTransform``
is the shared-geometry transform over an image and its label map;
``affine_warp`` is torchvision's RandomAffine, and ``ClsTransform`` the
classification stack; ``skimage_resize`` is the inference CLI's resize.
Randomness comes from an explicit ``np.random.Generator``, drawn in the JAX
package's order, so one seed gives the same image in both packages.

The hot resizes (bilinear float32, nearest integer) and every affine warp
run in the host library (``utils/native.py`` over ``csrc/fastops.cpp``), as
the JAX package sends them (mirage_tpu/data/augment.py:36-65, :142-182).
Their plain versions, ``resize_np_ref`` (the interpolation matrices of
``nn.resize.resize_matrix``) and ``affine_warp_ref`` (scipy's
``affine_transform``), are the references the tests and the card's stage
split hold the library to; ``resize_np`` takes ``resize_np_ref`` for the
modes and dtypes the library does not cover.
"""

import math
from typing import Dict, Mapping, Optional, Tuple

import numpy as np

from mirage_tpu_torch.data.constants import (IMAGENET_DEFAULT_MEAN,
                                             IMAGENET_DEFAULT_STD)
from mirage_tpu_torch.nn.resize import resize_matrix
from mirage_tpu_torch.utils import native


def resize_np(img: np.ndarray, out_size: Tuple[int, int],
              mode: str = "bilinear", align_corners: bool = False
              ) -> np.ndarray:
    """The trailing (H, W) resized to out_size: bilinear float32 and nearest
    integer maps in the host library, the rest as :func:`resize_np_ref`."""
    if tuple(img.shape[-2:]) == tuple(out_size):
        return img
    if mode == "bilinear" and img.dtype == np.float32:
        return native.resize_bilinear(img, out_size, align_corners)
    if mode == "nearest" and np.issubdtype(img.dtype, np.integer):
        return native.resize_nearest(img, out_size)
    return resize_np_ref(img, out_size, mode, align_corners)


def resize_np_ref(img: np.ndarray, out_size: Tuple[int, int],
                  mode: str = "bilinear", align_corners: bool = False
                  ) -> np.ndarray:
    """The plain resize: float32 products with the interpolation matrices;
    integer inputs are rounded back to their type."""
    in_h, in_w = img.shape[-2], img.shape[-1]
    out_h, out_w = out_size
    if (in_h, in_w) == (out_h, out_w):
        return img
    wh = resize_matrix(in_h, out_h, mode, align_corners)
    ww = resize_matrix(in_w, out_w, mode, align_corners)
    x = np.einsum("oh,...hw->...ow", wh, img.astype(np.float32))
    x = np.einsum("pw,...hw->...hp", ww, x)
    if np.issubdtype(img.dtype, np.integer):
        return np.round(x).astype(img.dtype)
    return x.astype(img.dtype)


class SemSegTransform:
    """Shared-geometry transform over {image tasks, 'semseg' mask}.

    train: HFlip(0.5) -> Resize(1.1·input) -> shared RandomCrop(input);
    eval: Resize(input). Norm modes: 'minmax' (identity: images arrive in
    [0, 1]), 'imagenet' (RGB, ImageNet standardisation), 'sam' (RGB in
    [0, 255]), 'z-score' (RGB divided by 255, the reference's quirk).
    Images come out (C, H, W) float32, the mask (H, W) int32."""

    def __init__(self, train: bool, input_size: int = 512,
                 norm: str = "minmax", mask_key: str = "semseg"):
        self.train = train
        self.input_size = int(input_size)
        self.norm = norm
        self.mask_key = mask_key

    def _normalize(self, img: np.ndarray) -> np.ndarray:
        if self.norm == "minmax":
            return img
        if img.ndim == 2:
            img = np.stack([img] * 3, axis=-1)
        elif img.shape[-1] == 1:
            img = np.repeat(img, 3, axis=-1)
        if self.norm == "imagenet":
            return (img - np.asarray(IMAGENET_DEFAULT_MEAN, np.float32)) \
                / np.asarray(IMAGENET_DEFAULT_STD, np.float32)
        if self.norm == "sam":
            lo, hi = img.min(), img.max()
            return (img - lo) * 255.0 / max(hi - lo, 1e-12)
        if self.norm == "z-score":
            return img.astype(np.float32) / 255.0
        raise ValueError(f"Unknown norm mode {self.norm}")

    def __call__(self, task_dict: Dict[str, np.ndarray],
                 rng: np.random.Generator) -> Dict[str, np.ndarray]:
        size = self.input_size
        out = {}
        if self.train:
            init = size + int(size * 0.1)
            flip = rng.random() < 0.5
            y0 = int(rng.integers(0, init - size + 1))
            x0 = int(rng.integers(0, init - size + 1))
            for task, img in task_dict.items():
                img = np.asarray(img)
                if flip:
                    img = img[..., ::-1]
                img = resize_np(img, (init, init), mode="nearest"
                                if task == self.mask_key else "bilinear")
                out[task] = img[..., y0:y0 + size, x0:x0 + size]
        else:
            for task, img in task_dict.items():
                out[task] = resize_np(np.asarray(img), (size, size),
                                      mode="nearest" if task == self.mask_key
                                      else "bilinear")
        final = {}
        for task, img in out.items():
            if task == self.mask_key:
                final[task] = np.ascontiguousarray(img).astype(np.int32)
                continue
            img = self._normalize(img.astype(np.float32))
            img = img[None] if img.ndim == 2 else img.transpose(2, 0, 1)
            final[task] = np.ascontiguousarray(img, np.float32)
        return final


# ------------------------------------------------------------ affine warps

def skimage_resize(img: np.ndarray, out_shape, order: int = 1,
                   anti_aliasing: Optional[bool] = None) -> np.ndarray:
    """``skimage.transform.resize(..., preserve_range=True)``, the
    reference inference CLI's preprocessing, on scipy (a fork of
    ``mirage_tpu/data/augment.py:skimage_resize``): an optional gaussian
    pre-filter with sigma = max(0, (downscale factor - 1) / 2) per axis
    (scipy's 'mirror' is skimage's 'reflect'), then ``ndimage.zoom(...,
    grid_mode=True, mode='mirror')``. Anti-aliased downscales and round-based
    nearest sampling, unlike :func:`resize_np`'s torch semantics."""
    from scipy import ndimage as ndi

    img = np.asarray(img, np.float64)
    out_shape = tuple(int(s) for s in out_shape)
    factors = np.asarray(img.shape, np.float64) / np.asarray(out_shape,
                                                             np.float64)
    if anti_aliasing is None:
        anti_aliasing = order != 0 and bool(np.any(factors > 1))
    if anti_aliasing:
        sigma = np.maximum(0.0, (factors - 1) / 2)
        img = ndi.gaussian_filter(img, sigma, mode="mirror")
    out = ndi.zoom(img, 1.0 / factors, order=order, mode="mirror",
                   grid_mode=True)
    if out.shape != out_shape:
        raise ValueError(f"resize to {out_shape} gave {out.shape}")
    return out


def random_affine_params(rng: np.random.Generator, *, degrees: float = 10.0,
                         translate: Tuple[float, float] = (0.1, 0.1),
                         scale: Tuple[float, float] = (0.9, 1.1),
                         shear: float = 5.0,
                         img_size: Tuple[int, int] = (512, 512)):
    """(angle, (tx, ty), scale, (shear_x, shear_y)), drawn as torchvision's
    RandomAffine.get_params draws them."""
    h, w = img_size
    angle = float(rng.uniform(-degrees, degrees))
    tx = float(np.round(rng.uniform(-translate[0] * w, translate[0] * w)))
    ty = float(np.round(rng.uniform(-translate[1] * h, translate[1] * h)))
    s = float(rng.uniform(scale[0], scale[1]))
    sh = float(rng.uniform(-shear, shear))
    return angle, (tx, ty), s, (sh, 0.0)


def _inverse_affine_matrix(center, angle, translate, scale, shear):
    """Inverse of T(center)·T(translate)·R(angle)·Shear·Scale·T(−center):
    output pixel (x, y) -> input pixel, as six row-major coefficients."""
    rot = math.radians(angle)
    sx, sy = math.radians(shear[0]), math.radians(shear[1])
    cx, cy = center
    tx, ty = translate
    a = math.cos(rot - sy) / math.cos(sy)
    b = -math.cos(rot - sy) * math.tan(sx) / math.cos(sy) - math.sin(rot)
    c = math.sin(rot - sy) / math.cos(sy)
    d = -math.sin(rot - sy) * math.tan(sx) / math.cos(sy) + math.cos(rot)
    m = [d / scale, -b / scale, 0.0, -c / scale, a / scale, 0.0]
    m[2] += m[0] * (-cx - tx) + m[1] * (-cy - ty)
    m[5] += m[3] * (-cx - tx) + m[4] * (-cy - ty)
    m[2] += cx
    m[5] += cy
    # float noise (cos(pi/2) ~ 6e-17) would put an exact edge outside the
    # constant-mode resampler's range
    return [0.0 if abs(v) < 1e-9 else v for v in m]


def _affine_coeffs(shape, angle, translate, scale, shear):
    """scipy's (matrix, offset) in (y, x) order for TF.affine's inverse map
    over a plane of ``shape``'s trailing (H, W)."""
    if not isinstance(shear, (tuple, list)):
        shear = (float(shear), 0.0)
    h, w = shape[-2], shape[-1]
    m = _inverse_affine_matrix(((w - 1) * 0.5, (h - 1) * 0.5), angle,
                               translate, scale, shear)
    return (np.array([[m[4], m[3]], [m[1], m[0]]], np.float64),
            np.array([m[5], m[2]], np.float64))


def affine_warp(img: np.ndarray, angle: float, translate, scale: float,
                shear, *, order: int = 1, fill: float = 0.0) -> np.ndarray:
    """The trailing (H, W) warped as torchvision's TF.affine warps it
    (rotation about the centre, then translation; bilinear order=1 or
    nearest order=0; constant fill), in the host library."""
    matrix, offset = _affine_coeffs(img.shape, angle, translate, scale, shear)
    return native.affine_warp(img, matrix, offset, order=order, cval=fill)


def affine_warp_ref(img: np.ndarray, angle: float, translate, scale: float,
                    shear, *, order: int = 1, fill: float = 0.0
                    ) -> np.ndarray:
    """The plain :func:`affine_warp`: scipy's ``affine_transform`` plane by
    plane in float32."""
    from scipy.ndimage import affine_transform

    matrix, offset = _affine_coeffs(img.shape, angle, translate, scale, shear)
    h, w = img.shape[-2], img.shape[-1]

    def warp2d(plane):
        return affine_transform(plane.astype(np.float32), matrix,
                                offset=offset, order=order, mode="constant",
                                cval=fill)

    if img.ndim == 2:
        out = warp2d(img)
    else:
        out = np.stack([warp2d(p) for p in img.reshape(-1, h, w)]).reshape(
            img.shape)
    if np.issubdtype(img.dtype, np.integer):
        return np.round(out).astype(img.dtype)
    return out.astype(img.dtype)


# ------------------------------------------------------ pretraining

LABEL_TASKS = ("layermaps", "bscanlayermap", "semseg")


class PretrainAugment:
    """The correlated augmentation of MultiMAE pretraining
    (mirage_tpu/data/augment.py:185-245, reference datasets_pretrain.py:
    18-84). One flip decision and one affine for every task; the affine is
    drawn against a fixed (512, 512) whatever the raw size and applied at
    the raw size. bscan and the layer map share it; the SLO (an en-face
    projection) takes its scale and x-translation only. Images get a
    gaussian intensity shift of random sign, clipped to [0, 1]. Labels warp
    and resize nearest and come out (H, W) int32; images bilinear, (C, H, W)
    float32. ``input_size``: task -> (H, W)."""

    def __init__(self, input_size: Mapping[str, Tuple[int, int]], *,
                 hflip: float = 0.5, intensity_shift: float = 0.05,
                 affine: bool = True, degrees: float = 10.0,
                 translate=(0.1, 0.1), scale=(0.9, 1.1), shear: float = 5.0):
        self.input_size = {k: tuple(v) for k, v in input_size.items()}
        self.hflip = hflip
        self.intensity_shift = intensity_shift
        self.affine = affine
        self.affine_cfg = dict(degrees=degrees, translate=translate,
                               scale=scale, shear=shear)

    def __call__(self, task_dict: Dict[str, np.ndarray],
                 rng: np.random.Generator) -> Dict[str, np.ndarray]:
        flip = rng.random() < self.hflip
        angle, (tx, ty), s, sh = random_affine_params(
            rng, img_size=(512, 512), **self.affine_cfg)
        out = {}
        for task, img in task_dict.items():
            img = np.asarray(img)
            if flip:
                img = img[..., ::-1]
            is_label = task in LABEL_TASKS
            if self.intensity_shift > 0 and not is_label:
                shift = float(rng.normal(0, self.intensity_shift))
                if rng.random() < 0.5:
                    shift = -shift
                img = np.clip(img + shift, 0.0, 1.0)
            if self.affine:
                order = 0 if is_label else 1
                if task in ("bscan", "bscanlayermap"):
                    img = affine_warp(img, angle, (tx, ty), s, sh,
                                      order=order)
                else:
                    img = affine_warp(img, 0.0, (tx, 0.0), s, 0.0,
                                      order=order)
            size = self.input_size[task]
            if img.shape[-2:] != size:
                img = resize_np(img, size, mode="nearest" if is_label
                                else "bilinear")
            if is_label:
                out[task] = np.ascontiguousarray(img).astype(np.int32)
            else:
                arr = np.ascontiguousarray(img).astype(np.float32)
                out[task] = arr[None] if arr.ndim == 2 else arr
        return out


# -------------------------------------------------- classification stack

def minmax_norm(img: np.ndarray, per_channel: bool = True) -> np.ndarray:
    """(x − min) / (max − min), per channel of a (C, H, W) image."""
    img = img.astype(np.float32)
    axes = (-2, -1) if per_channel else None
    lo = img.min(axis=axes, keepdims=True) if axes else img.min()
    hi = img.max(axis=axes, keepdims=True) if axes else img.max()
    return (img - lo) / np.maximum(hi - lo, 1e-12)


def naive_norm(img: np.ndarray) -> np.ndarray:
    """/255 for uint8-range data, /65535 for uint16-range, else as is."""
    img = img.astype(np.float32)
    return img / (65535.0 if img.max() > 255.0 else 255.0) \
        if img.max() > 1.0 else img


def to_rgb(img: np.ndarray) -> np.ndarray:
    """(1, H, W) or (H, W) -> (3, H, W)."""
    if img.ndim == 2:
        img = img[None]
    if img.shape[0] == 1:
        img = np.repeat(img, 3, axis=0)
    return img


class RandomIntensityChannel:
    """With probability p, each channel times U(0.8, 1.2), clamped to
    [0, 1] (mutils/transforms.py:69-104)."""

    def __init__(self, scale=(0.8, 1.2), p: float = 0.5):
        self.scale = scale
        self.p = p

    def __call__(self, img: np.ndarray, rng: np.random.Generator
                 ) -> np.ndarray:
        if rng.random() >= self.p:
            return img
        factors = rng.uniform(self.scale[0], self.scale[1],
                              size=(img.shape[0], 1, 1))
        return np.clip(img * factors.astype(np.float32), 0.0, 1.0)


class RandomAffineChannel:
    """With probability p a random affine per channel, each channel warped
    only 90 % of the time, and fill 0.5 drawing a fill from [min, max] of
    the image per call (mutils/transforms.py:107-148)."""

    def __init__(self, degrees: float = 10.0, translate=(0.1, 0.1),
                 scale=(0.9, 1.1), shear: float = 5.0, p: float = 1.0,
                 fill: Optional[float] = 0.0, channel_p: float = 0.9):
        self.cfg = dict(degrees=degrees, translate=translate, scale=scale,
                        shear=shear)
        self.p = p
        self.fill = 0.0 if fill is None else fill
        self.channel_p = channel_p

    def __call__(self, img: np.ndarray, rng: np.random.Generator
                 ) -> np.ndarray:
        if rng.random() >= self.p:
            return img
        if self.fill == 0.5:
            fill = float(rng.uniform(float(img.min()), float(img.max())))
        else:
            fill = self.fill
        out = img.copy()
        for c in range(img.shape[0]):
            if rng.random() >= self.channel_p:
                continue
            angle, t, s, sh = random_affine_params(
                rng, img_size=img.shape[-2:], **self.cfg)
            out[c] = affine_warp(img[c], angle, t, s, sh, order=1, fill=fill)
        return out


class ClsTransform:
    """The classification stack (fm_cls_config.build_transform): bilinear
    resize -> grayscale -> per-channel min-max -> in training a flip, the
    intensity jitter and the affine -> the model's norm ('minmax' per
    channel, or ImageNet RGB). Returns (C, H, W) float32."""

    def __init__(self, input_size: int = 512, train: bool = False,
                 norm: str = "minmax", hflip: float = 0.5,
                 intensity: bool = True, affine: bool = True,
                 fill: Optional[float] = 0.0):
        self.input_size = int(input_size)
        self.train = train
        self.norm = norm
        self.hflip = hflip
        self.intensity = RandomIntensityChannel() if intensity else None
        self.affine = RandomAffineChannel(fill=fill) if affine else None

    def __call__(self, img: np.ndarray, rng: np.random.Generator
                 ) -> np.ndarray:
        img = np.asarray(img, np.float32)
        if img.ndim == 3:
            img = img.mean(axis=-1)
        img = resize_np(img, (self.input_size, self.input_size),
                        mode="bilinear")
        img = minmax_norm(img[None])
        if self.train:
            if rng.random() < self.hflip:
                img = img[..., ::-1].copy()
            if self.intensity is not None:
                img = self.intensity(img, rng)
            if self.affine is not None:
                img = self.affine(img, rng)
        if self.norm == "imagenet":
            img = to_rgb(img)
            mean = np.asarray(IMAGENET_DEFAULT_MEAN, np.float32).reshape(3, 1, 1)
            std = np.asarray(IMAGENET_DEFAULT_STD, np.float32).reshape(3, 1, 1)
            img = (img - mean) / std
        else:
            img = minmax_norm(img)
        return np.ascontiguousarray(img, np.float32)
