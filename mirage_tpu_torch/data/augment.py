"""Host-side preprocessing for segmentation tuning.

A fork of the segmentation part of ``mirage_tpu/data/augment.py``
(reference mutils/datasets_semseg.py): ``resize_np`` resizes the trailing
two dims with torch ``F.interpolate`` semantics through the interpolation
matrices (``nn.resize.resize_matrix``), and ``SemSegTransform`` is the
shared-geometry transform over an image and its label map. Randomness comes
from an explicit ``np.random.Generator``.
"""

from typing import Dict, Tuple

import numpy as np

from mirage_tpu_torch.nn.resize import resize_matrix

IMAGENET_DEFAULT_MEAN = (0.485, 0.456, 0.406)
IMAGENET_DEFAULT_STD = (0.229, 0.224, 0.225)


def resize_np(img: np.ndarray, out_size: Tuple[int, int],
              mode: str = "bilinear", align_corners: bool = False
              ) -> np.ndarray:
    """The trailing (H, W) resized to out_size, in float32 matrix products;
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
