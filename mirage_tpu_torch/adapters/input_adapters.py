"""Modality input adapters: image -> tokens.

Counterparts of ``mirage_tpu/adapters/input_adapters.py``:

- ``PatchedInputAdapter``: patch projection (reshape + matmul) plus a
  bicubic-resized 2-D sin-cos positional embedding.
- ``SemSegInputAdapter``: class-embedding lookup, then patch projection
  (or, with ``interpolate_class_emb``, a bilinear downsampling of the
  embedded map by the patch size and a 1×1 projection), plus a
  bilinear-resized positional embedding. ``emb_padding_idx`` adds one
  class whose embedding row starts at zero (a semseg input domain of
  downstream tuning, reference input_adapters.py:157-158).

As in the reference, an adapter is configured first and given its token
width by the model (``init(dim_tokens)``), which creates its parameters.
"""

from typing import Optional

from torch import nn

from mirage_tpu_torch.nn.layers import Embedding, PatchProj
from mirage_tpu_torch.nn.posemb import build_2d_sincos_posemb
from mirage_tpu_torch.nn.resize import resize2d
from mirage_tpu_torch.ops.patch_embed import patch_embed


def pair(t):
    if t is None:
        return None
    return tuple(t) if isinstance(t, (tuple, list)) else (t, t)


class _Patched(nn.Module):
    """Patch geometry shared by the adapters."""

    def __init__(self, stride_level, patch_size_full, image_size):
        super().__init__()
        self.stride_level = stride_level
        self.patch_size_full = pair(patch_size_full)
        self.image_size = pair(image_size)
        self.dim_tokens = None

    @property
    def patch_hw(self):
        ph, pw = self.patch_size_full
        return max(1, ph // self.stride_level), max(1, pw // self.stride_level)

    @property
    def posemb_grid(self):
        (h, w), (ph, pw) = self.image_size, self.patch_hw
        return h // (self.stride_level * ph), w // (self.stride_level * pw)

    def num_tokens(self, input_hw):
        ph, pw = self.patch_hw
        return (input_hw[0] // ph) * (input_hw[1] // pw)

    def _init_pos_emb(self, dim_tokens):
        self.dim_tokens = dim_tokens
        self.pos_emb = nn.Parameter(
            build_2d_sincos_posemb(*self.posemb_grid, dim_tokens),
            requires_grad=False)

    def _pos_tokens(self, nh, nw, mode):
        pos = resize2d(self.pos_emb, (nh, nw), mode=mode)
        return pos.reshape(1, pos.shape[1], nh * nw).transpose(1, 2)

    def _grid(self, h, w):
        ph, pw = self.patch_hw
        if h % ph or w % pw:
            raise ValueError(f"{h}x{w} not divisible by patch {ph}x{pw}")
        return h // ph, w // pw


class PatchedInputAdapter(_Patched):
    def __init__(self, num_channels, stride_level=1, patch_size_full=16,
                 image_size=224):
        super().__init__(stride_level, patch_size_full, image_size)
        self.num_channels = num_channels

    def init(self, dim_tokens):
        self._init_pos_emb(dim_tokens)
        self.proj = PatchProj(self.num_channels, dim_tokens, *self.patch_hw)
        return self

    def forward(self, x, compute_dtype=None):
        """x: (B, C, H, W) -> (B, N, D)."""
        nh, nw = self._grid(*x.shape[-2:])
        return patch_embed(x, self.proj.weight, self.proj.bias, *self.patch_hw,
                           pos_emb_tokens=self._pos_tokens(nh, nw, "bicubic"),
                           compute_dtype=compute_dtype)


class SemSegInputAdapter(_Patched):
    def __init__(self, num_classes, stride_level=1, patch_size_full=16,
                 image_size=224, dim_class_emb=64,
                 interpolate_class_emb=False,
                 emb_padding_idx: Optional[int] = None):
        super().__init__(stride_level, patch_size_full, image_size)
        self.num_classes = num_classes
        self.dim_class_emb = dim_class_emb
        self.interpolate_class_emb = interpolate_class_emb
        self.emb_padding_idx = emb_padding_idx

    @property
    def effective_num_classes(self):
        return self.num_classes + (self.emb_padding_idx is not None)

    def init(self, dim_tokens):
        self._init_pos_emb(dim_tokens)
        self.class_emb = Embedding(self.effective_num_classes,
                                   self.dim_class_emb,
                                   zero_row=self.emb_padding_idx)
        proj_hw = (1, 1) if self.interpolate_class_emb else self.patch_hw
        self.proj = PatchProj(self.dim_class_emb, dim_tokens, *proj_hw)
        return self

    def forward(self, x, compute_dtype=None):
        """x: (B, H, W) integer labels -> (B, N, D)."""
        nh, nw = self._grid(*x.shape[-2:])
        emb = self.class_emb(x.long()).permute(0, 3, 1, 2)
        if compute_dtype is not None:
            emb = emb.to(compute_dtype)
        pos = self._pos_tokens(nh, nw, "bilinear")
        if self.interpolate_class_emb:
            # torch Upsample(scale_factor=1/patch) then the 1×1 projection
            # (reference input_adapters.py:194-200)
            return patch_embed(resize2d(emb, (nh, nw), mode="bilinear"),
                               self.proj.weight, self.proj.bias, 1, 1,
                               pos_emb_tokens=pos,
                               compute_dtype=compute_dtype)
        return patch_embed(emb, self.proj.weight, self.proj.bias,
                           *self.patch_hw, pos_emb_tokens=pos,
                           compute_dtype=compute_dtype)
