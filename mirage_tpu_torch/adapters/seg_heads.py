"""Segmentation heads: output adapters for the light (unmasked) forward.

Counterpart of ``mirage_tpu/adapters/seg_heads.py``: ``adapt_tokens`` and
the ConvNeXt head (reference output_adapters.py:437-517 and
output_adapter_utils.py:8-46), keyed like the reference state dict
(``proj_dec``, ``blocks.{i}.{dwconv,norm,pwconv1,pwconv2}``,
``final_layer``). The head runs channels-last end to end: a ConvNeXt
block's LN + pointwise MLP over its B·H·W rows is the MLP half-block, run
as ``mlp_block(stash=True)`` (the stash pair B9 in training, B2 without a
gradient), whose own residual of the dwconv output t is taken back out
(out − t) before the block input is added, as the JAX package does
(seg_heads.py:104-110). The DPT, Segmenter and linear heads come later.
"""

from typing import Optional, Sequence, Tuple, Union

import torch
from torch import nn

from mirage_tpu_torch.adapters.input_adapters import pair
from mirage_tpu_torch.nn.conv import Conv2d, conv2d_nhwc
from mirage_tpu_torch.nn.layers import LayerNorm, Linear, linear
from mirage_tpu_torch.nn.resize import resize2d
from mirage_tpu_torch.ops.fused_mlp import mlp_block


def adapt_tokens(encoder_tokens, input_info, main_tasks: Sequence[str]):
    """Each main task's token range, concatenated on the channel dim; the
    global tokens at the end fall away (output_adapters.py:313-322)."""
    return torch.cat([encoder_tokens[:, input_info["tasks"][t]["start_idx"]:
                                     input_info["tasks"][t]["end_idx"]]
                      for t in main_tasks], dim=-1)


class ConvNeXtBlock(nn.Module):
    """Depthwise 7×7 -> LN -> pwconv1 -> GELU -> pwconv2, plus the input;
    x is channels-last (B, H, W, C)."""

    def __init__(self, dim):
        super().__init__()
        self.dwconv = Conv2d(dim, dim, 7, groups=dim)
        self.norm = LayerNorm(dim)
        self.pwconv1 = Linear(dim, 4 * dim, trunc_normal=True)
        self.pwconv2 = Linear(4 * dim, dim, trunc_normal=True)

    def forward(self, x):
        c = x.shape[-1]
        t = conv2d_nhwc(x, self.dwconv.weight, self.dwconv.bias, padding=3,
                        groups=c).reshape(-1, c)
        out = mlp_block(t, self.norm.weight, self.norm.bias,
                        self.pwconv1.weight, self.pwconv1.bias,
                        self.pwconv2.weight, self.pwconv2.bias, stash=True)
        return x + (out - t).reshape(x.shape)


class ConvNeXtAdapter(nn.Module):
    """proj_dec (tokens -> embed_dim), preds_per_patch sub-pixels per patch
    of class_dim channels, ``depth`` ConvNeXt blocks, a 1×1 conv to the
    classes, and an upsampling to the image size."""

    def __init__(self, num_classes: int, embed_dim: int = 6144,
                 preds_per_patch: int = 16,
                 main_tasks: Tuple[str, ...] = ("bscan",),
                 patch_size: Union[int, Tuple[int, int]] = 16, depth: int = 4,
                 interpolate_mode: str = "bilinear",
                 task: Optional[str] = None, image_size=None):
        super().__init__()
        self.num_classes = num_classes
        self.embed_dim = embed_dim
        self.preds_per_patch = preds_per_patch
        self.main_tasks = tuple(main_tasks)
        self.patch_size = patch_size
        self.depth = depth
        self.interpolate_mode = interpolate_mode
        self.task = task
        self.image_size = pair(image_size)

    @property
    def class_dim(self):
        return self.embed_dim // self.preds_per_patch

    def init(self, dim_tokens_enc):
        self.proj_dec = Linear(dim_tokens_enc * len(self.main_tasks),
                               self.embed_dim, trunc_normal=True)
        self.blocks = nn.ModuleList(
            [ConvNeXtBlock(self.class_dim) for _ in range(self.depth)])
        self.final_layer = Conv2d(self.class_dim, self.num_classes, 1)
        return self

    def forward(self, encoder_tokens, input_info, deterministic=True,
                generator=None):
        """encoder_tokens (B, N + G, D) -> logits (B, classes, H, W)."""
        task = self.task or self.main_tasks[0]
        h, w = self.image_size or input_info["tasks"][task]["image_size"]
        ph, pw = pair(self.patch_size)
        nh, nw = h // ph, w // pw
        sub = int(self.preds_per_patch ** 0.5)
        x = linear(adapt_tokens(encoder_tokens, input_info, self.main_tasks),
                   self.proj_dec.weight, self.proj_dec.bias)
        b, c = x.shape[0], self.class_dim
        # (B, nh·nw, sub·sub·c) -> (B, nh·sub, nw·sub, c), channels-last
        x = x.reshape(b, nh, nw, sub, sub, c).permute(0, 1, 3, 2, 4, 5)
        x = x.reshape(b, nh * sub, nw * sub, c)
        for block in self.blocks:
            x = block(x)
        fw = self.final_layer.weight
        x = linear(x, fw.reshape(fw.shape[0], -1), self.final_layer.bias)
        return resize2d(x.permute(0, 3, 1, 2), (h, w),
                        mode=self.interpolate_mode, align_corners=False)
