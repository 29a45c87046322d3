"""Segmentation heads: output adapters for the light (unmasked) forward.

Counterpart of ``mirage_tpu/adapters/seg_heads.py`` (reference
output_adapters.py:299-762 and output_adapter_utils.py), each head keyed
like the reference state dict, so a reference checkpoint loads with
``load_state_dict`` (the keys ``seg_heads.py``'s ``params_from_torch``
reads):

- ``ConvNeXtAdapter`` (``proj_dec``, ``blocks.{i}.{dwconv,norm,pwconv1,
  pwconv2}``, ``final_layer``) runs channels-last end to end: a ConvNeXt
  block's LN + pointwise MLP over its B·H·W rows is the MLP half-block, run
  as ``mlp_block(stash=True)`` (the stash pair B9 in training, B2 without
  a gradient), whose own residual of the dwconv output t is taken back out
  (out − t) before the block input is added, as the JAX package does
  (seg_heads.py:104-110);
- ``LinearSegAdapter`` (``final_layer``): a 1×1 conv over the token grid;
- ``SegmenterMaskTransformerAdapter`` (``cls_emb``, ``proj_dec``,
  ``blocks.{i}``, ``decoder_norm``, ``patch_proj``, ``classes_proj``,
  ``mask_norm``): class tokens through transformer blocks, the port's
  ``Block``, so on the card they take the kernels ``nn/block.py`` routes
  them to (flash attention above 512 tokens);
- ``DPTOutputAdapter`` (``act_postprocess.{i}.{0,1}``,
  ``scratch.layer{i}_rn``, ``scratch.refinenet{i}``, ``head.{0,1,4}``):
  four encoder layers reassembled at four scales and fused; it takes the
  list of every block's output (``forward_light(return_all_layers=True)``).

The convolutions, transposed convolutions, batch norm and resizes are
plain PyTorch, as the JAX package leaves them to XLA.
"""

from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from mirage_tpu_torch.adapters.input_adapters import pair
from mirage_tpu_torch.nn import init as vinit
from mirage_tpu_torch.nn.block import Block
from mirage_tpu_torch.nn.conv import (BatchNorm2d, Conv2d, ConvTranspose2d,
                                      conv2d, conv2d_nhwc, conv_transpose2d)
from mirage_tpu_torch.nn.layers import (LayerNorm, Linear, dropout,
                                        layer_norm, linear)
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


class LinearSegAdapter(nn.Module):
    """A 1×1 conv from the token grid to the classes, upsampled to the image
    size (output_adapters.py:520-575)."""

    def __init__(self, num_classes: int,
                 main_tasks: Tuple[str, ...] = ("bscan",),
                 patch_size: Union[int, Tuple[int, int]] = 16,
                 interpolate_mode: str = "bilinear",
                 task: Optional[str] = None, image_size=None):
        super().__init__()
        self.num_classes = num_classes
        self.main_tasks = tuple(main_tasks)
        self.patch_size = patch_size
        self.interpolate_mode = interpolate_mode
        self.task = task
        self.image_size = pair(image_size)

    def init(self, dim_tokens_enc):
        # one task's width, as mirage_tpu/adapters/seg_heads.py:249-251
        self.final_layer = Conv2d(dim_tokens_enc, self.num_classes, 1)
        return self

    def forward(self, encoder_tokens, input_info, deterministic=True,
                generator=None):
        """encoder_tokens (B, N + G, D) -> logits (B, classes, H, W)."""
        task = self.task or self.main_tasks[0]
        h, w = self.image_size or input_info["tasks"][task]["image_size"]
        ph, pw = pair(self.patch_size)
        x = adapt_tokens(encoder_tokens, input_info, self.main_tasks)
        b, _, d = x.shape
        x = x.reshape(b, h // ph, w // pw, d).permute(0, 3, 1, 2)
        x = conv2d(x, self.final_layer.weight, self.final_layer.bias)
        return resize2d(x, (h, w), mode=self.interpolate_mode,
                        align_corners=False)


def _l2_normalize(x):
    """F.normalize(p=2, dim=-1): x / max(‖x‖, 1e-12), the norm in float."""
    norm = torch.linalg.vector_norm(x.float(), dim=-1, keepdim=True)
    return x / norm.clamp_min(1e-12).to(x.dtype)


class SegmenterMaskTransformerAdapter(nn.Module):
    """Segmenter's mask transformer (output_adapters.py:325-434): the
    projected patch tokens and ``num_classes`` learned class tokens through
    ``depth`` transformer blocks (stochastic depth linspace(0,
    drop_path_rate, depth)), then the L2-normalised patch and class
    features' products, layer-normed, as masks upsampled to the image."""

    def __init__(self, num_classes: int, depth: int = 2, num_heads: int = 12,
                 embed_dim: int = 768, mlp_ratio: float = 4.0,
                 drop_path_rate: float = 0.1, qkv_bias: bool = True,
                 main_tasks: Tuple[str, ...] = ("bscan",),
                 patch_size: Union[int, Tuple[int, int]] = 16,
                 task: str = "semseg", image_size=None):
        super().__init__()
        self.num_classes = num_classes
        self.depth = depth
        self.num_heads = num_heads
        self.embed_dim = embed_dim
        self.mlp_ratio = mlp_ratio
        self.drop_path_rate = drop_path_rate
        self.qkv_bias = qkv_bias
        self.main_tasks = tuple(main_tasks)
        self.patch_size = patch_size
        self.task = task
        self.image_size = pair(image_size)

    def init(self, dim_tokens_enc):
        e = self.embed_dim
        self.cls_emb = nn.Parameter(torch.empty(1, self.num_classes, e))
        self.proj_dec = Linear(dim_tokens_enc * len(self.main_tasks), e,
                               trunc_normal=True)
        self.blocks = nn.ModuleList(
            [Block(e, self.num_heads, self.mlp_ratio, self.qkv_bias)
             for _ in range(self.depth)])
        self.decoder_norm = LayerNorm(e)
        self.patch_proj = Linear(e, e, bias=False, trunc_normal=True)
        self.classes_proj = Linear(e, e, bias=False, trunc_normal=True)
        self.mask_norm = LayerNorm(self.num_classes)
        return self

    def init_params(self, generator):
        vinit.trunc_normal_(self.cls_emb, generator)

    def forward(self, encoder_tokens, input_info, deterministic=True,
                generator=None):
        """encoder_tokens (B, N + G, D) -> logits (B, classes, H, W)."""
        h, w = self.image_size or input_info["tasks"][self.task]["image_size"]
        ph, pw = pair(self.patch_size)
        c = self.num_classes
        x = linear(adapt_tokens(encoder_tokens, input_info, self.main_tasks),
                   self.proj_dec.weight, self.proj_dec.bias)
        b = x.shape[0]
        x = torch.cat([x, self.cls_emb.to(x.dtype).expand(
            b, c, self.embed_dim)], dim=1)
        # Python floats, as the JAX head's static rates: the first block's
        # 0.0 is statically zero (nn/block.py's routes)
        rates = np.linspace(0.0, self.drop_path_rate, self.depth)
        for block, rate in zip(self.blocks, rates):
            x = block(x, deterministic, float(rate), generator)
        x = layer_norm(x, self.decoder_norm.weight, self.decoder_norm.bias)
        patches = _l2_normalize(linear(x[:, :-c], self.patch_proj.weight))
        cls_feat = _l2_normalize(linear(x[:, -c:], self.classes_proj.weight))
        masks = layer_norm(patches @ cls_feat.transpose(1, 2),
                           self.mask_norm.weight, self.mask_norm.bias)
        masks = masks.reshape(b, h // ph, w // pw, c).permute(0, 3, 1, 2)
        return resize2d(masks, (h, w), mode="bilinear", align_corners=False)


class ResidualConvUnit(nn.Module):
    """relu → 3×3 conv [→ BN] twice, plus the input
    (output_adapter_utils.py:50-105)."""

    def __init__(self, features, use_bn):
        super().__init__()
        self.conv1 = Conv2d(features, features, 3, bias=not use_bn)
        self.conv2 = Conv2d(features, features, 3, bias=not use_bn)
        if use_bn:
            self.bn1 = BatchNorm2d(features)
            self.bn2 = BatchNorm2d(features)
        self.use_bn = use_bn

    def forward(self, x, training=False):
        out = x
        for i in (1, 2):
            conv = getattr(self, f"conv{i}")
            out = conv2d(torch.relu(out), conv.weight, conv.bias, padding=1)
            if self.use_bn:
                out = getattr(self, f"bn{i}")(out, training)
        return out + x


class FeatureFusionBlock(nn.Module):
    """[the skip's RCU added,] an RCU, a 2× bilinear upsampling
    (align_corners) and a 1×1 conv (output_adapter_utils.py:166-225)."""

    def __init__(self, features, use_bn):
        super().__init__()
        self.resConfUnit1 = ResidualConvUnit(features, use_bn)
        self.resConfUnit2 = ResidualConvUnit(features, use_bn)
        self.out_conv = Conv2d(features, features, 1)

    def forward(self, x, res=None, training=False):
        if res is not None:
            x = x + self.resConfUnit1(res, training)
        x = self.resConfUnit2(x, training)
        x = resize2d(x, (x.shape[-2] * 2, x.shape[-1] * 2), mode="bilinear",
                     align_corners=True)
        return conv2d(x, self.out_conv.weight, self.out_conv.bias)


class DPTOutputAdapter(nn.Module):
    """DPT (output_adapters.py:578-762): the tokens of encoder layers
    ``hooks`` reassembled at 4×, 2×, 1× and ½× the token grid (a 1×1
    projection, then a transposed conv up or a strided conv down), each
    brought to ``feature_dim`` by a 3×3 conv, fused from the coarsest up,
    and a semseg (or regression) head at 2× the finest scale. Batch norm
    (``use_bn``) normalises with the batch's statistics when ``training``.
    """

    def __init__(self, num_classes: int = 3, stride_level: int = 1,
                 patch_size: Union[int, Tuple[int, int]] = 16,
                 main_tasks: Tuple[str, ...] = ("bscan",),
                 hooks: Tuple[int, ...] = (2, 5, 8, 11),
                 layer_dims: Tuple[int, ...] = (96, 192, 384, 768),
                 feature_dim: int = 256, use_bn: bool = False,
                 head_type: str = "semseg", task: str = "semseg",
                 image_size=None):
        super().__init__()
        if head_type not in ("semseg", "regression"):
            raise ValueError('DPT head_type must be "regression" or '
                             '"semseg".')
        self.num_classes = num_classes
        self.stride_level = stride_level
        self.patch_size = patch_size
        self.main_tasks = tuple(main_tasks)
        self.hooks = tuple(hooks)
        self.layer_dims = tuple(layer_dims)
        self.feature_dim = feature_dim
        self.use_bn = use_bn
        self.head_type = head_type
        self.task = task
        self.image_size = pair(image_size)

    def init(self, dim_tokens_enc):
        in_ch = dim_tokens_enc * len(self.main_tasks)
        d, f = self.layer_dims, self.feature_dim
        self.act_postprocess = nn.ModuleList([
            nn.ModuleList([Conv2d(in_ch, d[0], 1),
                           ConvTranspose2d(d[0], d[0], 4)]),
            nn.ModuleList([Conv2d(in_ch, d[1], 1),
                           ConvTranspose2d(d[1], d[1], 2)]),
            nn.ModuleList([Conv2d(in_ch, d[2], 1)]),
            nn.ModuleList([Conv2d(in_ch, d[3], 1), Conv2d(d[3], d[3], 3)])])
        self.scratch = nn.Module()
        for i in range(4):
            setattr(self.scratch, f"layer{i + 1}_rn",
                    Conv2d(d[i], f, 3, bias=False))
            setattr(self.scratch, f"refinenet{i + 1}",
                    FeatureFusionBlock(f, self.use_bn))
        if self.head_type == "semseg":
            head = {"0": Conv2d(f, f, 3, bias=False),
                    "4": Conv2d(f, self.num_classes, 1)}
            if self.use_bn:
                head["1"] = BatchNorm2d(f)
        else:
            head = {"0": Conv2d(f, f // 2, 3), "2": Conv2d(f // 2, 32, 3),
                    "4": Conv2d(32, self.num_classes, 1)}
        self.head = nn.ModuleDict(head)
        return self

    def forward(self, encoder_tokens, input_info, deterministic=True,
                generator=None, training=False):
        """encoder_tokens: the list of every block's (B, N + G, D) output
        -> (B, classes, H, W). Dropout (0.1) before the semseg head's last
        conv when not ``deterministic``, drawn from ``generator`` (none
        without one, as the JAX head without an rng)."""
        h, w = self.image_size or input_info["tasks"][self.task]["image_size"]
        ph, pw = pair(self.patch_size)
        ph = max(1, ph // self.stride_level)
        pw = max(1, pw // self.stride_level)
        nh = h // (self.stride_level * ph)
        nw = w // (self.stride_level * pw)
        layers = []
        for k in self.hooks:
            t = adapt_tokens(encoder_tokens[k], input_info, self.main_tasks)
            layers.append(t.reshape(t.shape[0], nh, nw, -1).permute(
                0, 3, 1, 2))
        act = self.act_postprocess

        def proj(i):
            return conv2d(layers[i], act[i][0].weight, act[i][0].bias)

        layers = [
            conv_transpose2d(proj(0), act[0][1].weight, act[0][1].bias,
                             stride=4),
            conv_transpose2d(proj(1), act[1][1].weight, act[1][1].bias,
                             stride=2),
            proj(2),
            conv2d(proj(3), act[3][1].weight, act[3][1].bias, stride=2,
                   padding=1)]
        sc = self.scratch
        layers = [conv2d(x, getattr(sc, f"layer{i + 1}_rn").weight,
                         padding=1) for i, x in enumerate(layers)]
        path = sc.refinenet4(layers[3], training=training)
        for i in (2, 1, 0):
            path = getattr(sc, f"refinenet{i + 1}")(path, layers[i],
                                                      training=training)
        hd = self.head
        out = conv2d(path, hd["0"].weight, hd["0"].bias, padding=1)
        if self.head_type == "semseg":
            if "1" in hd:
                out = hd["1"](out, training)
            out = torch.relu(out)
            if not deterministic and generator is not None:
                out = dropout(out, 0.1, deterministic=False,
                              generator=generator)
            out = conv2d(out, hd["4"].weight, hd["4"].bias)
            return resize2d(out, (out.shape[-2] * 2, out.shape[-1] * 2),
                            mode="bilinear", align_corners=True)
        out = resize2d(out, (out.shape[-2] * 2, out.shape[-1] * 2),
                       mode="bilinear", align_corners=True)
        out = torch.relu(conv2d(out, hd["2"].weight, hd["2"].bias,
                                padding=1))
        return conv2d(out, hd["4"].weight, hd["4"].bias)
