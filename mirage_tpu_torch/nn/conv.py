"""2-D convolutions with torch layouts: weights (O, I/groups, kH, kW).

Counterpart of ``mirage_tpu/nn/conv.py`` (``conv2d``, ``conv2d_nhwc``,
``conv2d_init``): the ConvNeXt head's 7×7 depthwise conv and its 1×1 head
conv. The convolution itself is ``F.conv2d`` (cuDNN on the card), as the
JAX package leaves it to XLA; ``conv2d_nhwc`` runs it on a channels-last
(B, H, W, C) tensor as a channels-last view, so no layout copy is made on
the card. The transposed conv and batch norm of the DPT head come with it.
"""

import math

import torch
import torch.nn.functional as F
from torch import nn


def _pair(v):
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v)


def conv2d_init_(weight, bias, generator):
    """torch Conv2d's default init, as mirage_tpu/nn/conv.py:conv2d_init:
    U(±1/√fan_in) for the weight and the bias."""
    fan_in = weight[0].numel()
    bound = 1.0 / math.sqrt(fan_in)
    with torch.no_grad():
        weight.uniform_(-bound, bound, generator=generator)
        if bias is not None:
            bias.uniform_(-bound, bound, generator=generator)


def conv2d(x, weight, bias=None, *, stride=1, padding=0, groups=1,
           dilation=1, channels_last=False):
    """x: (B, C, H, W), or (B, H, W, C) with channels_last; the weight and
    bias are cast to x's dtype."""
    if channels_last:
        x = x.permute(0, 3, 1, 2)
    y = F.conv2d(x, weight.to(x.dtype),
                 None if bias is None else bias.to(x.dtype),
                 stride=_pair(stride), padding=_pair(padding),
                 dilation=_pair(dilation), groups=groups)
    return y.permute(0, 2, 3, 1) if channels_last else y


def conv2d_nhwc(x, weight, bias=None, **kwargs):
    """Channels-last conv2d: x (B, H, W, C) -> (B, H', W', O)."""
    return conv2d(x, weight, bias, channels_last=True, **kwargs)


class Conv2d(nn.Module):
    """Parameter holder with torch Conv2d's keys (``weight``, ``bias``)."""

    def __init__(self, in_channels, out_channels, kernel_size, groups=1,
                 bias=True):
        super().__init__()
        kh, kw = _pair(kernel_size)
        self.groups = groups
        self.weight = nn.Parameter(
            torch.empty(out_channels, in_channels // groups, kh, kw))
        self.bias = nn.Parameter(torch.empty(out_channels)) if bias else None

    def init_params(self, generator):
        conv2d_init_(self.weight, self.bias, generator)
