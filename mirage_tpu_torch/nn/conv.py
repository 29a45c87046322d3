"""2-D convolutions with torch layouts: weights (O, I/groups, kH, kW), and
(I, O, kH, kW) for the transposed convolution; 2-D batch norm.

Counterpart of ``mirage_tpu/nn/conv.py`` (``conv2d``, ``conv2d_nhwc``,
``conv_transpose2d``, ``batch_norm2d`` and their inits): the ConvNeXt
head's 7×7 depthwise conv and 1×1 head conv, the linear head's 1×1 conv,
and the DPT head's reassemble, fusion and head convs. The convolutions
themselves are ``F.conv2d`` / ``F.conv_transpose2d`` (cuDNN on the card),
as the JAX package leaves them to XLA; ``conv2d_nhwc`` runs a conv on a
channels-last (B, H, W, C) tensor as a channels-last view, so no layout
copy is made on the card.
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


def conv_transpose2d(x, weight, bias=None, *, stride=1, padding=0):
    """torch ConvTranspose2d (output_padding 0, groups 1): x (B, I, H, W),
    weight (I, O, kH, kW), both cast to x's dtype."""
    return F.conv_transpose2d(x, weight.to(x.dtype),
                              None if bias is None else bias.to(x.dtype),
                              stride=_pair(stride), padding=_pair(padding))


def batch_norm2d(x, weight, bias, running_mean, running_var, *,
                 training=False, eps=1e-5, momentum=0.1):
    """(y, new_mean, new_var) of x (B, C, H, W), as
    mirage_tpu/nn/conv.py:batch_norm2d: in training, normalised with the
    batch's float32 statistics over (B, H, W), and the running statistics
    moved by ``momentum`` toward the batch mean and the unbiased batch
    variance; otherwise normalised with the running statistics, which come
    back unchanged. y is in x's dtype."""
    x32 = x.float()
    if training:
        mean = x32.mean(dim=(0, 2, 3))
        var = x32.var(dim=(0, 2, 3), unbiased=False)
        n = x.shape[0] * x.shape[2] * x.shape[3]
        new_mean = (1 - momentum) * running_mean + momentum * mean
        new_var = (1 - momentum) * running_var \
            + momentum * var * n / max(n - 1, 1)
    else:
        mean, var = running_mean, running_var
        new_mean, new_var = running_mean, running_var
    y = (x32 - mean.reshape(1, -1, 1, 1)) \
        * torch.rsqrt(var.reshape(1, -1, 1, 1) + eps)
    y = y * weight.float().reshape(1, -1, 1, 1) \
        + bias.float().reshape(1, -1, 1, 1)
    return y.to(x.dtype), new_mean, new_var


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


class ConvTranspose2d(nn.Module):
    """Parameter holder with torch ConvTranspose2d's keys: ``weight`` (I, O,
    kH, kW) and ``bias``; U(±1/√(O·kH·kW)) as
    mirage_tpu/nn/conv.py:conv_transpose2d_init."""

    def __init__(self, in_channels, out_channels, kernel_size, bias=True):
        super().__init__()
        kh, kw = _pair(kernel_size)
        self.weight = nn.Parameter(
            torch.empty(in_channels, out_channels, kh, kw))
        self.bias = nn.Parameter(torch.empty(out_channels)) if bias else None

    def init_params(self, generator):
        conv2d_init_(self.weight, self.bias, generator)


class BatchNorm2d(nn.Module):
    """torch BatchNorm2d's keys: ``weight``, ``bias`` and the running
    statistics as buffers. ``forward(x, training)``: in training the batch's
    statistics normalise x and the buffers take the new running statistics
    (torch's BatchNorm2d; the JAX package's DPT head drops what its
    batch_norm2d returns, and no configuration trains with batch norm)."""

    def __init__(self, num_features):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(num_features))
        self.bias = nn.Parameter(torch.empty(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def init_params(self, generator):
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)

    def forward(self, x, training=False):
        y, mean, var = batch_norm2d(x, self.weight, self.bias,
                                    self.running_mean, self.running_var,
                                    training=training)
        if training:
            with torch.no_grad():
                self.running_mean.copy_(mean)
                self.running_var.copy_(var)
        return y
