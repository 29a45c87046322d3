"""ViT encoder: ``encoder.{i}`` blocks run in a Python loop.

Counterpart of ``mirage_tpu/models/encoder.py`` (a ``lax.scan`` over stacked
layers there); the unstacked ``nn.ModuleList`` keeps the reference's
``encoder.{i}.*`` state-dict keys. No ``torch.utils.checkpoint``: the
blocks' ops save only their inputs and recompute the rest in the backward,
which is what the JAX package's ``jax.checkpoint`` with
``save_only_these_names("attn_half_out")`` achieves.

Stochastic depth: block i drops its branches at ``linspace(0, rate,
depth)[i]`` (models/encoder.py:29-31), drawn from the caller's generator.
"""

import torch
from torch import nn

from mirage_tpu_torch.nn.block import Block


def drop_path_rates(drop_path_rate: float, depth: int):
    """Per-layer rates: 0-d tensors when the rate is non-zero (the JAX
    scan's traced rates, which keep every block off the routes that need a
    statically zero rate), the float 0.0 otherwise."""
    if drop_path_rate == 0.0:
        return [0.0] * depth
    return list(torch.linspace(0.0, drop_path_rate, depth))


class Encoder(nn.ModuleList):
    def __init__(self, depth, dim, num_heads, mlp_ratio=4.0, qkv_bias=True):
        super().__init__([Block(dim, num_heads, mlp_ratio, qkv_bias)
                          for _ in range(depth)])

    def forward(self, x, deterministic=True, drop_path_rate=0.0,
                generator=None, grad_free=False):
        for block, rate in zip(self, drop_path_rates(drop_path_rate,
                                                     len(self))):
            x = block(x, deterministic, rate, generator, grad_free)
        return x
