"""ViT encoder: ``encoder.{i}`` blocks run in a Python loop.

Counterpart of ``mirage_tpu/models/encoder.py`` (a ``lax.scan`` over stacked
layers there); the unstacked ``nn.ModuleList`` keeps the reference's
``encoder.{i}.*`` state-dict keys. No ``torch.utils.checkpoint``: the
blocks' ops save only their inputs and recompute the rest in the backward,
which is what the JAX package's ``jax.checkpoint`` with
``save_only_these_names("attn_half_out")`` achieves.
"""

from torch import nn

from mirage_tpu_torch.nn.block import Block


class Encoder(nn.ModuleList):
    def __init__(self, depth, dim, num_heads, mlp_ratio=4.0, qkv_bias=True):
        super().__init__([Block(dim, num_heads, mlp_ratio, qkv_bias)
                          for _ in range(depth)])

    def forward(self, x, deterministic=True):
        for block in self:
            x = block(x, deterministic)
        return x
