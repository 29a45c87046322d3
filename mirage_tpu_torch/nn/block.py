"""Pre-LN transformer block.

x = x + proj(attn(LN1(x))); x = x + fc2(GELU(fc1(LN2(x)))). Counterpart of
``mirage_tpu/nn/block.py:block_apply``, route for route (the routing decides
which rounding the port has to match):

- inference (``deterministic``), or training at N ≤ 128: each half one op,
  ``attn_half_block`` (B1, backward B4) and ``mlp_block`` (B2, backward B5);
- training at N > 128 (the decoders' 256 tokens): LN → ``attention_apply``
  (qkv projection, ``block_attention`` B6, output projection) → residual,
  then ``mlp_block``.

Dropout and drop-path are statically zero in every configuration the port
runs, so they are identities here (the JAX package's fused routes require
that too); the tensor-parallel branch comes with the multi-GPU slice.
"""

from torch import nn

from mirage_tpu_torch.nn.attention import Attention, attention_apply
from mirage_tpu_torch.nn.layers import LayerNorm, Mlp, layer_norm
from mirage_tpu_torch.ops.block_attention import attn_half_block
from mirage_tpu_torch.ops.fused_mlp import mlp_block

# training fuses the attention half only up to this many tokens
# (mirage_tpu/nn/block.py:77-82)
FUSED_TRAIN_TOKENS = 128


class Block(nn.Module):
    def __init__(self, dim, num_heads, mlp_ratio=4.0, qkv_bias=False):
        super().__init__()
        self.num_heads = num_heads
        self.norm1 = LayerNorm(dim)
        self.attn = Attention(dim, qkv_bias=qkv_bias)
        self.norm2 = LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x, deterministic=True):
        a, m = self.attn, self.mlp
        if deterministic or x.shape[1] <= FUSED_TRAIN_TOKENS:
            x = attn_half_block(x, self.norm1.weight, self.norm1.bias,
                                a.qkv.weight, a.qkv.bias, a.proj.weight,
                                a.proj.bias, self.num_heads)
        else:
            x = x + attention_apply(
                a, layer_norm(x, self.norm1.weight, self.norm1.bias),
                self.num_heads)
        return mlp_block(x, self.norm2.weight, self.norm2.bias, m.fc1.weight,
                         m.fc1.bias, m.fc2.weight, m.fc2.bias)
