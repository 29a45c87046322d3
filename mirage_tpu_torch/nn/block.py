"""Pre-LN transformer block.

x = x + drop_path(proj(attn(LN1(x)))); x = x + drop_path(fc2(GELU(fc1(LN2(x))))).
Counterpart of ``mirage_tpu/nn/block.py:block_apply``, route for route (the
routing decides which rounding the port has to match, and which kernels a
path launches):

- (a) up to 512 tokens, inference (``deterministic``) or, with the
  regularisers statically zero, training at up to 128 tokens or grad-free:
  each half one op, ``attn_half_block`` (B1, backward B4) and ``mlp_block``
  (B2, backward B5);
- (b) otherwise LN → ``attention_apply`` (qkv projection, the packed
  ``block_attention`` B6 up to 512 tokens, ``flash_attention`` B8 above,
  output projection) → ``x + drop_path(h)``; then the MLP half as
  ``mlp_block`` when deterministic or drop-path is statically zero, as
  ``mlp_block(residual=False)`` plus drop-path when grad-free or at up to
  512 tokens, and as LN + the plain MLP + drop-path otherwise.

A drop-path rate is "statically zero" only as the float 0.0: the encoder
passes 0-d tensors (``torch.linspace``) whenever its rate is non-zero, as
the JAX scan threads traced per-layer rates (models/encoder.py:82-83), so
then even layer 0 at rate 0.0 routes as stochastic. Dropout is zero in
every configuration; the tensor-parallel branch comes with the multi-GPU
slice.
"""

from torch import nn

from mirage_tpu_torch.nn.attention import Attention, attention_apply
from mirage_tpu_torch.nn.layers import LayerNorm, Mlp, drop_path, layer_norm
from mirage_tpu_torch.ops.block_attention import attn_half_block
from mirage_tpu_torch.ops.fused_mlp import mlp_block, mlp_block_ref

# the fused routes hold up to this many tokens; training fuses the
# attention half only up to FUSED_TRAIN_TOKENS (mirage_tpu/nn/block.py:77-82)
FUSED_TOKENS = 512
FUSED_TRAIN_TOKENS = 128


class Block(nn.Module):
    def __init__(self, dim, num_heads, mlp_ratio=4.0, qkv_bias=False):
        super().__init__()
        self.num_heads = num_heads
        self.norm1 = LayerNorm(dim)
        self.attn = Attention(dim, qkv_bias=qkv_bias)
        self.norm2 = LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x, deterministic=True, drop_path_rate=0.0,
                generator=None, grad_free=False):
        a, m, n = self.attn, self.mlp, x.shape[1]
        mlp = (self.norm2.weight, self.norm2.bias, m.fc1.weight, m.fc1.bias,
               m.fc2.weight, m.fc2.bias)
        static_zero = (isinstance(drop_path_rate, (int, float))
                       and drop_path_rate == 0.0)
        if n <= FUSED_TOKENS and (deterministic or (
                static_zero and (n <= FUSED_TRAIN_TOKENS or grad_free))):
            x = attn_half_block(x, self.norm1.weight, self.norm1.bias,
                                a.qkv.weight, a.qkv.bias, a.proj.weight,
                                a.proj.bias, self.num_heads)
            return mlp_block(x, *mlp)
        h = attention_apply(
            a, layer_norm(x, self.norm1.weight, self.norm1.bias),
            self.num_heads)
        x = x + drop_path(h, drop_path_rate, deterministic=deterministic,
                          generator=generator)
        if deterministic or static_zero:
            return mlp_block(x, *mlp)
        if grad_free or n <= FUSED_TOKENS:
            h = mlp_block(x, *mlp, residual=False)
        else:
            h = mlp_block_ref(x, *mlp, residual=False)
        return x + drop_path(h, drop_path_rate, deterministic=deterministic,
                             generator=generator)
