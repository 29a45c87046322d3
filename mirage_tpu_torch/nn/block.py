"""Pre-LN transformer block.

x = x + drop_path(proj(attn(LN1(x)))); x = x + drop_path(fc2(GELU(fc1(LN2(x))))).
Counterpart of ``mirage_tpu/nn/block.py:block_apply``, route for route (the
routing decides which rounding the port has to match, and which kernels a
path launches):

- (a) up to 512 tokens, inference (``deterministic``) or, with the
  regularisers statically zero, training at up to 128 tokens or grad-free:
  each half one op, ``attn_half_block`` (B1, backward B4) and ``mlp_block``
  (B2, backward B5); a deterministic call under ``MIRAGE_BLOCK_FUSE=all``,
  or ``decoder`` at width ≤ 256, is instead one ``fused_block`` (B10,
  mirage_tpu/nn/block.py:93-101): its backward is autograd through the plain
  version, so training and grad-free probes keep the halves;
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
every configuration.

A block with ``tp`` set (a (group, t) pair, by ``train/steps.py:
shard_state``) holds tensor-local weights and runs :meth:`Block.tp_forward`,
the counterpart of ``mirage_tpu/nn/block.py:_tp_block_apply``.
"""

import torch
from torch import nn

from mirage_tpu_torch.nn.attention import Attention, attention_apply
from mirage_tpu_torch.nn.layers import LayerNorm, Mlp, drop_path, layer_norm
from mirage_tpu_torch.ops import linear as dense
from mirage_tpu_torch.ops import runtime
from mirage_tpu_torch.ops.block_attention import (attn_half_block,
                                                  block_attention)
from mirage_tpu_torch.ops.flash_attention import flash_attention
from mirage_tpu_torch.ops.fused_block import fused_block
from mirage_tpu_torch.ops.fused_mlp import mlp_block, mlp_block_ref

# the fused routes hold up to this many tokens; training fuses the
# attention half only up to FUSED_TRAIN_TOKENS (mirage_tpu/nn/block.py:77-82)
FUSED_TOKENS = 512
FUSED_TRAIN_TOKENS = 128
# MIRAGE_BLOCK_FUSE=decoder routes blocks up to this width (the decoders')
BLOCK_FUSE_DECODER_DIM = 256


class Block(nn.Module):
    def __init__(self, dim, num_heads, mlp_ratio=4.0, qkv_bias=False):
        super().__init__()
        self.num_heads = num_heads
        self.norm1 = LayerNorm(dim)
        self.attn = Attention(dim, qkv_bias=qkv_bias)
        self.norm2 = LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        self.tp = None

    @staticmethod
    def halves_route(n, deterministic, drop_path_rate, grad_free):
        """Whether the block runs as the two half-block ops (route (a)),
        whose autograd Functions save only their inputs."""
        static_zero = (isinstance(drop_path_rate, (int, float))
                       and drop_path_rate == 0.0)
        return n <= FUSED_TOKENS and (deterministic or (
            static_zero and (n <= FUSED_TRAIN_TOKENS or grad_free)))

    def forward(self, x, deterministic=True, drop_path_rate=0.0,
                generator=None, grad_free=False, noise=(None, None)):
        """``noise``: the attention and MLP branches' drop-path draws made
        beforehand (a block rerun under activation checkpointing must
        not draw again)."""
        if self.tp is not None:
            return self.tp_forward(x, deterministic, drop_path_rate,
                                   generator, grad_free, noise)
        a, m, n = self.attn, self.mlp, x.shape[1]
        mlp = (self.norm2.weight, self.norm2.bias, m.fc1.weight, m.fc1.bias,
               m.fc2.weight, m.fc2.bias)
        static_zero = (isinstance(drop_path_rate, (int, float))
                       and drop_path_rate == 0.0)
        if self.halves_route(n, deterministic, drop_path_rate, grad_free):
            fuse = runtime.switches["MIRAGE_BLOCK_FUSE"]
            if deterministic and (fuse == "all" or (
                    fuse == "decoder"
                    and x.shape[-1] <= BLOCK_FUSE_DECODER_DIM)):
                return fused_block(x, self.norm1.weight, self.norm1.bias,
                                   a.qkv.weight, a.qkv.bias, a.proj.weight,
                                   a.proj.bias, *mlp, self.num_heads)
            x = attn_half_block(x, self.norm1.weight, self.norm1.bias,
                                a.qkv.weight, a.qkv.bias, a.proj.weight,
                                a.proj.bias, self.num_heads)
            return mlp_block(x, *mlp)
        h = attention_apply(
            a, layer_norm(x, self.norm1.weight, self.norm1.bias),
            self.num_heads)
        x = x + drop_path(h, drop_path_rate, deterministic=deterministic,
                          generator=generator, noise=noise[0])
        if deterministic or static_zero:
            return mlp_block(x, *mlp)
        if grad_free or n <= FUSED_TOKENS:
            h = mlp_block(x, *mlp, residual=False)
        else:
            h = mlp_block_ref(x, *mlp, residual=False)
        return x + drop_path(h, drop_path_rate, deterministic=deterministic,
                             generator=generator, noise=noise[1])

    def tp_forward(self, x, deterministic=True, drop_path_rate=0.0,
                   generator=None, grad_free=False, noise=(None, None)):
        """The tensor-parallel block (mirage_tpu/nn/block.py:154-226) on
        this process's weights: H/t heads' qkv rows and proj columns, the
        MLP's hidden/t fc1 rows and fc2 columns (``parallel/tp.py``).

        The attention branch is LN (the LN kernel), the qkv product at
        3·D/t columns (the GEMM), the attention core on H/t heads (B6 up to
        512 tokens, B8 above) and the proj product with no bias and no
        residual, then the all-reduce and the proj bias; the MLP branch is
        ``mlp_block(residual=False)`` (B2, backward B5) with a zero fc2
        bias, then the all-reduce and the fc2 bias. Drop-path scales each
        completed branch with the generator every tensor rank shares."""
        from mirage_tpu_torch.parallel.tp import ident_f, psum_g

        group, t = self.tp
        a, m, n = self.attn, self.mlp, x.shape[1]
        heads = self.num_heads // t
        assert heads * t == self.num_heads
        h = dense.layer_norm(ident_f(x, group), self.norm1.weight,
                             self.norm1.bias)
        qkv = dense.linear(h, a.qkv.weight, a.qkv.bias)
        dh = qkv.shape[-1] // 3 // heads
        if n <= FUSED_TOKENS:
            out = block_attention(qkv, heads, dh ** -0.5)
        else:
            out = flash_attention(qkv, num_heads=heads, scale=dh ** -0.5)
        part = dense.linear(out, a.proj.weight)
        h = psum_g(part, group) + a.proj.bias.to(part.dtype)
        x = x + drop_path(h, drop_path_rate, deterministic=deterministic,
                          generator=generator, noise=noise[0])
        mlp = (self.norm2.weight, self.norm2.bias, m.fc1.weight, m.fc1.bias,
               m.fc2.weight, torch.zeros_like(m.fc2.bias))
        xf = ident_f(x, group)
        if grad_free or n <= FUSED_TOKENS:
            part = mlp_block(xf, *mlp, residual=False)
        else:
            part = mlp_block_ref(xf, *mlp, residual=False)
        h = psum_g(part, group) + m.fc2.bias.to(part.dtype)
        return x + drop_path(h, drop_path_rate, deterministic=deterministic,
                             generator=generator, noise=noise[1])
