"""LayerNorm and the dense product as differentiable ops on their kernels.

The tensor-parallel block (``nn/block.py:Block.tp_forward``) runs its
attention branch as the JAX package's ``_tp_block_apply`` does
(mirage_tpu/nn/block.py:189-206): LayerNorm, the qkv product at 3·D/t
columns, the attention core on H/t heads (``block_attention``, B6), the proj
product at D/t input columns with no bias and no residual. Where the JAX
package leaves the LayerNorm and the two products to XLA, the port runs
them here on its own kernels:

- ``layer_norm``: csrc/layernorm.cu forward; backward from the float
  cotangent, dgamma and dbeta finished by the kernel (``runtime.
  layernorm_bwd``);
- ``linear``: csrc/gemm.cu (x · Wᵀ + b); backward dx = T(g · W) on
  csrc/mlp_bwd.cu's dyln product (W read as it lies), dW = gᵀ·x and db =
  Σ g in float outside, as B4 leaves its weight gradients.

Each op saves its inputs. On a CPU tensor both are the plain versions
(``nn/layers.py``), differentiated by autograd.
"""

import torch

from mirage_tpu_torch.nn import layers
from mirage_tpu_torch.ops import runtime


class _LayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b):
        x2 = x.reshape(-1, x.shape[-1])
        ctx.save_for_backward(x2, w)
        ctx.shape = x.shape
        return runtime.layernorm(x2, w, b).view(x.shape)

    @staticmethod
    def backward(ctx, dy):
        x2, w = ctx.saved_tensors
        dyln = dy.reshape(x2.shape).float().contiguous()
        dx, dgamma, dbeta = runtime.layernorm_bwd(x2, w, dyln)
        return dx.view(ctx.shape), dgamma, dbeta


def layer_norm(x, w, b):
    """LayerNorm (eps 1e-6, float statistics) over the last axis of x, in
    x's dtype; differentiable."""
    if not runtime.use_kernel(x):
        return layers.layer_norm(x, w, b)
    return _LayerNorm.apply(x.contiguous(), w, b)


class _Linear(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b):
        x2 = x.reshape(-1, x.shape[-1])
        ctx.save_for_backward(x2, w)
        ctx.shape, ctx.has_bias = x.shape, b is not None
        y = runtime.gemm(x2, w.to(x.dtype).contiguous(), b)
        return y.view(*x.shape[:-1], w.shape[0])

    @staticmethod
    def backward(ctx, dy):
        x2, w = ctx.saved_tensors
        g2 = dy.reshape(-1, w.shape[0]).contiguous()
        dx = runtime.mlp_bwd_dyln(g2, w.to(x2.dtype).contiguous(),
                                  out_dtype=x2.dtype)
        db = g2.float().sum(0) if ctx.has_bias else None
        return dx.view(ctx.shape), runtime.wgrad(g2, x2), db


def linear(x, w, b=None):
    """x · wᵀ (+ b) for w (N, K) in torch Linear layout, in x's dtype;
    differentiable."""
    if not runtime.use_kernel(x):
        return layers.linear(x, w, b)
    return _Linear.apply(x.contiguous(), w, b)
