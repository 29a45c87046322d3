"""ViT encoder: ``encoder.{i}`` blocks run in a Python loop.

Counterpart of ``mirage_tpu/models/encoder.py`` (a ``lax.scan`` over stacked
layers there); the unstacked ``nn.ModuleList`` keeps the reference's
``encoder.{i}.*`` state-dict keys.

Rematerialisation (``remat``, mirage_tpu/models/encoder.py:93-101). The JAX
package's ``jax.checkpoint`` saves only the inter-half activation on the
fused route and recomputes each half's internals in its backward; off that
route it is plain per-layer remat. Here the two half-block ops (route (a) of
``nn/block.py``) already save only their inputs and recompute the rest, so
a block on that route runs as it is: checkpointing it would rerun both
halves' forwards for no memory. A block on any other route, whose ops save
their intermediates, runs under ``torch.utils.checkpoint`` when training
with ``remat``; its drop-path draws are made before the checkpointed call
and passed in, since the rerun must not draw from the generator again.

Stochastic depth: block i drops its branches at ``linspace(0, rate,
depth)[i]`` (models/encoder.py:29-31), drawn from the caller's generator.
``return_layers`` (models/encoder.py:50) also hands back the output of
each listed block, which the DPT head reads.

Tensor parallelism (``tp``, mirage_tpu/models/mirage.py:61-68): a (group,
t) pair routes every block to its tensor-parallel form
(``nn/block.py:Block.tp_forward``); ``train/steps.py:shard_state`` sets it
when it cuts the blocks' weights to their tensor-local shards. A
tensor-parallel block saves its ops' intermediates, so under ``remat`` it
runs checkpointed (its all-reduces rerun in the backward on every tensor
rank alike).

Pipeline parallelism (``pp``, mirage_tpu/models/mirage.py:69-95): a
("pipe", n_micro) pair routes the stack through the GPipe schedule of
``parallel/pp.py:pp_encoder_apply``; ``train/steps.py:shard_state`` keeps
only the stage's blocks (the others' slots hold None, so the kept ones
keep their global ``encoder.{i}`` names) and binds ``pipe``, the stage's
place in its pipeline. Without ``pipe`` (or with one stage) the flag is
the plain loop over every block held. It needs a drop-path rate of 0 and
refuses ``return_layers``.
"""

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from mirage_tpu_torch.nn.block import Block
from mirage_tpu_torch.nn.layers import drop_path_noise


def drop_path_rates(drop_path_rate: float, depth: int):
    """Per-layer rates: 0-d tensors when the rate is non-zero (the JAX
    scan's traced rates, which keep every block off the routes that need a
    statically zero rate), the float 0.0 otherwise."""
    if drop_path_rate == 0.0:
        return [0.0] * depth
    return list(torch.linspace(0.0, drop_path_rate, depth))


class Encoder(nn.ModuleList):
    def __init__(self, depth, dim, num_heads, mlp_ratio=4.0, qkv_bias=True,
                 remat=False):
        super().__init__([Block(dim, num_heads, mlp_ratio, qkv_bias)
                          for _ in range(depth)])
        self.remat = remat
        self.pp = None
        self.pipe = None

    @property
    def tp(self):
        blocks = [b for b in self if b is not None]
        return blocks[0].tp if blocks else None

    @tp.setter
    def tp(self, value):
        for block in self:
            if block is not None:
                block.tp = value

    def block_step(self, block, x, deterministic, rate, generator,
                   grad_free):
        """One block, checkpointed under ``remat`` when its ops save their
        intermediates."""
        if not (self.remat and torch.is_grad_enabled() and not grad_free
                and not (block.tp is None and Block.halves_route(
                    x.shape[1], deterministic, rate, grad_free))):
            return block(x, deterministic, rate, generator, grad_free)
        noise = (None, None)
        if not deterministic and float(rate) != 0.0 \
                and generator is not None:
            noise = (drop_path_noise(x, generator),
                     drop_path_noise(x, generator))
        return checkpoint(block, x, deterministic, rate, None, grad_free,
                          noise, use_reentrant=False)

    def forward(self, x, deterministic=True, drop_path_rate=0.0,
                generator=None, grad_free=False, return_layers=None,
                n_micro=None):
        """The blocks' output, or with ``return_layers`` (block indices)
        (output, {i: block i's output}); ``n_micro``: this call's
        microbatches under ``pp`` (default: ``pp``'s)."""
        if self.pp is not None:
            from mirage_tpu_torch.parallel.pp import pp_encoder_apply

            if return_layers is not None:
                raise ValueError("return_all_layers is not supported under "
                                 "pipeline parallelism")
            if drop_path_rate != 0.0:
                raise ValueError("pipeline parallelism requires "
                                 "drop_path_rate == 0.0 (parallel/pp.py "
                                 "scope note)")
            return pp_encoder_apply(self, x, deterministic, grad_free,
                                    n_micro)
        outs = {}
        for i, (block, rate) in enumerate(zip(
                self, drop_path_rates(drop_path_rate, len(self)))):
            x = self.block_step(block, x, deterministic, rate, generator,
                                grad_free)
            if return_layers is not None and i in return_layers:
                outs[i] = x
        return x if return_layers is None else (x, outs)
