"""Linear, LayerNorm (eps 1e-6), exact-erf GELU, dropout and drop-path.

``Linear`` and ``LayerNorm`` hold their parameters as ``weight``/``bias``
like ``torch.nn.Linear``/``LayerNorm``, so reference checkpoints load with
``load_state_dict``; they allocate without drawing random numbers and are
initialised by :func:`mirage_tpu_torch.nn.init.init_weights` from an
explicit generator. Counterpart of ``mirage_tpu/nn/layers.py``.

``linear`` and ``layer_norm`` also take a task stack (``ops/tasks.py``): a
weight (T, out, in) or (T, D) with a leading task axis over x whose leading
batch is T·B, each task's rows with its own weights (a batched product,
as jax.vmap makes of the JAX package's products).
"""

import math

import torch
import torch.nn.functional as F
from torch import nn

from mirage_tpu_torch.nn import init as vinit

LN_EPS = 1e-6


def acc_dtype(t):
    """The type sums are taken in: float64 stays float64 (the gradient
    checks), everything else is float32."""
    return torch.float64 if t.dtype == torch.float64 else torch.float32


def gelu(x):
    """Exact (erf) GELU."""
    return F.gelu(x, approximate="none")


def linear(x, weight, bias=None):
    """x · weightᵀ + bias in x's dtype; weight is (out, in), or a task
    stack (T, out, in) (bias (T, out)) over x's leading batch T·B."""
    if weight.ndim == 3:
        tasks, n, k = weight.shape
        xt = x.reshape(tasks, -1, k)
        w = weight.to(x.dtype).transpose(1, 2)
        y = (torch.bmm(xt, w) if bias is None else
             torch.baddbmm(bias.to(x.dtype).unsqueeze(1), xt, w))
        return y.reshape(*x.shape[:-1], n)
    return F.linear(x, weight.to(x.dtype),
                    None if bias is None else bias.to(x.dtype))


def layer_norm(x, weight, bias, eps=LN_EPS):
    """LayerNorm with float statistics, output in x's dtype; weight and
    bias (D,), or a task stack (T, D) over x's leading batch T·B."""
    acc = acc_dtype(x)
    x32 = x.to(acc)
    mean = x32.mean(-1, keepdim=True)
    var = (x32 - mean).square().mean(-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    if weight.ndim == 2:  # a task stack: task t's rows take row t
        tasks, d = weight.shape
        shape = (tasks, -1) + (1,) * (x.ndim - 2) + (d,)
        out = (y.reshape(tasks, -1, *y.shape[1:]) * weight.to(acc).view(shape)
               + bias.to(acc).view(shape))
        return out.reshape(y.shape).to(x.dtype)
    return (y * weight.to(acc) + bias.to(acc)).to(x.dtype)


def dropout(x, rate: float, *, deterministic: bool = True, generator=None):
    """Inverted dropout; the identity at rate 0 or when deterministic, and
    otherwise drawn from ``generator``."""
    if deterministic or rate == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout at a non-zero rate needs a generator")
    keep = 1.0 - rate
    u = torch.rand(x.shape, generator=generator, device=generator.device)
    return torch.where(u.to(x.device) < keep, x / keep, 0.0).to(x.dtype)


def drop_path_noise(x, generator):
    """The per-sample uniform draws of :func:`drop_path` on ``x``."""
    return torch.rand((x.shape[0],) + (1,) * (x.ndim - 1), generator=generator,
                      device=generator.device)


def drop_path(x, rate, *, deterministic: bool = True, generator=None,
              noise=None):
    """Per-sample stochastic depth; the identity at rate 0 or when
    deterministic (or without a generator, as the JAX package's rng=None).
    ``rate`` is a float or a 0-d tensor (the encoder's per-layer rates).
    ``noise``: the draws made beforehand (:func:`drop_path_noise`), in
    place of drawing from ``generator``."""
    rate = float(rate)
    if deterministic or rate == 0.0 or (generator is None and noise is None):
        return x
    keep = 1.0 - rate
    u = drop_path_noise(x, generator) if noise is None else noise
    return torch.where(u.to(x.device) < keep, x / keep, 0.0).to(x.dtype)


class Linear(nn.Module):
    """(in, out) linear; ``n_fused`` > 1 marks a fused qkv (3) or kv (2)
    projection, whose xavier fan counts one of the fused outputs.
    ``trunc_normal`` initialises the weight as the heads' linears are
    (trunc-normal(0.02), mirage_tpu/adapters/seg_heads.py:65-70)."""

    def __init__(self, dim_in, dim_out, bias=True, n_fused=1,
                 trunc_normal=False):
        super().__init__()
        self.n_fused = n_fused
        self.trunc_normal = trunc_normal
        self.weight = nn.Parameter(torch.empty(dim_out, dim_in))
        self.bias = nn.Parameter(torch.empty(dim_out)) if bias else None

    def init_params(self, generator):
        fan_out, fan_in = self.weight.shape
        if self.trunc_normal:
            vinit.trunc_normal_(self.weight, generator)
        else:
            vinit.xavier_uniform_(self.weight, fan_in,
                                  fan_out // self.n_fused, generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x):
        return linear(x, self.weight, self.bias)


class LayerNorm(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(dim))
        self.bias = nn.Parameter(torch.empty(dim))

    def init_params(self, generator):
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)

    def forward(self, x):
        return layer_norm(x, self.weight, self.bias)


class Mlp(nn.Module):
    """fc1 -> GELU -> fc2 (parameter holder; ops/fused_mlp.py runs it)."""

    def __init__(self, dim, hidden):
        super().__init__()
        self.fc1 = Linear(dim, hidden)
        self.fc2 = Linear(hidden, dim)


class PatchProj(nn.Module):
    """Strided-conv patch projection held as a conv weight (D, C, ph, pw),
    applied as patchify + matmul (ops/patch_embed.py), never as a conv."""

    def __init__(self, channels, dim, ph, pw):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(dim, channels, ph, pw))
        self.bias = nn.Parameter(torch.empty(dim))

    def init_params(self, generator):
        d = self.weight.shape[0]
        fan = self.weight[0].numel()
        vinit.xavier_uniform_(self.weight, fan, d, generator)
        bound = 1.0 / math.sqrt(fan)
        with torch.no_grad():
            self.bias.uniform_(-bound, bound, generator=generator)


class Embedding(nn.Module):
    """Lookup table (num, dim) with the key ``weight``; trunc-normal init,
    the row ``zero_row`` (a padding class) set to zero."""

    def __init__(self, num, dim, zero_row=None):
        super().__init__()
        self.zero_row = zero_row
        self.weight = nn.Parameter(torch.empty(num, dim))

    def init_params(self, generator):
        vinit.trunc_normal_(self.weight, generator)
        if self.zero_row is not None:
            with torch.no_grad():
                self.weight[self.zero_row] = 0.0

    def forward(self, idx):
        return F.embedding(idx, self.weight)
