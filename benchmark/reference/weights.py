"""Seeded weights: the state dict both sides of a cell are given.

One normal draw over every random leaf at once, from a ``torch.Generator``
on the device, in the type the leaves are served in; each leaf is then a
slice of it under its own scale: linears at the Xavier standard deviation
(the fused qkv and kv count one output's fan), patch projections at their
fan-in, biases at 0.02, LN scales 1 ± 0.1 and shifts at 0.02, embeddings and
tokens at 0.02, the mask token 0.02 too (so the decoders see it), and the
fixed positions as the sin-cos table. The same seed on the same device
gives the same bits, so the reference rebuilds the state dict from the
seed instead of keeping a copy.
"""

import math

import torch

from benchmark.reference import mirage


def _scale(name, shape, kind):
    if kind == "linear":
        n_out, n_in = shape
        fused = 3 if name.endswith("qkv.weight") else \
            2 if name.endswith("kv.weight") else 1
        return math.sqrt(2.0 / (n_in + n_out / fused)), 0.0
    if kind == "patch":
        return math.sqrt(1.0 / math.prod(shape[1:])), 0.0
    if kind == "ln_w":
        return 0.1, 1.0
    return 0.02, 0.0  # bias, ln_b, token, zero


def make(cfg, seed, dtype, device, specs=None):
    """name -> tensor of a state dict: ``specs`` (``mirage.Specs``), by
    default the configuration's MIRAGE pretraining model."""
    specs = mirage.param_specs(cfg) if specs is None else specs
    sizes = [math.prod(s) for _, s, k in specs if k != "posemb"]
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(sum(sizes), generator=gen, device=device, dtype=dtype)
    sd, off = {}, 0
    for name, shape, kind in specs:
        if kind == "posemb":
            sd[name] = mirage.sincos_posemb(shape[2], shape[3], shape[1]).to(
                device=device, dtype=dtype)
            continue
        n = math.prod(shape)
        std, mean = _scale(name, shape, kind)
        leaf = flat[off:off + n].view(shape)
        sd[name] = leaf.mul_(std).add_(mean) if mean else leaf.mul_(std)
        off += n
    return sd
