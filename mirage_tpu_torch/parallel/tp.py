"""Megatron tensor parallelism with explicit collectives on tensor-local
shards.

Counterpart of ``mirage_tpu/parallel/tp.py``. Activations stay replicated
over the 'tensor' axis between encoder blocks. Each block's attention runs
head-parallel (each process owns H/t heads: its qkv rows, its attention,
its proj columns) and its MLP hidden-parallel (fc1 rows, fc2 columns); one
all-reduce a branch completes the row-parallel product
(``nn/block.py:Block.tp_forward``). The kernels see tensor-local operands
only, so the hand-written LN, GEMM, attention and MLP kernels run as they
do on one GPU, at the local widths. (DTensor's ``parallelize_module``
would run qkv/proj/fc1/fc2 as DTensor linears and bypass them.)

The conjugate pair: ``ident_f`` is the identity forward and an all-reduce
backward (where the replicated activation fans out into local branches),
``psum_g`` an all-reduce forward and the identity backward (after the
row-parallel product). The in-block LayerNorm parameters' gradients then
come out as per-process partial sums (``tp_grad_kind`` 'partial'), which
the train step all-reduces over 'tensor'.

Storage layout: the leaves' tensor axis in torch's (out, in) layout is
:func:`tp_leaf_axis`. The fused qkv weight's output rows are ordered [3, H,
dh]; :func:`tp_relayout` permutes them (and the qkv bias's, and their Adam
moments') to [t, 3, H/t, dh], so the contiguous t-th block of rows is a
standard-layout qkv weight for H/t heads. A checkpoint is always written in
the standard layout (:func:`tp_unrelayout`).
"""

import re
from typing import Dict, Mapping, Optional

import torch
import torch.distributed as dist

# the tensor-sharded leaves of an encoder block: name suffix -> axis of the
# torch (out, in) tensor split over 'tensor' (mirage_tpu/parallel/tp.py:
# _tp_leaf_spec, whose (in, out) weights are transposed here)
TP_LEAF_AXES = {"attn.qkv.weight": 0, "attn.qkv.bias": 0,
                "attn.proj.weight": 1, "mlp.fc1.weight": 0,
                "mlp.fc1.bias": 0, "mlp.fc2.weight": 1}
_BLOCK = re.compile(r"^encoder\.\d+\.(.+)$")


# ---------------------------------------------------------------------------
# Megatron f/g conjugate collectives
# ---------------------------------------------------------------------------

class _IdentF(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _PsumG(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


def ident_f(x, group):
    """Megatron 'f': identity forward, all-reduce (sum) over ``group``
    backward."""
    return _IdentF.apply(x, group)


def psum_g(x, group):
    """Megatron 'g': all-reduce (sum) over ``group`` forward, identity
    backward."""
    return _PsumG.apply(x, group)


# ---------------------------------------------------------------------------
# Mesh predicates / leaf specs
# ---------------------------------------------------------------------------

def is_tp_only(mesh) -> bool:
    """tensor > 1 and fsdp == 1 (data any)."""
    return mesh.shape["tensor"] > 1 and mesh.shape["fsdp"] == 1


def is_tp_fsdp(mesh) -> bool:
    """tensor > 1 and fsdp > 1 (data any): the TP-local modules, then FSDP2
    over the 'fsdp' sub-mesh."""
    return mesh.shape["tensor"] > 1 and mesh.shape["fsdp"] > 1


def tp_leaf_axis(name: str) -> Optional[int]:
    """The axis of the named state-dict leaf split over 'tensor', or None
    (replicated: norms, the proj and fc2 biases added after the
    all-reduce, everything outside the encoder)."""
    m = _BLOCK.match(name)
    return TP_LEAF_AXES.get(m.group(1)) if m else None


def tp_grad_kind(name: str) -> str:
    """How the named leaf's gradient relates to 'tensor' in the TP step:
    'local' (a sharded leaf, complete for its shard), 'partial' (the
    in-block LayerNorms: each process differentiates its own branches, so
    the gradient is all-reduced), 'replicated' (complete everywhere)."""
    if tp_leaf_axis(name) is not None:
        return "local"
    m = _BLOCK.match(name)
    if m and m.group(1).split(".")[0] in ("norm1", "norm2"):
        return "partial"
    return "replicated"


# ---------------------------------------------------------------------------
# qkv head-group-major relayout
# ---------------------------------------------------------------------------

def _qkv_perm(leaf: torch.Tensor, num_heads: int, t: int, invert: bool):
    """Permute the leading [3, H, dh] axis of a qkv weight (3D, D) or bias
    (3D,) to [t, 3, H/t, dh] (or back)."""
    three_d, rest = leaf.shape[0], leaf.shape[1:]
    dh = three_d // 3 // num_heads
    if invert:
        x = leaf.reshape(t, 3, num_heads // t, dh, *rest).transpose(0, 1)
    else:
        x = leaf.reshape(3, t, num_heads // t, dh, *rest).transpose(0, 1)
    return x.reshape(three_d, *rest)


def _relayout(tree: Mapping[str, torch.Tensor], num_heads: int, t: int,
              invert: bool) -> Dict[str, torch.Tensor]:
    assert num_heads % t == 0, f"num_heads {num_heads} % tensor {t} != 0"
    return {n: (_qkv_perm(v, num_heads, t, invert)
                if _BLOCK.match(n) and ".attn.qkv." in n and v.ndim else v)
            for n, v in tree.items()}


def tp_relayout(tree: Mapping[str, torch.Tensor], num_heads: int, t: int):
    """Head-group-major permutation of the encoder's qkv weights and biases
    in a name -> tensor map (parameters or Adam moments), so the t-th
    contiguous block of rows is a standard-layout local qkv. A pure
    permutation: :func:`tp_unrelayout` inverts it bit for bit."""
    return _relayout(tree, num_heads, t, invert=False)


def tp_unrelayout(tree: Mapping[str, torch.Tensor], num_heads: int, t: int):
    """Inverse of :func:`tp_relayout` (checkpoint export)."""
    return _relayout(tree, num_heads, t, invert=True)


def tp_relayout_state(state, num_heads: int, t: int, invert: bool = False):
    """The permutation on a whole host state {'params', 'opt', 'step'}: the
    parameters and the Adam moments ('mu', 'nu') together; the counters
    pass through."""
    fn = tp_unrelayout if invert else tp_relayout
    return {"params": fn(state["params"], num_heads, t),
            "opt": {k: (fn(v, num_heads, t) if k in ("mu", "nu") else v)
                    for k, v in state["opt"].items()},
            "step": state["step"]}


def tp_slice(full: torch.Tensor, name: str, index: int, t: int):
    """The tensor-local block ``index`` of t of a relayouted full leaf (the
    leaf itself when replicated)."""
    axis = tp_leaf_axis(name)
    if axis is None or full.ndim == 0:
        return full
    return full.chunk(t, dim=axis)[index]
