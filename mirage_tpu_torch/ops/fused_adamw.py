"""The fused AdamW update: one pass over g, m, n, p per parameter.

Replaces ``mirage_tpu/ops/fused_adamw.py:fused_adamw_leaf`` /
``_adamw_kernel`` (B11). The optimizer (``train/optim.py``) sends its
routed leaves here when ``MIRAGE_OPT_KERNEL=on`` (default off, as in the JAX
package). On the card all routed leaves go through one launch of
``csrc/adamw.cu`` (a table of leaves in device memory, m, n and p updated in
place, gscale / c1 / c2 / keep read from a device buffer: no host sync);
on a CPU tensor each leaf takes :func:`fused_adamw_ref`.

:func:`leaf_update_viable` keeps the JAX package's routing rule (AdamW only,
float32, trainable, at least ``1 << 17`` elements, a scalar lr scale) with
two TPU-only gates dropped. The 128-lane ``_flat2d`` alignment goes: the
card's kernel takes any length (16-byte vectors and a scalar tail). The
exclusion of vector lr scales goes too: the JAX package stacks the encoder
layers into one leaf with a per-layer lr vector under layer decay, while the
port's per-layer leaves (``encoder.{i}.…``) always carry a scalar scale.
Both change which leaves route, never a number.
"""

import struct

import torch

from mirage_tpu_torch.ops import runtime

MIN_ELEMS = 1 << 17


def leaf_update_viable(param: torch.Tensor, lr_scale, opt: str = "adamw",
                       trainable: bool = True) -> bool:
    """Route this leaf's update through the fused kernel?"""
    return (runtime.switches["MIRAGE_OPT_KERNEL"] == "on" and opt == "adamw"
            and trainable and isinstance(lr_scale, (int, float))
            and param.dtype == torch.float32 and param.numel() >= MIN_ELEMS)


def fused_adamw_ref(g, m, n, p, *, gscale, lr, wd, c1, c2, keep, b1, b2,
                    eps):
    """Plain PyTorch version, in place on m, n and p, step by step as
    _adamw_kernel: gs = g·gscale; m' = b1·m + (1 − b1)·gs; n' = b2·n +
    (1 − b2)·gs²; p' = p − lr·((m'/c1)/(√(n'/c2) + eps) + wd·p); where
    keep ≤ 0, m, n and p are left exactly as they were. gscale, c1, c2 and
    keep are float32 scalars (0-d tensors), lr and wd floats."""
    gs = g.float() * gscale
    m2 = b1 * m + (1 - b1) * gs
    n2 = b2 * n + (1 - b2) * (gs * gs)
    p2 = p - lr * ((m2 / c1) / (torch.sqrt(n2 / c2) + eps) + wd * p)
    kept = keep > 0
    for t, new in ((m, m2), (n, n2), (p, p2)):
        t.copy_(torch.where(kept, new, t))


def _pack(lr: float, wd: float) -> int:
    """(lr, wd) as two float32 in one int64 (the table row's last word)."""
    return struct.unpack("<q", struct.pack("<ff", lr, wd))[0]


def fused_adamw(gs, ms, ns, ps, lrs, wds, *, gscale, c1, c2, keep, b1, b2,
                eps):
    """One AdamW step in place on every leaf (g, m, n, p) of the lists, with
    per-leaf lr (its lr scale folded in) and wd, and the device scalars
    gscale, c1, c2 and keep. On the card one launch of csrc/adamw.cu covers
    every leaf; on a CPU tensor each leaf takes fused_adamw_ref."""
    fused_adamw.last_routed_count = len(ps)
    if not ps:
        return
    if not runtime.use_kernel(ps[0]):
        for g, m, n, p, lr, wd in zip(gs, ms, ns, ps, lrs, wds):
            fused_adamw_ref(g, m, n, p, gscale=gscale, lr=lr, wd=wd, c1=c1,
                            c2=c2, keep=keep, b1=b1, b2=b2, eps=eps)
        return
    rows = []
    for g, m, n, p, lr, wd in zip(gs, ms, ns, ps, lrs, wds):
        for name, t in (("g", g), ("m", m), ("n", n), ("p", p)):
            runtime.check(name, t, p, p.shape)
        if p.dtype != torch.float32:
            raise ValueError(f"fused AdamW takes float32 leaves, got {p.dtype}")
        rows.append([g.data_ptr(), m.data_ptr(), n.data_ptr(), p.data_ptr(),
                     p.numel(), _pack(lr, wd)])
    table = torch.tensor(rows, dtype=torch.int64).pin_memory().to(
        ps[0].device, non_blocking=True)
    scalars = torch.stack([torch.as_tensor(v, dtype=torch.float32,
                                           device=ps[0].device).reshape(())
                           for v in (gscale, c1, c2, keep)])
    runtime.adamw(table, len(rows), max(p.numel() for p in ps), scalars, b1,
                  b2, eps)
    runtime.count(fused_adamw)


fused_adamw.launches = 0
fused_adamw.last_routed_count = 0
