"""The AdamW step on the card: the gradient norm and the update as two
launches over a leaf table kept on the card.

Replaces ``mirage_tpu/ops/fused_adamw.py:fused_adamw_leaf`` /
``_adamw_kernel`` (B11) and the global norm the JAX optimizer leaves to
XLA. With ``MIRAGE_OPT_KERNEL=on`` (the port's default; ``off`` in the JAX
package) the optimizer (``train/optim.py``) sends every trainable float32
AdamW leaf on the card to a :class:`LeafTable`: the m, n and p pointers,
lengths, lr scales and weight decays of its leaves and a flat list of
fixed-size (leaf, tile) pairs, built at the first update and kept on the
card until a leaf's storage or the leaf set changes. Each step the host
writes the gradients' pointers and the leaves' (lr, wd) into one pinned
buffer, copies it to the card, and launches csrc/adamw.cu twice: the norm
(each tile's squared sum into its own slot, summed in a fixed order by the
last CTA, which also writes gscale, c1, c2, keep and ``count += keep``:
no host sync) and the update (m, n and p in place). On a CPU tensor a leaf
of at least ``MIN_ELEMS`` elements takes :func:`fused_adamw_ref` and the
rest the ``torch._foreach_*`` route, as before.

:func:`leaf_route` keeps the JAX package's rule (AdamW only, float32,
trainable, a scalar lr scale) and drops three TPU-only gates on the card:
the ``1 << 17`` floor (the TPU's per-leaf launches; one launch over a tile
list has no per-leaf cost, and the floor strands the small leaves on the
foreach route), the 128-lane ``_flat2d`` alignment (the kernels take any
length, 16-byte vectors where the pointers allow and scalars elsewhere),
and the exclusion of vector lr scales (the JAX package stacks the encoder
layers into one leaf with a per-layer lr vector under layer decay; the
port's per-layer leaves always carry a scalar scale). These change which
leaves route, never a number: with the same gscale, c1 and c2 the update
is the foreach route's float32 arithmetic operation by operation; the
norm's order of summation differs (within 1e-6 relative).
"""

import torch

from mirage_tpu_torch.ops import runtime
from mirage_tpu_torch.utils import profiling

MIN_ELEMS = 1 << 17
# elements of a tile (one CTA of csrc/adamw.cu): 256 threads × 8 vectors
TILE = 8192


def leaf_route(param: torch.Tensor, lr_scale, opt: str = "adamw",
               trainable: bool = True) -> str:
    """How this leaf is updated: "table" (the leaf table's kernels, on the
    card), "ref" (:func:`fused_adamw_ref`, a large leaf on the CPU) or
    "foreach" (the optimizer's foreach chain)."""
    if not (runtime.switches["MIRAGE_OPT_KERNEL"] == "on" and opt == "adamw"
            and trainable and isinstance(lr_scale, (int, float))
            and param.dtype == torch.float32):
        return "foreach"
    if runtime.use_kernel(param):
        return "table"
    return "ref" if param.numel() >= MIN_ELEMS else "foreach"


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


def tile_list(numels, tile: int = TILE) -> torch.Tensor:
    """(T, 2) int32 (leaf, tile in the leaf): every leaf cut into tiles of
    ``tile`` elements (the last one shorter), leaf by leaf."""
    per = torch.tensor([-(-k // tile) for k in numels], dtype=torch.int64)
    leaf = torch.repeat_interleave(torch.arange(len(numels)), per)
    first = torch.cumsum(per, 0) - per
    return torch.stack([leaf, torch.arange(len(leaf)) - first[leaf]],
                       1).to(torch.int32)


def packed_rates(lr_scales: torch.Tensor, wds: torch.Tensor, lr: float,
                 wd_scale: float) -> torch.Tensor:
    """(L,) int64: each leaf's float32 (lr · scale, wd · wd_scale), the
    products taken in double and rounded once, as the foreach route rounds
    ``-lr * scale`` and ``wd * wd_scale`` (``lr_scales`` and ``wds`` float64
    on the host)."""
    pair = torch.stack([(lr_scales * lr).float(), (wds * wd_scale).float()], 1)
    return pair.view(torch.int64).reshape(-1)


_dp = torch.Tensor.data_ptr


class LeafTable:
    """The AdamW leaves ``names`` of one optimizer state: their m, n and p
    pointers and lengths and the tile list (on the leaves' device), their
    lr scales and weight decays (host, float64), the norm's slots, its
    arrival counter and the step's scalars (gscale, c1, c2, keep). It holds
    the leaves it points to. Built once; :meth:`matches` tells whether the
    leaves still lie where the table says. :meth:`step` launches the two
    kernels on the card; :meth:`step_ref` is their plain version, which
    the tests hold the optimizer's table route to on the CPU. ``builds``
    counts the tables built in the process."""

    builds = 0

    def __init__(self, names, ms, ns, ps, lr_scales, wds, key=None):
        dev = ps[0].device
        for name, m, n, p in zip(names, ms, ns, ps):
            for what, t in (("m", m), ("n", n), ("p", p)):
                if (t.device != dev or t.dtype != torch.float32
                        or not t.is_contiguous() or t.shape != p.shape):
                    raise ValueError(
                        f"leaf table {name} {what}: {t.dtype} "
                        f"{tuple(t.shape)} on {t.device}, expected "
                        f"contiguous float32 {tuple(p.shape)} on {dev}")
        self.names, self.key = list(names), key
        self.ms, self.ns, self.ps = list(ms), list(ns), list(ps)
        self.index = set(self.names)
        self.numels = [p.numel() for p in ps]
        self.numel = sum(self.numels)
        self.sig = self._sig(ms, ns, ps)
        leaves = torch.tensor([[m.data_ptr(), n.data_ptr(), p.data_ptr(), k]
                               for m, n, p, k in zip(ms, ns, ps, self.numels)],
                              dtype=torch.int64)
        tiles = tile_list(self.numels)
        self.leaves, self.tiles = leaves.to(dev), tiles.to(dev)
        self.slots = torch.empty(max(1, len(tiles)), dtype=torch.float32,
                                 device=dev)
        self.arrived = torch.zeros(1, dtype=torch.int32, device=dev)
        self.scalars = torch.empty(4, dtype=torch.float32, device=dev)
        self.step_buf = torch.empty(2 * len(ps), dtype=torch.int64,
                                    device=dev)
        self.lr_scales = torch.tensor(lr_scales, dtype=torch.float64)
        self.wds = torch.tensor(wds, dtype=torch.float64)
        self._rates_at, self._rates = None, None
        LeafTable.builds += 1
        profiling.tally(table_builds=1)

    @staticmethod
    def _sig(ms, ns, ps):
        return [*map(_dp, ms), *map(_dp, ns), *map(_dp, ps)]

    def matches(self, ms, ns, ps) -> bool:
        """Do the leaves' m, n and p still lie where the table says?"""
        return self._sig(ms, ns, ps) == self.sig

    def write(self, gs, lr: float, wd_scale: float):
        """The step buffer: the gradients' pointers and each leaf's (lr,
        wd), through one pinned buffer and one async copy (the pinned
        allocator reuses the buffer once the copy is done). A gradient that
        is not contiguous float32 is copied so; one of another length
        raises. Returns the gradients the kernels read."""
        f32 = torch.float32
        bad = [i for i, (g, k) in enumerate(zip(gs, self.numels))
               if g.dtype is not f32 or g.numel() != k
               or not g.is_contiguous()]
        if bad:
            gs = list(gs)
            for i in bad:
                if gs[i].numel() != self.numels[i]:
                    raise ValueError(f"leaf table {self.names[i]}: gradient "
                                     f"of {gs[i].numel()} elements, expected "
                                     f"{self.numels[i]}")
                gs[i] = gs[i].to(f32).contiguous()
        if self._rates_at != (lr, wd_scale):
            self._rates = packed_rates(self.lr_scales, self.wds, lr,
                                       wd_scale).numpy()
            self._rates_at = (lr, wd_scale)
        n = len(self.numels)
        host = torch.empty(2 * n, dtype=torch.int64, pin_memory=True)
        buf = host.numpy()
        buf[:n] = list(map(_dp, gs))
        buf[n:] = self._rates
        self.step_buf.copy_(host, non_blocking=True)
        return gs

    def step(self, gs, count, lr, wd_scale=1.0, *, gnorm=None, extra=None,
             clip=None, skip=None, b1, b2, eps) -> torch.Tensor:
        """One AdamW step in place over the table's leaves from the
        gradients ``gs`` (in the table's order): the norm kernel (or, with
        ``gnorm`` given, only the scalars from it; ``extra``: the squared
        sum of gradients outside the table), ``count`` += keep, then the
        update. Returns the gradient norm, a device scalar of its own."""
        fused_adamw.last_routed_count = len(self.names)
        gs = self.write(gs, lr, wd_scale)
        dev = self.leaves.device
        out = None
        if gnorm is None:
            out = torch.empty((), dtype=torch.float32, device=dev)
        elif gnorm.dtype != torch.float32:
            gnorm = gnorm.float()
        runtime.adamw_norm(self.tiles, TILE, self.leaves, self.step_buf,
                           self.slots, self.arrived, count, self.scalars,
                           extra=extra, gnorm_in=gnorm, gnorm_out=out,
                           clip=clip, skip=skip, b1=b1, b2=b2)
        self.update(b1, b2, eps)
        return out if gnorm is None else gnorm

    def step_ref(self, gs, count, lr, wd_scale=1.0, *, gnorm=None,
                 extra=None, clip=None, skip=None, b1, b2, eps):
        """Plain version of :meth:`step`: the norm as ``global_norm`` takes
        it, the scalars as the optimizer's foreach route computes them,
        :func:`fused_adamw_ref` on every leaf."""
        if gnorm is None:
            gnorm = torch.sqrt(sum([g.float().square().sum() for g in gs]
                                   + ([extra] if extra is not None else [])))
        dev = gnorm.device
        keep = (torch.isfinite(gnorm) & (gnorm < skip) if skip is not None
                else torch.ones((), dtype=torch.bool, device=dev))
        gscale = (torch.clamp(clip / (gnorm + 1e-6), max=1.0)
                  if clip is not None else torch.ones((), device=dev))
        count += keep.to(torch.int32)
        cnt = torch.clamp(count.float(), min=1.0)
        c1, c2 = 1 - torch.pow(b1, cnt), 1 - torch.pow(b2, cnt)
        keep_f = keep.float()
        self.scalars.copy_(torch.stack([gscale, c1, c2, keep_f]))
        for g, m, n, p, s, w in zip(gs, self.ms, self.ns, self.ps,
                                    self.lr_scales.tolist(),
                                    self.wds.tolist()):
            fused_adamw_ref(g, m, n, p, gscale=gscale, lr=lr * s,
                            wd=w * wd_scale, c1=c1, c2=c2, keep=keep_f,
                            b1=b1, b2=b2, eps=eps)
        return gnorm

    def update(self, b1, b2, eps):
        """The update kernel from the step buffer and the scalars."""
        if len(self.tiles):
            runtime.adamw_tiles(self.tiles, TILE, self.leaves, self.step_buf,
                                self.scalars, b1, b2, eps)

    def update_with(self, gs, *, gscale, c1, c2, keep, b1, b2, eps):
        """:meth:`update` from the gradients ``gs`` (float32, contiguous:
        the step buffer keeps their pointers for reruns of :meth:`update`)
        and the device scalars given, at the table's lr scales and weight
        decays: the kernel route of :func:`fused_adamw`'s update."""
        self.scalars.copy_(torch.stack([gscale, c1, c2, keep]))
        gs = self.write(gs, 1.0, 1.0)  # noqa: F841 (alive until the launch)
        self.update(b1, b2, eps)


def fused_adamw(gs, ms, ns, ps, lrs, wds, *, gscale, c1, c2, keep, b1, b2,
                eps):
    """One AdamW update in place on every leaf (g, m, n, p) of the lists,
    with per-leaf lr (its lr scale folded in) and wd, and the scalars
    gscale, c1, c2 and keep: :func:`fused_adamw_ref` on each leaf, the
    optimizer's route for the large leaves on the CPU (:func:`leaf_route`'s
    "ref"). On the card the optimizer's leaves take a :class:`LeafTable`."""
    fused_adamw.last_routed_count = len(ps)
    for g, m, n, p, lr, wd in zip(gs, ms, ns, ps, lrs, wds):
        fused_adamw_ref(g, m, n, p, gscale=gscale, lr=lr, wd=wd, c1=c1,
                        c2=c2, keep=keep, b1=b1, b2=b2, eps=eps)


fused_adamw.last_routed_count = 0
