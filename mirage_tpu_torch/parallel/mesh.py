"""The process mesh of multi-GPU training (one process a GPU, its axes
named as the JAX package names them) and the device list of multi-GPU
serving (one process, one host thread a device).

Counterpart of ``mirage_tpu/parallel/mesh.py``. A 4-axis mesh ('data',
'fsdp', 'tensor', 'pipe') over the processes of a ``torch.distributed``
group, rank ((d·F + f)·T + t)·P + p at coordinate (d, f, t, p), as
``make_mesh`` reshapes the device list there ('pipe' innermost, so a
pipeline's stages are neighbouring ranks). The batch shards over ('data',
'fsdp'); 'fsdp' shards the parameters and moments (FSDP2); 'tensor' runs
the encoder blocks head- and hidden-parallel (``parallel/tp.py``); 'pipe'
splits the encoder's depth into GPipe stages (``parallel/pp.py``). Unused
axes have size 1.

The JAX package's ``shard_batch`` / ``global_batch_from_local`` assemble a
global array from per-host stripes; here each process loads its own stripe
(``data/loader.py``'s ``shard_index`` / ``num_shards``, which are
:func:`batch_rank` / :func:`batch_count`), and every tensor and pipe
rank of one batch position loads the same stripe. :func:`local_batch` cuts
a global batch that a process holds whole into its stripe.

:func:`init_distributed` joins the process group: NCCL for a CUDA device,
gloo for the CPU, picked from the device; a failed NCCL init raises.

:func:`make_serve_mesh` is the one-process counterpart of ``make_mesh(axes,
devices=)`` for the wrapper's ``mesh=`` (``api/wrapper.py``): serving is
pure data parallelism, so every axis ('data', 'fsdp', 'tensor') shards the
batch and the mesh is its list of devices, one model replica on each.
"""

import contextlib
import dataclasses
import datetime
import itertools
import math
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

AXES = ("data", "fsdp", "tensor", "pipe")
BATCH_AXES = ("data", "fsdp")
# the axis combinations a group is made for: the batch axes (DDP, the
# metrics), 'tensor' (the Megatron collectives), the gradient norm's
# buckets ('fsdp', 'tensor', both), and 'pipe' (the pipeline's sends and
# receives, its broadcast and its gradient sums)
GROUP_AXES = (BATCH_AXES, ("fsdp",), ("tensor",), ("fsdp", "tensor"),
              ("pipe",))
# the axes of a serving mesh, all of which shard the batch
# (mirage_tpu/api/wrapper.py:104 _SERVE_AXES)
SERVE_AXES = ("data", "fsdp", "tensor")
TIMEOUT = datetime.timedelta(seconds=300)


def backend_for(device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_distributed(device, *, init_method: Optional[str] = None,
                     world_size: Optional[int] = None,
                     rank: Optional[int] = None,
                     timeout: datetime.timedelta = TIMEOUT) -> torch.device:
    """Joins the default process group (``torchrun``'s environment fills in
    what is not given) and returns this process's device: ``cuda:LOCAL_RANK``
    (made the current device before anything launches) or the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0))
                           if dev.index is None else dev.index)
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group(
            backend_for(dev), init_method=init_method or "env://",
            world_size=-1 if world_size is None else world_size,
            rank=-1 if rank is None else rank, timeout=timeout,
            **({"device_id": dev} if dev.type == "cuda" else {}))
    return dev


@dataclasses.dataclass(eq=False)
class Mesh:
    """A ('data', 'fsdp', 'tensor', 'pipe') mesh over the default group:
    ``shape``
    (axis -> size), this process's ``coords`` (axis -> index), the
    ``DeviceMesh`` FSDP2 shards over and a process group for each
    combination of :data:`GROUP_AXES`."""

    shape: Dict[str, int]
    coords: Dict[str, int]
    device_mesh: object
    groups: Dict[Tuple[str, ...], object]

    @property
    def size(self) -> int:
        return math.prod(self.shape[a] for a in AXES)

    def group(self, axes):
        return self.groups[tuple(a for a in AXES if a in axes)]


def make_mesh(axes: Optional[Dict[str, int]] = None,
              device_type: str = "cpu") -> Mesh:
    """axes e.g. {'data': 2, 'fsdp': 2, 'tensor': 2} or {'data': 2, 'pipe':
    2}; missing axes are 1,
    and without ``axes`` all processes are 'data'. The sizes' product must
    be the world size. Every process of the group calls this together."""
    world = dist.get_world_size()
    axes = dict(axes or {"data": world})
    for name in axes:
        if name not in AXES:
            raise ValueError(f"unknown mesh axis {name!r} (axes {AXES})")
    for name in AXES:
        axes.setdefault(name, 1)
    n = math.prod(axes[a] for a in AXES)
    assert n == world, f"mesh {axes} != {world} processes"
    from torch.distributed.device_mesh import init_device_mesh

    dm = init_device_mesh(device_type, tuple(axes[a] for a in AXES),
                          mesh_dim_names=AXES)
    rank = dist.get_rank()
    coords = dict(zip(AXES, _unravel(rank, [axes[a] for a in AXES])))
    groups = {}
    for combo in GROUP_AXES:
        # one group per value of the other axes, made in the same order by
        # every process (new_group is collective over the default group)
        others = [a for a in AXES if a not in combo]
        parts = []
        for fixed in itertools.product(*(range(axes[a]) for a in others)):
            pin = dict(zip(others, fixed))
            parts.append([r for r in range(world) if all(
                _unravel(r, [axes[a] for a in AXES])[AXES.index(a)] == v
                for a, v in pin.items())])
        groups[combo], _ = dist.new_subgroups_by_enumeration(parts)
    return Mesh(axes, coords, dm, groups)


def _unravel(rank: int, sizes):
    out = []
    for s in reversed(sizes):
        out.append(rank % s)
        rank //= s
    return list(reversed(out))


def batch_rank(mesh: Mesh) -> int:
    """This process's position along the batch axes (its data stripe)."""
    return mesh.coords["data"] * mesh.shape["fsdp"] + mesh.coords["fsdp"]


def batch_count(mesh: Mesh) -> int:
    """The number of batch stripes (data × fsdp)."""
    return mesh.shape["data"] * mesh.shape["fsdp"]


def is_dp_only(mesh: Mesh) -> bool:
    """True when the mesh shards nothing but the batch."""
    return (mesh.shape["fsdp"] == 1 and mesh.shape["tensor"] == 1
            and mesh.shape["pipe"] == 1)


def is_fsdp_only(mesh: Mesh) -> bool:
    """(data, fsdp) meshes with fsdp > 1 and no tensor or pipeline
    parallelism."""
    return (mesh.shape["fsdp"] > 1 and mesh.shape["tensor"] == 1
            and mesh.shape["pipe"] == 1)


def local_batch(batch, mesh: Mesh):
    """This process's stripe (rows) of a global batch every process holds:
    the counterpart of ``shard_batch`` on a one-host mesh, where device i
    of the batch axes takes the i-th contiguous block."""
    n = batch_count(mesh)
    i = batch_rank(mesh)

    def cut(x):
        if x.shape[0] % n:
            raise ValueError(f"batch of {x.shape[0]} does not split over "
                             f"{n} batch stripes (data x fsdp)")
        b = x.shape[0] // n
        return x[i * b:(i + 1) * b]

    return {k: cut(v) for k, v in batch.items()}


def data_parallel(device):
    """(device, mesh) of a tuning command line: under torchrun (WORLD_SIZE
    above 1) or in a process group already joined, the group is joined and
    the mesh is data parallelism over every process, the device this
    process's; otherwise (device, None)."""
    if not (dist.is_initialized()
            or int(os.environ.get("WORLD_SIZE", "1")) > 1):
        return device, None
    device = init_distributed(device)
    return device, make_mesh(device_type=device.type)


def is_writer(mesh) -> bool:
    """Whether this process logs and writes: process 0, or no mesh."""
    return mesh is None or all(v == 0 for v in mesh.coords.values())


@contextlib.contextmanager
def writer_prints(mesh):
    """Within the block, only the writer's prints reach stdout."""
    with contextlib.ExitStack() as stack:
        if not is_writer(mesh):
            stack.enter_context(contextlib.redirect_stdout(
                stack.enter_context(open(os.devnull, "w"))))
        yield


def sum_across(arrays, device):
    """Float64 numpy arrays summed over every process of the default group
    (through ``device``, which NCCL needs to be a GPU)."""
    if not dist.is_initialized():
        return arrays
    flat = torch.from_numpy(np.concatenate(
        [np.asarray(a, np.float64).reshape(-1) for a in arrays])).to(device)
    dist.all_reduce(flat)
    flat = flat.cpu().numpy()
    out, start = [], 0
    for a in arrays:
        n = np.size(a)
        out.append(flat[start:start + n].reshape(np.shape(a)))
        start += n
    return out


def gather_rows(parts):
    """Every process's list of per-batch row arrays, joined in the loaders'
    order (batch by batch, process by process: the samples' order in one
    process's loader)."""
    if not dist.is_initialized():
        return list(parts)
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, list(parts))
    return [rows for batch in zip(*every) for rows in batch]


# ------------------------------------------------------------ serving mesh

@dataclasses.dataclass(frozen=True)
class ServeMesh:
    """The serving mesh: ``shape`` (axis -> size over :data:`SERVE_AXES`)
    and ``devices``, one a mesh position in row-major order, each holding
    a replica of the model."""

    shape: Dict[str, int]
    devices: Tuple[torch.device, ...]

    @property
    def size(self) -> int:
        return len(self.devices)


def make_serve_mesh(axes: Optional[Dict[str, int]] = None, device="cuda",
                    devices=None) -> ServeMesh:
    """axes e.g. {'data': 4, 'fsdp': 1, 'tensor': 2} (missing axes are 1;
    without ``axes``, 'data' over every device given, or every card);
    ``devices`` the list to take, by default cuda:0 … cuda:n−1 for a CUDA
    ``device`` (raising when there are fewer cards) and n times the CPU
    for the CPU. Several entries may name one card: each runs its own
    replica from its own thread and stream."""
    dev = torch.device(device)
    if devices is None and axes is None:
        n = torch.cuda.device_count() if dev.type == "cuda" else 1
        axes = {"data": n}
    axes = dict(axes or {"data": len(devices)})
    for name in axes:
        if name not in SERVE_AXES:
            raise ValueError(f"unknown serving mesh axis {name!r} (axes "
                             f"{SERVE_AXES})")
        if int(axes[name]) < 1:
            raise ValueError(f"mesh axis {name} = {axes[name]} < 1")
    shape = {a: int(axes.get(a, 1)) for a in SERVE_AXES}
    n = math.prod(shape.values())
    if devices is None:
        if dev.type == "cuda":
            have = torch.cuda.device_count()
            if have < n:
                raise RuntimeError(f"serving mesh {shape} needs {n} CUDA "
                                   f"devices, {have} available")
            devices = [torch.device("cuda", i) for i in range(n)]
        else:
            devices = [dev] * n
    devices = tuple(torch.device(d) for d in devices)
    if len(devices) != n:
        raise ValueError(f"serving mesh {shape} != {len(devices)} devices")
    return ServeMesh(shape, devices)


def parse_mesh(text: str) -> Dict[str, int]:
    """'data=4,fsdp=1,tensor=2' -> {'data': 4, 'fsdp': 1, 'tensor': 2}
    (mirage_tpu/cli/serve.py:119-124)."""
    axes = dict(kv.split("=") for kv in text.split(","))
    return {k.strip(): int(v) for k, v in axes.items()}
