"""The single-device training steps: pretraining (masked forward,
token-space losses), segmentation tuning (the light forward through the
seg head, a segmentation loss) and classification tuning (the pooled head,
label-smoothed cross-entropy over zero-weight-padded batches), each with its
backward and the grouped optimizer's update.

Counterpart of ``mirage_tpu/train/steps.py`` (``make_pretrain_loss``,
``make_train_step``, ``init_train_state``; reference run_pretraining.py
train_one_epoch) and of the seg tuning loss of
``mirage_tpu/cli/run_seg_tuning.py:296-308``: the loss, the gradients of
every trainable parameter (frozen encoder blocks stop requiring grad, so
the backward runs through them to the input adapters without their weight
gradients, as the reference freeze does), the clipped update, and metrics
``{"loss", "grad_norm", "loss_<task>"}`` left on the device (no host sync
in the step); the classification loss hands its logits back as the
metric ``logits``.

The multi-GPU steps (``mirage_tpu/train/steps.py:163-498``): one process a
GPU over a ('data', 'fsdp', 'tensor', 'pipe') mesh (``parallel/mesh.py``),
in one of five layouts, which :func:`shard_state` places and
:func:`make_train_step` steps:

- 'dp': ``DistributedDataParallel`` over the batch axes, the parameters
  and moments whole on every process;
- 'fsdp': FSDP2 (``fully_shard``) on each ``encoder.{i}`` block, then on
  the model, over the 'fsdp' sub-mesh (HSDP, replicated over 'data', when
  data > 1): every parameter and its moments sharded on axis 0;
- 'tp': Megatron tensor parallelism with explicit collectives
  (``parallel/tp.py``): the encoder's qkv/proj/fc1/fc2 cut to their
  tensor-local blocks (qkv relayouted head-group-major), the blocks run
  ``Block.tp_forward``; DDP over the batch axes;
- 'tp_fsdp': the tensor-local model, then FSDP2 over the 'fsdp' sub-mesh;
- 'pp': GPipe pipeline parallelism (``parallel/pp.py``) over 'pipe', with
  'data' only: each stage keeps its ``encoder.{i}`` blocks and their
  moments, everything else whole; ``make_train_step(..., pp=True)`` with a
  model carrying ``pp=("pipe", n_micro)``. Its gradients are summed and
  averaged by explicit bucketed all-reduces (DDP cannot do the 'pipe'
  sum): the loss scaled by 1/S, the 'sum' leaves all-reduced over 'pipe',
  every leaf averaged over the batch axes, the norm
  sqrt(replicated² + all-reduce_pipe(local²)).

The step's generator is folded by the batch-axes index (every tensor rank
of one batch position draws the same masks and drop-path). Gradients: DDP
and FSDP2 take the batch mean in their backward hooks (so the sharded step
runs ``loss.backward()``); the in-block LayerNorms' 'partial' gradients are
then all-reduced over 'tensor'. The clip/skip norm sums each gradient's
squares over the axes it is split across ('fsdp' for FSDP2's shards,
'tensor' for the tensor-local leaves), one all-reduce a bucket, and the
optimizer updates the local shards with it. ``MIRAGE_FSDP_STEP`` /
``MIRAGE_TP_STEP`` take 'shardmap' (the default: these steps); 'gspmd'
(the JAX package's automatic partitioning with the kernels off) has no
counterpart here and raises.
"""

import dataclasses
import math
from typing import Any, Callable, Dict, Mapping, Optional

import torch

from mirage_tpu_torch.losses.masked import (masked_ce_loss_tokens,
                                            masked_mse_loss_tokens)
from mirage_tpu_torch.ops.runtime import env_choice
from mirage_tpu_torch.train.optim import GroupedOptimizer, local

# mirage_tpu/train/steps.py:42,49: read once at import
_FSDP_STEP = env_choice("MIRAGE_FSDP_STEP", "shardmap", ("shardmap", "gspmd"))
_TP_STEP = env_choice("MIRAGE_TP_STEP", "shardmap", ("shardmap", "gspmd"))
LAYOUTS = ("dp", "fsdp", "tp", "tp_fsdp", "pp")
PIPE_SCOPE = ("pipeline parallelism composes only with data parallelism "
              "(mesh {}); fsdp/tensor x pipe is not implemented")
# elements of one bucket of the pipeline step's explicit all-reduces
BUCKET = 1 << 24


def make_pretrain_loss(model, domain_conf: Mapping[str, Mapping[str, Any]],
                       num_encoded_tokens: int, alphas=1.0,
                       sample_tasks_uniformly: bool = False,
                       loss_on_unmasked: bool = False):
    """domain_conf: task -> {'loss': 'mse'|'ce', 'patch_size': int,
    'norm_pix': bool}. Returns loss_fn(batch, generator=None,
    task_masks=None, num_visible=None) -> (loss, {task: loss}): random masks
    from ``generator``, or explicit ``task_masks`` (1 = masked) with
    ``num_visible`` visible tokens per sample."""

    def loss_fn(batch, generator: Optional[torch.Generator] = None,
                task_masks=None, num_visible=None):
        preds, masks = model(
            batch, mask_inputs=True, task_masks=task_masks,
            num_encoded_tokens=num_encoded_tokens, num_visible=num_visible,
            alphas=alphas, sample_tasks_uniformly=sample_tasks_uniformly,
            generator=generator, deterministic=False, pixel_outputs=False)
        task_losses = {}
        for task, pred in preds.items():
            conf = domain_conf[task]
            mask = None if loss_on_unmasked else masks[task]
            if conf["loss"] == "ce":
                task_losses[task] = masked_ce_loss_tokens(
                    pred, batch[task], mask, patch_size=conf["patch_size"])
            else:
                task_losses[task] = masked_mse_loss_tokens(
                    pred.float(), batch[task].float(), mask,
                    patch_size=conf["patch_size"],
                    norm_pix=conf.get("norm_pix", False))
        return sum(task_losses.values()), task_losses

    return loss_fn


def make_seg_loss(model, criterion: Callable, in_domains,
                  frozen_encoder: bool = False,
                  return_all_layers: bool = False):
    """Segmentation tuning's loss: loss_fn(batch, generator=None) -> (loss,
    {}). The light forward (stochastic depth from ``generator``; every
    block's output to the head with ``return_all_layers``, as the DPT head
    takes them), the seg head's logits in float, resized bilinearly to the
    labels' size when they differ, and ``criterion(logits,
    batch["semseg"])``."""

    def loss_fn(batch, generator: Optional[torch.Generator] = None):
        preds = model.forward_light(
            {k: v for k, v in batch.items() if k in in_domains},
            return_all_layers=return_all_layers,
            deterministic=False, generator=generator,
            frozen_encoder=frozen_encoder)
        logits = preds["semseg"].float()
        target = batch["semseg"]
        if logits.shape[-2:] != target.shape[-2:]:
            from mirage_tpu_torch.nn.resize import resize2d

            logits = resize2d(logits, target.shape[-2:], mode="bilinear")
        return criterion(logits, target), {}

    return loss_fn


def make_cls_loss(model, smoothing: float = 0.1,
                  frozen_encoder: bool = False):
    """Classification tuning's loss (mirage_tpu/cli/run_cls_tuning.py:
    178-190): loss_fn(batch, generator=None) -> (loss, {"logits": logits})
    over batch {"images", "targets", "weights"}: the sum form of the
    label-smoothed cross-entropy divided by the total weight (at least 1),
    so zero-weight padding rows add nothing. ``frozen_encoder``: linear
    probing."""
    from mirage_tpu_torch.losses.gdice import cross_entropy_loss

    def loss_fn(batch, generator: Optional[torch.Generator] = None):
        logits = model(batch["images"], deterministic=False,
                       generator=generator, frozen_encoder=frozen_encoder)
        s, w = cross_entropy_loss(
            logits[..., None, None], batch["targets"][..., None, None],
            label_smoothing=smoothing, weights=batch["weights"],
            normalize=False)
        return s / w.clamp_min(1.0), {"logits": logits}

    return loss_fn


def step_generator(seed: int, it: int, device) -> torch.Generator:
    """The generator of training step ``it`` (its masks and stochastic
    depth), seeded from (seed, it) so a resumed run repeats the step."""
    return torch.Generator(device=device).manual_seed(
        (seed + 1) * 1_000_003 + it)


def init_train_state(model: torch.nn.Module, optimizer: GroupedOptimizer):
    """{'params': name -> parameter (the model's own, updated in place),
    'opt': the optimizer state, 'step': a device counter}. Frozen parameters
    stop requiring grad."""
    optimizer.stop_frozen(model)
    params = dict(model.named_parameters())
    first = next(iter(params.values()))
    return {"params": params, "opt": optimizer.init(params),
            "step": torch.zeros((), dtype=torch.int32, device=first.device)}


def make_train_step(loss_fn: Callable, optimizer: GroupedOptimizer,
                    mesh=None, pp: bool = False):
    """step_fn(state, batch, generator, lr, wd_scale=1.0, **loss_kwargs) ->
    (state, metrics): loss_fn(batch, generator=generator, **loss_kwargs)
    (e.g. the pretraining loss's task_masks and num_visible), gradients of
    every parameter that requires grad, the optimizer update in place, the
    step counter. The loss function's 0-d extras become metrics
    ``loss_<name>``, any other extra the metric ``<name>`` (detached).

    With ``mesh`` the sharded step of the layout :func:`shard_state` placed
    the state in: ``batch`` is this process's stripe and the metrics are
    means over the batch axes. A mesh with a 'pipe' axis above 1 takes the
    pipeline step only with ``pp`` (the caller promises a model built with
    ``pp=("pipe", n_micro)``), as mirage_tpu/train/steps.py:140-146 routes
    it; there is no other step for it."""
    if mesh is not None:
        from mirage_tpu_torch.parallel.pp import is_pp

        if is_pp(mesh):
            if not pp:
                raise ValueError(
                    "mesh has a pipe axis > 1 but make_train_step was not "
                    "called with pp=True (and a model carrying "
                    "pp=('pipe', n_micro)): there is no other step for "
                    "pipeline parallelism")
            return _make_pp_step(loss_fn, optimizer, mesh)
        return _make_sharded_step(loss_fn, optimizer, mesh)

    def step_fn(state, batch, generator, lr, wd_scale=1.0, **loss_kwargs):
        params = state["params"]
        loss, task_losses = loss_fn(batch, generator=generator,
                                    **loss_kwargs)
        names = [n for n, p in params.items() if p.requires_grad]
        grads = torch.autograd.grad(loss, [params[n] for n in names],
                                    allow_unused=True)
        gnorm = optimizer.update(dict(zip(names, grads)), state["opt"],
                                 params, lr, wd_scale)
        state["step"] += 1
        metrics = {"loss": loss.detach(), "grad_norm": gnorm}
        metrics.update({(f"loss_{k}" if v.ndim == 0 else k): v.detach()
                        for k, v in task_losses.items()})
        return state, metrics

    return step_fn


# ------------------------------------------------------------ multi-GPU

@dataclasses.dataclass(eq=False)
class Layout:
    """How :func:`shard_state` placed a state: the layout, the mesh, the
    model it cut (updated in place by the steps) and the encoder's head
    count (the qkv relayout's); under 'pp' the stage's ``pipe``
    (``parallel/pp.py:Pipe``), the standard layout's leaves ``full``
    ({'params' | 'mu' | 'nu': {name: (shape, dtype)}}, in the standard
    order) and each leaf's owning stage (``owners``, None: every stage)."""

    kind: str
    mesh: Any
    model: torch.nn.Module
    num_heads: Optional[int] = None
    pipe: Any = None
    full: Optional[Dict] = None
    owners: Optional[Dict] = None

    @property
    def tp(self) -> bool:
        return self.kind in ("tp", "tp_fsdp")

    @property
    def fsdp(self) -> bool:
        return self.kind in ("fsdp", "tp_fsdp")


def mesh_layout(mesh) -> str:
    """The layout a mesh's shape selects (mirage_tpu/train/steps.py:
    make_train_step's routing)."""
    from mirage_tpu_torch.parallel.mesh import is_dp_only
    from mirage_tpu_torch.parallel.pp import is_pp
    from mirage_tpu_torch.parallel.tp import is_tp_fsdp, is_tp_only

    if is_pp(mesh):
        if mesh.shape["fsdp"] > 1 or mesh.shape["tensor"] > 1:
            raise ValueError(PIPE_SCOPE.format(dict(mesh.shape)))
        return "pp"
    if is_tp_fsdp(mesh):
        return "tp_fsdp"
    if is_tp_only(mesh):
        return "tp"
    return "dp" if is_dp_only(mesh) else "fsdp"


def _check_switches(kind: str):
    for name, value, kinds in (("MIRAGE_FSDP_STEP", _FSDP_STEP,
                                ("fsdp", "tp_fsdp")),
                               ("MIRAGE_TP_STEP", _TP_STEP,
                                ("tp", "tp_fsdp"))):
        if value == "gspmd" and kind in kinds:
            raise ValueError(
                f"{name}=gspmd selects the JAX package's automatic (GSPMD) "
                f"partitioning with the kernels off, which has no "
                f"counterpart in the port: use shardmap (the default)")


def _fsdp_mesh(mesh):
    dm = mesh.device_mesh
    return dm["data", "fsdp"] if mesh.shape["data"] > 1 else dm["fsdp"]


def _fsdp_range(n: int, parts: int, index: int):
    """The rows of axis 0 FSDP2 gives shard ``index`` of ``parts``
    (torch.chunk's: ceil(n / parts) rows each, the last ones short or
    empty)."""
    size = -(-n // parts)
    start = min(index * size, n)
    return start, min(start + size, n)


def _tp_cut(full: torch.Tensor, name: str, lay: Layout) -> torch.Tensor:
    """The tensor-local block of a standard-layout full leaf."""
    from mirage_tpu_torch.parallel.tp import tp_relayout, tp_slice

    t = lay.mesh.shape["tensor"]
    full = tp_relayout({name: full}, lay.num_heads, t)[name]
    return tp_slice(full, name, lay.mesh.coords["tensor"], t)


def _cut(full: torch.Tensor, name: str, lay: Layout, param) -> torch.Tensor:
    """This process's part of a standard-layout full leaf (a parameter or
    a moment) named ``name`` in layout ``lay``, shaped as the local shard
    of ``param`` (the live parameter)."""
    mesh = lay.mesh
    if full.ndim == 0:
        return full
    if lay.tp:
        full = _tp_cut(full, name, lay)
    if lay.fsdp:
        start, end = _fsdp_range(full.shape[0], mesh.shape["fsdp"],
                                 mesh.coords["fsdp"])
        full = full[start:end]
    want = local(param).shape
    assert tuple(full.shape) == tuple(want), (name, full.shape, want)
    return full


def gather_leaf(part: torch.Tensor, name: str, lay: Layout, param):
    """The standard-layout full leaf named ``name`` (a parameter, its
    moment or its gradient) from every process's local ``part`` of it, for
    the live parameter ``param`` of layout ``lay`` (the inverse of
    :func:`_cut`); collective over the mesh."""
    import torch.distributed as dist

    from mirage_tpu_torch.parallel.tp import tp_leaf_axis, tp_unrelayout

    mesh = lay.mesh
    if part.ndim == 0:
        return part
    if lay.fsdp:
        from torch.distributed.tensor import DTensor

        part = DTensor.from_local(part, param.device_mesh, param.placements,
                                  shape=param.shape,
                                  stride=param.stride()).full_tensor()
    axis = tp_leaf_axis(name) if lay.tp else None
    if axis is not None:
        t = mesh.shape["tensor"]
        parts = [torch.empty_like(part) for _ in range(t)]
        dist.all_gather(parts, part.contiguous(),
                        group=mesh.group(("tensor",)))
        part = tp_unrelayout({name: torch.cat(parts, axis)}, lay.num_heads,
                             t)[name]
    return part


def shard_state(state, mesh, model: torch.nn.Module, tp_num_heads=None,
                layout: Optional[str] = None):
    """Places a whole train state (``init_train_state``, possibly loaded
    from a checkpoint) on ``mesh`` in ``layout`` (by default the one the
    mesh's shape selects, :func:`mesh_layout`); returns the placed state,
    whose 'layout' entry is a :class:`Layout`. The model is cut in place:
    under 'tp'/'tp_fsdp' its encoder weights become their tensor-local
    blocks and its blocks run tensor-parallel (``tp_num_heads``, the
    encoder's head count, is required); under 'fsdp'/'tp_fsdp' FSDP2
    shards it; under 'pp' (a model with ``pp`` set) it keeps the stage's
    encoder blocks and binds the stage's pipe. The moments are cut as their
    parameters are. Counterpart of mirage_tpu/train/steps.py:504."""
    from mirage_tpu_torch.parallel.tp import tp_leaf_axis

    kind = layout or mesh_layout(mesh)
    if kind not in LAYOUTS:
        raise ValueError(f"layout {kind!r} not in {LAYOUTS}")
    _check_switches(kind)
    if kind == "pp":
        return _shard_pp(state, mesh, model)
    lay = Layout(kind, mesh, model, tp_num_heads)
    if lay.tp and tp_num_heads is None:
        raise ValueError("a tensor-parallel layout needs tp_num_heads")
    if lay.tp:
        with torch.no_grad():
            for n, p in model.named_parameters():
                if tp_leaf_axis(n) is not None:
                    p.data = _tp_cut(p.data, n, lay).contiguous()
        model.tp = (mesh.group(("tensor",)), mesh.shape["tensor"])
    if lay.fsdp:
        from torch.distributed.fsdp import (fully_shard,
                                            register_fsdp_forward_method)

        fmesh = _fsdp_mesh(mesh)
        for block in model.encoder:
            fully_shard(block, mesh=fmesh)
        fully_shard(model, mesh=fmesh)
        if hasattr(model, "forward_light"):
            register_fsdp_forward_method(model, "forward_light")
    params = dict(model.named_parameters())

    def cut(m, n):
        part = _cut(m, n, lay, params[n])
        return part if part is m else part.clone()

    opt = {k: ({n: cut(m, n) for n, m in v.items()}
               if k in ("mu", "nu") else v)
           for k, v in state["opt"].items()}
    return {"params": params, "opt": opt, "step": state["step"],
            "layout": lay}


def gather_state(state):
    """The standard-layout whole state of a placed one, on the host:
    {'params', 'opt', 'step'} as a one-GPU run holds it (the qkv leaves
    unrelayouted, every shard gathered, every stage's blocks). Collective:
    every process of the mesh calls it."""
    lay, params = state.get("layout"), state["params"]
    if lay is not None and lay.kind == "pp":
        return _gather_pp_state(state)

    def host(t, name=None):
        t = t.detach()
        if lay is not None and name is not None:
            t = gather_leaf(local(t), name, lay, params[name])
        return t.to("cpu", copy=True)

    return {"params": {n: host(p, n) for n, p in params.items()},
            "opt": {k: ({n: host(m, n) for n, m in v.items()}
                        if isinstance(v, dict) else host(v))
                    for k, v in state["opt"].items()},
            "step": host(state["step"])}


@torch.no_grad()
def load_whole(state, whole):
    """Copies a standard-layout whole state {'params', 'opt', 'step'}
    (host tensors, as :func:`gather_state` or a checkpoint gives it) into a
    state, placed or not, in place: each process takes its own part."""
    lay = state.get("layout")
    params = state["params"]

    def part(full, name):
        if lay is None:
            return full
        return _cut(full, name, lay, params[name])

    for n, p in params.items():
        local(p).copy_(part(whole["params"][n], n))
    for k, v in state["opt"].items():
        if isinstance(v, dict):
            for n, m in v.items():
                saved = whole["opt"].get(k, {}).get(n)
                if saved is None:
                    m.zero_()
                else:
                    m.copy_(part(saved, n))
        else:
            v.copy_(whole["opt"][k])
    state["step"].copy_(whole["step"])
    return state


def fold_generator(generator: torch.Generator, index: int):
    """The generator of batch position ``index`` of a step whose generator
    is ``generator`` (fresh, as :func:`step_generator` makes it): itself at
    index 0, else one seeded at initial_seed + index·2³² (the counterpart of
    ``jax.random.fold_in(rng, axis_index(('data', 'fsdp')))``)."""
    if index == 0:
        return generator
    return torch.Generator(device=generator.device).manual_seed(
        generator.initial_seed() + (index << 32))


class _LossModule(torch.nn.Module):
    """The loss as a module over the model's parameters, for DDP, whose
    reducer is prepared by its own forward."""

    def __init__(self, model, loss_fn):
        super().__init__()
        self.model = model
        self.loss_fn = loss_fn

    def forward(self, *args, **kwargs):
        return self.loss_fn(*args, **kwargs)


def _make_sharded_step(loss_fn: Callable, optimizer: GroupedOptimizer,
                       mesh):
    """The step of every layout (mirage_tpu/train/steps.py:163-339): the
    batch mean of the gradients in DDP's or FSDP2's backward hooks, the
    'partial' gradients all-reduced over 'tensor', the bucketed global
    norm, the update on the local shards."""
    import torch.distributed as dist

    from mirage_tpu_torch.parallel.mesh import batch_count, batch_rank
    from mirage_tpu_torch.parallel.tp import tp_grad_kind

    cache = {}
    batch_group = mesh.group(("data", "fsdp"))
    n_batch = batch_count(mesh)

    def build(lay: Layout):
        if lay.mesh is not mesh:
            raise ValueError("the state was placed on another mesh")
        if lay.fsdp:
            return loss_fn
        from torch.nn.parallel import DistributedDataParallel

        dev = next(lay.model.parameters()).device
        return DistributedDataParallel(
            _LossModule(lay.model, loss_fn), process_group=batch_group,
            device_ids=[dev] if dev.type == "cuda" else None,
            find_unused_parameters=True)

    def stepper(state, batch, generator, lr, wd_scale=1.0, **loss_kwargs):
        lay = state["layout"]
        if "fn" not in cache:
            cache["fn"] = build(lay)
        params = state["params"]
        names = [n for n, p in params.items() if p.requires_grad]
        for n in names:
            params[n].grad = None
        loss, task_losses = cache["fn"](
            batch, generator=fold_generator(generator, batch_rank(mesh)),
            **loss_kwargs)
        loss.backward()
        grads = {n: params[n].grad for n in names}
        if lay.tp:
            _all_reduce_buckets([local(grads[n]) for n in names
                                 if grads[n] is not None
                                 and tp_grad_kind(n) == "partial"],
                                mesh.group(("tensor",)))
        # the squared sums bucketed by the axes each gradient is split
        # across; the buckets come from the names alone, so every process
        # all-reduces the same ones in the same order
        split = {n: (("fsdp",) if lay.fsdp else ()) + (
            ("tensor",) if lay.tp and tp_grad_kind(n) == "local" else ())
            for n in names}
        buckets = {axes: torch.zeros((), device=loss.device)
                   for axes in sorted(set(split.values()))}
        for n in names:
            if grads[n] is not None:
                buckets[split[n]] += local(grads[n]).float().square().sum()
        for axes, v in buckets.items():
            if axes:
                dist.all_reduce(v, group=mesh.group(axes))
        gnorm = torch.sqrt(sum(buckets.values()))
        optimizer.update(grads, state["opt"], params, lr, wd_scale,
                         gnorm=gnorm)
        state["step"] += 1
        return state, _batch_metrics(loss, task_losses, gnorm, batch_group,
                                     n_batch)

    return stepper


def _batch_metrics(loss, task_losses, gnorm, batch_group, n_batch):
    """A sharded step's metrics: the loss and the 0-d extras averaged over
    the batch axes (one all-reduce), the grad norm, the other extras as
    they are."""
    import torch.distributed as dist

    scalars = {k: v for k, v in task_losses.items() if v.ndim == 0}
    means = torch.stack([loss.detach().float()] + [
        v.detach().float() for v in scalars.values()])
    dist.all_reduce(means, group=batch_group)
    means = means / n_batch
    metrics = {"loss": means[0], "grad_norm": gnorm}
    metrics.update({f"loss_{k}": v for k, v in zip(scalars, means[1:])})
    metrics.update({k: v.detach() for k, v in task_losses.items()
                    if v.ndim})
    return metrics


# ----------------------------------------------------- pipeline parallelism

def _shard_pp(state, mesh, model):
    """The 'pp' placement (mirage_tpu/train/steps.py:529-535): the stage
    keeps its ``encoder.{i}`` blocks (the others' slots emptied, so the
    kept ones keep their global names) and their moments, everything else
    whole; the model's encoder is bound to the stage's pipe."""
    from mirage_tpu_torch.parallel.pp import Pipe, pp_param_specs

    if model.pp is None:
        raise ValueError("mesh has a pipe axis > 1 but the model carries no "
                         "pp=('pipe', n_micro): build it with one")
    n_stages, stage = mesh.shape["pipe"], mesh.coords["pipe"]
    if model.depth % n_stages:
        raise ValueError(f"encoder depth {model.depth} is not divisible by "
                         f"{n_stages} pipeline stages")
    full = {"params": {n: (tuple(p.shape), p.dtype)
                       for n, p in state["params"].items()}}
    for k in ("mu", "nu"):
        if k in state["opt"]:
            full[k] = {n: (tuple(m.shape), m.dtype)
                       for n, m in state["opt"][k].items()}
    owners = pp_param_specs(full["params"], model.depth, n_stages)
    per = model.depth // n_stages
    for i in range(model.depth):
        if i // per != stage:
            model.encoder._modules[str(i)] = None
    device = next(model.parameters()).device
    lay = Layout("pp", mesh, model, pipe=Pipe(mesh, device), full=full,
                 owners=owners)
    model.encoder.pipe = lay.pipe
    params = dict(model.named_parameters())
    opt = {k: ({n: m for n, m in v.items() if n in params}
               if k in ("mu", "nu") else v)
           for k, v in state["opt"].items()}
    return {"params": params, "opt": opt, "step": state["step"],
            "layout": lay}


def gather_pp(parts: Mapping[str, torch.Tensor], lay: Layout, kind="params"):
    """The standard-layout whole leaves of ``kind`` ('params', 'mu', 'nu';
    a gradient gathers as its parameter) from this stage's ``parts`` (name
    -> tensor for the leaves it holds), on the host, in the standard order:
    one broadcast over 'pipe' from each stage of its leaves, flattened
    (per dtype). Collective over the pipe group."""
    pipe, full, owners = lay.pipe, lay.full[kind], lay.owners
    out = {n: parts[n].detach().to("cpu", copy=True)
           for n in full if owners[n] is None}
    device = next(iter(parts.values())).device
    for stage in range(pipe.size):
        mine = [n for n in full if owners[n] == stage]
        for dtype in sorted({full[n][1] for n in mine}, key=str):
            names = [n for n in mine if full[n][1] == dtype]
            sizes = [math.prod(full[n][0]) for n in names]
            if stage == pipe.stage:
                flat = torch.cat([parts[n].detach().reshape(-1).to(dtype)
                                  for n in names])
            else:
                flat = torch.empty(sum(sizes), dtype=dtype, device=device)
            flat = pipe.broadcast(flat, stage).cpu()
            for n, piece in zip(names, flat.split(sizes)):
                out[n] = piece.view(full[n][0]).clone()
    return {n: out[n] for n in full}


def _gather_pp_state(state):
    lay = state["layout"]
    opt = {}
    for k, v in state["opt"].items():
        if isinstance(v, dict):
            opt[k] = gather_pp(v, lay, k)
        else:
            opt[k] = v.detach().to("cpu", copy=True)
    return {"params": gather_pp(state["params"], lay),
            "opt": opt, "step": state["step"].detach().to("cpu", copy=True)}


def _all_reduce_buckets(tensors, group):
    """Sums each tensor over ``group`` in place, in flat buckets of at most
    :data:`BUCKET` elements (per dtype), one all-reduce a bucket, the same
    buckets in the same order on every process."""
    import torch.distributed as dist

    by_dtype: Dict[torch.dtype, list] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for dtype in sorted(by_dtype, key=str):
        bucket, size = [], 0
        for t in by_dtype[dtype] + [None]:
            if t is not None and (not bucket or size + t.numel() <= BUCKET):
                bucket.append(t)
                size += t.numel()
                continue
            flat = torch.cat([b.reshape(-1) for b in bucket])
            dist.all_reduce(flat, group=group)
            torch._foreach_copy_(bucket, [
                c.view_as(b) for c, b in zip(flat.split(
                    [b.numel() for b in bucket]), bucket)])
            bucket, size = ([t], t.numel()) if t is not None else ([], 0)


def _make_pp_step(loss_fn: Callable, optimizer: GroupedOptimizer, mesh):
    """The GPipe step (mirage_tpu/train/steps.py:_make_pp_train_step): the
    loss scaled by 1/S and ``backward`` through the schedule; the 'sum'
    leaves' gradients (with a flag a leaf: a leaf no stage reached keeps no
    gradient, as on one GPU) all-reduced over 'pipe'; every gradient
    averaged over the batch axes; the norm sqrt(replicated² +
    all-reduce_pipe(local²)); the update on the stage's leaves."""
    from mirage_tpu_torch.parallel.mesh import batch_count, batch_rank
    from mirage_tpu_torch.parallel.pp import pp_grad_kind

    if mesh.shape["fsdp"] > 1 or mesh.shape["tensor"] > 1:
        raise ValueError(PIPE_SCOPE.format(dict(mesh.shape)))
    if getattr(optimizer, "cfg", None) is not None \
            and optimizer.cfg.layer_decay is not None:
        raise ValueError(
            "pipeline parallelism requires layer_decay=None: the "
            "layer-decay lr scales span the full depth, which a stage's "
            "blocks do not (parallel/pp.py scope note)")
    batch_group = mesh.group(("data", "fsdp"))
    n_batch = batch_count(mesh)
    n_stages = mesh.shape["pipe"]
    reached = {}  # the 'sum' leaves some stage's backward reaches

    def stepper(state, batch, generator, lr, wd_scale=1.0, **loss_kwargs):
        lay = state["layout"]
        if lay.mesh is not mesh or lay.kind != "pp":
            raise ValueError("the state was not placed on this mesh's "
                             "pipeline layout")
        pipe = lay.pipe
        params = state["params"]
        names = [n for n, p in params.items() if p.requires_grad]
        for n in names:
            params[n].grad = None
        loss, task_losses = loss_fn(
            batch, generator=fold_generator(generator, batch_rank(mesh)),
            **loss_kwargs)
        (loss / n_stages).backward()
        kinds = pp_grad_kind(names)
        grads = {n: params[n].grad for n in names}
        summed = [n for n in names if kinds[n] == "sum"]
        dev = loss.device
        flags = []
        if "names" not in reached:  # the same leaves every step: once
            flags = [torch.tensor([grads[n] is not None for n in summed],
                                  dtype=torch.float32, device=dev)]
        for n in summed:
            if grads[n] is None:
                grads[n] = torch.zeros_like(params[n])
        _all_reduce_buckets([grads[n] for n in summed] + flags, pipe.group)
        if flags:
            reached["names"] = {n for n, f in zip(summed, flags[0].tolist())
                                if f}
        for n in summed:
            if n not in reached["names"]:
                grads[n] = None
        held = [grads[n] for n in names if grads[n] is not None]
        if n_batch > 1:
            _all_reduce_buckets(held, batch_group)
            torch._foreach_div_(held, float(n_batch))
        sq = {"local": torch.zeros((), device=dev),
              "sum": torch.zeros((), device=dev)}
        for n in names:
            if grads[n] is not None:
                sq[kinds[n]] += grads[n].float().square().sum()
        gnorm = torch.sqrt(sq["sum"] + pipe.sum(sq["local"]))
        optimizer.update(grads, state["opt"], params, lr, wd_scale,
                         gnorm=gnorm)
        state["step"] += 1
        return state, _batch_metrics(loss, task_losses, gnorm, batch_group,
                                     n_batch)

    return stepper
