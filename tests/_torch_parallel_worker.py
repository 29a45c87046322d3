"""Worker processes of the port's multi-process tests (gloo on the CPU).

Imported by ``multiprocessing``'s spawn in a fresh interpreter: it imports
neither JAX nor the JAX package, and the test files import its constants.
Each worker joins a group through a ``FileStore`` file (no TCP port), runs
one task and writes what rank 0 gathered to ``out``.
"""

import datetime
import multiprocessing
import os
import traceback

import numpy as np
import torch

DOMAINS = ["bscan", "slo", "bscanlayermap"]
# the tiny model: dim 64, depth 2, 4 heads (dh 16); 64² inputs at patch 8,
# 64 tokens a task; decoders 32 wide with 2 heads
ARGS = dict(model="miragepre_tiny", num_global_tokens=1, in_domains=DOMAINS,
            out_domains=DOMAINS, dim_tokens=64, depth=2, num_heads=4,
            decoder_dim=32, decoder_depth=1, decoder_num_heads=2)
SIZE, PATCH, N_TASK, NUM_VISIBLE, BATCH = 64, 8, 64, 24, 8
GEOMETRY = {d: ((SIZE, SIZE), (PATCH, PATCH)) for d in DOMAINS}
DOMAIN_CONF = {"bscan": {"loss": "mse", "patch_size": PATCH,
                         "norm_pix": True},
               "slo": {"loss": "mse", "patch_size": PATCH, "norm_pix": True},
               "bscanlayermap": {"loss": "ce", "patch_size": PATCH}}
# the four layouts on four processes, as mesh axes
LAYOUTS = {"dp": {"data": 4}, "fsdp": {"data": 2, "fsdp": 2},
           "tp": {"data": 2, "tensor": 2}, "tp_fsdp": {"fsdp": 2, "tensor": 2}}
TIMEOUT = 120
ADAM_EPS = 1e-5


def make_batch(seed, b=BATCH, visible=NUM_VISIBLE):
    """Images, labels and explicit masks (1 = masked) carried as batch
    leaves "mask_<task>", ``visible`` visible tokens a sample and at least
    one masked token a task."""
    rng = np.random.default_rng(seed)
    x = {"bscan": rng.random((b, 1, SIZE, SIZE), dtype=np.float32),
         "slo": rng.random((b, 1, SIZE, SIZE), dtype=np.float32),
         "bscanlayermap": rng.integers(0, 13, (b, SIZE, SIZE)).astype(
             np.int32)}
    mask = np.ones((b, 3 * N_TASK), np.int32)
    for i in range(b):
        mask[i, rng.choice(3 * N_TASK, visible, replace=False)] = 0
    for k, t in enumerate(DOMAINS):
        x[f"mask_{t}"] = mask[:, k * N_TASK:(k + 1) * N_TASK]
    return x


def build_tiny(state_dict=None, remat=False):
    from mirage_tpu_torch.api.wrapper import build_model

    model = build_model("miragepre_tiny", ARGS, DOMAINS, geometry=GEOMETRY,
                        remat=remat)
    if state_dict is not None:
        model.load_state_dict(state_dict, strict=True)
    return model


def masked_loss(model, visible=NUM_VISIBLE):
    """The pretraining loss reading its masks (``visible`` visible tokens
    a sample) from the batch."""
    from mirage_tpu_torch.train.steps import make_pretrain_loss

    base = make_pretrain_loss(model, DOMAIN_CONF, visible)

    def loss_fn(batch, generator=None):
        return base({t: batch[t] for t in DOMAINS}, generator,
                    task_masks={t: batch[f"mask_{t}"] for t in DOMAINS},
                    num_visible=visible)

    return loss_fn


def optimizer(clip_grad):
    from mirage_tpu_torch.train.optim import GroupedOptimizer, OptimizerConfig

    # eps 1e-5: the key rows of a qkv or kv bias get a gradient that is
    # zero in exact arithmetic (softmax ignores a constant added to a row of
    # scores), so two implementations leave different ~1e-8 rounding there,
    # which Adam's g/(√v + eps) would magnify to ±lr; at 1e-5 it stays
    # ~1e-6 while every other leaf moves by ~lr
    return GroupedOptimizer(OptimizerConfig(eps=ADAM_EPS,
                                            clip_grad=clip_grad))


def run_steps(model, opt, batches, mesh=None, layout=None, lr=1e-3,
              visible=NUM_VISIBLE):
    """Two steps of the masked pretraining loss from whole-batch numpy
    ``batches``; on a mesh each process takes its stripe (a model with
    ``pp`` set takes the pipeline step). Returns (losses, grad norms, the
    standard-layout whole state)."""
    from mirage_tpu_torch.parallel.mesh import local_batch
    from mirage_tpu_torch.train.steps import (gather_state, init_train_state,
                                              make_train_step, shard_state,
                                              step_generator)

    state = init_train_state(model, opt)
    if mesh is not None:
        state = shard_state(state, mesh, model, tp_num_heads=ARGS["num_heads"],
                            layout=layout)
    step = make_train_step(masked_loss(model, visible), opt, mesh=mesh,
                           pp=model.pp is not None)
    losses, norms = [], []
    for it, whole in enumerate(batches):
        batch = {k: torch.from_numpy(v) for k, v in whole.items()}
        if mesh is not None:
            batch = local_batch(batch, mesh)
        state, metrics = step(state, batch, step_generator(0, it, "cpu"), lr)
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
    return losses, norms, state


def task_layouts(rank, world, workdir):
    """The cases of ``workdir/layouts.json`` ([name, layout, clip_grad]):
    two steps each and the gathered state. With "resume": the last case's
    checkpoint read into dp, written again and read back into that
    layout; with "cls": two data-parallel classification steps."""
    import json

    from mirage_tpu_torch.parallel.mesh import make_mesh
    from mirage_tpu_torch.train import checkpoint as ckpt
    from mirage_tpu_torch.train.steps import (gather_state, init_train_state,
                                              shard_state)

    with open(os.path.join(workdir, "layouts.json")) as f:
        spec = json.load(f)
    init = torch.load(os.path.join(workdir, "init.pt"))
    batches = [make_batch(s) for s in (11, 12)]
    out = {}
    for name, kind, clip in spec["cases"]:
        mesh = make_mesh(dict(LAYOUTS[kind]))
        model = build_tiny(init)
        losses, norms, state = run_steps(model, optimizer(clip), batches,
                                         mesh, kind)
        out[name] = {"loss": losses, "grad_norm": norms,
                     **gather_state(state)}
    if spec.get("resume"):
        ckpt.save_checkpoint(workdir, state, 0)
        for epoch, kind in enumerate(("dp", spec["cases"][-1][1])):
            mesh = make_mesh(dict(LAYOUTS[kind]))
            model = build_tiny(init)
            opt = optimizer(None)
            state = shard_state(init_train_state(model, opt), mesh, model,
                                tp_num_heads=ARGS["num_heads"], layout=kind)
            state, _ = ckpt.load_checkpoint(
                os.path.join(workdir, f"checkpoint-{epoch}"), state)
            out[f"resumed_{kind}"] = gather_state(state)
            ckpt.save_checkpoint(workdir, state, epoch + 1)
    if spec.get("cls"):
        losses, whole = cls_dp_steps(workdir, make_mesh())
        out["cls"] = {"loss": losses, **whole}
    return out


CLS_CLASSES = 4


def cls_batches():
    """Two batches of 8 for the classification steps; every other row has
    weight 0, so each of 4 stripes weighs 1 and the mean of the stripes'
    losses is the whole batch's loss."""
    rng = np.random.default_rng(21)
    return [{"images": rng.random((BATCH, 1, SIZE, SIZE), dtype=np.float32),
             "targets": rng.integers(0, CLS_CLASSES, BATCH).astype(np.int64),
             "weights": np.tile(np.float32([1, 0]), BATCH // 2)}
            for _ in range(2)]


def cls_setup(workdir):
    """(model, optimizer, loss) of the tiny classifier over the weights
    ``write_cls_weights`` wrote into ``workdir``."""
    from mirage_tpu_torch.api.cls import miragecls_factory
    from mirage_tpu_torch.train.steps import make_cls_loss

    model = miragecls_factory["global"](
        num_classes=CLS_CLASSES, input_size=SIZE, patch_size=PATCH,
        weights=os.path.join(workdir, "mirage-base_tiny.pth"),
        model_override="miragepre_tiny", device="cpu")
    from mirage_tpu_torch.train.optim import GroupedOptimizer, OptimizerConfig

    opt = GroupedOptimizer(OptimizerConfig(
        opt="adamw", betas=(0.9, 0.999), eps=ADAM_EPS, weight_decay=1e-2))
    return model, opt, make_cls_loss(model, 0.1)


def write_cls_weights(workdir):
    """A tiny pretraining checkpoint named as MIRAGE-Base, from a seed."""
    from mirage_tpu_torch.api.wrapper import build_model

    model = build_model("miragepre_tiny", ARGS, DOMAINS, SIZE, PATCH,
                        generator=torch.Generator().manual_seed(3))
    torch.save({"model": model.state_dict(), "args": ARGS},
               os.path.join(workdir, "mirage-base_tiny.pth"))


def cls_dp_steps(workdir, mesh=None):
    """Two classification steps, data-parallel on ``mesh`` (each process
    its stripe) or in one process: (losses, the whole state)."""
    from mirage_tpu_torch.parallel.mesh import local_batch
    from mirage_tpu_torch.train.steps import (gather_state, init_train_state,
                                              make_train_step, shard_state,
                                              step_generator)

    model, opt, loss_fn = cls_setup(workdir)
    state = init_train_state(model, opt)
    if mesh is not None:
        state = shard_state(state, mesh, model)
    step = make_train_step(loss_fn, opt, mesh=mesh)
    losses = []
    for it, whole in enumerate(cls_batches()):
        batch = {k: torch.from_numpy(v) for k, v in whole.items()}
        if mesh is not None:
            batch = local_batch(batch, mesh)
        state, metrics = step(state, batch, step_generator(0, it, "cpu"),
                              1e-3)
        losses.append(float(metrics["loss"]))
    return losses, gather_state(state)


# the tensor-parallel block's test: width, heads, tokens, batch
BLOCK_D, BLOCK_H, BLOCK_N, BLOCK_B = 32, 4, 10, 2


def task_tp_block(rank, world, workdir):
    """ident_f / psum_g on a (2, 3) tensor; the tensor-parallel block's
    output and gradients (qkv leaves unrelayouted, shards gathered, the
    LayerNorms' partial gradients all-reduced as the step does), without
    and with remat (an Encoder of that block)."""
    import torch.distributed as dist

    from mirage_tpu_torch.models.encoder import Encoder
    from mirage_tpu_torch.parallel.mesh import make_mesh
    from mirage_tpu_torch.parallel.tp import (ident_f, psum_g, tp_grad_kind,
                                              tp_leaf_axis, tp_relayout,
                                              tp_slice, tp_unrelayout)

    mesh = make_mesh({"tensor": world})
    group = mesh.group(("tensor",))
    out = {}
    a = torch.arange(6.0).view(2, 3).add(rank).requires_grad_()
    y = psum_g(a, group)
    (y * (rank + 1)).sum().backward()
    out["psum_g"] = (y.detach(), a.grad.clone())
    b = torch.arange(6.0).view(2, 3).requires_grad_()
    z = ident_f(b, group)
    (z * (rank + 1)).sum().backward()
    out["ident_f"] = (z.detach(), b.grad.clone())

    spec = torch.load(os.path.join(workdir, "block.pt"))
    for remat in (False, True):
        enc = Encoder(1, BLOCK_D, BLOCK_H, qkv_bias=True, remat=remat)
        sd = tp_relayout({f"encoder.0.{k}": v for k, v in
                          spec["sd"].items()}, BLOCK_H, world)
        with torch.no_grad():
            for n, p in enc.named_parameters():
                p.data = tp_slice(sd["encoder." + n], "encoder." + n, rank,
                                  world).contiguous().clone()
        enc.tp = (group, world)
        x = spec["x"].clone().requires_grad_()
        y = enc(x, deterministic=False)
        (y * spec["cot"]).sum().backward()
        grads = {}
        for n, p in enc.named_parameters():
            g = p.grad
            name = "encoder." + n
            if tp_grad_kind(name) == "partial":
                dist.all_reduce(g, group=group)
            axis = tp_leaf_axis(name)
            if axis is not None:
                parts = [torch.empty_like(g) for _ in range(world)]
                dist.all_gather(parts, g.contiguous(), group=group)
                g = torch.cat(parts, axis)
            grads[n] = g
        grads = tp_unrelayout({"encoder." + n: g for n, g in grads.items()},
                              BLOCK_H, world)
        out[f"block_remat{int(remat)}"] = {
            "y": y.detach(), "dx": x.grad,
            "grads": {n[len("encoder.0."):]: g for n, g in grads.items()}}
    return out


def tiny_depth(base, depth):
    """A ``model_dims`` that gives the dev size ("tiny" in a model name)
    ``depth`` blocks, else ``base``'s (the pretraining command line has no
    depth flag, and a pipeline over two stages needs an even depth)."""

    def dims(name, args):
        width, d, heads = base(name, args)
        return (width, depth, heads) if "tiny" in name else (width, d, heads)

    return dims


def task_cli(rank, world, workdir):
    """A command line's main in every process: the module and argv of
    ``workdir/cli.json`` (and its "tiny_depth"); returns rank 0's log rows
    (or its result)."""
    import importlib
    import json

    with open(os.path.join(workdir, "cli.json")) as f:
        spec = json.load(f)
    if spec.get("tiny_depth"):
        from mirage_tpu_torch.api import wrapper

        wrapper.model_dims = tiny_depth(wrapper.model_dims,
                                        spec["tiny_depth"])
    out = importlib.import_module(spec["module"]).main(spec["argv"])
    return out.get("log", out) if isinstance(out, dict) else out


# the pipeline cases on four processes: data 2 x pipe 2 (depth 2: one
# block a stage), two microbatches of the local batch of 4
PP_AXES = {"data": 2, "pipe": 2}
PP_MICRO = 2


def task_pp(rank, world, workdir):
    """The cases of ``workdir/pp.json`` ([name, clip_grad, remat, visible
    tokens]) on PP_AXES: two pipeline steps each from ``init.pt``, then
    the gathered standard-layout state; with "resume": the last case's
    checkpoint read into dp and back into the pipeline."""
    import json

    from mirage_tpu_torch.parallel.mesh import make_mesh
    from mirage_tpu_torch.train import checkpoint as ckpt
    from mirage_tpu_torch.train.steps import (gather_state, init_train_state,
                                              shard_state)

    with open(os.path.join(workdir, "pp.json")) as f:
        spec = json.load(f)
    init = torch.load(os.path.join(workdir, "init.pt"))
    out = {}
    for name, clip, remat, visible in spec["cases"]:
        mesh = make_mesh(dict(PP_AXES))
        model = build_tiny(init, remat=remat)
        model.pp = ("pipe", PP_MICRO)
        batches = [make_batch(s, visible=visible) for s in (11, 12)]
        losses, norms, state = run_steps(model, optimizer(clip), batches,
                                         mesh, visible=visible)
        out[name] = {"loss": losses, "grad_norm": norms,
                     "kept": sorted(state["params"]),
                     **gather_state(state)}
    if spec.get("resume"):
        ckpt.save_checkpoint(workdir, state, 0)
        for epoch, axes in enumerate(({"data": world}, dict(PP_AXES))):
            mesh = make_mesh(axes)
            model = build_tiny(init)
            if "pipe" in axes:
                model.pp = ("pipe", PP_MICRO)
            opt = optimizer(None)
            state = shard_state(init_train_state(model, opt), mesh, model)
            state, _ = ckpt.load_checkpoint(
                os.path.join(workdir, f"checkpoint-{epoch}"), state)
            out[f"resumed_{state['layout'].kind}"] = gather_state(state)
            ckpt.save_checkpoint(workdir, state, epoch + 1)
    return out


TASKS = {"layouts": task_layouts, "tp_block": task_tp_block,
         "cli": task_cli, "pp": task_pp}


def run(rank, world, store, task, workdir):
    """One worker: join the group, run ``task``, rank 0 saves its result
    to ``workdir/out.pt``; any failure is written to ``workdir/err<rank>``
    and exits non-zero."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        dist.init_process_group(
            "gloo", init_method=f"file://{store}", rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=TIMEOUT))
        out = TASKS[task](rank, world, workdir)
        if rank == 0:
            torch.save(out, os.path.join(workdir, "out.pt"))
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(workdir, f"err{rank}"), "w") as f:
            f.write(traceback.format_exc())
        raise


class Workers:
    """``world`` spawned processes running ``task``; :meth:`result` joins
    them (each join bounded by ``timeout``) and returns rank 0's result,
    or raises with the workers' tracebacks if one failed or hung. No
    process is left behind."""

    def __init__(self, task, world, workdir, timeout=TIMEOUT):
        ctx = multiprocessing.get_context("spawn")
        store = os.path.join(workdir, "store")
        self.task, self.workdir, self.timeout = task, workdir, timeout
        self.procs = [ctx.Process(target=run,
                                  args=(r, world, store, task, workdir))
                      for r in range(world)]
        for p in self.procs:
            p.start()

    def result(self):
        try:
            for p in self.procs:
                p.join(self.timeout)
        finally:
            hung = [p for p in self.procs if p.is_alive()]
            for p in hung:
                p.kill()
                p.join(10)
        errs = [open(os.path.join(self.workdir, f)).read()
                for f in sorted(os.listdir(self.workdir))
                if f.startswith("err")]
        codes = [p.exitcode for p in self.procs]
        if hung or errs or any(codes):
            raise RuntimeError(f"{self.task}: exit codes {codes}, hung "
                               f"{len(hung)}\n" + "\n".join(errs))
        return torch.load(os.path.join(self.workdir, "out.pt"),
                          weights_only=False)


def spawn(task, world, workdir, timeout=TIMEOUT):
    """Runs ``task`` on ``world`` spawned processes; rank 0's result."""
    return Workers(task, world, workdir, timeout).result()
