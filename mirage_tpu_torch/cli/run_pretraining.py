"""MIRAGE multimodal masked pretraining on the PyTorch/CUDA port.

Counterpart of ``mirage_tpu/cli/run_pretraining.py`` (reference
run_pretraining.py): three domains in and out, Dirichlet masking with
``num_encoded_tokens`` visible (or ``perc_encoded_tokens`` of all), the
masked MSE (bscan, slo) and CE (bscanlayermap) losses summed, AdamW with
per-step cosine LR and WD schedules (``lr = blr · batch / 256``), gradient
clipping and skipping, a checkpoint every ``save_ckpt_freq`` epochs and at
the last, resuming from the newest one, reconstruction panels at the start
of every 20th epoch, a hard exit on a non-finite loss, warm starts from
MultiMAE-B / MAE weights (``blocks.`` renamed ``encoder.``).

Usage:
  python -m mirage_tpu_torch.cli.run_pretraining -c configs/pretrain_mirage_98_1600e.yaml \\
      --data_path /data/pretrain --output_dir ./out [--device cuda]

Several GPUs, one process each (``parallel/mesh.py``, ``train/steps.py``):
  torchrun --nproc_per_node 8 -m mirage_tpu_torch.cli.run_pretraining \
      -c configs/pretrain_mirage_98_1600e.yaml --data_path ... \
      [--mesh_tensor 2] [--mesh_fsdp 2] [--mesh_pipe 2 [--pp_microbatches 4]]

``--device`` defaults to ``cuda`` and fails without a card; ``--device cpu``
runs the plain PyTorch path (gloo between processes). The dataset is
``{data_path}/{task}/...`` per domain with matching file names
(``data/folder.py:MultiTaskPretDatasetFolder``). Each step draws its masks
(and drop-path) from a ``torch.Generator`` on the device seeded from (seed +
1, step), folded by the process's batch position, so a resumed run repeats
the same steps; the metrics stay on the device and are read on log steps
only.

The mesh (mirage_tpu/cli/run_pretraining.py:253-320): 'tensor' is
``--mesh_tensor`` (it must divide the heads and the MLP hidden width),
'fsdp' ``--mesh_fsdp``, 'pipe' ``--mesh_pipe`` (GPipe stages over the
encoder's depth, ``parallel/pp.py``: with 'data' only, a depth it divides
and ``--drop_path 0``; ``--pp_microbatches`` M a divisor of the local
batch, by default 2·S shrunk to one, the bubble (S − 1)/(M + S − 1)
printed), and 'data' what remains of the processes; the layout follows
(dp, fsdp, tp, tp_fsdp or pp). ``--distributed`` with
``--coordinator_address`` / ``--num_processes`` / ``--process_id`` joins
the group at tcp://ADDRESS (torchrun's environment fills in what is not
given); torchrun alone is enough. ``--batch_size`` keeps the JAX command
line's meaning: the batch of one host (here: the processes of one node
under torchrun, or one process launched by hand with ``--distributed``),
split over its processes; the learning rate scales with it times the
hosts. Process 0 alone logs and writes.
"""

import argparse
import contextlib
import math
import os
import sys
import time

import numpy as np
import torch

from mirage_tpu_torch.api import wrapper
from mirage_tpu_torch.cli.config import (normalize_domain_sizes,
                                         parse_with_yaml, save_args, str2bool)

def get_parser():
    p = argparse.ArgumentParser("MIRAGE pretraining (PyTorch/CUDA)")
    # schedule / batch
    p.add_argument("--batch_size", default=256, type=int,
                   help="the batch of one host (a node's processes under "
                        "torchrun, else one process), split over its "
                        "processes' batch stripes (data x fsdp)")
    p.add_argument("--epochs", default=1600, type=int)
    p.add_argument("--save_ckpt_freq", default=20, type=int)
    # tasks
    p.add_argument("--in_domains", default="bscan-slo-bscanlayermap", type=str)
    p.add_argument("--out_domains", default="bscan-slo-bscanlayermap",
                   type=str)
    # model
    p.add_argument("--model", default="miragepre_base", type=str)
    p.add_argument("--num_encoded_tokens", default=98, type=int)
    p.add_argument("--perc_encoded_tokens", default=None, type=float)
    p.add_argument("--num_global_tokens", default=1, type=int)
    p.add_argument("--patch_size", default=32, type=int)
    p.add_argument("--input_size", default=512, type=int)
    p.add_argument("--alphas", default=1.0, type=float)
    p.add_argument("--sample_tasks_uniformly", default=False,
                   action="store_true")
    p.add_argument("--decoder_use_task_queries", default=True, type=str2bool)
    p.add_argument("--decoder_use_xattn", default=True, type=str2bool)
    p.add_argument("--decoder_dim", default=256, type=int)
    p.add_argument("--decoder_depth", default=2, type=int)
    p.add_argument("--decoder_num_heads", default=8, type=int)
    p.add_argument("--drop_path", default=0.0, type=float)
    p.add_argument("--loss_on_unmasked", default=False, action="store_true")
    p.add_argument("--norm_pix_loss", default=False, action="store_true")
    # optimizer
    p.add_argument("--opt", default="adamw", type=str)
    p.add_argument("--opt_eps", default=1e-8, type=float)
    p.add_argument("--opt_betas", default=[0.9, 0.95], type=float, nargs="+")
    p.add_argument("--clip_grad", default=None, type=float)
    p.add_argument("--skip_grad", default=None, type=float)
    p.add_argument("--weight_decay", default=0.05, type=float)
    p.add_argument("--weight_decay_end", default=None, type=float)
    p.add_argument("--decoder_decay", default=None, type=float)
    p.add_argument("--blr", default=1e-4, type=float,
                   help="base lr; lr = blr * batch_size / 256")
    p.add_argument("--lr", default=None, type=float)
    p.add_argument("--warmup_lr", default=1e-6, type=float)
    p.add_argument("--min_lr", default=0.0, type=float)
    p.add_argument("--warmup_epochs", default=40, type=int)
    p.add_argument("--warmup_steps", default=-1, type=int)
    # augmentation
    p.add_argument("--hflip", default=0.5, type=float)
    p.add_argument("--intensity_shift", default=0.1, type=float)
    p.add_argument("--affine", default=True, type=str2bool)
    # data / io
    p.add_argument("--data_path", required=True, type=str)
    p.add_argument("--output_dir", default="./output/pretrain", type=str)
    p.add_argument("--num_workers", default=10, type=int)
    p.add_argument("--use_cache", default=False, action="store_true")
    p.add_argument("--weights", default="", type=str,
                   help="warm-start checkpoint (.pth/.safetensors)")
    p.add_argument("--auto_resume", default=True, type=str2bool)
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--dtype", default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--remat", default=True, type=str2bool,
                   help="per-layer activation checkpointing of the encoder "
                        "blocks whose ops keep their intermediates")
    p.add_argument("--mesh_fsdp", default=1, type=int,
                   help="processes the parameters and moments shard over")
    p.add_argument("--mesh_tensor", default=1, type=int,
                   help="processes the encoder runs tensor-parallel over")
    p.add_argument("--mesh_pipe", default=1, type=int,
                   help="GPipe pipeline stages over the encoder depth "
                        "(parallel/pp.py; kernels engaged; composes with "
                        "data parallelism only; requires --drop_path 0)")
    p.add_argument("--pp_microbatches", default=0, type=int,
                   help="microbatches per local batch for --mesh_pipe > 1 "
                        "(0 = auto: 2x stages, shrunk to divide the local "
                        "batch; bubble fraction is (S-1)/(M+S-1))")
    p.add_argument("--distributed", default=False, action="store_true",
                   help="join a process group (torchrun's, or the one the "
                        "next three flags give)")
    p.add_argument("--coordinator_address", default=None, type=str)
    p.add_argument("--num_processes", default=None, type=int)
    p.add_argument("--process_id", default=None, type=int)
    p.add_argument("--log_freq", default=20, type=int)
    p.add_argument("--debug_images", default=True, type=str2bool)
    p.add_argument("--max_steps_per_epoch", default=None, type=int,
                   help="debug/smoke-run cap")
    p.add_argument("--profile_dir", default=None, type=str,
                   help="write a torch.profiler trace of the first epoch "
                        "and its spans' summary (spans.json) into this "
                        "directory")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; fails without a card) or cpu")
    return p


# the adapters of api/wrapper.py:default_domain_conf, with each task's loss
DOMAIN_DEFAULTS = {d: {**wrapper.default_domain_conf(d), "loss": loss}
                   for d, loss in (("bscan", "mse"), ("slo", "mse"),
                                   ("bscanlayermap", "ce"))}

# weight-file name substring -> model (run_pretraining.py:353-368 and
# docs/pretraining.md: 'multimae-b' warm-starts MIRAGE-Base, 'mae_pretrain'
# MIRAGE-Large)
WARMSTART_MODEL_KEYS = {"multimae-b": "miragepre_base",
                        "mae_pretrain": "miragepre_large"}


def process_args(args):
    """Domains as lists, per-domain sizes and grids, and the visible-token
    count from ``perc_encoded_tokens``."""
    if args.mesh_fsdp < 1 or args.mesh_tensor < 1 or args.mesh_pipe < 1:
        sys.exit("--mesh_fsdp, --mesh_tensor and --mesh_pipe must be at "
                 "least 1")
    args.in_domains = args.in_domains.split("-")
    args.out_domains = args.out_domains.split("-")
    args.all_domains = sorted(set(args.in_domains) | set(args.out_domains))
    normalize_domain_sizes(args, args.all_domains)
    total = sum(args.grid_size[d][0] * args.grid_size[d][1]
                for d in args.in_domains)
    if args.perc_encoded_tokens is not None:
        args.num_encoded_tokens = int(total * args.perc_encoded_tokens)
    print(f"Tokens: {args.num_encoded_tokens} encoded of {total}")
    return args


def check_pipeline(args):
    """The pipeline's refusals that need no process group, in the JAX
    command line's order and words (mirage_tpu/cli/run_pretraining.py:
    295-306): 'pipe' with 'data' only, a depth it divides, drop-path 0."""
    s = args.mesh_pipe
    if s == 1:
        return
    if args.mesh_fsdp > 1 or args.mesh_tensor > 1:
        sys.exit("--mesh_pipe composes only with data parallelism "
                 "(pipe x fsdp/tensor is not implemented)")
    _, depth, _ = wrapper.model_dims(args.model, vars(args))
    if depth % s:
        sys.exit(f"--mesh_pipe {s} must divide the encoder depth ({depth})")
    if args.drop_path != 0.0:
        sys.exit("--mesh_pipe requires --drop_path 0 (per-layer rates "
                 "span the full depth — parallel/pp.py scope note; every "
                 "reference pretraining config uses 0.0)")


def pipeline_microbatches(stages: int, requested: int, local_b: int) -> int:
    """M of a pipeline of ``stages`` over a local batch of ``local_b``:
    ``requested`` (a positive divisor of the local batch, else the run
    exits), or with 0 the JAX command line's automatic 2·S shrunk to a
    divisor (mirage_tpu/cli/run_pretraining.py:307-316); prints the
    bubble fraction."""
    if requested:
        n_micro = requested
        if n_micro < 1 or local_b % n_micro:
            sys.exit(f"--pp_microbatches {n_micro} must be a positive "
                     f"divisor of the local batch ({local_b} = batch_size "
                     f"x hosts / (data x fsdp))")
    else:  # auto: 2x stages, shrunk to the nearest divisor
        n_micro = min(local_b, 2 * stages)
        while local_b % n_micro:
            n_micro -= 1
    print(f">> pipe mesh: GPipe step, {stages} stages x {n_micro} "
          f"microbatches (bubble "
          f"{(stages - 1) / (n_micro + stages - 1):.0%}, kernels engaged)")
    return n_micro


def build_model(args, generator=None):
    """The MultiMAE model of ``args`` (weights from ``generator``)."""
    geometry = {d: (args.input_size[d], args.patch_size[d])
                for d in args.all_domains}
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    return wrapper.build_model(
        args.model, vars(args), args.in_domains, compute_dtype=dtype,
        generator=generator, geometry=geometry,
        drop_path_rate=args.drop_path, remat=args.remat)


def pick_model_from_weights(args, default: str = "miragepre_base"):
    if args.model != default or not args.weights:
        return args.model
    for kw, name in WARMSTART_MODEL_KEYS.items():
        if kw in os.path.basename(args.weights).lower():
            print(f">> Model {name} selected by weights filename ('{kw}')")
            return name
    return args.model


def warm_start(model, weights_path: str):
    """Overlays a ``.pth`` or ``.safetensors`` state dict onto the model
    (MAE's ``blocks.{i}`` keys read as ``encoder.{i}``); returns the
    model's keys it did not fill."""
    from mirage_tpu_torch.api import convert

    if weights_path.endswith(".pth"):
        sd = convert.load_torch_checkpoint(weights_path)["model"]
    else:
        sd = convert.load_safetensors(weights_path)
    if "_vit_large" in weights_path or any(k.startswith("blocks.")
                                           for k in sd):
        sd = convert.rename_keys(sd, {r"^blocks\.": "encoder."})
    print(f">> Warm start from {weights_path} ({len(sd)} tensors)")
    return convert.overlay_state_dict(model, sd)


def make_loss(model, args):
    """The pretraining loss of ``args`` (train/steps.py:
    make_pretrain_loss)."""
    from mirage_tpu_torch.train.steps import make_pretrain_loss

    domain_conf = {d: {"loss": DOMAIN_DEFAULTS[d]["loss"],
                       "patch_size": args.patch_size[d][0],
                       "norm_pix": args.norm_pix_loss}
                   for d in args.out_domains}
    return make_pretrain_loss(
        model, domain_conf, args.num_encoded_tokens, alphas=args.alphas,
        sample_tasks_uniformly=args.sample_tasks_uniformly,
        loss_on_unmasked=args.loss_on_unmasked)


def setup(args, device):
    """The model (warm-started, on ``device``), the optimizer and the loss
    function of a run, as ``main`` builds them."""
    from mirage_tpu_torch.train.optim import OptimizerConfig, create_optimizer

    args.model = pick_model_from_weights(args)
    model = build_model(args, torch.Generator().manual_seed(args.seed))
    if args.weights:
        warm_start(model, args.weights)
    model = model.to(device)
    opt = create_optimizer(OptimizerConfig(
        opt=args.opt, betas=tuple(args.opt_betas), eps=args.opt_eps,
        weight_decay=args.weight_decay, clip_grad=args.clip_grad,
        skip_grad=args.skip_grad, decoder_decay=args.decoder_decay))
    return model, opt, make_loss(model, args)


def setup_mesh(args, device):
    """(device, mesh, hosts): for a multi-process run (``--distributed``,
    torchrun's WORLD_SIZE above 1, or a process group already joined) the
    group is joined, the device is this process's, and the mesh is
    ('data': the rest, 'fsdp', 'tensor', 'pipe'); else (device, None, 1).
    Exits on a model axis above 1 without a group, on ``--distributed``
    without a rendezvous and on a mesh that does not divide the
    processes."""
    import torch.distributed as dist

    from mirage_tpu_torch.parallel.mesh import init_distributed, make_mesh

    if not (args.distributed or int(os.environ.get("WORLD_SIZE", "1")) > 1
            or dist.is_initialized()):
        if args.mesh_fsdp > 1 or args.mesh_tensor > 1 or args.mesh_pipe > 1:
            sys.exit(f"--mesh_fsdp {args.mesh_fsdp} x --mesh_tensor "
                     f"{args.mesh_tensor} x --mesh_pipe {args.mesh_pipe} "
                     f"needs as many processes: run under torchrun (or "
                     f"with --distributed)")
        return device, None, 1
    if not (dist.is_initialized() or args.coordinator_address
            or "MASTER_ADDR" in os.environ):
        sys.exit("--distributed needs --coordinator_address or torchrun's "
                 "environment (MASTER_ADDR)")
    device = init_distributed(
        device, world_size=args.num_processes, rank=args.process_id,
        init_method=(f"tcp://{args.coordinator_address}"
                     if args.coordinator_address else None))
    world = dist.get_world_size()
    model_axes = args.mesh_fsdp * args.mesh_tensor * args.mesh_pipe
    if world % model_axes:
        sys.exit(f"--mesh_fsdp {args.mesh_fsdp} x --mesh_tensor "
                 f"{args.mesh_tensor} x --mesh_pipe {args.mesh_pipe} does "
                 f"not divide {world} processes")
    mesh = make_mesh({"data": world // model_axes, "fsdp": args.mesh_fsdp,
                      "tensor": args.mesh_tensor, "pipe": args.mesh_pipe},
                     device.type)
    hosts = world // int(os.environ.get("LOCAL_WORLD_SIZE", "1"))
    print(f"process {dist.get_rank()}/{world} on {device}, mesh "
          f"{mesh.shape}, {hosts} host(s)")
    return device, mesh, hosts


@torch.no_grad()
def debug_forward(model, batch, args, epoch: int):
    """The epoch-start forward of the reconstruction panels: the first 8
    samples, masked, deterministic; (preds, masks). Under a pipeline every
    stage calls it (the forward runs the schedule), in microbatches that
    divide the 8."""
    dev = next(iter(batch.values())).device
    x = {k: v[:8] for k, v in batch.items()}
    n_micro = None if model.pp is None else math.gcd(
        len(next(iter(x.values()))), model.pp[1])
    return model(x, mask_inputs=True,
                 num_encoded_tokens=args.num_encoded_tokens,
                 generator=torch.Generator(device=dev).manual_seed(epoch),
                 n_micro=n_micro)


def save_debug_images(output_dir, epoch, batch, preds, masks, args):
    """Reconstruction panels (run_pretraining.py:569-645): input |
    masked input | prediction per domain, first 4 samples."""
    from PIL import Image

    def to_u8(x):
        x = np.asarray(x, np.float32)
        lo, hi = x.min(), x.max()
        return ((x - lo) / max(hi - lo, 1e-12) * 255).astype(np.uint8)

    os.makedirs(os.path.join(output_dir, "debug"), exist_ok=True)
    n = min(4, next(iter(batch.values())).shape[0])
    for task, pred in preds.items():
        pred = pred.float().cpu().numpy()
        mask = masks[task].cpu().numpy()
        gh, gw = args.grid_size[task]
        ph = args.input_size[task][0] // gh
        pw = args.input_size[task][1] // gw
        rows = []
        for i in range(n):
            tgt = batch[task][i].float().cpu().numpy()
            if tgt.ndim == 3:
                tgt = tgt[0]
            pr = pred[i].argmax(0) if pred.shape[1] > 1 else pred[i, 0]
            m_img = np.kron(mask[i].reshape(gh, gw), np.ones((ph, pw)))
            masked = np.where(m_img > 0, 0, tgt)
            rows.append(np.concatenate([to_u8(tgt), to_u8(masked),
                                        to_u8(pr)], axis=1))
        Image.fromarray(np.concatenate(rows, axis=0)).save(
            os.path.join(output_dir, "debug", f"e{epoch:05d}_{task}.png"))


def main(argv=None):
    """Trains; returns {"state", "log" (the epochs' log lines), "step_s"
    and "wait_s" (per step: host seconds from the previous step's end to
    this one's, and of them waiting on the loader; a step ends where its
    metrics are read, so with --log_freq 1 on the card each is
    synchronised)}."""
    args = process_args(parse_with_yaml(get_parser(), argv))
    args.model = pick_model_from_weights(args)
    check_pipeline(args)

    from mirage_tpu_torch.ops.runtime import resolve_device
    from mirage_tpu_torch.parallel.mesh import (batch_count, is_writer,
                                                writer_prints)

    device, mesh, hosts = setup_mesh(args, resolve_device(args.device))
    writer = is_writer(mesh)
    stripes = 1 if mesh is None else batch_count(mesh)
    global_batch = args.batch_size * hosts
    if global_batch % stripes:
        sys.exit(f"--batch_size {args.batch_size} x {hosts} host(s) must be "
                 f"divisible by the {stripes} batch stripes (data x fsdp)")
    with writer_prints(mesh):
        n_micro = (pipeline_microbatches(
            args.mesh_pipe, args.pp_microbatches, global_batch // stripes)
            if args.mesh_pipe > 1 else None)
        return _train(args, device, mesh, writer, global_batch // stripes,
                      hosts, n_micro)


def _on_device(batches, steps, device, domains):
    """The first ``steps`` batches of ``batches`` (items (batch, _, _)) on
    ``device``, each as (the time its fetch ended, batch); one fetch more
    ends it, as a capped epoch ends. Each wait on the loader, with the
    copy to the device, is the span ``mirage.data``."""
    from mirage_tpu_torch.data.loader import to_device
    from mirage_tpu_torch.utils.profiling import annotate

    batches = iter(batches)
    while True:
        with annotate("mirage.data"):
            got = next(batches, None)
            if got is None or steps == 0:
                return
            t_got = time.perf_counter()
            batch = to_device(got[0], device, domains)
        steps -= 1
        yield t_got, batch


def _train(args, device, mesh, writer, local_batch_size, hosts, n_micro):
    from mirage_tpu_torch.data.augment import PretrainAugment
    from mirage_tpu_torch.data.folder import MultiTaskPretDatasetFolder
    from mirage_tpu_torch.data.loader import DataLoader
    from mirage_tpu_torch.parallel.mesh import batch_count, batch_rank
    from mirage_tpu_torch.train import checkpoint as ckpt
    from mirage_tpu_torch.train.logger import MetricLogger, append_log
    from mirage_tpu_torch.train.schedules import cosine_scheduler
    from mirage_tpu_torch.train.steps import (init_train_state,
                                              make_train_step, shard_state,
                                              step_generator)
    from mirage_tpu_torch.utils.profiling import trace

    model, opt, loss_fn = setup(args, device)
    if mesh is not None and args.mesh_tensor > 1:
        hidden = model.encoder[0].mlp.fc1.weight.shape[0]
        if model.num_heads % args.mesh_tensor or hidden % args.mesh_tensor:
            sys.exit(f"--mesh_tensor {args.mesh_tensor} must divide "
                     f"num_heads ({model.num_heads}) and the MLP hidden "
                     f"dim ({hidden})")
    if n_micro is not None:
        model.pp = ("pipe", n_micro)

    aug = PretrainAugment(
        {d: args.input_size[d] for d in args.in_domains}, hflip=args.hflip,
        intensity_shift=args.intensity_shift, affine=args.affine)
    dataset = MultiTaskPretDatasetFolder(
        args.data_path, args.in_domains, transform=aug,
        use_cache=args.use_cache)
    loader = DataLoader(
        dataset, local_batch_size, shuffle=True, drop_last=True,
        num_workers=args.num_workers, seed=args.seed,
        shard_index=0 if mesh is None else batch_rank(mesh),
        num_shards=1 if mesh is None else batch_count(mesh))
    steps_per_epoch = len(loader)
    if args.max_steps_per_epoch:
        steps_per_epoch = min(steps_per_epoch, args.max_steps_per_epoch)
    if steps_per_epoch == 0:
        raise RuntimeError("Dataset smaller than one batch")

    if args.lr is None:
        args.lr = args.blr * args.batch_size * hosts / 256.0
    lr_sched = cosine_scheduler(args.lr, args.min_lr, args.epochs,
                                steps_per_epoch,
                                warmup_epochs=args.warmup_epochs,
                                start_warmup_value=args.warmup_lr,
                                warmup_steps=args.warmup_steps)
    wd_end = args.weight_decay_end if args.weight_decay_end is not None \
        else args.weight_decay
    wd_sched = cosine_scheduler(1.0, wd_end / max(args.weight_decay, 1e-12),
                                args.epochs, steps_per_epoch)
    step_fn = make_train_step(loss_fn, opt, mesh=mesh,
                              pp=n_micro is not None)

    state = init_train_state(model, opt)
    trainable, total = opt.count_trainable(state["params"])
    if mesh is not None:
        state = shard_state(state, mesh, model, tp_num_heads=model.num_heads)
        print(f">> layout {state['layout'].kind}")
    start_epoch = 0
    if args.auto_resume:
        state, start_epoch = ckpt.auto_load_checkpoint(args.output_dir,
                                                       state)
        if start_epoch:
            print(f">> Resumed from epoch {start_epoch}")
    if writer:
        save_args(args.output_dir, args)
    print(f"Params: {total / 1e6:.1f}M ({trainable / 1e6:.1f}M trainable), "
          f"device {device}")

    log, step_s, wait_s = [], [], []
    t_start = time.time()
    for epoch in range(start_epoch, args.epochs):
        with contextlib.ExitStack() as stack:
            if args.profile_dir and epoch == start_epoch:
                stack.enter_context(trace(args.profile_dir))
            loader.set_epoch(epoch)
            logger = MetricLogger()
            it = epoch * steps_per_epoch
            t_end = time.perf_counter()
            for step, (t_got, batch) in enumerate(_on_device(
                    logger.log_every(loader, args.log_freq,
                                     f"Epoch [{epoch}]"),
                    steps_per_epoch, device, args.in_domains)):
                lr = float(lr_sched[min(it, len(lr_sched) - 1)])
                state, metrics = step_fn(
                    state, batch, step_generator(args.seed, it, device),
                    lr, float(wd_sched[min(it, len(wd_sched) - 1)]))
                if step % args.log_freq == 0 or step == steps_per_epoch - 1:
                    host = {k: float(v) for k, v in metrics.items()}
                    if not math.isfinite(host["loss"]):
                        print(f"Loss is {host['loss']}, stopping training")
                        sys.exit(1)
                    logger.update(lr=lr, **host)
                if args.debug_images and step == 0 and epoch % 20 == 0:
                    preds, masks = debug_forward(model, batch, args, epoch)
                    if writer:
                        save_debug_images(args.output_dir, epoch, batch,
                                          preds, masks, args)
                it += 1
                wait_s.append(t_got - t_end)
                t_prev, t_end = t_end, time.perf_counter()
                step_s.append(t_end - t_prev)
        if (epoch + 1) % args.save_ckpt_freq == 0 or epoch + 1 == args.epochs:
            ckpt.save_checkpoint(args.output_dir, state, epoch,
                                 args=vars(args))
        row = {"epoch": epoch, **{f"train_{k}": m.global_avg
                                  for k, m in logger.meters.items()}}
        if writer:
            append_log(args.output_dir, row)
        log.append(row)

    total_time = time.time() - t_start
    if writer:
        with open(os.path.join(args.output_dir, "training_time.txt"),
                  "w") as f:
            f.write(f"{total_time}\n")
    print(f"Training done in {total_time:.1f}s")
    return {"state": state, "log": log, "step_s": step_s, "wait_s": wait_s}


if __name__ == "__main__":
    main()
