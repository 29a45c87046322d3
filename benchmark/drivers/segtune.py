"""Segmentation tuning steps as the segmentation CLI builds them.

The traffic file gives the CLI's settings (``cli``: the flags of the
published config, as ``cli/run_seg_tuning.py`` parses them) and the pool
of seeded batches held on the device; the configuration's ``seg`` part
gives the input, the head and the label maps' classes. Set-up writes the seeded pretraining weights as the
checkpoint the CLI loads (under ``TMPDIR``, with the dataset's
``INFO.json`` it reads the classes from; both removed once loaded), builds
the model, the optimizer and the loss with the CLI's ``setup`` and the
step with ``make_train_step``, loads the whole seeded state dict (the
head's leaves too), and runs the first three steps on three different
batches, each with its own generator for the encoder's stochastic depth,
seeded by the benchmark. The readings and the comparison are the
pretraining driver's: after the window the plain float32 reference takes
the same three steps (the same weights, batches and stochastic-depth
draws, layer decay, the frozen encoder) and the worst loss, gradient and
change gaps are compared.
"""

import json
import os
import shutil
import tempfile

import torch

from benchmark import work
from benchmark.drivers import common, pretrain
from benchmark.reference import seg, weights
from benchmark.reference import train as ref_train
from benchmark.reference.numerics import Numerics, strict_float32

FIRST_STEPS = pretrain.FIRST_STEPS


def step_seed(seed, it):
    """The seed of step ``it``'s stochastic-depth generator."""
    return (seed * 1_000_003 + it) % (1 << 62)


def _files(cfg, seed, device):
    """A directory under TMPDIR with the dataset's INFO.json and the seeded
    pretraining checkpoint, named as the CLI picks MIRAGE-Base by."""
    root = tempfile.mkdtemp(prefix="mirage-bench-seg-")
    info = {str(i): {"label": f"class {i}", "value": i}
            for i in range(cfg["seg"]["head"]["classes"])}
    with open(os.path.join(root, "INFO.json"), "w") as f:
        json.dump(info, f)
    sd = weights.make(cfg, seed, torch.float32, device,
                      specs=seg.param_specs(cfg))
    enc = {k: v.cpu() for k, v in sd.items() if not k.startswith("output")}
    path = os.path.join(root, cfg["seg"]["checkpoint_name"])
    torch.save({"model": enc, "args": {}}, path)
    return root, path, sd


def cli_args(cfg, traffic, seed, device, root, path):
    from mirage_tpu_torch.cli import run_seg_tuning as rs

    flags = ["--weights", path, "--data_path", root, "--output_dir",
             os.path.join(root, "out"), "--seed", str(seed), "--device",
             str(device), "--model_override", cfg["seg"]["model"]]
    for k, v in traffic["cli"].items():
        flags += [f"--{k}", str(v)]
    return rs.process_args(rs.get_parser().parse_args(flags))


def batches(cfg, traffic, seed, device, b):
    gen = torch.Generator(device=device).manual_seed(seed)
    s, classes = cfg["seg"], cfg["seg"]["head"]["classes"]
    hw = (s["image"], s["image"])
    return [{s["input"]: torch.rand((b, s.get("channels", 1)) + hw,
                                    generator=gen, device=device),
             "semseg": torch.randint(0, classes, (b,) + hw, generator=gen,
                                     device=device)}
            for _ in range(traffic["pool"])]


def reference(cfg, args, seed, device, pool, precision="float32",
              rows=None):
    """The reference's three steps: (losses, first gradients, changes).
    ``rows``: the first rows of each batch only (a fault's readings)."""
    strict_float32()
    num = Numerics(precision)
    specs = seg.param_specs(cfg)
    params = ref_train.leaf_params(
        weights.make(cfg, seed, torch.float32, device, specs=specs),
        trainable=seg.trainable)
    opt = ref_train.AdamW(params, tuple(args.opt_betas), args.opt_eps,
                          args.weight_decay,
                          lambda n: seg.lr_scale(cfg, args.layer_decay, n))
    names = [n for n, p in params.items() if p.requires_grad]
    task = cfg["seg"]["input"]
    losses, g1 = [], None
    for k in range(FIRST_STEPS):
        batch = pool[k]
        gen = torch.Generator(device=device).manual_seed(step_seed(seed, k))
        x, y = batch[task][:rows], batch["semseg"][:rows]
        loss = seg.ce_gdice(seg.logits(num, cfg, params, x, gen,
                                       args.drop_path_encoder), y)
        grads = dict(zip(names, torch.autograd.grad(
            loss, [params[n] for n in names])))
        losses.append(float(loss.detach()))
        if k == 0:
            g1 = grads
        opt.step(params, grads, args.lr)
    start = weights.make(cfg, seed, torch.float32, device, specs=specs)
    return losses, g1, {n: params[n].detach() - start[n] for n in g1}


def run(ctx):
    from mirage_tpu_torch.cli import run_seg_tuning as rs
    from mirage_tpu_torch.train.steps import (init_train_state,
                                              make_train_step)

    cfg, traffic, dev = ctx.cfg, ctx.traffic, torch.device(ctx.device)
    root, path, sd = _files(cfg, ctx.seed, dev)
    try:
        args = cli_args(cfg, traffic, ctx.seed, dev, root, path)
        _, model, opt, _, loss_fn = rs.setup(args, dev)
    finally:
        shutil.rmtree(root)
    model.load_state_dict(sd, strict=True)
    del sd
    step_fn = make_train_step(loss_fn, opt)
    state = init_train_state(model, opt)
    b = args.batch_size
    pool = batches(cfg, traffic, ctx.seed, dev, b)

    def step(it):
        gen = torch.Generator(device=dev).manual_seed(step_seed(ctx.seed, it))
        return step_fn(state, pool[it % len(pool)], gen, args.lr, 1.0)

    specs = seg.param_specs(cfg)
    readings, setup_s, win, steps, device, n_trainable = \
        pretrain.steps_and_window(
            ctx, step, state, opt,
            lambda: weights.make(cfg, ctx.seed, torch.float32, dev, specs))
    del step, step_fn, state, model, opt, loss_fn
    common.free()
    rec = pretrain.record(ctx, setup_s, win, steps, b, device,
                          work.segtune_step(cfg, b, n_trainable))
    rec["checks"] = pretrain.checks(readings,
                                    reference(cfg, args, ctx.seed, dev, pool))
    return rec
