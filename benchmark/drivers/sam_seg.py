"""Segmentation-head training over the frozen SAM ViT image encoder, as
the segmentation CLI builds it.

The traffic file gives the CLI's settings (``cli``: its flags and values,
the full freeze among them) and the pool of seeded batches held on the
device; the configuration gives SAM's image encoder (``build_sam.py``'s
names) and its ``seg`` part the input, the head and the classes. Set-up
writes the seeded encoder as SAM's checkpoint (``image_encoder.*`` beside
prompt-encoder and mask-decoder keys the loader drops), named as SAM ViT-H's
so the CLI picks the SAM model by it (``sam_vit_h-seeded.pth``, under
``TMPDIR`` with the dataset's ``INFO.json``; both removed once loaded),
builds the model, the optimizer and the loss with the CLI's ``setup`` and
the step with ``make_train_step``, loads the head's seeded leaves, and runs
the first three steps on three different batches. A forward hook on the
neck keeps the image embedding of those three steps and removes itself
before the window. The readings and the comparison are the pretraining
driver's (``pretrain.steps_and_window``, ``pretrain.record``,
``pretrain.checks``: the loss, the head's first gradients and its change
after three steps), and ``feature_gap``: the worst per-image relative L2
gap between the program's embedding and the plain float32 reference's
(``benchmark/reference/sam.py``), which takes the same three steps after
the window.

The traced window also sums the device time of the kernels whose names
start with ``relpos_attn`` (the relative-position attention's) before the
profiler is dropped; ``relpos_attn_least_s`` is the least time of the
window's calls of that op (``benchmark/work_sam.py``). A program without
the SAM encoder exits at once with an error.
"""

import contextlib
import importlib.util
import json
import os
import shutil
import tempfile

import torch

from benchmark import work_sam
from benchmark.drivers import common, pretrain, segtune
from benchmark.reference import sam as ref_sam

CHECKPOINT = "sam_vit_h-seeded.pth"
PREFIX = "relpos_attn"


def is_relpos(name):
    """A kernel of the relative-position attention, by its name as the
    profiler gives it (a template's with its return type first)."""
    return name.removeprefix("void ").startswith(PREFIX)


class RelposWindow(common.Window):
    """The measured window; once closed with a trace, ``relpos_s`` is the
    device time of the relative-position attention's kernels in it."""

    relpos_s = None

    def __exit__(self, *exc):
        prof = self.prof
        out = super().__exit__(*exc)
        if prof is not None and exc[0] is None:
            ns = 0
            for ev in prof.profiler.kineto_results.events():
                if str(ev.device_type()).endswith("CPU") \
                        or not is_relpos(ev.name()):
                    continue
                end = ev.start_ns() + ev.duration_ns()
                ns += max(0, end - max(ev.start_ns(), self.ns0))
            self.relpos_s = ns / 1e9
        return out


@contextlib.contextmanager
def relpos_window():
    """``pretrain.steps_and_window`` opens its window as ``common.Window``:
    within the block that is :class:`RelposWindow`."""
    saved = common.Window
    common.Window = RelposWindow
    try:
        yield
    finally:
        common.Window = saved


def files(cfg, sd=None):
    """A directory under TMPDIR with the dataset's INFO.json and, given the
    seeded state dict ``sd``, SAM's checkpoint of its encoder."""
    root = tempfile.mkdtemp(prefix="mirage-bench-sam-")
    info = {str(i): {"label": f"class {i}", "value": i}
            for i in range(cfg["seg"]["head"]["classes"])}
    with open(os.path.join(root, "INFO.json"), "w") as f:
        json.dump(info, f)
    if sd is not None:
        torch.save(ref_sam.checkpoint(sd), os.path.join(root, CHECKPOINT))
    return root


def cli_args(cfg, traffic, seed, device, root):
    """The CLI's parsed and processed arguments: the traffic's flags (a
    flag without a value given when true) and the run's paths."""
    from mirage_tpu_torch.cli import run_seg_tuning as rs

    parser = rs.get_parser()
    flags = ["--weights", os.path.join(root, CHECKPOINT), "--data_path", root,
             "--output_dir", os.path.join(root, "out"), "--seed", str(seed),
             "--device", str(device), "--model_override", cfg["seg"]["model"]]
    for k, v in traffic["cli"].items():
        if parser._option_string_actions[f"--{k}"].nargs == 0:
            flags += [f"--{k}"] if v else []
        else:
            flags += [f"--{k}"] + [str(x) for x in (
                v if isinstance(v, list) else [v])]
    return rs.process_args(parser.parse_args(flags))


def capture(module, steps):
    """The outputs of ``module``'s next ``steps`` calls as float
    (B, C, H, W) maps; the hook removes itself after the last."""
    kept = []

    def hook(_, __, out):
        kept.append(out.detach().float().permute(0, 3, 1, 2).clone())
        if len(kept) == steps:
            handle.remove()

    handle = module.register_forward_hook(hook)
    return kept


def feature_gap(prog, ref):
    """The worst per-image ‖program − reference‖ / ‖reference‖ over the
    embeddings of the first steps."""
    worst = 0.0
    for p, r in zip(prog, ref):
        for pi, ri in zip(p, r.to(p.device)):
            gap = float((pi - ri).norm() / ri.norm())
            worst = max(worst, gap if gap == gap else float("inf"))
    return worst


def run(ctx):
    if importlib.util.find_spec("mirage_tpu_torch.models.sam") is None:
        raise SystemExit("benchmark: this program has no SAM image encoder "
                         "(mirage_tpu_torch/models/sam.py)")
    from mirage_tpu_torch.cli import run_seg_tuning as rs
    from mirage_tpu_torch.train.steps import (init_train_state,
                                              make_train_step)

    cfg, traffic, dev = ctx.cfg, ctx.traffic, torch.device(ctx.device)
    sd = ref_sam.seeded(cfg, ctx.seed, dev)
    root = files(cfg, sd)
    try:
        args = cli_args(cfg, traffic, ctx.seed, dev, root)
        _, model, opt, _, loss_fn = rs.setup(args, dev)
    finally:
        shutil.rmtree(root)
    head = {k: v for k, v in sd.items() if ref_sam.trainable(k)}
    del sd
    if model.load_state_dict(head, strict=False).unexpected_keys:
        raise ValueError("the head's seeded leaves do not fit the model")
    step_fn = make_train_step(loss_fn, opt)
    state = init_train_state(model, opt)
    b = args.batch_size
    pool = segtune.batches(cfg, traffic, ctx.seed, dev, b)
    feats = capture(model.neck, pretrain.FIRST_STEPS)

    def step(it):
        gen = torch.Generator(device=dev).manual_seed(
            segtune.step_seed(ctx.seed, it))
        return step_fn(state, pool[it % len(pool)], gen, args.lr, 1.0)

    with relpos_window():
        readings, setup_s, win, steps, device, n_trainable = \
            pretrain.steps_and_window(ctx, step, state, opt, lambda: head)
    del step, step_fn, state, model, opt, loss_fn
    common.free()
    rec = pretrain.record(ctx, setup_s, win, steps, b, device,
                          work_sam.seg_step(cfg, b, n_trainable))
    rec["relpos_attn_s"] = win.relpos_s
    rec["relpos_attn_least_s"] = steps * work_sam.relpos_least_ms(cfg, b) / 1e3
    losses, g1, change, ref_feats = ref_sam.reference(cfg, args, ctx.seed,
                                                      dev, pool)
    rec["checks"] = {"feature_gap": feature_gap(feats, ref_feats),
                     **pretrain.checks(readings, (losses, g1, change))}
    return rec
