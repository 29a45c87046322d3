"""The port's scripts/bench_train.py: training steps at the reference configs.

Five rows, as scripts/bench_train.py:161-171 runs them (``run()``):

- ``pretrain_vitb_img_per_sec``: MultiMAE pretraining (:38-62), ViT-B
  (``miragepre_base``) on 512² B-scans and SLOs (patch 32) and the 128²
  layer map (patch 8), 98 visible tokens, three 256/2/8 decoders, AdamW
  (0.9, 0.95), wd 0.05, clip 1.0, token-space losses (norm_pix on the
  images), batch 256;
- ``seg_vitb_frozen_img_per_sec`` and ``seg_vitb_fullfreeze_img_per_sec``
  (:65-107): ViT-B at 1024² (patch 32, 1025 tokens), drop path 0.1, the
  ConvNeXt head (8 classes, 6144 / 16 channels, depth 4), CE + GDice, AdamW
  with layer decay 0.75 and a frozen encoder, batch 8; the reference freeze
  (the input adapters train through the frozen encoder) and the full freeze
  (``frozen_paths=("input_adapters", "global_tokens")``, the encoder run
  grad-free);
- ``cls_vitb_probe_img_per_sec`` and ``cls_vitb_fullft_img_per_sec``
  (:110-158): ViT-B on 512² B-scans, the LN + mean-pooled patch tokens + a
  5-class linear head, label smoothing 0.1, AdamW wd 1e-2, batch 64; linear
  probing (``frozen_paths=("model", "norm")``) and the full fine-tune.

Every model is bf16 compute with float32 parameters, random weights from
seed 0 and a numpy-seeded batch. A row is ``_row``'s (:31-35): the metric,
img/s, ms per step and the batch, plus the card's name and power limit;
the step time is the host clock over ``steps`` steps after one warm-up
step, ended in ``torch.cuda.synchronize()``. The JAX full fine-tune runs
with ``remat`` (rematerialisation); the port has none (its ops save only
their inputs and recompute the rest), so that row compares speed and
memory, not identical work. ``size="tiny"`` is the CPU dry run: the same
code at ``miragepre_tiny`` widths, batch 2 (64² images for seg and cls),
one step, no time.
"""

import time

import numpy as np
import torch
from torch import nn

from mirage_tpu_torch import bench

STEPS = 10  # scripts/bench_train.py:21 timestep(iters=10)
SEED = 0
DOMAINS = ["bscan", "slo", "bscanlayermap"]


def _vit(size):
    """(dim, depth, heads) of the encoder: ViT-B, or the dry run's width."""
    return bench.sizes(size, (768, 12, 12), (64, 2, 2))


def _timed(step, state, batch, lr, steps, device, measure, gen=None):
    """ms per step of ``step`` after one warm-up step (None when not
    measuring: the warm-up step alone runs), and its metrics."""
    state, m = step(state, batch, gen, lr)
    loss = m["loss"].item()
    if not np.isfinite(loss):
        raise AssertionError(f"non-finite loss {loss}")
    if not measure:
        return None, loss
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        state, m = step(state, batch, gen, lr)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / steps * 1e3, m["loss"].item()


def _row(metric, b, ms, loss, device, extra=None):
    row = {"metric": metric, "unit": "images/sec", "batch": b,
           "loss": loss, **(extra or {})}
    if ms is None:
        return {**row, "measured": False, "device": str(device)}
    return {**row, "value": b / ms * 1e3, "ms_per_step": ms,
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            **bench.card()}


def pretrain_row(size="large", device="cuda", steps=STEPS, measure=True):
    from mirage_tpu_torch.api.wrapper import build_model
    from mirage_tpu_torch.train.optim import GroupedOptimizer, OptimizerConfig
    from mirage_tpu_torch.train.steps import (init_train_state,
                                              make_pretrain_loss,
                                              make_train_step)

    dim, depth, heads = _vit(size)
    img, patch, b, visible = bench.sizes(size, (512, 32, 256, 98),
                                         (512, 32, 2, 16))
    args = dict(model="miragepre_base" if size == "large" else
                "miragepre_tiny", num_global_tokens=1, in_domains=DOMAINS,
                out_domains=DOMAINS, decoder_dim=bench.sizes(size, 256, 32),
                decoder_depth=2, decoder_num_heads=bench.sizes(size, 8, 2),
                dim_tokens=dim, depth=depth, num_heads=heads)
    model = build_model(args["model"], args, DOMAINS, img, patch,
                        compute_dtype=torch.bfloat16,
                        generator=torch.Generator().manual_seed(SEED))
    model = model.to(device)
    opt = GroupedOptimizer(OptimizerConfig(
        opt="adamw", betas=(0.9, 0.95), weight_decay=0.05, clip_grad=1.0))
    dc = {"bscan": {"loss": "mse", "patch_size": patch, "norm_pix": True},
          "slo": {"loss": "mse", "patch_size": patch, "norm_pix": True},
          "bscanlayermap": {"loss": "ce", "patch_size": 8}}
    loss_fn = make_pretrain_loss(model, dc, num_encoded_tokens=visible,
                                 alphas=1.0)
    step = make_train_step(loss_fn, opt)
    state = init_train_state(model, opt)
    rng = np.random.default_rng(SEED)
    batch = {"bscan": rng.random((b, 1, img, img), dtype=np.float32),
             "slo": rng.random((b, 1, img, img), dtype=np.float32),
             "bscanlayermap": rng.integers(0, 13, (b, 128, 128))}
    batch = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
    gen = torch.Generator(device=device).manual_seed(SEED)
    ms, loss = _timed(step, state, batch, 1e-4, steps, device, measure, gen)
    return _row("pretrain_vitb_img_per_sec", b, ms, loss, device)


def seg_row(parity, size="large", device="cuda", steps=STEPS, measure=True):
    from mirage_tpu_torch.adapters.input_adapters import PatchedInputAdapter
    from mirage_tpu_torch.adapters.seg_heads import ConvNeXtAdapter
    from mirage_tpu_torch.losses.gdice import ce_gdice_loss
    from mirage_tpu_torch.models.mirage import MIRAGEModel
    from mirage_tpu_torch.train.optim import GroupedOptimizer, OptimizerConfig
    from mirage_tpu_torch.train.steps import (init_train_state, make_seg_loss,
                                              make_train_step)

    dim, depth, heads = _vit(size)
    img, embed, b = bench.sizes(size, (1024, 6144, 8), (64, 256, 2))
    model = MIRAGEModel(
        input_adapters={"bscan": PatchedInputAdapter(
            num_channels=1, patch_size_full=(32, 32), image_size=img)},
        output_adapters={"semseg": ConvNeXtAdapter(
            num_classes=8, patch_size=32, preds_per_patch=16, depth=4,
            embed_dim=embed, main_tasks=("bscan",), task="semseg",
            image_size=(img, img))},
        dim_tokens=dim, depth=depth, num_heads=heads, drop_path_rate=0.1,
        compute_dtype=torch.bfloat16,
        generator=torch.Generator().manual_seed(SEED)).to(device)
    opt = GroupedOptimizer(OptimizerConfig(
        opt="adamw", weight_decay=0.05, layer_decay=0.75,
        num_layers=model.depth, freeze_encoder=True,
        frozen_paths=() if parity else ("input_adapters", "global_tokens")))
    loss_fn = make_seg_loss(model, ce_gdice_loss, ["bscan"],
                            frozen_encoder=not parity)
    step = make_train_step(loss_fn, opt)
    state = init_train_state(model, opt)
    rng = np.random.default_rng(SEED)
    batch = {"bscan": rng.random((b, 1, img, img), dtype=np.float32),
             "semseg": rng.integers(0, 8, (b, img, img))}
    batch = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
    gen = torch.Generator(device=device).manual_seed(SEED)
    ms, loss = _timed(step, state, batch, 1e-4, steps, device, measure, gen)
    tag = ("seg_vitb_frozen_img_per_sec" if parity
           else "seg_vitb_fullfreeze_img_per_sec")
    return _row(tag, b, ms, loss, device)


class ClsModel(nn.Module):
    """scripts/bench_train.py:118-135: the encoder (no output heads), LN,
    the mean of the patch tokens and a linear head, parameters under
    ``model``, ``norm`` and ``head``."""

    def __init__(self, size, img, classes=5):
        from mirage_tpu_torch.adapters.input_adapters import \
            PatchedInputAdapter
        from mirage_tpu_torch.models.mirage import MIRAGEModel
        from mirage_tpu_torch.nn.layers import LayerNorm, Linear

        super().__init__()
        dim, depth, heads = _vit(size)
        self.model = MIRAGEModel(
            input_adapters={"bscan": PatchedInputAdapter(
                num_channels=1, patch_size_full=(32, 32), image_size=img)},
            output_adapters=None, dim_tokens=dim, depth=depth,
            num_heads=heads, compute_dtype=torch.bfloat16,
            generator=torch.Generator().manual_seed(SEED))
        self.norm = LayerNorm(dim)
        self.norm.init_params(None)
        self.head = Linear(dim, classes)
        with torch.no_grad():
            self.head.weight.zero_()
            self.head.bias.zero_()

    def forward(self, x, generator=None, frozen_encoder=False):
        from mirage_tpu_torch.nn.layers import layer_norm, linear

        tokens = self.model.forward_light(
            {"bscan": x}, deterministic=False, generator=generator,
            frozen_encoder=frozen_encoder)
        pooled = layer_norm(tokens, self.norm.weight,
                            self.norm.bias)[:, :-1].mean(dim=1)
        return linear(pooled.float(), self.head.weight, self.head.bias)


def cls_row(linear_probing, size="large", device="cuda", steps=STEPS,
            measure=True):
    from mirage_tpu_torch.losses.gdice import cross_entropy_loss
    from mirage_tpu_torch.train.optim import GroupedOptimizer, OptimizerConfig
    from mirage_tpu_torch.train.steps import init_train_state, make_train_step

    img, b = bench.sizes(size, (512, 64), (64, 2))
    model = ClsModel(size, img).to(device)
    opt = GroupedOptimizer(OptimizerConfig(
        opt="adamw", weight_decay=1e-2,
        frozen_paths=("model", "norm") if linear_probing else ()))

    def loss_fn(batch, generator=None):
        logits = model(batch["x"], generator, frozen_encoder=linear_probing)
        return cross_entropy_loss(logits[..., None, None],
                                  batch["y"][..., None, None],
                                  label_smoothing=0.1), {}

    step = make_train_step(loss_fn, opt)
    state = init_train_state(model, opt)
    rng = np.random.default_rng(SEED)
    batch = {"x": torch.from_numpy(rng.random((b, 1, img, img),
                                              dtype=np.float32)).to(device),
             "y": torch.from_numpy(rng.integers(0, 5, (b,))).to(device)}
    gen = torch.Generator(device=device).manual_seed(SEED)
    ms, loss = _timed(step, state, batch, 1e-4, steps, device, measure, gen)
    tag = ("cls_vitb_probe_img_per_sec" if linear_probing
           else "cls_vitb_fullft_img_per_sec")
    return _row(tag, b, ms, loss, device,
                None if linear_probing else {"remat": False})


def run(size="large", device="cuda", steps=STEPS, measure=True):
    """The five rows of scripts/bench_train.py:161-171, in its order; each
    model is freed before the next is built."""
    kw = dict(size=size, device=device, steps=steps, measure=measure)
    jobs = [lambda: pretrain_row(**kw), lambda: seg_row(True, **kw),
            lambda: seg_row(False, **kw), lambda: cls_row(True, **kw),
            lambda: cls_row(False, **kw)]
    rows = []
    for job in jobs:
        if measure:
            torch.cuda.reset_peak_memory_stats()
        rows.append(job())
        if measure:
            torch.cuda.empty_cache()
    return rows
