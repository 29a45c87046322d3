"""The port's scripts/bench_decbatch_ab.py: the decoders' tails as one task
stack (``MIRAGE_DEC_BATCH=on``) against one tail a task, on the card.

    python -m mirage_tpu_torch.bench.decbatch [--rounds R] [--iters N]
    python -m mirage_tpu_torch.bench.decbatch --dry-run --device cpu --size tiny

Two cases, each built once, both arms in one process (the switch is read at
each forward, so one model serves both), timed in alternating rounds in
the order batched, per-task, per-task, batched (ABBA), so that slow drift
of the card and the host falls on both arms alike:

- ``step``: the ViT-B pretraining step of scripts/bench_decbatch_ab.py at
  batch 256: ``miragepre_base`` on 512² B-scans and SLOs (patch 32) and the
  128² layer map (patch 8), three 256-wide decoders of depth 2 with 8
  heads, remat on, 98 visible tokens from one set of injected masks, AdamW
  (0.9, 0.95), wd 0.05, clip 1.0;
- ``forward``: the MIRAGE-Large reconstruct forward (bench.py's, the
  headline model) at batch 64.

A round is ``iters`` calls between two CUDA events and, on the host clock,
ended in ``torch.cuda.synchronize()``; a row gives each arm's rounds, their
median and best, the C entries one call of each arm launches
(``runtime.launch_counts``) and the card's name and power limit. Both arms must agree first: the
step's loss (relative 1e-2, phase 5's bar) and the forward's outputs
(bf16 bars). ``--dry-run --device cpu --size tiny`` runs the same code at
``miragepre_tiny`` widths, batch 2, one round of one call, without time.
"""

import argparse
import json
import sys
import time

import numpy as np
import torch

from mirage_tpu_torch import bench

SEED = 0
DOMAINS = ["bscan", "slo", "bscanlayermap"]
ARMS = ("batched", "per-task")
ORDER = ("batched", "per-task", "per-task", "batched")
SWITCH = {"batched": "on", "per-task": "off"}
STEP_LOSS_REL = 1e-2  # chip_smoke.py's TRAIN_LOSS_REL


def launches(fn):
    """The C entries one call of ``fn`` launches: entry -> launches."""
    from mirage_tpu_torch.ops import runtime

    before = runtime.launch_counts()
    fn()
    return dict(runtime.launch_counts() - before)


def abba(calls, rounds, iters, measure):
    """Each arm's rounds in ABBA order: ms a call on the host clock (ended
    in a synchronise) and by CUDA events; None without ``measure``."""
    from mirage_tpu_torch.ops import runtime

    host = {a: [] for a in ARMS}
    device = {a: [] for a in ARMS}
    for r in range(rounds):
        arm = ORDER[r % len(ORDER)]
        with runtime.switched({"MIRAGE_DEC_BATCH": SWITCH[arm]}):
            if not measure:
                calls[arm]()
                continue
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            for _ in range(iters):
                calls[arm]()
            end.record()
            torch.cuda.synchronize()
            host[arm].append((time.perf_counter() - t0) * 1e3 / iters)
            device[arm].append(start.elapsed_time(end) / iters)
    if not measure:
        return None

    def summary(runs):
        s = sorted(runs)
        return {"rounds_ms": runs, "median_ms": s[len(s) // 2],
                "best_ms": s[0]}

    out = {a: {"host": summary(host[a]), "events": summary(device[a])}
           for a in ARMS}
    for clock in ("host", "events"):
        b, p = out["batched"][clock], out["per-task"][clock]
        out[f"{clock}_delta_pct"] = {
            "median": 100 * (b["median_ms"] / p["median_ms"] - 1),
            "best": 100 * (b["best_ms"] / p["best_ms"] - 1)}
    return out


def step_case(size="large", device="cuda", rounds=8, iters=5, measure=True):
    """The pretraining step's row (module docstring)."""
    from mirage_tpu_torch.api.wrapper import build_model
    from mirage_tpu_torch.masking.masking import generate_random_masks
    from mirage_tpu_torch.ops import runtime
    from mirage_tpu_torch.train.optim import GroupedOptimizer, OptimizerConfig
    from mirage_tpu_torch.train.steps import (init_train_state,
                                              make_pretrain_loss,
                                              make_train_step)

    dim, depth, heads = bench.sizes(size, (768, 12, 12), (64, 2, 2))
    b, visible = bench.sizes(size, (256, 98), (2, 16))
    args = dict(model="miragepre_base" if size == "large" else
                "miragepre_tiny", num_global_tokens=1, in_domains=DOMAINS,
                out_domains=DOMAINS, decoder_dim=bench.sizes(size, 256, 32),
                decoder_depth=2, decoder_num_heads=bench.sizes(size, 8, 2),
                dim_tokens=dim, depth=depth, num_heads=heads)
    model = build_model(args["model"], args, DOMAINS, 512, 32,
                        compute_dtype=torch.bfloat16,
                        generator=torch.Generator().manual_seed(SEED),
                        remat=True).to(device)
    opt = GroupedOptimizer(OptimizerConfig(
        opt="adamw", betas=(0.9, 0.95), weight_decay=0.05, clip_grad=1.0))
    dc = {"bscan": {"loss": "mse", "patch_size": 32, "norm_pix": True},
          "slo": {"loss": "mse", "patch_size": 32, "norm_pix": True},
          "bscanlayermap": {"loss": "ce", "patch_size": 8}}
    loss_fn = make_pretrain_loss(model, dc, num_encoded_tokens=visible,
                                 alphas=1.0)
    step = make_train_step(loss_fn, opt)
    state = init_train_state(model, opt)
    rng = np.random.default_rng(SEED)
    batch = {"bscan": rng.random((b, 1, 512, 512), dtype=np.float32),
             "slo": rng.random((b, 1, 512, 512), dtype=np.float32),
             "bscanlayermap": rng.integers(0, 13, (b, 128, 128))}
    batch = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
    masks, _, _ = generate_random_masks(torch.Generator().manual_seed(SEED),
                                        [256, 256, 256], b, visible)
    masks = {t: m.to(device) for t, m in zip(DOMAINS, masks)}

    def loss():
        with torch.no_grad():
            return loss_fn(batch, task_masks=masks,
                           num_visible=visible)[0].item()

    agree = {}
    for arm in ARMS:
        with runtime.switched({"MIRAGE_DEC_BATCH": SWITCH[arm]}):
            agree[arm] = loss()
    rel = abs(agree["batched"] - agree["per-task"]) / abs(agree["per-task"])
    if not (np.isfinite(rel) and rel <= STEP_LOSS_REL):
        raise AssertionError(f"step: the arms' losses disagree: {agree}")

    def call():
        step(state, batch, None, 1e-4, task_masks=masks, num_visible=visible)

    counts = {}
    for arm in ARMS:
        with runtime.switched({"MIRAGE_DEC_BATCH": SWITCH[arm]}):
            counts[arm] = launches(call)
    return {"case": "step", "model": args["model"], "batch": b,
            "remat": True, "visible": visible, "loss": agree,
            "loss_rel": rel, "launches_per_call": counts,
            "timing": abba({a: call for a in ARMS}, rounds, iters, measure),
            "measured": measure, **(bench.card() if measure else
                                    {"device": str(device)})}


@torch.inference_mode()
def forward_case(size="large", device="cuda", rounds=8, iters=10,
                 measure=True, batch=64):
    """The MIRAGE-Large reconstruct forward's row (module docstring)."""
    from mirage_tpu_torch.bench.__main__ import (build_headline_model,
                                                 forward, headline_inputs)
    from mirage_tpu_torch.ops import runtime

    dev = torch.device(device)
    model = build_headline_model(size, dev)
    b = batch if size == "large" else 2
    x, masks = headline_inputs(b, dev)
    outs = {}
    for arm in ARMS:
        with runtime.switched({"MIRAGE_DEC_BATCH": SWITCH[arm]}):
            outs[arm] = forward(model, x, masks)
    errs = {t: bench.check(f"forward {t}", outs["batched"][t],
                           outs["per-task"][t]) for t in outs["batched"]}

    def call():
        forward(model, x, masks)

    counts = {}
    for arm in ARMS:
        with runtime.switched({"MIRAGE_DEC_BATCH": SWITCH[arm]}):
            counts[arm] = launches(call)
    return {"case": "forward", "model": "miragepre_large" if size == "large"
            else "miragepre_tiny", "batch": b, "agreement": errs,
            "launches_per_call": counts,
            "timing": abba({a: call for a in ARMS}, rounds, iters, measure),
            "measured": measure, **(bench.card() if measure else
                                    {"device": str(device)})}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--size", default="large", choices=("large", "tiny"))
    ap.add_argument("--dry-run", action="store_true",
                    help="one round of one call each, no time")
    opts = ap.parse_args(argv)
    if not opts.dry_run and not torch.cuda.is_available():
        print("decbatch: no CUDA device (use --dry-run --device cpu)",
              file=sys.stderr)
        return 2
    measure = not opts.dry_run
    rounds = opts.rounds if measure else len(ARMS)
    for case in (step_case, forward_case):
        print(json.dumps(case(opts.size, opts.device, rounds,
                              opts.iters if measure else 1, measure)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
