"""MultiMAE pretraining steps as the pretraining CLI builds them.

The traffic file gives the CLI's settings (``cli``: the flags and values of
the published config, as ``cli/run_pretraining.py`` parses them), the pool
of seeded batches held on the device, and the check's block of reference
rows. Set-up parses those settings with the CLI's own parser, builds the
model, the optimizer and the loss with its ``setup`` and the step with
``make_train_step``, loads the seeded float32 state dict, makes the batches
and their task masks from the seed (Dirichlet over the tasks with the
config's alpha, exactly ``num_encoded_tokens`` visible a sample, as the CLI
would draw them; passed as ``task_masks`` so the reference sees the same),
and runs the first three steps through the step on three different
batches: their losses, the first gradient of every leaf (its first moment
after one step over 1 − β1) and every leaf's change after the three are
read before the window goes on with the same state from step four. After
the window the program is freed and the plain float32 reference takes the
same three steps from the same weights, batches and masks. Compared: the
worst relative gap of a step's loss, and the worst leaf's gap between the
program's and the reference's gradient norm and change norm, each against
the larger of the reference leaf's norm and the median leaf's; leaves
whose reference gradient is under a thousandth of the median leaf's move by
round-off alone under Adam and are left out of the change.
"""

import time

import numpy as np
import torch

from benchmark import work
from benchmark.drivers import common
from benchmark.reference import mirage, weights
from benchmark.reference import train as ref_train
from benchmark.reference.numerics import Numerics, strict_float32

FIRST_STEPS = 3


def cli_args(cfg, traffic, seed, device):
    """The CLI's parsed and processed arguments for this cell."""
    from mirage_tpu_torch.cli import run_pretraining as rp

    domains = "-".join(cfg["domains"])
    flags = ["--data_path", ".", "--model", cfg["model"], "--seed",
             str(seed), "--device", str(device), "--in_domains", domains,
             "--out_domains", domains]
    for k, v in traffic["cli"].items():
        if isinstance(v, bool):  # the CLI's store_true flags
            flags += [f"--{k}"] if v else []
        else:
            flags += [f"--{k}"] + [str(x) for x in np.atleast_1d(v)]
    args = rp.get_parser().parse_args(flags)
    args.input_size = {t: [d["image"]] * 2 for t, d in cfg["domains"].items()}
    args.patch_size = {t: [d["patch"]] * 2 for t, d in cfg["domains"].items()}
    args.decoder_dim = cfg["decoder"]["dim"]
    args.decoder_depth = cfg["decoder"]["depth"]
    args.decoder_num_heads = cfg["decoder"]["num_heads"]
    args.num_global_tokens = cfg["num_global_tokens"]
    # read by the tiny dev size only; the base and large presets fix them
    args.dim_tokens, args.depth, args.num_heads = (
        cfg["dim_tokens"], cfg["depth"], cfg["num_heads"])
    return rp.process_args(args)


def sample_masks(cfg, batch, visible, alpha, rng):
    """task -> (B, n_task) int32 masks (1 = masked) with exactly
    ``visible`` zeros a sample, spread over the tasks by a Dirichlet draw
    rounded by largest remainder."""
    counts = mirage.token_counts(cfg)
    n = np.array([c for _, c in counts])
    share = rng.dirichlet([alpha] * len(n), size=batch) * visible
    take = np.floor(share).astype(int)
    for b, short in enumerate(visible - take.sum(1)):
        take[b, np.argsort(-(share[b] - take[b]), kind="stable")[:short]] += 1
    if (take > n).any():
        raise ValueError(f"{visible} visible tokens overflow a task of "
                         f"{n.min()}")
    masks = {}
    for j, (t, c) in enumerate(counts):
        m = np.ones((batch, c), dtype=np.int32)
        for b in range(batch):
            m[b, rng.permutation(c)[:take[b, j]]] = 0
        masks[t] = m
    return masks


def batches(cfg, traffic, seed, device, b, visible, alpha):
    """The pool of seeded batches and their masks, on the device."""
    gen = torch.Generator(device=device).manual_seed(seed)
    rng = np.random.default_rng(seed)
    pool = []
    for _ in range(traffic["pool"]):
        batch = {}
        for t, d in cfg["domains"].items():
            hw = (d["image"], d["image"])
            if d.get("classes"):
                batch[t] = torch.randint(0, d["classes"], (b,) + hw,
                                         generator=gen, device=device)
            else:
                batch[t] = torch.rand((b, d.get("channels", 1)) + hw,
                                      generator=gen, device=device)
        masks = {t: torch.from_numpy(m).to(device) for t, m in
                 sample_masks(cfg, b, visible, alpha, rng).items()}
        pool.append((batch, masks))
    return pool


def loss_conf(cfg, args):
    return {t: {"loss": "ce" if d.get("classes") else "mse",
                "norm_pix": args.norm_pix_loss}
            for t, d in cfg["domains"].items()}


def reference(cfg, args, seed, device, pool, rows, precision="float32"):
    """The reference's three steps: (losses, the first gradient of every
    trainable leaf, every such leaf's change after the three)."""
    strict_float32()
    num = Numerics(precision)
    params = ref_train.leaf_params(weights.make(cfg, seed, torch.float32,
                                                device))
    opt = ref_train.AdamW(params, tuple(args.opt_betas), args.opt_eps,
                          args.weight_decay)
    conf = loss_conf(cfg, args)
    losses, g1 = [], None
    for k in range(FIRST_STEPS):
        batch, masks = pool[k]
        loss, grads = ref_train.loss_and_grads(num, cfg, conf, params, batch,
                                               masks, rows)
        losses.append(loss)
        if k == 0:
            g1 = grads
        opt.step(params, grads, args.lr)
    start = weights.make(cfg, seed, torch.float32, device)
    change = {n: params[n].detach() - start[n] for n in g1}
    return losses, g1, change


def checks(prog, ref):
    """The compared numbers: the worst step's relative loss gap, and the
    worst leaf's gap of the first gradient's norm and of the change's norm
    (:func:`common.worst_gap`). The change is taken over the elements
    whose reference gradient reaches a thousandth of the median leaf's
    root-mean-square gradient: the others (a key's bias under softmax has
    none) move under Adam by round-off alone."""
    (pl, pg, pc), (rl, rg, rc) = prog, ref
    import statistics

    rms = statistics.median(float(g.norm()) / g.numel() ** 0.5
                            for g in rg.values())
    p_change, r_change = {}, {}
    for n, g in rg.items():
        keep = g.abs() >= 1e-3 * rms
        if bool(keep.any()):
            r_change[n] = float(rc[n][keep].norm())
            p_change[n] = float(pc[n].to(g.device)[keep].norm())
    loss_gap = max(abs(p - r) / max(abs(r), 1e-30) for p, r in zip(pl, rl))
    return {"loss_gap": loss_gap if loss_gap == loss_gap else float("inf"),
            "grad_gap": common.worst_gap(
                pg, {n: float(g.norm()) for n, g in rg.items()}),
            "change_gap": common.worst_gap(p_change, r_change)}


def steps_and_window(ctx, step, state, opt, start):
    """The first three steps through ``step(it)`` with the readings the
    check takes of them (each step's loss, the first gradient of every
    leaf from its first moment, every leaf's change from ``start()``, the
    seeded initial leaves), then the window from step four. Returns
    (readings, setup_s, window, steps, device, trainable elements)."""
    dev = torch.device(ctx.device)
    b1 = opt.cfg.betas[0]
    losses = []
    for it in range(FIRST_STEPS):
        _, metrics = step(it)
        losses.append(float(metrics["loss"]))
        if it == 0:
            g1 = {n: float(m.norm()) / (1 - b1)
                  for n, m in state["opt"]["mu"].items()}
    t_check = time.perf_counter()
    init = start()
    change = {n: (state["params"][n].detach() - init[n]).cpu() for n in g1}
    del init
    common.sync(dev)
    # reading the program's change for the check is not set-up
    setup_s = t_check - ctx.t_start

    steps = 0
    with common.Window(dev, ctx.trace) as win:
        it = FIRST_STEPS
        while win.done() < ctx.seconds:
            with win.call():
                step(it)
            it += 1
            steps += 1
    n_trainable = sum(p.numel() for p in state["params"].values()
                      if p.requires_grad)
    return ((losses, g1, change), setup_s, win, steps,
            common.device_record(dev, win), n_trainable)


def record(ctx, setup_s, win, steps, batch, device, ops):
    """The run's record of a window of training steps."""
    return {"mode": ctx.traffic["mode"], "setup_s": setup_s,
            "window_s": win.seconds, "units": steps * batch, "calls": steps,
            "flops": steps * ops.flops(),
            "least_s": steps * ops.least_ms() / 1e3,
            "peak_window_bytes": win.peak_bytes, "trace": win.facts,
            "attempted": steps, "failed": 0, "device": device,
            "breakdown": common.breakdown(win)}


def run(ctx):
    from mirage_tpu_torch.cli import run_pretraining as rp
    from mirage_tpu_torch.train.steps import (init_train_state,
                                              make_train_step,
                                              step_generator)

    cfg, traffic, dev = ctx.cfg, ctx.traffic, torch.device(ctx.device)
    args = cli_args(cfg, traffic, ctx.seed, dev)
    model, opt, loss_fn = rp.setup(args, dev)
    model.load_state_dict(weights.make(cfg, ctx.seed, torch.float32, dev),
                          strict=True)
    step_fn = make_train_step(loss_fn, opt)
    state = init_train_state(model, opt)
    args.lr = args.blr * args.batch_size / 256.0
    b, visible = args.batch_size, args.num_encoded_tokens
    pool = batches(cfg, traffic, ctx.seed, dev, b, visible, args.alphas)
    if len(pool) < FIRST_STEPS:
        raise ValueError(f"the pool needs at least {FIRST_STEPS} batches")

    def step(it):
        batch, masks = pool[it % len(pool)]
        return step_fn(state, batch, step_generator(ctx.seed, it, dev),
                       args.lr, 1.0, task_masks=masks, num_visible=visible)

    readings, setup_s, win, steps, device, n_trainable = steps_and_window(
        ctx, step, state, opt,
        lambda: weights.make(cfg, ctx.seed, torch.float32, dev))
    del step, step_fn, state, model, opt, loss_fn
    common.free()
    rec = record(ctx, setup_s, win, steps, b, device,
                 work.pretrain_step(cfg, b, visible, n_trainable))
    ref = reference(cfg, args, ctx.seed, dev, pool, traffic["check"]["rows"])
    rec["checks"] = checks(readings, ref)
    return rec
