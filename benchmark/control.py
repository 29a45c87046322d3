"""The readings the check's limits are set from, for the control and the
faults: not part of a benchmark run.

    python3 -m benchmark.control --workload <cell> --seeds 11 12 13 [--fault fp8|half_batch]

For each seed it builds the cell's inputs exactly as a run does (weights,
volumes or batches and masks from the seed) and prints, as one JSON line,
the cell's compared numbers with the plain reference put in the program's
place: ``fp8`` computes it with fp8 products (the precision below the
configuration's bf16), ``half_batch`` (training) takes each step's loss
over the first half of the batch only. The program's own readings come
from the benchmark's runs; ``PERF.md`` gives both and the limits set
between them.
"""

import argparse
import json
import sys

import torch

from benchmark import run


def infer_readings(ctx, fault):
    from benchmark.drivers import volumes

    cfg, traffic, dev = ctx.cfg, ctx.traffic, torch.device(ctx.device)
    pool = volumes.volumes(cfg, traffic, ctx.seed, dev)
    order = volumes.schedule(traffic, ctx.seed)
    kept = []
    for i in volumes.kept_requests(traffic, order, ctx.seed):
        s = order[i % len(order)]
        kept.append((pool[s][(i // len(order)) % traffic["pool_per_size"]],
                     None))
    return {"worst_image_rel_l2": volumes.compare(cfg, traffic, ctx.seed, dev,
                                                  kept, control=fault)}


def train_readings(ctx, fault):
    from benchmark.drivers import pretrain

    cfg, traffic, dev = ctx.cfg, ctx.traffic, torch.device(ctx.device)
    args = pretrain.cli_args(cfg, traffic, ctx.seed, dev)
    args.lr = args.blr * args.batch_size / 256.0
    pool = pretrain.batches(cfg, traffic, ctx.seed, dev, args.batch_size,
                            args.num_encoded_tokens, args.alphas)
    rows = traffic["check"]["rows"]
    ref = pretrain.reference(cfg, args, ctx.seed, dev, pool, rows)
    if fault == "half_batch":
        half = args.batch_size // 2
        pool = [({t: v[:half] for t, v in b.items()},
                 {t: v[:half] for t, v in m.items()}) for b, m in pool]
        low = pretrain.reference(cfg, args, ctx.seed, dev, pool, rows)
    else:
        low = pretrain.reference(cfg, args, ctx.seed, dev, pool, rows,
                                 precision=fault)
    low = (low[0], {n: float(g.norm()) for n, g in low[1].items()},
           {n: c.cpu() for n, c in low[2].items()})
    return pretrain.checks(low, ref)


def tune_readings(ctx, fault):
    import shutil

    from benchmark.drivers import pretrain, segtune

    cfg, traffic, dev = ctx.cfg, ctx.traffic, torch.device(ctx.device)
    root, path, _ = segtune._files(cfg, ctx.seed, dev)
    try:
        args = segtune.cli_args(cfg, traffic, ctx.seed, dev, root, path)
    finally:
        shutil.rmtree(root)
    pool = segtune.batches(cfg, traffic, ctx.seed, dev, args.batch_size)
    ref = segtune.reference(cfg, args, ctx.seed, dev, pool)
    if fault == "half_batch":
        low = segtune.reference(cfg, args, ctx.seed, dev, pool,
                                rows=args.batch_size // 2)
    else:
        low = segtune.reference(cfg, args, ctx.seed, dev, pool,
                                precision=fault)
    low = (low[0], {n: float(g.norm()) for n, g in low[1].items()},
           {n: c.cpu() for n, c in low[2].items()})
    return pretrain.checks(low, ref)


def readings(workload, seed, fault, device="cuda", cfg=None, traffic=None,
             bench=None):
    """The compared numbers of ``workload`` at ``seed`` with the reference
    under ``fault`` in the program's place."""
    _, _, cfg0, traffic0, cell = run.cell_spec(workload, bench)
    ctx = run.Context(workload, cfg or cfg0, traffic or traffic0, cell, seed,
                      0, False, device, 0.0)
    read = {"infer": infer_readings, "train": train_readings,
            "tune": tune_readings}[ctx.traffic["mode"]]
    return read(ctx, fault)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--fault", default="fp8", choices=("fp8", "half_batch"))
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("benchmark.control: needs a CUDA card", file=sys.stderr)
        return 3
    for seed in a.seeds:
        print(json.dumps({"workload": a.workload, "seed": seed,
                          "fault": a.fault,
                          "readings": readings(a.workload, seed, a.fault)}),
              flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
