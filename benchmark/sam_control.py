"""The readings the ``sam_vit_huge`` cell's limits are set from, for the
control and the planted faults: not part of a benchmark run.

    python3 -m benchmark.sam_control --seeds 11 12 13 \
        [--faults fp8 no_bias mask_pad global_windowed]

For each seed it builds the cell's inputs exactly as a run does (the
seeded weights and batches) and prints, as one JSON line a seed and
fault, the cell's compared numbers with the plain reference put in the
program's place: ``fp8`` computes it with fp8 products (the precision
below the configuration's bf16); ``no_bias``, ``mask_pad`` and
``global_windowed`` plant a fault in its encoder
(``benchmark/reference/sam.py``: the relative-position bias left out, the
padded keys masked, the global blocks run over windows). The program's
own readings come from the benchmark's runs; ``PERF.md`` gives both and
the limits set between them. (``benchmark/control.py`` takes the
pretraining and segmentation-tuning cells: it picks its reader by the
traffic's ``mode`` and has none for this cell's ``sam_seg`` driver.)
"""

import argparse
import json
import shutil
import sys

import torch

from benchmark import run
from benchmark.drivers import pretrain, sam_seg, segtune
from benchmark.reference import sam as ref_sam

FAULTS = ("fp8", "no_bias", "mask_pad", "global_windowed")
WORKLOAD = "sam_vit_huge.seg_frozen_1024"


def readings(seed, faults=FAULTS, device="cuda", cfg=None, traffic=None,
             workload=WORKLOAD, bench=None):
    """fault -> the compared numbers of the cell at ``seed`` with the
    reference under that fault in the program's place."""
    _, _, cfg0, traffic0, _ = run.cell_spec(workload, bench)
    cfg, traffic, dev = cfg or cfg0, traffic or traffic0, torch.device(device)
    root = sam_seg.files(cfg)
    try:
        args = sam_seg.cli_args(cfg, traffic, seed, dev, root)
    finally:
        shutil.rmtree(root)
    pool = segtune.batches(cfg, traffic, seed, dev, args.batch_size)
    ref = ref_sam.reference(cfg, args, seed, dev, pool)
    out = {}
    for fault in faults:
        low = ref_sam.reference(
            cfg, args, seed, dev, pool,
            precision="fp8" if fault == "fp8" else "float32",
            fault=None if fault == "fp8" else fault)
        out[fault] = {"feature_gap": sam_seg.feature_gap(low[3], ref[3]),
                      **pretrain.checks(
                          (low[0], {n: float(g.norm()) for n, g in
                                    low[1].items()},
                           {n: c.cpu() for n, c in low[2].items()}),
                          ref[:3])}
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--faults", nargs="+", default=list(FAULTS),
                    choices=FAULTS)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("benchmark.sam_control: needs a CUDA card", file=sys.stderr)
        return 3
    for seed in a.seeds:
        for fault, r in readings(seed, a.faults).items():
            print(json.dumps({"workload": WORKLOAD, "seed": seed,
                              "fault": fault, "readings": r}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
