"""The port's bench.py: MIRAGE-Large reconstruction at batch 512 on the card.

    python -m mirage_tpu_torch.bench [--all] [--ab] [--json PATH]
    python -m mirage_tpu_torch.bench --dry-run --device cpu --size tiny [--all] [--ab]

The workload is bench.py:114-143's: ``miragepre_large`` at 512² B-scans
(patch 32) and a 128² layer map, weights from seed 0 with every float
parameter cast to bf16, batch 512, a seeded B-scan with zero SLO and layer
map, the task masks of bench.py:131-135 (the B-scan visible, the other two
masked), ``num_visible=256``, ``absent_tasks=("slo", "bscanlayermap")``,
``mask_inputs=False``, deterministic. One warm-up forward, then ``ITERS``
forwards timed with CUDA events and ended in ``torch.cuda.synchronize()``;
one JSON line with the metric, img/s, the batch, the card's name and its
power limit. bench.py's ``vs_baseline`` (an A100 estimate) is left out.

``--all`` adds the five rows of scripts/bench_train.py (``bench.train``),
``--ab`` the A/B cases S1, S3, S4 and S7, then S2, S5 and S6, one JSON line
each; ``--json``
writes every line's object, as a list, to PATH. Without a card the bench
exits non-zero; ``--dry-run --device cpu --size tiny`` runs the same path
at ``miragepre_tiny`` and batch 2 and prints ``"measured": false`` with no
value.
"""

import argparse
import json
import sys
import time

import numpy as np
import torch

from mirage_tpu_torch import bench

METRIC = "mirage_large_infer_images_per_sec_per_chip"
BATCH = 512  # bench.py:37
ITERS = 12  # bench.py:38
DOMAINS = ("bscan", "slo", "bscanlayermap")
# size -> (model, batch)
SIZES = {"large": ("miragepre_large", BATCH), "tiny": ("miragepre_tiny", 2)}


def build_headline_model(size="large", device="cuda"):
    """The headline model: weights from seed 0, every float parameter in
    bf16 (bench.py:116-123), on ``device``, in eval mode."""
    from mirage_tpu_torch.api.wrapper import build_model

    name = SIZES[size][0]
    args = dict(model=name, num_global_tokens=1, in_domains=list(DOMAINS),
                out_domains=list(DOMAINS), decoder_dim=256, decoder_depth=2,
                decoder_num_heads=8)
    model = build_model(name, args, list(DOMAINS), 512, 32,
                        compute_dtype=torch.bfloat16,
                        generator=torch.Generator().manual_seed(0))
    return model.to(device=device, dtype=torch.bfloat16).eval()


def headline_inputs(batch, device):
    """bench.py:125-135: a seeded B-scan, zero SLO and layer map, and the
    task masks (1 = masked)."""
    rng = np.random.default_rng(0)
    x = {"bscan": torch.from_numpy(
             rng.random((batch, 1, 512, 512), dtype=np.float32)),
         "slo": torch.zeros((batch, 1, 512, 512)),
         "bscanlayermap": torch.zeros((batch, 128, 128), dtype=torch.int64)}
    masks = {"bscan": torch.zeros((batch, 256), dtype=torch.int32),
             "slo": torch.ones((batch, 256), dtype=torch.int32),
             "bscanlayermap": torch.ones((batch, 256), dtype=torch.int32)}
    return ({k: v.to(device) for k, v in x.items()},
            {k: v.to(device) for k, v in masks.items()})


def work(model, batch, n=257):
    """(FLOPs, bytes) of one headline forward: the B-scan's patch embedding
    and n tokens (256 patches + the global token) through the encoder, then
    each decoder (the context projection, the cross-attention half and its
    MLP over the 256 queries and n context tokens, its blocks, the output
    projection); bytes: the parameters, the B-scan and the outputs once."""
    d, depth = model.dim_tokens, model.depth
    q = n - 1
    flops = 2 * q * d * 32 * 32 + depth * (2 * n * d * 4 * d + 4 * n * n * d
                                           + 2 * n * d * 8 * d)
    out_elems = 0
    for a in model.output_adapters.values():
        e, (ph, pw) = a.dim_tokens, a.patch_hw
        flops += (2 * n * d * e + 2 * q * e * e + 2 * n * e * 2 * e
                  + 4 * q * n * e + 2 * q * e * e + 2 * q * e * 8 * e
                  + a.depth * (2 * q * e * 4 * e + 4 * q * q * e
                               + 2 * q * e * 8 * e)
                  + 2 * q * e * a.num_channels * ph * pw)
        out_elems += a.num_channels * q * ph * pw
    params = sum(p.numel() * p.element_size() for p in model.parameters())
    return (batch * flops,
            params + batch * (4 * q * 32 * 32 + 2 * out_elems))


def forward(model, x, masks):
    """One forward as bench.py:138-141 calls it."""
    return model(x, mask_inputs=False, task_masks=masks, num_visible=256,
                 deterministic=True, absent_tasks=("slo", "bscanlayermap"))


@torch.inference_mode()
def headline(size="large", device="cuda", iters=ITERS, measure=True):
    """The headline row: img/s over ``iters`` timed forwards after one
    warm-up; without ``measure``, the dry run (one forward, no time)."""
    dev = torch.device(device)
    model = build_headline_model(size, dev)
    b = SIZES[size][1]
    x, masks = headline_inputs(b, dev)
    out = forward(model, x, masks)  # warm-up
    shapes = {k: list(v.shape) for k, v in out.items()}
    if not all(bool(torch.isfinite(v).all()) for v in out.values()):
        raise AssertionError(f"non-finite headline output {shapes}")
    if not measure:
        return {"metric": METRIC, "measured": False, "unit": "images/sec",
                "batch": b, "device": str(dev), "model": SIZES[size][0],
                "output_shapes": shapes}
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        out = forward(model, x, masks)
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / iters
    flops, nbytes = work(model, b)
    bound_ms, bound_by = bench.bound(flops, nbytes)
    return {"metric": METRIC, "value": b / ms * 1e3, "unit": "images/sec",
            "batch": b, "ms_per_batch": ms, "iters": iters,
            "gflop_per_image": flops / b / 1e9, "bound_ms": bound_ms,
            "bound_by": bound_by, "bound_img_per_s": b / bound_ms * 1e3,
            **bench.card()}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--all", action="store_true",
                    help="also the five scripts/bench_train.py rows")
    ap.add_argument("--ab", action="store_true",
                    help="also the A/B cases S1-S7")
    ap.add_argument("--json", default=None, help="write every row here")
    ap.add_argument("--dry-run", action="store_true",
                    help="run the path without timing it (the CPU test)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--size", choices=sorted(SIZES), default="large")
    a = ap.parse_args(argv)
    dev = torch.device(a.device)
    if not a.dry_run and (dev.type != "cuda" or not torch.cuda.is_available()):
        print("mirage_tpu_torch.bench: measures on a CUDA card only (none "
              "available, or --device is not cuda); --dry-run --device cpu "
              "--size tiny runs the path without timing it", file=sys.stderr)
        return 2
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("mirage_tpu_torch.bench: no CUDA device available",
              file=sys.stderr)
        return 2
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    measure = not a.dry_run
    rows = [headline(size=a.size, device=dev, measure=measure)]
    print(json.dumps(rows[-1]), flush=True)
    if a.all:
        from mirage_tpu_torch.bench import train

        for row in train.run(size=a.size, device=dev, measure=measure):
            rows.append(row)
            print(json.dumps(row), flush=True)
    if a.ab:
        from mirage_tpu_torch.bench import (attn2, attn_half, int8, lnfold,
                                            overlap, pad264, vpu)

        for mod in (attn2, int8, lnfold, pad264, attn_half, vpu, overlap):
            for row in mod.run(size=a.size, device=dev, measure=measure):
                rows.append(row)
                print(json.dumps(row), flush=True)
    if a.json:
        with open(a.json, "w") as f:
            json.dump(rows, f, indent=1)
    print(f"mirage_tpu_torch.bench: {len(rows)} rows in "
          f"{time.perf_counter() - t0:.1f}s", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
