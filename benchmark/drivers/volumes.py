"""Volume inference through the wrapper, one client in a closed loop.

The traffic file gives the volume sizes (B-scans a request), how many
times each appears in the fixed cycle the seed shuffles, the seeded
volumes held on the device for each size, the modalities given (the rest
absent) and the check: how many requests of each size keep their outputs,
drawn from the seed among the first cycles, and the rows a block of the
reference takes. Set-up writes the seeded state dict as the checkpoint
the wrapper loads (under ``TMPDIR``, removed once loaded), builds
``MIRAGEWrapper``, makes the volumes on the device and runs each size
twice. In the window each request is a call of the wrapper on one volume,
timed on the host from the call to its outputs being ready on the card
(a synchronize). After the window the program is freed and the plain
float32 reference reconstructs the kept volumes from the same state dict:
the compared number is the worst relative L2 error, over the kept
requests, their images and every task, of the program's reconstruction.
"""

import os
import sys
import tempfile
import time

import numpy as np
import torch

from benchmark import work
from benchmark.drivers import common
from benchmark.reference import mirage, weights
from benchmark.reference.numerics import Numerics, strict_float32

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def schedule(traffic, seed):
    """The request sizes in order: the fixed cycle shuffled by the seed."""
    cycle = [s for s in traffic["volume_sizes"]
             for _ in range(traffic["per_cycle"])]
    return [int(s) for s in np.random.default_rng(seed).permutation(cycle)]


def kept_requests(traffic, order, seed):
    """Indices of the requests whose outputs are kept for the check: for
    each size, ``check.per_size`` of its places in the first
    ``check.cycles`` cycles, drawn from the seed."""
    rng = np.random.default_rng(seed + 1)
    n = len(order) * traffic["check"]["cycles"]
    keep = []
    for s in traffic["volume_sizes"]:
        places = [i for i in range(n) if order[i % len(order)] == s]
        keep += rng.choice(places, traffic["check"]["per_size"],
                           replace=False).tolist()
    return sorted(int(i) for i in keep)


def _checkpoint(cfg, sd):
    """The seeded state dict as a reference-style .pth under TMPDIR."""
    args = {"model": cfg["model"], "num_global_tokens":
            cfg["num_global_tokens"], "out_domains": list(cfg["domains"]),
            "decoder_dim": cfg["decoder"]["dim"],
            "decoder_depth": cfg["decoder"]["depth"],
            "decoder_num_heads": cfg["decoder"]["num_heads"],
            "dim_tokens": cfg["dim_tokens"], "depth": cfg["depth"],
            "num_heads": cfg["num_heads"]}
    fd, path = tempfile.mkstemp(prefix="mirage-bench-", suffix=".pth")
    os.close(fd)
    torch.save({"model": {k: v.cpu() for k, v in sd.items()}, "args": args},
               path)
    return path


def build(cfg, traffic, seed, device):
    """The wrapper over the seeded weights."""
    from mirage_tpu_torch.api.wrapper import MIRAGEWrapper

    dtype = DTYPES[cfg["dtype"]["serve"]]
    path = _checkpoint(cfg, weights.make(cfg, seed, dtype, device))
    try:
        dom = cfg["domains"][traffic["given"][0]]
        return MIRAGEWrapper(input_size=dom["image"],
                             patch_size=dom["patch"],
                             modalities="-".join(cfg["domains"]),
                             weights=path, compute_dtype=dtype,
                             device=device)
    finally:
        os.remove(path)


def volumes(cfg, traffic, seed, device):
    """size -> the seeded volumes of that size, (s, C, H, W) in [0, 1)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    pool = {}
    for s in traffic["volume_sizes"]:
        pool[s] = []
        for _ in range(traffic["pool_per_size"]):
            vol = {}
            for t in traffic["given"]:
                dom = cfg["domains"][t]
                vol[t] = torch.rand((s, dom.get("channels", 1), dom["image"],
                                     dom["image"]), generator=gen,
                                    device=device)
            pool[s].append(vol)
    return pool


def compare(cfg, traffic, seed, device, kept, control=None):
    """The worst per-image relative L2 error of the kept outputs against
    the float32 reference on the same weights and volumes. With
    ``control`` (a precision), the kept outputs are ignored and the
    reference in that precision is compared in the program's place."""
    strict_float32()
    num = Numerics("float32")
    low = Numerics(control) if control else None
    dtype = DTYPES[cfg["dtype"]["serve"]]
    sd = {k: v.float() for k, v in
          weights.make(cfg, seed, dtype, device).items()}
    rows = traffic["check"]["rows"]
    worst = 0.0
    with torch.no_grad():
        for vol, out in kept:
            s = next(iter(vol.values())).shape[0]
            for lo in range(0, s, rows):
                part = {t: v[lo:lo + rows] for t, v in vol.items()}
                ref = mirage.reconstruct(num, cfg, sd, part)
                got = (mirage.reconstruct(low, cfg, sd, part) if low else
                       {t: o[lo:lo + rows] for t, o in out.items()})
                for t, r in ref.items():
                    err = ((got[t].float() - r).flatten(1).norm(dim=1)
                           / r.flatten(1).norm(dim=1).clamp_min(1e-30))
                    worst = max(worst, float(torch.nan_to_num(
                        err, nan=float("inf")).max()))
    return worst


def run(ctx):
    cfg, traffic, dev = ctx.cfg, ctx.traffic, torch.device(ctx.device)
    wrapper = build(cfg, traffic, ctx.seed, dev)
    pool = volumes(cfg, traffic, ctx.seed, dev)
    order = schedule(traffic, ctx.seed)
    keep = set(kept_requests(traffic, order, ctx.seed))
    for s in traffic["volume_sizes"]:  # every shape of the window, twice
        for _ in range(2):
            wrapper(pool[s][0])
    common.sync(dev)

    lat_ms, sizes, kept = [], [], []
    setup_s = time.perf_counter() - ctx.t_start
    with common.Window(dev, ctx.trace) as win:
        i = 0
        while win.done() < ctx.seconds:
            s = order[i % len(order)]
            vol = pool[s][(i // len(order)) % traffic["pool_per_size"]]
            t0 = time.perf_counter()
            with win.call():
                out = wrapper(vol)
            common.sync(dev)
            lat_ms.append((time.perf_counter() - t0) * 1e3)
            sizes.append(s)
            if i in keep:
                kept.append((vol, out))
            del out
            i += 1
    device = common.device_record(dev, win)
    for s in traffic["volume_sizes"]:
        lat = [t for t, z in zip(lat_ms, sizes) if z == s]
        if lat:
            print(f"requests of {s}: {len(lat)}, ms median "
                  f"{float(np.median(lat))!r}, p95 {float(np.percentile(lat, 95))!r}, "
                  f"max {max(lat)!r}", file=sys.stderr)
    del wrapper
    common.free()

    present = traffic["given"]
    calls = {s: work.reconstruct(cfg, s, present) for s in set(sizes)}
    rec = {"mode": "infer", "setup_s": setup_s, "window_s": win.seconds,
           "units": sum(sizes), "calls": len(sizes), "latencies_ms": lat_ms,
           "flops": sum(calls[s].flops() for s in sizes),
           "least_s": sum(calls[s].least_ms() for s in sizes) / 1e3,
           "peak_window_bytes": win.peak_bytes, "trace": win.facts,
           "attempted": len(sizes), "failed": 0, "device": device,
           "breakdown": common.breakdown(win)}
    # a kept request that never came back is a failed check
    worst = (compare(cfg, traffic, ctx.seed, dev, kept)
             if len(kept) == len(keep) else float("inf"))
    rec["checks"] = {"worst_image_rel_l2": worst}
    return rec
