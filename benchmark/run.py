"""Runs one cell of the port's benchmark once and prints its result.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is found by name: its entry in ``BENCHMARK.json`` names a
configuration (``benchmark/configs/<config>.json``) and a traffic mix
(``benchmark/traffic/<traffic>.json``, whose ``driver`` names the general
driver in ``benchmark/drivers/``); ``benchmark/cells/<cell>.json`` holds the
limits of its check. Every metric is read by its own reader,
``benchmark/metrics/<name>.py`` or, for a name ``<base>.<mode>``,
``benchmark/metrics/<base>.py``. Nothing here lists cells, configurations
or metrics: a new one is new files and new entries.

The run builds the cell's program from the seed, warms up the shapes its
traffic uses, measures for ``--seconds``, checks what the timed path
produced against the plain reference, and prints one JSON line last on
standard output: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``: each
compared number with its limit, which also end standard error. Without a
CUDA card, or with fewer than the cell asks for, it exits 3 and prints no
result; if JAX or the JAX package is loaded once the window has closed, it
exits 4.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
# the top-level modules that may not be loaded in the process that reports
FORBIDDEN = ("jax", "jaxlib", "flax", "mirage_tpu")


def load_json(path):
    with open(path) as f:
        return json.load(f)


def cell_spec(workload, bench=None):
    """(workload entry, configuration, traffic, cell file) of a cell."""
    bench = bench or load_json(ROOT / "BENCHMARK.json")
    found = [w for w in bench["workloads"] if w["name"] == workload]
    if not found:
        raise SystemExit(f"benchmark.run: no workload {workload!r} in "
                         f"BENCHMARK.json")
    wl = found[0]
    conf = [c for c in bench["configs"] if c["name"] == wl["config"]][0]
    cfg = load_json(ROOT / conf["file"])
    traffic = load_json(HERE / "traffic" / f"{wl['traffic']}.json")
    cell = load_json(HERE / "cells" / f"{workload}.json")
    return bench, wl, cfg, traffic, cell


def reader(name):
    """The ``read(rec, mode)`` of metric ``name``: its own file, else the
    file of its base name, given the part after the first dot as mode."""
    base, _, mode = name.partition(".")
    for stem in (name, base):
        path = HERE / "metrics" / f"{stem}.py"
        if path.exists():
            spec = importlib.util.spec_from_file_location(
                f"benchmark.metrics.{stem}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return lambda rec, mod=mod, mode=mode or None: mod.read(rec, mode)
    raise FileNotFoundError(f"no reader for metric {name!r} under "
                            f"{HERE / 'metrics'}")


def cell_metrics(bench, workload, traced):
    """The metric entries a run of ``workload`` reports: the end-to-end
    ones that apply to it, or with ``traced`` the per-layer ones (listed
    for it, or, with no list, moving an end-to-end metric it reports)."""
    e2e = [m for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    if not traced:
        return e2e
    reported = {m["name"] for m in e2e}

    def applies(m):
        if "workloads" in m:
            return workload in m["workloads"]
        return m["moves"] in reported

    return [m for m in bench["per_layer"] if applies(m)]


def loaded_forbidden():
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


class Context:
    """What a driver is given: the cell's parts, the run's arguments, the
    device, and the time the process started."""

    def __init__(self, workload, cfg, traffic, cell, seed, seconds, trace,
                 device, t_start):
        self.workload, self.cfg, self.traffic = workload, cfg, traffic
        self.cell, self.seed, self.seconds = cell, seed, seconds
        self.trace, self.device, self.t_start = trace, device, t_start


def run_cell(workload, seed, seconds, trace, device="cuda", bench=None,
             cfg=None, traffic=None, cell=None, t_start=None):
    """One run of ``workload``: the driver's record, its metrics, its
    checks. ``cfg`` / ``traffic`` / ``cell`` replace the cell's (the CPU
    tests run the same path at the dev widths, with limits for that
    size); returns the result object."""
    bench, wl, cfg0, traffic0, cell0 = cell_spec(workload, bench)
    cfg, traffic, cell = cfg or cfg0, traffic or traffic0, cell or cell0
    driver = importlib.import_module(f"benchmark.drivers.{traffic['driver']}")
    ctx = Context(workload, cfg, traffic, cell, seed, seconds, trace,
                  device, T_START if t_start is None else t_start)
    rec = driver.run(ctx)
    metrics = {}
    for m in cell_metrics(bench, workload, trace):
        value = reader(m["name"])(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    # a non-finite reading is printed as null and is never correct
    checks = {k: {"value": v if math.isfinite(v) else None,
                  "limit": cell["limits"][k]}
              for k, v in rec["checks"].items()}
    correct = bool(checks) and all(
        c["value"] is not None and c["value"] <= c["limit"]
        for c in checks.values())
    result = {"correct": correct, "attempted": rec["attempted"],
              "failed": rec["failed"], "metrics": metrics,
              "device": rec["device"]}
    if trace and rec.get("breakdown"):
        result["breakdown"] = rec["breakdown"]
    result["checks"] = checks
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    bench, wl, *_ = cell_spec(a.workload)
    os.environ.setdefault("USE_FLAX", "0")
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < wl["chips"]:
        print(f"benchmark.run: {a.workload} needs {wl['chips']} CUDA "
              f"card(s); {torch.cuda.device_count()} available",
              file=sys.stderr)
        return 3
    result = run_cell(a.workload, a.seed, a.seconds, bool(a.trace),
                      bench=bench)
    found = loaded_forbidden()
    if found:
        print(f"benchmark.run: loaded in this process: {found}",
              file=sys.stderr)
        return 4
    for k, c in result["checks"].items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
