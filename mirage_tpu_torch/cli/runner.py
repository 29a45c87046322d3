#!/usr/bin/env python3
"""Experiment grid launcher.

A copy of ``mirage_tpu/cli/runner.py`` (the reference ``runner`` script),
which imports no JAX: it builds the cartesian product of the multi-valued
flags after ``--``, drops the combinations that hold every token of a
``--runner-filter a,b`` group, runs the commands through a pool of
``--runners N`` threads (each a shell) and, with ``--runner-info``, only
prints them.

Usage:
  python -m mirage_tpu_torch.cli.runner \\
      "python -m mirage_tpu_torch.cli.run_cls_tuning --data_root /data \\
       --weights MIRAGE-Base.pth" \\
      --runners 2 -- --data_set OCTID OCTDL --pool global token_mix
  python -m mirage_tpu_torch.cli.runner \\
      "python -m mirage_tpu_torch.cli.run_seg_tuning \\
       -c configs/seg_200e_convnext.yaml" \\
      --runner-info -- --weights MIRAGE-Base.pth MIRAGE-Large.pth
"""

import subprocess
import sys
from itertools import product
from multiprocessing.pool import ThreadPool


def parse(argv):
    base_parts = []
    num_runners = 1
    info = False
    incompatible = []
    grid = []  # list of [(flag, value-or-None), ...] alternatives

    i = 0
    in_grid = False
    while i < len(argv):
        arg = argv[i]
        # runner-control flags are recognized anywhere, like the reference
        if arg == "--runners":
            num_runners = int(argv[i + 1])
            i += 2
            continue
        if arg == "--runner-info":
            info = True
            i += 1
            continue
        if arg == "--runner-filter":
            i += 1
            while i < len(argv) and not argv[i].startswith("--"):
                incompatible.append(argv[i].split(","))
                i += 1
            continue
        if not in_grid:
            if arg == "--":
                in_grid = True
                i += 1
                continue
            base_parts.append(arg)
            i += 1
            continue
        # grid section: --flag v1 v2 ... or bare --flag
        assert arg.startswith("--"), f"expected a flag in grid section, got {arg}"
        values = []
        i += 1
        while i < len(argv) and not argv[i].startswith("--"):
            values.append(argv[i])
            i += 1
        if values:
            grid.append([(arg, v) for v in values])
        else:
            grid.append([(arg, None)])

    return " ".join(base_parts), num_runners, info, incompatible, grid


def build_commands(base, grid, incompatible):
    commands = []
    for comb in product(*grid):
        cmd = base
        for flag, value in comb:
            cmd += f" {flag} {value}" if value is not None else f" {flag}"
        if any(all(tok in cmd for tok in group) for group in incompatible):
            continue
        commands.append(cmd)
    return commands


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    base, num_runners, info, incompatible, grid = parse(argv)
    commands = build_commands(base, grid, incompatible)
    print(f"Number of commands: {len(commands)}")
    print(f"Number of runners: {num_runners}")

    def run(cmd):
        print("=" * 80)
        print(cmd)
        print("-" * 80)
        if not info:
            return subprocess.call(cmd, shell=True)
        return 0

    with ThreadPool(num_runners) as pool:
        codes = pool.map(run, commands)
    failed = sum(1 for c in codes if c != 0)
    if failed:
        print(f"{failed}/{len(commands)} commands failed")
    return codes


if __name__ == "__main__":
    main()
