"""Flags: argparse with a YAML file's values as defaults.

A fork of ``mirage_tpu/cli/config.py`` (reference run_pretraining.py:59-66,
:306-339): ``-c/--config`` names a YAML file whose keys set the parser's
defaults, explicit flags override them, and int sizes become per-domain
(h, w).
"""

import argparse
import json
import os


def str2bool(v) -> bool:
    """argparse bool type: true/false, 1/0, yes/no."""
    if isinstance(v, bool):
        return v
    s = str(v).strip().lower()
    if s in ("true", "1", "yes", "y", "t"):
        return True
    if s in ("false", "0", "no", "n", "f"):
        return False
    raise argparse.ArgumentTypeError(f"boolean value expected, got {v!r}")


def parse_with_yaml(parser: argparse.ArgumentParser, argv=None):
    """-c/--config YAML sets defaults; explicit flags override."""
    import yaml

    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("-c", "--config", default="", type=str)
    cfg_args, remaining = pre.parse_known_args(argv)
    if cfg_args.config:
        with open(cfg_args.config) as f:
            cfg = yaml.safe_load(f) or {}
        unknown = set(cfg) - {a.dest for a in parser._actions}
        if unknown:
            raise ValueError(f"Unknown config keys in {cfg_args.config}: "
                             f"{sorted(unknown)}")
        parser.set_defaults(**cfg)
    args = parser.parse_args(remaining)
    args.config = cfg_args.config
    return args


def normalize_domain_sizes(args, domains,
                           size_attrs=("input_size", "patch_size")):
    """int or {domain: (h, w)} -> {domain: (h, w)} for every domain, and
    args.grid_size per domain."""
    for attr in size_attrs:
        v = getattr(args, attr)
        if isinstance(v, int):
            v = {d: (v, v) for d in domains}
        else:
            v = {d: tuple(v[d]) for d in v}
        setattr(args, attr, v)
    args.grid_size = {d: tuple(args.input_size[d][i] // args.patch_size[d][i]
                               for i in range(2))
                      for d in domains
                      if d in args.input_size and d in args.patch_size}
    return args


def save_args(output_dir: str, args, name: str = "config.json"):
    os.makedirs(output_dir, exist_ok=True)
    with open(os.path.join(output_dir, name), "w") as f:
        json.dump(vars(args), f, indent=2, default=str)
