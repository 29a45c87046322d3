"""Checkpoints of a train state: save (per epoch, or tagged as the best by a
metric) and resume.

Counterpart of ``mirage_tpu/train/checkpoint.py`` (reference
mutils/checkpoint.py): ``{output_dir}/checkpoint-{epoch|tag}/`` holds
``checkpoint.pth`` (``torch.save`` of the parameters in the model's
state-dict namespace, the optimizer's moments and step counts, the epoch
and the run's arguments; host tensors) and ``meta.json``. Loading copies
into the live train state in place. A moment that a checkpoint saved with
other frozen parameters lacks starts at zero, as the reference does for a
newly trainable parameter; one it has beyond the state's is dropped.
"""

import glob
import json
import os
import re
from typing import Optional

import torch

FILE = "checkpoint.pth"


def _ckpt_dir(output_dir: str, tag) -> str:
    return os.path.join(os.path.abspath(output_dir), f"checkpoint-{tag}")


def _host(tree):
    if torch.is_tensor(tree):
        return tree.detach().cpu()
    return {k: _host(v) for k, v in tree.items()}


def save_checkpoint(output_dir: str, state, epoch, *,
                    args: Optional[dict] = None, tag=None) -> str:
    """Writes ``checkpoint-{epoch}`` (or ``checkpoint-{tag}``); ``args`` is
    kept with its JSON-able values."""
    path = _ckpt_dir(output_dir, epoch if tag is None else tag)
    os.makedirs(path, exist_ok=True)
    meta = {"epoch": int(epoch)}
    if args is not None:
        meta["args"] = {k: v for k, v in args.items() if isinstance(
            v, (int, float, str, bool, list, dict, type(None)))}
    torch.save({"params": _host(state["params"]), "opt": _host(state["opt"]),
                "step": _host(state["step"]), **meta},
               os.path.join(path, FILE))
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f)
    return path


def latest_checkpoint(output_dir: str) -> Optional[str]:
    found = [(int(m.group(1)), d)
             for d in glob.glob(_ckpt_dir(output_dir, "*"))
             if (m := re.search(r"checkpoint-(\d+)$", d))]
    return max(found)[1] if found else None


@torch.no_grad()
def load_checkpoint(path: str, state):
    """Copies a checkpoint into ``state`` in place; returns (state, meta)."""
    ckpt = torch.load(os.path.join(path, FILE), map_location="cpu",
                      weights_only=False)
    for name, p in state["params"].items():
        if name not in ckpt["params"]:
            raise KeyError(f"{path}: no parameter {name}")
        p.copy_(ckpt["params"][name])
    opt = state["opt"]
    opt["count"].copy_(ckpt["opt"]["count"])
    for key in ("mu", "nu"):
        for name, m in opt.get(key, {}).items():
            saved = ckpt["opt"].get(key, {}).get(name)
            if saved is None:
                m.zero_()
            else:
                m.copy_(saved)
    state["step"].copy_(ckpt["step"])
    return state, {k: ckpt[k] for k in ("epoch", "args") if k in ckpt}


def auto_load_checkpoint(output_dir: str, state):
    """Resumes from the newest ``checkpoint-N``: (state, start epoch), or
    (state, 0) without one."""
    path = latest_checkpoint(output_dir)
    if path is None:
        return state, 0
    state, meta = load_checkpoint(path, state)
    return state, int(meta.get("epoch", -1)) + 1

