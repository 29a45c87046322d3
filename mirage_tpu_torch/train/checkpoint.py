"""Checkpoints of a train state: save (per epoch, or tagged as the best by a
metric) and resume.

Counterpart of ``mirage_tpu/train/checkpoint.py`` (reference
mutils/checkpoint.py): ``{output_dir}/checkpoint-{epoch|tag}/`` holds
``checkpoint.pth`` (``torch.save`` of the parameters in the model's
state-dict namespace, the optimizer's moments and step counts, the epoch
and the run's arguments; host tensors) and ``meta.json``; ``keep_every``
prunes the older epochs. Loading copies into the live train state in place
(``load_best_checkpoint`` from ``checkpoint-best``). ``resolve_pretrained``
finds a weights file. A moment that a checkpoint saved with
other frozen parameters lacks starts at zero, as the reference does for a
newly trainable parameter; one it has beyond the state's is dropped.

A state placed on a mesh (``train/steps.py:shard_state``) is gathered to
the standard layout (the qkv leaves unrelayouted, every shard joined) by
every process together, and process 0 alone writes it and prunes; each
process loads the whole file and copies in its own part, so a run resumes
into any layout (a tensor-parallel checkpoint into data parallelism, and
the reverse).
"""

import glob
import json
import os
import re
import shutil
from typing import Optional

import torch
import torch.distributed as dist

FILE = "checkpoint.pth"


def _ckpt_dir(output_dir: str, tag) -> str:
    return os.path.join(os.path.abspath(output_dir), f"checkpoint-{tag}")


def _writer() -> bool:
    """Whether this process writes (process 0 of a group, or no group)."""
    return not dist.is_initialized() or dist.get_rank() == 0


def snapshot(state):
    """A host copy of a train state in the standard layout, kept apart from
    the live one (which the steps update in place): the best model held in
    memory. Collective for a placed state."""
    from mirage_tpu_torch.train.steps import gather_state

    return gather_state(state)


def save_checkpoint(output_dir: str, state, epoch, *,
                    args: Optional[dict] = None, tag=None,
                    keep_every: int = 0) -> str:
    """Writes ``checkpoint-{epoch}`` (or ``checkpoint-{tag}``); ``args`` is
    kept with its JSON-able values. ``keep_every`` > 0 then prunes the epoch
    checkpoints (:func:`prune_checkpoints`)."""
    from mirage_tpu_torch.train.steps import gather_state

    path = _ckpt_dir(output_dir, epoch if tag is None else tag)
    whole = gather_state(state)
    if _writer():
        _write(path, whole, epoch, args, output_dir, keep_every)
    if dist.is_initialized():
        dist.barrier()  # every process may read it from here on
    return path


def _write(path, whole, epoch, args, output_dir, keep_every):
    os.makedirs(path, exist_ok=True)
    meta = {"epoch": int(epoch)}
    if args is not None:
        meta["args"] = {k: v for k, v in args.items() if isinstance(
            v, (int, float, str, bool, list, dict, type(None)))}
    torch.save({**whole, **meta}, os.path.join(path, FILE))
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f)
    if keep_every:
        prune_checkpoints(output_dir, keep_every)


def _epochs(output_dir: str):
    """[(epoch, directory)] of the ``checkpoint-N`` directories."""
    return [(int(m.group(1)), d)
            for d in glob.glob(_ckpt_dir(output_dir, "*"))
            if (m := re.search(r"checkpoint-(\d+)$", d))]


def prune_checkpoints(output_dir: str, keep_every: int):
    """Deletes every epoch checkpoint but the latest and those of epochs
    divisible by ``keep_every``; tagged ones (``checkpoint-best``) stay."""
    for epoch, path in sorted(_epochs(output_dir))[:-1]:
        if epoch % keep_every:
            shutil.rmtree(path, ignore_errors=True)


def latest_checkpoint(output_dir: str) -> Optional[str]:
    found = _epochs(output_dir)
    return max(found)[1] if found else None


def load_checkpoint(path: str, state):
    """Copies a checkpoint into ``state`` (placed or not) in place;
    returns (state, meta)."""
    from mirage_tpu_torch.train.steps import load_whole

    ckpt = torch.load(os.path.join(path, FILE), map_location="cpu",
                      weights_only=False)
    for name in state["params"]:
        if name not in ckpt["params"]:
            raise KeyError(f"{path}: no parameter {name}")
    load_whole(state, ckpt)
    return state, {k: ckpt[k] for k in ("epoch", "args") if k in ckpt}


def load_best_checkpoint(output_dir: str, state):
    """Copies ``checkpoint-best`` into ``state`` in place; raises
    FileNotFoundError without one."""
    path = _ckpt_dir(output_dir, "best")
    if not os.path.isdir(path):
        raise FileNotFoundError(path)
    return load_checkpoint(path, state)[0]


def auto_load_checkpoint(output_dir: str, state):
    """Resumes from the newest ``checkpoint-N``: (state, start epoch), or
    (state, 0) without one."""
    path = latest_checkpoint(output_dir)
    if path is None:
        return state, 0
    state, meta = load_checkpoint(path, state)
    return state, int(meta.get("epoch", -1)) + 1



def resolve_pretrained(name_or_path: str) -> str:
    """A local weights file for ``name_or_path``: the path itself, a
    directory's ``model.safetensors`` or ``model.pth``, or, for a name that
    is not a local path, ``model.safetensors`` of that Hugging Face repo
    when ``huggingface_hub`` imports (mirage_tpu/train/checkpoint.py:224).
    Raises FileNotFoundError when none is found."""
    if os.path.isdir(name_or_path):
        for fname in ("model.safetensors", "model.pth"):
            candidate = os.path.join(name_or_path, fname)
            if os.path.isfile(candidate):
                return candidate
        raise FileNotFoundError(f"no model.safetensors or model.pth under "
                                f"{name_or_path}")
    if os.path.exists(name_or_path):
        return name_or_path
    try:
        from huggingface_hub import hf_hub_download
    except ImportError as e:
        raise FileNotFoundError(
            f"{name_or_path} is not a local path, and huggingface_hub is "
            f"not installed to look it up") from e
    try:
        return hf_hub_download(repo_id=name_or_path,
                               filename="model.safetensors")
    except Exception as e:  # offline, or no such repo
        raise FileNotFoundError(f"{name_or_path} is neither a local path "
                                f"nor a reachable repo: {e}") from e
