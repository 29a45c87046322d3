"""Hugging Face distribution helper.

Counterpart of ``mirage_tpu/cli/hf_push.py`` (reference hf/helper_hf.py),
with the standard library's safetensors writer (``api/convert.py:
save_safetensors``) in place of the ``safetensors`` package, which the
card's machine lacks:

- ``-t push`` converts a reference-format checkpoint (``.pth`` or
  ``.safetensors``) into the encoder-only layout (``model.safetensors``
  without the reconstruction decoders, ``config.json``, ``README.md``)
  in a local directory, and uploads it with ``--hub`` (``huggingface_hub``
  is imported only then);
- ``-t load`` reads it back through the one-file API
  (``hf.py:MIRAGEWrapper.from_pretrained``) and runs its forward on the
  card (``--device cpu`` for the CPU);
- ``-t export`` writes a training checkpoint (a ``checkpoint-N`` or
  ``checkpoint-best`` directory of ``train/checkpoint.py``) as
  ``model.safetensors`` in the reference namespace, with a ``config.json``,
  the model rebuilt from the arguments its ``meta.json`` recorded.

Usage:
  python -m mirage_tpu_torch.cli.hf_push -t push -s base \\
      --weights ./__weights/MIRAGE-Base.pth [--repo j-morano/MIRAGE-Base --hub]
  python -m mirage_tpu_torch.cli.hf_push -t load -s base --path ./MIRAGE-Base
  python -m mirage_tpu_torch.cli.hf_push -t export \\
      --weights ./output/pretrain/checkpoint-99 [--path model.safetensors]
"""

import argparse
import json
import os


def export_checkpoint(ckpt_dir: str, out_path: str):
    """A training checkpoint -> a reference-namespace ``model.safetensors``
    at ``out_path`` and a ``config.json`` beside it (the counterpart of
    ``export_orbax``, mirage_tpu/cli/hf_push.py:25-49): the model is
    rebuilt from ``meta.json``'s arguments and loads the checkpoint's
    parameters strictly, so a checkpoint of another configuration raises."""
    from argparse import Namespace

    import torch

    from mirage_tpu_torch.api import convert
    from mirage_tpu_torch.cli.run_pretraining import build_model
    from mirage_tpu_torch.train.checkpoint import FILE

    with open(os.path.join(ckpt_dir, "meta.json")) as f:
        args = Namespace(**json.load(f)["args"])
    args.patch_size = {k: tuple(v) for k, v in args.patch_size.items()}
    args.input_size = {k: tuple(v) for k, v in args.input_size.items()}
    model = build_model(args)
    ckpt = torch.load(os.path.join(ckpt_dir, FILE), map_location="cpu",
                      weights_only=False)
    model.load_state_dict(ckpt["params"], strict=True)
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    convert.save_safetensors(model.state_dict(), out_path)
    first = args.in_domains[0]
    config = {"input_size": list(args.input_size[first]),
              "patch_size": list(args.patch_size[first]),
              "modalities": "-".join(args.in_domains),
              "size": args.model.rsplit("_", 1)[-1]}
    with open(os.path.join(os.path.dirname(out_path) or ".", "config.json"),
              "w") as f:
        json.dump(config, f, indent=2)
    print(f"Exported {ckpt_dir} -> {out_path}")
    return out_path


def model_card(size: str) -> str:
    """The README of a pushed repo (hf/helper_hf.py:56-62 uploads
    hf/README.md beside the config and weights)."""
    name = f"MIRAGE-{size.capitalize()}"
    vit = "ViT-Base" if size == "base" else "ViT-Large"
    return f"""---
license: cc-by-nc-nd-4.0
library_name: pytorch
pipeline_tag: image-feature-extraction
tags:
- OCT
- SLO
- retinal-imaging
- classification
- segmentation
- pytorch
---

# {name} (PyTorch / CUDA)

Weights of the {name} multimodal retinal-imaging foundation model
(based on {vit}), from "MIRAGE: Multimodal foundation model and benchmark
for comprehensive retinal OCT image analysis" (arXiv:2506.08900), in the
PyTorch reference key namespace, so they also load in the original repo
(https://github.com/j-morano/MIRAGE).

## Models

Model | Resolution | Repo
--- | --- | ---
MIRAGE-Base  | 512x512 | j-morano/MIRAGE-Base
MIRAGE-Large | 512x512 | j-morano/MIRAGE-Large

## Usage

Only the self-contained `hf.py` (torch + numpy) is needed:

```python
import numpy as np
from mirage_tpu_torch.hf import MIRAGEWrapper  # or: from hf import MIRAGEWrapper

model = MIRAGEWrapper.from_pretrained("j-morano/{name}", size="{size}")
bscan = np.zeros((1, 1, 512, 512), np.float32)  # [0, 1] grayscale
slo = np.zeros((1, 1, 512, 512), np.float32)
features = model({{"bscan": bscan, "slo": slo}})  # (B, 513, D) tokens
```

Pass `device="cpu"` without a CUDA card. For reconstruction decoders,
fine-tuning and the full benchmark pipeline see the `mirage_tpu_torch`
package (`api/wrapper.py`, `cli/`).

## Citation

Morano et al., "MIRAGE: Multimodal foundation model and benchmark for
comprehensive retinal OCT image analysis", arXiv:2506.08900, 2025.
"""


def main(argv=None):
    p = argparse.ArgumentParser("MIRAGE HF push/load/export")
    p.add_argument("-t", "--task", choices=["push", "load", "export"],
                   required=True)
    p.add_argument("-s", "--size", choices=["base", "large"], default="base")
    p.add_argument("--weights", default=None, type=str)
    p.add_argument("--path", default=None, type=str,
                   help="local output dir (push) / source (load) / output "
                   "file (export)")
    p.add_argument("--repo", default=None, type=str)
    p.add_argument("--hub", action="store_true",
                   help="also push to the HF hub (requires network + token)")
    p.add_argument("--device", default="cuda",
                   help="load: cuda (default; fails without a card) or cpu")
    args = p.parse_args(argv)

    name = f"MIRAGE-{args.size.capitalize()}"
    config = {"input_size": 512, "patch_size": 32, "modalities": "bscan-slo",
              "size": args.size}

    if args.task == "export":
        if not args.weights:
            p.error("-t export needs --weights: a checkpoint directory "
                    "(checkpoint-N)")
        out = args.path or os.path.join(
            os.path.dirname(args.weights.rstrip("/")), "model.safetensors")
        return export_checkpoint(args.weights, out)

    if args.task == "push":
        from mirage_tpu_torch.api import convert

        weights = args.weights or f"./__weights/{name}.pth"
        if weights.endswith(".pth"):
            sd = convert.load_torch_checkpoint(weights)["model"]
        else:
            sd = convert.load_safetensors(weights)
        # encoder-only flavour: the reconstruction decoders dropped
        sd = {k: v for k, v in sd.items() if "output_adapters" not in k}
        out_dir = args.path or name
        os.makedirs(out_dir, exist_ok=True)
        convert.save_safetensors(sd, os.path.join(out_dir,
                                                  "model.safetensors"))
        with open(os.path.join(out_dir, "config.json"), "w") as f:
            json.dump(config, f, indent=2)
        with open(os.path.join(out_dir, "README.md"), "w") as f:
            f.write(model_card(args.size))
        print(f"Wrote {out_dir}/model.safetensors ({len(sd)} tensors) "
              "+ config.json + README.md")
        if args.hub:
            from huggingface_hub import HfApi

            api = HfApi()
            repo = args.repo or f"j-morano/{name}"
            api.create_repo(repo, repo_type="model", exist_ok=True)
            api.upload_folder(folder_path=out_dir, repo_id=repo,
                              repo_type="model")
            print(f"Pushed to {repo}")
        return out_dir

    import numpy as np

    from mirage_tpu_torch.hf import MIRAGEWrapper

    src = args.path or (args.repo or f"j-morano/{name}")
    model = MIRAGEWrapper.from_pretrained(src, size=args.size,
                                          device=args.device)
    x = np.zeros((1, 1, 512, 512), np.float32)
    out = model({"bscan": x, "slo": x})
    print(f"Loaded {src}: features {tuple(out.shape)} on {out.device}")
    return out


if __name__ == "__main__":
    main()
