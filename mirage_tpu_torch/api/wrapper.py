"""Public inference API: MIRAGEWrapper.

Counterpart of ``mirage_tpu/api/wrapper.py``: loads a reference ``.pth``
(or safetensors) checkpoint, rebuilds the model for the requested modalities
('bscan-slo-bscanlayermap') and runs the reference wrapper's contract:
missing modalities are zero-filled and fully masked, present ones fully
visible. Runs on ``device`` (default ``"cuda"``, which raises when no card
is present); pass ``device="cpu"`` for the plain PyTorch path.
"""

from typing import Dict, Optional

import numpy as np
import torch

from mirage_tpu_torch.adapters.input_adapters import (PatchedInputAdapter,
                                                      SemSegInputAdapter,
                                                      pair)
from mirage_tpu_torch.adapters.spatial_output import SpatialOutputAdapter
from mirage_tpu_torch.api import convert
from mirage_tpu_torch.models.mirage import MIRAGEModel
from mirage_tpu_torch.ops.runtime import resolve_device


def default_domain_conf(task: str) -> Dict:
    """The reference wrapper's DOMAIN_CONF."""
    if task == "bscanlayermap":
        return {"num_classes": 13, "stride_level": 1, "channels": 13,
                "semseg": True, "dim_class_emb": 64}
    return {"channels": 1, "stride_level": 1, "semseg": False}


def domain_geometry(in_domains, input_size=512, patch_size=32):
    """task -> (input size, patch size); layer maps are 128² at patch 8."""
    geo = {}
    for domain in in_domains:
        if domain == "bscanlayermap":
            geo[domain] = ((128, 128), (8, 8))
        else:
            geo[domain] = (pair(input_size), pair(patch_size))
    return geo


def build_model(model_name: str, args: Dict, in_domains, input_size=512,
                patch_size=32, compute_dtype=torch.float32,
                with_outputs: bool = True,
                generator: Optional[torch.Generator] = None) -> MIRAGEModel:
    """The MIRAGEModel a checkpoint with ``args`` describes."""
    geo = domain_geometry(in_domains, input_size, patch_size)
    inputs = {}
    for domain in in_domains:
        conf = default_domain_conf(domain)
        size, patch = geo[domain]
        if conf["semseg"]:
            inputs[domain] = SemSegInputAdapter(
                num_classes=conf["num_classes"],
                stride_level=conf["stride_level"], patch_size_full=patch,
                dim_class_emb=conf["dim_class_emb"], image_size=size)
        else:
            inputs[domain] = PatchedInputAdapter(
                num_channels=conf["channels"],
                stride_level=conf["stride_level"], patch_size_full=patch,
                image_size=size)
    outputs = None
    out_domains = list(args.get("out_domains", in_domains))
    if with_outputs and out_domains:
        outputs = {}
        for domain in out_domains:
            conf = default_domain_conf(domain)
            size, patch = geo[domain]
            outputs[domain] = SpatialOutputAdapter(
                num_channels=conf.get("num_classes", conf["channels"]),
                stride_level=conf["stride_level"], patch_size_full=patch,
                dim_tokens=args.get("decoder_dim", 256),
                depth=args.get("decoder_depth", 2),
                num_heads=args.get("decoder_num_heads", 8),
                use_task_queries=args.get("decoder_use_task_queries", True),
                task=domain, context_tasks=tuple(in_domains),
                use_xattn=args.get("decoder_use_xattn", True),
                image_size=size)
    if "large" in model_name:
        dim, depth, heads = 1024, 24, 16
    elif "base" in model_name:
        dim, depth, heads = 768, 12, 12
    elif "tiny" in model_name:  # dev size; checkpoint args may override it
        dim = args.get("dim_tokens", 192)
        depth = args.get("depth", 3)
        heads = args.get("num_heads", 4)
    else:
        raise ValueError(f"Unknown model size: {model_name}")
    return MIRAGEModel(inputs, outputs,
                       num_global_tokens=args.get("num_global_tokens", 1),
                       dim_tokens=dim, depth=depth, num_heads=heads,
                       compute_dtype=compute_dtype, generator=generator)


class MIRAGEWrapper:
    def __init__(self, input_size=512, patch_size=32,
                 modalities: str = "bscan-slo-bscanlayermap",
                 weights: Optional[str] = None, compute_dtype=torch.float32,
                 output_adapters: bool = True,
                 model_override: Optional[str] = None, device="cuda"):
        """compute_dtype: torch.float32 or torch.bfloat16; the weights are
        held in it on ``device``."""
        if weights is None:
            raise ValueError("weights= is required")
        self.device = resolve_device(device)
        if str(weights).endswith(".pth"):
            ckpt = convert.load_torch_checkpoint(str(weights))
        else:
            ckpt = {"model": convert.load_safetensors(str(weights)),
                    "args": {}}
        self.args = dict(ckpt["args"])
        self.in_domains = modalities.split("-")
        geo = domain_geometry(self.in_domains, input_size, patch_size)
        self.input_size = {d: g[0] for d, g in geo.items()}
        self.patch_size = {d: g[1] for d, g in geo.items()}
        self.out_domains = (list(self.args.get("out_domains", self.in_domains))
                            if output_adapters else [])
        model_name = model_override or self.args.get("model",
                                                     "miragepre_base")
        model = build_model(model_name, self.args, self.in_domains,
                            input_size, patch_size, compute_dtype,
                            with_outputs=output_adapters)
        sd = ckpt["model"]
        if not output_adapters:
            sd = {k: v for k, v in sd.items()
                  if not k.startswith("output_adapters.")}
        model.load_state_dict(sd, strict=True)
        self.model = model.to(device=self.device, dtype=compute_dtype).eval()
        self.compute_dtype = compute_dtype
        self.n_params = sum(p.numel() for p in self.model.parameters())

    def _inputs(self, x):
        """Input arrays -> tensors on the device (labels as int64)."""
        out = {}
        for k, v in x.items():
            t = torch.as_tensor(np.asarray(v) if not torch.is_tensor(v)
                                else v)
            t = t.long() if k == "bscanlayermap" else t.float()
            out[k] = t.to(self.device)
        return out

    @torch.inference_mode()
    def __call__(self, x: Dict):
        """x: task -> (B, 1, H, W) float in [0, 1], or (B, H, W) integer
        labels for bscanlayermap (numpy or torch). Missing modalities are
        zero-filled and masked. Returns task -> (B, C, H, W) on the device,
        in compute_dtype."""
        x = self._inputs(x)
        batch = next(iter(x.values())).shape[0]
        absent = []
        for k in self.in_domains:
            if k not in x:
                shape = (batch, *self.input_size[k]) if k == "bscanlayermap" \
                    else (batch, 1, *self.input_size[k])
                x[k] = torch.zeros(shape, device=self.device)
                absent.append(k)
        return self.model(x, absent_tasks=tuple(absent))

    @torch.inference_mode()
    def features(self, x: Dict):
        """Encoder features (B, N + G, D) of the given modalities."""
        return self.model.features(self._inputs(x))
