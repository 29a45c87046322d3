"""Foundation-model registries for segmentation and classification tuning.

Counterpart of ``mirage_tpu/api/fm_configs.py`` (reference fm_seg_config.py
and fm_cls_config.py): the model to build is picked by a substring of the
weights file's name (``sam_vit_h``: SAM's ViT-H image encoder,
``models/sam.py``, which the JAX package does not have). A segmentation
config gives the per-domain input adapter settings (one channel under
min-max normalisation, three otherwise) and loads a pretraining
checkpoint into the tuning model (surgery, position-embedding resize,
strict=False overlay). A
classification config builds a ``MIRAGECls`` and its transform stack, with
lr 1e-3 for linear probing and 1e-5 for full fine-tuning; the baseline
ViTs of the cls registry (``vit_base``, ``vit_large``: ``models/vit.py``,
ImageNet normalisation, 224² by default) load a timm-keyed checkpoint.

A linear probe freezes the parameters under the config's
``probe_frozen`` names: the MIRAGE backbone and its norm, or every
top-level name of a baseline but its head (the reference's rule: all but
``head.`` frozen, fm_cls_config.py:111-124). The JAX CLI freezes
``("model", "norm")`` for both, which leaves a baseline's blocks
trainable (queue C fault 9, ``mirage_tpu_torch/DEVIATIONS.md``).
"""

import os
from typing import Dict, Optional

from mirage_tpu_torch.api import convert


def pick_fm(factory: Dict[str, type], weights_path: str, **kwargs):
    """The config whose key is a substring of the lower-cased weights path
    (run_seg_tuning.py:389-395)."""
    for kw, cls in factory.items():
        if kw in str(weights_path).lower():
            return cls(**kwargs)
    raise ValueError(f"Unknown model for weights: {weights_path} "
                     f"(known: {list(factory)})")


class SegFoundModel:
    """norm: input normalisation mode; model: the model registry key;
    minmax_ok: ``--minmax`` may replace the norm."""

    norm = "minmax"
    model = "miragelight_base"
    minmax_ok = True

    def domain_conf(self):
        channels = 1 if self.norm == "minmax" else 3
        return {
            "bscan": {"channels": channels, "stride_level": 1,
                      "semseg": False},
            "slo": {"channels": channels, "stride_level": 1,
                    "semseg": False},
            "semseg": {"num_classes": 4, "stride_level": 4, "semseg": True,
                       "dim_class_emb": 64, "emb_padding_idx": 4},
        }

    @staticmethod
    def read(weights_path: str):
        """The state dict of a .pth or safetensors checkpoint."""
        if str(weights_path).endswith(".pth"):
            return convert.load_torch_checkpoint(weights_path)["model"]
        return convert.load_safetensors(str(weights_path))

    def load(self, model, weights_path: str):
        """Loads a pretraining checkpoint (.pth or safetensors) into the
        freshly initialised ``model`` in place (fm_seg_config.py:54-64);
        returns the model's keys the checkpoint did not fill."""
        sd = convert.seg_checkpoint_surgery(self.read(weights_path))
        sd = convert.interpolate_pos_embed_sd(sd, model)
        return convert.overlay_state_dict(model, sd)


class MIRAGELargeSegFM(SegFoundModel):
    model = "miragelight_large"


class MIRAGEBaseSegFM(SegFoundModel):
    model = "miragelight_base"


class SAMViTHSegFM(SegFoundModel):
    """SAM's ViT-H image encoder (``models/sam.py``): RGB in, under SAM's
    pixel mean and standard deviation, which are ImageNet's (whatever
    ``--minmax`` says); its checkpoint in SAM's layout (``image_encoder.*``,
    the prompt encoder's and mask decoder's keys dropped)."""

    norm = "imagenet"
    model = "sam_vit_h"
    minmax_ok = False

    def load(self, model, weights_path: str):
        """Loads SAM's checkpoint (a plain state dict, a {'model': ...}
        one, or safetensors) into ``model``; returns the model's keys it
        did not fill (the head's)."""
        sd = convert.sam_checkpoint_to_port(self.read(weights_path),
                                            model.task)
        return convert.overlay_state_dict(model, sd)


seg_fm_factory = {"mirage-large": MIRAGELargeSegFM,
                  "mirage-base": MIRAGEBaseSegFM,
                  "sam_vit_h": SAMViTHSegFM}


class ClsFoundModel:
    """A MIRAGECls head and its transforms (fm_cls_config.py:27-164)."""

    norm = "minmax"
    size_kw = "base"
    default_input_size = 512  # fm_cls_config.py:137-138

    # the names a linear probe freezes (train/optim.py's frozen_paths)
    probe_frozen = ("model", "norm")

    def __init__(self, linear_probing: bool = True):
        self.linear_probing = linear_probing
        self.lr = 1e-3 if linear_probing else 1e-5
        self.weight_decay = 1e-2

    def frozen_paths(self):
        """The optimizer's frozen names: ``probe_frozen`` under linear
        probing, none in a full fine-tune."""
        return self.probe_frozen if self.linear_probing else ()

    def build_model(self, *, num_classes: int, pool: str, weights: str,
                    input_size: int = 512, patch_size: int = 32,
                    compute_dtype=None, model_override=None, device="cuda"):
        import torch

        from mirage_tpu_torch.api.cls import miragecls_factory

        return miragecls_factory[pool](
            num_classes=num_classes, input_size=input_size,
            patch_size=patch_size, modalities="bscan", weights=weights,
            compute_dtype=compute_dtype or torch.float32,
            model_override=model_override, device=device)

    def build_transform(self, train: bool, input_size: int = 512,
                        fill: Optional[float] = 0.0, affine: bool = True):
        from mirage_tpu_torch.data.augment import ClsTransform

        return ClsTransform(input_size=input_size, train=train,
                            norm=self.norm, fill=fill, affine=affine)


class MIRAGELargeClsFM(ClsFoundModel):
    size_kw = "large"


class MIRAGEBaseClsFM(ClsFoundModel):
    size_kw = "base"


class BaselineViTClsFM(ClsFoundModel):
    """Non-MIRAGE baseline: a timm-style ViT classifier with ImageNet RGB
    normalisation (fm_cls_config.py:101-109), optionally from a timm
    checkpoint (mirage_tpu/api/fm_configs.py:143-190)."""

    norm = "imagenet"
    vit_name = "vit_base_patch16"
    default_input_size = 224
    probe_frozen = ("cls_token", "pos_embed", "patch_embed", "blocks", "norm")

    def build_model(self, *, num_classes: int, pool: str, weights: str,
                    input_size: int = 224, patch_size: int = 16,
                    compute_dtype=None, model_override=None, device="cuda"):
        """``vit_factory[vit_name]`` on ``device`` (``patch_size`` is the
        preset's 16). An existing ``.pth`` or ``.safetensors`` file is
        loaded (:func:`checkpoint_for`); one that lacks a key, or holds one
        of another shape, is reported and the fresh weights are kept."""
        import torch

        from mirage_tpu_torch.models.vit import vit_factory

        if model_override is not None:
            raise ValueError("--model_override applies to MIRAGE configs "
                             "only")
        vit = vit_factory[self.vit_name](
            num_classes=num_classes, img_size=input_size, pool=pool,
            compute_dtype=compute_dtype or torch.float32, device=device)
        if weights and os.path.exists(str(weights)):
            sd = convert.load_torch_checkpoint(weights)["model"] \
                if str(weights).endswith(".pth") \
                else convert.load_safetensors(str(weights))
            try:
                vit.load_state_dict(checkpoint_for(vit, sd), strict=True)
            except (KeyError, ValueError) as e:
                print(f">> baseline ViT: partial/absent weights ({e}); "
                      "training from scratch")
        return vit


def checkpoint_for(vit, sd):
    """The entries of the timm-keyed state dict ``sd`` that ``vit`` loads:
    its head swapped for the fresh one when the class counts differ, its
    ``pos_embed`` resized to the model's grid. A missing key raises
    KeyError, any other shape ValueError."""
    import torch

    own = vit.state_dict()
    out = {k: torch.as_tensor(sd[k]) for k in own}
    if out["head.weight"].shape != own["head.weight"].shape:
        out["head.weight"] = own["head.weight"]
        out["head.bias"] = own["head.bias"]
    if out["pos_embed"].shape != own["pos_embed"].shape:
        out["pos_embed"] = torch.from_numpy(convert.interpolate_vit_pos_embed(
            out["pos_embed"], vit.grid))
    for k, v in out.items():
        if v.shape != own[k].shape:
            raise ValueError(f"{k}: checkpoint shape {tuple(v.shape)}, model "
                             f"shape {tuple(own[k].shape)}")
    return out


class ViTLargeClsFM(BaselineViTClsFM):
    vit_name = "vit_large_patch16"


class ViTBaseClsFM(BaselineViTClsFM):
    vit_name = "vit_base_patch16"


cls_fm_factory = {"mirage-large": MIRAGELargeClsFM,
                  "mirage-base": MIRAGEBaseClsFM,
                  "vit_large": ViTLargeClsFM,
                  "vit_base": ViTBaseClsFM}
