"""Foundation-model registries for segmentation and classification tuning.

Counterpart of ``mirage_tpu/api/fm_configs.py`` (reference fm_seg_config.py
and fm_cls_config.py): the model to build is picked by a substring of the
weights file's name. A segmentation config gives the per-domain input
adapter settings (one channel under min-max normalisation, three
otherwise) and loads a pretraining checkpoint into the tuning model
(surgery, position-embedding resize, strict=False overlay). A
classification config builds a ``MIRAGECls`` and its transform stack, with
lr 1e-3 for linear probing and 1e-5 for full fine-tuning. The baseline ViTs
of the cls registry (``vit_base``, ``vit_large``) are not ported yet.
"""

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
    """norm: input normalisation mode; model: the model registry key."""

    norm = "minmax"
    model = "miragelight_base"

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

    def load(self, model, weights_path: str):
        """Loads a pretraining checkpoint (.pth or safetensors) into the
        freshly initialised ``model`` in place (fm_seg_config.py:54-64);
        returns the model's keys the checkpoint did not fill."""
        if str(weights_path).endswith(".pth"):
            sd = convert.load_torch_checkpoint(weights_path)["model"]
        else:
            sd = convert.load_safetensors(str(weights_path))
        sd = convert.seg_checkpoint_surgery(sd)
        sd = convert.interpolate_pos_embed_sd(sd, model)
        return convert.overlay_state_dict(model, sd)


class MIRAGELargeSegFM(SegFoundModel):
    model = "miragelight_large"


class MIRAGEBaseSegFM(SegFoundModel):
    model = "miragelight_base"


seg_fm_factory = {"mirage-large": MIRAGELargeSegFM,
                  "mirage-base": MIRAGEBaseSegFM}


class ClsFoundModel:
    """A MIRAGECls head and its transforms (fm_cls_config.py:27-164)."""

    norm = "minmax"
    size_kw = "base"
    default_input_size = 512  # fm_cls_config.py:137-138

    def __init__(self, linear_probing: bool = True):
        self.linear_probing = linear_probing
        self.lr = 1e-3 if linear_probing else 1e-5
        self.weight_decay = 1e-2

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


cls_fm_factory = {"mirage-large": MIRAGELargeClsFM,
                  "mirage-base": MIRAGEBaseClsFM}
