"""Foundation-model registry for segmentation tuning.

Counterpart of the segmentation half of ``mirage_tpu/api/fm_configs.py``
(reference fm_seg_config.py): the model to build is picked by a substring
of the weights file's name; the picked config gives the per-domain input
adapter settings (one channel under min-max normalisation, three
otherwise) and loads a pretraining checkpoint into the tuning model
(surgery, position-embedding resize, strict=False overlay).
"""

from typing import Dict

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
