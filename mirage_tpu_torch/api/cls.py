"""Classification heads over the MIRAGE encoder.

Counterpart of ``mirage_tpu/api/cls.py`` (reference mirage_wrapper.py:
185-244): three poolers registered in ``miragecls_factory``,

  'global'     the mean of the patch tokens
  'cls'        the mean of the global tokens
  'token_mix'  both, concatenated, under a head twice as wide

each over the encoder of a pretrained MIRAGE with its output adapters
stripped (the port's wrapper with ``output_adapters=False``), then
LayerNorm(D, eps 1e-6) and a linear head, on one in-domain image through
the unmasked light forward. ``MIRAGECls`` is an ``nn.Module`` whose state
dict has the reference cls checkpoint's ``model.*`` / ``norm.*`` /
``head.*`` keys (mutils/misc.py:28-38). The parameters stay in float32
while the activations run in ``compute_dtype``.
"""

from typing import Optional

import torch
from torch import nn

from mirage_tpu_torch.api import convert
from mirage_tpu_torch.api.wrapper import MIRAGEWrapper
from mirage_tpu_torch.nn.layers import LayerNorm, Linear, layer_norm, linear


class MIRAGECls(nn.Module):
    """Encoder + norm + pooled linear head."""

    pooling = "global"
    head_factor = 1

    def __init__(self, num_classes: int, input_size=512, patch_size=32,
                 modalities: str = "bscan", weights: Optional[str] = None,
                 compute_dtype=torch.float32,
                 head_generator: Optional[torch.Generator] = None,
                 model_override: Optional[str] = None, device="cuda"):
        super().__init__()
        if num_classes <= 0:
            raise ValueError(f"num_classes must be positive, got {num_classes}")
        if "-" in modalities:
            raise ValueError("cls heads take a single in-domain")
        self.num_classes = num_classes
        self.in_domain = modalities
        wrapper = MIRAGEWrapper(
            input_size=input_size, patch_size=patch_size,
            modalities=modalities, weights=weights,
            compute_dtype=compute_dtype, output_adapters=False,
            model_override=model_override, device=device,
            param_dtype=torch.float32)
        self.device = wrapper.device
        self.model = wrapper.model
        self.embed_dim = self.model.dim_tokens
        self.num_global_tokens = self.model.num_global_tokens
        self.norm = LayerNorm(self.embed_dim)
        self.norm.init_params(None)
        # torch nn.Linear's default init (reference build_head,
        # mirage_wrapper.py:205-206): U(±1/√fan_in), weight then bias
        fan_in = self.embed_dim * self.head_factor
        bound = fan_in ** -0.5
        gen = head_generator or torch.Generator().manual_seed(0)
        self.head = Linear(fan_in, num_classes)
        with torch.no_grad():
            self.head.weight.uniform_(-bound, bound, generator=gen)
            self.head.bias.uniform_(-bound, bound, generator=gen)
        self.norm.to(self.device)
        self.head.to(self.device)

    def pool(self, tokens):
        g = self.num_global_tokens
        if self.pooling == "global":
            return tokens[:, :-g].mean(dim=1)
        if self.pooling == "cls":
            return tokens[:, -g:].mean(dim=1)
        return torch.cat([tokens[:, :-g].mean(dim=1),
                          tokens[:, -g:].mean(dim=1)], dim=1)

    def forward(self, x, *, deterministic: bool = True,
                generator: Optional[torch.Generator] = None,
                frozen_encoder: bool = False):
        """x: (B, C, H, W) in [0, 1] -> (B, num_classes) float logits.
        ``frozen_encoder`` (linear probing): the encoder runs grad-free and
        its output is detached."""
        tokens = self.model.forward_light(
            {self.in_domain: x}, deterministic=deterministic,
            generator=generator, frozen_encoder=frozen_encoder)
        tokens = layer_norm(tokens, self.norm.weight, self.norm.bias)
        return linear(self.pool(tokens).float(), self.head.weight,
                      self.head.bias)

    def load_cls_checkpoint(self, path: str):
        """Loads a reference cls checkpoint (keys model.*, norm.*, head.*;
        mutils/misc.py:28-38)."""
        self.load_state_dict(convert.load_torch_checkpoint(path)["model"],
                             strict=True)
        return self


class MIRAGEClsGlobal(MIRAGECls):
    pooling = "global"
    head_factor = 1


class MIRAGEClsCLS(MIRAGECls):
    pooling = "cls"
    head_factor = 1


class MIRAGEClsTokenMix(MIRAGECls):
    pooling = "token_mix"
    head_factor = 2


miragecls_factory = {"global": MIRAGEClsGlobal, "cls": MIRAGEClsCLS,
                     "token_mix": MIRAGEClsTokenMix}
