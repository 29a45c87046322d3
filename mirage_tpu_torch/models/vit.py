"""Plain ViT classifiers: the non-MIRAGE baselines of the cls benchmark.

Counterpart of ``mirage_tpu/models/vit.py`` (reference mutils/vit.py): a
timm-style ViT (the cls token first, a learned position embedding, patch
16) with three pools: 'global' (the mean of the patch tokens), 'cls'
(token 0) and 'token_mix' (both, concatenated under a head twice as wide).

The submodules carry timm's names (``cls_token``, ``pos_embed``,
``patch_embed.proj.{weight,bias}`` with the (D, C, 16, 16) conv weight,
``blocks.{i}.*``, ``norm.*``, ``head.*``), so a timm checkpoint loads with
``load_state_dict`` (the JAX package's ``params_from_torch``). The blocks
are the port's ``Encoder``, so they take MIRAGE's routes and kernels
(``nn/block.py``); the patch embedding is one matmul
(``ops/patch_embed.py``), and the final LayerNorm, the pool and the head
are plain PyTorch, as the JAX package computes them outside Pallas. The
parameters stay float32 while the activations run in ``compute_dtype``.
"""

from typing import Optional

import torch
from torch import nn

from mirage_tpu_torch.models.encoder import Encoder
from mirage_tpu_torch.nn import init as vinit
from mirage_tpu_torch.nn.layers import LayerNorm, Linear, PatchProj, \
    layer_norm, linear
from mirage_tpu_torch.ops.patch_embed import patch_embed
from mirage_tpu_torch.ops.runtime import resolve_device

POOLS = ("global", "cls", "token_mix")


class PatchEmbed(nn.Module):
    """Holds ``proj`` (timm's ``patch_embed.proj``)."""

    def __init__(self, in_chans, dim, patch):
        super().__init__()
        self.proj = PatchProj(in_chans, dim, patch, patch)


class VisionTransformer(nn.Module):
    """x (B, C, H, W) -> (B, num_classes) float32 logits."""

    def __init__(self, num_classes: int, img_size: int = 224,
                 patch_size: int = 16, in_chans: int = 3,
                 embed_dim: int = 768, depth: int = 12, num_heads: int = 12,
                 mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 pool: str = "cls", drop_rate: float = 0.0,
                 attn_drop_rate: float = 0.0, drop_path_rate: float = 0.0,
                 compute_dtype=torch.float32, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if pool not in POOLS:
            raise ValueError(f"pool must be one of {POOLS}, got {pool!r}")
        if drop_rate or attn_drop_rate:
            raise ValueError("the port's blocks take no dropout (every "
                             "configuration sets drop_rate and "
                             "attn_drop_rate to 0)")
        self.num_classes = num_classes
        self.img_size = img_size
        self.patch_size = patch_size
        self.in_chans = in_chans
        self.embed_dim = embed_dim
        self.depth = depth
        self.num_heads = num_heads
        self.mlp_ratio = mlp_ratio
        self.qkv_bias = qkv_bias
        self.pool = pool
        self.drop_rate = drop_rate
        self.attn_drop_rate = attn_drop_rate
        self.drop_path_rate = drop_path_rate
        self.compute_dtype = compute_dtype
        self.device = resolve_device(device)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(
            torch.empty(1, self.num_patches + 1, embed_dim))
        self.patch_embed = PatchEmbed(in_chans, embed_dim, patch_size)
        self.blocks = Encoder(depth, embed_dim, num_heads, mlp_ratio,
                              qkv_bias)
        self.norm = LayerNorm(embed_dim)
        self.head = Linear(embed_dim * (2 if pool == "token_mix" else 1),
                           num_classes)
        gen = generator or torch.Generator().manual_seed(0)
        vinit.init_weights(self, gen)
        vinit.trunc_normal_(self.pos_embed, gen)
        # torch nn.Linear's default init of the head: U(±1/√fan_in)
        bound = self.head.weight.shape[1] ** -0.5
        with torch.no_grad():
            self.head.weight.uniform_(-bound, bound, generator=gen)
            self.head.bias.uniform_(-bound, bound, generator=gen)
        self.to(self.device)

    @property
    def grid(self):
        return self.img_size // self.patch_size

    @property
    def num_patches(self):
        return self.grid * self.grid

    def pool_tokens(self, tokens):
        if self.pool == "global":
            return tokens[:, 1:].mean(dim=1)
        if self.pool == "cls":
            return tokens[:, 0]
        return torch.cat([tokens[:, 0], tokens[:, 1:].mean(dim=1)], dim=1)

    def trunk(self, x, deterministic, generator, grad_free):
        """Patch embedding, cls token, position embedding, the blocks."""
        p = self.patch_size
        proj = self.patch_embed.proj
        tokens = patch_embed(x, proj.weight, proj.bias, p, p,
                             compute_dtype=self.compute_dtype)
        cls = self.cls_token.to(tokens.dtype).expand(tokens.shape[0], 1, -1)
        tokens = torch.cat([cls, tokens], dim=1)
        tokens = tokens + self.pos_embed.to(tokens.dtype)
        return self.blocks(tokens, deterministic, self.drop_path_rate,
                           generator, grad_free=grad_free)

    def forward(self, x, *, deterministic: bool = True,
                generator: Optional[torch.Generator] = None,
                frozen_encoder: bool = False):
        """x: (B, C, H, W) -> (B, num_classes) float32 logits.
        ``frozen_encoder`` (linear probing): the blocks run grad-free and
        their output is detached, as ``api/cls.py:MIRAGECls`` does."""
        tokens = self.trunk(x, deterministic, generator, frozen_encoder)
        if frozen_encoder:
            tokens = tokens.detach()
        tokens = layer_norm(tokens, self.norm.weight, self.norm.bias)
        return linear(self.pool_tokens(tokens).float(), self.head.weight,
                      self.head.bias)


def vit_base_patch16(num_classes, **kwargs):
    return VisionTransformer(num_classes=num_classes, patch_size=16,
                             embed_dim=768, depth=12, num_heads=12, **kwargs)


def vit_large_patch16(num_classes, **kwargs):
    return VisionTransformer(num_classes=num_classes, patch_size=16,
                             embed_dim=1024, depth=24, num_heads=16, **kwargs)


vit_factory = {"vit_base_patch16": vit_base_patch16,
               "vit_large_patch16": vit_large_patch16}
