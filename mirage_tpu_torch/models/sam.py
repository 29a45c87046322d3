"""The Segment Anything ViT image encoder as a frozen foundation model for
segmentation tuning.

SAM (github.com/facebookresearch/segment-anything,
``modeling/image_encoder.py`` as ``build_sam.py`` configures it; Kirillov
et al., arXiv:2304.02643): a
16-pixel patch embedding plus a learned absolute position embedding on the
token grid (64 × 64 at 1024²), pre-LN blocks whose attention runs over
windows of 14 × 14 positions (the grid padded at the bottom and right) or,
at the global indexes, over the whole grid, each adding the decomposed
relative-position bias to its logits (``ops/relpos_attention.py``), an
exact-GELU MLP, and a neck (a 1 × 1 convolution, LayerNorm2d, a 3 × 3
convolution, LayerNorm2d, no convolution bias) to the image embedding.

:class:`SAMSegModel` is the segmentation CLI's model interface
(``cli/run_seg_tuning.py:build_model`` finds its presets in
:data:`sam_factory` beside ``models/mirage.py:model_factory``):
``forward_light`` runs the encoder and the neck and hands the embedding
to the head as tokens (B, H·W, out) of one task, as
``MIRAGEModel.forward_light`` hands its encoder's tokens; ``depth`` is the
block count, which the optimizer's layer decay reads. Its
parameters are named so that the optimizer's rules apply as to MIRAGE
(``train/optim.py``): the patch embedding and the position embedding are
the input adapter (``input_adapters.{task}.proj``, ``.pos_emb``, fixed
unless ``--learnable_pos_emb``), the blocks the ``encoder`` and the neck
``neck``, both frozen with the encoder; ``api/convert.py:
sam_checkpoint_to_port`` maps SAM's checkpoint keys onto them.

On the card a block is the LN kernel, the qkv GEMM, the relative-position
attention, the proj GEMM with the residual in its epilogue and the MLP
half (B2); the neck's 1 × 1 convolution is a GEMM and its LayerNorm2d the
LN kernel over the channels, channels-last; the 3 × 3 convolution is
cuDNN's. A frozen encoder (``frozen_encoder``) runs grad-free; a trained
one runs the same attention kernel forward, and its backward differentiates
the attention's plain version recomputed. A forward is the span
``mirage.forward`` over ``mirage.encoder`` (each block ``mirage.win_block``
or ``mirage.global_block``) and ``mirage.decoders`` (the head).

SAM's encoder has no stochastic depth: a non-zero rate is refused, as are
``return_all_layers`` (the DPT head's) and activation checkpointing.
"""

from typing import Mapping, Optional

import torch
from torch import nn

from mirage_tpu_torch.nn import init as vinit
from mirage_tpu_torch.nn.conv import Conv2d, LayerNorm2d, conv2d_nhwc
from mirage_tpu_torch.nn.layers import LayerNorm, Linear, Mlp, PatchProj
from mirage_tpu_torch.ops import linear as dense
from mirage_tpu_torch.ops import runtime
from mirage_tpu_torch.ops.block_attention import _needs_grad
from mirage_tpu_torch.ops.fused_mlp import mlp_block
from mirage_tpu_torch.ops.patch_embed import patch_embed
from mirage_tpu_torch.ops.relpos_attention import relpos_attention
from mirage_tpu_torch.utils.profiling import annotate


class SAMPatchEmbed(nn.Module):
    """The patch projection (``proj``, SAM's ``patch_embed.proj``) and the
    learned position embedding (``pos_emb`` (1, H, W, D), SAM's
    ``pos_embed``), zero at initialisation as in SAM."""

    def __init__(self, channels, dim, patch, grid_hw):
        super().__init__()
        self.patch = patch
        self.proj = PatchProj(channels, dim, patch, patch)
        self.pos_emb = nn.Parameter(torch.empty(1, *grid_hw, dim))

    def init_params(self, generator):
        nn.init.zeros_(self.pos_emb)

    def forward(self, x, compute_dtype=None):
        """x (B, C, S, S) -> (B, H·W, D) tokens, the position added."""
        pos = self.pos_emb.reshape(1, -1, self.pos_emb.shape[-1])
        return patch_embed(x, self.proj.weight, self.proj.bias, self.patch,
                           self.patch, pos_emb_tokens=pos,
                           compute_dtype=compute_dtype)


class SAMAttention(nn.Module):
    """qkv (with bias), proj, and the relative-position tables (2·k − 1, dh)
    of the window (or of the grid in a global block), zero at
    initialisation as in SAM."""

    def __init__(self, dim, num_heads, size_hw):
        super().__init__()
        dh = dim // num_heads
        self.qkv = Linear(dim, 3 * dim, n_fused=3)
        self.proj = Linear(dim, dim)
        self.rel_pos_h = nn.Parameter(torch.empty(2 * size_hw[0] - 1, dh))
        self.rel_pos_w = nn.Parameter(torch.empty(2 * size_hw[1] - 1, dh))

    def init_params(self, generator):
        nn.init.zeros_(self.rel_pos_h)
        nn.init.zeros_(self.rel_pos_w)


def _proj_residual(o, w, b, x):
    """x + o·wᵀ + b: on the card without a gradient one GEMM with the
    residual in its epilogue."""
    if runtime.use_kernel(o) and not _needs_grad(o, w, b, x):
        d = x.shape[-1]
        return runtime.gemm(o.reshape(-1, o.shape[-1]), w.to(o.dtype),
                            b, residual=x.reshape(-1, d)).view(x.shape)
    return x + dense.linear(o, w, b)


class SAMBlock(nn.Module):
    """A pre-LN block over the (B, H·W, D) tokens of an H × W grid; its
    attention runs over windows of ``window`` (0: the whole grid)."""

    def __init__(self, dim, num_heads, window, grid_hw, mlp_ratio=4.0):
        super().__init__()
        self.num_heads = num_heads
        self.window = window
        self.grid_hw = tuple(grid_hw)
        self.norm1 = LayerNorm(dim)
        self.attn = SAMAttention(dim, num_heads,
                                 (window, window) if window else grid_hw)
        self.norm2 = LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x):
        a, m = self.attn, self.mlp
        with annotate("mirage.win_block" if self.window
                      else "mirage.global_block"):
            h = dense.layer_norm(x, self.norm1.weight, self.norm1.bias)
            qkv = dense.linear(h, a.qkv.weight, a.qkv.bias)
            o = relpos_attention(
                qkv.view(x.shape[0], *self.grid_hw, qkv.shape[-1]),
                a.qkv.bias, a.rel_pos_h, a.rel_pos_w, self.num_heads,
                self.window)
            x = _proj_residual(o.reshape(x.shape), a.proj.weight,
                               a.proj.bias, x)
            return mlp_block(x, self.norm2.weight, self.norm2.bias,
                             m.fc1.weight, m.fc1.bias, m.fc2.weight,
                             m.fc2.bias)


class SAMNeck(nn.ModuleList):
    """SAM's neck, keyed as its ``neck.{0,1,2,3}``: (B, H, W, D) ->
    (B, H, W, out) channels-last."""

    def __init__(self, dim, out):
        super().__init__([Conv2d(dim, out, 1, bias=False), LayerNorm2d(out),
                          Conv2d(out, out, 3, bias=False), LayerNorm2d(out)])

    def forward(self, x):
        c1, n1, c3, n3 = self
        x = dense.linear(x, c1.weight.reshape(c1.weight.shape[0], -1))
        x = n1(x)
        return n3(conv2d_nhwc(x, c3.weight, padding=1))


class SAMSegModel(nn.Module):
    """The SAM image encoder with output heads over its embedding: the
    segmentation CLI's model (module docstring)."""

    def __init__(self, input_adapters: Mapping[str, nn.Module],
                 output_adapters: Optional[Mapping[str, nn.Module]] = None,
                 *, embed_dim=1280, depth=32, num_heads=16,
                 global_attn_indexes=(7, 15, 23, 31), window_size=14,
                 out_chans=256, mlp_ratio=4.0, compute_dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if len(input_adapters) != 1:
            raise ValueError("the SAM encoder takes one image domain, got "
                             f"{list(input_adapters)}")
        (task, adapter), = input_adapters.items()
        ph, pw = adapter.patch_hw
        if ph != pw:
            raise ValueError(f"SAM's patches are square, got {ph}x{pw}")
        grid_hw = adapter.posemb_grid
        self.task = task
        self.grid_hw = grid_hw
        self.image_size = adapter.image_size
        self.depth = depth
        self.out_chans = out_chans
        self.compute_dtype = compute_dtype
        self.input_adapters = nn.ModuleDict({task: SAMPatchEmbed(
            adapter.num_channels, embed_dim, ph, grid_hw)})
        self.encoder = nn.ModuleList([
            SAMBlock(embed_dim, num_heads,
                     0 if i in global_attn_indexes else window_size, grid_hw,
                     mlp_ratio) for i in range(depth)])
        self.neck = SAMNeck(embed_dim, out_chans)
        self.output_adapters = None
        if output_adapters is not None:
            self.output_adapters = nn.ModuleDict(
                {t: a.init(out_chans) for t, a in output_adapters.items()})
        if generator is not None:
            vinit.init_weights(self, generator)

    def input_info(self, x):
        h, w = x.shape[-2:]
        n = self.grid_hw[0] * self.grid_hw[1]
        return {"tasks": {self.task: {
            "num_tokens": n, "has_posemb": True, "start_idx": 0,
            "end_idx": n, "image_size": (h, w), "grid_size": self.grid_hw}},
            "num_task_tokens": n, "num_global_tokens": 0}

    def embed(self, images):
        """The image embedding (B, H·W, out) of images (B, C, S, S)."""
        if tuple(images.shape[-2:]) != tuple(self.image_size):
            raise ValueError(f"SAM's position embedding is for "
                             f"{self.image_size}, got "
                             f"{tuple(images.shape[-2:])}")
        x = self.input_adapters[self.task](images,
                                           compute_dtype=self.compute_dtype)
        for block in self.encoder:
            x = block(x)
        b = x.shape[0]
        x = self.neck(x.view(b, *self.grid_hw, -1))
        return x.reshape(b, -1, self.out_chans)

    def forward_light(self, x: Mapping[str, torch.Tensor], *,
                      return_all_layers: bool = False,
                      deterministic: bool = True,
                      generator: Optional[torch.Generator] = None,
                      frozen_encoder: bool = False):
        """The image of ``x[task]`` through the encoder and the neck, then
        task -> prediction of each head (or the embedding's tokens without
        heads). ``frozen_encoder``: the encoder (and its input adapter)
        carries no trainable parameter, so it runs grad-free and its
        output is detached. SAM has no stochastic depth, so
        ``deterministic`` and ``generator`` reach the heads alone."""
        if return_all_layers:
            raise ValueError("the SAM encoder hands its heads the neck's "
                             "embedding only (no return_all_layers)")
        images = x[self.task]
        with annotate("mirage.forward"):
            with annotate("mirage.encoder"):
                if frozen_encoder:
                    with torch.no_grad():
                        enc = self.embed(images).detach()
                else:
                    enc = self.embed(images)
            if self.output_adapters is None:
                return enc
            info = self.input_info(images)
            with annotate("mirage.decoders"):
                return {task: adapter(enc, info, deterministic=deterministic,
                                      generator=generator)
                        for task, adapter in self.output_adapters.items()}


# ---------------------------------------------------------------- registry

SIZES = {"vit_h": dict(embed_dim=1280, depth=32, num_heads=16,
                       global_attn_indexes=(7, 15, 23, 31), window_size=14,
                       out_chans=256),
         # dev/smoke-test size, not a published one: a 10 × 10 grid at
         # 160² in windows of 4 (9 windows, 5 of them padded)
         "tiny": dict(embed_dim=64, depth=4, num_heads=2,
                      global_attn_indexes=(1, 3), window_size=4,
                      out_chans=32)}


def _preset(dims):
    def build(input_adapters, output_adapters, *, num_global_tokens=0,
              drop_path_rate=0.0, compute_dtype=torch.float32, remat=False,
              generator=None):
        """The segmentation CLI's model arguments; SAM has no global
        token (``num_global_tokens`` is not read), no stochastic depth
        and no checkpointed blocks."""
        if drop_path_rate:
            raise ValueError("SAM's image encoder has no stochastic depth: "
                             "run it with --drop_path_encoder 0")
        if remat:
            raise ValueError("the SAM encoder takes no --remat")
        return SAMSegModel(input_adapters, output_adapters,
                           compute_dtype=compute_dtype, generator=generator,
                           **dims)
    return build


sam_factory = {f"sam_{size}": _preset(dims) for size, dims in SIZES.items()}
