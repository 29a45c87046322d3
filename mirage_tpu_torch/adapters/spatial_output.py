"""SpatialOutputAdapter: the MultiMAE cross-attention reconstruction decoder.

Counterpart of ``mirage_tpu/adapters/spatial_output.py``: project the
encoder tokens to the decoder width, put mask tokens where tokens were not
encoded (whole absent modalities on the wrapper's static path; the masked
positions of ``ids_keep`` in pretraining), add task and positional
embeddings, take the task's tokens as queries and the visible tokens as
context, then the cross-attention and its MLP, ``depth`` transformer blocks,
and a linear to pixels (or, ``pixel_output=False``, to the patch tokens the
token-space losses take).

Inference (``deterministic``) with at most 512 queries and 512 context
tokens runs the cross-attention as B3 (``xattn_half_block``) and its MLP as
B2; training, and longer inputs (a request with two or more 512²
modalities has 769 context tokens), run the cross-attention through
``cross_attention_apply`` (``flash_attention``, B8, at 512 context tokens or
more) and the MLP on the plain path, as the JAX package does
(spatial_output.py:209-232).
The cross-attention adds no skip from the queries: the reference decoder
computes x = xattn(LN_q(q), LN_c(ctx)); x = x + mlp(LN(x)). (The JAX
package's fused TPU route at spatial_output.py:209-225 calls its
xattn_half_block, which adds x; the port calls B3 with residual=False.)

The forward is ``_prepare`` (everything before the transformer tail),
``_tail`` (the cross-attention, its MLP and the blocks) and ``_finish`` (the
output projection and unpatchify), as in the JAX package, so that
identically configured decoders can run their tails as one:
:func:`batched_spatial_decode` (``MIRAGE_DEC_BATCH=on``,
``models/mirage.py``) stacks the tasks' queries and contexts task-major
into one T·B batch and their tail weights on a leading task axis, and runs
one tail over the task stack (``ops/tasks.py``): each kernel of the tail
launches once for the T decoders instead of T times.
"""

import torch
from torch import nn
from torch.func import functional_call

from mirage_tpu_torch.adapters.input_adapters import pair
from mirage_tpu_torch.masking.masking import gather_rows, scatter_rows
from mirage_tpu_torch.nn import init as vinit
from mirage_tpu_torch.nn.attention import CrossAttention, cross_attention_apply
from mirage_tpu_torch.nn.block import FUSED_TOKENS, Block
from mirage_tpu_torch.nn.layers import LayerNorm, Linear, Mlp, layer_norm
from mirage_tpu_torch.nn.posemb import build_2d_sincos_posemb
from mirage_tpu_torch.nn.resize import resize2d
from mirage_tpu_torch.ops.block_attention import xattn_half_block
from mirage_tpu_torch.ops.fused_mlp import mlp_block, mlp_block_ref
from mirage_tpu_torch.ops.patch_embed import unpatchify


class SpatialOutputAdapter(nn.Module):
    def __init__(self, num_channels, stride_level=1, patch_size_full=16,
                 dim_tokens=256, depth=0, image_size=224, mlp_ratio=4,
                 num_heads=8, qkv_bias=True, use_task_queries=True,
                 task=None, context_tasks=None, use_xattn=True):
        super().__init__()
        self.num_channels = num_channels
        self.stride_level = stride_level
        self.patch_size_full = pair(patch_size_full)
        self.dim_tokens = dim_tokens
        self.depth = depth
        self.image_size = pair(image_size)
        self.mlp_ratio = mlp_ratio
        self.num_heads = num_heads
        self.qkv_bias = qkv_bias
        self.use_task_queries = use_task_queries
        self.task = task
        self.context_tasks = tuple(context_tasks) if context_tasks else None
        self.use_xattn = use_xattn

    @property
    def patch_hw(self):
        ph, pw = self.patch_size_full
        return max(1, ph // self.stride_level), max(1, pw // self.stride_level)

    @property
    def posemb_grid(self):
        (h, w), (ph, pw) = self.image_size, self.patch_hw
        return h // (self.stride_level * ph), w // (self.stride_level * pw)

    def init(self, dim_tokens_enc):
        d = self.dim_tokens
        if self.context_tasks is not None:
            self.task_embeddings = nn.ParameterDict(
                {t: nn.Parameter(torch.empty(1, 1, d))
                 for t in self.context_tasks})
        self.mask_token = nn.Parameter(torch.empty(1, 1, d))
        self.pos_emb = nn.Parameter(
            build_2d_sincos_posemb(*self.posemb_grid, d), requires_grad=False)
        if self.use_xattn:
            self.decoder = CrossAttention(d, qkv_bias=self.qkv_bias)
            self.context_norm = LayerNorm(d)
            self.query_norm = LayerNorm(d)
            self.out_norm = LayerNorm(d)
            self.mlp = Mlp(d, d * self.mlp_ratio)
        if self.depth > 0:
            self.decoder_transformer = nn.ModuleList(
                [Block(d, self.num_heads, self.mlp_ratio, self.qkv_bias)
                 for _ in range(self.depth)])
        ph, pw = self.patch_hw
        self.out_proj = Linear(d, self.num_channels * ph * pw)
        self.proj_context = Linear(dim_tokens_enc, d)
        return self

    def init_params(self, generator):
        nn.init.zeros_(self.mask_token)
        for p in getattr(self, "task_embeddings", {}).values():
            vinit.trunc_normal_(p, generator)

    def _pos_tokens(self, nh, nw):
        pos = resize2d(self.pos_emb, (nh, nw), mode="bilinear")
        return pos.reshape(1, pos.shape[1], nh * nw).transpose(1, 2)

    def _embeddings(self, input_info, nh, nw, dtype):
        """Task embedding + posemb of every token of the full sequence,
        (1, N, d) (the JAX package's _context_embeddings)."""
        task_embs = getattr(self, "task_embeddings", {})
        pos = self._pos_tokens(nh, nw).to(dtype)
        chunks = []
        for task, info in input_info["tasks"].items():
            n = info["num_tokens"]
            emb = (task_embs[task].to(dtype).expand(1, n, self.dim_tokens)
                   if task in task_embs
                   else pos.new_zeros(1, n, self.dim_tokens))
            if info["has_posemb"]:
                if n != pos.shape[1]:
                    raise ValueError(f"# tokens ({n}) != # pos embeddings "
                                     f"({pos.shape[1]})")
                emb = emb + pos
            chunks.append(emb)
        return torch.cat(chunks, dim=1)

    def _prepare(self, encoder_tokens, input_info, absent_tasks=(),
                 ids_keep=None):
        """Queries and visible context for the decoder: (B, nq, d),
        (B, nc, d), and the output grid (nh, nw). ids_keep (B, M): the
        original positions of the M encoded tokens (masked pretraining);
        None on the static path, where absent_tasks are the masked ones."""
        b = encoder_tokens.shape[0]
        h, w = input_info["tasks"][self.task]["image_size"]
        ph, pw = self.patch_hw
        nh, nw = h // (self.stride_level * ph), w // (self.stride_level * pw)
        context = self.proj_context(encoder_tokens)
        dtype, d = context.dtype, self.dim_tokens
        num_global = input_info.get("num_global_tokens", 0)
        body = context[:, :-num_global] if num_global else context

        if ids_keep is None:
            chunks, off = [], 0
            for task, info in input_info["tasks"].items():
                n = info["num_tokens"]
                if task in absent_tasks:
                    chunks.append(self.mask_token.to(dtype).expand(b, n, d))
                else:
                    chunks.append(body[:, off:off + n])
                    off += n
            full = torch.cat(chunks, dim=1)
        else:
            # mask tokens everywhere, the encoded tokens back at their
            # positions (the reference's concat + ids_restore unshuffle)
            full = scatter_rows(body, ids_keep, input_info["num_task_tokens"],
                                self.mask_token.reshape(d))
        full = full + self._embeddings(input_info, nh, nw, dtype)

        if self.use_task_queries and self.task in input_info["tasks"]:
            info = input_info["tasks"][self.task]
            queries = full[:, info["start_idx"]:info["end_idx"]]
        else:
            queries = (self.mask_token.to(dtype)
                       + self._pos_tokens(nh, nw).to(dtype)).expand(
                           b, nh * nw, d)
            task_embs = getattr(self, "task_embeddings", {})
            if self.task in task_embs:
                queries = queries + task_embs[self.task].to(dtype)
        if ids_keep is None:
            visible = [full[:, i["start_idx"]:i["end_idx"]]
                       for t, i in input_info["tasks"].items()
                       if t not in absent_tasks]
        else:
            visible = [gather_rows(full, ids_keep)]
        if num_global:
            visible.append(context[:, -num_global:])
        return queries.contiguous(), torch.cat(visible, 1), (nh, nw)

    def forward(self, encoder_tokens, input_info, absent_tasks=(),
                ids_keep=None, deterministic=True, pixel_output=True):
        """encoder_tokens: (B, M + G, D_enc) -> (B, C, H, W), or the patch
        tokens (B, N, C·ph·pw) in (c, ph, pw) order when pixel_output is
        False."""
        x, ctx, (nh, nw) = self._prepare(encoder_tokens, input_info,
                                         absent_tasks, ids_keep)
        return self._finish(self._tail(x, ctx, deterministic), nh, nw,
                            pixel_output)

    def _tail(self, x, ctx, deterministic=True):
        """The cross-attention and its MLP, then the transformer blocks,
        over the prepared queries x (B, nq, d) and context (B, nc, d); its
        weights may be a task stack (:func:`batched_spatial_decode`)."""
        if self.use_xattn:
            dec, qn, cn, on, m = (self.decoder, self.query_norm,
                                  self.context_norm, self.out_norm, self.mlp)
            mlp_args = (on.weight, on.bias, m.fc1.weight, m.fc1.bias,
                        m.fc2.weight, m.fc2.bias)
            if (deterministic and x.shape[1] <= FUSED_TOKENS
                    and ctx.shape[1] <= FUSED_TOKENS):
                x = xattn_half_block(
                    x, ctx, qn.weight, qn.bias, cn.weight, cn.bias,
                    dec.q.weight, dec.q.bias, dec.kv.weight, dec.kv.bias,
                    dec.proj.weight, dec.proj.bias, self.num_heads,
                    residual=False)
                x = mlp_block(x, *mlp_args)
            else:
                x = cross_attention_apply(
                    dec, layer_norm(x, qn.weight, qn.bias),
                    layer_norm(ctx, cn.weight, cn.bias), self.num_heads)
                x = mlp_block_ref(x, *mlp_args)
        for block in getattr(self, "decoder_transformer", ()):
            x = block(x, deterministic)
        return x

    def _finish(self, x, nh, nw, pixel_output=True):
        """The output projection, then the pixels (B, C, H, W) unless
        pixel_output is False."""
        x = self.out_proj(x)
        if not pixel_output:
            return x
        ph, pw = self.patch_hw
        return unpatchify(x, nh, nw, ph, pw, self.num_channels)


# ------------------------------------------------------------- task batching

# Settings that must agree across adapters for their tails to stack: the
# same weight shapes and the same routes inside _tail and Block
# (mirage_tpu/adapters/spatial_output.py:_BATCH_KEYS)
_BATCH_KEYS = ("dim_tokens", "depth", "num_heads", "mlp_ratio", "qkv_bias",
               "use_task_queries", "use_xattn")
# the submodules that make up the tail
_TAIL_KEYS = ("decoder", "context_norm", "query_norm", "out_norm", "mlp",
              "decoder_transformer")


def decoders_batchable(adapters, input_info) -> bool:
    """True when the output adapters are two or more SpatialOutputAdapters
    with cross-attention and task queries, the same tail settings, tasks
    present in input_info with equal token counts and the same context
    tasks (mirage_tpu/adapters/spatial_output.py:decoders_batchable): the
    reference pretraining decoders (dim 256, depth 2, 8 heads, 256 tokens
    each)."""
    ads = list(adapters.values())
    if len(ads) < 2 or not all(isinstance(a, SpatialOutputAdapter)
                               for a in ads):
        return False
    a0 = ads[0]
    if not (a0.use_xattn and a0.use_task_queries):
        return False
    if not all(getattr(a, k) == getattr(a0, k) for a in ads
               for k in _BATCH_KEYS):
        return False
    if not all(a.task in input_info["tasks"] for a in ads):
        return False
    if len({input_info["tasks"][a.task]["num_tokens"] for a in ads}) != 1:
        return False
    return len({a.context_tasks for a in ads}) == 1


class _Tail(nn.Module):
    """An adapter's tail as a module's forward, for functional_call."""

    def __init__(self, adapter):
        super().__init__()
        self.adapter = adapter

    def forward(self, x, ctx, deterministic):
        return self.adapter._tail(x, ctx, deterministic)


def batched_spatial_decode(adapters, encoder_tokens, input_info,
                           absent_tasks=(), ids_keep=None, deterministic=True,
                           pixel_output=True):
    """Every adapter's prediction (task -> output, as each adapter's
    forward gives it) with the tails run as one: each task's ``_prepare``;
    the queries and contexts stacked task-major into (T·B, n, d) (task t's
    rows contiguous) and each tail weight stacked on a leading task axis
    (T, ...); one ``_tail`` of the first adapter over that task stack
    (``torch.func.functional_call`` with the stacked weights, as the JAX
    package vmaps ``_tail`` over its stacked parameters,
    mirage_tpu/adapters/spatial_output.py:314); then each task's
    ``_finish``. Gradients reach each adapter's own parameters through the
    stack. ``decoders_batchable`` must hold."""
    tasks = list(adapters.keys())
    ads = [adapters[t] for t in tasks]
    prepared = [a._prepare(encoder_tokens, input_info, absent_tasks, ids_keep)
                for a in ads]
    queries = torch.cat([p[0] for p in prepared])
    context = torch.cat([p[1] for p in prepared])
    named = [dict(a.named_parameters()) for a in ads]
    stack = {f"adapter.{name}": torch.stack([n[name] for n in named])
             for name in named[0] if name.split(".")[0] in _TAIL_KEYS}
    x = functional_call(_Tail(ads[0]), stack,
                        (queries, context, deterministic))
    return {t: a._finish(xt, *p[2], pixel_output)
            for t, a, xt, p in zip(tasks, ads, x.chunk(len(ads)), prepared)}
