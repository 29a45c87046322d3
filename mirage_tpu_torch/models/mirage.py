"""MIRAGE core model: the masked pretraining forward, the wrapper's static
forward and the light forward.

Counterpart of ``mirage_tpu/models/mirage.py``. ``forward`` runs the masked
MultiMAE forward (random Dirichlet masks from a ``torch.Generator``, or
explicit task masks through ``masks_to_indices``) and returns
``(preds, task_masks)``; called with ``absent_tasks`` it runs the wrapper's
static contract instead: each modality either present (all its tokens
visible) or absent (its embedding skipped, its decoder positions filled with
mask tokens), where the token shuffle is the identity and the forward is
concatenation and slicing; that call returns the predictions alone.
``forward_light`` is the unmasked forward of downstream tuning (every given
modality fully visible, stochastic depth from a generator, then the output
heads); ``features`` returns the encoder tokens alone. ``return_all_layers``
(mirage_tpu/models/mirage.py:199, :349) gives every block's output: the
masked forward returns them as spatial maps, the light forward hands the
list to its heads (the DPT head reads four of them).

Training keeps the parameters in float32 and runs the activations in
``compute_dtype``; each op casts its weights to the activation dtype.
``remat`` (mirage_tpu/models/mirage.py:60) checkpoints the encoder blocks
whose ops save their intermediates (``models/encoder.py``); ``tp`` runs
the encoder tensor-parallel (``parallel/tp.py``); ``pp`` ("pipe",
n_micro) runs it as a GPipe schedule over the stages of a 'pipe' mesh
axis (``parallel/pp.py``; a drop-path rate of 0, no ``return_all_layers``).

``MIRAGE_DEC_BATCH=on`` (``ops/runtime.py``'s switch, default off, read at
import as mirage_tpu/models/mirage.py:37 reads it) runs identically
configured decoders' tails as one task stack
(``adapters/spatial_output.py:batched_spatial_decode``) wherever
``decoders_batchable`` holds, in the masked forward and the static forward
alike (mirage_tpu/models/mirage.py:310-320); ``forward_light`` keeps its
heads one by one.

``forward`` and ``features`` are the span ``mirage.forward``, over
``mirage.encoder`` and ``mirage.decoders`` (``utils/profiling.py``).
"""

from typing import Dict, Mapping, Optional, Sequence, Union

import torch
from torch import nn

from mirage_tpu_torch.adapters.input_adapters import SemSegInputAdapter
from mirage_tpu_torch.adapters.spatial_output import (batched_spatial_decode,
                                                      decoders_batchable)
from mirage_tpu_torch.masking.masking import (gather_rows,
                                              generate_random_masks,
                                              masks_to_indices)
from mirage_tpu_torch.models.encoder import Encoder
from mirage_tpu_torch.nn import init as vinit
from mirage_tpu_torch.ops import runtime
from mirage_tpu_torch.utils.profiling import annotate


class MIRAGEModel(nn.Module):
    """Multimodal ViT: task-keyed input adapters, encoder, and optional
    task-keyed output adapters. ``generator`` (a ``torch.Generator``)
    initialises the weights; without it they are left uninitialised for a
    checkpoint to fill."""

    def __init__(self, input_adapters: Mapping[str, nn.Module],
                 output_adapters: Optional[Mapping[str, nn.Module]] = None,
                 num_global_tokens: int = 1, dim_tokens: int = 768,
                 depth: int = 12, num_heads: int = 12,
                 mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 drop_path_rate: float = 0.0, compute_dtype=torch.float32,
                 remat: bool = False,
                 generator: Optional[torch.Generator] = None, pp=None):
        super().__init__()
        self.num_global_tokens = num_global_tokens
        self.drop_path_rate = drop_path_rate
        self.dim_tokens = dim_tokens
        self.depth = depth
        self.num_heads = num_heads
        self.compute_dtype = compute_dtype
        self.input_adapters = nn.ModuleDict(
            {t: a.init(dim_tokens) for t, a in input_adapters.items()})
        self.output_adapters = None
        if output_adapters is not None:
            self.output_adapters = nn.ModuleDict(
                {t: a.init(dim_tokens) for t, a in output_adapters.items()})
        self.encoder = Encoder(depth, dim_tokens, num_heads, mlp_ratio,
                               qkv_bias, remat)
        self.global_tokens = nn.Parameter(
            torch.empty(1, num_global_tokens, dim_tokens))
        if generator is not None:
            vinit.init_weights(self, generator)
        self.pp = pp

    def init_params(self, generator):
        vinit.trunc_normal_(self.global_tokens, generator)

    @property
    def tp(self):
        """None, or the encoder's tensor parallelism (group, t)
        (``models/encoder.py``)."""
        return self.encoder.tp

    @tp.setter
    def tp(self, value):
        if value is not None and self.pp is not None:
            raise ValueError("pipeline x tensor parallelism is not "
                             "implemented: build the model with exactly one "
                             "of tp/pp set")
        self.encoder.tp = value

    @property
    def pp(self):
        """None, or the encoder's pipeline parallelism ("pipe", n_micro)
        (mirage_tpu/models/mirage.py:69-75)."""
        return self.encoder.pp

    @pp.setter
    def pp(self, value):
        if value is not None:
            if self.drop_path_rate != 0.0:
                raise ValueError("pipeline parallelism requires "
                                 "drop_path_rate == 0.0 (parallel/pp.py "
                                 "scope note)")
            if self.tp is not None:
                raise ValueError("pipeline x tensor parallelism is not "
                                 "implemented: build the model with exactly "
                                 "one of tp/pp set")
            axis, n_micro = value
            if int(n_micro) < 1:
                raise ValueError(f"pp n_micro {n_micro} < 1")
            value = (axis, int(n_micro))
        self.encoder.pp = value

    def generate_input_info(self, x: Mapping[str, torch.Tensor]) -> Dict:
        """Token bookkeeping per task, from the input shapes."""
        info: Dict = {"tasks": {}}
        i = 0
        for domain, tensor in x.items():
            if domain not in self.input_adapters:
                continue
            adapter = self.input_adapters[domain]
            h, w = tensor.shape[-2], tensor.shape[-1]
            n = adapter.num_tokens((h, w))
            ph, pw = adapter.patch_hw
            if isinstance(adapter, SemSegInputAdapter):
                image_size = (h * adapter.stride_level,
                              w * adapter.stride_level)
            else:
                image_size = (h, w)
            info["tasks"][domain] = {
                "num_tokens": n, "has_posemb": True, "start_idx": i,
                "end_idx": i + n, "image_size": image_size,
                "grid_size": (h // ph, w // pw)}
            i += n
        info["num_task_tokens"] = i
        info["num_global_tokens"] = self.num_global_tokens
        return info

    def _tokens(self, x, absent_tasks=()):
        """Present tasks' embeddings in task order, then the global tokens."""
        tokens = [self.input_adapters[t](v, compute_dtype=self.compute_dtype)
                  for t, v in x.items()
                  if t in self.input_adapters and t not in absent_tasks]
        if not tokens:
            raise ValueError("no present modality to encode")
        b = tokens[0].shape[0]
        glob = self.global_tokens.to(tokens[0].dtype).expand(
            b, self.num_global_tokens, self.dim_tokens)
        return torch.cat(tokens + [glob], dim=1)

    def forward(self, x: Mapping[str, torch.Tensor], absent_tasks=None, *,
                mask_inputs: bool = True,
                task_masks: Optional[Mapping[str, torch.Tensor]] = None,
                num_encoded_tokens: int = 128,
                num_visible: Optional[int] = None,
                alphas: Union[float, Sequence[float]] = 1.0,
                sample_tasks_uniformly: bool = False,
                generator: Optional[torch.Generator] = None,
                deterministic: bool = True, pixel_outputs: bool = True,
                return_all_layers: bool = False,
                n_micro: Optional[int] = None):
        """x: task -> (B, C, H, W) image or (B, H, W) labels.

        With ``absent_tasks`` (a sequence, possibly empty): the wrapper's
        static path. Every task of the model's adapters must be in x (absent
        ones may hold zeros: only their shapes are read); returns task ->
        reconstruction (B, C, H, W), or the encoder tokens (B, N + G, D) if
        the model has no output adapters.

        Otherwise the masked pretraining forward (mirage_tpu/models/
        mirage.py:186-327): ``task_masks`` (task -> (B, n) with 1 = masked)
        with ``num_visible`` visible tokens per sample, or masks drawn from
        ``generator`` with ``num_encoded_tokens`` visible (all tokens if not
        ``mask_inputs``). Returns (preds, task_masks); preds are pixels, or
        the decoders' patch tokens if not ``pixel_outputs``; with
        ``return_all_layers``, {"layer_{i}": block i's output without the
        global tokens as a (B, D, gh, gw) map of the first task's grid}.
        ``n_micro``: the masked forward's microbatches under ``pp`` (default:
        ``pp``'s)."""
        with annotate("mirage.forward"):
            if absent_tasks is not None:
                return self._forward_static(x, tuple(absent_tasks))
            return self._forward_masked(
                x, mask_inputs, task_masks, num_encoded_tokens, num_visible,
                alphas, sample_tasks_uniformly, generator, deterministic,
                pixel_outputs, return_all_layers, n_micro)

    def _forward_masked(self, x, mask_inputs, task_masks, num_encoded_tokens,
                        num_visible, alphas, sample_tasks_uniformly,
                        generator, deterministic, pixel_outputs,
                        return_all_layers, n_micro):
        """The masked pretraining forward of :meth:`forward`."""
        input_info = self.generate_input_info(x)
        task_order = [t for t in x if t in self.input_adapters]
        tokens = [self.input_adapters[t](x[t], compute_dtype=self.compute_dtype)
                  for t in task_order]
        b = tokens[0].shape[0]
        n_per_task = [t.shape[1] for t in tokens]
        num_encoded = num_encoded_tokens if mask_inputs else sum(n_per_task)
        if task_masks is None:
            if generator is None:
                generator = torch.Generator().manual_seed(0)
            masks, ids_keep, _ = generate_random_masks(
                generator, n_per_task, b, num_encoded, alphas,
                sample_tasks_uniformly)
            task_masks = dict(zip(task_order, masks))
        else:
            ids_keep, _ = masks_to_indices(
                task_masks, task_order,
                num_visible if num_visible is not None else num_encoded)
        dev = tokens[0].device
        ids_keep = ids_keep.to(dev)
        task_masks = {t: m.to(dev) for t, m in task_masks.items()}
        enc = gather_rows(torch.cat(tokens, dim=1), ids_keep)
        enc = torch.cat([enc, self.global_tokens.to(enc.dtype).expand(
            b, self.num_global_tokens, self.dim_tokens)], dim=1)
        if return_all_layers:
            with annotate("mirage.encoder"):
                _, outs = self.encoder(enc, deterministic,
                                       self.drop_path_rate, generator,
                                       return_layers=range(self.depth))
            gh, gw = input_info["tasks"][task_order[0]]["grid_size"]
            return {f"layer_{i}": t[:, :-self.num_global_tokens].reshape(
                b, gh, gw, -1).permute(0, 3, 1, 2) for i, t in outs.items()}
        with annotate("mirage.encoder"):
            enc = self.encoder(enc, deterministic, self.drop_path_rate,
                               generator, n_micro=n_micro)
        if self.output_adapters is None:
            return enc, task_masks
        with annotate("mirage.decoders"):
            if self._decoders_batched(input_info):
                return batched_spatial_decode(
                    self.output_adapters, enc, input_info,
                    ids_keep=ids_keep, deterministic=deterministic,
                    pixel_output=pixel_outputs), task_masks
            preds = {task: adapter(enc, input_info, ids_keep=ids_keep,
                                   deterministic=deterministic,
                                   pixel_output=pixel_outputs)
                     for task, adapter in self.output_adapters.items()}
        return preds, task_masks

    def _decoders_batched(self, input_info) -> bool:
        """MIRAGE_DEC_BATCH is on and the decoders' tails stack."""
        return (runtime.switches["MIRAGE_DEC_BATCH"] == "on"
                and decoders_batchable(self.output_adapters, input_info))

    def _forward_static(self, x, absent_tasks):
        input_info = self.generate_input_info(x)
        tokens = self._tokens(x, absent_tasks)
        with annotate("mirage.encoder"):
            encoded = self.encoder(tokens)
        if self.output_adapters is None:
            return encoded
        with annotate("mirage.decoders"):
            if self._decoders_batched(input_info):
                return batched_spatial_decode(self.output_adapters, encoded,
                                              input_info, absent_tasks)
            return {task: adapter(encoded, input_info, absent_tasks)
                    for task, adapter in self.output_adapters.items()}

    def process_input(self, x: Mapping[str, torch.Tensor]):
        """Unmasked tokens of every given modality plus the global tokens,
        and their bookkeeping (mirage_tpu/models/mirage.py:331)."""
        return self._tokens(x), self.generate_input_info(x)

    def features(self, x: Mapping[str, torch.Tensor]):
        """Encoder features of every given modality: (B, N + G, D)."""
        with annotate("mirage.forward"):
            tokens = self._tokens(x)
            with annotate("mirage.encoder"):
                return self.encoder(tokens)

    def forward_light(self, x: Mapping[str, torch.Tensor], *,
                      return_all_layers: bool = False,
                      deterministic: bool = True,
                      generator: Optional[torch.Generator] = None,
                      frozen_encoder: bool = False):
        """The plain multimodal ViT forward of downstream tuning
        (mirage_tpu/models/mirage.py:344-398): every given modality fully
        visible, the encoder with stochastic depth drawn from ``generator``
        when not ``deterministic``, then task -> prediction of each output
        head (or the encoder tokens without heads). ``return_all_layers``
        puts the list of every block's output (B, N + G, D) in place of
        the encoder tokens. ``frozen_encoder`` (the encoder and input
        adapters carry no trainable parameter) runs the blocks grad-free
        and detaches their output."""
        tokens, input_info = self.process_input(x)
        if return_all_layers:
            _, outs = self.encoder(tokens, deterministic, self.drop_path_rate,
                                   generator, grad_free=frozen_encoder,
                                   return_layers=range(self.depth))
            enc = [outs[i].detach() if frozen_encoder else outs[i]
                   for i in range(self.depth)]
        else:
            enc = self.encoder(tokens, deterministic, self.drop_path_rate,
                               generator, grad_free=frozen_encoder)
            if frozen_encoder:
                enc = enc.detach()
        if self.output_adapters is None:
            return enc
        return {task: adapter(enc, input_info, deterministic=deterministic,
                              generator=generator)
                for task, adapter in self.output_adapters.items()}


# ---------------------------------------------------------------- registry

SIZES = {"base": dict(dim_tokens=768, depth=12, num_heads=12),
         "large": dict(dim_tokens=1024, depth=24, num_heads=16),
         # dev/smoke-test size, not a reference size
         "tiny": dict(dim_tokens=192, depth=3, num_heads=4)}



def _preset(dims):
    def build(input_adapters, output_adapters, **kwargs):
        return MIRAGEModel(input_adapters, output_adapters,
                           **{"mlp_ratio": 4, "qkv_bias": True, **dims,
                              **kwargs})
    return build


model_factory = {f"{kind}_{size}": _preset(dims)
                 for kind in ("miragepre", "miragelight")
                 for size, dims in SIZES.items()}
