"""Public inference API: MIRAGEWrapper.

Counterpart of ``mirage_tpu/api/wrapper.py``: loads a reference ``.pth``
(or safetensors) checkpoint, rebuilds the model for the requested modalities
('bscan-slo-bscanlayermap') and runs the reference wrapper's contract:
missing modalities are zero-filled and fully masked, present ones fully
visible. Runs on ``device`` (default ``"cuda"``, which raises when no card
is present); pass ``device="cpu"`` for the plain PyTorch path.

Several devices (``mesh=``, mirage_tpu/api/wrapper.py:45-125, 195-263):
pure data parallelism, as the JAX package's ``dp_shard_map`` serving is.
One replica of the model a mesh position (``parallel/mesh.py:
make_serve_mesh``, the parameters replicated); a batch is padded with zeros
to a multiple of the mesh size and split in order, each shard runs on its
replica from one host thread a position, with that device current and on
the replica's own stream, and the outputs are joined in batch order on the
first device with the padding sliced off. Each replica's kernels see the
whole model at the shard's batch, as on one card.

A call is the span ``mirage.request``, over ``mirage.inputs`` (the inputs
to tensors, the absent modalities zero-filled) and the model's
``mirage.forward`` (``utils/profiling.py``); on a mesh, each replica's
``mirage.forward``, from its own thread.
"""

import copy
from concurrent.futures import ThreadPoolExecutor
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
from mirage_tpu_torch.utils import profiling
from mirage_tpu_torch.utils.profiling import annotate


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


def model_dims(model_name: str, args: Dict):
    """(width, depth, heads) of the encoder a model name (and, for the dev
    size, a checkpoint's args) describes."""
    if "large" in model_name:
        return 1024, 24, 16
    if "base" in model_name:
        return 768, 12, 12
    if "tiny" in model_name:  # dev size; checkpoint args may override it
        return (args.get("dim_tokens", 192), args.get("depth", 3),
                args.get("num_heads", 4))
    raise ValueError(f"Unknown model size: {model_name}")


def build_model(model_name: str, args: Dict, in_domains, input_size=512,
                patch_size=32, compute_dtype=torch.float32,
                with_outputs: bool = True,
                generator: Optional[torch.Generator] = None,
                geometry: Optional[Dict] = None, drop_path_rate: float = 0.0,
                remat: bool = False) -> MIRAGEModel:
    """The MIRAGEModel a checkpoint with ``args`` describes. ``geometry``
    (task -> (input size, patch size) pairs) replaces
    :func:`domain_geometry`'s sizes."""
    geo = geometry or domain_geometry(in_domains, input_size, patch_size)
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
    dim, depth, heads = model_dims(model_name, args)
    return MIRAGEModel(inputs, outputs,
                       num_global_tokens=args.get("num_global_tokens", 1),
                       dim_tokens=dim, depth=depth, num_heads=heads,
                       drop_path_rate=drop_path_rate,
                       compute_dtype=compute_dtype, remat=remat,
                       generator=generator)


class MIRAGEWrapper:
    def __init__(self, input_size=512, patch_size=32,
                 modalities: str = "bscan-slo-bscanlayermap",
                 weights: Optional[str] = None, compute_dtype=torch.float32,
                 output_adapters: bool = True,
                 model_override: Optional[str] = None, device="cuda",
                 param_dtype=None, mesh=None):
        """compute_dtype: torch.float32 or torch.bfloat16, the activations'
        type; the weights are held in ``param_dtype`` (default:
        compute_dtype) on ``device``. A checkpoint's input adapters for
        modalities not asked for are left out, as the JAX package's
        conversion leaves them. ``mesh``: None (one device), a
        ``parallel.mesh.ServeMesh``, or its axes ({'data': 4, 'fsdp': 1,
        'tensor': 2}; every axis shards the batch) over the devices of
        ``device``'s type: one replica a position (see the module
        docstring); ``device`` is then the first position's."""
        if weights is None:
            raise ValueError("weights= is required")
        self.device = resolve_device(device)
        self.mesh = None
        if mesh is not None:
            from mirage_tpu_torch.parallel.mesh import (ServeMesh,
                                                        make_serve_mesh)

            self.mesh = mesh if isinstance(mesh, ServeMesh) else \
                make_serve_mesh(mesh, self.device)
            self.device = resolve_device(self.mesh.devices[0])
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
        sd = {k: v for k, v in ckpt["model"].items()
              if not (k.startswith("input_adapters.")
                      and k.split(".")[1] not in self.in_domains)}
        if not output_adapters:
            sd = {k: v for k, v in sd.items()
                  if not k.startswith("output_adapters.")}
        model.load_state_dict(sd, strict=True)
        self.model = model.to(device=self.device,
                              dtype=param_dtype or compute_dtype).eval()
        self.compute_dtype = compute_dtype
        self.n_params = sum(p.numel() for p in self.model.parameters())
        self._replicas = [self.model]
        if self.mesh is not None:
            self._replicas += [copy.deepcopy(self.model).to(d)
                               for d in self.mesh.devices[1:]]
            self._streams = [torch.cuda.Stream(d) if d.type == "cuda"
                             else None for d in self.mesh.devices]
            self._spans = [None] * self.mesh.size
            self._pool = ThreadPoolExecutor(
                max_workers=self.mesh.size,
                thread_name_prefix="mirage-replica")

    def _batch_multiple(self) -> int:
        """The batch multiple a call pads to: the mesh size (serving shards
        the batch over every axis), else 1."""
        return 1 if self.mesh is None else self.mesh.size

    def _place_batch(self, x: Dict, batch: int):
        """Pads host tensors to the mesh's multiple with zeros and splits
        them into one shard a mesh position, in order."""
        n = self._batch_multiple()
        pad = (-batch) % n
        if pad:
            x = {k: torch.cat([v, v.new_zeros((pad,) + tuple(v.shape[1:]))])
                 for k, v in x.items()}
        per = (batch + pad) // n
        return [{k: v[i * per:(i + 1) * per] for k, v in x.items()}
                for i in range(n)]

    def _run_replica(self, i: int, fn, shard: Dict, span=None):
        """``fn(replica, inputs)`` on mesh position i's replica, its
        device current and its stream, from the calling (pool) thread,
        under the caller's span ``span`` (``profiling.adopt``); the stream
        is synchronised before it returns."""
        dev = self.mesh.devices[i]
        with torch.inference_mode(), profiling.adopt(span):
            if dev.type != "cuda":
                return fn(self._replicas[i], shard)
            stream = self._streams[i]
            start, end = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            with torch.cuda.device(dev), torch.cuda.stream(stream):
                start.record(stream)
                out = fn(self._replicas[i],
                         {k: v.to(dev) for k, v in shard.items()})
                end.record(stream)
            stream.synchronize()
            self._spans[i] = (dev, start, end)
            return out

    def _sharded(self, fn, x: Dict):
        """``fn`` over the mesh: x (host tensors) padded and split, each
        shard on its replica from its own thread, the outputs (a tensor or
        a task -> tensor dict) joined in batch order on the first device,
        the padding sliced off."""
        batch = next(iter(x.values())).shape[0]
        span = profiling.current()
        futures = [self._pool.submit(self._run_replica, i, fn, shard, span)
                   for i, shard in enumerate(self._place_batch(x, batch))]
        outs = [f.result() for f in futures]

        def join(parts):
            for t in parts:  # their blocks now also serve this stream
                if t.is_cuda:
                    t.record_stream(torch.cuda.current_stream(t.device))
            return torch.cat([t.to(self.device) for t in parts])[:batch]

        if isinstance(outs[0], dict):
            return {k: join([o[k] for o in outs]) for k in outs[0]}
        return join(outs)

    def device_spans(self):
        """The last call's device time on each mesh position, (start, end)
        in ms by CUDA events on the replicas' streams: from position 0's
        start where a position shares its card, else from its own start;
        None on the CPU."""
        if self.mesh is None or any(s is None for s in self._spans):
            return None
        dev0, first, _ = self._spans[0]
        return [(first.elapsed_time(a), first.elapsed_time(b)) if d == dev0
                else (0.0, a.elapsed_time(b)) for d, a, b in self._spans]

    def close(self):
        """Stops the mesh's threads."""
        if self.mesh is not None:
            self._pool.shutdown(wait=True)

    def _inputs(self, x):
        """Input arrays -> tensors on the device, or on the host for a
        mesh to split (labels as int64)."""
        dev = self.device if self.mesh is None else torch.device("cpu")
        out = {}
        for k, v in x.items():
            t = torch.as_tensor(np.asarray(v) if not torch.is_tensor(v)
                                else v)
            t = t.long() if k == "bscanlayermap" else t.float()
            out[k] = t.to(dev)
        return out

    def _filled(self, x):
        """:meth:`_inputs` with each absent modality zero-filled: (inputs,
        the absent modalities)."""
        x = self._inputs(x)
        batch = next(iter(x.values())).shape[0]
        absent = []
        dev = next(iter(x.values())).device
        for k in self.in_domains:
            if k not in x:
                shape = (batch, *self.input_size[k]) if k == "bscanlayermap" \
                    else (batch, 1, *self.input_size[k])
                x[k] = torch.zeros(shape, device=dev)
                absent.append(k)
        return x, tuple(absent)

    @torch.inference_mode()
    def __call__(self, x: Dict):
        """x: task -> (B, 1, H, W) float in [0, 1], or (B, H, W) integer
        labels for bscanlayermap (numpy or torch). Missing modalities are
        zero-filled and masked. Returns task -> (B, C, H, W) on the device,
        in compute_dtype."""
        with annotate("mirage.request"):
            with annotate("mirage.inputs"):
                x, absent = self._filled(x)
            if self.mesh is not None:
                return self._sharded(
                    lambda model, xs: model(xs, absent_tasks=absent), x)
            return self.model(x, absent_tasks=absent)

    @torch.inference_mode()
    def features(self, x: Dict):
        """Encoder features (B, N + G, D) of the given modalities."""
        with annotate("mirage.request"):
            with annotate("mirage.inputs"):
                x = self._inputs(x)
            if self.mesh is not None:
                return self._sharded(lambda model, xs: model.features(xs), x)
            return self.model.features(x)
