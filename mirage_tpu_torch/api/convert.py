"""Checkpoint loading and carrying JAX parameters across.

The port's modules use the reference torch state-dict namespace:

  input_adapters.{task}.{pos_emb, proj.weight, proj.bias, class_emb.weight}
  encoder.{i}.{norm1, attn.qkv, attn.proj, norm2, mlp.fc1, mlp.fc2}.{weight,bias}
  output_adapters.{task}.{mask_token, task_embeddings.{t}, pos_emb,
      proj_context, decoder.{q,kv,proj}, context_norm, query_norm, out_norm,
      mlp.{fc1,fc2}, decoder_transformer.{i}.*, out_proj}
  global_tokens

so a reference ``.pth`` loads with ``load_state_dict(strict=True)``; the
ConvNeXt segmentation head adds ``output_adapters.{task}.{proj_dec,
blocks.{i}.{dwconv,norm,pwconv1,pwconv2}, final_layer}``.
:func:`jax_params_to_state_dict` maps a ``mirage_tpu`` parameter pytree
(given as numpy arrays) into that namespace, as
``mirage_tpu/api/convert.py:params_to_torch`` does. The segmentation
warm start (:func:`seg_checkpoint_surgery`, :func:`interpolate_pos_embed_sd`,
:func:`overlay_state_dict`) follows ``mirage_tpu/api/convert.py:288-354``.
"""

import re
from typing import Any, Dict, Mapping

import numpy as np
import torch

from mirage_tpu_torch.adapters.input_adapters import SemSegInputAdapter
from mirage_tpu_torch.adapters.seg_heads import ConvNeXtAdapter
from mirage_tpu_torch.adapters.spatial_output import SpatialOutputAdapter
from mirage_tpu_torch.nn.resize import resize_matrix


def load_torch_checkpoint(path: str) -> Dict[str, Any]:
    """A reference ``.pth`` -> {'model': {key: tensor}, 'args': dict}.

    The reference pickles its argparse namespace beside the weights, so this
    is a full unpickle: load only checkpoints you trust."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    state = ckpt.get("model", ckpt)
    args = ckpt.get("args", {})
    return {"model": dict(state),
            "args": dict(args) if isinstance(args, dict) else vars(args)}


def load_safetensors(path: str) -> Dict[str, torch.Tensor]:
    from safetensors.torch import load_file

    return load_file(path)


def jax_params_to_state_dict(params: Mapping[str, Any], model
                             ) -> Dict[str, torch.Tensor]:
    """mirage_tpu parameter pytree (numpy leaves: stacked encoder layers,
    (in, out) linears, (C·ph·pw, D) patch projections) -> state dict of the
    port's ``model``."""
    sd: Dict[str, torch.Tensor] = {}

    def put(key, value):
        sd[key] = torch.tensor(np.asarray(value), dtype=torch.float32)

    def put_linear(prefix, p):
        put(f"{prefix}.weight", np.asarray(p["w"]).T)
        if "b" in p:
            put(f"{prefix}.bias", p["b"])

    def put_conv(prefix, p, chw):
        w = np.asarray(p["w"]).T  # (D, C·ph·pw)
        put(f"{prefix}.weight", w.reshape(w.shape[0], *chw))
        put(f"{prefix}.bias", p["b"])

    def put_ln(prefix, p):
        put(f"{prefix}.weight", p["scale"])
        put(f"{prefix}.bias", p["bias"])

    def put_block(prefix, p):
        put_ln(f"{prefix}.norm1", p["norm1"])
        put_linear(f"{prefix}.attn.qkv", p["attn"]["qkv"])
        put_linear(f"{prefix}.attn.proj", p["attn"]["proj"])
        put_ln(f"{prefix}.norm2", p["norm2"])
        put_linear(f"{prefix}.mlp.fc1", p["mlp"]["fc1"])
        put_linear(f"{prefix}.mlp.fc2", p["mlp"]["fc2"])

    for task, adapter in model.input_adapters.items():
        pre, p = f"input_adapters.{task}", params["input_adapters"][task]
        put(f"{pre}.pos_emb", p["pos_emb"])
        ph, pw = adapter.patch_hw
        if isinstance(adapter, SemSegInputAdapter):
            put(f"{pre}.class_emb.weight", p["class_emb"])
            put_conv(f"{pre}.proj", p["proj"], (adapter.dim_class_emb, ph, pw))
        else:
            put_conv(f"{pre}.proj", p["proj"], (adapter.num_channels, ph, pw))

    def layer(tree, i):
        if isinstance(tree, Mapping):
            return {k: layer(v, i) for k, v in tree.items()}
        return np.asarray(tree)[i]

    for i in range(len(model.encoder)):
        put_block(f"encoder.{i}", layer(params["encoder"], i))
    put("global_tokens", params["global_tokens"])

    def put_conv2d(prefix, p):
        put(f"{prefix}.weight", p["w"])
        if "b" in p:
            put(f"{prefix}.bias", p["b"])

    for task, adapter in (model.output_adapters or {}).items():
        pre, p = f"output_adapters.{task}", params["output_adapters"][task]
        if isinstance(adapter, ConvNeXtAdapter):
            # inverse of mirage_tpu/adapters/seg_heads.py:120-133, :227-233
            put_linear(f"{pre}.proj_dec", p["proj_dec"])
            for i, bp in enumerate(p["blocks"]):
                put_conv2d(f"{pre}.blocks.{i}.dwconv", bp["dwconv"])
                put_ln(f"{pre}.blocks.{i}.norm", bp["norm"])
                put_linear(f"{pre}.blocks.{i}.pwconv1", bp["pwconv1"])
                put_linear(f"{pre}.blocks.{i}.pwconv2", bp["pwconv2"])
            put_conv2d(f"{pre}.final_layer", p["final_layer"])
            continue
        if not isinstance(adapter, SpatialOutputAdapter):
            raise NotImplementedError(f"output adapter {type(adapter)}")
        put(f"{pre}.mask_token", p["mask_token"])
        put(f"{pre}.pos_emb", p["pos_emb"])
        put_linear(f"{pre}.proj_context", p["proj_context"])
        put_linear(f"{pre}.out_proj", p["out_proj"])
        for t, v in p.get("task_embeddings", {}).items():
            put(f"{pre}.task_embeddings.{t}", v)
        if adapter.use_xattn:
            for name in ("q", "kv", "proj"):
                put_linear(f"{pre}.decoder.{name}", p["decoder"][name])
            for name in ("context_norm", "query_norm", "out_norm"):
                put_ln(f"{pre}.{name}", p[name])
            put_linear(f"{pre}.mlp.fc1", p["mlp"]["fc1"])
            put_linear(f"{pre}.mlp.fc2", p["mlp"]["fc2"])
        for i in range(adapter.depth):
            put_block(f"{pre}.decoder_transformer.{i}",
                      p["decoder_transformer"][i])
    return sd


def seg_checkpoint_surgery(sd: Mapping[str, Any]) -> Dict[str, Any]:
    """A pretraining checkpoint made ready for segmentation tuning
    (fm_seg_config.py:87-104): bscanlayermap renamed to semseg, the semseg
    class embedding padded by one zero row (the downstream padding index),
    the output adapters dropped."""
    out = {k.replace("bscanlayermap", "semseg"): v for k, v in sd.items()
           if "output_adapters" not in k}
    key = "input_adapters.semseg.class_emb.weight"
    if key in out:
        emb = torch.as_tensor(out[key])
        out[key] = torch.cat([emb, emb.new_zeros(1, emb.shape[1])])
    return out


def interpolate_pos_embed_sd(sd: Mapping[str, Any], model) -> Dict[str, Any]:
    """Bicubic-resizes every ``input_adapters.*.pos_emb`` to the model's
    position-embedding grid (mutils/pos_embed.py:7-23; a 512² pretraining
    checkpoint tuned at 1024²), with torch F.interpolate semantics
    (align_corners=False) through the host interpolation matrices."""
    out = dict(sd)
    pattern = re.compile(r"input_adapters\.(.*)\.pos_emb$")
    for key in list(out):
        m = pattern.match(key)
        adapter = model.input_adapters[m.group(1)] \
            if m and m.group(1) in model.input_adapters else None
        if adapter is None:
            continue
        new_h, new_w = adapter.posemb_grid
        arr = np.asarray(out[key], dtype=np.float32)
        if arr.shape[-2:] == (new_h, new_w):
            continue
        arr = np.einsum("oh,bdhw->bdow",
                        resize_matrix(arr.shape[-2], new_h, "bicubic"), arr)
        arr = np.einsum("pw,bdhw->bdhp",
                        resize_matrix(arr.shape[-1], new_w, "bicubic"), arr)
        out[key] = torch.from_numpy(arr)
    return out


def overlay_state_dict(model: torch.nn.Module, sd: Mapping[str, Any]):
    """Loads the entries of ``sd`` that the model has, leaving the rest of
    its freshly initialised parameters as they are: a strict=False load
    (the warm start of mirage_tpu/api/convert.py:overlay_torch_params). A
    present key whose shape differs raises. Returns the model's keys that
    ``sd`` did not fill."""
    own = model.state_dict()
    picked = {}
    for key, value in sd.items():
        if key not in own:
            continue
        value = torch.as_tensor(value)
        if tuple(value.shape) != tuple(own[key].shape):
            raise ValueError(f"{key}: checkpoint shape {tuple(value.shape)}, "
                             f"model shape {tuple(own[key].shape)}")
        picked[key] = value
    model.load_state_dict(picked, strict=False)
    return sorted(set(own) - set(picked))
