"""Checkpoint loading and carrying JAX parameters across.

The port's modules use the reference torch state-dict namespace:

  input_adapters.{task}.{pos_emb, proj.weight, proj.bias, class_emb.weight}
  encoder.{i}.{norm1, attn.qkv, attn.proj, norm2, mlp.fc1, mlp.fc2}.{weight,bias}
  output_adapters.{task}.{mask_token, task_embeddings.{t}, pos_emb,
      proj_context, decoder.{q,kv,proj}, context_norm, query_norm, out_norm,
      mlp.{fc1,fc2}, decoder_transformer.{i}.*, out_proj}
  global_tokens

so a reference ``.pth`` loads with ``load_state_dict(strict=True)``; the
segmentation heads add their reference keys under
``output_adapters.{task}`` (``adapters/seg_heads.py``: the ConvNeXt,
linear, Segmenter and DPT heads).
:func:`jax_params_to_state_dict` maps a ``mirage_tpu`` parameter pytree
(given as numpy arrays) into that namespace, as
``mirage_tpu/api/convert.py:params_to_torch`` does. The segmentation
warm start (:func:`seg_checkpoint_surgery`, :func:`interpolate_pos_embed_sd`,
:func:`overlay_state_dict`) follows ``mirage_tpu/api/convert.py:288-354``,
and :func:`rename_keys` the pretraining warm start's MAE key rename. The
baseline ViTs (``models/vit.py``) use timm's namespace (``cls_token``,
``pos_embed``, ``patch_embed.proj``, ``blocks.{i}``, ``norm``, ``head``);
:func:`interpolate_vit_pos_embed` resizes their learned position
embedding (mirage_tpu/api/convert.py:318-338). :func:`sam_checkpoint_to_port`
keys SAM's image-encoder checkpoint as ``models/sam.py``'s model.
"""

import json
import re
import sys
from typing import Any, Dict, Mapping

import numpy as np
import torch

from mirage_tpu_torch.adapters.input_adapters import SemSegInputAdapter
from mirage_tpu_torch.adapters.seg_heads import (
    ConvNeXtAdapter, DPTOutputAdapter, LinearSegAdapter,
    SegmenterMaskTransformerAdapter)
from mirage_tpu_torch.adapters.spatial_output import SpatialOutputAdapter
from mirage_tpu_torch.nn.resize import resize_matrix

# the top-level names of a mirage_tpu ViT pytree (mirage_tpu/models/vit.py)
VIT_PARAM_NAMES = {"cls_token", "pos_embed", "patch_embed", "encoder", "norm",
                   "head"}
# mirage_tpu/nn/block.py:decoder_block_init's leaves (nn/block.py:DecoderBlock)
DECODER_BLOCK_NAMES = {"norm1", "self_attn", "cross_attn", "query_norm",
                       "context_norm", "norm2", "mlp"}


def load_torch_checkpoint(path: str) -> Dict[str, Any]:
    """A reference ``.pth`` -> {'model': {key: tensor}, 'args': dict}.

    The reference pickles its argparse namespace beside the weights, so this
    is a full unpickle: load only checkpoints you trust."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    state = ckpt.get("model", ckpt)
    args = ckpt.get("args", {})
    return {"model": dict(state),
            "args": dict(args) if isinstance(args, dict) else vars(args)}


# safetensors dtype names -> torch dtypes
SAFETENSORS_DTYPES = {"F64": torch.float64, "F32": torch.float32,
                      "F16": torch.float16, "BF16": torch.bfloat16,
                      "I64": torch.int64, "I32": torch.int32,
                      "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
                      "BOOL": torch.bool}


def load_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """A ``.safetensors`` file -> {name: tensor}, read with the standard
    library and torch alone (the ``safetensors`` package is not needed): a
    little-endian u64 header length, the JSON header (name -> dtype, shape,
    data offsets), then the raw little-endian data. A dtype outside
    :data:`SAFETENSORS_DTYPES` raises."""
    if sys.byteorder != "little":
        raise NotImplementedError("safetensors data is little-endian")
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(n))
        data = bytearray(f.read())
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        if info["dtype"] not in SAFETENSORS_DTYPES:
            raise ValueError(f"{path}: tensor {name!r} has dtype "
                             f"{info['dtype']!r}, not one of "
                             f"{sorted(SAFETENSORS_DTYPES)}")
        dtype = SAFETENSORS_DTYPES[info["dtype"]]
        start, end = info["data_offsets"]
        if end > start:
            t = torch.frombuffer(data, dtype=dtype, count=(end - start)
                                 // dtype.itemsize, offset=start)
        else:
            t = torch.empty(0, dtype=dtype)
        out[name] = t.reshape(info["shape"]).clone()
    return out


def save_safetensors(tensors: Mapping[str, torch.Tensor], path: str):
    """{name: tensor} -> a ``.safetensors`` file that :func:`load_safetensors`
    (and the ``safetensors`` package) reads: the header padded with spaces
    to 8 bytes, the tensors' bytes in name order."""
    names = {v: k for k, v in SAFETENSORS_DTYPES.items()}
    header, blobs, offset = {}, [], 0
    for name in sorted(tensors):
        t = tensors[name].detach().cpu().contiguous()
        blob = t.view(-1).view(torch.uint8).numpy().tobytes() \
            if t.numel() else b""
        header[name] = {"dtype": names[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(blob)]}
        blobs.append(blob)
        offset += len(blob)
    text = json.dumps(header, separators=(",", ":")).encode()
    text += b" " * (-len(text) % 8)
    with open(path, "wb") as f:
        f.write(len(text).to_bytes(8, "little"))
        f.write(text)
        for blob in blobs:
            f.write(blob)


def jax_params_to_state_dict(params: Mapping[str, Any], model
                             ) -> Dict[str, torch.Tensor]:
    """mirage_tpu parameter pytree (numpy leaves: stacked encoder layers,
    (in, out) linears, (C·ph·pw, D) patch projections) -> state dict of the
    port's ``model``. A classification tree {"model", "norm", "head"}
    (mirage_tpu/api/cls.py) maps onto a ``MIRAGECls``: ``model.*`` from the
    backbone, ``norm.*``, and ``head.*`` with the (fan_in, C) weight
    transposed to torch's (C, fan_in). A ViT tree (:data:`VIT_PARAM_NAMES`)
    maps onto a ``models/vit.py:VisionTransformer`` in timm's keys, a
    decoder block's (:data:`DECODER_BLOCK_NAMES`) onto an
    ``nn/block.py:DecoderBlock``."""
    if set(params) == {"model", "norm", "head"}:
        sd = {f"model.{k}": v for k, v in
              jax_params_to_state_dict(params["model"], model.model).items()}
        for key, value in (("norm.weight", params["norm"]["scale"]),
                           ("norm.bias", params["norm"]["bias"]),
                           ("head.weight", np.asarray(params["head"]["w"]).T),
                           ("head.bias", params["head"]["b"])):
            sd[key] = torch.tensor(np.asarray(value), dtype=torch.float32)
        return sd
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

    def layer(tree, i):
        if isinstance(tree, Mapping):
            return {k: layer(v, i) for k, v in tree.items()}
        return np.asarray(tree)[i]

    if set(params) == DECODER_BLOCK_NAMES:  # nn/block.py:decoder_block_init
        for name in ("norm1", "query_norm", "context_norm", "norm2"):
            put_ln(name, params[name])
        for name in ("qkv", "proj"):
            put_linear(f"self_attn.{name}", params["self_attn"][name])
        for name in ("q", "kv", "proj"):
            put_linear(f"cross_attn.{name}", params["cross_attn"][name])
        put_linear("mlp.fc1", params["mlp"]["fc1"])
        put_linear("mlp.fc2", params["mlp"]["fc2"])
        return sd

    if set(params) == VIT_PARAM_NAMES:  # the inverse of vit.py:107-118
        put("cls_token", params["cls_token"])
        put("pos_embed", params["pos_embed"])
        put_conv("patch_embed.proj", params["patch_embed"],
                 tuple(model.patch_embed.proj.weight.shape[1:]))
        for i in range(len(model.blocks)):
            put_block(f"blocks.{i}", layer(params["encoder"], i))
        put_ln("norm", params["norm"])
        put_linear("head", params["head"])
        return sd

    for task, adapter in model.input_adapters.items():
        pre, p = f"input_adapters.{task}", params["input_adapters"][task]
        put(f"{pre}.pos_emb", p["pos_emb"])
        if isinstance(adapter, SemSegInputAdapter):
            put(f"{pre}.class_emb.weight", p["class_emb"])
        put_conv(f"{pre}.proj", p["proj"],
                 tuple(adapter.proj.weight.shape[1:]))

    for i in range(len(model.encoder)):
        put_block(f"encoder.{i}", layer(params["encoder"], i))
    put("global_tokens", params["global_tokens"])

    def put_conv2d(prefix, p):  # torch layout already, conv or transposed
        put(f"{prefix}.weight", p["w"])
        if "b" in p:
            put(f"{prefix}.bias", p["b"])

    def put_bn(prefix, p):
        put_ln(prefix, p)
        put(f"{prefix}.running_mean", p["mean"])
        put(f"{prefix}.running_var", p["var"])

    def put_rcu(prefix, p):
        for i in (1, 2):
            put_conv2d(f"{prefix}.conv{i}", p[f"conv{i}"])
            if f"bn{i}" in p:
                put_bn(f"{prefix}.bn{i}", p[f"bn{i}"])

    # inverse of each head's params_from_torch (mirage_tpu/adapters/
    # seg_heads.py:227, :265, :345, :543)
    for task, adapter in (model.output_adapters or {}).items():
        pre, p = f"output_adapters.{task}", params["output_adapters"][task]
        if isinstance(adapter, LinearSegAdapter):
            put_conv2d(f"{pre}.final_layer", p["final_layer"])
            continue
        if isinstance(adapter, SegmenterMaskTransformerAdapter):
            put(f"{pre}.cls_emb", p["cls_emb"])
            put_linear(f"{pre}.proj_dec", p["proj_dec"])
            for i, bp in enumerate(p["blocks"]):
                put_block(f"{pre}.blocks.{i}", bp)
            put_ln(f"{pre}.decoder_norm", p["decoder_norm"])
            put_linear(f"{pre}.patch_proj", p["patch_proj"])
            put_linear(f"{pre}.classes_proj", p["classes_proj"])
            put_ln(f"{pre}.mask_norm", p["mask_norm"])
            continue
        if isinstance(adapter, DPTOutputAdapter):
            for i, stage in enumerate(p["act_postprocess"]):
                put_conv2d(f"{pre}.act_postprocess.{i}.0", stage["proj"])
                if "resample" in stage:
                    put_conv2d(f"{pre}.act_postprocess.{i}.1",
                               stage["resample"])
            for i in range(4):
                put_conv2d(f"{pre}.scratch.layer{i + 1}_rn",
                           p["layer_rn"][i])
                rn, fp = f"{pre}.scratch.refinenet{i + 1}", p["refinenet"][i]
                put_rcu(f"{rn}.resConfUnit1", fp["resConfUnit1"])
                put_rcu(f"{rn}.resConfUnit2", fp["resConfUnit2"])
                put_conv2d(f"{rn}.out_conv", fp["out_conv"])
            head = p["head"]
            names = ({"conv1": "0", "conv2": "4"}
                     if adapter.head_type == "semseg"
                     else {"conv1": "0", "conv2": "2", "conv3": "4"})
            for name, idx in names.items():
                put_conv2d(f"{pre}.head.{idx}", head[name])
            if "bn" in head:
                put_bn(f"{pre}.head.1", head["bn"])
            continue
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


def rename_keys(sd: Mapping[str, Any], mapping: Mapping[str, str]
                ) -> Dict[str, Any]:
    """Every key with each ``re.sub(old, new, key)`` of ``mapping`` applied
    in turn (mirage_tpu/api/convert.py:357; e.g. MAE's ``^blocks\\.`` ->
    ``encoder.``, run_pretraining.py:432-436)."""
    out = {}
    for key, value in sd.items():
        for old, new in mapping.items():
            key = re.sub(old, new, key)
        out[key] = value
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


def interpolate_vit_pos_embed(arr, new_grid: int,
                              num_prefix_tokens: int = 1) -> np.ndarray:
    """A timm-style learned ``pos_embed`` (1, P + G·G, D) bicubic-resized
    to a square grid of ``new_grid`` (F.interpolate, align_corners=False),
    the P prefix (cls) tokens kept; returned as it is (float32) when the
    grid already matches (mirage_tpu/api/convert.py:318-338)."""
    arr = np.asarray(arr, dtype=np.float32)
    prefix, patch = arr[:, :num_prefix_tokens], arr[:, num_prefix_tokens:]
    orig = int(round(patch.shape[1] ** 0.5))
    if orig * orig != patch.shape[1]:
        raise ValueError(f"pos_embed patch count {patch.shape[1]} not square")
    if orig == new_grid:
        return arr
    d = patch.shape[-1]
    m = resize_matrix(orig, new_grid, "bicubic")
    grid = np.einsum("oh,bhwd->bowd", m, patch.reshape(1, orig, orig, d))
    grid = np.einsum("pw,bhwd->bhpd", m, grid)
    return np.concatenate([prefix, grid.reshape(1, new_grid * new_grid, d)],
                          axis=1)


# SAM's image-encoder keys -> models/sam.py's, applied in turn
SAM_KEYS = ((r"^image_encoder\.patch_embed\.proj\.",
             "input_adapters.{task}.proj."),
            (r"^image_encoder\.pos_embed$", "input_adapters.{task}.pos_emb"),
            (r"^image_encoder\.blocks\.", "encoder."),
            (r"\.mlp\.lin1\.", ".mlp.fc1."), (r"\.mlp\.lin2\.", ".mlp.fc2."),
            (r"^image_encoder\.neck\.", "neck."))


def sam_checkpoint_to_port(sd: Mapping[str, Any], task: str = "bscan"
                           ) -> Dict[str, Any]:
    """A SAM checkpoint (``image_encoder.{patch_embed.proj, pos_embed,
    blocks.{i}.{norm1, attn.{qkv, proj, rel_pos_h, rel_pos_w}, norm2,
    mlp.{lin1, lin2}}, neck.{0, 1, 2, 3}}`` beside ``prompt_encoder.*`` and
    ``mask_decoder.*``, which are dropped) keyed as ``models/sam.py``'s
    model with the image domain ``task``. Any other key raises KeyError."""
    out = {}
    for key, value in sd.items():
        if key.startswith(("prompt_encoder.", "mask_decoder.")):
            continue
        if not key.startswith("image_encoder."):
            raise KeyError(f"{key}: not a key of SAM's checkpoint")
        for old, new in SAM_KEYS:
            key = re.sub(old, new.format(task=task), key)
        out[key] = value
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
