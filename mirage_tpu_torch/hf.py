"""MIRAGE one-file public API (Hugging Face distribution flavour), in PyTorch.

A self-contained port of ``mirage_tpu/hf.py``: it imports torch and numpy
and nothing else of this package, so it can be vendored alone:

    from mirage_tpu_torch.hf import MIRAGEWrapper
    model = MIRAGEWrapper.from_pretrained("j-morano/MIRAGE-Base")
    feats = model({"bscan": x, "slo": y})   # (B, N+1, D) token features

Weights load from the official ``j-morano/MIRAGE-{Base,Large}`` safetensors
(the inner-model key namespace: ``input_adapters.*``, ``encoder.*``,
``global_tokens``), from a local ``.pth``/``.safetensors`` file or from a
directory holding ``model.safetensors``; safetensors are read by the small
reader below, so the ``safetensors`` package is not needed. Only a name
that is not a local path goes to the hub (``huggingface_hub``).

The module runs on ``device`` (default ``"cuda"``, which raises without a
card; ``device="cpu"`` runs on the CPU), always in float32. The JAX module
computes its blocks in plain XLA, outside any Pallas kernel, so there is no
kernel to port: the blocks here are plain PyTorch on purpose (an explicit
softmax, no fused attention), not a fallback of a kernel path. The
positional embedding keeps the reference's meshgrid quirk and is resized by
the exact torch-bicubic matrices.

Parity: hf/mirage_hf.py:582-692 (MIRAGEWrapper), :363-579 (MIRAGELight),
hf/helper_hf.py:9-77 (from_pretrained).
"""

import functools
import json
import os
import sys
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch


def _pair(v):
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v)


# ---------------------------------------------------------------- numerics

def build_2d_sincos_posemb(h: int, w: int, embed_dim: int,
                           temperature: float = 1e4) -> torch.Tensor:
    """MoCo-v3 style (hf/mirage_hf.py:93-110). Returns (1, D, H, W) with the
    reference's layout quirk: meshgrid('ij') over (w, h) flattened and then
    read as (h, w)."""
    assert embed_dim % 4 == 0
    gw, gh = np.meshgrid(np.arange(w, dtype=np.float32),
                         np.arange(h, dtype=np.float32), indexing="ij")
    pos_dim = embed_dim // 4
    omega = np.arange(pos_dim, dtype=np.float32) / pos_dim
    omega = 1.0 / (temperature ** omega)
    out_w = gw.reshape(-1)[:, None] * omega[None]
    out_h = gh.reshape(-1)[:, None] * omega[None]
    pos = np.concatenate([np.sin(out_w), np.cos(out_w),
                          np.sin(out_h), np.cos(out_h)], axis=1)
    pos = pos.reshape(1, h, w, embed_dim).transpose(0, 3, 1, 2)
    return torch.from_numpy(np.ascontiguousarray(pos))


@functools.lru_cache(maxsize=64)
def _bicubic_matrix(in_size: int, out_size: int, A: float = -0.75):
    """torch F.interpolate(bicubic, align_corners=False) row matrix."""
    W = np.zeros((out_size, in_size), np.float64)
    scale = in_size / out_size
    dst = np.arange(out_size, dtype=np.float64)
    src = scale * (dst + 0.5) - 0.5
    base = np.floor(src).astype(np.int64)
    t = src - base

    def cubic(x):
        x = np.abs(x)
        return np.where(
            x <= 1.0, ((A + 2) * x - (A + 3)) * x * x + 1,
            np.where(x < 2.0, (((A * x) - 5 * A) * x + 8 * A) * x - 4 * A,
                     0.0))

    for tap in range(-1, 3):
        idx = np.clip(base + tap, 0, in_size - 1)
        np.add.at(W, (np.arange(out_size), idx), cubic(tap - t))
    return W.astype(np.float32)


def interpolate_posemb(pos: torch.Tensor, out_hw: Tuple[int, int]):
    """(1, D, H, W) -> (1, D, h, w), exact torch bicubic."""
    in_h, in_w = pos.shape[-2], pos.shape[-1]
    out_h, out_w = out_hw
    if (in_h, in_w) == (out_h, out_w):
        return pos
    wh = torch.from_numpy(_bicubic_matrix(in_h, out_h)).to(pos.device)
    ww = torch.from_numpy(_bicubic_matrix(in_w, out_w)).to(pos.device)
    x = torch.einsum("oh,bdhw->bdow", wh, pos.float())
    return torch.einsum("pw,bdhw->bdhp", ww, x)


def layer_norm(scale, bias, x, eps=1e-6):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * scale + bias


def attention(p, x, num_heads):
    b, n, d = x.shape
    qkv = x @ p["qkv_w"] + p["qkv_b"]
    q, k, v = qkv.reshape(b, n, 3, num_heads, d // num_heads).permute(
        2, 0, 3, 1, 4)
    scale = (d // num_heads) ** -0.5
    attn = torch.softmax((q * scale) @ k.transpose(-1, -2), dim=-1)
    out = (attn @ v).transpose(1, 2).reshape(b, n, d)
    return out @ p["proj_w"] + p["proj_b"]


def block(p, x, num_heads):
    h = layer_norm(p["n1_s"], p["n1_b"], x)
    x = x + attention(p, h, num_heads)
    h = layer_norm(p["n2_s"], p["n2_b"], x)
    h = torch.nn.functional.gelu(h @ p["fc1_w"] + p["fc1_b"],
                                 approximate="none")
    return x + (h @ p["fc2_w"] + p["fc2_b"])


# ------------------------------------------------------------- loading

_ST_DTYPES = {"F64": torch.float64, "F32": torch.float32,
              "F16": torch.float16, "BF16": torch.bfloat16,
              "I64": torch.int64, "I32": torch.int32, "I16": torch.int16,
              "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool}


def load_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """A ``.safetensors`` file -> {name: tensor}: a little-endian u64
    header length, the JSON header, then the raw little-endian data."""
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
        if info["dtype"] not in _ST_DTYPES:
            raise ValueError(f"{path}: tensor {name!r} has unsupported "
                             f"dtype {info['dtype']!r}")
        dtype = _ST_DTYPES[info["dtype"]]
        start, end = info["data_offsets"]
        t = (torch.frombuffer(data, dtype=dtype, count=(end - start)
                              // dtype.itemsize, offset=start)
             if end > start else torch.empty(0, dtype=dtype))
        out[name] = t.reshape(info["shape"]).clone()
    return out


def _resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device={device!r} but no CUDA device is "
                           f"available; pass device='cpu'")
    return dev


# ---------------------------------------------------------------- wrapper

class MIRAGEWrapper:
    """Encoder-only MIRAGE: multimodal tokens -> ViT -> (B, N+G, D)
    features."""

    SIZES = {"base": (768, 12, 12), "large": (1024, 24, 16)}

    def __init__(self, input_size=512, patch_size=32,
                 modalities: str = "bscan-slo", size: str = "base",
                 device="cuda"):
        self.in_domains = modalities.split("-")
        self.input_size = _pair(input_size)
        self.patch_size = _pair(patch_size)
        self.grid_size = tuple(self.input_size[i] // self.patch_size[i]
                               for i in range(2))
        if size not in self.SIZES:
            raise ValueError(f"Unknown model size: {size}")
        self.size = size
        self.dim, self.depth, self.num_heads = self.SIZES[size]
        self.num_global_tokens = 1
        self.device = _resolve_device(device)
        self.params: Optional[Dict[str, Any]] = None

    # -- weights ------------------------------------------------------------

    def load_state_dict(self, sd: Mapping[str, Any]):
        """Torch key namespace -> internal float32 params on the device.
        Adapters and keys of absent modalities are ignored (strict=False
        semantics)."""

        def t(k, transpose=False):
            v = torch.as_tensor(np.asarray(sd[k]) if not torch.is_tensor(
                sd[k]) else sd[k]).float()
            return (v.t() if transpose else v).contiguous().to(self.device)

        p: Dict[str, Any] = {"adapters": {}, "blocks": []}
        for dom in self.in_domains:
            pre = f"input_adapters.{dom}"
            w = t(f"{pre}.proj.weight")  # (D, C, ph, pw)
            p["adapters"][dom] = {
                "pos_emb": t(f"{pre}.pos_emb"),
                "w": w.reshape(w.shape[0], -1).t().contiguous(),
                "b": t(f"{pre}.proj.bias"),
            }
        for i in range(self.depth):
            pre = f"encoder.{i}"
            p["blocks"].append({
                "n1_s": t(f"{pre}.norm1.weight"),
                "n1_b": t(f"{pre}.norm1.bias"),
                "qkv_w": t(f"{pre}.attn.qkv.weight", True),
                "qkv_b": t(f"{pre}.attn.qkv.bias"),
                "proj_w": t(f"{pre}.attn.proj.weight", True),
                "proj_b": t(f"{pre}.attn.proj.bias"),
                "n2_s": t(f"{pre}.norm2.weight"),
                "n2_b": t(f"{pre}.norm2.bias"),
                "fc1_w": t(f"{pre}.mlp.fc1.weight", True),
                "fc1_b": t(f"{pre}.mlp.fc1.bias"),
                "fc2_w": t(f"{pre}.mlp.fc2.weight", True),
                "fc2_b": t(f"{pre}.mlp.fc2.bias"),
            })
        p["global_tokens"] = t("global_tokens")
        self.params = p
        return self

    @classmethod
    def from_pretrained(cls, name_or_path: str, **kwargs):
        """'j-morano/MIRAGE-{Base,Large}' (HF hub), a local safetensors/.pth
        file, or a local save_pretrained directory."""
        size = kwargs.pop("size", None)
        if size is None:
            size = "large" if "large" in str(name_or_path).lower() else "base"

        path = str(name_or_path)
        if os.path.isdir(path):
            path = os.path.join(path, "model.safetensors")
        elif not os.path.exists(path):
            from huggingface_hub import hf_hub_download

            path = hf_hub_download(repo_id=path, filename="model.safetensors")

        if path.endswith(".pth"):
            ckpt = torch.load(path, map_location="cpu", weights_only=False)
            sd = dict(ckpt.get("model", ckpt))
        else:
            sd = load_safetensors(path)
        model = cls(size=size, **kwargs)
        return model.load_state_dict(sd)

    # -- forward ------------------------------------------------------------

    def _embed(self, dom, x):
        """(B, 1, H, W) -> (B, N, D): strided patchify as reshape + matmul,
        plus the interpolated sincos posemb."""
        b, c, h, w = x.shape
        ph, pw = self.patch_size
        nh, nw = h // ph, w // pw
        a = self.params["adapters"][dom]
        patches = x.reshape(b, c, nh, ph, nw, pw).permute(0, 2, 4, 1, 3, 5)
        patches = patches.reshape(b, nh * nw, c * ph * pw)
        tokens = patches @ a["w"] + a["b"]
        pos = interpolate_posemb(a["pos_emb"], (nh, nw))
        pos = pos.reshape(1, self.dim, nh * nw).transpose(1, 2)
        return tokens + pos

    @torch.inference_mode()
    def __call__(self, x: Dict[str, Any]) -> torch.Tensor:
        """x: dict of (B, 1, H, W) float arrays in [0, 1] (numpy or torch).
        Returns (B, N+1, D) float32 encoder token features on the device."""
        assert self.params is not None, \
            "call load_state_dict/from_pretrained first"
        x = {k: torch.as_tensor(v).float().to(self.device)
             for k, v in x.items()}
        tokens = torch.cat([self._embed(dom, x[dom])
                            for dom in self.in_domains if dom in x], dim=1)
        b = tokens.shape[0]
        g = self.params["global_tokens"].expand(b, self.num_global_tokens,
                                                self.dim)
        tokens = torch.cat([tokens, g], dim=1)
        for bp in self.params["blocks"]:
            tokens = block(bp, tokens, self.num_heads)
        return tokens
