"""The work of a cell's calls, counted from the configuration's shapes.

An op is (name, FLOPs, bytes). The products count 2·m·k·n operations and
their operands and result once; an attention core counts 4·b·n_q·n_k·d
operations and q, k, v and its output once. LayerNorms, GELUs, biases and
residuals are left out: an implementation may fold them into the
products' prologues and epilogues, and the least time has to hold for any
implementation. A training step adds each product's input gradient where
the input needs one and its weight gradient where the weight trains, the
attention cores' backward (twice the forward's products; recomputation is
not counted), and AdamW's pass over the trainable parameters (read p, g,
m, v; write p, m, v: 28 bytes a float32 parameter). Bytes are those of
the compute type (bf16: 2) except the optimizer's.

``least_ms`` sums max(FLOPs / peak, bytes / bandwidth) over the ops: the
least time any implementation of the same work could take on the card.
"""

import math

from benchmark import peaks
from benchmark.reference import mirage

ACT_BYTES = 2  # bf16 activations and products
ADAMW_BYTES = 28  # float32 p, g, m, v read; p, m, v written


class Ops:
    """A list of ops, with the rules of the forward and the backward."""

    def __init__(self, train=False):
        self.train = train
        self.ops = []

    def gemm(self, name, m, k, n, needs_dx=True, weight_trains=True):
        """x (m, k) · W (k, n): its forward, and in training dX and dW."""
        flops = 2 * m * k * n
        nbytes = (m * k + k * n + m * n) * ACT_BYTES
        self.ops.append((name, flops, nbytes))
        if self.train and needs_dx:
            self.ops.append((name + ".dx", flops, nbytes))
        if self.train and weight_trains:
            self.ops.append((name + ".dw", flops, nbytes))

    def attention(self, name, b, heads, nq, nk, dh):
        flops = 4 * b * heads * nq * nk * dh
        nbytes = b * heads * dh * (2 * nq + 2 * nk) * ACT_BYTES
        self.ops.append((name, flops, nbytes))
        if self.train:
            self.ops.append((name + ".bwd", 2 * flops, 2 * nbytes))

    def optimizer(self, n_params):
        self.ops.append(("adamw", 0, n_params * ADAMW_BYTES))

    def block(self, name, b, n, d, heads, ratio):
        m = b * n
        self.gemm(f"{name}.qkv", m, d, 3 * d)
        self.attention(f"{name}.attn", b, heads, n, n, d // heads)
        self.gemm(f"{name}.proj", m, d, d)
        self.gemm(f"{name}.fc1", m, d, int(d * ratio))
        self.gemm(f"{name}.fc2", m, int(d * ratio), d)

    def flops(self):
        return sum(f for _, f, _ in self.ops)

    def least_ms(self):
        return sum(peaks.bound(f, b)[0] for _, f, b in self.ops)


def _embed(ops, cfg, task, b, needs_dx=False):
    dom = cfg["domains"][task]
    n = math.prod(mirage.grid(cfg, task))
    k = dom["patch"] ** 2 * (dom.get("class_emb") if dom.get("classes")
                             else dom.get("channels", 1))
    ops.gemm(f"embed.{task}", b * n, k, cfg["dim_tokens"], needs_dx=needs_dx)


def _decoder(ops, cfg, task, b, enc_tokens, ctx_tokens):
    dec = cfg["decoder"]
    d, heads, ratio = dec["dim"], dec["num_heads"], dec["mlp_ratio"]
    nq = math.prod(mirage.grid(cfg, task))
    pre = f"dec.{task}"
    ops.gemm(f"{pre}.proj_context", b * enc_tokens, cfg["dim_tokens"], d)
    ops.gemm(f"{pre}.q", b * nq, d, d)
    ops.gemm(f"{pre}.kv", b * ctx_tokens, d, 2 * d)
    ops.attention(f"{pre}.xattn", b, heads, nq, ctx_tokens, d // heads)
    ops.gemm(f"{pre}.proj", b * nq, d, d)
    ops.gemm(f"{pre}.fc1", b * nq, d, d * ratio)
    ops.gemm(f"{pre}.fc2", b * nq, d * ratio, d)
    for j in range(dec["depth"]):
        ops.block(f"{pre}.block{j}", b, nq, d, heads, ratio)
    p = cfg["domains"][task]["patch"]
    ops.gemm(f"{pre}.out", b * nq, d, mirage.out_channels(cfg, task) * p * p)


def _encoder(ops, cfg, b, n):
    d = cfg["dim_tokens"]
    for i in range(cfg["depth"]):
        ops.block(f"enc{i}", b, n, d, cfg["num_heads"], cfg["mlp_ratio"])


def reconstruct(cfg, b, present):
    """The wrapper's forward of ``b`` images with the modalities
    ``present`` given whole and every decoder run."""
    ops = Ops()
    n = sum(math.prod(mirage.grid(cfg, t)) for t in present)
    for t in present:
        _embed(ops, cfg, t, b)
    enc = n + cfg["num_global_tokens"]
    _encoder(ops, cfg, b, enc)
    for t in cfg["domains"]:
        _decoder(ops, cfg, t, b, enc, enc)
    return ops


def pretrain_step(cfg, b, visible, n_trainable):
    """One pretraining step of ``b`` samples with ``visible`` tokens
    encoded: every modality embedded, the encoder over the visible tokens
    and the global ones, every decoder, the backward, AdamW over
    ``n_trainable`` parameters."""
    ops = Ops(train=True)
    for t in cfg["domains"]:
        # a label map's class embeddings train through the projection
        _embed(ops, cfg, t, b, needs_dx=bool(cfg["domains"][t].get("classes")))
    enc = visible + cfg["num_global_tokens"]
    _encoder(ops, cfg, b, enc)
    for t in cfg["domains"]:
        _decoder(ops, cfg, t, b, enc, enc)
    ops.optimizer(n_trainable)
    return ops


def segtune_step(cfg, b, n_trainable):
    """One segmentation-tuning step of ``b`` images: the input adapter
    (its weights train), the encoder over every token with its weights
    frozen (input gradients only), the ConvNeXt head (depthwise 7x7
    convolutions counted as 2·49 operations an output element), the
    backward, AdamW over ``n_trainable`` parameters."""
    seg = cfg["seg"]
    head = seg["head"]
    ops = Ops(train=True)
    d = cfg["dim_tokens"]
    n = (seg["image"] // seg["patch"]) ** 2
    ops.gemm("embed", b * n, seg["patch"] ** 2 * seg.get("channels", 1), d,
             needs_dx=False)
    tokens = n + cfg["num_global_tokens"]
    for i in range(cfg["depth"]):
        m, hid = b * tokens, int(d * cfg["mlp_ratio"])
        for name, k, out in (("qkv", d, 3 * d), ("proj", d, d),
                             ("fc1", d, hid), ("fc2", hid, d)):
            ops.gemm(f"enc{i}.{name}", m, k, out, weight_trains=False)
        h = cfg["num_heads"]
        ops.attention(f"enc{i}.attn", b, h, tokens, tokens, d // h)
    c = head["embed_dim"] // head["preds_per_patch"]
    pix = b * n * head["preds_per_patch"]
    ops.gemm("head.proj_dec", b * n, d, head["embed_dim"])
    for i in range(head["depth"]):
        flops = 2 * 49 * pix * c
        nbytes = (2 * pix * c + 49 * c) * ACT_BYTES
        ops.ops += [(f"head.block{i}.dwconv", flops, nbytes),
                    (f"head.block{i}.dwconv.dx", flops, nbytes),
                    (f"head.block{i}.dwconv.dw", flops, nbytes)]
        ops.gemm(f"head.block{i}.pwconv1", pix, c, 4 * c)
        ops.gemm(f"head.block{i}.pwconv2", pix, 4 * c, c)
    ops.gemm("head.final", pix, c, head["classes"])
    ops.optimizer(n_trainable)
    return ops
