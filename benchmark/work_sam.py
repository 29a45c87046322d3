"""The work of the ``sam_vit_huge`` cell's steps, counted from the
configuration's shapes by ``benchmark/work.py``'s rules (products at
2·m·k·n, their operands and result once, in bf16; no LayerNorm, GELU,
bias or residual).

The frozen encoder counts its forward alone, on the 4096 real tokens of the
64 × 64 grid: the patch embedding, each block's qkv, proj, fc1 and fc2 (a
padded row's qkv is the bias and its proj is cropped, so any
implementation may skip them), the neck's 1 × 1 and 3 × 3 convolutions as
products. Each block's relative-position attention (:func:`relpos_attn`)
counts the attention over its keys, a windowed block as its windows of
14 × 14 keys with only the real queries counted, a global block at
4096 × 4096, plus the bias products, 2·n_q·dh·k_h + 2·n_q·dh·k_w a head,
and moves q, k, v and the output of the real tokens once. The ConvNeXt
head counts its forward and gradients as ``work.segtune_step`` counts
them, its first product taking no input gradient (its input is the
detached embedding), then AdamW over the trainable parameters.
"""

from benchmark import peaks
from benchmark.reference import sam as ref_sam
from benchmark.work import ACT_BYTES, Ops


def relpos_attn(cfg, b, window):
    """(FLOPs, bytes) of one call of the relative-position attention over
    ``b`` images, in windows of ``window`` (0: the whole grid)."""
    g = ref_sam.grid(cfg)
    heads = cfg["encoder_num_heads"]
    dh = cfg["encoder_embed_dim"] // heads
    n, k = g * g, window or g
    flops = 4 * b * heads * n * k * k * dh + b * heads * 2 * (
        2 * n * dh * k)
    return flops, b * heads * dh * 4 * n * ACT_BYTES


def relpos_least_ms(cfg, b):
    """The least time of one step's calls of the op (all blocks), ms."""
    return sum(peaks.bound(*relpos_attn(cfg, b, ref_sam.window_of(cfg, i)))[0]
               for i in range(cfg["encoder_depth"]))


def seg_step(cfg, b, n_trainable):
    """One step of ``b`` images: the frozen encoder's forward, the head's
    forward and gradients, AdamW over ``n_trainable`` parameters."""
    ops = Ops(train=True)
    d, p = cfg["encoder_embed_dim"], cfg["vit_patch_size"]
    g = ref_sam.grid(cfg)
    hid, out = int(d * cfg["mlp_ratio"]), cfg["prompt_embed_dim"]
    m = b * g * g
    frozen = dict(needs_dx=False, weight_trains=False)
    ops.gemm("embed", m, cfg["in_chans"] * p * p, d, **frozen)
    for i in range(cfg["encoder_depth"]):
        ops.gemm(f"enc{i}.qkv", m, d, 3 * d, **frozen)
        ops.ops.append((f"enc{i}.attn",
                        *relpos_attn(cfg, b, ref_sam.window_of(cfg, i))))
        ops.gemm(f"enc{i}.proj", m, d, d, **frozen)
        ops.gemm(f"enc{i}.fc1", m, d, hid, **frozen)
        ops.gemm(f"enc{i}.fc2", m, hid, d, **frozen)
    ops.gemm("neck.0", m, d, out, **frozen)
    ops.gemm("neck.2", m, 9 * out, out, **frozen)
    head = cfg["seg"]["head"]
    c = head["embed_dim"] // head["preds_per_patch"]
    pix = m * head["preds_per_patch"]
    ops.gemm("head.proj_dec", m, out, head["embed_dim"], needs_dx=False)
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
