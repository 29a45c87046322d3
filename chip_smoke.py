#!/usr/bin/env python3
"""Runs the PyTorch/CUDA port (mirage_tpu_torch) end to end on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero):

1. build: compiles every csrc/*.cu with nvcc for sm_90a (one nvcc per
   source, in parallel) and prints each kernel's registers and shared memory;
   prints the card's name and power limit.
2. kernels: each op (B1 attn_half_block, B2 mlp_block, B3 xattn_half_block)
   at the MIRAGE-Large main-path shapes in bf16 against its plain PyTorch
   version computed in float32 from the same bf16 inputs, plus one float32
   case per op; the backward ops B4-B6 at the pretraining shapes; B8
   flash_attention (forward and backward) at the segmentation encoder's
   (4, 12, 1025, 64) and the decoders' (64, 8, 256 × 769, 32), and B9 (the
   stash MLP pair) at (65536, 384) -> 1536; times the kernel, the plain
   version and a composite of PyTorch library calls with CUDA events.
3. golden: tests/golden/example_triplet_tiny.npz (reference weights and
   outputs) through the port's wrapper on the card in float32.
4. serve: MIRAGE-Large (1024 wide, 24 layers, 16 heads; three 256/2/8
   decoders) from a seeded random init, saved as a .pth, loaded through
   MIRAGEWrapper in bf16, served by MIRAGEServer on an ephemeral port;
   concurrent HTTP requests, launch counts per forward, agreement with the
   plain path on the card, one three-modality request (769 tokens, through
   B8), batch-64 throughput, and one forward's device time by kernel group
   under torch.profiler.
5. train: the ViT-B pretraining step at batch 256 (kernel step vs plain
   step, launch counts, ms/step, a profile).
6. seg: segmentation tuning (configs/seg_200e_convnext.yaml, MIRAGE-Base
   at 1025 tokens with the ConvNeXt head) through run_seg_tuning.main on a
   seeded synthetic dataset, then the bare train step at batch 4: kernel
   step vs plain step, exact launch counts per step and per eval forward,
   ms/step, peak memory and a profile.
7. cls: classification tuning (MIRAGE-Base at 257 tokens, the global
   pool, batch 64) through run_cls_tuning.main on a seeded synthetic class
   folder with seeded MIRAGE-Base weights, then the bare step three ways
   (the default switches: B6, B2, B5; MIRAGE_OPT_KERNEL=on with
   MIRAGE_MLP_BWD=accumulate: B7 and B11; linear probing: B1 + B2), each
   against the plain step, with exact launch counts, ms/step, peak memory
   and a profile.

8. infer: cli/infer.main on a seeded synthetic folder of two subjects at raw
   sizes that are not 512², with the MIRAGE-Large weights of phase 4
   (reconstructions and --features, the features held to MIRAGEWrapper's);
   the same weights written as model.safetensors and read by
   hf.MIRAGEWrapper.from_pretrained and by MIRAGEWrapper (the repaired
   reader): hf's batch-64 features against the wrapper's in float32.

Phase 2 also holds the accumulating backwards (B7, both halves) and the
fused AdamW update (B11) against their plain versions, and phase 5 runs the
pretraining step once more with the three switches on (B7 for both halves,
B11). Phase 2 checks the whole-block kernel (B10) at the decoder and
MIRAGE-Large encoder shapes, the int8 MLP (B12; reruns bit for bit) and the
3-D stash forward (B9′; bit-equal to B2); phase 3 replays the MIRAGE-Base
golden (tests/golden/example_triplet_base.npz, seeded full-size weights)
under MIRAGE_BLOCK_FUSE=off and all; phase 4 serves MIRAGE-Large at batch
64 under MIRAGE_BLOCK_FUSE=off, decoder and all.

``--phases`` runs a subset (a partial run prints no result line). The line
before the last is a JSON object with one entry per kernel; the card's name
and power limit come before it; the last line is {"ok": true, "device":
{...}}.
"""

import hashlib
import io
import json
import subprocess
import sys
import threading
import time
import urllib.request
import zlib
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0
BATCH = 64
TRAIN_BATCH = 256
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_BYTES = 3.35e12
# bf16 kernel vs its float32 plain version on the same bf16 inputs: the
# kernel rounds the LN output, the projections, the probabilities and the
# attention output to bf16 (8 significant bits, relative step 2^-8) as the
# TPU kernels do; outputs are O(1)-O(5), so one bf16 step of the output
# alone is up to 0.03.
BF16_MAX_ABS, BF16_REL_L2 = 5e-2, 1e-2
F32_ATOL = 1e-4
GOLDEN_ATOL = 1e-4  # 1e-5 on the CPU; the card sums in another order
# whole-model bf16 kernel path vs bf16 plain path, 24 layers deep
MODEL_REL_L2 = 3e-2

# op -> (file:line of the TPU kernel, its launcher)
TPU_KERNELS = {
    "attn_half_block": ("mirage_tpu/ops/block_attention.py:251",
                        "_attn_half_fwd :310 -> _attn_half_kernel :251"),
    "mlp_block": ("mirage_tpu/ops/fused_mlp.py:58",
                  "_mlp_block_fwd :92 -> _mlp_kernel :58"),
    "xattn_half_block": ("mirage_tpu/ops/block_attention.py:745",
                         "_xattn_half_fwd :795 -> _xattn_half_kernel :745"),
}
# op -> (its wrapper, the CUDA sources it launches)
CSRC = "mirage_tpu_torch/csrc/"
SOURCES = {
    "attn_half_block": ("mirage_tpu_torch/ops/block_attention.py",
                        [CSRC + f for f in ("layernorm.cu", "gemm.cu",
                                            "attention.cu")]),
    "mlp_block": ("mirage_tpu_torch/ops/fused_mlp.py",
                  [CSRC + f for f in ("layernorm.cu", "gemm.cu")]),
    "xattn_half_block": ("mirage_tpu_torch/ops/block_attention.py",
                         [CSRC + f for f in ("layernorm.cu", "gemm.cu",
                                             "attention.cu")]),
}
# launches of each op per reconstruct / features forward on the main path
PER_RECONSTRUCT = {"attn_half_block": 30, "mlp_block": 33,
                   "xattn_half_block": 3}
PER_FEATURES = {"attn_half_block": 24, "mlp_block": 24,
                "xattn_half_block": 0}


# the port's CUDA kernels by function name -> their group in a profile
PORT_KERNELS = {"gemm_bf16_kernel": "gemm", "gemm_f32_kernel": "gemm",
                "attention_bf16_kernel": "attention",
                "attention_f32_kernel": "attention",
                "attn_bwd_dq_kernel": "attention_bwd",
                "attn_bwd_dkv_kernel": "attention_bwd",
                "attn_bwd_dq_f32_kernel": "attention_bwd",
                "attn_bwd_dkv_f32_kernel": "attention_bwd",
                "layernorm_kernel": "layernorm",
                "layernorm_bwd_kernel": "layernorm_bwd",
                "flash_fwd_bf16_kernel": "flash_attention",
                "flash_fwd_f32_kernel": "flash_attention",
                "flash_bwd_dq_kernel": "flash_attention_bwd",
                "flash_bwd_dkv_kernel": "flash_attention_bwd",
                "flash_bwd_dq_f32_kernel": "flash_attention_bwd",
                "flash_bwd_dkv_f32_kernel": "flash_attention_bwd",
                "wgrad_bf16_kernel": "wgrad", "wgrad_f32_kernel": "wgrad",
                "colsum_kernel": "wgrad", "chunk_sum_kernel": "wgrad",
                "adamw_kernel": "adamw", "fused_block_kernel": "fused_block",
                "ln_quant_kernel": "quant", "quant_rows_kernel": "quant",
                "gemm_s8_kernel": "quant"}


def log(*a):
    print(*a, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0].strip()


def cuda_ms(fn, iters=20, warmup=3, repeats=3):
    """Milliseconds per call from CUDA events around `iters` calls; the
    median of `repeats` such runs (ops of ~0.1 ms are near the host's launch
    rate, and single runs of them spread)."""
    import torch

    for _ in range(warmup):
        fn()
    runs = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        runs.append(start.elapsed_time(end) / iters)
    return sorted(runs)[len(runs) // 2]


def profile_forward(fn, top_n=0):
    """Device time of one call of `fn` by kernel group, from torch.profiler:
    {group: ms}, the device span from the first kernel's start to the last
    one's end, the share of that span with no kernel running, and the
    `top_n` kernels by device time. None if the profiler saw no device
    kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    if not spans:
        return None
    groups, by_name = {}, {}
    busy, cur_start, cur_end = 0.0, spans[0][0], spans[0][1]
    for start, end, name in spans:
        # "gemm_bf16_kernel(...)", "void attention_bf16_kernel<64>(...)"
        fname = name.split("(")[0].split("<")[0].split()[-1]
        group = PORT_KERNELS.get(fname, "torch")
        groups[group] = groups.get(group, 0.0) + (end - start) / 1e3
        key = f"{group}: {name[:90]}"
        ms, n = by_name.get(key, (0.0, 0))
        by_name[key] = (ms + (end - start) / 1e3, n + 1)
        if start > cur_end:
            busy += cur_end - cur_start
            cur_start = start
        cur_end = max(cur_end, end)
    busy += cur_end - cur_start
    span = spans[-1][1] - spans[0][0]
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top_n]
    return {"kernel_ms_by_group": groups, "device_span_ms": span / 1e3,
            "idle_share": 1 - busy / span, "kernels": len(spans),
            "top_kernels": [{"name": k, "ms": ms, "calls": n}
                            for k, (ms, n) in top]}


# ------------------------------------------------------------------ phase 1

def phase_build():
    from mirage_tpu_torch.ops import _build

    t0 = time.perf_counter()
    report = _build.build(force=True)
    log(f"[build] nvcc {len(report)} sources in "
        f"{time.perf_counter() - t0:.1f}s into {_build.BUILD_DIR}")
    for name, text in report.items():
        for line in text.splitlines():
            if "Compiling entry" in line or "Used" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")


# ------------------------------------------------------------------ phase 2

def _op_inputs(op, shape, dtype, gen):
    """Random bf16/f32 operands at an op's shape, weights scaled so every
    activation stays O(1)."""
    import torch

    def rn(*s, scale=1.0):
        return (torch.randn(*s, generator=gen) * scale).to(dtype).cuda()

    if op == "xattn_half_block":
        b, nq, nc, d, h = shape
        return (rn(b, nq, d), rn(b, nc, d), 1 + rn(d, scale=0.1),
                rn(d, scale=0.02), 1 + rn(d, scale=0.1), rn(d, scale=0.02),
                rn(d, d, scale=d ** -0.5), rn(d, scale=0.02),
                rn(2 * d, d, scale=d ** -0.5), rn(2 * d, scale=0.02),
                rn(d, d, scale=d ** -0.5), rn(d, scale=0.02), h)
    b, n, d = shape[:3]
    if op == "attn_half_block":
        h = shape[3]
        return (rn(b, n, d), 1 + rn(d, scale=0.1), rn(d, scale=0.02),
                rn(3 * d, d, scale=d ** -0.5), rn(3 * d, scale=0.02),
                rn(d, d, scale=d ** -0.5), rn(d, scale=0.02), h)
    return (rn(b, n, d), 1 + rn(d, scale=0.1), rn(d, scale=0.02),
            rn(4 * d, d, scale=d ** -0.5), rn(4 * d, scale=0.02),
            rn(d, 4 * d, scale=(4 * d) ** -0.5), rn(d, scale=0.02))


def _work(op, shape, elem_bytes):
    """(FLOPs, bytes) one call needs: each input read once, the output
    written once."""
    if op == "xattn_half_block":
        b, nq, nc, d, _ = shape
        flops = 2 * b * nq * d * d * 2 + 2 * b * nc * d * 2 * d \
            + 4 * b * nq * nc * d
        elems = 2 * b * nq * d + b * nc * d + 4 * d * d + 4 * d + 4 * d \
            + 4 * d
        return flops, elems * elem_bytes
    b, n, d = shape[:3]
    m = b * n
    if op == "attn_half_block":
        flops = 2 * m * d * 4 * d + 4 * b * n * n * d
        elems = 2 * m * d + 4 * d * d + 6 * d
    else:
        flops = 2 * m * d * 8 * d
        elems = 2 * m * d + 8 * d * d + 7 * d
    return flops, elems * elem_bytes


def _library(op):
    """The same function composed from PyTorch library calls (F.layer_norm,
    F.linear, F.gelu, F.scaled_dot_product_attention): a timing yardstick
    only, never called by the port."""
    import torch.nn.functional as F

    def ln(x, w, b):
        return F.layer_norm(x, (x.shape[-1],), w, b, 1e-6)

    def heads(t, h):
        b, n, c = t.shape
        return t.view(b, n, h, c // h).transpose(1, 2)

    def merge(t):
        b, h, n, dh = t.shape
        return t.transpose(1, 2).reshape(b, n, h * dh)

    if op == "attn_half_block":
        def fn(x, lw, lb, wqkv, bqkv, wp, bp, h):
            q, k, v = F.linear(ln(x, lw, lb), wqkv, bqkv).chunk(3, dim=-1)
            o = F.scaled_dot_product_attention(heads(q, h), heads(k, h),
                                               heads(v, h))
            return x + F.linear(merge(o), wp, bp)
    elif op == "xattn_half_block":
        def fn(x, c, qw, qb, cw, cb, wq, bq, wkv, bkv, wp, bp, h,
               residual=True):
            q = F.linear(ln(x, qw, qb), wq, bq)
            k, v = F.linear(ln(c, cw, cb), wkv, bkv).chunk(2, dim=-1)
            o = F.scaled_dot_product_attention(heads(q, h), heads(k, h),
                                               heads(v, h))
            out = F.linear(merge(o), wp, bp)
            return x + out if residual else out
    else:
        def fn(x, lw, lb, w1, b1, w2, b2, residual=True):
            h = F.linear(F.gelu(F.linear(ln(x, lw, lb), w1, b1)), w2, b2)
            return x + h if residual else h
    return fn


def phase_kernels():
    import torch

    from mirage_tpu_torch.ops import runtime
    from mirage_tpu_torch.ops.block_attention import (
        attn_half_block, attn_half_block_ref, xattn_half_block,
        xattn_half_block_ref)
    from mirage_tpu_torch.ops.fused_mlp import mlp_block, mlp_block_ref

    ops = {"attn_half_block": (attn_half_block, attn_half_block_ref),
           "mlp_block": (mlp_block, mlp_block_ref),
           "xattn_half_block": (xattn_half_block, xattn_half_block_ref)}
    # (op, label, shape, extra kwargs, calls per reconstruct forward)
    cases = [
        ("attn_half_block", "encoder", (BATCH, 257, 1024, 16), {}, 24),
        ("attn_half_block", "decoder", (BATCH, 256, 256, 8), {}, 6),
        ("mlp_block", "encoder", (BATCH, 257, 1024), {}, 24),
        ("mlp_block", "decoder", (BATCH, 256, 256), {}, 9),
        ("mlp_block", "encoder residual=False", (BATCH, 257, 1024),
         {"residual": False}, 0),
        ("mlp_block", "decoder residual=False", (BATCH, 256, 256),
         {"residual": False}, 0),
        # the decoder calls B3 without the skip-add (reference semantics)
        ("xattn_half_block", "decoder residual=False",
         (BATCH, 256, 257, 256, 8), {"residual": False}, 3),
        ("xattn_half_block", "decoder", (BATCH, 256, 257, 256, 8), {}, 0),
    ]
    gen = torch.Generator().manual_seed(SEED)
    results = {}
    for op, label, shape, kw, per_fwd in cases:
        kernel, ref = ops[op]
        args = _op_inputs(op, shape, torch.bfloat16, gen)
        got = kernel(*args, **kw)
        torch.cuda.synchronize()
        with runtime.plain_on_card():
            want = ref(*[a.float() if torch.is_tensor(a) else a
                         for a in args], **kw)
        diff = (got.float() - want)
        max_abs = diff.abs().max().item()
        rel_l2 = (diff.norm() / want.norm()).item()
        ok = (max_abs <= BF16_MAX_ABS and rel_l2 <= BF16_REL_L2
              and bool(torch.isfinite(got).all()))
        kernel_ms = cuda_ms(lambda: kernel(*args, **kw))
        with runtime.plain_on_card():
            plain_ms = cuda_ms(lambda: ref(*args, **kw))
        lib = _library(op)
        library_ms = cuda_ms(lambda: lib(*args, **kw))
        flops, nbytes = _work(op, shape, 2)
        t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
        row = {"label": label, "shape": list(shape), "dtype": "bf16",
               "max_abs_err": max_abs, "rel_l2_err": rel_l2,
               "ms": kernel_ms, "plain_ms": plain_ms,
               "library_ms": library_ms, "bound_ms": max(t_ops, t_bytes),
               "bound_by": "operations" if t_ops >= t_bytes else "bytes",
               "calls_per_forward": per_fwd, **kw}
        log(f"[kernels] {op} {label} {shape}: max_abs {max_abs:.3e} "
            f"rel_l2 {rel_l2:.3e} kernel {kernel_ms:.4f} ms plain "
            f"{plain_ms:.4f} ms library {library_ms:.4f} ms bound "
            f"{row['bound_ms']:.4f} ms ({row['bound_by']})")
        if not ok:
            raise AssertionError(
                f"{op} {label}: bf16 kernel disagrees with its plain version "
                f"(max_abs {max_abs} > {BF16_MAX_ABS} or rel_l2 {rel_l2} > "
                f"{BF16_REL_L2})")
        results.setdefault(op, []).append(row)
        del args, got, want, diff

    # one float32 case per op (batch 2 of the encoder / decoder shapes)
    f32_cases = [("attn_half_block", (2, 257, 1024, 16), {}),
                 ("mlp_block", (2, 257, 1024), {}),
                 ("mlp_block", (2, 256, 256), {"residual": False}),
                 ("xattn_half_block", (2, 256, 257, 256, 8),
                  {"residual": False})]
    for op, shape, kw in f32_cases:
        kernel, ref = ops[op]
        args = _op_inputs(op, shape, torch.float32, gen)
        got = kernel(*args, **kw)
        with runtime.plain_on_card():
            want = ref(*args, **kw)
        err = (got - want).abs().max().item()
        log(f"[kernels] {op} float32 {shape} {kw}: max_abs {err:.3e}")
        if not err <= F32_ATOL:
            raise AssertionError(f"{op} float32: max_abs {err} > {F32_ATOL}")
        results[op].append({"label": "float32 check", "shape": list(shape),
                            "dtype": "f32", "max_abs_err": err, **kw})
    torch.cuda.synchronize()
    return results


# backward ops: name -> (TPU kernel file:line, launcher -> kernel, wrapper,
# sources). B6's forward is the attention kernel on the packed qkv.
BWD_KERNELS = {
    "attn_half_block_bwd": (
        "mirage_tpu/ops/block_attention.py:549",
        "_attn_half_bwd_defused :573 -> _attn_half_bwd_dx_kernel :549",
        "mirage_tpu_torch/ops/block_attention.py",
        ["layernorm.cu", "gemm.cu", "attention.cu", "attention_bwd.cu"]),
    "mlp_block_bwd": (
        "mirage_tpu/ops/fused_mlp.py:453",
        "_mlp_block_bwd_defused :469 -> _mlp_bwd_dx_kernel :453",
        "mirage_tpu_torch/ops/fused_mlp.py", ["layernorm.cu", "gemm.cu"]),
    "block_attention": (
        "mirage_tpu/ops/block_attention.py:58",
        "_block_attn_fwd :88 -> _block_attn_kernel :58",
        "mirage_tpu_torch/ops/block_attention.py", ["attention.cu"]),
    "block_attention_bwd": (
        "mirage_tpu/ops/block_attention.py:111",
        "_block_attn_bwd :169 -> _block_attn_bwd_kernel :111",
        "mirage_tpu_torch/ops/block_attention.py", ["attention_bwd.cu"]),
}
# launches of each op per pretraining step (ViT-B: 12 encoder layers at 99
# tokens; three decoders of two 256-token blocks)
PER_STEP = {"attn_half_block": 12, "attn_half_block_bwd": 12,
            "mlp_block": 18, "mlp_block_bwd": 18, "block_attention": 6,
            "block_attention_bwd": 6, "xattn_half_block": 0,
            "attn_half_block_acc_bwd": 0, "mlp_block_acc_bwd": 0,
            "fused_adamw": 0}
# the same step with the JAX package's three switches on
# (MIRAGE_OPT_KERNEL=on, MIRAGE_MLP_BWD=accumulate,
# MIRAGE_ATTN_BWD=accumulate): both halves' backwards take B7, the update B11
SWITCHES_ON = {"MIRAGE_OPT_KERNEL": "on", "MIRAGE_MLP_BWD": "accumulate",
               "MIRAGE_ATTN_BWD": "accumulate"}
PER_STEP_ON = {**PER_STEP, "attn_half_block_bwd": 0, "mlp_block_bwd": 0,
               "attn_half_block_acc_bwd": 12, "mlp_block_acc_bwd": 18,
               "fused_adamw": 1}
# a backward output against its float32 plain version: relative L2 error,
# and the largest element error relative to the output's largest element
# (outputs range from O(1) (dx) to O(1e3) (weight grads summed over 25k-65k
# rows); bf16 intermediates carry 2^-8 relative steps)
BWD_REL_L2, BWD_REL_MAX = 1e-2, 5e-2


def _bwd_inputs(op, shape, dtype, gen):
    """(args, cotangent) of a backward op at its shape."""
    import torch

    def rn(*s, scale=1.0):
        return (torch.randn(*s, generator=gen) * scale).to(dtype).cuda()

    if op.startswith("block_attention"):
        b, n, d, h = shape
        return (rn(b, n, 3 * d), h, (d // h) ** -0.5), rn(b, n, d)
    base = "attn_half_block" if op.startswith("attn") else "mlp_block"
    args = _op_inputs(base, shape, dtype, gen)
    return args, rn(*shape[:3])


def _bwd_work(op, shape, elem_bytes):
    """(FLOPs, bytes) of a backward op: the forward it recomputes and the
    backward products, each input read once and each output written once
    (weight grads in float)."""
    b, n, d = shape[:3]
    m = b * n
    if op == "block_attention":
        return 4 * b * n * n * d, 4 * m * d * elem_bytes
    if op == "block_attention_bwd":
        return 10 * b * n * n * d, 7 * m * d * elem_bytes
    if op == "attn_half_block_bwd":
        flops = 22 * m * d * d + 12 * b * n * n * d
        return flops, (3 * m * d + 4 * d * d) * elem_bytes + (4 * d * d + 8 * d) * 4
    flops = 40 * m * d * d
    return flops, (3 * m * d + 8 * d * d) * elem_bytes + (8 * d * d + 7 * d) * 4


def _bwd_library(op):
    """The same function from PyTorch library calls (F.layer_norm, F.linear,
    F.gelu, F.scaled_dot_product_attention and torch.autograd.grad): the
    forward it recomputes and its backward. A yardstick only."""
    import torch
    import torch.nn.functional as F

    def heads(t, h):
        b, n, c = t.shape
        return t.view(b, n, h, c // h).transpose(1, 2)

    if op == "block_attention":
        def fn(qkv, h, scale):
            q, k, v = qkv.chunk(3, dim=-1)
            o = F.scaled_dot_product_attention(heads(q, h), heads(k, h),
                                               heads(v, h), scale=scale)
            return o.transpose(1, 2).flatten(2)
        return fn
    if op == "block_attention_bwd":
        fwd = _bwd_library("block_attention")

        def fn(dy, qkv, h, scale):
            qkv = qkv.detach().requires_grad_()
            return torch.autograd.grad(fwd(qkv, h, scale), qkv, dy)
        return fn
    fwd = _library("attn_half_block" if op.startswith("attn")
                   else "mlp_block")

    def fn(dy, *args, **kw):
        args = [a.detach().requires_grad_() if torch.is_tensor(a) else a
                for a in args]
        return torch.autograd.grad(fwd(*args, **kw),
                                   [a for a in args if torch.is_tensor(a)],
                                   dy)
    return fn


def phase_backward(results):
    """Each backward op (and B6's forward) at the pretraining shapes against
    its plain version computed in float32 from the same inputs; every output
    compared. Adds rows to ``results``."""
    import torch

    from mirage_tpu_torch.ops import block_attention as ba
    from mirage_tpu_torch.ops import fused_mlp as fm
    from mirage_tpu_torch.ops import runtime

    def b4(args, dy):
        return ba._attn_half_bwd(args[0], dy, *args[1:6], args[7])

    def b4_ref(args, dy):
        return ba.attn_half_block_bwd_ref(args[0], dy, *args[1:6], args[7])

    def b5(args, dy, **kw):
        return fm._mlp_bwd(args[0], dy, *args[1:6], **kw)

    def b5_ref(args, dy, **kw):
        return fm.mlp_block_bwd_ref(args[0], dy, *args[1:6], **kw)

    def b6f(args, dy):
        return (ba.block_attention(*args),)

    def b6f_ref(args, dy):
        return (ba.block_attention_ref(*args),)

    def b6(args, dy):
        return (ba._block_attn_bwd(args[0], dy, *args[1:]),)

    def b6_ref(args, dy):
        return (ba.block_attention_bwd_ref(args[0], dy, *args[1:]),)

    ops = {"attn_half_block_bwd": (b4, b4_ref),
           "mlp_block_bwd": (b5, b5_ref),
           "block_attention": (b6f, b6f_ref),
           "block_attention_bwd": (b6, b6_ref)}
    names = {"attn_half_block_bwd": ["dx", "dgamma", "dbeta", "dwqkv",
                                     "dbqkv", "dwproj", "dbproj"],
             "mlp_block_bwd": ["dx", "dgamma", "dbeta", "dw1", "db1", "dw2",
                               "db2"],
             "block_attention": ["out"], "block_attention_bwd": ["dqkv"]}
    # (op, label, shape, kwargs, calls per pretraining step)
    cases = [
        ("attn_half_block_bwd", "encoder", (256, 99, 768, 12), {}, 12),
        ("mlp_block_bwd", "encoder", (256, 99, 768), {}, 12),
        ("mlp_block_bwd", "decoder", (256, 256, 256), {}, 6),
        ("mlp_block_bwd", "encoder residual=False", (256, 99, 768),
         {"residual": False}, 0),
        ("mlp_block_bwd", "decoder residual=False", (256, 256, 256),
         {"residual": False}, 0),
        ("block_attention", "decoder", (256, 256, 256, 8), {}, 6),
        ("block_attention_bwd", "decoder", (256, 256, 256, 8), {}, 6),
    ]
    gen = torch.Generator().manual_seed(SEED + 1)
    for op, label, shape, kw, per_step in cases:
        kernel, ref = ops[op]
        args, dy = _bwd_inputs(op, shape, torch.bfloat16, gen)
        got = kernel(args, dy, **kw)
        torch.cuda.synchronize()
        with runtime.plain_on_card():
            want = ref([a.float() if torch.is_tensor(a) else a
                        for a in args], dy.float(), **kw)
        errs = {}
        for name, g, w in zip(names[op], got, want):
            if w is None:
                continue
            diff = g.float() - w
            errs[name] = {
                "max_abs": diff.abs().max().item(),
                "rel_max": (diff.abs().max() / w.abs().max()).item(),
                "rel_l2": (diff.norm() / w.norm()).item()}
            if not (bool(torch.isfinite(g).all())
                    and errs[name]["rel_l2"] <= BWD_REL_L2
                    and errs[name]["rel_max"] <= BWD_REL_MAX):
                raise AssertionError(
                    f"{op} {label} {name}: kernel disagrees with its plain "
                    f"version: {errs[name]} (bars rel_l2 {BWD_REL_L2}, "
                    f"rel_max {BWD_REL_MAX})")
        del got, want
        kernel_ms = cuda_ms(lambda: kernel(args, dy, **kw), iters=10)
        with runtime.plain_on_card():
            plain_ms = cuda_ms(lambda: ref(args, dy, **kw), iters=5)
        lib = _bwd_library(op)
        if op == "block_attention":
            library_ms = cuda_ms(lambda: lib(*args), iters=10)
        else:
            library_ms = cuda_ms(lambda: lib(dy, *args, **kw), iters=10)
        flops, nbytes = _bwd_work(op, shape, 2)
        t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
        row = {"label": label, "shape": list(shape), "dtype": "bf16",
               "errors": errs,
               "max_abs_err": max(e["max_abs"] for e in errs.values()),
               "ms": kernel_ms, "plain_ms": plain_ms,
               "library_ms": library_ms, "bound_ms": max(t_ops, t_bytes),
               "bound_by": "operations" if t_ops >= t_bytes else "bytes",
               "calls_per_step": per_step, **kw}
        log(f"[kernels] {op} {label} {shape}: worst rel_l2 "
            f"{max(e['rel_l2'] for e in errs.values()):.3e} rel_max "
            f"{max(e['rel_max'] for e in errs.values()):.3e} kernel "
            f"{kernel_ms:.4f} ms plain {plain_ms:.4f} ms library "
            f"{library_ms:.4f} ms bound {row['bound_ms']:.4f} ms "
            f"({row['bound_by']})")
        results.setdefault(op, []).append(row)
        del args, dy

    # one float32 case per op (batch 2 of the pretraining shapes)
    f32_cases = [("attn_half_block_bwd", (2, 99, 768, 12), {}),
                 ("mlp_block_bwd", (2, 99, 768), {}),
                 ("mlp_block_bwd", (2, 256, 256), {"residual": False}),
                 ("block_attention", (2, 256, 256, 8), {}),
                 ("block_attention_bwd", (2, 256, 256, 8), {})]
    for op, shape, kw in f32_cases:
        kernel, ref = ops[op]
        args, dy = _bwd_inputs(op, shape, torch.float32, gen)
        got = kernel(args, dy, **kw)
        with runtime.plain_on_card():
            want = ref(args, dy, **kw)
        err = max((g - w).abs().max().item()
                  for g, w in zip(got, want) if w is not None)
        log(f"[kernels] {op} float32 {shape} {kw}: max_abs {err:.3e}")
        if not err <= F32_ATOL:
            raise AssertionError(f"{op} float32: max_abs {err} > {F32_ATOL}")
        results[op].append({"label": "float32 check", "shape": list(shape),
                            "dtype": "f32", "max_abs_err": err, **kw})
    torch.cuda.synchronize()
    return results


# segmentation's kernels: name -> (TPU kernel file:line, launcher -> kernel,
# wrapper, sources)
SEG_KERNELS = {
    "flash_attention": (
        "mirage_tpu/ops/flash_attention.py:42",
        "_flash_fwd :82 -> _attn_kernel :42",
        "mirage_tpu_torch/ops/flash_attention.py", ["flash_attention.cu"]),
    "flash_attention_bwd": (
        "mirage_tpu/ops/flash_attention.py:115",
        "_flash_bwd :175 -> _attn_bwd_kernel :115",
        "mirage_tpu_torch/ops/flash_attention.py", ["flash_attention.cu"]),
    "mlp_block_stash": (
        "mirage_tpu/ops/fused_mlp.py:555",
        "_mlp_block_fwd_stash :591 -> _mlp_fwd_stash_kernel :555",
        "mirage_tpu_torch/ops/fused_mlp.py", ["layernorm.cu", "gemm.cu"]),
    "mlp_block_stash_bwd": (
        "mirage_tpu/ops/fused_mlp.py:687",
        "_mlp_block_bwd_stash :736 -> _mlp_bwd_stash_kernel :687",
        "mirage_tpu_torch/ops/fused_mlp.py",
        ["layernorm.cu", "gemm.cu", "wgrad.cu"]),
}


def _flash_inputs(shape, dtype, gen):
    """(q_src, kv_src or None, heads, scale), cotangent: the packed qkv of a
    self-attention (b, h, n, dh) or the queries and packed kv of a
    cross-attention (b, h, nq, nk, dh)."""
    import torch

    def rn(*s):
        return torch.randn(*s, generator=gen).to(dtype).cuda()

    if len(shape) == 4:
        b, h, n, dh = shape
        return (rn(b, n, 3 * h * dh), None, h, dh ** -0.5), rn(b, n, h * dh)
    b, h, nq, nk, dh = shape
    return ((rn(b, nq, h * dh), rn(b, nk, 2 * h * dh), h, dh ** -0.5),
            rn(b, nq, h * dh))


def _flash_work(shape, elem_bytes, backward):
    """(FLOPs, bytes) at (b, h, nq, nk, dh): 4·B·H·Nq·Nk·dh forward, 10·
    backward; q, k, v (and dO) read once, out (dq, dk, dv) written once,
    the float lse."""
    b, h, nq, nk, dh = shape
    if not backward:
        return 4 * b * h * nq * nk * dh, \
            (2 * nq + 2 * nk) * b * h * dh * elem_bytes + 4 * b * h * nq
    return 10 * b * h * nq * nk * dh, \
        (3 * nq + 4 * nk) * b * h * dh * elem_bytes + 4 * b * h * nq


def _flash_library(backward):
    """F.scaled_dot_product_attention on the same packed inputs (and its
    autograd backward): a yardstick only."""
    import torch
    import torch.nn.functional as F

    def heads(t, h):
        b, n, c = t.shape
        return t.view(b, n, h, c // h).transpose(1, 2)

    def fwd(q_src, kv_src, h, scale):
        if kv_src is None:
            q, k, v = q_src.chunk(3, dim=-1)
        else:
            q, (k, v) = q_src, kv_src.chunk(2, dim=-1)
        o = F.scaled_dot_product_attention(heads(q, h), heads(k, h),
                                           heads(v, h), scale=scale)
        return o.transpose(1, 2).flatten(2)

    if not backward:
        return fwd

    def bwd(dy, q_src, kv_src, h, scale):
        srcs = [t.detach().requires_grad_() for t in (q_src, kv_src)
                if t is not None]
        out = fwd(srcs[0], srcs[1] if len(srcs) > 1 else None, h, scale)
        return torch.autograd.grad(out, srcs, dy)
    return bwd


def _stash_work(m, d, elem_bytes, backward):
    """(FLOPs, bytes) of the stash pair at (m, d) -> 4d: two products
    forward, four backward; x (dy, act, dg) read and out, act, dg (dx and
    the float parameter grads) written once."""
    hd = 4 * d
    if not backward:
        return 4 * m * d * hd, (2 * m * d + 2 * m * hd + 2 * d * hd) \
            * elem_bytes + 7 * d * 4
    return 8 * m * d * hd, (3 * m * d + 2 * m * hd + 2 * d * hd) \
        * elem_bytes + (2 * d * hd + hd + 3 * d) * 4


def phase_seg_kernels(results):
    """B8 (flash attention) and B9 (the stash MLP pair) at the
    segmentation shapes and B8 at the three-modality cross-attention shape,
    forward and backward, against their plain versions in float32 from the
    same bf16 inputs; float32 checks at smaller shapes. Adds rows to
    ``results``."""
    import torch

    from mirage_tpu_torch.ops import flash_attention as fa
    from mirage_tpu_torch.ops import fused_mlp as fm
    from mirage_tpu_torch.ops import runtime

    gen = torch.Generator().manual_seed(SEED + 2)

    def check(name, label, got, want, fwd, f32=False):
        errs = {}
        for key, g, w in zip(name, got, want):
            diff = g.float() - w.float()
            errs[key] = {"max_abs": diff.abs().max().item(),
                         "rel_max": (diff.abs().max()
                                     / w.abs().max()).item(),
                         "rel_l2": (diff.norm() / w.norm()).item()}
            e = errs[key]
            if f32:
                ok = e["max_abs"] <= F32_ATOL * max(1.0, w.abs().max().item())
            elif fwd:
                ok = e["max_abs"] <= BF16_MAX_ABS and \
                    e["rel_l2"] <= BF16_REL_L2
            else:
                ok = e["rel_l2"] <= BWD_REL_L2 and e["rel_max"] <= BWD_REL_MAX
            if not (ok and bool(torch.isfinite(g).all())):
                raise AssertionError(f"{label} {key}: kernel disagrees with "
                                     f"its plain version: {e}")
        return errs

    def row(label, shape, errs, kernel_ms, plain_ms, library_ms, work,
            per_step, **extra):
        flops, nbytes = work
        t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
        r = {"label": label, "shape": list(shape), "dtype": "bf16",
             "errors": errs,
             "max_abs_err": max(e["max_abs"] for e in errs.values()),
             "ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms,
             "bound_ms": max(t_ops, t_bytes),
             "bound_by": "operations" if t_ops >= t_bytes else "bytes",
             "calls_per_step": per_step, **extra}
        log(f"[kernels] {label} {shape}: worst rel_l2 "
            f"{max(e['rel_l2'] for e in errs.values()):.3e} max_abs "
            f"{r['max_abs_err']:.3e} kernel {kernel_ms:.4f} ms plain "
            f"{plain_ms:.4f} ms library {library_ms:.4f} ms bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']})")
        return r

    # B8: (label, shape, calls per seg train step)
    for label, shape, per_step in [
            ("encoder self-attention", (4, 12, 1025, 64), 12),
            ("decoder cross-attention", (64, 8, 256, 769, 32), 0)]:
        (q_src, kv_src, h, scale), dy = _flash_inputs(shape, torch.bfloat16,
                                                      gen)
        out, lse = fa._flash_fwd(q_src, kv_src, h, scale)
        grads = fa._flash_bwd(q_src, kv_src, lse, dy, h, scale)
        torch.cuda.synchronize()
        f32 = [t.float() if t is not None else None for t in (q_src, kv_src)]
        with runtime.plain_on_card():
            want = fa._flash_fwd(f32[0], f32[1], h, scale)[0]
            want_g = fa._flash_bwd(f32[0], f32[1], None, dy.float(), h, scale)
        names = ["dqkv"] if kv_src is None else ["dq", "dkv"]
        errs_f = check(["out"], f"flash_attention {label}", [out], [want],
                       True)
        errs_b = check(names, f"flash_attention_bwd {label}",
                       [g for g in grads if g is not None],
                       [w for w in want_g if w is not None], False)
        del out, grads, want, want_g, f32
        k_f = cuda_ms(lambda: fa._flash_fwd(q_src, kv_src, h, scale), iters=10)
        k_b = cuda_ms(lambda: fa._flash_bwd(q_src, kv_src, lse, dy, h, scale),
                      iters=10)
        with runtime.plain_on_card():
            p_f = cuda_ms(lambda: fa._flash_fwd(q_src, kv_src, h, scale),
                          iters=3)
            p_b = cuda_ms(lambda: fa._flash_bwd(q_src, kv_src, None, dy, h,
                                                scale), iters=3)
        lib_f, lib_b = _flash_library(False), _flash_library(True)
        l_f = cuda_ms(lambda: lib_f(q_src, kv_src, h, scale), iters=10)
        l_b = cuda_ms(lambda: lib_b(dy, q_src, kv_src, h, scale), iters=10)
        shape5 = shape if len(shape) == 5 else shape[:3] + shape[2:]
        results.setdefault("flash_attention", []).append(
            row(f"flash_attention {label}", shape, errs_f, k_f, p_f, l_f,
                _flash_work(shape5, 2, False), per_step))
        results.setdefault("flash_attention_bwd", []).append(
            row(f"flash_attention_bwd {label}", shape, errs_b, k_b, p_b, l_b,
                _flash_work(shape5, 2, True), per_step))
        del q_src, kv_src, dy, lse

    # B9 at the ConvNeXt head's rows: 4 per seg train step
    m, d = 65536, 384
    args = _op_inputs("mlp_block", (1, m, d), torch.bfloat16, gen)
    x2 = args[0].view(m, d)
    prm = args[1:]
    dy = (torch.randn(m, d, generator=gen)).to(torch.bfloat16).cuda()
    if fm.stash_route(x2, 4 * d) != "2d":
        raise AssertionError("the stash route refuses the seg head's shape")
    out, act, dg = fm._mlp_fwd_stash(x2, *prm)
    grads = fm._mlp_bwd_stash(x2, dy, act, dg, prm[0], prm[1], prm[2], prm[4])
    torch.cuda.synchronize()
    with runtime.plain_on_card():
        pf = [a.float() for a in prm]
        want = fm.mlp_block_fwd_stash_ref(x2.float(), *pf)
        want_g = fm.mlp_block_bwd_stash_ref(
            x2.float(), dy.float(), act.float(), dg.float(), pf[0], pf[1],
            pf[2], pf[4])
    errs_f = check(["out", "act", "dgelu"], "mlp_block_stash",
                   [out, act, dg], want, True)
    errs_b = check(["dx", "dgamma", "dbeta", "dw1", "db1", "dw2", "db2"],
                   "mlp_block_stash_bwd", grads, want_g, False)
    del grads, want, want_g, pf
    k_f = cuda_ms(lambda: fm._mlp_fwd_stash(x2, *prm), iters=10)
    k_b = cuda_ms(lambda: fm._mlp_bwd_stash(x2, dy, act, dg, prm[0], prm[1],
                                            prm[2], prm[4]), iters=10)
    with runtime.plain_on_card():
        p_f = cuda_ms(lambda: fm._mlp_fwd_stash(x2, *prm), iters=3)
        p_b = cuda_ms(lambda: fm._mlp_bwd_stash(x2, dy, act, dg, prm[0],
                                                prm[1], prm[2], prm[4]),
                      iters=3)
    lib_f, lib_b = _library("mlp_block"), _bwd_library("mlp_block_bwd")
    l_f = cuda_ms(lambda: lib_f(x2, *prm), iters=10)
    l_b = cuda_ms(lambda: lib_b(dy, x2, *prm), iters=10)
    results.setdefault("mlp_block_stash", []).append(
        row("mlp_block_stash ConvNeXt head", (m, d, 4 * d), errs_f, k_f, p_f,
            l_f, _stash_work(m, d, 2, False), 4))
    results.setdefault("mlp_block_stash_bwd", []).append(
        row("mlp_block_stash_bwd ConvNeXt head", (m, d, 4 * d), errs_b, k_b,
            p_b, l_b, _stash_work(m, d, 2, True), 4))
    del args, x2, prm, dy, out, act, dg

    # float32: B8 self and cross, B9 at 2048 rows
    for shape in [(1, 2, 1025, 64), (2, 2, 256, 600, 32)]:
        (q_src, kv_src, h, scale), dy = _flash_inputs(shape, torch.float32,
                                                      gen)
        out, lse = fa._flash_fwd(q_src, kv_src, h, scale)
        grads = [g for g in fa._flash_bwd(q_src, kv_src, lse, dy, h, scale)
                 if g is not None]
        with runtime.plain_on_card():
            want = fa._flash_fwd(q_src, kv_src, h, scale)[0]
            want_g = [g for g in fa._flash_bwd(q_src, kv_src, None, dy, h,
                                               scale) if g is not None]
        errs = check(["out"] + [f"grad{i}" for i in range(len(grads))],
                     f"flash_attention float32 {shape}", [out] + grads,
                     [want] + want_g, True, f32=True)
        err = max(e["max_abs"] for e in errs.values())
        log(f"[kernels] flash_attention float32 {shape}: max_abs {err:.3e}")
        results["flash_attention"].append(
            {"label": "float32 check", "shape": list(shape), "dtype": "f32",
             "max_abs_err": err})
    args = _op_inputs("mlp_block", (1, 2048, 384), torch.float32, gen)
    x2, prm = args[0].view(2048, 384), args[1:]
    dy = torch.randn(2048, 384, generator=gen).cuda()
    got = fm._mlp_fwd_stash(x2, *prm)
    got_g = fm._mlp_bwd_stash(x2, dy, got[1], got[2], prm[0], prm[1], prm[2],
                              prm[4])
    with runtime.plain_on_card():
        want = fm.mlp_block_fwd_stash_ref(x2, *prm)
        want_g = fm.mlp_block_bwd_stash_ref(x2, dy, got[1], got[2], prm[0],
                                            prm[1], prm[2], prm[4])
    errs = check([f"out{i}" for i in range(10)], "mlp_block_stash float32",
                 list(got) + list(got_g), list(want) + list(want_g), True,
                 f32=True)
    err = max(e["max_abs"] for e in errs.values())
    log(f"[kernels] mlp_block_stash float32 (2048, 384): max_abs {err:.3e}")
    results["mlp_block_stash"].append(
        {"label": "float32 check", "shape": [2048, 384, 1536],
         "dtype": "f32", "max_abs_err": err})
    torch.cuda.synchronize()
    return results


# the accumulating backwards (B7) and the fused AdamW update (B11): name ->
# (TPU kernel file:line, launcher -> kernel, wrapper, sources)
ACC_KERNELS = {
    "attn_half_block_acc_bwd": (
        "mirage_tpu/ops/block_attention.py:457",
        "_attn_half_bwd_pallas :502 -> _attn_half_bwd_kernel :457",
        "mirage_tpu_torch/ops/block_attention.py",
        ["layernorm.cu", "gemm.cu", "attention.cu", "attention_bwd.cu",
         "wgrad.cu"]),
    "mlp_block_acc_bwd": (
        "mirage_tpu/ops/fused_mlp.py:240",
        "_mlp_block_bwd_pallas :311 -> _mlp_bwd_kernel :240",
        "mirage_tpu_torch/ops/fused_mlp.py",
        ["layernorm.cu", "gemm.cu", "wgrad.cu"]),
    "fused_adamw": (
        "mirage_tpu/ops/fused_adamw.py:111",
        "fused_adamw_leaf :133 -> _adamw_kernel :111",
        "mirage_tpu_torch/ops/fused_adamw.py", ["adamw.cu"]),
}
B11_RTOL, B11_ATOL = 1e-6, 1e-7


def _cls_leaves(gen):
    """The float32 leaves B11 takes in the classification full fine-tune
    (MIRAGE-Base, one 512² B-scan at patch 32, seeded): every trainable
    weight of at least 1 << 17 elements, by the port's own rule."""
    import torch

    from mirage_tpu_torch.api.wrapper import build_model
    from mirage_tpu_torch.ops import fused_adamw as fa
    from mirage_tpu_torch.ops import runtime

    model = build_model("miragepre_base", {}, ["bscan"], 512, 32,
                        with_outputs=False, generator=gen)
    with runtime.switched({"MIRAGE_OPT_KERNEL": "on"}):
        return [p.detach().cuda() for n, p in model.named_parameters()
                if "pos_emb" not in n and fa.leaf_update_viable(p, 1.0)]


def phase_acc_kernels():
    """B7's two halves at the classification and pretraining shapes and
    B11 over the classification leaves, each against its plain version
    (float32 from the same bf16 inputs for B7, the same float32 state for
    B11), with reruns compared bit for bit. Returns (rows of the
    pretraining path, rows of the classification path)."""
    import torch

    from mirage_tpu_torch.ops import block_attention as ba
    from mirage_tpu_torch.ops import fused_adamw as fa
    from mirage_tpu_torch.ops import fused_mlp as fm
    from mirage_tpu_torch.ops import runtime

    gen = torch.Generator().manual_seed(SEED + 3)

    def b7a(args, dy):
        return ba._attn_half_bwd_acc(args[0], dy, *args[1:6], args[7])

    def b7a_ref(args, dy):
        return ba.attn_half_block_bwd_acc_ref(args[0], dy, *args[1:6],
                                              args[7])

    def b7m(args, dy):
        return fm._mlp_bwd_acc(args[0], dy, *args[1:6])

    def b7m_ref(args, dy):
        return fm.mlp_block_bwd_acc_ref(args[0], dy, *args[1:6])

    ops = {"attn_half_block_acc_bwd": (b7a, b7a_ref, "attn_half_block_bwd",
                                       ["dx", "dgamma", "dbeta", "dwqkv",
                                        "dbqkv", "dwproj", "dbproj"]),
           "mlp_block_acc_bwd": (b7m, b7m_ref, "mlp_block_bwd",
                                 ["dx", "dgamma", "dbeta", "dw1", "db1",
                                  "dw2", "db2"])}
    # (op, label, shape, calls per step of its path, path, launches per
    # pretraining step)
    cases = [
        ("attn_half_block_acc_bwd", "pretraining encoder", (256, 99, 768, 12),
         12, "pretrain"),
        ("mlp_block_acc_bwd", "classification encoder", (BATCH, 257, 768),
         12, "cls"),
        ("mlp_block_acc_bwd", "pretraining encoder", (256, 99, 768), 0,
         "cls"),
        ("mlp_block_acc_bwd", "pretraining decoder", (256, 256, 256), 0,
         "cls"),
    ]
    rows = {"pretrain": {}, "cls": {}}
    for op, label, shape, per_step, path in cases:
        kernel, ref, base, names = ops[op]
        args, dy = _bwd_inputs(base, shape, torch.bfloat16, gen)
        got = kernel(args, dy)
        again = kernel(args, dy)
        torch.cuda.synchronize()
        rerun_equal = all(torch.equal(a, b) for a, b in zip(got, again)
                          if a is not None)
        if not rerun_equal:
            raise AssertionError(f"{op} {label}: a rerun is not bit-identical")
        del again
        with runtime.plain_on_card():
            want = ref([a.float() if torch.is_tensor(a) else a
                        for a in args], dy.float())
        errs = {}
        for name, g, w in zip(names, got, want):
            diff = g.float() - w
            errs[name] = {"max_abs": diff.abs().max().item(),
                          "rel_max": (diff.abs().max() / w.abs().max()).item(),
                          "rel_l2": (diff.norm() / w.norm()).item()}
            if not (bool(torch.isfinite(g).all())
                    and errs[name]["rel_l2"] <= BWD_REL_L2
                    and errs[name]["rel_max"] <= BWD_REL_MAX):
                raise AssertionError(
                    f"{op} {label} {name}: kernel disagrees with its plain "
                    f"version: {errs[name]} (bars rel_l2 {BWD_REL_L2}, "
                    f"rel_max {BWD_REL_MAX})")
        del got, want
        kernel_ms = cuda_ms(lambda: kernel(args, dy), iters=10)
        with runtime.plain_on_card():
            plain_ms = cuda_ms(lambda: ref(args, dy), iters=5)
        lib = _bwd_library(base)
        library_ms = cuda_ms(lambda: lib(dy, *args), iters=10)
        flops, nbytes = _bwd_work(base, shape, 2)
        t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
        row = {"label": label, "shape": list(shape), "dtype": "bf16",
               "errors": errs, "rerun_bit_identical": rerun_equal,
               "max_abs_err": max(e["max_abs"] for e in errs.values()),
               "ms": kernel_ms, "plain_ms": plain_ms,
               "library_ms": library_ms, "bound_ms": max(t_ops, t_bytes),
               "bound_by": "operations" if t_ops >= t_bytes else "bytes",
               "calls_per_step": per_step}
        log(f"[kernels] {op} {label} {shape}: worst rel_l2 "
            f"{max(e['rel_l2'] for e in errs.values()):.3e} rel_max "
            f"{max(e['rel_max'] for e in errs.values()):.3e} kernel "
            f"{kernel_ms:.4f} ms plain {plain_ms:.4f} ms library "
            f"{library_ms:.4f} ms bound {row['bound_ms']:.4f} ms "
            f"({row['bound_by']})")
        rows[path].setdefault(op, []).append(row)
        del args, dy

    # float32 checks (batch 2 of the main shapes)
    for op, shape, path in [("attn_half_block_acc_bwd", (2, 99, 768, 12),
                             "pretrain"),
                            ("mlp_block_acc_bwd", (2, 257, 768), "cls")]:
        kernel, ref, base, _ = ops[op]
        args, dy = _bwd_inputs(base, shape, torch.float32, gen)
        got = kernel(args, dy)
        with runtime.plain_on_card():
            want = ref(args, dy)
        err = max(((g - w).abs().max() / max(1.0, w.abs().max().item())).item()
                  for g, w in zip(got, want) if w is not None)
        log(f"[kernels] {op} float32 {shape}: max_abs (relative to the "
            f"output's largest element above 1) {err:.3e}")
        if not err <= F32_ATOL:
            raise AssertionError(f"{op} float32: {err} > {F32_ATOL}")
        rows[path][op].append({"label": "float32 check", "shape": list(shape),
                               "dtype": "f32", "max_abs_err": err})

    # B11 over the classification leaves: gscale < 1, the count of step 3
    leaves = _cls_leaves(torch.Generator().manual_seed(SEED))
    numel = sum(p.numel() for p in leaves)

    def state(scale):
        g = [torch.randn(p.shape, generator=gen).cuda() * scale
             for p in leaves]
        m = [torch.randn(p.shape, generator=gen).cuda() * 1e-3
             for p in leaves]
        n = [torch.rand(p.shape, generator=gen).cuda() * 1e-6
             for p in leaves]
        return g, m, n, [p.clone() for p in leaves]

    g, m, n, ps = state(1e-3)
    count = torch.tensor(3.0, device="cuda")
    b1, b2, eps = 0.9, 0.999, 1e-8
    kw = dict(gscale=torch.tensor(0.5, device="cuda"),
              c1=1 - torch.pow(b1, count), c2=1 - torch.pow(b2, count),
              keep=torch.tensor(1.0, device="cuda"), b1=b1, b2=b2, eps=eps)
    lrs, wds = [1e-5] * len(ps), [1e-2] * len(ps)

    def run(keep=None, plain=False):
        mm, nn_, pp = ([t.clone() for t in ts] for ts in (m, n, ps))
        args = dict(kw, keep=keep) if keep is not None else kw
        if plain:
            with runtime.plain_on_card():
                fa.fused_adamw(g, mm, nn_, pp, lrs, wds, **args)
        else:
            fa.fused_adamw(g, mm, nn_, pp, lrs, wds, **args)
        return mm + nn_ + pp

    got, again, want = run(), run(), run(plain=True)
    torch.cuda.synchronize()
    rerun_equal = all(torch.equal(a, b) for a, b in zip(got, again))
    max_abs = max((a - b).abs().max().item() for a, b in zip(got, want))
    bad = sum(int((~torch.isclose(a, b, rtol=B11_RTOL, atol=B11_ATOL)).sum())
              for a, b in zip(got, want))
    skipped = run(keep=torch.tensor(0.0, device="cuda"))
    passthrough = all(torch.equal(a, b) for a, b in zip(skipped, m + n + ps))
    log(f"[kernels] fused_adamw {len(leaves)} leaves, {numel} params: max_abs "
        f"{max_abs:.3e}, {bad} elements outside rtol {B11_RTOL} atol "
        f"{B11_ATOL}; rerun bit-identical {rerun_equal}; keep=0 pass-through "
        f"{passthrough}")
    if bad or not rerun_equal or not passthrough:
        raise AssertionError("fused_adamw disagrees with its plain version")
    del got, again, want, skipped
    kernel_ms = cuda_ms(lambda: fa.fused_adamw(g, m, n, ps, lrs, wds, **kw),
                        iters=10)
    with runtime.plain_on_card():
        plain_ms = cuda_ms(lambda: fa.fused_adamw(g, m, n, ps, lrs, wds, **kw),
                           iters=5)
    steps = [torch.tensor(3.0, device="cuda") for _ in ps]
    library_ms = cuda_ms(lambda: torch._fused_adamw_(
        ps, g, m, n, [], steps, lr=1e-5, beta1=b1, beta2=b2,
        weight_decay=1e-2, eps=eps, amsgrad=False, maximize=False), iters=10)
    nbytes = 28 * numel
    row = {"label": "classification leaves", "shape": [len(leaves), numel],
           "dtype": "f32", "max_abs_err": max_abs,
           "rerun_bit_identical": rerun_equal,
           "keep0_bit_identical": passthrough, "ms": kernel_ms,
           "plain_ms": plain_ms, "library_ms": library_ms,
           "library": "torch._fused_adamw_ over the same leaves",
           "bound_ms": nbytes / PEAK_BYTES * 1e3, "bound_by": "bytes",
           "calls_per_step": 1}
    log(f"[kernels] fused_adamw: kernel {kernel_ms:.4f} ms plain "
        f"{plain_ms:.4f} ms library {library_ms:.4f} ms bound "
        f"{row['bound_ms']:.4f} ms (bytes)")
    rows["cls"]["fused_adamw"] = [row]
    del g, m, n, ps, leaves
    torch.cuda.synchronize()
    return rows["pretrain"], rows["cls"]


# the serving slice's kernels: name -> (TPU kernel file:line, launcher ->
# kernel, wrapper, sources)
SERVE_KERNELS = {
    "fused_block": (
        "mirage_tpu/ops/fused_block.py:47",
        "_block_fwd :95 -> _block_kernel :47",
        "mirage_tpu_torch/ops/fused_block.py", ["fused_block.cu"]),
    "mlp_block_q": (
        "mirage_tpu/ops/quant.py:95",
        "_mlp_block_q_fwd :106 -> _mlp_q_kernel :95",
        "mirage_tpu_torch/ops/quant.py", ["quant.cu"]),
    "mlp_block_fwd_stash3d": (
        "mirage_tpu/ops/fused_mlp.py:555",
        "_mlp_block_fwd_stash3d :636 -> _mlp_fwd_stash_kernel :555",
        "mirage_tpu_torch/ops/fused_mlp.py", ["layernorm.cu", "gemm.cu"]),
}
PEAK_INT8_OPS = 1979e12  # H100 SXM dense int8 tensor-core rate (data sheet)
# B12 kernel vs its plain version on the same bf16 inputs: the kernels and
# the plain version run the same float operations in the same order, but the
# LN sums in another order, so a code flips where y / scale lies within a
# few float steps (~1e-5 of a code step) of a half-integer: about 1e-5 of
# the codes (the first call measured 3.6e-7 and 9.5e-6); each flip moves one
# term of a row's product by one int8 step. Bars 1e-4 of the codes and
# rel-L2 1e-3 of the output (out = x + branch, branch ~ x).
B12_CODE_SHARE, B12_REL_L2 = 1e-4, 1e-3


def _block_work(shape, elem_bytes):
    """(FLOPs, bytes) of one whole block: 2·M·D·12D + 4·B·N²·D; x read and
    out written once, the 12D² weights and the vectors read once."""
    b, n, d = shape[:3]
    m = b * n
    return (2 * m * d * 12 * d + 4 * b * n * n * d,
            (2 * m * d + 12 * d * d + 13 * d) * elem_bytes)


def _quant_library(x, lw, lb, w1q, s1, b1, w2q, s2, b2):
    """The int8 MLP from PyTorch library calls: F.layer_norm, torch's
    rounding and clamping, torch._int_mm (cuBLASLt s8·s8 -> s32), F.gelu
    and the dequantisation. A yardstick only, never called by the port; not
    the same codes (two-pass LN, exact erf)."""
    import torch
    import torch.nn.functional as F

    def quant(v):
        r = v.abs().amax(-1, keepdim=True) / 127.0
        r = torch.where(r == 0, torch.ones_like(r), r)
        return torch.round(v / r).clamp_(-127, 127).to(torch.int8), r

    x2 = x.reshape(-1, x.shape[-1])
    yq, rs = quant(F.layer_norm(x2.float(), (x2.shape[-1],), lw, lb, 1e-6))
    h = F.gelu(torch._int_mm(yq, w1q.t()).float() * rs * s1 + b1)
    aq, as_ = quant(h)
    o = torch._int_mm(aq, w2q.t()).float() * as_ * s2 + b2
    return (x2 + o.to(x.dtype)).view(x.shape)


def phase_serve_kernels(results):
    """B10 (the one-launch whole block) at the decoder and MIRAGE-Large
    encoder shapes in bf16 and one float32 case, B12 (the int8 MLP) at the
    encoder's (64, 257, 1024) and (16384, 1024) rows with bit-identical
    reruns, and B9′ (the 3-D stash forward) at the pretraining (256, 99,
    768), out bit-equal to B2's; each against its plain version, with
    kernel, plain and library ms and the bound. Adds rows to ``results``.
    B12 and B9′ have no caller in either package: their launches are those
    of their own timed calls."""
    import torch

    from mirage_tpu_torch.ops import fused_mlp as fm
    from mirage_tpu_torch.ops import quant as q
    from mirage_tpu_torch.ops import runtime
    from mirage_tpu_torch.ops.fused_block import fused_block, fused_block_ref

    gen = torch.Generator().manual_seed(SEED + 4)

    def block_inputs(shape, dtype):
        attn = _op_inputs("attn_half_block", shape, dtype, gen)
        mlp = _op_inputs("mlp_block", shape[:3], dtype, gen)
        return attn[:7] + mlp[1:] + (shape[3],)

    lib_attn, lib_mlp = _library("attn_half_block"), _library("mlp_block")

    def library(*a):
        return lib_mlp(lib_attn(*a[:7], a[-1]), *a[7:13])

    def cluster_sweep(args):
        """ms of the kernel at every cluster size it takes (the op picks the
        largest that keeps batch · cluster CTAs within one wave), outputs
        bit-equal across sizes."""
        x, *prm, heads = args
        d, hidden = x.shape[-1], prm[8].shape[0]
        sizes = [c for c in range(1, 9) if heads % c == 0
                 and hidden % c == 0 and (hidden // c) % 16 == 0]

        def run(c):
            return runtime.fused_block(x, *prm, heads=heads, cluster=c,
                                       scale=(d // heads) ** -0.5)

        ref, out = run(sizes[0]), {}
        for c in sizes:
            if not torch.equal(run(c), ref):
                raise AssertionError(f"fused_block: cluster {c} changes the "
                                     f"output")
            out[c] = cuda_ms(lambda: run(c), iters=5)
        return out

    # B10: (label, shape, calls per reconstruct forward under
    # MIRAGE_BLOCK_FUSE=all)
    for label, shape, per_fwd in [("decoder", (BATCH, 256, 256, 8), 6),
                                  ("encoder", (BATCH, 257, 1024, 16), 24)]:
        args = block_inputs(shape, torch.bfloat16)
        got = fused_block(*args)
        torch.cuda.synchronize()
        with runtime.plain_on_card():
            want = fused_block_ref(*[a.float() if torch.is_tensor(a) else a
                                     for a in args])
        diff = got.float() - want
        max_abs, rel_l2 = diff.abs().max().item(), (diff.norm()
                                                   / want.norm()).item()
        if not (max_abs <= BF16_MAX_ABS and rel_l2 <= BF16_REL_L2
                and bool(torch.isfinite(got).all())):
            raise AssertionError(f"fused_block {label}: max_abs {max_abs}, "
                                 f"rel_l2 {rel_l2}")
        del got, want, diff
        kernel_ms = cuda_ms(lambda: fused_block(*args), iters=10)
        with runtime.plain_on_card():
            plain_ms = cuda_ms(lambda: fused_block_ref(*args), iters=5)
        library_ms = cuda_ms(lambda: library(*args), iters=10)
        sweep = cluster_sweep(args)
        flops, nbytes = _block_work(shape, 2)
        t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
        row = {"label": label, "shape": list(shape), "dtype": "bf16",
               "max_abs_err": max_abs, "rel_l2_err": rel_l2,
               "ms": kernel_ms, "plain_ms": plain_ms,
               "library_ms": library_ms, "bound_ms": max(t_ops, t_bytes),
               "bound_by": "operations" if t_ops >= t_bytes else "bytes",
               "calls_per_forward": per_fwd, "ms_by_cluster": sweep}
        log(f"[kernels] fused_block {label} {shape}: max_abs {max_abs:.3e} "
            f"rel_l2 {rel_l2:.3e} kernel {kernel_ms:.4f} ms plain "
            f"{plain_ms:.4f} ms library {library_ms:.4f} ms bound "
            f"{row['bound_ms']:.4f} ms ({row['bound_by']}); ms by cluster "
            f"size {sweep}")
        results.setdefault("fused_block", []).append(row)
        del args
    # one MIRAGE-Base block at batch 1 (the golden's shape) in bf16: the
    # cluster sizes where the batch alone leaves most SMs idle
    args = block_inputs((1, 257, 768, 12), torch.bfloat16)
    got = fused_block(*args)
    with runtime.plain_on_card():
        want = fused_block_ref(*[a.float() if torch.is_tensor(a) else a
                                 for a in args])
    diff = got.float() - want
    max_abs, rel_l2 = diff.abs().max().item(), (diff.norm()
                                               / want.norm()).item()
    if not (max_abs <= BF16_MAX_ABS and rel_l2 <= BF16_REL_L2
            and bool(torch.isfinite(got).all())):
        raise AssertionError(f"fused_block batch 1: max_abs {max_abs}, "
                             f"rel_l2 {rel_l2}")
    sweep = cluster_sweep(args)
    log(f"[kernels] fused_block (1, 257, 768, 12) bf16: max_abs "
        f"{max_abs:.3e} rel_l2 {rel_l2:.3e}; ms by cluster size {sweep}")
    results["fused_block"].append({"label": "batch-1 cluster sweep",
                                   "shape": [1, 257, 768, 12],
                                   "dtype": "bf16", "max_abs_err": max_abs,
                                   "rel_l2_err": rel_l2,
                                   "ms_by_cluster": sweep})
    args = block_inputs((2, 257, 1024, 16), torch.float32)
    got = fused_block(*args)
    with runtime.plain_on_card():
        want = fused_block_ref(*args)
    err = (got - want).abs().max().item()
    log(f"[kernels] fused_block float32 (2, 257, 1024, 16): max_abs {err:.3e}")
    if not err <= F32_ATOL:
        raise AssertionError(f"fused_block float32: max_abs {err}")
    results["fused_block"].append({"label": "float32 check",
                                   "shape": [2, 257, 1024, 16],
                                   "dtype": "f32", "max_abs_err": err})

    # B12 at the MIRAGE-Large encoder's MLP (3-D, per batch element in the
    # TPU kernel) and 16384 rows (2-D)
    q.mlp_block_q.launches = 0
    for label, shape in [("encoder 3-D", (BATCH, 257, 1024)),
                         ("rows 2-D", (16384, 1024))]:
        d = shape[-1]
        x = (torch.randn(*shape, generator=gen)).to(torch.bfloat16).cuda()
        lw = (1 + 0.1 * torch.randn(d, generator=gen)).cuda()
        lb = (0.02 * torch.randn(d, generator=gen)).cuda()
        prm = q.quantize_mlp_params(*[(torch.randn(*sh, generator=gen)
                                       * sc).cuda() for sh, sc in (
            ((4 * d, d), d ** -0.5), ((4 * d,), 0.02),
            ((d, 4 * d), (4 * d) ** -0.5), ((d,), 0.02))])
        before = q.mlp_block_q.launches
        got = q.mlp_block_q_kernel_parts(x, lw, lb, *prm)
        again = q.mlp_block_q_kernel_parts(x, lw, lb, *prm)
        q.mlp_block_q.launches = before
        torch.cuda.synchronize()
        rerun_equal = all(torch.equal(a, b) for a, b in zip(got, again))
        with runtime.plain_on_card():
            want = q.mlp_block_q_parts(x, lw, lb, *prm)
        share = {k: (got[i] != want[i]).float().mean().item()
                 for k, i in (("ln_codes", 1), ("hidden_codes", 3))}
        diff = got[0].float() - want[0].float()
        rel_l2 = (diff.norm() / want[0].float().norm()).item()
        max_abs = diff.abs().max().item()
        log(f"[kernels] mlp_block_q {label} {shape}: codes differing "
            f"{share} (bar {B12_CODE_SHARE}), out rel_l2 {rel_l2:.3e} (bar "
            f"{B12_REL_L2}), max_abs {max_abs:.3e}, rerun bit-identical "
            f"{rerun_equal}")
        if not (rerun_equal and max(share.values()) <= B12_CODE_SHARE
                and rel_l2 <= B12_REL_L2
                and bool(torch.isfinite(got[0]).all())):
            raise AssertionError(f"mlp_block_q {label} disagrees with its "
                                 f"plain version")
        del got, again, want, diff
        kernel_ms = cuda_ms(lambda: q.mlp_block_q(x, lw, lb, *prm), iters=10)
        with runtime.plain_on_card():
            plain_ms = cuda_ms(lambda: q.mlp_block_q(x, lw, lb, *prm),
                               iters=5)
        library_ms = cuda_ms(lambda: _quant_library(x, lw, lb, *prm),
                             iters=10)
        m = x.numel() // d
        t_ops = 2 * 2 * m * d * 4 * d / PEAK_INT8_OPS * 1e3
        t_bytes = (2 * 2 * m * d + 2 * 4 * d * d + 4 * (10 * d)) \
            / PEAK_BYTES * 1e3
        results.setdefault("mlp_block_q", []).append({
            "label": label, "shape": list(shape) + [4 * d], "dtype": "bf16",
            "max_abs_err": max_abs, "rel_l2_err": rel_l2,
            "codes_differing": share, "rerun_bit_identical": rerun_equal,
            "ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "library": "F.layer_norm, torch quantise ops, torch._int_mm, "
                       "F.gelu, dequantise",
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "calls": 1})
        log(f"[kernels] mlp_block_q {label}: kernel {kernel_ms:.4f} ms plain "
            f"{plain_ms:.4f} ms library {library_ms:.4f} ms bound "
            f"{max(t_ops, t_bytes):.4f} ms")
        del x, prm

    # B9′ at the pretraining encoder's unaligned (256, 99, 768)
    fm.mlp_block_fwd_stash3d.launches = 0
    args = _op_inputs("mlp_block", (TRAIN_BATCH, 99, 768), torch.bfloat16, gen)
    for flat in (False, True):
        before = fm.mlp_block_fwd_stash3d.launches
        out, act, dg = fm.mlp_block_fwd_stash3d(*args, stash_flat=flat)
        fm.mlp_block_fwd_stash3d.launches = before
        base = fm.mlp_block(*args)
        torch.cuda.synchronize()
        bit_equal = torch.equal(out, base)
        with runtime.plain_on_card():
            want = fm.mlp_block_fwd_stash3d_ref(*[a.float() for a in args],
                                                stash_flat=flat)
        errs = {}
        for key, g, w in zip(("out", "act", "dgelu"), (out, act, dg), want):
            d_ = g.float() - w
            errs[key] = {"max_abs": d_.abs().max().item(),
                         "rel_l2": (d_.norm() / w.norm()).item()}
        shapes = [list(t.shape) for t in (out, act, dg)]
        log(f"[kernels] mlp_block_fwd_stash3d stash_flat={flat}: shapes "
            f"{shapes}, out bit-equal to mlp_block {bit_equal}, errors {errs}")
        if not bit_equal or not all(
                e["max_abs"] <= BF16_MAX_ABS and e["rel_l2"] <= BF16_REL_L2
                for e in errs.values()):
            raise AssertionError(f"mlp_block_fwd_stash3d stash_flat={flat}")
        del out, act, dg, base, want
        kernel_ms = cuda_ms(lambda: fm.mlp_block_fwd_stash3d(
            *args, stash_flat=flat), iters=10)
        with runtime.plain_on_card():
            plain_ms = cuda_ms(lambda: fm.mlp_block_fwd_stash3d(
                *args, stash_flat=flat), iters=5)
        library_ms = cuda_ms(lambda: lib_mlp(*args), iters=10)
        flops, nbytes = _stash_work(TRAIN_BATCH * 99, 768, 2, False)
        t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
        results.setdefault("mlp_block_fwd_stash3d", []).append({
            "label": f"pretraining encoder stash_flat={flat}",
            "shape": [TRAIN_BATCH, 99, 768, 3072], "dtype": "bf16",
            "errors": errs, "out_bit_equal_to_mlp_block": bit_equal,
            "max_abs_err": max(e["max_abs"] for e in errs.values()),
            "ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "calls": 1})
        log(f"[kernels] mlp_block_fwd_stash3d stash_flat={flat}: kernel "
            f"{kernel_ms:.4f} ms plain {plain_ms:.4f} ms library "
            f"{library_ms:.4f} ms bound {max(t_ops, t_bytes):.4f} ms")
    del args
    torch.cuda.synchronize()
    return results


# ------------------------------------------------------------------ phase 3

def phase_golden(workdir):
    import numpy as np
    import torch

    from mirage_tpu_torch.api.wrapper import MIRAGEWrapper

    golden = np.load(ROOT / "tests" / "golden" / "example_triplet_tiny.npz")
    sd = {k[2:]: torch.from_numpy(golden[k].astype(np.float32))
          for k in golden.files if k.startswith("w_")}
    args = dict(model="miragepre_tiny", num_global_tokens=1,
                in_domains=["bscan", "slo", "bscanlayermap"],
                out_domains=["bscan", "slo", "bscanlayermap"],
                dim_tokens=192, depth=3, num_heads=4, decoder_dim=64,
                decoder_depth=2, decoder_num_heads=4)
    path = workdir / "tiny_golden.pth"
    torch.save({"model": sd, "args": args}, path)
    wrapper = MIRAGEWrapper(weights=str(path), device="cuda")
    preds = wrapper({"bscan": golden["in_bscan"]})
    errs = {}
    for task in ("bscan", "slo", "bscanlayermap"):
        errs[task] = float(np.abs(preds[task].cpu().numpy()
                                  - golden[f"pred_{task}"]).max())
    log(f"[golden] max |port - reference| on the card: {errs}")
    bad = {t: e for t, e in errs.items() if not e <= GOLDEN_ATOL}
    if bad:
        raise AssertionError(f"golden mismatch above {GOLDEN_ATOL}: {bad}")
    return {"tiny": errs, "base": _base_golden(workdir)}


def _base_golden(workdir):
    """tests/golden/example_triplet_base.npz: the reference MIRAGE-Base
    model's outputs from seeded full-size weights (rebuilt by
    golden_state_dict and checked against the recorded sha256), through the
    port's wrapper in float32 under MIRAGE_BLOCK_FUSE=off (B1-B3) and all
    (B10's float32 path through 12 encoder and 6 decoder blocks)."""
    import numpy as np
    import torch

    from mirage_tpu_torch.api.wrapper import MIRAGEWrapper
    from mirage_tpu_torch.ops import runtime
    from mirage_tpu_torch.ops.fused_block import fused_block

    golden = np.load(ROOT / "tests" / "golden" / "example_triplet_base.npz")
    sd = golden_state_dict(golden)
    path = workdir / "base_golden.pth"
    torch.save({"model": {k: torch.from_numpy(v) for k, v in sd.items()},
                "args": BASE_GOLDEN_ARGS}, path)
    wrapper = MIRAGEWrapper(weights=str(path), device="cuda")
    out = {}
    for switch, launches in (("off", 0), ("all", 18)):
        with runtime.switched({"MIRAGE_BLOCK_FUSE": switch}):
            fused_block.launches = 0
            preds = wrapper({"bscan": golden["in_bscan"]})
            torch.cuda.synchronize()
            got = fused_block.launches
        errs = {task: float(np.abs(preds[task].cpu().numpy()
                                   - golden[f"pred_{task}"]).max())
                for task in ("bscan", "slo", "bscanlayermap")}
        log(f"[golden] MIRAGE-Base, MIRAGE_BLOCK_FUSE={switch}: max |port - "
            f"reference| {errs}; fused_block launches {got} (expected "
            f"{launches})")
        bad = {t: e for t, e in errs.items() if not e <= GOLDEN_ATOL}
        if bad or got != launches:
            raise AssertionError(f"MIRAGE-Base golden under {switch}: {bad}, "
                                 f"launches {got}")
        out[switch] = errs
    return out


# The recorded MIRAGE-Base golden (tests/golden/example_triplet_base.npz)
# holds the reference Base model's outputs on one B-scan, computed from
# weights that numpy alone regenerates: seeded_state_dict is a copy of
# tests/test_fullsize_parity.py:seeded_state_dict (each key its own PCG64
# stream seeded by (seed, crc32(key)); 1-D weights and norm parameters
# centred at 1, everything else 0.02·N(0, 1); float16-quantised so that every
# framework loads the same bits). tests/test_torch_infer.py shares this copy.
GOLD_SEED = 20260819
# the Base golden's checkpoint arguments (tests/test_fullsize_parity.py:170)
BASE_GOLDEN_ARGS = dict(
    model="miragepre_base", num_global_tokens=1,
    in_domains=["bscan", "slo", "bscanlayermap"],
    out_domains=["bscan", "slo", "bscanlayermap"], decoder_dim=256,
    decoder_depth=2, decoder_num_heads=8, decoder_use_task_queries=True,
    decoder_use_xattn=True)


def seeded_state_dict(keys_shapes, seed=GOLD_SEED):
    """{key: float32 array} for [(key, shape), ...]."""
    import numpy as np

    sd = {}
    for key, shape in keys_shapes:
        rng = np.random.default_rng([seed, zlib.crc32(key.encode())])
        vals = rng.standard_normal(shape).astype(np.float32) * 0.02
        is_scale = (len(shape) == 1 and key.endswith(".weight")) \
            or "norm" in key.rsplit(".", 1)[0].rsplit(".", 1)[-1]
        if is_scale:
            vals = vals + 1.0
        sd[key] = vals.astype(np.float16).astype(np.float32)
    return sd


def state_dict_sha256(sd) -> str:
    """sha256 over the arrays' bytes in key order."""
    h = hashlib.sha256()
    for k in sorted(sd):
        h.update(sd[k].tobytes())
    return h.hexdigest()


def golden_state_dict(golden):
    """The loaded golden npz -> its seeded state dict, checked against the
    recorded seed and digest."""
    keys = [str(k) for k in golden["sd_keys"]]
    shapes = [tuple(int(d) for d in s if d >= 0) for s in golden["sd_shapes"]]
    if int(golden["seed"]) != GOLD_SEED:
        raise ValueError(f"golden seed {int(golden['seed'])} != {GOLD_SEED}")
    sd = seeded_state_dict(list(zip(keys, shapes)))
    if state_dict_sha256(sd) != str(golden["sd_sha256"]):
        raise ValueError("seeded_state_dict drifted from the recorded weights")
    return sd


# ------------------------------------------------------------------ phase 4

def _post(url, arrays):
    import numpy as np

    buf = io.BytesIO()
    np.savez(buf, **arrays)
    req = urllib.request.Request(url, data=buf.getvalue(), method="POST")
    with urllib.request.urlopen(req, timeout=300) as r:
        body = r.read()
    with np.load(io.BytesIO(body), allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def _large_weights(workdir):
    """MIRAGE-Large (1024 wide, 24 layers, 16 heads; three 256/2/8 decoders)
    from a seeded random init, saved as a bf16 .pth with its args. Built
    once per run (phases 4 and 8 share it); any older file is overwritten."""
    import torch

    from mirage_tpu_torch.api.wrapper import build_model

    t0 = time.perf_counter()
    path = workdir / "mirage_large_seed.pth"
    domains = ["bscan", "slo", "bscanlayermap"]
    args = dict(model="miragepre_large", num_global_tokens=1,
                in_domains=domains, out_domains=domains, decoder_dim=256,
                decoder_depth=2, decoder_num_heads=8)
    model = build_model("miragepre_large", args, domains, 512, 32,
                        generator=torch.Generator().manual_seed(SEED))
    torch.save({"model": {k: v.to(torch.bfloat16)
                          for k, v in model.state_dict().items()},
                "args": args}, path)
    log(f"[weights] MIRAGE-Large from seed {SEED} built and saved in "
        f"{time.perf_counter() - t0:.1f}s")
    return path


def phase_serve(workdir, card, path):
    import numpy as np
    import torch

    from mirage_tpu_torch.api.wrapper import MIRAGEWrapper
    from mirage_tpu_torch.cli.serve import make_model_fns
    from mirage_tpu_torch.ops import runtime
    from mirage_tpu_torch.ops.block_attention import (attn_half_block,
                                                      xattn_half_block)
    from mirage_tpu_torch.ops.fused_mlp import mlp_block
    from mirage_tpu_torch.serve import MIRAGEServer, pow2_padded

    ops = {"attn_half_block": attn_half_block, "mlp_block": mlp_block,
           "xattn_half_block": xattn_half_block}
    t0 = time.perf_counter()
    wrapper = MIRAGEWrapper(weights=str(path), compute_dtype=torch.bfloat16,
                            device="cuda")
    log(f"[serve] MIRAGE-Large from seed {SEED}: {wrapper.n_params} params, "
        f"loaded in {time.perf_counter() - t0:.1f}s")

    reconstruct, features = make_model_fns(wrapper, wrapper.in_domains)
    server = MIRAGEServer(
        reconstruct_fn=pow2_padded(reconstruct),
        features_fn=pow2_padded(features), max_batch=16, max_wait_ms=50,
        device=torch.cuda.get_device_name(0), n_params=wrapper.n_params,
        request_timeout_s=300)
    httpd = server.serve(host="127.0.0.1", port=0, background=True)
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    rng = np.random.default_rng(SEED)
    n_req = 8
    images = rng.random((n_req, 512, 512), dtype=np.float32)
    try:
        for fn in ops.values():
            fn.launches = 0
        results = [None] * n_req
        errors = []

        def worker(i):
            try:
                results[i] = _post(url + "/v1/reconstruct",
                                   {"bscan": images[i]})
            except Exception as e:  # noqa: BLE001 - re-raised below
                errors.append(e)

        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(n_req)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        feats = _post(url + "/v1/features", {"bscan": images[0]})
        torch.cuda.synchronize()
        counts = {name: fn.launches for name, fn in ops.items()}
        stats = server.stats()
        n_rec = server.queues["/v1/reconstruct"].n_batches
        n_feat = server.queues["/v1/features"].n_batches
        three = _three_modality_request(url, wrapper, rng)
    finally:
        server.close()
    if errors or any(r is None for r in results):
        raise AssertionError(f"requests failed: {errors}")
    log(f"[serve] {n_req} reconstruct requests in {n_rec} batches, "
        f"{n_feat} features batch; stats {stats}")
    want_shapes = {"bscan": (1, 512, 512), "slo": (1, 512, 512),
                   "bscanlayermap": (13, 128, 128)}
    for r in results:
        for task, shape in want_shapes.items():
            if r[task].shape != shape or not np.isfinite(r[task]).all():
                raise AssertionError(f"{task}: shape {r[task].shape} or "
                                     f"non-finite values")
    if feats["features"].shape != (257, 1024) \
            or not np.isfinite(feats["features"]).all():
        raise AssertionError(f"features shape {feats['features'].shape}")
    expected = {name: PER_RECONSTRUCT[name] * n_rec + PER_FEATURES[name]
                * n_feat for name in ops}
    log(f"[serve] launches {counts}, expected {expected}")
    if counts != expected or not all(counts.values()):
        raise AssertionError(f"launch counts {counts} != {expected}")

    # one batch against the plain path on the card, and the HTTP answers
    # against a direct call
    batch = {"bscan": images}
    got = reconstruct(batch)
    for i in range(n_req):
        for task in want_shapes:
            if not np.array_equal(results[i][task], got[task][i]):
                d = np.abs(results[i][task] - got[task][i]).max()
                if d > 0.1:
                    raise AssertionError(f"HTTP answer {i}/{task} differs "
                                         f"from a direct call by {d}")
    with runtime.plain_on_card():
        want = reconstruct(batch)
    agree = {}
    for task in want_shapes:
        d = got[task] - want[task]
        agree[task] = {"max_abs": float(np.abs(d).max()),
                       "rel_l2": float(np.linalg.norm(d)
                                       / np.linalg.norm(want[task]))}
    log(f"[serve] kernel path vs plain path (bf16, card): {agree}")
    bad = {t: a for t, a in agree.items() if not a["rel_l2"] <= MODEL_REL_L2}
    if bad:
        raise AssertionError(f"kernel path disagrees with the plain path "
                             f"above rel_l2 {MODEL_REL_L2}: {bad}")

    # batch-64 forward throughput, B-scan in, three reconstructions out
    x = {"bscan": torch.from_numpy(
        rng.random((BATCH, 1, 512, 512), dtype=np.float32)).cuda()}
    for _ in range(2):
        wrapper(x)
    torch.cuda.synchronize()
    iters = 5
    t0 = time.perf_counter()
    for _ in range(iters):
        out = wrapper(x)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / iters
    with runtime.plain_on_card():
        wrapper(x)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        wrapper(x)
        torch.cuda.synchronize()
        dt_plain = time.perf_counter() - t1
    if not all(bool(torch.isfinite(v).all()) for v in out.values()):
        raise AssertionError("non-finite batch-64 output")
    prof = profile_forward(lambda: wrapper(x))
    log(f"[serve] batch {BATCH} forward under torch.profiler: "
        f"{prof if prof else 'no device kernels seen (not measured)'}")
    tput = {"batch": BATCH, "ms_per_batch": dt * 1e3,
            "img_per_s": BATCH / dt, "plain_img_per_s": BATCH / dt_plain,
            "profile": prof, "card": card}
    log(f"[serve] batch {BATCH}: {dt * 1e3:.2f} ms/batch, "
        f"{BATCH / dt:.1f} img/s (plain path {BATCH / dt_plain:.1f} img/s) "
        f"on {card}")
    tput["three_modality"] = three
    tput["block_fuse"] = _serve_under_switch(wrapper, x, card)
    return counts, n_rec, tput


# launches per batch-64 MIRAGE-Large reconstruct forward under each
# MIRAGE_BLOCK_FUSE value: 24 encoder blocks (width 1024), three decoders
# of a cross-attention half (B3 + B2) and two 256-wide blocks
PER_RECONSTRUCT_FUSE = {
    "off": {"attn_half_block": 30, "mlp_block": 33, "xattn_half_block": 3,
            "fused_block": 0},
    "decoder": {"attn_half_block": 24, "mlp_block": 27,
                "xattn_half_block": 3, "fused_block": 6},
    "all": {"attn_half_block": 0, "mlp_block": 3, "xattn_half_block": 3,
            "fused_block": 30}}


def _serve_under_switch(wrapper, x, card):
    """The batch-64 reconstruct forward under MIRAGE_BLOCK_FUSE=off, decoder
    and all: exact launch counts, agreement with the plain path on the card,
    img/s over five forwards after one warm-up, one profiled forward by
    kernel group (fused_block its own group)."""
    import torch

    from mirage_tpu_torch.ops import runtime
    from mirage_tpu_torch.ops.block_attention import (attn_half_block,
                                                      xattn_half_block)
    from mirage_tpu_torch.ops.fused_block import fused_block
    from mirage_tpu_torch.ops.fused_mlp import mlp_block

    ops = {"attn_half_block": attn_half_block, "mlp_block": mlp_block,
           "xattn_half_block": xattn_half_block, "fused_block": fused_block}
    with runtime.plain_on_card():
        want = {k: v.float() for k, v in wrapper(x).items()}
    out, first = {}, None
    for switch, expected in PER_RECONSTRUCT_FUSE.items():
        with runtime.switched({"MIRAGE_BLOCK_FUSE": switch}):
            for fn in ops.values():
                fn.launches = 0
            got = wrapper(x)
            torch.cuda.synchronize()
            counts = {k: fn.launches for k, fn in ops.items()}
            agree = {task: (got[task].float() - want[task]).norm().item()
                     / want[task].norm().item() for task in want}
            finite = all(bool(torch.isfinite(v).all()) for v in got.values())
            first = first or got  # the outputs under off
            vs_off = max((got[t].float() - first[t].float()).abs().max().item()
                         for t in got)
            del got
            wrapper(x)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(5):
                wrapper(x)
            torch.cuda.synchronize()
            dt = (time.perf_counter() - t0) / 5
            prof = profile_forward(lambda: wrapper(x))
        log(f"[serve] MIRAGE_BLOCK_FUSE={switch}: launches {counts} "
            f"(expected {expected}); rel_l2 vs plain {agree}; max_abs vs "
            f"the outputs under off {vs_off:.3e}; "
            f"{dt * 1e3:.2f} ms/batch, {BATCH / dt:.1f} img/s on {card}; "
            f"profile {prof if prof else 'no device kernels seen'}")
        if counts != expected or not finite or not all(
                a <= MODEL_REL_L2 for a in agree.values()):
            raise AssertionError(f"MIRAGE_BLOCK_FUSE={switch}: launches "
                                 f"{counts} != {expected} or rel_l2 {agree}")
        out[switch] = {"counts": counts, "rel_l2": agree,
                       "max_abs_vs_off": vs_off,
                       "ms_per_batch": dt * 1e3, "img_per_s": BATCH / dt,
                       "profile": prof}
    return out


def _three_modality_request(url, wrapper, rng):
    """One request with all three modalities (769 encoder tokens, above
    what the packed attention kernels hold): the encoder's attention and the
    decoders' cross-attention run flash attention (B8). Its answer against
    the plain path on the card."""
    import numpy as np
    import torch

    from mirage_tpu_torch.ops import runtime
    from mirage_tpu_torch.ops.block_attention import attn_half_block
    from mirage_tpu_torch.ops.flash_attention import flash_attention
    from mirage_tpu_torch.ops.fused_mlp import mlp_block

    req = {"bscan": rng.random((512, 512), dtype=np.float32),
           "slo": rng.random((512, 512), dtype=np.float32),
           "bscanlayermap": rng.integers(0, 13, (128, 128)).astype(np.int32)}
    ops = {"flash_attention": flash_attention,
           "attn_half_block": attn_half_block, "mlp_block": mlp_block}
    for fn in ops.values():
        fn.launches = 0
    got = _post(url + "/v1/reconstruct", req)
    torch.cuda.synchronize()
    counts = {k: fn.launches for k, fn in ops.items()}
    # encoder: 24 × (B8 + B2); decoders: 3 × B8 cross-attention over 769
    # context tokens, 3 × 2 blocks × (B1 + B2)
    want_counts = {"flash_attention": 27, "attn_half_block": 6,
                   "mlp_block": 30}
    log(f"[serve] three-modality request: launches {counts}, expected "
        f"{want_counts}")
    if counts != want_counts:
        raise AssertionError(f"three-modality launches {counts} != "
                             f"{want_counts}")
    batch = {k: v[None] for k, v in req.items()}
    batch["bscan"], batch["slo"] = batch["bscan"][:, None], \
        batch["slo"][:, None]
    with runtime.plain_on_card():
        want = {k: v.float().cpu().numpy() for k, v in wrapper(batch).items()}
    agree = {}
    for task, w in want.items():
        d = got[task] - w[0]
        agree[task] = {"max_abs": float(np.abs(d).max()),
                       "rel_l2": float(np.linalg.norm(d) / np.linalg.norm(w))}
    log(f"[serve] three-modality request vs plain path (bf16, card): {agree}")
    bad = {t: a for t, a in agree.items() if not a["rel_l2"] <= MODEL_REL_L2}
    if bad or not all(np.isfinite(v).all() for v in got.values()):
        raise AssertionError(f"three-modality answer disagrees with the "
                             f"plain path above rel_l2 {MODEL_REL_L2}: {bad}")
    return {"launches": counts, "agreement": agree}


# ------------------------------------------------------------------ phase 5

TRAIN_STEPS = 5  # timed steps, after one warm-up step
TRAIN_STEPS_ON = 3  # timed steps with the switches on, after one warm-up
# one step on the kernel path against the same step on the plain path, both
# in bf16 from the same weights, batch and explicit masks: the kernels and
# the plain versions round at the same places but sum in other orders, and
# the differences pass through 12 encoder and 3 × 3 decoder layers
TRAIN_LOSS_REL, TRAIN_GNORM_REL, TRAIN_LEAF_REL = 1e-2, 2e-2, 5e-2


def _launch_counters():
    from mirage_tpu_torch.ops import block_attention as ba
    from mirage_tpu_torch.ops import flash_attention as fa
    from mirage_tpu_torch.ops import fused_adamw as fadam
    from mirage_tpu_torch.ops import fused_mlp as fm

    return {"attn_half_block": (ba.attn_half_block, "launches"),
            "attn_half_block_bwd": (ba.attn_half_block, "bwd_launches"),
            "attn_half_block_acc_bwd": (ba.attn_half_block,
                                        "acc_bwd_launches"),
            "mlp_block_acc_bwd": (fm.mlp_block, "acc_bwd_launches"),
            "fused_adamw": (fadam.fused_adamw, "launches"),
            "mlp_block": (fm.mlp_block, "launches"),
            "mlp_block_bwd": (fm.mlp_block, "bwd_launches"),
            "block_attention": (ba.block_attention, "launches"),
            "block_attention_bwd": (ba.block_attention, "bwd_launches"),
            "xattn_half_block": (ba.xattn_half_block, "launches"),
            "flash_attention": (fa.flash_attention, "launches"),
            "flash_attention_bwd": (fa.flash_attention, "bwd_launches"),
            "mlp_block_stash": (fm.mlp_block, "stash_launches"),
            "mlp_block_stash_bwd": (fm.mlp_block, "stash_bwd_launches")}


def _agreement(loss_k, grads_k, loss_p, grads_p, names):
    """Loss, global grad norm and the worst leaf's relative L2 error of a
    kernel-path forward and backward against the plain path's."""
    from mirage_tpu_torch.train.optim import global_norm

    gn_k, gn_p = global_norm(grads_k).item(), global_norm(grads_p).item()
    leaf = {n: ((g - w).norm() / w.norm()).item()
            for n, g, w in zip(names, grads_k, grads_p)}
    worst = max(leaf, key=leaf.get)
    return {"loss": loss_k.item(), "plain_loss": loss_p.item(),
            "loss_rel": abs(loss_k.item() - loss_p.item()) / abs(
                loss_p.item()),
            "grad_norm": gn_k, "plain_grad_norm": gn_p,
            "grad_norm_rel": abs(gn_k - gn_p) / gn_p,
            "worst_leaf": worst, "worst_leaf_rel_l2": leaf[worst],
            "leaves": len(leaf)}


def _check_agreement(what, agree):
    if not (agree["loss_rel"] <= TRAIN_LOSS_REL
            and agree["grad_norm_rel"] <= TRAIN_GNORM_REL
            and agree["worst_leaf_rel_l2"] <= TRAIN_LEAF_REL):
        raise AssertionError(
            f"{what}: kernel step disagrees with the plain step: {agree} "
            f"(bars loss {TRAIN_LOSS_REL}, grad norm {TRAIN_GNORM_REL}, leaf "
            f"{TRAIN_LEAF_REL})")


def phase_train(card):
    """The ViT-B pretraining step of scripts/bench_train.py:38-62 at full
    width: miragepre_base (768 wide, 12 layers, 12 heads), bscan and slo
    512² at patch 32 and the 128² layer map at patch 8 (256 tokens each), 98
    visible tokens + 1 global, three 256/2/8 decoders, batch 256, bf16
    compute with float32 parameters, AdamW (0.9, 0.95), wd 0.05, clip 1.0,
    token-space losses with norm_pix on the images. Random weights (seed 0)
    and a numpy-seeded batch."""
    import numpy as np
    import torch

    from mirage_tpu_torch.api.wrapper import build_model
    from mirage_tpu_torch.masking.masking import generate_random_masks
    from mirage_tpu_torch.ops import runtime
    from mirage_tpu_torch.train.optim import GroupedOptimizer, OptimizerConfig
    from mirage_tpu_torch.train.steps import (init_train_state,
                                              make_pretrain_loss,
                                              make_train_step)

    counters = _launch_counters()

    def reset():
        for fn, attr in counters.values():
            setattr(fn, attr, 0)

    def read():
        return {k: getattr(fn, attr) for k, (fn, attr) in counters.items()}

    domains = ["bscan", "slo", "bscanlayermap"]
    args = dict(model="miragepre_base", num_global_tokens=1,
                in_domains=domains, out_domains=domains, decoder_dim=256,
                decoder_depth=2, decoder_num_heads=8)
    t0 = time.perf_counter()
    model = build_model("miragepre_base", args, domains, 512, 32,
                        compute_dtype=torch.bfloat16,
                        generator=torch.Generator().manual_seed(SEED)).cuda()
    opt = GroupedOptimizer(OptimizerConfig(
        opt="adamw", betas=(0.9, 0.95), weight_decay=0.05, clip_grad=1.0))
    dc = {"bscan": {"loss": "mse", "patch_size": 32, "norm_pix": True},
          "slo": {"loss": "mse", "patch_size": 32, "norm_pix": True},
          "bscanlayermap": {"loss": "ce", "patch_size": 8}}
    loss_fn = make_pretrain_loss(model, dc, num_encoded_tokens=98,
                                 alphas=1.0)
    state = init_train_state(model, opt)
    step = make_train_step(loss_fn, opt)
    b = TRAIN_BATCH
    rng = np.random.default_rng(SEED)
    batch = {"bscan": rng.random((b, 1, 512, 512), dtype=np.float32),
             "slo": rng.random((b, 1, 512, 512), dtype=np.float32),
             "bscanlayermap": rng.integers(0, 13, (b, 128, 128))}
    batch = {k: torch.from_numpy(v).cuda() for k, v in batch.items()}
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[train] ViT-B pretraining model from seed {SEED}: {n_params} "
        f"params, built in {time.perf_counter() - t0:.1f}s")

    # one step's loss and grads, kernels against the plain path
    masks, _, _ = generate_random_masks(gen, [256, 256, 256], b, 98)
    task_masks = dict(zip(domains, masks))
    names = [n for n, p in state["params"].items() if p.requires_grad]

    def loss_and_grads():
        loss, _ = loss_fn(batch, task_masks=task_masks, num_visible=98)
        return loss.detach(), torch.autograd.grad(
            loss, [state["params"][n] for n in names])

    reset()
    loss_k, grads_k = loss_and_grads()
    torch.cuda.synchronize()
    one_pass = {k: v for k, v in read().items() if k in PER_STEP}
    with runtime.plain_on_card():
        loss_p, grads_p = loss_and_grads()
    agree = _agreement(loss_k, grads_k, loss_p, grads_p, names)
    log(f"[train] one step, kernel path vs plain path (bf16, card): {agree}")
    del grads_k
    _check_agreement("pretraining step", agree)
    if one_pass != PER_STEP:
        raise AssertionError(f"launches in one forward+backward {one_pass} "
                             f"!= {PER_STEP}")
    with runtime.switched(SWITCHES_ON):
        reset()
        loss_a, grads_a = loss_and_grads()
        torch.cuda.synchronize()
        one_pass_on = {k: v for k, v in read().items() if k in PER_STEP}
    agree_on = _agreement(loss_a, grads_a, loss_p, grads_p, names)
    log(f"[train] one step with {SWITCHES_ON}, kernel path vs plain path "
        f"(bf16, card): {agree_on}")
    del grads_a, grads_p
    _check_agreement("pretraining step, switches on", agree_on)
    want_on = {**PER_STEP_ON, "fused_adamw": 0}
    if one_pass_on != want_on:
        raise AssertionError(f"launches in one forward+backward with the "
                             f"switches on {one_pass_on} != {want_on}")

    # the pretraining step itself: random masks, warm-up, timed steps
    watch = ["encoder.0.attn.qkv.weight", "encoder.11.mlp.fc2.weight",
             "output_adapters.bscan.decoder_transformer.1.attn.qkv.weight",
             "global_tokens"]
    before = {n: state["params"][n].detach().clone() for n in watch}
    lr = 1e-4
    state, m = step(state, batch, gen, lr)
    torch.cuda.synchronize()
    reset()
    metrics = []
    t1 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        state, m = step(state, batch, gen, lr)
        metrics.append(m)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t1) / TRAIN_STEPS
    counts = {k: v for k, v in read().items() if k in PER_STEP}
    expected = {k: v * TRAIN_STEPS for k, v in PER_STEP.items()}
    losses = [{k: v.item() for k, v in mm.items()} for mm in metrics]
    log(f"[train] {TRAIN_STEPS} steps: launches {counts}, expected "
        f"{expected}; metrics {losses}")
    if counts != expected:
        raise AssertionError(f"launch counts {counts} != {expected}")
    if not all(np.isfinite(v) for mm in losses for v in mm.values()):
        raise AssertionError(f"non-finite loss or grad norm: {losses}")
    changed = {n: not torch.equal(before[n], state["params"][n])
               for n in watch}
    if not all(changed.values()) or int(state["opt"]["count"]) \
            != TRAIN_STEPS + 1:
        raise AssertionError(f"parameters unchanged: {changed}, count "
                             f"{int(state['opt']['count'])}")
    prof = profile_forward(lambda: step(state, batch, gen, lr), top_n=25)
    log(f"[train] one step under torch.profiler: "
        f"{prof if prof else 'no device kernels seen (not measured)'}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"[train] batch {b}: {dt * 1e3:.2f} ms/step, {b / dt:.1f} img/s, "
        f"peak memory {peak:.1f} GiB, on {card}")

    # the step with the switches on: B7 for both backwards, B11
    routed = sum(1 for p in state["params"].values()
                 if p.requires_grad and p.numel() >= 1 << 17)
    with runtime.switched(SWITCHES_ON):
        state, _ = step(state, batch, gen, lr)
        torch.cuda.synchronize()
        reset()
        t2 = time.perf_counter()
        for _ in range(TRAIN_STEPS_ON):
            state, m = step(state, batch, gen, lr)
        torch.cuda.synchronize()
        dt_on = (time.perf_counter() - t2) / TRAIN_STEPS_ON
        counts_on = {k: v for k, v in read().items() if k in PER_STEP_ON}
        prof_on = profile_forward(lambda: step(state, batch, gen, lr),
                                  top_n=25)
    from mirage_tpu_torch.ops.fused_adamw import fused_adamw

    expected_on = {k: v * TRAIN_STEPS_ON for k, v in PER_STEP_ON.items()}
    log(f"[train] {TRAIN_STEPS_ON} steps with the switches on: launches "
        f"{counts_on}, expected {expected_on}; B11 leaves "
        f"{fused_adamw.last_routed_count}, expected {routed}; "
        f"{dt_on * 1e3:.2f} ms/step; loss {m['loss'].item()}; profile "
        f"{prof_on if prof_on else 'no device kernels seen (not measured)'}")
    if counts_on != expected_on or fused_adamw.last_routed_count != routed \
            or not np.isfinite(m["loss"].item()):
        raise AssertionError(f"switches on: launches {counts_on}, leaves "
                             f"{fused_adamw.last_routed_count}")
    return {"batch": b, "steps": TRAIN_STEPS + 2, "ms_per_step": dt * 1e3,
            "img_per_s": b / dt, "counts": counts, "agreement": agree,
            "losses": losses, "profile": prof, "peak_gib": peak,
            "switches_on": {"switches": SWITCHES_ON, "counts": counts_on,
                            "agreement": agree_on, "ms_per_step": dt_on * 1e3,
                            "img_per_s": b / dt_on, "b11_leaves": routed,
                            "profile": prof_on},
            "card": card}


# ------------------------------------------------------------------ phase 6

SEG_CONFIG = "configs/seg_200e_convnext.yaml"
SEG_STEPS = 5  # timed steps, after two warm-up steps
SEG_TRAIN, SEG_VAL, SEG_BATCH = 8, 4, 4  # synthetic images; the yaml's batch
# launches per segmentation train step and per eval forward (ViT-B at 1025
# tokens, 12 layers; four ConvNeXt blocks over 4·128² rows)
SEG_PER_STEP = {"flash_attention": 12, "flash_attention_bwd": 12,
                "mlp_block_stash": 4, "mlp_block_stash_bwd": 4,
                "attn_half_block": 0, "attn_half_block_bwd": 0,
                "mlp_block": 0, "mlp_block_bwd": 0, "block_attention": 0,
                "block_attention_bwd": 0, "xattn_half_block": 0,
                "attn_half_block_acc_bwd": 0, "mlp_block_acc_bwd": 0,
                "fused_adamw": 0}
SEG_PER_EVAL = {**{k: 0 for k in SEG_PER_STEP}, "flash_attention": 12,
                "mlp_block": 16}


def _seg_dataset(root, rng, n_train=SEG_TRAIN, n_val=SEG_VAL, size=1024,
                 classes=8):
    """Seeded B-scans in [0, 1] and banded label maps (each image split
    into `classes` horizontal bands at random heights), as .npy in the
    folder layout of data/folder.py, and INFO.json (label 0 background)."""
    import numpy as np

    for split, n in (("train", n_train), ("val", n_val)):
        for task in ("bscan", "semseg"):
            (root / split / task).mkdir(parents=True, exist_ok=True)
        for i in range(n):
            cuts = np.sort(rng.choice(np.arange(1, size), classes - 1,
                                      replace=False))
            lab = np.searchsorted(cuts, np.arange(size), side="right")
            lab = np.repeat(lab[:, None], size, axis=1).astype(np.uint8)
            img = 0.5 * rng.random((size, size), dtype=np.float32) \
                + lab.astype(np.float32) / (2 * classes)
            np.save(root / split / "bscan" / f"s{i:03d}.npy", img)
            np.save(root / split / "semseg" / f"s{i:03d}.npy", lab)
    info = {str(k): {"label": "background" if k == 0 else f"layer{k}",
                     "value": k} for k in range(classes)}
    (root / "INFO.json").write_text(json.dumps(info))


def phase_seg(workdir, card):
    """Segmentation tuning (configs/seg_200e_convnext.yaml: MIRAGE-Base at
    1024² and patch 32 -> 1025 tokens, stochastic depth 0.1, the reference
    freeze, the ConvNeXt head (6144 / 16 -> 384 channels at 128², depth 4),
    CE + GDice, batch 4, AdamW with layer decay 0.75) through its entry
    point run_seg_tuning.main on a seeded synthetic dataset and seeded
    random MIRAGE-Base weights; then the bare train step: kernel step vs
    plain step, exact launch counts, ms/step and a profile."""
    import numpy as np
    import torch

    from mirage_tpu_torch.api.wrapper import build_model as build_pretrain
    from mirage_tpu_torch.cli import run_seg_tuning as rst
    from mirage_tpu_torch.cli.config import parse_with_yaml
    from mirage_tpu_torch.data.augment import SemSegTransform
    from mirage_tpu_torch.data.folder import MultiTaskImageFolder
    from mirage_tpu_torch.ops import runtime
    from mirage_tpu_torch.train.steps import init_train_state, make_train_step

    counters = _launch_counters()

    def reset():
        for fn, attr in counters.values():
            setattr(fn, attr, 0)

    def read():
        return {k: getattr(fn, attr) for k, (fn, attr) in counters.items()}

    t0 = time.perf_counter()
    root = workdir / "seg"
    data = root / "AROI"
    _seg_dataset(data, np.random.default_rng(SEED))
    domains = ["bscan", "slo", "bscanlayermap"]
    pre_args = dict(model="miragepre_base", num_global_tokens=1,
                    in_domains=domains, out_domains=domains, decoder_dim=256,
                    decoder_depth=2, decoder_num_heads=8)
    weights = root / "mirage-base_seed0.pth"
    torch.save({"model": build_pretrain(
        "miragepre_base", pre_args, domains, 512, 32,
        generator=torch.Generator().manual_seed(SEED)).state_dict(),
        "args": pre_args}, weights)
    log(f"[seg] dataset and MIRAGE-Base weights from seed {SEED} in "
        f"{time.perf_counter() - t0:.1f}s")

    # 1. the entry point: min(8 // 4, 3) = 2 train steps and the validation
    # pass (one batch of 4)
    argv = ["-c", str(ROOT / SEG_CONFIG), "--data_path", str(data),
            "--weights", str(weights), "--device", "cuda", "--epochs", "1",
            "--max_steps_per_epoch", "3", "--log_freq", "1",
            "--output_dir", str(root / "out"), "--num_workers", "4"]
    reset()
    t1 = time.perf_counter()
    out = rst.main(argv)
    torch.cuda.synchronize()
    cli_counts = read()
    cli_s = time.perf_counter() - t1
    steps = min(SEG_TRAIN // SEG_BATCH, 3)
    evals = -(-SEG_VAL // SEG_BATCH)
    want_cli = {k: steps * SEG_PER_STEP[k] + evals * SEG_PER_EVAL[k]
                for k in SEG_PER_STEP}
    log(f"[seg] run_seg_tuning: {out} in {cli_s:.1f}s; launches "
        f"{cli_counts}, expected {want_cli}")
    best = Path(out["output_dir"]) / "checkpoint-best"
    loss = out["last_epoch"].get("train/loss", float("nan"))
    if not (np.isfinite(loss) and np.isfinite(out["max_miou"])
            and best.is_dir()):
        raise AssertionError(f"seg tuning: loss {loss}, mIoU "
                             f"{out['max_miou']}, checkpoint-best "
                             f"{best.is_dir()}")
    if cli_counts != want_cli:
        raise AssertionError(f"seg tuning launches {cli_counts} != "
                             f"{want_cli}")

    # 2. the bare step, built as the entry point builds it
    args = rst.process_args(parse_with_yaml(rst.get_parser(), argv))
    _, model, opt, _, loss_fn = rst.setup(args, torch.device("cuda"))
    state = init_train_state(model, opt)
    step = make_train_step(loss_fn, opt)
    ds = MultiTaskImageFolder(str(args.train_data_path), args.all_domains,
                              mapping=args.mapping,
                              transform=SemSegTransform(True, 1024))
    items = [ds[(i, np.random.default_rng(i))][0] for i in range(SEG_BATCH)]
    batch = rst.to_device({k: np.stack([it[k] for it in items])
                           for k in items[0]}, "cuda")
    names = [n for n, p in state["params"].items() if p.requires_grad]

    def loss_and_grads():
        gen = rst.step_generator(SEED, 0, "cuda")
        loss, _ = loss_fn(batch, generator=gen)
        return loss.detach(), torch.autograd.grad(
            loss, [state["params"][n] for n in names])

    loss_k, grads_k = loss_and_grads()
    with runtime.plain_on_card():
        loss_p, grads_p = loss_and_grads()
    leaf = {n: ((g - w).norm() / w.norm()).item()
            for n, g, w in zip(names, grads_k, grads_p)}
    worst = max(leaf, key=leaf.get)
    agree = {"loss": loss_k.item(), "plain_loss": loss_p.item(),
             "loss_rel": abs(loss_k.item() - loss_p.item())
             / abs(loss_p.item()),
             "worst_leaf": worst, "worst_leaf_rel_l2": leaf[worst],
             "leaves": len(leaf)}
    log(f"[seg] one step, kernel path vs plain path (bf16, card, same "
        f"drop-path draws): {agree}")
    del grads_k, grads_p
    if not (agree["loss_rel"] <= TRAIN_LOSS_REL
            and agree["worst_leaf_rel_l2"] <= TRAIN_LEAF_REL):
        raise AssertionError(f"seg kernel step disagrees with the plain step:"
                             f" {agree} (bars loss {TRAIN_LOSS_REL}, leaf "
                             f"{TRAIN_LEAF_REL})")

    # 3. launches per eval forward and per train step, exactly
    reset()
    with torch.no_grad():
        model.forward_light({"bscan": batch["bscan"]})
    torch.cuda.synchronize()
    eval_counts = read()
    lr = 1e-4
    for it in range(2):
        state, _ = step(state, batch, rst.step_generator(SEED, it, "cuda"), lr)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset()
    metrics = []
    t2 = time.perf_counter()
    for it in range(SEG_STEPS):
        state, m = step(state, batch, rst.step_generator(SEED, it, "cuda"),
                        lr)
        metrics.append(m)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t2) / SEG_STEPS
    step_counts = read()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    want_steps = {k: v * SEG_STEPS for k, v in SEG_PER_STEP.items()}
    losses = [{k: v.item() for k, v in mm.items()} for mm in metrics]
    log(f"[seg] eval forward launches {eval_counts}, expected {SEG_PER_EVAL}"
        f"; {SEG_STEPS} steps: launches {step_counts}, expected "
        f"{want_steps}; metrics {losses}")
    if eval_counts != SEG_PER_EVAL or step_counts != want_steps:
        raise AssertionError(f"seg launch counts: eval {eval_counts}, steps "
                             f"{step_counts}")
    if not all(np.isfinite(v) for mm in losses for v in mm.values()):
        raise AssertionError(f"non-finite seg loss or grad norm: {losses}")
    prof = profile_forward(
        lambda: step(state, batch, rst.step_generator(SEED, 9, "cuda"), lr),
        top_n=25)
    log(f"[seg] one step under torch.profiler: "
        f"{prof if prof else 'no device kernels seen (not measured)'}")
    b = batch["bscan"].shape[0]
    log(f"[seg] batch {b}: {dt * 1e3:.2f} ms/step, {b / dt:.2f} img/s, peak "
        f"memory {peak:.1f} GiB, on {card}")
    return {"batch": b, "ms_per_step": dt * 1e3, "img_per_s": b / dt,
            "peak_gib": peak, "agreement": agree, "cli": out,
            "cli_seconds": cli_s, "cli_counts": cli_counts,
            "eval_counts": eval_counts, "step_counts": step_counts,
            "losses": losses, "profile": prof, "card": card}


# ------------------------------------------------------------------ phase 7

CLS_BATCH = 64  # the CLI's cap on the auto batch size
CLS_STEPS = 3  # timed steps, after one warm-up step
# images per class of the synthetic set: 2 steps at batch 64 (129 train
# images make 3 batches, 2 run), one validation batch and one test batch
CLS_SPLITS = {"train": 43, "val": 10, "test": 2}
CLS_CLASSES = ("AMD", "DME", "NORMAL")
# launches per full fine-tune step (ViT-B at 257 tokens, 12 layers: LN ->
# B6 -> residual, then B2 / B5), per linear-probe step and per eval forward
# (the fused halves B1 + B2)
CLS_ZERO = {k: 0 for k in PER_STEP}
CLS_PER_STEP = {**CLS_ZERO, "block_attention": 12, "block_attention_bwd": 12,
                "mlp_block": 12, "mlp_block_bwd": 12}
CLS_PER_STEP_ON = {**CLS_PER_STEP, "mlp_block_bwd": 0,
                   "mlp_block_acc_bwd": 12, "fused_adamw": 1}
CLS_PER_EVAL = {**CLS_ZERO, "attn_half_block": 12, "mlp_block": 12}


def _cls_dataset(root, rng):
    """Seeded non-square uint8 B-scans (496 × 768, the shape of a common
    OCT export) in the class-folder layout, a per-class brightness offset
    so that the classes differ."""
    import numpy as np

    for split, n in CLS_SPLITS.items():
        for k, c in enumerate(CLS_CLASSES):
            d = root / split / c
            d.mkdir(parents=True, exist_ok=True)
            for i in range(n):
                img = rng.random((496, 768), dtype=np.float32) * 160 + 40 * k
                np.save(d / f"{c}_{i:03d}.npy", img.astype(np.uint8))


def phase_cls(workdir, card):
    """Classification tuning: run_cls_tuning.main at full width (MIRAGE-Base
    picked from a weights name holding mirage-base, one 512² B-scan at
    patch 32 -> 257 tokens, the global pool, batch 64, bf16 compute with
    float32 parameters, AdamW (0.9, 0.999), wd 1e-2, lr 1e-5, label
    smoothing 0.1) on a seeded synthetic class folder with seeded random
    MIRAGE-Base weights; then the bare step at batch 64 three ways (default
    switches, the switches on, linear probing), each against its plain step,
    with exact launch counts, ms/step, peak memory and one profile."""
    import numpy as np
    import torch

    from mirage_tpu_torch.api.wrapper import build_model as build_pretrain
    from mirage_tpu_torch.cli import run_cls_tuning as rct
    from mirage_tpu_torch.cli.config import parse_with_yaml
    from mirage_tpu_torch.data.folder import ImageFolder
    from mirage_tpu_torch.ops import runtime
    from mirage_tpu_torch.ops.fused_adamw import fused_adamw
    from mirage_tpu_torch.train.steps import init_train_state, make_train_step

    counters = _launch_counters()

    def reset():
        for fn, attr in counters.values():
            setattr(fn, attr, 0)

    def read():
        return {k: getattr(fn, attr) for k, (fn, attr) in counters.items()
                if k in CLS_ZERO}

    t0 = time.perf_counter()
    root = workdir / "cls"
    _cls_dataset(root / "data" / "OCTID", np.random.default_rng(SEED))
    domains = ["bscan", "slo", "bscanlayermap"]
    pre_args = dict(model="miragepre_base", num_global_tokens=1,
                    in_domains=domains, out_domains=domains, decoder_dim=256,
                    decoder_depth=2, decoder_num_heads=8)
    weights = root / "mirage-base_seed0.pth"
    torch.save({"model": build_pretrain(
        "miragepre_base", pre_args, domains, 512, 32,
        generator=torch.Generator().manual_seed(SEED)).state_dict(),
        "args": pre_args}, weights)
    log(f"[cls] dataset and MIRAGE-Base weights from seed {SEED} in "
        f"{time.perf_counter() - t0:.1f}s")

    # 1. the entry point: 2 steps, a validation batch, the test batch
    argv = ["--data_root", str(root / "data"), "--data_set", "OCTID",
            "--weights", str(weights), "--device", "cuda", "--epochs", "1",
            "--batch_size", str(CLS_BATCH), "--max_steps_per_epoch", "2",
            "--output_dir", str(root / "out"), "--num_workers", "8",
            "--seed", str(SEED)]
    reset()
    t1 = time.perf_counter()
    stats = rct.main(argv)
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t1
    cli_counts = read()
    run = next((root / "out" / "v1" / str(SEED) / "OCTID").iterdir())
    rows = (run / "train_eval.csv").read_text().splitlines()
    want_cli = {k: 2 * CLS_PER_STEP[k] + 2 * CLS_PER_EVAL[k]
                for k in CLS_ZERO}
    missing = [m for m in ("sklearn", "pandas", "jax") if m in sys.modules]
    log(f"[cls] run_cls_tuning in {cli_s:.1f}s: {run.name}; test stats "
        f"{dict(stats)}; train_eval.csv {rows}; launches {cli_counts}, "
        f"expected {want_cli}; imported of sklearn/pandas/jax: {missing}")
    loss = float(rows[-1].split(",")[1])
    if not (np.isfinite(loss) and (run / "checkpoint-best").is_dir()
            and (run / "valid_eval.csv").is_file()
            and (run / "test_eval.csv").is_file()) or missing:
        raise AssertionError(f"cls tuning: loss {loss}, outputs of {run}")
    if cli_counts != want_cli:
        raise AssertionError(f"cls tuning launches {cli_counts} != "
                             f"{want_cli}")

    # 2. the bare step, built as the entry point builds it
    ds = None
    results = {}
    for way, extra, switches, per_step in (
            ("full fine-tune", [], {}, CLS_PER_STEP),
            ("full fine-tune, switches on", [], SWITCHES_ON,
             CLS_PER_STEP_ON),
            ("linear probe", ["--linear_probing"], {},
             {**CLS_ZERO, "attn_half_block": 12, "mlp_block": 12})):
        if not switches:  # the switches-on way reuses the fine-tune model
            args = rct.process_args(parse_with_yaml(rct.get_parser(),
                                                    argv + extra))
            fm, model, opt, loss_fn = rct.setup(args, torch.device("cuda"))
            state = init_train_state(model, opt)
            step = make_train_step(loss_fn, opt)
        if ds is None:
            ds = ImageFolder(str(Path(args.data_path) / "train"),
                             transform=fm.build_transform(
                                 train=True, input_size=args.input_size,
                                 fill=args.fill))
            items = [ds[(i, np.random.default_rng(i))]
                     for i in range(CLS_BATCH)]
            batch = {"images": torch.from_numpy(np.stack(
                         [it[0] for it in items])).cuda(),
                     "targets": torch.tensor([it[1] for it in items]).cuda(),
                     "weights": torch.ones(CLS_BATCH, device="cuda")}
        names = [n for n, p in state["params"].items() if p.requires_grad]

        def loss_and_grads():
            loss, _ = loss_fn(batch)
            return loss.detach(), torch.autograd.grad(
                loss, [state["params"][n] for n in names])

        with runtime.switched(switches):
            reset()
            loss_k, grads_k = loss_and_grads()
            torch.cuda.synchronize()
            one_pass = read()
            with runtime.plain_on_card():
                loss_p, grads_p = loss_and_grads()
            agree = _agreement(loss_k, grads_k, loss_p, grads_p, names)
            del grads_k, grads_p
            log(f"[cls] {way}: one step, kernel path vs plain path (bf16, "
                f"card): {agree}")
            _check_agreement(f"cls {way}", agree)
            want_pass = {**per_step, "fused_adamw": 0}
            if one_pass != want_pass:
                raise AssertionError(f"cls {way}: launches in one forward+"
                                     f"backward {one_pass} != {want_pass}")
            before = {n: p.detach().clone() for n, p in
                      state["params"].items()}
            lr = 1e-3 if "--linear_probing" in extra else 1e-5
            state, _ = step(state, batch, None, lr)
            torch.cuda.synchronize()
            changed = sorted(n for n, p in state["params"].items()
                             if not torch.equal(p, before[n]))
            del before
            torch.cuda.reset_peak_memory_stats()
            reset()
            t2 = time.perf_counter()
            metrics = []
            for _ in range(CLS_STEPS):
                state, m = step(state, batch, None, lr)
                metrics.append(m["loss"])
            torch.cuda.synchronize()
            dt = (time.perf_counter() - t2) / CLS_STEPS
            counts = read()
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            prof = profile_forward(lambda: step(state, batch, None, lr),
                                   top_n=20)
        losses = [v.item() for v in metrics]
        expected = {k: v * CLS_STEPS for k, v in per_step.items()}
        leaves = fused_adamw.last_routed_count if switches else 0
        want_leaves = 49 if switches else 0
        log(f"[cls] {way}: {CLS_STEPS} steps, launches {counts}, expected "
            f"{expected}; B11 leaves {leaves}, expected {want_leaves}; "
            f"losses {losses}; {dt * 1e3:.2f} ms/step, "
            f"{CLS_BATCH / dt:.1f} img/s, peak memory {peak:.2f} GiB, on "
            f"{card}; one step under torch.profiler: "
            f"{prof if prof else 'no device kernels seen (not measured)'}")
        if counts != expected or leaves != want_leaves \
                or not all(np.isfinite(losses)):
            raise AssertionError(f"cls {way}: launches {counts}, leaves "
                                 f"{leaves}, losses {losses}")
        if "--linear_probing" in extra and changed != ["head.bias",
                                                        "head.weight"]:
            raise AssertionError(f"linear probe changed {changed}")
        if "--linear_probing" not in extra and len(changed) != len(names):
            raise AssertionError(f"full fine-tune changed {len(changed)} of "
                                 f"{len(names)} trainable tensors")
        results[way] = {"agreement": agree, "counts": counts,
                        "one_pass": one_pass, "b11_leaves": leaves,
                        "ms_per_step": dt * 1e3,
                        "img_per_s": CLS_BATCH / dt, "peak_gib": peak,
                        "losses": losses, "changed_tensors": len(changed),
                        "profile": prof}
    return {"batch": CLS_BATCH, "cli": dict(stats), "cli_seconds": cli_s,
            "cli_counts": cli_counts, "steps": results, "card": card}


# ------------------------------------------------------------------ phase 8

HF_ATOL = 1e-4  # hf (plain PyTorch, cuBLAS) vs the wrapper's kernels, float32


def phase_infer(workdir, card, path):
    """cli/infer.main (reconstructions, then --features) over two seeded
    subjects at raw sizes that are not 512², with the MIRAGE-Large weights
    of phase 4; the features against MIRAGEWrapper.features on the same
    input. The same weights written as model.safetensors (numpy) and read by
    hf.MIRAGEWrapper.from_pretrained(dir) and by MIRAGEWrapper through the
    repaired reader: their batch-64 float32 features agree."""
    import shutil

    import numpy as np
    import torch

    from mirage_tpu_torch import hf
    from mirage_tpu_torch.api.convert import (load_torch_checkpoint,
                                              save_safetensors)
    from mirage_tpu_torch.api.wrapper import MIRAGEWrapper
    from mirage_tpu_torch.cli import infer

    root = workdir / "infer"
    shutil.rmtree(root, ignore_errors=True)
    rng = np.random.default_rng(SEED)
    subjects = []
    for i, (h, w) in enumerate([(496, 768), (650, 512)]):
        d = root / "images" / f"subject{i}"
        d.mkdir(parents=True)
        np.save(d / "bscan.npy", (rng.random((h, w)) * 255).astype(np.float32))
        np.save(d / "slo.npy", (rng.random((w, w)) * 255).astype(np.uint8))
        np.save(d / "bscanlayermap.npy",
                rng.integers(0, 13, (h // 2, w // 2)).astype(np.uint8))
        subjects.append(d)
    t0 = time.perf_counter()
    argv = ["--weights", str(path), "--image_path", str(root / "images"),
            "--device", "cuda"]
    infer.main(argv)
    infer.main(argv + ["--features"])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    pngs = {}
    from PIL import Image

    for d in subjects:
        for task, shape in (("bscan", (512, 512)), ("slo", (512, 512)),
                            ("bscanlayermap", (128, 128))):
            img = np.asarray(Image.open(d / f"__out_{task}.png"))
            pngs[f"{d.name}/{task}"] = list(img.shape)
            if img.shape != shape:
                raise AssertionError(f"{d.name} {task}: PNG {img.shape}")
    wrapper = MIRAGEWrapper(weights=str(path), output_adapters=False,
                            device="cuda")
    feat_err = 0.0
    for d in subjects:
        saved = np.load(d / "__out_features.npy")
        want = wrapper.features({"bscan": infer.to_array(d / "bscan.npy")})
        if saved.shape != (1, 257, 1024) or not np.isfinite(saved).all():
            raise AssertionError(f"{d.name}: features {saved.shape}")
        feat_err = max(feat_err, float(np.abs(saved - want.cpu().numpy()
                                              ).max()))
    log(f"[infer] cli/infer.main, 2 subjects, reconstruct + --features in "
        f"{cli_s:.1f}s; PNGs {pngs}; features vs MIRAGEWrapper.features "
        f"max_abs {feat_err:.3e}")
    if feat_err > 1e-5:
        raise AssertionError(f"infer features differ by {feat_err}")

    # the same weights as model.safetensors: hf.py and the wrapper
    hf_dir = root / "hf"
    hf_dir.mkdir()
    save_safetensors(load_torch_checkpoint(str(path))["model"],
                     str(hf_dir / "model.safetensors"))
    t1 = time.perf_counter()
    model = hf.MIRAGEWrapper.from_pretrained(str(hf_dir), size="large",
                                             modalities="bscan")
    st_wrapper = MIRAGEWrapper(weights=str(hf_dir / "model.safetensors"),
                               modalities="bscan",
                               model_override="miragepre_large",
                               output_adapters=False, device="cuda")
    load_s = time.perf_counter() - t1
    x = {"bscan": rng.random((BATCH, 1, 512, 512), dtype=np.float32)}
    f_hf = model(x)
    f_st = st_wrapper.features(x)
    f_pth = wrapper.features(x)
    torch.cuda.synchronize()
    same = torch.equal(f_st, f_pth)
    hf_err = (f_hf - f_st).abs().max().item()
    scale = f_st.abs().max().item()
    log(f"[infer] model.safetensors read by hf.py and MIRAGEWrapper in "
        f"{load_s:.1f}s; batch-{BATCH} features {tuple(f_hf.shape)}: hf vs "
        f"wrapper max_abs {hf_err:.3e} (features up to {scale:.2f}; bar "
        f"{HF_ATOL}); wrapper from .safetensors bit-equal to the .pth's "
        f"{same}; on {card}")
    if not same or hf_err > HF_ATOL or tuple(f_hf.shape) != (BATCH, 257,
                                                              1024):
        raise AssertionError(f"hf / safetensors features: max_abs {hf_err}, "
                             f"bit-equal {same}")
    return {"cli_seconds": cli_s, "pngs": pngs, "features_max_abs": feat_err,
            "hf_vs_wrapper_max_abs": hf_err, "features_max": scale,
            "safetensors_bit_equal_to_pth": same, "load_seconds": load_s}


# --------------------------------------------------------------------- main

def _kernel_entries(kernel_rows, counts, per_path, path, times_are=None,
                    **per_other_path):
    """One entry of the `kernels` line per op: per-call rows at each shape,
    and times summed over one pass of the main path (per-call time × calls
    on the path); ``per_other_path``: name -> {op: launches} of other
    passes of the same path (e.g. an eval forward)."""
    entries = []
    for name, rows in kernel_rows.items():
        key = "calls_per_forward" if path == "forward" else "calls_per_step"
        main_rows = [r for r in rows if r.get(key)]
        per_path_sum = lambda k: sum(r[k] * r[key] for r in main_rows)  # noqa
        top = max(main_rows, key=lambda r: r["bound_ms"] * r[key])
        if name in TPU_KERNELS:
            replaces, tpu_kernel = TPU_KERNELS[name]
            source, csrc = SOURCES[name]
        else:
            replaces, tpu_kernel, source, csrc = {
                **BWD_KERNELS, **SEG_KERNELS, **ACC_KERNELS,
                **SERVE_KERNELS}[name]
            csrc = [CSRC + f for f in csrc]
        ms = per_path_sum("ms")
        entries.append({
            "name": name, "route": "cuda", "source": source, "csrc": csrc,
            "replaces": replaces, "tpu_kernel": tpu_kernel,
            "launches": counts[name], f"launches_per_{path}": per_path[name],
            **{f"launches_per_{k}": v[name] for k, v in per_other_path.items()},
            "max_abs_err": max([r["max_abs_err"] for r in rows
                                if r["dtype"] == "bf16"]
                               or [r["max_abs_err"] for r in rows]),
            "max_err": max(r["max_abs_err"] for r in rows),
            "ms": ms, "kernel_ms": ms, "plain_ms": per_path_sum("plain_ms"),
            "bound_ms": per_path_sum("bound_ms"), "bound_by": top["bound_by"],
            "library_ms": per_path_sum("library_ms"),
            "library": top.get("library", (
                "composite of F.layer_norm, F.linear, F.gelu, "
                "F.scaled_dot_product_attention"
                + (" and torch.autograd.grad" if path == "step" else ""))),
            "times_are": times_are or (
                f"sum over one batch-{BATCH} reconstruct forward"
                if path == "forward" else
                f"sum over one batch-{TRAIN_BATCH} pretraining step"),
            "shapes": rows,
        })
    return entries


def _op_entries(rows_by_op, launches):
    """Entries of the `kernels` line for the ops no path calls (B12, B9′):
    times per call at their first (main) shape, launches from their own
    timed calls."""
    entries = []
    for name in ("mlp_block_q", "mlp_block_fwd_stash3d"):
        rows = rows_by_op[name]
        main = rows[0]
        replaces, tpu_kernel, source, csrc = SERVE_KERNELS[name]
        entries.append({
            "name": name, "route": "cuda", "source": source,
            "csrc": [CSRC + f for f in csrc], "replaces": replaces,
            "tpu_kernel": tpu_kernel, "launches": launches[name],
            "launches_are": "the op's own timed calls in phase 2: no caller "
                            "in either package",
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "max_err": max(r["max_abs_err"] for r in rows),
            "ms": main["ms"], "kernel_ms": main["ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": main["library_ms"],
            "library": main.get("library", "composite of F.layer_norm, "
                                           "F.linear, F.gelu"),
            "times_are": f"per call at {main['shape']}", "shapes": rows})
    return entries


PHASES = ("build", "kernels", "golden", "serve", "train", "seg", "cls",
          "infer")


def main(argv=None):
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES)
                    + " (a partial run prints no result line)")
    opts = ap.parse_args(argv)
    phases = opts.phases.split(",")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if not (ROOT / "mirage_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository (no "
              "mirage_tpu_torch/ beside this script)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    card = card_line()
    log(f"[card] {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    workdir = ROOT / "build" / "mirage_tpu_torch" / "smoke"
    workdir.mkdir(parents=True, exist_ok=True)

    if "build" in phases:
        phase_build()
    fwd_rows = bwd_rows = seg_rows = golden = train = seg = cls = None
    infer = None
    if "kernels" in phases:
        from mirage_tpu_torch.ops.fused_mlp import mlp_block_fwd_stash3d
        from mirage_tpu_torch.ops.quant import mlp_block_q

        fwd_rows = phase_kernels()
        bwd_rows = phase_backward({})
        seg_rows = phase_seg_kernels({})
        acc_pre_rows, acc_cls_rows = phase_acc_kernels()
        serve_rows = phase_serve_kernels({})
        op_launches = {"mlp_block_q": mlp_block_q.launches,
                       "mlp_block_fwd_stash3d": mlp_block_fwd_stash3d.launches}
    if "golden" in phases:
        golden = phase_golden(workdir)
    if {"serve", "infer"} & set(phases):
        large = _large_weights(workdir)
    if "serve" in phases:
        counts, n_rec, tput = phase_serve(workdir, card, large)
    if "train" in phases:
        train = phase_train(card)
    if "seg" in phases:
        seg = phase_seg(workdir, card)
    if "cls" in phases:
        cls = phase_cls(workdir, card)
    if "infer" in phases:
        infer = phase_infer(workdir, card, large)
    if set(phases) != set(PHASES):
        log(f"[partial] phases {phases} passed in "
            f"{time.perf_counter() - t_start:.1f}s; no result line")
        return 0

    entries = (_kernel_entries(fwd_rows, counts, PER_RECONSTRUCT, "forward")
               + _kernel_entries(bwd_rows, train["counts"], PER_STEP,
                                 "step")
               + _kernel_entries(
                   seg_rows, seg["cli_counts"], SEG_PER_STEP, "step",
                   "sum over one batch-4 segmentation tuning step; launches "
                   "from run_seg_tuning (2 steps + 1 eval batch)",
                   eval_forward=SEG_PER_EVAL)
               + _kernel_entries(
                   acc_pre_rows, train["switches_on"]["counts"], PER_STEP_ON,
                   "step", f"sum over one batch-{TRAIN_BATCH} pretraining "
                   f"step with {SWITCHES_ON}; launches from "
                   f"{TRAIN_STEPS_ON} such steps")
               + _kernel_entries(
                   acc_cls_rows,
                   cls["steps"]["full fine-tune, switches on"]["counts"],
                   CLS_PER_STEP_ON, "step",
                   f"sum over one batch-{CLS_BATCH} classification full "
                   f"fine-tune step with {SWITCHES_ON}; launches from "
                   f"{CLS_STEPS} such steps")
               + _kernel_entries(
                   {"fused_block": serve_rows["fused_block"]},
                   tput["block_fuse"]["all"]["counts"],
                   PER_RECONSTRUCT_FUSE["all"], "forward",
                   f"sum over one batch-{BATCH} reconstruct forward under "
                   f"MIRAGE_BLOCK_FUSE=all; launches from that forward "
                   f"(6 under decoder: "
                   f"{tput['block_fuse']['decoder']['counts']['fused_block']})")
               + _op_entries(serve_rows, op_launches))
    log(json.dumps({"golden_max_abs": golden, "throughput": tput,
                    "train": train, "seg": seg, "cls": cls, "infer": infer,
                    "seconds": time.perf_counter() - t_start}))
    log(card)
    log(json.dumps({"kernels": entries}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
