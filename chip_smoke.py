#!/usr/bin/env python3
"""Runs the PyTorch/CUDA port (mirage_tpu_torch) end to end on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero):

1. build: compiles every csrc/*.cu with nvcc for sm_90a (one nvcc per
   source, in parallel) and prints each kernel's registers and shared memory;
   prints the card's name and power limit; builds the data path's host
   library (csrc/fastops.cpp, the host compiler) beside them and prints the
   compiler, its flags, the build time and the host's CPU. The attention forward
   (csrc/attention_fwd.cuh, in attention.cu and flash_attention.cu) must not
   spill nor have its wgmma serialized, and its libraries' SASS must hold
   HGMMA and no mma.sync forward; so must the ping-pong GEMM
   (csrc/gemm_pingpong.cuh) in gemm.cu (HGMMA) and quant.cu (IGMMA, no
   IMMA: no mma.sync int8 product is left).
2. kernels: each op (B1 attn_half_block, B2 mlp_block, B3 xattn_half_block)
   at the MIRAGE-Large main-path shapes in bf16 against its plain PyTorch
   version computed in float32 from the same bf16 inputs, plus one float32
   case per op; the backward ops B4-B6 at the pretraining shapes; B8
   flash_attention (forward and backward) at the segmentation encoder's
   (4, 12, 1025, 64) and the decoders' (64, 8, 256 × 769, 32), and B9 (the
   stash MLP pair) at (65536, 384) -> 1536; the bf16 GEMM alone at its path
   shapes (``gemm``: every serving product, the pretraining and seg ones,
   S5's A&S GELU) beside torch.matmul, and the int8 GEMM's S3 and B12
   products beside torch._int_mm; times the kernel, the plain
   version and a composite of PyTorch library calls with CUDA events. The
   attention forward alone (``attention_fwd``) at the serving encoder's,
   the decoders' (self and cross) and the pretraining B1's and B6's shapes
   beside SDPA; B8's rows hold its log-sum-exp to float32 math too. The
   attention backward alone (``attention_bwd``: B4's core and B6's at the
   pretraining and classification shapes; ``flash_bwd``: B8's at the seg
   encoder's and the decoders' cross shapes) beside SDPA's backward alone
   and SDPA's forward and backward; B6's backward also at the
   classification shape, and every backward op and kernel row reruns bit
   for bit the same. The LN kernel alone (``layernorm``: csrc/layernorm.cu,
   forward at the serving encoder's, the decoders' (queries and B3's
   context) and the pretraining shapes, backward at the pretraining and
   classification ones, each row naming the instantiation
   runtime.layernorm_plan picks, each rerun bit for bit) beside
   F.layer_norm and its autograd backward.
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
   seeded synthetic dataset, then --test on checkpoint-best (a 496 × 512
   test split of two volumes of two slices: the PNG export, exact
   launches), run_seg_eval on the export (the AROI layers/lesions CSVs,
   Dice and IoU in [0, 1]) and --infer_only skipping the finished export;
   the exported PNGs against the argmax of the same forward taken from the
   model, its logits against the plain path's (rel-L2 3e-2); the bare
   train step at batch 4: kernel step vs plain step, exact launch counts
   per step and per eval forward, ms/step, peak memory and a profile; then
   --output_adapter linear, segmenter and dpt through the entry point (2
   steps and a validation pass each, exact launches), and the Segmenter's
   step (its blocks take B8 and B2/B5) kernel vs plain, with its launches
   per step and per eval forward.
7. cls: classification tuning (MIRAGE-Base at 257 tokens, the global
   pool, batch 64) through run_cls_tuning.main on a seeded synthetic class
   folder with seeded MIRAGE-Base weights, then the bare step three ways
   (the default switches: B6, B2, B5 and B11 over every trainable leaf;
   MIRAGE_MLP_BWD=accumulate too: B7; linear probing: B1 + B2), each
   against the plain step, with exact launch counts, ms/step, peak memory
   and a profile.

8. infer: cli/infer.main on a seeded synthetic folder of two subjects at raw
   sizes that are not 512², with the MIRAGE-Large weights of phase 4
   (reconstructions and --features, the features held to MIRAGEWrapper's);
   the same weights written as model.safetensors and read by
   hf.MIRAGEWrapper.from_pretrained and by MIRAGEWrapper (the repaired
   reader): hf's batch-64 features against the wrapper's in float32; then
   cli/hf_push -t push of the weights (the encoder's tensors bit-equal to
   the checkpoint's) and -t load on the card (its features bit-equal to
   hf.py's from the .pth).
9. bench: the port's bench (mirage_tpu_torch.bench) through its entry
   points: bench.py's headline (MIRAGE-Large reconstruction at batch 512,
   its JSON line printed), the A/B cases S1 (B6 in a 24-layer chain), S3
   (the int8 GEMM, exact, against bf16), S4 (the next LN folded into B2's
   tail: csrc/gemm_lnfold.cu, and B1 from the pre-normed input) and S7 (B1
   and B2 at 257 tokens against 264 and 320, B1 masked), S2 (B1's
   attention in three phases: csrc/attention_phased.cu), S5 (B1's and B2's
   LN, softmax and GELU modes: the phased kernel's softmax modes, the LN
   kernel's one-pass mode, the GEMM epilogue's GELU formulas) and S6 (B2
   with the hidden on chip, csrc/mlp_chunked.cu; B1 with 2, 4 or 8 heads
   per block), each checked against its plain version and then timed, and
   the five scripts/bench_train.py rows (pretraining, seg twice, cls
   twice).
10. pretrain: the pretraining entry point, cli/run_pretraining.main, with
   configs/pretrain_mirage_98_1600e.yaml (ViT-B MultiMAE at batch 256, bf16)
   on a seeded dataset of 512 samples (uint8 .npy B-scans and SLOs at 512²,
   layer maps at 128²), warm-started from seeded ViT-B weights with MAE's
   blocks.{i} keys: one epoch of two steps, then a run to two epochs that
   resumes at epoch 1. Exact launch counts a train step (phase 5's, and one
   LN and LN backward in each B1, B2, B4 and B5; the epoch-0 debug
   forward's counted apart), finite losses, the warm start leaf for leaf,
   the pixel-space loss against the token-space loss on one loader batch
   (relative 1e-3), the wall time a step and the loader's share of it
   beside phase 5's bare step, and the peak memory of one step with and
   without --remat. One sample's read and augmentation split into stages
   (read, each task's affine warp, the resizes, the rest), through the host
   library and through the plain versions on the same samples and seeds,
   which must agree (images within 1e-5, label maps at 99.5 % of pixels),
   and the 8-worker loader's interval a batch of 256. cli/hf_push -t
   export of checkpoint-1, read by hf.py on the card: its float32 features
   against the checkpoint's model's (HF_ATOL).
11. parallel: multi-GPU training (mirage_tpu_torch/parallel, train/steps.py
   sharded steps). (a) One process, NCCL, world 1: phase 5's pretraining
   step (ViT-B, batch 256, bf16) with injected masks under dp (DDP), fsdp
   (FSDP2), tp (t = 1) and tp_fsdp (1 × 1), each against the bare step
   (the first step's loss, grad norm and every gradient, the second
   step's loss; phase 5's bars), exact launch counts (the tp layouts
   through Block.tp_forward: B6 and the LN / GEMM ops of ops/linear.py in
   place of B1 / B4), ms a step beside the bare step's; the pretraining
   command line one step with --distributed --num_processes 1. (b) Two
   processes on cuda:0 over gloo: tp = 2 and dp = 2 at global batch 256
   from the same weights and masks against (a)'s bare step within the same
   bars, exact launches, each rank's ms a step (printed, not compared: the
   processes share the card). (c) The GEMM (qkv, proj, fc1, fc2), B6's
   attention forward and backward and csrc/mlp_bwd.cu's hidden stage and
   dyln at the tensor-local shapes of ViT-B (t = 2, 4) and ViT-L (t = 4,
   8) against their plain versions (phase 2's bars), timed beside the
   plain versions, the library and the bound.
12. pipeline: GPipe pipeline parallelism and multi-device serving
   (mirage_tpu_torch/parallel/pp.py, the wrapper's mesh=).
   (a) Phase 5's bare step at batch 256 with injected masks, then the
   pipeline flag on a pipe = 1 mesh (one process, NCCL), equal to it with
   the same launches; two processes on cuda:0 over gloo, pipe = 2, M = 4,
   plain and with remat: the first step's loss, grad norm and every
   gradient (gathered to the standard layout) and the second step's loss
   against the bare step (phase 5's bars), each stage holding its six
   blocks, exact launches on each rank (B1/B4 and B2/B5 6 × 4 times, the
   decoders replicated), each rank's ms a step (printed, not compared).
   (b) The wrapper (MIRAGE-Large, bf16) with a mesh of one bit-equal to
   the plain wrapper at batch 64, 3 and 1 for __call__ and features with
   exact launches; two replicas on cuda:0 (two threads, two streams)
   within phase 4's bar with exact launches (twice one forward's), their img/s beside the plain wrapper's and the
   overlap of their device time; the server over the mesh of one answering
   16 HTTP requests, p50 / p95. (c) The GEMM, B1, B2, B4, B5 and the LN at
   a microbatch of S = 2, M = 4 (6336 rows) and S = 4, M = 8 (3168), and
   the GEMM, B1, B2 and B3 at a serving replica's batch 32, against their
   plain versions (phase 2's bars), timed beside them, the library and the
   bound.
13. vit: the baseline ViT classifiers (mirage_tpu_torch/models/vit.py) at
   ViT-L/16 width (1024 wide, 24 layers, 16 heads; ImageNet-normalised RGB
   at 224² -> 197 tokens) from a seeded timm-keyed 224-grid checkpoint
   named vit_large, on a seeded RGB class folder. (a) run_cls_tuning.main
   at batch 64: two full fine-tune steps, a validation and a test pass,
   --eval and --save_predictions, then the same as a linear probe, with
   exact launches. (b) The bare step three ways (default switches: B6,
   B2, B5, B11; the switches on: B7-MLP; the linear
   probe: B1 + B2), each against the plain step with exact launches
   (VIT_PER_STEP), ms a step, peak memory and a profile; the eval forward
   against the plain path under MIRAGE_BLOCK_FUSE=off (B1 + B2) and all
   (B10). (c) At 512² from the 224-grid checkpoint (pos_embed resized,
   1025 tokens): the eval forward at batch 64 and a full fine-tune step at
   batch 16 through B8, against the plain path, with exact launches, ms a
   step, peak memory and a profile. (d) B1, B2, B6 forward and backward,
   B5 and B10 at (64, 197, 1024) and B8 at (16, 16, 1025, 64) against
   their plain versions (phase 2's bars). (e) The ViT-B/16 eval forward at
   batch 64 against the plain path.
14. decbatch: the decoders' tails as one task stack (MIRAGE_DEC_BATCH=on,
   adapters/spatial_output.py:batched_spatial_decode). (a) Each
   task-strided op and kernel at the three decoders' shapes (width 256,
   hidden 1024; 3·64·256 rows serving, 3·256·256 pretraining, B3's context
   3·64·257), bf16: B1, B2, B3, the GEMM (bias, GELU, residual) and the LN
   forward bit-equal to three one-task calls; B5, B7-MLP and the LN
   backward within phase 2's bars of them (the LN's dx bit-equal); each
   against its plain version (phase 2's bars), rerun bit for bit, timed
   beside the one-task calls, the plain version, the library over the
   stacked weights and the bound. (b) nn/block.py:DecoderBlock at batch 64,
   256 queries and 257 and 600 context tokens (the second through B8),
   forward and backward against its plain version with exact launches.
   (c) Phase 4's batch-64 MIRAGE-Large forward with the switch on against
   off and the plain path (MODEL_REL_L2), exact launches (DEC_PER_FORWARD:
   each decoder op once instead of three times). (d) Phase 5's
   pretraining step (remat on, injected masks) with the switch on, and with
   MIRAGE_MLP_BWD=accumulate too, against off: loss, grad norm and every
   leaf within phase 5's bars, exact launches (DEC_PER_STEP,
   DEC_PER_STEP_ACC). (e) Both arms of (c) and (d) timed in ABBA rounds
   (mirage_tpu_torch/bench/decbatch.py: CUDA events and the host clock).
15. sam: SAM ViT-H's relative-position attention (csrc/relpos_attention.cu,
   ops/relpos_attention.py) alone at its shapes, batch 4 of 1024² images:
   a windowed layer (25 windows of 14², 9 of them padded) and a global one
   (64² keys), 16 heads of 80, against its plain version in float32 from
   the same bf16 inputs (BF16_REL_L2, BF16_MAX_ABS), rerun bit for bit,
   timed with its host cost and the device's alone, its one kernel a call
   timed by torch.profiler, beside the plain version and the bound; a
   windowed call's TMA traffic, modelled from the shape, logged apart
   (``python3 chip_smoke.py --phases build,sam``); then the SAM ViT-H
   encoder's grad-free forward (the frozen-encoder step's, batch 4 at 1024²,
   bf16 compute) with the op's count of calls set to 0 before it: its calls
   and its kernels (those named relpos_attn*, from torch.profiler) counted
   in that forward, their device time in it, the port's launches counted
   to its spans and the forward's time. Phase 1 holds its kernels
   to the attention forward's rules: no spill, no serialized wgmma, HGMMA in
   librelpos_attention.so.

Phase 1 also prints the ptxas spill lines of the four redesigned kernels
(fused_block, attention_phased, mlp_chunked, gemm_stash), fails on a spill
in the last two and fails unless fused_block's SASS holds HGMMA (wgmma)
instructions; it prints the registers and spills of each of csrc/
layernorm.cu's 32 kernels (forward and backward, three width classes and
the generic kernel, x and the scale each in bf16 or float32) and fails on a
spill there. Phases 2 and 6 split the stash forward (B9′, B9) into its
launches (LN, fc1 with the stash epilogue, the same product with B2's GELU
epilogue and with none, fc2) and hold its act bit-equal to B2's fc1;
phase 9 times S6a at R = 1 and 2 row tiles a cluster. Phase 2 splits B5
and B7-MLP (the MLP backward: LN, the hidden stage of csrc/mlp_bwd.cu,
dyln, the LN backward, the weight gradients, the column sums) into their
launches at the pretraining encoder and decoder and the classification
shapes (torch.profiler, ``mlp_bwd_split``), holds the hidden stage's act
bit-equal to B2's fc1 and reruns B5, B7 and B9's backward bit for bit.
Phase 2 also holds the accumulating backwards (B7, both halves, the MLP
half with residual=False too) and the AdamW update (B11) against
their plain versions, and phase 5 runs the pretraining step once more with
the three switches on (B7 for both halves). Phase 2 checks the whole-block
kernel (B10, a persistent cooperative grid) at the decoder and MIRAGE-Large
encoder shapes beside B1 + B2, with its GEMM tile widths swept and its time
by stage, the int8 MLP (B12; reruns bit for bit) and the 3-D stash forward
(B9′; bit-equal to B2); phase 3 replays the MIRAGE-Base
golden (tests/golden/example_triplet_base.npz, seeded full-size weights)
under MIRAGE_BLOCK_FUSE=off and all; phase 4 serves MIRAGE-Large at batch
64 under MIRAGE_BLOCK_FUSE=off, decoder and all.

``--phases`` runs a subset (a partial run prints no result line).
``--attn-split [CSRC]`` only times the attention forward at its main-path
shapes (ATTN_SHAPES), built from CSRC (default this checkout's csrc/) whole
and without P·V, without the softmax, and without any product (the loads
alone), beside SDPA and the bound; the C entries it calls are the parent's
too, so a copy of an older csrc/ with the same macros is timed the same
way.
``--attn-bwd-split [CSRC]`` only times the bf16 attention backward at its
path shapes (ATTN_BWD_SHAPES), built from CSRC whole and without the dQ
products, the dK/dV kernel, the exponentials, or every product, beside
SDPA's backward alone, SDPA's forward and backward and the bound, and splits
B4's chain into its launches; its C entries and macro names are the
parent's too, so a copy of this script in an older checkout (its sources
given the macros) times that tree the same way.
``--gemm-split [CSRC]`` only times the bf16 GEMM (mtt_gemm,
mtt_gemm_gelu_mode) and the int8 GEMM (mtt_gemm_s8) at GEMM_SHAPES and
GEMM_S8_SHAPES, built from CSRC whole, without the epilogue's math, without
the store, the loads alone and without the cluster's multicast, beside
torch.matmul, the F.linear composition or torch._int_mm and the bound,
then B9's backward of the checkout it runs in; its C entries and macro
names are the parent's too, so a copy of this script in an older
checkout's root times that tree (its sources given the macros).
``--multi-card`` runs only what exists across cards, on every card of the
machine (at least two; the pipelines need four): phase 5's bare step on
cuda:0, then one process a card over NCCL through the pipelines of
MULTI_PIPES (data 2 × pipe 2 at M = 4, pipe 4 at M = 8) against it with
exact launches, then the wrapper with one replica a card against the
plain wrapper on cuda:0 at batch 64, 3 and 1, with img/s and each card's
device time.
``--mlp-bwd-split`` only times B5 and B7-MLP at their three shapes beside
the library call and the bound, each split into its launches; it calls
only the two backward ops, so a copy of this script in an older
checkout's root times that tree the same way (an A/B of parent and
change). The line
before the last is a JSON object with one entry per kernel; the card's name
and power limit come before it; the last line is {"ok": true, "device":
{...}}.
"""

import hashlib
import io
import json
import math
import re
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
# the flash forward's log-sum-exp (log2 units) against float32 math from the
# same bf16 inputs: both sum float products of the same bf16 values
LSE_ATOL = 1e-3
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
    # the attention core inside B1's and B3's kernels (and B6's, B8's)
    "attention_fwd": ("mirage_tpu/ops/block_attention.py:251",
                      "the attention of _attn_half_kernel :251, "
                      "_xattn_half_kernel :745, _block_attn_kernel :58 and "
                      "flash_attention.py:_attn_kernel :42"),
    # the matrix products inside B1's, B2's and B3's kernels
    "gemm": ("mirage_tpu/ops/fused_mlp.py:58",
             "the products of _mlp_kernel :58, block_attention.py:"
             "_attn_half_kernel :251 and _xattn_half_kernel :745"),
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
    "attention_fwd": ("mirage_tpu_torch/csrc/attention_fwd.cuh",
                      [CSRC + f for f in ("attention_fwd.cuh", "attention.cu",
                                          "flash_attention.cu")]),
    "gemm": ("mirage_tpu_torch/csrc/gemm_pingpong.cuh",
             [CSRC + f for f in ("gemm_pingpong.cuh", "gemm.cu")]),
}
# launches of each op per reconstruct / features forward on the main path
# (attention_fwd: runtime.attention's launches of the forward kernel, one
# in each B1 and B3; gemm: the bf16 GEMM's, two in each B1 and B2, three in
# each B3)
PER_RECONSTRUCT = {"attn_half_block": 30, "mlp_block": 33,
                   "xattn_half_block": 3, "attention_fwd": 33, "gemm": 135}
PER_FEATURES = {"attn_half_block": 24, "mlp_block": 24,
                "xattn_half_block": 0, "attention_fwd": 24, "gemm": 96}


# the port's CUDA kernels by function name -> their group in a profile (the
# bf16 forward of csrc/attention_fwd.cuh and backward of
# csrc/attention_bwd.cuh serve both the packed and the flash entries: B8's
# forward is in "attention" and its bf16 backward in "attention_bwd" too)
PORT_KERNELS = {"gemm_bf16_pingpong": "gemm",
                "gemm_bf16_pingpong_tasks": "gemm", "gemm_f32_kernel": "gemm",
                "gemm_stash_kernel": "gemm_stash",
                "gemm_stash_f32_kernel": "gemm_stash",
                "attn_fwd::attention_fwd_kernel": "attention",
                "attention_f32_kernel": "attention",
                "attn_bwd::dq_kernel": "attention_bwd",
                "attn_bwd::dkv_kernel": "attention_bwd",
                "attn_bwd::head_kernel": "attention_bwd",
                "attn_bwd_dq_f32_kernel": "attention_bwd",
                "attn_bwd_dkv_f32_kernel": "attention_bwd",
                "layernorm_kernel": "layernorm",
                "layernorm_generic_kernel": "layernorm",
                "layernorm_bwd_kernel": "layernorm_bwd",
                "layernorm_bwd_generic_kernel": "layernorm_bwd",
                "flash_fwd_f32_kernel": "flash_attention",
                "flash_bwd_dq_f32_kernel": "flash_attention_bwd",
                "flash_bwd_dkv_f32_kernel": "flash_attention_bwd",
                "wgrad_bf16_kernel": "wgrad", "wgrad_f32_kernel": "wgrad",
                "colsum_kernel": "wgrad", "chunk_sum_kernel": "wgrad",
                "adamw_tiles_kernel": "adamw", "adamw_norm_kernel": "adamw",
                "fused_block_kernel": "fused_block",
                "ln_quant_kernel": "quant", "quant_rows_kernel": "quant",
                "gemm_s8_pingpong": "quant",
                "gemm_lnfold_kernel": "gemm_lnfold",
                "attention_phased_resident": "attention_phased",
                "attention_phased_staged": "attention_phased",
                "mlp_chunked_kernel": "mlp_chunked",
                "mlp_bwd_hidden_kernel": "mlp_bwd",
                "mlp_bwd_hidden_f32_kernel": "mlp_bwd",
                "mlp_bwd_dyln_kernel": "mlp_bwd",
                "mlp_bwd_dyln_f32_kernel": "mlp_bwd",
                "relpos_attn_kernel": "relpos_attention"}


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


def device_ms(fn, iters=20, warmup=3, repeats=3):
    """Milliseconds per call of the device alone: `iters` calls queued
    behind a ≈ 5 ms device sleep, so the host's launch cost is hidden and
    CUDA events time the calls back to back; the median of `repeats`."""
    import torch

    for _ in range(warmup):
        fn()
    runs = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(10_000_000)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        runs.append(start.elapsed_time(end) / iters)
    return sorted(runs)[len(runs) // 2]


def device_kernels(prof):
    """[(start, end, name)] in µs of the device's work in a finished
    torch.profiler window, sorted: its CUDA events less the user
    annotations, the ``record_function`` ranges (the port's ``mirage.*``
    spans) that the profiler mirrors on the device, which are no work."""
    from torch.autograd import DeviceType

    def annotation(e):
        flag = getattr(e, "is_user_annotation", False)
        return bool(flag() if callable(flag) else flag)

    return sorted((e.time_range.start, e.time_range.end, e.name)
                  for e in prof.events()
                  if e.device_type == DeviceType.CUDA and not annotation(e))


def forget_spans():
    """Clears the port's recorded spans (``utils/profiling.py:reset``)
    before a profiler window, so that the windows of one process do not
    add up; an older checkout records none."""
    from mirage_tpu_torch.utils import profiling

    getattr(profiling, "reset", lambda: None)()


def profile_forward(fn, top_n=0):
    """Device time of one call of `fn` by kernel group, from torch.profiler:
    {group: ms}, the device span from the first kernel's start to the last
    one's end, the share of that span with no kernel running, and the
    `top_n` kernels by device time. None if the profiler saw no device
    kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    forget_spans()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    spans = device_kernels(prof)
    if not spans:
        return None
    groups, by_name = {}, {}
    busy, cur_start, cur_end = 0.0, spans[0][0], spans[0][1]
    for start, end, name in spans:
        # "void gemm_bf16_pingpong<0, false>(...)", "void attn_fwd::..."
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

# the kernels redesigned for Hopper whose ptxas report must show no spill
NO_SPILL = ("mlp_chunked", "gemm_stash", "mlp_bwd", "wgrad", "gemm", "quant",
            "layernorm")


def _ln_instantiations(report):
    """csrc/layernorm.cu's kernels from its ptxas report: [(label, the
    report's register and spill lines)], the label demangled from
    "_Z16layernorm_kernelI13__nv_bfloat16fLi1024EEv..." to
    "layernorm_kernel<bf16, float, 1024>"."""
    out = []
    lines = report.splitlines()
    for i, ln in enumerate(lines):
        m = re.search(r"Compiling entry function '_Z(\d+)(\w+)'", ln)
        if not m:
            continue
        n, rest = int(m.group(1)), m.group(2)
        name, args = rest[:n], rest[n + 1:]
        label = []
        while args and not args.startswith("E"):
            # S0_: the first type again (bf16: float is not substituted)
            t = re.match(r"13__nv_bfloat16|S0_|f|Li(\d+)E", args)
            if t is None:
                break
            label.append({"13__nv_bfloat16": "bf16", "S0_": "bf16",
                          "f": "float"}.get(t.group(0), t.group(1)))
            args = args[t.end():]
        props = " ".join(x.strip() for x in lines[i + 1:i + 4]
                         if "spill" in x or "Used" in x)
        out.append((f"{name}<{', '.join(label)}>", props))
    return out


def phase_build():
    from mirage_tpu_torch.ops import _build

    t0 = time.perf_counter()
    report = _build.build(force=True)
    log(f"[build] nvcc {len(report)} sources in "
        f"{time.perf_counter() - t0:.1f}s into {_build.BUILD_DIR}")
    # the host library of the data path (csrc/fastops.cpp), beside them
    t0 = time.perf_counter()
    lib = _build.build_host(force=True)
    log(f"[build] host library {lib.name}: {_build.host_compiler()} "
        f"{' '.join(_build.HOST_FLAGS)} -shared in "
        f"{time.perf_counter() - t0:.1f}s; host {host_line()}")
    for name, text in report.items():
        for line in text.splitlines():
            if "Compiling entry" in line or "Used" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")
    for name in ("fused_block", "attention_phased") + NO_SPILL:
        spills = [ln.strip() for ln in report[name].splitlines()
                  if re.search(r"[1-9]\d* bytes spill (stores|loads)", ln)]
        log(f"[build] {name}: {len(spills)} ptxas lines with a spill"
            + "".join(f"\n[build]   {ln}" for ln in spills))
        if spills and name in NO_SPILL:
            raise AssertionError(f"{name}.cu spills registers")
    # every instantiation of the LN kernels: registers and spills
    ln = _ln_instantiations(report["layernorm"])
    for label, props in ln:
        log(f"[build] layernorm: {label}: {props}")
    if len(ln) != 32:
        raise AssertionError(f"layernorm.cu: {len(ln)} kernels in the ptxas "
                             f"report, expected 32")
    # the attention forward (csrc/attention_fwd.cuh, in attention.cu and
    # flash_attention.cu) and backward (csrc/attention_bwd.cuh, in
    # attention_bwd.cu and flash_attention.cu): registers and spills of each
    # head dim's kernel, none allowed, and no serialized wgmma
    for name, kernels in (("attention", ("attention_fwd_kernel",)),
                          ("attention_bwd", ("dq_kernel", "dkv_kernel")),
                          ("flash_attention", ("attention_fwd_kernel",
                                               "dq_kernel", "dkv_kernel")),
                          ("relpos_attention", ("relpos_attn_kernel",))):
        lines = report[name].splitlines()
        for i, ln in enumerate(lines):
            kernel = next((k for k in kernels if "Compiling entry" in ln
                           and re.search(rf"\d{k}ILi", ln)), None)
            if kernel is None:
                continue
            args = re.search(r"ILi(\d+)E(Lb[01]E)?", ln)
            label = f"{kernel}<{args.group(1)}" + (
                f", {'true' if args.group(2) == 'Lb1E' else 'false'}>"
                if args.group(2) else ">")
            props = " ".join(x.strip() for x in lines[i + 1:i + 4]
                             if "spill" in x or "Used" in x)
            log(f"[build] {name}: {label}: {props}")
            if re.search(r"[1-9]\d* bytes spill", props):
                raise AssertionError(f"{label} spills registers in {name}.cu")
        if "C7520" in report[name]:
            raise AssertionError(f"{name}.cu: ptxas serialized wgmma (C7520)")
    # the ping-pong GEMM (csrc/gemm_pingpong.cuh: the bf16 product of
    # gemm.cu, the int8 one of quant.cu): no serialized wgmma either
    for name in ("gemm", "quant"):
        if "C7520" in report[name]:
            raise AssertionError(f"{name}.cu: ptxas serialized wgmma (C7520)")
    # the bf16 products of B10 and of the attention forward and backward
    # must be wgmma: HGMMA in the libraries' SASS; the mma.sync forwards and
    # backwards are gone
    tool = Path(_build.nvcc()).with_name("cuobjdump")
    mma_sync = ("attention_bf16_kernel", "flash_fwd_bf16_kernel",
                "attn_bwd_dq_kernel", "attn_bwd_dkv_kernel",
                "flash_bwd_dq_kernel", "flash_bwd_dkv_kernel")
    for lib in ("fused_block", "attention", "attention_bwd",
                "flash_attention", "gemm", "quant", "relpos_attention"):
        sass = subprocess.run([str(tool), "-sass",
                               str(_build.BUILD_DIR / f"lib{lib}.so")],
                              capture_output=True, text=True, check=True,
                              timeout=300).stdout
        hgmma = sass.count("HGMMA")
        old = [k for k in mma_sync if k in sass]
        # the int8 GEMM: wgmma's integer form (IGMMA) and no mma.sync (IMMA)
        igmma, imma = sass.count("IGMMA"), sass.count("IMMA")
        log(f"[build] {lib}: {hgmma} HGMMA instructions in its SASS"
            + (f", {igmma} IGMMA, {imma} IMMA" if lib == "quant" else "")
            + (f"; mma.sync kernels found: {old}" if old else ""))
        if lib == "quant":
            if igmma + hgmma == 0 or imma:
                raise AssertionError(f"the int8 GEMM is not wgmma ({igmma} "
                                     f"IGMMA, {hgmma} HGMMA) or an mma.sync "
                                     f"is left ({imma} IMMA)")
        elif hgmma == 0 or old:
            raise AssertionError(f"{lib}'s bf16 products are not wgmma, or "
                                 f"an mma.sync attention kernel is left: {old}")


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


def attention_core_rows(entry, per_call, shapes=None, key=None):
    """The attention forward alone (csrc/attention_fwd.cuh through
    ``runtime.attention`` or ``runtime.flash_attention``) at the ``shapes``
    (default ATTN_SHAPES) of ``entry`` that a path calls (``per_call``:
    label -> launches a forward or step, in each row's ``key``), bf16,
    against float32 math from the same inputs (max-abs BF16_MAX_ABS, rel-L2
    BF16_REL_L2; the flash entry's log-sum-exp within LSE_ATOL in log2
    units); then the kernel, its plain version (``sdpa``, or
    ``flash_attention_ref``) and SDPA timed."""
    import torch

    from mirage_tpu_torch.nn.attention import sdpa
    from mirage_tpu_torch.ops import runtime
    from mirage_tpu_torch.ops.flash_attention import flash_attention_ref

    gen = torch.Generator().manual_seed(SEED + 8)
    lib = _flash_library(False)
    rows = []
    for label, shape, cross, ent, _ in shapes or ATTN_SHAPES:
        if ent != entry or label not in per_call:
            continue
        q, k, v, out, lse, q_src, kv_src = _attn_inputs(shape, cross, gen)
        b, nq, nk, h, dh = shape
        scale = dh ** -0.5

        def heads(t):
            return t.reshape(b, t.shape[1], h, dh).transpose(1, 2)

        def kernel():
            if entry == "attention":
                runtime.attention(q, k, v, out, heads=h, dh=dh, scale=scale)
                return None
            return runtime.flash_attention(q, k, v, out, heads=h, dh=dh,
                                           scale=scale)

        got_lse = kernel()
        torch.cuda.synchronize()
        s = heads(q.float()) @ heads(k.float()).transpose(-1, -2) * scale
        want = (torch.softmax(s, -1) @ heads(v.float())).transpose(1, 2) \
            .reshape(b, nq, h * dh)
        diff = out.float() - want
        errs = {"out": {"max_abs": diff.abs().max().item(),
                        "rel_l2": (diff.norm() / want.norm()).item()}}
        ok = (errs["out"]["max_abs"] <= BF16_MAX_ABS
              and errs["out"]["rel_l2"] <= BF16_REL_L2
              and bool(torch.isfinite(out).all()))
        if got_lse is not None:
            lse_err = (got_lse - torch.logsumexp(s, -1) / math.log(2.0)) \
                .abs().max().item()
            errs["lse"] = {"max_abs": lse_err}
            ok = ok and lse_err <= LSE_ATOL
        del s, want, diff
        if not ok:
            raise AssertionError(f"attention_fwd {label}: kernel disagrees "
                                 f"with float32 math: {errs}")
        ms = cuda_ms(kernel)
        qh, kh, vh = heads(q), heads(k), heads(v)
        plain = sdpa if entry == "attention" else flash_attention_ref
        plain_ms = cuda_ms(lambda: plain(qh, kh, vh, scale), iters=5)
        library_ms = cuda_ms(lambda: lib(q_src, kv_src, h, scale))
        bound_ms, bound_by = _bound(_attn_core_work(shape, entry))
        key = key or ("calls_per_forward" if entry == "attention"
                      else "calls_per_step")
        row = {"label": label, "shape": list(shape), "dtype": "bf16",
               "errors": errs, "max_abs_err": errs["out"]["max_abs"],
               "rel_l2_err": errs["out"]["rel_l2"], "ms": ms,
               "plain_ms": plain_ms, "library_ms": library_ms,
               "library": "F.scaled_dot_product_attention on the same views",
               "bound_ms": bound_ms, "bound_by": bound_by,
               key: per_call[label]}
        log(f"[kernels] attention_fwd {label} {shape}: {errs}; kernel "
            f"{ms:.4f} ms plain {plain_ms:.4f} ms SDPA {library_ms:.4f} ms "
            f"bound {bound_ms:.4f} ms ({bound_by})")
        rows.append(row)
        del q, k, v, out, lse, q_src, kv_src, qh, kh, vh
    return rows


def fwd_op_rows(cases, gen, key="calls_per_forward"):
    """The bf16 forward ops (B1, B2, B3) at ``cases`` ((op, label, shape,
    kwargs, calls on the path, in each row's ``key``)) against their plain
    versions in float32 from the same inputs (BF16_MAX_ABS, BF16_REL_L2),
    timed beside the plain version, the library composition and the bound:
    op -> rows."""
    import torch

    from mirage_tpu_torch.ops import runtime
    from mirage_tpu_torch.ops.block_attention import (
        attn_half_block, attn_half_block_ref, xattn_half_block,
        xattn_half_block_ref)
    from mirage_tpu_torch.ops.fused_mlp import mlp_block, mlp_block_ref

    ops = {"attn_half_block": (attn_half_block, attn_half_block_ref),
           "mlp_block": (mlp_block, mlp_block_ref),
           "xattn_half_block": (xattn_half_block, xattn_half_block_ref)}
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
               key: per_fwd, **kw}
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
    return results


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
    results = fwd_op_rows(cases, gen)

    # the attention forward alone at the serving shapes (launches a
    # reconstruct forward) and the pretraining ones (none a forward)
    results["attention_fwd"] = attention_core_rows("attention", {
        "serving encoder (B1)": 24, "serving decoder self (B1)": 6,
        "serving decoder cross (B3)": 3, "pretraining encoder (B1)": 0,
        "pretraining decoder (B6)": 0})

    # the bf16 GEMM alone at its path shapes (launches a reconstruct forward)
    results["gemm"] = gemm_rows()

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


# csrc/layernorm.cu (B1-B5's, B9's and S4's LN) at its path shapes:
# (label, (rows, width), launches a batch-64 reconstruct forward, launches
# a batch-256 pretraining step). A reconstruct forward: one LN in each of
# the encoder's 24 B1 and 24 B2 and the decoders' 6 B1, 9 B2 and 3 B3
# (two each: the queries' and the context's), 69 in all. A pretraining
# step: one LN in each B1 (12 encoder) and B2 (12 encoder, 6 decoder),
# recomputed in each B4 and B5 backward, whose LN backward runs once each;
# a classification full fine-tune step: one LN backward in each of the 12
# B5.
LN_FWD_SHAPES = [("serving encoder", (16448, 1024), 48, 0),
                 ("decoders", (16384, 256), 18, 0),
                 ("B3 context", (16448, 256), 3, 0),
                 ("pretraining encoder", (25344, 768), 0, 48),
                 ("pretraining decoders", (65536, 256), 0, 12)]
LN_BWD_SHAPES = [("pretraining encoder", (25344, 768), 24, 0),
                 ("pretraining decoders", (65536, 256), 6, 0),
                 ("classification encoder", (BATCH * 257, 768), 0, 12)]
# launches per pretraining step, from the ops' counts: one LN in each B1,
# B2, B4 and B5 launch, one LN backward in each B4 and B5
LN_OPS = {"layernorm": ("attn_half_block", "mlp_block",
                        "attn_half_block_bwd", "mlp_block_bwd"),
          "layernorm_bwd": ("attn_half_block_bwd", "mlp_block_bwd")}
LN_PER_RECONSTRUCT, LN_PER_FEATURES = 69, 48


def _ln_instantiation(m, d, backward):
    """The kernel runtime.layernorm_plan picks for a bf16 (m, d) call with
    float32 scale and shift, and its grid (in an older checkout without the
    plan, the kernel's name)."""
    import torch

    from mirage_tpu_torch.ops import runtime

    name = "layernorm_bwd" if backward else "layernorm"
    if not hasattr(runtime, "layernorm_plan"):  # a checkout before the plan
        return {"kernel": f"{name}_kernel (a warp a row)"}
    plan = runtime.layernorm_plan(m, d, torch.cuda.get_device_properties(
        0).multi_processor_count, torch.bfloat16, backward)
    kernel = (f"{name}_kernel<bf16, float, {plan.width}>" if plan.width
              else f"{name}_generic_kernel<bf16, float>")
    return {"kernel": kernel, "grid": plan.grid,
            "threads_per_row": plan.threads_per_row,
            "rows_per_cta": plan.rows_per_cta,
            "partial_rows": plan.partial_rows}


def layernorm_rows(fwd_shapes=None, bwd_shapes=None):
    """The LN kernel alone (runtime.layernorm, runtime.layernorm_bwd) at
    LN_FWD_SHAPES / LN_BWD_SHAPES (or the shapes given) in bf16 (float32 scale and shift, as the
    ops pass the parameters): against its plain version in float32 from
    the same inputs, rerun bit for bit, then timed beside the plain version
    and F.layer_norm (its autograd backward alone for the backward rows,
    without the residual's cotangent the kernel adds), and the bytes bound
    (each input read once, each output written once); each row names the
    instantiation the plan picked. ``device_ms``: the same calls with the
    host's launch cost hidden (:func:`device_ms`), for the kernel and
    F.layer_norm."""
    import torch
    import torch.nn.functional as F

    from mirage_tpu_torch.nn.layers import layer_norm
    from mirage_tpu_torch.ops import runtime
    from mirage_tpu_torch.ops.block_attention import ln_bwd_ref

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = {"layernorm": [], "layernorm_bwd": []}
    for label, (m, d), per_fwd, per_step in (
            LN_FWD_SHAPES if fwd_shapes is None else fwd_shapes):
        x = (torch.randn((m, d), generator=gen, device="cuda") * 2 + 0.5
             ).to(torch.bfloat16)
        w = 1 + 0.1 * torch.randn(d, generator=gen, device="cuda")
        b = 0.1 * torch.randn(d, generator=gen, device="cuda")
        got = runtime.layernorm(x, w, b)
        rerun = torch.equal(got, runtime.layernorm(x, w, b))
        want = layer_norm(x.float(), w, b)
        diff = got.float() - want
        max_abs = diff.abs().max().item()
        rel_l2 = (diff.norm() / want.norm()).item()
        if not (max_abs <= BF16_MAX_ABS and rel_l2 <= BF16_REL_L2 and rerun):
            raise AssertionError(f"layernorm {label}: max_abs {max_abs}, "
                                 f"rel_l2 {rel_l2}, rerun bit-equal {rerun}")
        wb, bb = w.to(torch.bfloat16), b.to(torch.bfloat16)
        nbytes = 2 * m * d * 2 + 2 * d * 4
        row = {"label": label, "shape": [m, d], "dtype": "bf16",
               **_ln_instantiation(m, d, False),
               "max_abs_err": max_abs, "rel_l2_err": rel_l2,
               "rerun_bit_equal": rerun,
               "ms": cuda_ms(lambda: runtime.layernorm(x, w, b)),
               "plain_ms": cuda_ms(lambda: layer_norm(x, w, b)),
               "library_ms": cuda_ms(lambda: F.layer_norm(
                   x, (d,), wb, bb, 1e-6)),
               "device_ms": device_ms(lambda: runtime.layernorm(x, w, b)),
               "library_device_ms": device_ms(lambda: F.layer_norm(
                   x, (d,), wb, bb, 1e-6)),
               "bound_ms": nbytes / PEAK_BYTES * 1e3, "bound_by": "bytes",
               "calls_per_forward": per_fwd, "calls_per_step": per_step}
        rows["layernorm"].append(row)
        log(f"[kernels] layernorm {label} ({m}, {d}) {row['kernel']} grid "
            f"{row.get('grid')}: max_abs {max_abs:.3e} kernel "
            f"{row['ms']:.4f} ms (device alone {row['device_ms']:.4f}) plain "
            f"{row['plain_ms']:.4f} ms F.layer_norm {row['library_ms']:.4f} "
            f"ms (device alone {row['library_device_ms']:.4f}) bound "
            f"{row['bound_ms']:.4f} ms (bytes)")
    for label, (m, d), per_step, per_cls_step in (
            LN_BWD_SHAPES if bwd_shapes is None else bwd_shapes):
        x = (torch.randn((m, d), generator=gen, device="cuda") * 2 + 0.5
             ).to(torch.bfloat16)
        w = 1 + 0.1 * torch.randn(d, generator=gen, device="cuda")
        dyln = torch.randn((m, d), generator=gen, device="cuda")
        dy = torch.randn((m, d), generator=gen, device="cuda").to(
            torch.bfloat16)
        dx, dg, db = runtime.layernorm_bwd(x, w, dyln, dy)
        rerun = all(torch.equal(a, b) for a, b in zip(
            (dx, dg, db), runtime.layernorm_bwd(x, w, dyln, dy)))
        wdx, wdg, wdb = ln_bwd_ref(x.float(), dyln, w, dy.float())
        errs = {}
        for name, g, r in (("dx", dx.float(), wdx), ("dgamma", dg, wdg),
                           ("dbeta", db, wdb)):
            errs[name] = ((g - r).norm() / r.norm()).item()
        max_abs = (dx.float() - wdx).abs().max().item()
        if not (max(errs.values()) <= BWD_REL_L2 and rerun):
            raise AssertionError(f"layernorm_bwd {label}: rel_l2 {errs}, "
                                 f"rerun bit-equal {rerun}")
        xg = x.clone().requires_grad_(True)
        wg = w.to(torch.bfloat16).requires_grad_(True)
        bg = torch.zeros(d, device="cuda", dtype=torch.bfloat16,
                         requires_grad=True)
        y = F.layer_norm(xg, (d,), wg, bg, 1e-6)
        dyb = dyln.to(torch.bfloat16)
        nbytes = m * d * (2 + 4 + 2 + 2) + 3 * d * 4
        row = {"label": label, "shape": [m, d], "dtype": "bf16",
               **_ln_instantiation(m, d, True),
               "max_abs_err": max_abs, "rel_l2_err": errs,
               "rerun_bit_equal": rerun,
               "ms": cuda_ms(lambda: runtime.layernorm_bwd(x, w, dyln, dy)),
               "plain_ms": cuda_ms(lambda: ln_bwd_ref(x, dyln, w, dy)),
               "library_ms": cuda_ms(lambda: torch.autograd.grad(
                   y, (xg, wg, bg), dyb, retain_graph=True)),
               "device_ms": device_ms(
                   lambda: runtime.layernorm_bwd(x, w, dyln, dy)),
               "library_device_ms": device_ms(lambda: torch.autograd.grad(
                   y, (xg, wg, bg), dyb, retain_graph=True)),
               "bound_ms": nbytes / PEAK_BYTES * 1e3, "bound_by": "bytes",
               "calls_per_step": per_step, "calls_per_cls_step": per_cls_step}
        rows["layernorm_bwd"].append(row)
        log(f"[kernels] layernorm_bwd {label} ({m}, {d}) {row['kernel']} "
            f"grid {row.get('grid')}: rel_l2 {errs} kernel {row['ms']:.4f} ms "
            f"(device alone {row['device_ms']:.4f}) plain "
            f"{row['plain_ms']:.4f} ms F.layer_norm backward "
            f"{row['library_ms']:.4f} ms (device alone "
            f"{row['library_device_ms']:.4f}) bound {row['bound_ms']:.4f} ms "
            f"(bytes)")
        del y, xg
    torch.cuda.synchronize()
    return rows


def ln_ab(card):
    """``--ln-ab``: the LN kernel's rows (:func:`layernorm_rows`), the
    bench's headline and the bare pretraining step (phase 5) of the
    checkout this copy of the script runs in; it calls only what the port
    has had since the LN rows were first timed, so copied into the root of
    an older checkout (the parent by `git archive` into `build/parent/`)
    it measures that tree the same way: run parent, change, change,
    parent in one call."""
    from mirage_tpu_torch.bench import __main__ as head

    rows = layernorm_rows()
    headline = head.headline()
    log(json.dumps(headline))
    train = phase_train(card)
    prof = train["profile"] or {}
    return {"layernorm": rows,
            "ln_per_reconstruct_ms": sum(
                r["ms"] * r["calls_per_forward"] for r in rows["layernorm"]),
            "ln_per_reconstruct_device_ms": sum(
                r["device_ms"] * r["calls_per_forward"]
                for r in rows["layernorm"]),
            "headline_img_per_s": headline["value"],
            "train_ms_per_step": train["ms_per_step"],
            "train_kernels_per_step": prof.get("kernels"),
            "train_idle_share": prof.get("idle_share"),
            "train_kernel_ms_by_group": prof.get("kernel_ms_by_group")}


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
        "mirage_tpu_torch/ops/fused_mlp.py", ["layernorm.cu", "mlp_bwd.cu"]),
    "block_attention": (
        "mirage_tpu/ops/block_attention.py:58",
        "_block_attn_fwd :88 -> _block_attn_kernel :58",
        "mirage_tpu_torch/ops/block_attention.py", ["attention.cu"]),
    "block_attention_bwd": (
        "mirage_tpu/ops/block_attention.py:111",
        "_block_attn_bwd :169 -> _block_attn_bwd_kernel :111",
        "mirage_tpu_torch/ops/block_attention.py", ["attention_bwd.cu"]),
}
# the bf16 attention backward kernel (csrc/attention_bwd.cuh) by its two
# launchers, each a `kernels` entry on the paths that launch it: name ->
# (TPU kernel file:line, the TPU kernels whose attention core it is, source,
# sources)
ATTN_BWD_KERNELS = {
    "attention_bwd": (
        "mirage_tpu/ops/block_attention.py:111",
        "_block_attn_bwd :169 -> _block_attn_bwd_kernel :111 (B6); the "
        "attention core (_attn_half_bwd_rows :406-440) of "
        "_attn_half_bwd_dx_kernel :549 (B4) and _attn_half_bwd_kernel :457 "
        "(B7)",
        "mirage_tpu_torch/csrc/attention_bwd.cuh",
        ["attention_bwd.cuh", "attention_bwd.cu"]),
    "flash_bwd": (
        "mirage_tpu/ops/flash_attention.py:115",
        "_flash_bwd :175 -> _attn_bwd_kernel :115 (B8)",
        "mirage_tpu_torch/csrc/attention_bwd.cuh",
        ["attention_bwd.cuh", "flash_attention.cu"]),
}
# launches of each op per pretraining step (ViT-B: 12 encoder layers at 99
# tokens; three decoders of two 256-token blocks; attention_bwd: the bf16
# backward kernel's launches, one in each B4 and B6 backward)
PER_STEP = {"attn_half_block": 12, "attn_half_block_bwd": 12,
            "mlp_block": 18, "mlp_block_bwd": 18, "block_attention": 6,
            "block_attention_bwd": 6, "xattn_half_block": 0,
            "attn_half_block_acc_bwd": 0, "mlp_block_acc_bwd": 0,
            "fused_adamw": 1, "adamw_norm": 1, "attention_bwd": 18,
            "flash_bwd": 0}
# the AdamW step's two launches over the leaf table (the norm and the
# update, B11) in a training step, and in a forward and backward alone
OPT_STEP = {"fused_adamw": 1, "adamw_norm": 1}
NO_OPT = {"fused_adamw": 0, "adamw_norm": 0}
# the same step with the JAX package's three switches on
# (MIRAGE_OPT_KERNEL=on, MIRAGE_MLP_BWD=accumulate,
# MIRAGE_ATTN_BWD=accumulate): both halves' backwards take B7 (the update
# takes B11 by default)
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


def launch_split(fn, calls=5):
    """Device ms of each launch of one call of ``fn``, in launch order:
    [[kernel, ms], ...], each the mean over ``calls`` calls after a warm-up,
    from one torch.profiler window in which the host pauses 5 ms between
    calls: a gap of over 2 ms on the device starts the next call, and a call
    whose count of launches is not the most common one (an event the
    profiler lost) is left out. The host's gaps between launches are not in
    it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    forget_spans()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
            torch.cuda.synchronize()
            time.sleep(0.005)
    spans = device_kernels(prof)
    if not spans:
        raise AssertionError("the profiler saw no device launch")
    runs = [[spans[0]]]
    for span in spans[1:]:  # time_range in µs
        if span[0] - runs[-1][-1][1] > 2000:
            runs.append([])
        runs[-1].append(span)
    lengths = [len(r) for r in runs]
    runs = [r for r in runs if len(r) == max(set(lengths), key=lengths.count)]
    out = []
    for i, (_, _, name) in enumerate(runs[0]):
        name = name.split("(")[0].split("<")[0].split()[-1][:48]
        out.append([name, sum(r[i][1] - r[i][0] for r in runs)
                    / len(runs) / 1e3])
    return out


def mlp_bwd_split(args, dy, label, acc=False, **kw):
    """The MLP backward's chain (B7 with ``acc``, else B5) split into its
    launches (:func:`launch_split`: LN, the hidden stage, dyln, the LN
    backward, the weight gradients, the column sums), and the hidden
    stage's act held against B2's fc1 on the same y: bit-equal, or within
    the bf16 bars (the difference recorded)."""
    import torch

    from mirage_tpu_torch.ops import fused_mlp as fm
    from mirage_tpu_torch.ops import runtime

    x, ln_w, ln_b, w1, b1, w2 = args[:6]
    d = x.shape[-1]
    y = runtime.layernorm(x.view(-1, d), ln_w, ln_b)
    act = runtime.mlp_bwd_hidden(y, dy.view(-1, d), w1, b1, w2)[1]
    fc1 = runtime.gemm(y, w1, b1, gelu=True)
    equal = torch.equal(act, fc1)
    diff = (act.float() - fc1.float()).abs().max().item()
    if not equal and diff > BF16_MAX_ABS:
        raise AssertionError(f"{label}: the hidden stage's act is {diff} "
                             f"from B2's fc1 output")
    del y, act, fc1
    fn = fm._mlp_bwd_acc if acc else fm._mlp_bwd
    launches = launch_split(lambda: fn(x, dy, *args[1:6], **kw))
    total = sum(ms for _, ms in launches)
    log(f"[kernels] {label} split {tuple(x.shape)} (device ms a launch): "
        + ", ".join(f"{n} {ms:.4f}" for n, ms in launches)
        + f"; sum {total:.4f}; act bit-equal to B2's fc1 {equal} (max_abs "
        f"{diff:.3e})")
    return {"launches": launches, "sum_ms": total,
            "act_bit_equal_b2_fc1": equal, "act_max_abs_vs_b2_fc1": diff}


# the MLP backward's timed shapes: the pretraining encoder and decoder (B5
# 12 and 6 a step) and the classification encoder (B5 12 a full fine-tune
# step, B7-MLP 12 under MIRAGE_MLP_BWD=accumulate)
MLP_BWD_SHAPES = [("pretraining encoder", (256, 99, 768)),
                  ("pretraining decoder", (256, 256, 256)),
                  ("classification encoder", (BATCH, 257, 768))]


def mlp_bwd_timing():
    """B5 and B7-MLP at MLP_BWD_SHAPES in bf16: CUDA-event ms a call beside
    the library call's and the bound, and each call split into its launches
    (:func:`launch_split`). It calls only what the port has had since its
    accumulating backward (``fused_mlp._mlp_bwd``, ``_mlp_bwd_acc``), so a
    copy of this script in an older checkout's root times that tree the
    same way (``--mlp-bwd-split``)."""
    import torch

    from mirage_tpu_torch.ops import fused_mlp as fm

    gen = torch.Generator().manual_seed(SEED + 4)
    rows = []
    for label, shape in MLP_BWD_SHAPES:
        args, dy = _bwd_inputs("mlp_block_bwd", shape, torch.bfloat16, gen)
        lib = _bwd_library("mlp_block_bwd")
        library_ms = cuda_ms(lambda: lib(dy, *args), iters=10)
        flops, nbytes = _bwd_work("mlp_block_bwd", shape, 2)
        bound_ms = max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES) * 1e3
        for op, fn in (("mlp_block_bwd", fm._mlp_bwd),
                       ("mlp_block_acc_bwd", fm._mlp_bwd_acc)):
            ms = cuda_ms(lambda: fn(args[0], dy, *args[1:6]), iters=10)
            split = launch_split(lambda: fn(args[0], dy, *args[1:6]))
            rows.append({"op": op, "label": label, "shape": list(shape),
                         "ms": ms, "library_ms": library_ms,
                         "bound_ms": bound_ms, "split_ms": split})
            log(f"[mlp_bwd] {op} {label} {shape}: kernel {ms:.4f} ms library "
                f"{library_ms:.4f} ms bound {bound_ms:.4f} ms; launches "
                + ", ".join(f"{n} {t:.4f}" for n, t in split))
        del args, dy
    return rows


# the attention forward's main-path shapes: (label, (batch, nq, nk, heads,
# dh), cross-attention, C entry, launches on its path: per batch-64
# reconstruct forward (serving), per pretraining step (B1, B6), per seg step
# (B8), per three-modality request)
ATTN_SHAPES = [
    ("serving encoder (B1)", (BATCH, 257, 257, 16, 64), False, "attention",
     "24 / forward"),
    ("serving encoder N=256", (BATCH, 256, 256, 16, 64), False, "attention",
     "none: the N = 257 row's ragged tail priced"),
    ("serving decoder self (B1)", (BATCH, 256, 256, 8, 32), False,
     "attention", "6 / forward"),
    ("serving decoder cross (B3)", (BATCH, 256, 257, 8, 32), True,
     "attention", "3 / forward"),
    ("pretraining encoder (B1)", (TRAIN_BATCH, 99, 99, 12, 64), False,
     "attention", "12 / step"),
    ("pretraining decoder (B6)", (TRAIN_BATCH, 256, 256, 8, 32), False,
     "attention", "6 / step"),
    ("seg encoder (B8)", (4, 1025, 1025, 12, 64), False, "flash_fwd",
     "12 / step"),
    ("seg encoder N=1024", (4, 1024, 1024, 12, 64), False, "flash_fwd",
     "none: the N = 1025 row's ragged tail priced"),
    ("three-modality cross (B8)", (BATCH, 256, 769, 8, 32), True,
     "flash_fwd", "3 / request at batch 1"),
]
# compile-time variants of csrc/attention_fwd.cuh (the attention forward of
# csrc/attention.cu and csrc/flash_attention.cu) that ``--attn-split`` times
# side by side; only their order of speed is a finding
ATTN_SPLIT_VARIANTS = {"full": [], "no_pv": ["-DMTT_ATTN_SPLIT_NO_PV"],
                       "no_softmax": ["-DMTT_ATTN_SPLIT_NO_SOFTMAX"],
                       "loads": ["-DMTT_ATTN_SPLIT_LOADS"]}


def _attn_inputs(shape, cross, gen):
    """bf16 (q, k, v, out, lse, q_src, kv_src): q, k and v column windows of
    a packed qkv (self) or of the queries and a packed kv (cross)."""
    import torch

    b, nq, nk, h, dh = shape
    d = h * dh

    def rn(*s):
        return torch.randn(*s, generator=gen).to(torch.bfloat16).cuda()

    if cross:
        q_src, kv_src = rn(b, nq, d), rn(b, nk, 2 * d)
        q, k, v = q_src, kv_src[..., :d], kv_src[..., d:]
    else:
        q_src, kv_src = rn(b, nq, 3 * d), None
        q, k, v = q_src[..., :d], q_src[..., d:2 * d], q_src[..., 2 * d:]
    out = torch.empty(b, nq, d, dtype=torch.bfloat16, device="cuda")
    lse = torch.empty(b, h, nq, dtype=torch.float32, device="cuda")
    return q, k, v, out, lse, q_src, kv_src


def _attn_entry_call(fn, entry, q, k, v, out, lse, shape):
    """One launch of a C entry (``mtt_attention`` or ``mtt_flash_fwd``, any
    build of them) on the views; raises if the launch was refused."""
    import ctypes

    import torch

    b, nq, nk, h, dh = shape
    strides = [t.stride(i) for t in (q, k, v, out) for i in (0, 1)]
    stream = torch.cuda.current_stream().cuda_stream
    if entry == "attention":
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b,
                nq, nk, h, dh, *strides, dh ** -0.5, 1, stream)
    else:
        arr = (ctypes.c_longlong * 8)(*strides)
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                lse.data_ptr(), ctypes.addressof(arr), b, nq, nk, h, dh,
                dh ** -0.5, 1, stream)
    if rc != 0:
        raise RuntimeError(f"{entry} launch failed: CUDA error {rc}")


def _attn_core_work(shape, entry):
    """(FLOPs, bytes): 4·B·H·Nq·Nk·dh; q, k, v read once, out (and B8's
    float lse) written once."""
    b, nq, nk, h, dh = shape
    extra = 4 * b * h * nq if entry == "flash_fwd" else 0
    return 4 * b * h * nq * nk * dh, (2 * nq + 2 * nk) * b * h * dh * 2 + extra


def _bound(work):
    t_ops, t_bytes = work[0] / PEAK_BF16_FLOPS * 1e3, work[1] / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def attn_split(csrc):
    """The attention forward at ATTN_SHAPES, built from ``csrc`` (default:
    this checkout's sources) once per ATTN_SPLIT_VARIANTS entry into
    build/mirage_tpu_torch/split/, each variant's ``mtt_attention`` or
    ``mtt_flash_fwd`` timed by CUDA events beside SDPA and the bound. The
    variants leave out P·V, the exponentials and the softmax, or every
    product (the loads alone); the C entries have not changed, so a copy of
    this script times an older tree's kernels with the same macros added."""
    import ctypes

    import torch

    from mirage_tpu_torch.ops import _build

    csrc = Path(csrc).resolve()
    out_dir = _build.BUILD_DIR / "split"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs, libs = [], {}
    t0 = time.perf_counter()
    for variant, flags in ATTN_SPLIT_VARIANTS.items():
        for src in ("attention", "flash_attention"):
            lib = out_dir / f"lib{src}_{variant}.so"
            procs.append((lib, subprocess.Popen(
                [_build.nvcc(), *_build.NVCC_FLAGS, *flags, "-o", str(lib),
                 str(csrc / f"{src}.cu")], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)))
    for lib, proc in procs:
        log_text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {lib.name}:\n{log_text}")
        serialized = log_text.count("C7520")
        log(f"[attn_split] {lib.name}: {serialized} ptxas notes of serialized "
            f"wgmma; " + "; ".join(ln.strip() for ln in log_text.splitlines()
                                    if "Used" in ln or "spill" in ln)[:600])
    log(f"[attn_split] {len(procs)} builds from {csrc} in "
        f"{time.perf_counter() - t0:.1f}s")
    for variant in ATTN_SPLIT_VARIANTS:
        for entry, (source, symbol, argtypes) in (
                ("attention", _build.ENTRIES["attention"]),
                ("flash_fwd", _build.ENTRIES["flash_fwd"])):
            fn = getattr(ctypes.CDLL(str(out_dir / f"lib{source}_{variant}.so")),
                         symbol)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
            libs[variant, entry] = fn
    gen = torch.Generator().manual_seed(SEED + 7)
    lib_fwd = _flash_library(False)
    rows = []
    for label, shape, cross, entry, calls in ATTN_SHAPES:
        q, k, v, out, lse, q_src, kv_src = _attn_inputs(shape, cross, gen)
        h, dh = shape[3], shape[4]
        row = {"label": label, "shape": list(shape), "entry": entry,
               "calls": calls}
        for variant in ATTN_SPLIT_VARIANTS:
            fn = libs[variant, entry]
            row[variant] = cuda_ms(lambda: _attn_entry_call(
                fn, entry, q, k, v, out, lse, shape), iters=20, repeats=5)
        row["library_ms"] = cuda_ms(
            lambda: lib_fwd(q_src, kv_src, h, dh ** -0.5), iters=20,
            repeats=5)
        row["bound_ms"], row["bound_by"] = _bound(_attn_core_work(shape,
                                                                  entry))
        log(f"[attn_split] {label} {shape} {entry}: "
            + ", ".join(f"{var} {row[var]:.4f}"
                        for var in ATTN_SPLIT_VARIANTS)
            + f"; SDPA {row['library_ms']:.4f}; bound {row['bound_ms']:.4f} "
            f"({row['bound_by']}) ms a call")
        rows.append(row)
        del q, k, v, out, lse, q_src, kv_src
    return rows


# the attention backward's path shapes: (label, (batch, nq, nk, heads, dh),
# cross-attention, C entry, launches on its path)
ATTN_BWD_SHAPES = [
    ("B4 core, pretraining encoder", (TRAIN_BATCH, 99, 99, 12, 64), False,
     "attention_bwd", "12 / pretraining step (B7-attention under its switch)"),
    ("B6, pretraining decoders", (TRAIN_BATCH, 256, 256, 8, 32), False,
     "attention_bwd", "6 / pretraining step"),
    ("B6, cls full fine-tune", (BATCH, 257, 257, 12, 64), False,
     "attention_bwd", "12 / cls step"),
    ("B8, seg encoder", (4, 1025, 1025, 12, 64), False, "flash_bwd",
     "12 / seg step"),
    ("B8, decoder cross", (BATCH, 256, 769, 8, 32), True, "flash_bwd",
     "none: phase 2's cross row"),
]
# compile-time variants of the bf16 attention backward (csrc/attention_bwd.cu
# and csrc/flash_attention.cu) that ``--attn-bwd-split`` times side by side
ATTN_BWD_SPLIT_VARIANTS = {
    "full": [], "no_dq": ["-DMTT_ATTN_BWD_SPLIT_NO_DQ"],
    "no_dkv": ["-DMTT_ATTN_BWD_SPLIT_NO_DKV"],
    "no_softmax": ["-DMTT_ATTN_BWD_SPLIT_NO_SOFTMAX"],
    "loads": ["-DMTT_ATTN_BWD_SPLIT_LOADS"]}


def _attn_bwd_core_work(shape, entry):
    """(FLOPs, bytes) of one attention backward: 10·B·H·Nq·Nk·dh; q, k, v
    and dO read once, dq, dk, dv written once, plus the packed form's float
    16-row partials of dqkv (written) or the flash form's lse (read)."""
    b, nq, nk, h, dh = shape
    extra = (3 * h * dh * b * -(-nq // 16) * 4 if entry == "attention_bwd"
             else 4 * b * h * nq)
    return (10 * b * h * nq * nk * dh,
            (3 * nq + 4 * nk) * b * h * dh * 2 + extra)


def _sdpa_bwd_alone(q_src, kv_src, h, scale, dy):
    """A closure that runs only the backward of SDPA's forward on the same
    packed views (torch.autograd.grad over a graph kept from one forward):
    the second yardstick of an attention backward row."""
    import torch

    srcs = [t.detach().requires_grad_() for t in (q_src, kv_src)
            if t is not None]
    out = _flash_library(False)(srcs[0], srcs[1] if len(srcs) > 1 else None,
                                h, scale)
    return lambda: torch.autograd.grad(out, srcs, dy, retain_graph=True)


def _attn_bwd_entry_call(fn, entry, bufs, shape):
    """One launch of ``mtt_attention_bwd`` or ``mtt_flash_bwd`` (any build of
    them) on the buffers of :func:`attn_bwd_split`; raises if refused."""
    import ctypes

    import torch

    b, nq, nk, h, dh = shape
    stream = torch.cuda.current_stream().cuda_stream
    if entry == "attention_bwd":
        rc = fn(bufs["qkv"].data_ptr(), bufs["dout"].data_ptr(),
                bufs["dqkv"].data_ptr(), bufs["stats"][0].data_ptr(),
                bufs["stats"][1].data_ptr(), bufs["part"].data_ptr(), b, nq,
                h, dh, dh ** -0.5, 1, stream)
    else:
        views = [bufs[k] for k in ("q", "k", "v", "dout", "dq", "dk", "dv")]
        arr = (ctypes.c_longlong * 14)(*[t.stride(i) for t in views
                                         for i in (0, 1)])
        rc = fn(*[t.data_ptr() for t in views], bufs["lse"].data_ptr(),
                bufs["delta"].data_ptr(), ctypes.addressof(arr), b, nq, nk,
                h, dh, dh ** -0.5, 1, stream)
    if rc != 0:
        raise RuntimeError(f"{entry} launch failed: CUDA error {rc}")


def attn_bwd_split(csrc):
    """The bf16 attention backward at ATTN_BWD_SHAPES, built from ``csrc``
    (default: this checkout's sources) once per ATTN_BWD_SPLIT_VARIANTS
    entry into build/mirage_tpu_torch/split_bwd/, each variant's C entry
    timed by CUDA events beside SDPA's backward alone, SDPA's forward and
    backward, and the bound; then B4's chain (``_attn_half_bwd`` at
    (256, 99, 768, 12)) split into its launches (:func:`launch_split`). The
    variants leave out the dQ products, the dK/dV kernel, the exponentials
    and delta, or every product (the loads alone); the C entries are the
    parent's too, so a copy of this script in an older checkout's root times
    that tree's kernels with the same macros added."""
    import ctypes

    import torch

    from mirage_tpu_torch.ops import _build, runtime
    from mirage_tpu_torch.ops import block_attention as ba

    csrc = Path(csrc).resolve()
    out_dir = _build.BUILD_DIR / "split_bwd"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs, libs = [], {}
    t0 = time.perf_counter()
    for variant, flags in ATTN_BWD_SPLIT_VARIANTS.items():
        for src in ("attention_bwd", "flash_attention"):
            lib = out_dir / f"lib{src}_{variant}.so"
            procs.append((lib, subprocess.Popen(
                [_build.nvcc(), *_build.NVCC_FLAGS, *flags, "-o", str(lib),
                 str(csrc / f"{src}.cu")], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)))
    for lib, proc in procs:
        log_text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {lib.name}:\n{log_text}")
        log(f"[attn_bwd_split] {lib.name}: {log_text.count('C7520')} ptxas "
            f"notes of serialized wgmma; " + "; ".join(
                ln.strip() for ln in log_text.splitlines()
                if "Used" in ln or "spill" in ln)[:700])
    log(f"[attn_bwd_split] {len(procs)} builds from {csrc} in "
        f"{time.perf_counter() - t0:.1f}s")
    for variant in ATTN_BWD_SPLIT_VARIANTS:
        for entry in ("attention_bwd", "flash_bwd"):
            source, symbol, argtypes = _build.ENTRIES[entry]
            fn = getattr(ctypes.CDLL(str(out_dir
                                         / f"lib{source}_{variant}.so")),
                         symbol)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
            libs[variant, entry] = fn
    gen = torch.Generator().manual_seed(SEED + 9)
    lib_bwd = _flash_library(True)
    rows = []
    for label, shape, cross, entry, calls in ATTN_BWD_SHAPES:
        b, nq, nk, h, dh = shape
        d, scale = h * dh, dh ** -0.5
        q, k, v, out, lse, q_src, kv_src = _attn_inputs(shape, cross, gen)
        dy = torch.randn(b, nq, d, generator=gen).to(torch.bfloat16).cuda()
        d_q = torch.empty_like(q_src)
        d_kv = None if kv_src is None else torch.empty_like(kv_src)
        dq, dk, dv = ((d_q[..., :d], d_q[..., d:2 * d], d_q[..., 2 * d:])
                      if kv_src is None else
                      (d_q, d_kv[..., :d], d_kv[..., d:]))
        if entry == "flash_bwd":
            lse = runtime.flash_attention(q, k, v, out, heads=h, dh=dh,
                                          scale=scale)
        bufs = {"qkv": q_src, "dout": dy, "dqkv": d_q, "q": q, "k": k,
                "v": v, "dq": dq, "dk": dk, "dv": dv, "lse": lse,
                "delta": torch.empty_like(lse),
                "stats": torch.empty(2, b, h, nq, device="cuda"),
                "part": torch.empty(b * -(-nq // 16), 3 * d, device="cuda")}
        row = {"label": label, "shape": list(shape), "entry": entry,
               "calls": calls}
        for variant in ATTN_BWD_SPLIT_VARIANTS:
            fn = libs[variant, entry]
            row[variant] = cuda_ms(lambda: _attn_bwd_entry_call(
                fn, entry, bufs, shape), iters=20, repeats=5)
        row["sdpa_bwd_ms"] = cuda_ms(
            _sdpa_bwd_alone(q_src, kv_src, h, scale, dy), iters=20,
            repeats=5)
        row["library_ms"] = cuda_ms(
            lambda: lib_bwd(dy, q_src, kv_src, h, scale), iters=20,
            repeats=5)
        row["bound_ms"], row["bound_by"] = _bound(
            _attn_bwd_core_work(shape, entry))
        log(f"[attn_bwd_split] {label} {shape} {entry}: "
            + ", ".join(f"{var} {row[var]:.4f}"
                        for var in ATTN_BWD_SPLIT_VARIANTS)
            + f"; SDPA bwd {row['sdpa_bwd_ms']:.4f}, fwd+bwd "
            f"{row['library_ms']:.4f}; bound {row['bound_ms']:.4f} "
            f"({row['bound_by']}) ms a call")
        rows.append(row)
        del q, k, v, out, lse, q_src, kv_src, dy, d_q, d_kv, bufs
    args, dy = _bwd_inputs("attn_half_block_bwd", (TRAIN_BATCH, 99, 768, 12),
                           torch.bfloat16, gen)
    chain = launch_split(lambda: ba._attn_half_bwd(args[0], dy, *args[1:6],
                                                   args[7]))
    log(f"[attn_bwd_split] B4 chain (256, 99, 768, 12) (device ms a launch): "
        + ", ".join(f"{n} {ms:.4f}" for n, ms in chain)
        + f"; sum {sum(ms for _, ms in chain):.4f}")
    return {"rows": rows, "b4_chain": chain}


# the bf16 GEMM's path shapes: (label, (M, N, K), epilogue, launches on its
# path). bias: + bias; res: and the residual; gelu: GELU of erff; as26: the
# A&S 7.1.26 GELU (S5's mode)
GEMM_SHAPES = [
    ("serving encoder qkv", (16448, 3072, 1024), "bias", "24 / forward"),
    ("serving encoder proj", (16448, 1024, 1024), "res", "24 / forward"),
    ("serving encoder fc1", (16448, 4096, 1024), "gelu", "24 / forward"),
    ("serving encoder fc2", (16448, 1024, 4096), "res", "24 / forward"),
    ("serving decoder qkv", (16384, 768, 256), "bias", "6 / forward"),
    ("serving decoder proj", (16384, 256, 256), "res", "6 / forward"),
    ("serving decoder fc1", (16384, 1024, 256), "gelu", "9 / forward"),
    ("serving decoder fc2", (16384, 256, 1024), "res", "9 / forward"),
    ("pretraining qkv", (25344, 2304, 768), "bias", "12 / step"),
    ("pretraining proj", (25344, 768, 768), "res", "12 / step"),
    ("pretraining fc1", (25344, 3072, 768), "gelu", "12 / step"),
    ("pretraining fc2", (25344, 768, 3072), "res", "12 / step"),
    ("seg fc2 (B9)", (4100, 768, 3072), "res", "12 / seg step"),
    ("S5 fc1, A&S GELU", (16448, 4096, 1024), "as26", "S5c/S5d's fc1"),
]
# the int8 GEMM's: s32 (S3: the raw accumulator), fc1 and fc2 (B12's)
GEMM_S8_SHAPES = [
    ("S3", (16384, 4096, 1024), "s32", "the bench's S3"),
    ("B12 fc1", (16448, 4096, 1024), "fc1", "B12"),
    ("B12 fc2", (16448, 1024, 4096), "fc2", "B12"),
]
# compile-time variants of csrc/gemm.cu and csrc/quant.cu that
# ``--gemm-split`` times side by side: the epilogue's math left out (bias
# added, stored), no store (loads and products), the loads alone, and no
# cluster (each CTA loads all of W's slices; a tree without that macro times
# its kernel again: a measure of the spread)
GEMM_SPLIT_VARIANTS = {"whole": [], "no_epi": ["-DMTT_GEMM_SPLIT_NO_EPI"],
                       "no_store": ["-DMTT_GEMM_SPLIT_NO_STORE"],
                       "loads": ["-DMTT_GEMM_SPLIT_LOADS"],
                       "cluster1": ["-DMTT_GEMM_CLUSTER=1"]}
PEAK_INT8_OPS = 1979e12  # H100 SXM dense int8 (NVIDIA data sheet)


def _gemm_work(shape, epi):
    """(FLOPs or int8 operations, bytes): 2·M·N·K; A, W (and the residual,
    the bias) read once, C written once (bf16; s32 or float32 for S3's and
    B12 fc1's outputs, B12 fc2 also reading x)."""
    m, n, k = shape
    if epi in ("s32", "fc1", "fc2"):
        out = 4 if epi != "fc2" else 2 + 2
        return 2 * m * n * k, m * k + n * k + m * n * out + 4 * (m + 2 * n)
    res = 2 * m * n if epi == "res" else 0
    return 2 * m * n * k, 2 * (m * k + n * k + m * n + n) + res


def _gemm_entry_call(fn, epi, bufs, shape):
    """One launch of ``mtt_gemm``, ``mtt_gemm_gelu_mode`` or ``mtt_gemm_s8``
    (any build of them) on the buffers of :func:`gemm_split`."""
    import torch

    m, n, k = shape
    stream = torch.cuda.current_stream().cuda_stream
    b = bufs
    if epi in ("s32", "fc1", "fc2"):
        code = {"fc1": 0, "fc2": 1, "s32": 2}[epi]
        rc = fn(b["a"].data_ptr(), b["w"].data_ptr(), b["rs"].data_ptr(),
                b["s"].data_ptr(), b["b"].data_ptr(), code,
                b["h"].data_ptr() if epi == "fc1" else None,
                b["amax"].data_ptr() if epi == "fc1" else None,
                b["x"].data_ptr() if epi == "fc2" else None,
                b["c"].data_ptr() if epi != "fc1" else None, m, n, k,
                1, stream)
    elif epi == "as26":
        rc = fn(b["a"].data_ptr(), b["w"].data_ptr(), b["c"].data_ptr(),
                b["bias"].data_ptr(), 1, None, m, n, k, 1, stream)
    else:
        rc = fn(b["a"].data_ptr(), b["w"].data_ptr(), b["c"].data_ptr(),
                b["bias"].data_ptr(), 1,
                b["res"].data_ptr() if epi == "res" else None, m, n, k,
                int(epi == "gelu"), 1, 0, None, None, stream)
    if rc != 0:
        raise RuntimeError(f"gemm ({epi}) launch failed: CUDA error {rc}")


def gemm_split(csrc):
    """The bf16 GEMM (``mtt_gemm``, ``mtt_gemm_gelu_mode``) at GEMM_SHAPES
    and the int8 GEMM (``mtt_gemm_s8``) at GEMM_S8_SHAPES, built from
    ``csrc`` (default: this checkout's sources) once per
    GEMM_SPLIT_VARIANTS entry into build/mirage_tpu_torch/split_gemm/, each
    timed by CUDA events beside ``torch.matmul`` of the product alone, the
    ``F.linear`` (+ ``F.gelu``) (+ residual) composition or
    ``torch._int_mm``, and the bound; then B9's backward
    (``fused_mlp._mlp_bwd_stash`` of the checkout it runs in) at the seg
    head's (65536, 384) -> 1536. The C entries and macro names are the
    parent's too, so a copy of this script in an older checkout's root
    times that tree with the same macros added."""
    import ctypes

    import torch
    import torch.nn.functional as F

    from mirage_tpu_torch.ops import _build
    from mirage_tpu_torch.ops import fused_mlp as fm

    csrc = Path(csrc).resolve()
    out_dir = _build.BUILD_DIR / "split_gemm"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs, libs = [], {}
    t0 = time.perf_counter()
    for variant, flags in GEMM_SPLIT_VARIANTS.items():
        for src in ("gemm", "quant"):
            lib = out_dir / f"lib{src}_{variant}.so"
            procs.append((lib, subprocess.Popen(
                [_build.nvcc(), *_build.NVCC_FLAGS, *flags, "-o", str(lib),
                 str(csrc / f"{src}.cu")], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)))
    for lib, proc in procs:
        log_text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {lib.name}:\n{log_text}")
        log(f"[gemm_split] {lib.name}: {log_text.count('C7520')} ptxas notes "
            f"of serialized wgmma; " + "; ".join(
                ln.strip() for ln in log_text.splitlines()
                if "Used" in ln or "spill" in ln)[:900])
    log(f"[gemm_split] {len(procs)} builds from {csrc} in "
        f"{time.perf_counter() - t0:.1f}s")
    for variant in GEMM_SPLIT_VARIANTS:
        for entry in ("gemm", "gemm_gelu_mode", "gemm_s8"):
            source, symbol, argtypes = _build.ENTRIES[entry]
            fn = getattr(ctypes.CDLL(str(out_dir / f"lib{source}_{variant}.so")),
                         symbol)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
            libs[variant, entry] = fn
    gen = torch.Generator().manual_seed(SEED + 11)
    dev = "cuda"

    def rn(*s, scale=1.0):
        return (torch.randn(*s, generator=gen) * scale).to(torch.bfloat16) \
            .to(dev)

    rows = []
    for label, shape, epi, calls in GEMM_SHAPES + GEMM_S8_SHAPES:
        m, n, k = shape
        row = {"label": label, "shape": list(shape), "epilogue": epi,
               "calls": calls}
        if epi in ("s32", "fc1", "fc2"):
            bufs = {"a": torch.randint(-127, 128, (m, k), generator=gen,
                                       dtype=torch.int8).to(dev),
                    "w": torch.randint(-127, 128, (n, k), generator=gen,
                                       dtype=torch.int8).to(dev),
                    "rs": torch.rand(m, generator=gen).to(dev) * 1e-3,
                    "s": torch.rand(n, generator=gen).to(dev) * 1e-3,
                    "b": torch.randn(n, generator=gen).to(dev) * 0.02,
                    "h": torch.empty(m, n, device=dev),
                    "amax": torch.zeros(m, device=dev),
                    "x": rn(m, n),
                    "c": torch.empty(m, n, device=dev, dtype=(
                        torch.int32 if epi == "s32" else torch.bfloat16))}
            entry = "gemm_s8"
            a, w = bufs["a"], bufs["w"]
            row["library_ms"] = cuda_ms(lambda: torch._int_mm(a, w.t()),
                                        iters=20, repeats=5)
            row["library"] = "torch._int_mm (s32 out)"
            flops, nbytes = _gemm_work(shape, epi)
            t_ops, t_bytes = flops / PEAK_INT8_OPS * 1e3, \
                nbytes / PEAK_BYTES * 1e3
        else:
            bufs = {"a": rn(m, k), "w": rn(n, k, scale=k ** -0.5),
                    "bias": rn(n, scale=0.02), "res": rn(m, n),
                    "c": torch.empty(m, n, device=dev, dtype=torch.bfloat16)}
            entry = "gemm_gelu_mode" if epi == "as26" else "gemm"
            a, w, bias, res = bufs["a"], bufs["w"], bufs["bias"], bufs["res"]

            def compose():
                y = F.linear(a, w, bias)
                if epi in ("gelu", "as26"):
                    y = F.gelu(y)
                return y + res if epi == "res" else y

            row["matmul_ms"] = cuda_ms(lambda: torch.matmul(a, w.t()),
                                       iters=20, repeats=5)
            row["library_ms"] = cuda_ms(compose, iters=20, repeats=5)
            row["library"] = "F.linear (+ F.gelu) (+ residual add)"
            flops, nbytes = _gemm_work(shape, epi)
            t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, \
                nbytes / PEAK_BYTES * 1e3
        row["bound_ms"] = max(t_ops, t_bytes)
        row["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
        for variant in GEMM_SPLIT_VARIANTS:
            fn = libs[variant, entry]
            row[variant] = cuda_ms(lambda: _gemm_entry_call(
                fn, epi, bufs, shape), iters=20, repeats=5)
        log(f"[gemm_split] {label} {shape} {epi}: "
            + ", ".join(f"{var} {row[var]:.4f}"
                        for var in GEMM_SPLIT_VARIANTS)
            + (f"; matmul {row['matmul_ms']:.4f}" if "matmul_ms" in row
               else "")
            + f"; library {row['library_ms']:.4f}; bound "
            f"{row['bound_ms']:.4f} ({row['bound_by']}) ms a call")
        rows.append(row)
        del bufs
    # B9's backward (dact and dyln with B9's weights as they lie in this
    # checkout) at the seg head's rows
    m, d = 65536, 384
    args = _op_inputs("mlp_block", (1, m, d), torch.bfloat16, gen)
    x2, prm = args[0].view(m, d), args[1:]
    dy = torch.randn(m, d, generator=gen).to(torch.bfloat16).to(dev)
    _, act, dg = fm._mlp_fwd_stash(x2, *prm)
    b9 = cuda_ms(lambda: fm._mlp_bwd_stash(x2, dy, act, dg, prm[0], prm[1],
                                           prm[2], prm[4]), iters=10,
                 repeats=5)
    log(f"[gemm_split] B9 backward (65536, 384) -> 1536: {b9:.4f} ms a call")
    return {"rows": rows, "b9_bwd_ms": b9}


# the bf16 GEMM's rows of phase 2: GEMM_SHAPES and B3's cross-attention
# products, with their launches per batch-64 reconstruct forward
GEMM_PATH_CALLS = {"serving encoder qkv": 24, "serving encoder proj": 24,
                   "serving encoder fc1": 24, "serving encoder fc2": 24,
                   "serving decoder qkv": 6, "serving decoder proj": 6,
                   "serving decoder fc1": 9, "serving decoder fc2": 9,
                   "serving decoder cross q": 3,
                   "serving decoder cross kv": 3,
                   "serving decoder cross proj": 3}
GEMM_CROSS_SHAPES = [
    ("serving decoder cross q", (16384, 256, 256), "bias", "3 / forward"),
    ("serving decoder cross kv", (16448, 512, 256), "bias", "3 / forward"),
    ("serving decoder cross proj", (16384, 256, 256), "bias", "3 / forward"),
]


def gemm_rows(shapes=None, calls=None, key="calls_per_forward"):
    """The bf16 GEMM (``runtime.gemm``, csrc/gemm_pingpong.cuh through
    csrc/gemm.cu) at ``shapes`` (default GEMM_SHAPES and B3's products;
    epilogue "none": no bias), bf16 operands, against float32 math from
    the same inputs (max-abs BF16_MAX_ABS, rel-L2 BF16_REL_L2), a rerun
    bit-identical; then the kernel, the float32 plain version,
    ``torch.matmul`` of the product alone and the ``F.linear`` composition
    timed, beside the bound. ``calls`` (default GEMM_PATH_CALLS): label ->
    launches on the path, in each row's ``key``."""
    import torch
    import torch.nn.functional as F

    from mirage_tpu_torch.ops import runtime
    from mirage_tpu_torch.ops.quant import _erf_as

    gen = torch.Generator().manual_seed(SEED + 12)

    def rn(*s, scale=1.0):
        return (torch.randn(*s, generator=gen) * scale).to(torch.bfloat16) \
            .cuda()

    rows = []
    calls = GEMM_PATH_CALLS if calls is None else calls
    for label, shape, epi, _ in shapes or GEMM_SHAPES + GEMM_CROSS_SHAPES:
        m, n, k = shape
        a, w = rn(m, k), rn(n, k, scale=k ** -0.5)
        bias = None if epi == "none" else rn(n, scale=0.02)
        res = rn(m, n) if epi == "res" else None

        def kernel():
            if epi == "as26":
                return runtime.gemm_gelu_mode(a, w, bias, mode="as26")
            return runtime.gemm(a, w, bias, residual=res, gelu=epi == "gelu")

        def plain(dt):
            y = F.linear(a.to(dt), w.to(dt),
                         None if bias is None else bias.to(dt))
            if epi == "gelu":
                y = F.gelu(y)
            elif epi == "as26":
                y = 0.5 * y * (1.0 + _erf_as(y / math.sqrt(2.0)))
            return y + res.to(dt) if res is not None else y

        got = kernel()
        again = kernel()
        torch.cuda.synchronize()
        want = plain(torch.float32)
        diff = got.float() - want
        max_abs = diff.abs().max().item()
        rel_l2 = (diff.norm() / want.norm()).item()
        if not (max_abs <= BF16_MAX_ABS and rel_l2 <= BF16_REL_L2
                and bool(torch.isfinite(got).all())
                and torch.equal(got, again)):
            raise AssertionError(
                f"gemm {label} {shape}: max_abs {max_abs} rel_l2 {rel_l2} "
                f"against float32 math, or a rerun differs")
        del got, again, want, diff
        flops, nbytes = _gemm_work(shape, "res" if res is not None else epi)
        bound_ms, bound_by = _bound((flops, nbytes))
        row = {"label": label, "shape": list(shape), "epilogue": epi,
               "dtype": "bf16", "max_abs_err": max_abs, "rel_l2_err": rel_l2,
               "ms": cuda_ms(kernel, iters=20, repeats=5),
               "plain_ms": cuda_ms(lambda: plain(torch.float32), iters=5),
               "matmul_ms": cuda_ms(lambda: torch.matmul(a, w.t()), iters=20,
                                    repeats=5),
               "library_ms": cuda_ms(lambda: plain(torch.bfloat16), iters=20,
                                     repeats=5),
               "library": "F.linear (+ F.gelu) (+ residual add) in bf16; "
                          "matmul_ms: torch.matmul of the product alone",
               "bound_ms": bound_ms, "bound_by": bound_by,
               key: calls.get(label, 0)}
        log(f"[kernels] gemm {label} {shape} {epi}: max_abs {max_abs:.3e} "
            f"rel_l2 {rel_l2:.3e}; kernel {row['ms']:.4f} ms, plain "
            f"{row['plain_ms']:.4f}, matmul {row['matmul_ms']:.4f}, library "
            f"{row['library_ms']:.4f}, bound {bound_ms:.4f} ({bound_by})")
        rows.append(row)
        del a, w, bias, res
    return rows


def gemm_s8_rows():
    """The int8 GEMM (csrc/gemm_pingpong.cuh through csrc/quant.cu) at
    GEMM_S8_SHAPES: S3's s32 product exact against the int64 product, B12's
    fc1 (float h within rel-L2 1e-5 of float32 math: exp2f within 2 ulp;
    the rows' abs-max the same within that) and fc2 (the bf16 gates) against
    the plain math on the same codes, each rerun bit-identical; timed
    beside ``torch._int_mm`` and the bound."""
    import torch

    from mirage_tpu_torch.ops import quant, runtime

    gen = torch.Generator().manual_seed(SEED + 13)
    rows = []
    for label, shape, epi, calls in GEMM_S8_SHAPES:
        m, n, k = shape
        a = torch.randint(-127, 128, (m, k), generator=gen,
                          dtype=torch.int8).cuda()
        w = torch.randint(-127, 128, (n, k), generator=gen,
                          dtype=torch.int8).cuda()
        # B12's scales: a row's abs-max / 127 of O(1) activations, a
        # channel's of weights ~ N(0, 1/K) (abs-max ≈ 4/√K), so v is O(1)
        rs = ((torch.rand(m, generator=gen) + 1) / 254).cuda()
        s = ((torch.rand(n, generator=gen) + 1) * 2 / (127 * k ** 0.5)).cuda()
        b = (torch.randn(n, generator=gen) * 0.02).cuda()
        x = torch.randn(m, n, generator=gen).to(torch.bfloat16).cuda()
        prod = quant._int_product(a, w)  # exact, as float32 (the s32 cast)
        if epi == "s32":
            def kernel():
                return runtime.gemm_s8_s32(a, w)
            got, again = kernel(), kernel()
            exact = torch.equal(got, quant.gemm_s8_ref(a, w))
            errs = {"exact": exact}
            ok = exact
        elif epi == "fc1":
            def kernel():
                return runtime.gemm_s8_fc1(a, w, rs, s, b)
            got, again = kernel(), kernel()
            h = prod * rs[:, None] * s + b
            h = 0.5 * h * (1.0 + quant._erf_as(h / math.sqrt(2.0)))
            rel = ((got[0] - h).norm() / h.norm()).item()
            amax = ((got[1] - h.abs().amax(-1)).abs().max()
                    / h.abs().max()).item()
            errs = {"rel_l2": rel, "amax_rel": amax}
            ok = rel <= 1e-5 and amax <= 1e-5
        else:
            def kernel():
                return runtime.gemm_s8_fc2(a, w, rs, s, b, x)
            got, again = kernel(), kernel()
            want = x.float() + (prod * rs[:, None] * s + b) \
                .to(torch.bfloat16).float()
            d = got.float() - want
            errs = {"max_abs": d.abs().max().item(),
                    "rel_l2": (d.norm() / want.norm()).item()}
            ok = errs["max_abs"] <= BF16_MAX_ABS and \
                errs["rel_l2"] <= BF16_REL_L2
        same = all(torch.equal(p, q) for p, q in zip(
            got if isinstance(got, tuple) else (got,),
            again if isinstance(again, tuple) else (again,)))
        if not ok or not same:
            raise AssertionError(f"gemm_s8 {label} {shape}: {errs}, rerun "
                                 f"bit-identical {same}")
        flops, nbytes = _gemm_work(shape, epi)
        t_ops, t_bytes = flops / PEAK_INT8_OPS * 1e3, nbytes / PEAK_BYTES * 1e3
        row = {"label": label, "shape": list(shape), "epilogue": epi,
               "errors": errs, "ms": cuda_ms(kernel, iters=20, repeats=5),
               "library_ms": cuda_ms(lambda: torch._int_mm(a, w.t()),
                                     iters=20, repeats=5),
               "library": "torch._int_mm (s32 out)",
               "bound_ms": max(t_ops, t_bytes),
               "bound_by": "operations" if t_ops >= t_bytes else "bytes",
               "calls": calls}
        log(f"[kernels] gemm_s8 {label} {shape} {epi}: {errs}; kernel "
            f"{row['ms']:.4f} ms, _int_mm {row['library_ms']:.4f}, bound "
            f"{row['bound_ms']:.4f} ({row['bound_by']})")
        rows.append(row)
        del a, w, rs, s, b, x, prod, got, again
    return rows


def attention_bwd_core_rows(cases):
    """The bf16 attention backward alone (csrc/attention_bwd.cuh through
    ``runtime.attention_bwd`` or ``runtime.flash_attention_bwd``) at
    ``cases`` ((label, ATTN_BWD_SHAPES shape, cross, entry, calls a step on
    its path)), bf16 against its plain version in float32 from the same
    inputs (rel-L2 BWD_REL_L2, max BWD_REL_MAX; the packed form's dbqkv
    partials too), a rerun bit for bit the same; then the kernel, its plain
    version, SDPA's backward alone and SDPA's forward and backward timed."""
    import torch

    from mirage_tpu_torch.ops import runtime
    from mirage_tpu_torch.ops.block_attention import block_attention_bwd_ref
    from mirage_tpu_torch.ops.flash_attention import flash_attention_bwd_ref

    gen = torch.Generator().manual_seed(SEED + 10)
    lib_bwd = _flash_library(True)
    rows = []
    for label, shape, cross, entry, per_step in cases:
        b, nq, nk, h, dh = shape
        d, scale = h * dh, dh ** -0.5
        q, k, v, out, lse, q_src, kv_src = _attn_inputs(shape, cross, gen)
        dy = torch.randn(b, nq, d, generator=gen).to(torch.bfloat16).cuda()

        def heads(t):
            return t.reshape(b, t.shape[1], h, dh).transpose(1, 2)

        if entry == "attention_bwd":
            def launch():
                return runtime.attention_bwd(q_src, dy, heads=h, dh=dh,
                                             scale=scale, partials=True)
            kernel = launch

            def plain():
                return block_attention_bwd_ref(q_src, dy, h, scale)
            want = block_attention_bwd_ref(q_src.float(), dy.float(), h,
                                           scale)
            wants = {"dqkv": want, "dbqkv": want.sum((0, 1))}
        else:
            lse = runtime.flash_attention(q, k, v, out, heads=h, dh=dh,
                                          scale=scale)
            # the gradients of the packed sources: dqkv, or dq and dkv
            srcs = [torch.empty_like(t) for t in (q_src, kv_src)
                    if t is not None]
            grads = [g[..., i * d:(i + 1) * d] for g in srcs
                     for i in range(g.shape[-1] // d)]

            def launch():
                runtime.flash_attention_bwd(q, k, v, dy, lse, *grads,
                                            heads=h, dh=dh, scale=scale)

            def kernel():
                launch()
                return [g.clone() for g in srcs]

            def plain():
                return flash_attention_bwd_ref(heads(q), heads(k), heads(v),
                                               heads(dy), scale)
            want = [w.transpose(1, 2).reshape(b, w.shape[2], d)
                    for w in flash_attention_bwd_ref(
                        *(heads(t.float()) for t in (q, k, v, dy)), scale)]
            wants = ({"dqkv": torch.cat(want, -1)} if kv_src is None else
                     {"dq": want[0], "dkv": torch.cat(want[1:], -1)})
        got, again = kernel(), kernel()
        torch.cuda.synchronize()
        if not all(torch.equal(a, c) for a, c in zip(got, again)):
            raise AssertionError(f"attention_bwd {label}: a rerun is not "
                                 f"bit-identical")
        got = {"dqkv": got[0], "dbqkv": got[1].sum(0)} \
            if entry == "attention_bwd" else dict(zip(wants, got))
        errs = {}
        for name, w in wants.items():
            diff = got[name].float() - w
            errs[name] = {"max_abs": diff.abs().max().item(),
                          "rel_max": (diff.abs().max() / w.abs().max()).item(),
                          "rel_l2": (diff.norm() / w.norm()).item()}
            if not (bool(torch.isfinite(got[name]).all())
                    and errs[name]["rel_l2"] <= BWD_REL_L2
                    and errs[name]["rel_max"] <= BWD_REL_MAX):
                raise AssertionError(f"attention_bwd {label} {name}: kernel "
                                     f"disagrees with its plain version: "
                                     f"{errs[name]}")
        del got, again, want, wants
        ms = cuda_ms(launch)
        plain_ms = cuda_ms(plain, iters=5)
        sdpa_bwd_ms = cuda_ms(_sdpa_bwd_alone(q_src, kv_src, h, scale, dy))
        library_ms = cuda_ms(lambda: lib_bwd(dy, q_src, kv_src, h, scale))
        bound_ms, bound_by = _bound(_attn_bwd_core_work(shape, entry))
        row = {"label": label, "shape": list(shape), "dtype": "bf16",
               "entry": entry, "errors": errs,
               "max_abs_err": max(e["max_abs"] for e in errs.values()),
               "rerun_bit_identical": True, "ms": ms, "plain_ms": plain_ms,
               "sdpa_bwd_ms": sdpa_bwd_ms, "library_ms": library_ms,
               "library": "F.scaled_dot_product_attention forward and "
                          "backward (torch.autograd.grad) on the same views; "
                          "sdpa_bwd_ms: its backward alone",
               "bound_ms": bound_ms, "bound_by": bound_by,
               "calls_per_step": per_step}
        log(f"[kernels] attention_bwd {label} {shape} {entry}: worst rel_l2 "
            f"{max(e['rel_l2'] for e in errs.values()):.3e}; rerun "
            f"bit-identical; kernel {ms:.4f} ms plain {plain_ms:.4f} ms SDPA "
            f"bwd {sdpa_bwd_ms:.4f} ms fwd+bwd {library_ms:.4f} ms bound "
            f"{bound_ms:.4f} ms ({bound_by})")
        rows.append(row)
        del q, k, v, out, lse, q_src, kv_src, dy
    return rows


def _rows_of(labels, calls):
    """The ATTN_BWD_SHAPES cases named in ``labels``, each with its calls a
    step on the path at hand."""
    return [(label, shape, cross, entry, calls[label])
            for label, shape, cross, entry, _ in ATTN_BWD_SHAPES
            if label in labels]


def _bwd_ops():
    """op -> (kernel, plain version), each called as fn(args, dy, **kw),
    and op -> the names of its outputs, of phase 2's backward rows."""
    from mirage_tpu_torch.ops import block_attention as ba
    from mirage_tpu_torch.ops import fused_mlp as fm

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
    return ops, names


def bwd_op_rows(cases, gen, results, key="calls_per_step"):
    """Each backward op (and B6's forward) at ``cases`` ((op, label, shape,
    kwargs, calls on the path, in each row's ``key``)) against its plain
    version in float32 from the same inputs, every output compared and
    every backward rerun bit for bit; timed beside the plain version, the
    library and the bound. Adds rows to ``results``."""
    import torch

    from mirage_tpu_torch.ops import runtime

    ops, names = _bwd_ops()
    for op, label, shape, kw, per_step in cases:
        kernel, ref = ops[op]
        args, dy = _bwd_inputs(op, shape, torch.bfloat16, gen)
        got = kernel(args, dy, **kw)
        if op != "block_attention":  # every backward reruns bit for bit
            again = kernel(args, dy, **kw)
            if not all(torch.equal(a, b) for a, b in zip(got, again)
                       if a is not None):
                raise AssertionError(f"{op} {label}: a rerun is not "
                                     f"bit-identical")
            del again
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
               key: per_step, **kw}
        if op != "block_attention":
            row["rerun_bit_identical"] = True
        if op == "block_attention_bwd":
            row["sdpa_bwd_ms"] = cuda_ms(_sdpa_bwd_alone(
                args[0], None, args[1], args[2], dy), iters=10)
            if label == "classification encoder":
                row["calls_per_cls_step"] = 12
        if op == "mlp_block_bwd":
            row["split_ms"] = mlp_bwd_split(args, dy, f"{op} {label}", **kw)
        log(f"[kernels] {op} {label} {shape}: worst rel_l2 "
            f"{max(e['rel_l2'] for e in errs.values()):.3e} rel_max "
            f"{max(e['rel_max'] for e in errs.values()):.3e} kernel "
            f"{kernel_ms:.4f} ms plain {plain_ms:.4f} ms library "
            f"{library_ms:.4f} ms"
            + (f" SDPA bwd {row['sdpa_bwd_ms']:.4f} ms"
               if "sdpa_bwd_ms" in row else "")
            + f" bound {row['bound_ms']:.4f} ms ({row['bound_by']})")
        results.setdefault(op, []).append(row)
        del args, dy
    return results


def phase_backward(results):
    """Each backward op (and B6's forward) at the pretraining shapes against
    its plain version computed in float32 from the same inputs; every output
    compared. Adds rows to ``results``."""
    import torch

    from mirage_tpu_torch.ops import runtime

    ops, _ = _bwd_ops()
    # (op, label, shape, kwargs, calls per pretraining step)
    cases = [
        ("attn_half_block_bwd", "encoder", (256, 99, 768, 12), {}, 12),
        ("mlp_block_bwd", "encoder", (256, 99, 768), {}, 12),
        ("mlp_block_bwd", "decoder", (256, 256, 256), {}, 6),
        ("mlp_block_bwd", "encoder residual=False", (256, 99, 768),
         {"residual": False}, 0),
        ("mlp_block_bwd", "decoder residual=False", (256, 256, 256),
         {"residual": False}, 0),
        ("mlp_block_bwd", "classification encoder", (BATCH, 257, 768), {}, 0),
        ("block_attention", "decoder", (256, 256, 256, 8), {}, 6),
        ("block_attention_bwd", "decoder", (256, 256, 256, 8), {}, 6),
        # B6's backward in the classification full fine-tune: 12 a cls step
        ("block_attention_bwd", "classification encoder", (BATCH, 257, 768, 12),
         {}, 0),
    ]
    gen = torch.Generator().manual_seed(SEED + 1)
    bwd_op_rows(cases, gen, results)

    # the bf16 attention backward alone at the packed shapes: a pretraining
    # step's B4 (B7-attention under its switch) and B6 calls, and B6's in a
    # classification full fine-tune step
    results["attention_bwd"] = attention_bwd_core_rows(_rows_of(
        ("B4 core, pretraining encoder", "B6, pretraining decoders",
         "B6, cls full fine-tune"),
        {"B4 core, pretraining encoder": 12, "B6, pretraining decoders": 6,
         "B6, cls full fine-tune": 0}))
    results["attention_bwd"][-1]["calls_per_cls_step"] = 12

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
        "mirage_tpu_torch/ops/fused_mlp.py",
        ["layernorm.cu", "gemm_stash.cu", "gemm.cu"]),
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


def stash_split(x2, prm, label):
    """ms of each launch of the stash chain at the rows x2 (M, D), CUDA
    events: the LN, fc1 with the stash epilogue (act and dg), the same
    product with B2's GELU epilogue and with none, fc2 with bias and the
    residual, and the chain itself; the differences price the stash
    epilogue, the GELU and fc2's padding. Fails unless the stash's act is
    bit-equal to B2's fc1 output."""
    import torch

    from mirage_tpu_torch.ops import fused_mlp as fm
    from mirage_tpu_torch.ops import runtime

    ln_w, ln_b, w1, b1, w2, b2 = prm
    y = runtime.layernorm(x2, ln_w, ln_b)
    act, _ = runtime.gemm_gelu_stash(y, w1, b1)
    if not torch.equal(act, runtime.gemm(y, w1, b1, gelu=True)):
        raise AssertionError(f"{label}: the stash's act is not B2's fc1 "
                             f"output bit for bit")
    split = {
        "ln": cuda_ms(lambda: runtime.layernorm(x2, ln_w, ln_b), iters=10),
        "fc1_stash": cuda_ms(lambda: runtime.gemm_gelu_stash(y, w1, b1),
                             iters=10),
        "fc1_gelu": cuda_ms(lambda: runtime.gemm(y, w1, b1, gelu=True),
                            iters=10),
        "fc1_none": cuda_ms(lambda: runtime.gemm(y, w1, b1), iters=10),
        "fc2": cuda_ms(lambda: runtime.gemm(act, w2, b2, residual=x2),
                       iters=10),
        "chain": cuda_ms(lambda: fm._stash_chain(x2, *prm), iters=10)}
    log(f"[kernels] {label} stash chain split {tuple(x2.shape)} -> "
        f"{w1.shape[0]} (ms): " + ", ".join(f"{k} {v:.4f}"
                                            for k, v in split.items()))
    return split


def _check_outputs(name, label, got, want, fwd, f32=False):
    """Each output against its plain version: float32 within F32_ATOL of
    its scale, a bf16 forward within BF16_MAX_ABS and BF16_REL_L2, a bf16
    backward within BWD_REL_L2 and BWD_REL_MAX; name -> errors."""
    import torch

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


def _op_row(label, shape, errs, kernel_ms, plain_ms, library_ms, work,
            per_step, **extra):
    """A timed row of a checked op, logged."""
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


def flash_op_rows(cases, gen, results):
    """B8 (flash attention), forward and backward, at ``cases`` ((label,
    shape: (b, h, n, dh) self or (b, h, nq, nk, dh) cross, calls a step on
    its path)) against its plain version in float32 from the same bf16
    inputs, the log-sum-exp within LSE_ATOL, the backward rerun bit for
    bit; timed beside the plain version, the library and SDPA's backward
    alone. Adds rows to ``results``."""
    import torch

    from mirage_tpu_torch.ops import flash_attention as fa
    from mirage_tpu_torch.ops import runtime

    for label, shape, per_step in cases:
        (q_src, kv_src, h, scale), dy = _flash_inputs(shape, torch.bfloat16,
                                                      gen)
        out, lse = fa._flash_fwd(q_src, kv_src, h, scale)
        grads = fa._flash_bwd(q_src, kv_src, lse, dy, h, scale)
        if not all(torch.equal(a, b) for a, b in zip(
                grads, fa._flash_bwd(q_src, kv_src, lse, dy, h, scale))
                if a is not None):
            raise AssertionError(f"flash_attention_bwd {label}: a rerun is "
                                 f"not bit-identical")
        torch.cuda.synchronize()
        f32 = [t.float() if t is not None else None for t in (q_src, kv_src)]
        with runtime.plain_on_card():
            want = fa._flash_fwd(f32[0], f32[1], h, scale)[0]
            want_g = fa._flash_bwd(f32[0], f32[1], None, dy.float(), h, scale)
        names = ["dqkv"] if kv_src is None else ["dq", "dkv"]
        errs_f = _check_outputs(["out"], f"flash_attention {label}", [out],
                                [want], True)
        # the log-sum-exp the backward reads, in log2 units
        d = q_src.shape[-1] // (3 if kv_src is None else 1)
        qw = q_src[..., :d]
        kw = q_src[..., d:2 * d] if kv_src is None else kv_src[..., :d]

        def split(t):
            return t.float().reshape(t.shape[0], t.shape[1], h, -1) \
                .transpose(1, 2)

        s = split(qw) @ split(kw).transpose(-1, -2) * scale
        want_lse = torch.logsumexp(s, -1) / math.log(2.0)
        lse_err = (lse - want_lse).abs().max().item()
        errs_f["lse"] = {"max_abs": lse_err, "rel_l2": (
            (lse - want_lse).norm() / want_lse.norm()).item()}
        log(f"[kernels] flash_attention {label}: lse max_abs {lse_err:.3e} "
            f"(log2 units; bar {LSE_ATOL})")
        if not lse_err <= LSE_ATOL:
            raise AssertionError(f"flash_attention {label}: lse max_abs "
                                 f"{lse_err} > {LSE_ATOL}")
        del s, want_lse
        errs_b = _check_outputs(names, f"flash_attention_bwd {label}",
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
        sdpa_b = cuda_ms(_sdpa_bwd_alone(q_src, kv_src, h, scale, dy),
                         iters=10)
        shape5 = shape if len(shape) == 5 else shape[:3] + shape[2:]
        results.setdefault("flash_attention", []).append(
            _op_row(f"flash_attention {label}", shape, errs_f, k_f, p_f,
                    l_f, _flash_work(shape5, 2, False), per_step))
        results.setdefault("flash_attention_bwd", []).append(
            _op_row(f"flash_attention_bwd {label}", shape, errs_b, k_b, p_b,
                    l_b, _flash_work(shape5, 2, True), per_step,
                    rerun_bit_identical=True, sdpa_bwd_ms=sdpa_b))
        log(f"[kernels] flash_attention_bwd {label}: rerun bit-identical; "
            f"SDPA bwd alone {sdpa_b:.4f} ms")
        del q_src, kv_src, dy, lse
    return results


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

    # B8: (label, shape, calls per seg train step)
    flash_op_rows([("encoder self-attention", (4, 12, 1025, 64), 12),
                   ("decoder cross-attention", (64, 8, 256, 769, 32), 0)],
                  gen, results)

    # the bf16 attention backward alone at B8's shapes: 12 a seg step
    results["flash_bwd"] = attention_bwd_core_rows(_rows_of(
        ("B8, seg encoder", "B8, decoder cross"),
        {"B8, seg encoder": 12, "B8, decoder cross": 0}))

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
    if not all(torch.equal(a, b) for a, b in zip(grads, fm._mlp_bwd_stash(
            x2, dy, act, dg, prm[0], prm[1], prm[2], prm[4]))):
        raise AssertionError("mlp_block_stash_bwd: a rerun is not "
                             "bit-identical")
    torch.cuda.synchronize()
    with runtime.plain_on_card():
        pf = [a.float() for a in prm]
        want = fm.mlp_block_fwd_stash_ref(x2.float(), *pf)
        want_g = fm.mlp_block_bwd_stash_ref(
            x2.float(), dy.float(), act.float(), dg.float(), pf[0], pf[1],
            pf[2], pf[4])
    errs_f = _check_outputs(["out", "act", "dgelu"], "mlp_block_stash",
                            [out, act, dg], want, True)
    errs_b = _check_outputs(["dx", "dgamma", "dbeta", "dw1", "db1", "dw2",
                             "db2"], "mlp_block_stash_bwd", grads, want_g,
                            False)
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
    split = stash_split(x2, prm, "mlp_block_stash ConvNeXt head")
    results.setdefault("mlp_block_stash", []).append(
        _op_row("mlp_block_stash ConvNeXt head", (m, d, 4 * d), errs_f,
                k_f, p_f, l_f, _stash_work(m, d, 2, False), 4,
                split_ms=split))
    results.setdefault("mlp_block_stash_bwd", []).append(
        _op_row("mlp_block_stash_bwd ConvNeXt head", (m, d, 4 * d), errs_b,
                k_b, p_b, l_b, _stash_work(m, d, 2, True), 4))
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
        errs = _check_outputs(
            ["out"] + [f"grad{i}" for i in range(len(grads))],
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
    errs = _check_outputs([f"out{i}" for i in range(10)],
                          "mlp_block_stash float32", list(got) + list(got_g),
                          list(want) + list(want_g), True, f32=True)
    err = max(e["max_abs"] for e in errs.values())
    log(f"[kernels] mlp_block_stash float32 (2048, 384): max_abs {err:.3e}")
    results["mlp_block_stash"].append(
        {"label": "float32 check", "shape": [2048, 384, 1536],
         "dtype": "f32", "max_abs_err": err})
    torch.cuda.synchronize()
    return results


# the accumulating backwards (B7) and the AdamW update (B11): name ->
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
        ["layernorm.cu", "mlp_bwd.cu", "wgrad.cu"]),
    "fused_adamw": (
        "mirage_tpu/ops/fused_adamw.py:111",
        "fused_adamw_leaf :133 -> _adamw_kernel :111",
        "mirage_tpu_torch/ops/fused_adamw.py", ["adamw.cu"]),
}
B11_RTOL, B11_ATOL = 1e-6, 1e-7


def _cls_leaves(gen):
    """The float32 leaves B11 takes in the classification full fine-tune
    (MIRAGE-Base, one 512² B-scan at patch 32, seeded): every trainable
    leaf, weights of 768 to 2.4 M elements and the biases and LN vectors
    beside them."""
    from mirage_tpu_torch.api.wrapper import build_model

    model = build_model("miragepre_base", {}, ["bscan"], 512, 32,
                        with_outputs=False, generator=gen)
    return [p.detach().cuda() for n, p in model.named_parameters()
            if "pos_emb" not in n]


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

    def b7m(args, dy, **kw):
        return fm._mlp_bwd_acc(args[0], dy, *args[1:6], **kw)

    def b7m_ref(args, dy, **kw):
        return fm.mlp_block_bwd_acc_ref(args[0], dy, *args[1:6], **kw)

    ops = {"attn_half_block_acc_bwd": (b7a, b7a_ref, "attn_half_block_bwd",
                                       ["dx", "dgamma", "dbeta", "dwqkv",
                                        "dbqkv", "dwproj", "dbproj"]),
           "mlp_block_acc_bwd": (b7m, b7m_ref, "mlp_block_bwd",
                                 ["dx", "dgamma", "dbeta", "dw1", "db1",
                                  "dw2", "db2"])}
    # (op, label, shape, calls per step of its path, path, kwargs)
    cases = [
        ("attn_half_block_acc_bwd", "pretraining encoder", (256, 99, 768, 12),
         12, "pretrain", {}),
        ("mlp_block_acc_bwd", "classification encoder", (BATCH, 257, 768),
         12, "cls", {}),
        ("mlp_block_acc_bwd", "pretraining encoder", (256, 99, 768), 0,
         "cls", {}),
        ("mlp_block_acc_bwd", "pretraining decoder", (256, 256, 256), 0,
         "cls", {}),
        ("mlp_block_acc_bwd", "classification encoder residual=False",
         (BATCH, 257, 768), 0, "cls", {"residual": False}),
        ("mlp_block_acc_bwd", "pretraining decoder residual=False",
         (256, 256, 256), 0, "cls", {"residual": False}),
    ]
    rows = {"pretrain": {}, "cls": {}}
    for op, label, shape, per_step, path, kw in cases:
        kernel, ref, base, names = ops[op]
        args, dy = _bwd_inputs(base, shape, torch.bfloat16, gen)
        got = kernel(args, dy, **kw)
        again = kernel(args, dy, **kw)
        torch.cuda.synchronize()
        rerun_equal = all(torch.equal(a, b) for a, b in zip(got, again)
                          if a is not None)
        if not rerun_equal:
            raise AssertionError(f"{op} {label}: a rerun is not bit-identical")
        del again
        with runtime.plain_on_card():
            want = ref([a.float() if torch.is_tensor(a) else a
                        for a in args], dy.float(), **kw)
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
        kernel_ms = cuda_ms(lambda: kernel(args, dy, **kw), iters=10)
        with runtime.plain_on_card():
            plain_ms = cuda_ms(lambda: ref(args, dy, **kw), iters=5)
        lib = _bwd_library(base)
        library_ms = cuda_ms(lambda: lib(dy, *args, **kw), iters=10)
        flops, nbytes = _bwd_work(base, shape, 2)
        t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
        row = {"label": label, "shape": list(shape), "dtype": "bf16",
               "errors": errs, "rerun_bit_identical": rerun_equal,
               "max_abs_err": max(e["max_abs"] for e in errs.values()),
               "ms": kernel_ms, "plain_ms": plain_ms,
               "library_ms": library_ms, "bound_ms": max(t_ops, t_bytes),
               "bound_by": "operations" if t_ops >= t_bytes else "bytes",
               "calls_per_step": per_step, **kw}
        if op == "mlp_block_acc_bwd":
            row["split_ms"] = mlp_bwd_split(args, dy, f"{op} {label}",
                                            acc=True, **kw)
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


# the AdamW step over a pretraining step's trainable leaves (the
# published config through the CLI's parser, built on the meta device):
# MIRAGE-Base 296 leaves, 98.2 M elements; MIRAGE-Large 440, 317.2 M
ADAMW_MODELS = ("miragepre_base", "miragepre_large")
ADAMW_STEPS = 10  # host-timed updates a route, after the two compared ones


def _host_ms(fn):
    """The host's ms to launch ``fn`` (the median of ADAMW_STEPS calls, each
    after a synchronize)."""
    import statistics

    import torch

    host = []
    for _ in range(ADAMW_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        host.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(host)


def adamw_rows(card):
    """The optimizer's two routes over each of ADAMW_MODELS' trainable
    leaves (seeded state on the card, lr 1e-4, the CLI's betas and wd): the
    leaf table (the default) against MIRAGE_OPT_KERNEL=off over two steps
    (every leaf on the table; m, n, p within rtol 1e-6 and the norms within
    1e-6 relative), then each route's host ms an update and its kernels
    under torch.profiler (their device ms and count), and the two kernels
    alone (device alone, rerun bit for bit) against their bounds (4 and 28
    bytes a parameter at 3.35 TB/s)."""
    import functools

    import torch

    from mirage_tpu_torch.cli import run_pretraining as rp
    from mirage_tpu_torch.cli.config import parse_with_yaml
    from mirage_tpu_torch.ops import fused_adamw as fa
    from mirage_tpu_torch.ops import runtime
    from mirage_tpu_torch.train.optim import GroupedOptimizer, OptimizerConfig

    rows = {}
    for model in ADAMW_MODELS:
        args = rp.process_args(parse_with_yaml(rp.get_parser(), [
            "-c", str(ROOT / PRETRAIN_CONFIG), "--data_path", ".",
            "--model", model]))
        with torch.device("meta"):
            net = rp.build_model(args, torch.Generator().manual_seed(SEED))
        cfg = OptimizerConfig(opt=args.opt, betas=tuple(args.opt_betas),
                              eps=args.opt_eps,
                              weight_decay=args.weight_decay)
        meta = GroupedOptimizer(cfg).meta(dict(net.named_parameters()))
        shapes = {n: tuple(p.shape) for n, p in net.named_parameters()
                  if meta[n][2]}
        del net
        numel = sum(math.prod(s) for s in shapes.values())
        gen = torch.Generator(device="cuda").manual_seed(SEED + 40)
        p0 = {n: torch.randn(s, device="cuda", generator=gen) * 0.02
              for n, s in shapes.items()}
        grads = [{n: torch.randn(s, device="cuda", generator=gen) * 1e-4
                  for n, s in shapes.items()} for _ in range(2)]
        routes = {}
        for switch in ("on", "off"):
            params = {n: t.clone() for n, t in p0.items()}
            opt = GroupedOptimizer(cfg)
            state = opt.init(params)
            with runtime.switched({"MIRAGE_OPT_KERNEL": switch}):
                norms = [opt.update(g, state, params, 1e-4).item()
                         for g in grads]
            routes[switch] = (opt, params, state, norms)
        (opt, params, state, norms), (_, p_off, s_off, n_off) = \
            routes["on"], routes["off"]
        table = opt._table
        bad = sum(int((~torch.isclose(a, b, rtol=B11_RTOL,
                                      atol=B11_ATOL)).sum())
                  for n in shapes for a, b in (
                      (params[n], p_off[n]), (state["mu"][n], s_off["mu"][n]),
                      (state["nu"][n], s_off["nu"][n])))
        bit_equal = all(torch.equal(a, b) for n in shapes for a, b in (
            (params[n], p_off[n]), (state["mu"][n], s_off["mu"][n]),
            (state["nu"][n], s_off["nu"][n])))
        norm_rel = max(abs(a - b) / b for a, b in zip(norms, n_off))
        if table is None or len(table.names) != len(shapes) or bad \
                or norm_rel > 1e-6:
            raise AssertionError(
                f"adamw {model}: table {table and len(table.names)} of "
                f"{len(shapes)} leaves, {bad} elements outside rtol "
                f"{B11_RTOL} atol {B11_ATOL}, norm gap {norm_rel}")
        timed = {}
        for switch, (o, pp, st, _) in routes.items():
            with runtime.switched({"MIRAGE_OPT_KERNEL": switch}):
                fn = functools.partial(o.update, grads[0], st, pp, 1e-4)
                prof = profile_forward(fn) or {}
                timed[switch] = (_host_ms(fn), sum(prof.get(
                    "kernel_ms_by_group", {}).values()), prof.get("kernels"))
        del routes, p_off, s_off
        count, out = state["count"], torch.empty((), device="cuda")

        def norm():
            runtime.adamw_norm(table.tiles, fa.TILE, table.leaves,
                               table.step_buf, table.slots, table.arrived,
                               count, table.scalars, gnorm_out=out,
                               b1=cfg.betas[0], b2=cfg.betas[1])

        def update():
            table.update(cfg.betas[0], cfg.betas[1], cfg.eps)

        leaves = (*table.ms, *table.ns, *table.ps)
        norm()
        first = out.clone()
        norm()
        saved = [t.clone() for t in leaves]
        update()
        once = [t.clone() for t in leaves]
        for t, v in zip(leaves, saved):
            t.copy_(v)
        update()
        rerun = torch.equal(first, out) and all(
            torch.equal(a, b) for a, b in zip(once, leaves))
        del saved, once
        if not rerun:
            raise AssertionError(f"adamw {model}: a rerun is not "
                                 f"bit-identical")
        rows[model] = {
            "leaves": len(shapes), "params": numel,
            "table_leaves": len(table.names), "tiles": len(table.tiles),
            "tile": fa.TILE, "bit_equal_to_foreach": bit_equal,
            "norm_rel": norm_rel, "rerun_bit_identical": rerun,
            "norm_ms": device_ms(norm), "norm_bound_ms":
                4 * numel / PEAK_BYTES * 1e3,
            "update_ms": device_ms(update), "update_bound_ms":
                28 * numel / PEAK_BYTES * 1e3,
            "table_host_ms": timed["on"][0], "table_kernel_ms": timed["on"][1],
            "table_kernels": timed["on"][2], "foreach_host_ms":
                timed["off"][0], "foreach_kernel_ms": timed["off"][1],
            "foreach_kernels": timed["off"][2]}
        log(f"[adamw] {model}: " + json.dumps(rows[model]))
        del opt, params, state, table, leaves, p0, grads
        torch.cuda.empty_cache()
    return {"rows": rows, "card": card}


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
        "mirage_tpu_torch/ops/fused_mlp.py",
        ["layernorm.cu", "gemm_stash.cu", "gemm.cu"]),
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


def _block_inputs(shape, dtype, gen):
    """B10's operands at (b, n, d, heads): B1's then B2's, one LN each."""
    attn = _op_inputs("attn_half_block", shape, dtype, gen)
    mlp = _op_inputs("mlp_block", shape[:3], dtype, gen)
    return attn[:7] + mlp[1:] + (shape[3],)


def _fused_tile_sweep(args):
    """ms of B10 at each GEMM tile width of its plan (128, 256; the op
    takes ``fused_block.TILE_N``), each output within the bf16 bars of the
    op's."""
    from mirage_tpu_torch.ops.fused_block import (fused_block,
                                                  fused_block_launch)

    x, *prm, heads = args
    ref, out = fused_block(*args), {}
    for tn in (128, 256):
        got = fused_block_launch(x, *prm, heads, tile_n=tn)
        err = (got.float() - ref.float()).abs().max().item()
        if not err <= BF16_MAX_ABS:
            raise AssertionError(f"fused_block: tile_n {tn} moves the "
                                 f"output by {err}")
        out[tn] = cuda_ms(lambda: fused_block_launch(x, *prm, heads,
                                                     tile_n=tn), iters=5)
    return out


def fused_block_rows(cases, gen, results):
    """B10 (the one-launch whole block) in bf16 at ``cases`` ((label,
    shape, calls a forward)) against its plain version in float32 from the
    same inputs, beside B1 + B2 on the same inputs, with a rerun bit for
    bit, a sweep of the plan's GEMM tile width and µs by stage; timed
    beside the plain version, the library and the bound. Adds rows to
    ``results``."""
    import torch

    from mirage_tpu_torch.ops import runtime
    from mirage_tpu_torch.ops.block_attention import attn_half_block
    from mirage_tpu_torch.ops.fused_block import (fused_block,
                                                  fused_block_launch,
                                                  fused_block_plan,
                                                  fused_block_ref, stage_us)
    from mirage_tpu_torch.ops.fused_mlp import mlp_block

    lib_attn, lib_mlp = _library("attn_half_block"), _library("mlp_block")

    def library(*a):
        return lib_mlp(lib_attn(*a[:7], a[-1]), *a[7:13])

    def halves(*a):
        """B1 then B2 (the unfused route, seven launches) on the same
        inputs: what the one launch competes with."""
        return mlp_block(attn_half_block(*a[:7], a[-1]), *a[7:13])

    for label, shape, per_fwd in cases:
        args = _block_inputs(shape, torch.bfloat16, gen)
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
        if not torch.equal(fused_block(*args), got):
            raise AssertionError(f"fused_block {label}: a rerun differs")
        del got, want, diff
        kernel_ms = cuda_ms(lambda: fused_block(*args), iters=10)
        with runtime.plain_on_card():
            plain_ms = cuda_ms(lambda: fused_block_ref(*args), iters=5)
        library_ms = cuda_ms(lambda: library(*args), iters=10)
        launches = attn_half_block.launches, mlp_block.launches
        halves_ms = cuda_ms(lambda: halves(*args), iters=10)
        attn_half_block.launches, mlp_block.launches = launches
        sweep = _fused_tile_sweep(args)
        flops, nbytes = _block_work(shape, 2)
        t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
        x = args[0]
        plan = fused_block_plan(
            shape[0], shape[1], shape[2], args[9].shape[0], shape[3],
            torch.cuda.get_device_properties(x.device).multi_processor_count,
            runtime.fused_block_blocks_per_sm(shape[1],
                                              shape[2] // shape[3], x.dtype))
        # where one launch's time goes: each stage to its grid barrier
        stamps = torch.zeros(7 + plan["grid"], dtype=torch.int64,
                             device=x.device)
        fused_block_launch(*args[:-1], shape[3], stamps=stamps)
        torch.cuda.synchronize()
        stages = stage_us(stamps)
        row = {"label": label, "shape": list(shape), "dtype": "bf16",
               "max_abs_err": max_abs, "rel_l2_err": rel_l2,
               "ms": kernel_ms, "plain_ms": plain_ms,
               "library_ms": library_ms, "halves_ms": halves_ms,
               "stage_us": stages,
               "bound_ms": max(t_ops, t_bytes),
               "bound_by": "operations" if t_ops >= t_bytes else "bytes",
               "calls_per_forward": per_fwd, "ms_by_tile_n": sweep,
               "grid": plan["grid"], "items": plan["items"]}
        log(f"[kernels] fused_block {label} {shape}: max_abs {max_abs:.3e} "
            f"rel_l2 {rel_l2:.3e} kernel {kernel_ms:.4f} ms (B1 + B2 "
            f"{halves_ms:.4f}) plain {plain_ms:.4f} ms library "
            f"{library_ms:.4f} ms bound {row['bound_ms']:.4f} ms "
            f"({row['bound_by']}); grid {plan['grid']} CTAs, items "
            f"{plan['items']}; ms by GEMM tile width {sweep}; µs by stage "
            f"(one launch) " + json.dumps({k: round(v, 2)
                                           for k, v in stages.items()}))
        results.setdefault("fused_block", []).append(row)
        del args
    return results


def phase_serve_kernels(results):
    """B10 (the one-launch whole block) at the decoder and MIRAGE-Large
    encoder shapes in bf16 (:func:`fused_block_rows`) and one float32
    case, B12 (the int8 MLP) at the
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
    lib_mlp = _library("mlp_block")

    # B10: (label, shape, calls per reconstruct forward under
    # MIRAGE_BLOCK_FUSE=all)
    fused_block_rows([("decoder", (BATCH, 256, 256, 8), 6),
                      ("encoder", (BATCH, 257, 1024, 16), 24)], gen, results)
    # one MIRAGE-Base block at batch 1 (the golden's shape) in bf16: the
    # whole grid on one batch element's 257 rows
    args = _block_inputs((1, 257, 768, 12), torch.bfloat16, gen)
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
    sweep = _fused_tile_sweep(args)
    log(f"[kernels] fused_block (1, 257, 768, 12) bf16: max_abs "
        f"{max_abs:.3e} rel_l2 {rel_l2:.3e}; ms by GEMM tile width {sweep}")
    results["fused_block"].append({"label": "batch-1 tile sweep",
                                   "shape": [1, 257, 768, 12],
                                   "dtype": "bf16", "max_abs_err": max_abs,
                                   "rel_l2_err": rel_l2,
                                   "ms_by_tile_n": sweep})
    args = _block_inputs((2, 257, 1024, 16), torch.float32, gen)
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
    split = stash_split(args[0].view(-1, 768), args[1:], "mlp_block_fwd_stash3d")
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
            "split_ms": split,
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
    from mirage_tpu_torch.ops import runtime

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
    runtime.layernorm.launches = 0
    preds = wrapper({"bscan": golden["in_bscan"]})
    log(f"[golden] LN launches (runtime.layernorm) in the tiny forward: "
        f"{runtime.layernorm.launches}")
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
           "xattn_half_block": xattn_half_block,
           "attention_fwd": runtime.attention, "gemm": runtime.gemm}
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
        runtime.layernorm.launches = 0
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
        ln_launches = runtime.layernorm.launches
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
    ln_expected = LN_PER_RECONSTRUCT * n_rec + LN_PER_FEATURES * n_feat
    log(f"[serve] launches {counts}, expected {expected}; LN "
        f"(runtime.layernorm) {ln_launches}, expected {ln_expected}")
    if counts != expected or not all(counts.values()) \
            or ln_launches != ln_expected:
        raise AssertionError(f"launch counts {counts} != {expected} or LN "
                             f"{ln_launches} != {ln_expected}")

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
            "fused_block": 0, "attention_fwd": 33, "gemm": 135},
    "decoder": {"attn_half_block": 24, "mlp_block": 27,
                "xattn_half_block": 3, "fused_block": 6, "attention_fwd": 27,
                "gemm": 111},
    "all": {"attn_half_block": 0, "mlp_block": 3, "xattn_half_block": 3,
            "fused_block": 30, "attention_fwd": 3, "gemm": 15}}


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
           "xattn_half_block": xattn_half_block, "fused_block": fused_block,
           "attention_fwd": runtime.attention, "gemm": runtime.gemm}
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
           "attn_half_block": attn_half_block, "mlp_block": mlp_block,
           "attention_fwd": runtime.attention,
           "attention_fwd (flash entry)": runtime.flash_attention}
    for fn in ops.values():
        fn.launches = 0
    got = _post(url + "/v1/reconstruct", req)
    torch.cuda.synchronize()
    counts = {k: fn.launches for k, fn in ops.items()}
    # encoder: 24 × (B8 + B2); decoders: 3 × B8 cross-attention over 769
    # context tokens, 3 × 2 blocks × (B1 + B2)
    want_counts = {"flash_attention": 27, "attn_half_block": 6,
                   "mlp_block": 30, "attention_fwd": 6,
                   "attention_fwd (flash entry)": 27}
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


TRAIN_DOMAINS = ["bscan", "slo", "bscanlayermap"]
TRAIN_ARGS = dict(model="miragepre_base", num_global_tokens=1,
                  in_domains=TRAIN_DOMAINS, out_domains=TRAIN_DOMAINS,
                  decoder_dim=256, decoder_depth=2, decoder_num_heads=8)
TRAIN_DOMAIN_CONF = {
    "bscan": {"loss": "mse", "patch_size": 32, "norm_pix": True},
    "slo": {"loss": "mse", "patch_size": 32, "norm_pix": True},
    "bscanlayermap": {"loss": "ce", "patch_size": 8}}


def _train_model():
    """Phase 5's ViT-B pretraining model (seed SEED) on the card and its
    optimizer."""
    import torch

    from mirage_tpu_torch.api.wrapper import build_model
    from mirage_tpu_torch.train.optim import GroupedOptimizer, OptimizerConfig

    model = build_model("miragepre_base", TRAIN_ARGS, TRAIN_DOMAINS, 512, 32,
                        compute_dtype=torch.bfloat16,
                        generator=torch.Generator().manual_seed(SEED)).cuda()
    opt = GroupedOptimizer(OptimizerConfig(
        opt="adamw", betas=(0.9, 0.95), weight_decay=0.05, clip_grad=1.0))
    return model, opt


def _launch_counters():
    from mirage_tpu_torch.ops import block_attention as ba
    from mirage_tpu_torch.ops import flash_attention as fa
    from mirage_tpu_torch.ops import fused_adamw as fadam
    from mirage_tpu_torch.ops import fused_mlp as fm
    from mirage_tpu_torch.ops import runtime

    return {"attn_half_block": (ba.attn_half_block, "launches"),
            "attn_half_block_bwd": (ba.attn_half_block, "bwd_launches"),
            "attn_half_block_acc_bwd": (ba.attn_half_block,
                                        "acc_bwd_launches"),
            "mlp_block_acc_bwd": (fm.mlp_block, "acc_bwd_launches"),
            "fused_adamw": (fadam.fused_adamw, "launches"),
            "adamw_norm": (fadam.fused_adamw, "norm_launches"),
            "mlp_block": (fm.mlp_block, "launches"),
            "mlp_block_bwd": (fm.mlp_block, "bwd_launches"),
            "block_attention": (ba.block_attention, "launches"),
            "block_attention_bwd": (ba.block_attention, "bwd_launches"),
            "xattn_half_block": (ba.xattn_half_block, "launches"),
            "flash_attention": (fa.flash_attention, "launches"),
            "flash_attention_bwd": (fa.flash_attention, "bwd_launches"),
            # the bf16 backward kernel (csrc/attention_bwd.cuh) by its two
            # launchers: the packed qkv (B4, B6, B7-attention) and B8's
            "attention_bwd": (runtime.attention_bwd, "launches"),
            "flash_bwd": (runtime.flash_attention_bwd, "launches"),
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

    from mirage_tpu_torch.masking.masking import generate_random_masks
    from mirage_tpu_torch.ops import runtime
    from mirage_tpu_torch.train.steps import (init_train_state,
                                              make_pretrain_loss,
                                              make_train_step)

    counters = _launch_counters()

    def reset():
        for fn, attr in counters.values():
            setattr(fn, attr, 0)

    def read():
        return {k: getattr(fn, attr) for k, (fn, attr) in counters.items()}

    domains = TRAIN_DOMAINS
    t0 = time.perf_counter()
    model, opt = _train_model()
    loss_fn = make_pretrain_loss(model, TRAIN_DOMAIN_CONF,
                                 num_encoded_tokens=98, alphas=1.0)
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
    if one_pass != {**PER_STEP, **NO_OPT}:
        raise AssertionError(f"launches in one forward+backward {one_pass} "
                             f"!= {({**PER_STEP, **NO_OPT})}")
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
    want_on = {**PER_STEP_ON, **NO_OPT}
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
    log(f"[train] device kernels in one step: "
        f"{prof['kernels'] if prof else 'not measured'}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"[train] batch {b}: {dt * 1e3:.2f} ms/step, {b / dt:.1f} img/s, "
        f"peak memory {peak:.1f} GiB, on {card}")

    # the step with the switches on: B7 for both backwards; B11 over every
    # trainable leaf, as in the default step
    routed = sum(1 for p in state["params"].values() if p.requires_grad)
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
                "flash_bwd": 12, "attention_bwd": 0,
                "mlp_block_stash": 4, "mlp_block_stash_bwd": 4,
                "attn_half_block": 0, "attn_half_block_bwd": 0,
                "mlp_block": 0, "mlp_block_bwd": 0, "block_attention": 0,
                "block_attention_bwd": 0, "xattn_half_block": 0,
                "attn_half_block_acc_bwd": 0, "mlp_block_acc_bwd": 0,
                **OPT_STEP}
SEG_PER_EVAL = {**{k: 0 for k in SEG_PER_STEP}, "flash_attention": 12,
                "mlp_block": 16}
# the test split: volumes of slices named {scan}_{slice}, at a size that is
# not 1024² (the eval's nearest resize of the predictions runs)
SEG_TEST_VOLUMES, SEG_TEST_SLICES, SEG_TEST_HW = 2, 2, (496, 512)
SEG_CLASSES = 8
# the other heads' launches per train step and per eval forward: the
# encoder's (its MLP plain in training at drop-path 0.1, B2 in eval) and,
# for the Segmenter, two 768-wide blocks over 1024 + 8 tokens: B8 each,
# block 0's MLP (drop-path statically 0) B2 with B5's backward, block 1's
# (0.1) the plain MLP in training and B2 in eval
_SEG_ZERO = {k: 0 for k in SEG_PER_STEP}
_ENC_STEP = {**_SEG_ZERO, "flash_attention": 12, "flash_attention_bwd": 12,
             "flash_bwd": 12, **OPT_STEP}
_ENC_EVAL = {**_SEG_ZERO, "flash_attention": 12, "mlp_block": 12}
SEG_HEADS = {
    "linear": (_ENC_STEP, _ENC_EVAL),
    "segmenter": ({**_ENC_STEP, "flash_attention": 14,
                   "flash_attention_bwd": 14, "flash_bwd": 14,
                   "mlp_block": 1, "mlp_block_bwd": 1},
                  {**_ENC_EVAL, "flash_attention": 14, "mlp_block": 14}),
    "dpt": (_ENC_STEP, _ENC_EVAL)}


def _seg_dataset(root, rng, n_train=SEG_TRAIN, n_val=SEG_VAL, size=1024,
                 classes=SEG_CLASSES):
    """Seeded B-scans in [0, 1] and banded label maps (each image split
    into `classes` horizontal bands at random heights), as .npy in the
    folder layout of data/folder.py, and INFO.json (label 0 background);
    the test split's B-scans as .npy and its labels as PNGs at SEG_TEST_HW,
    named {scan}_{slice} for run_seg_eval's volumes."""
    import numpy as np
    from PIL import Image

    def sample(h, w):
        cuts = np.sort(rng.choice(np.arange(1, h), classes - 1,
                                  replace=False))
        lab = np.searchsorted(cuts, np.arange(h), side="right")
        lab = np.repeat(lab[:, None], w, axis=1).astype(np.uint8)
        img = 0.5 * rng.random((h, w), dtype=np.float32) \
            + lab.astype(np.float32) / (2 * classes)
        return img, lab

    for split, n in (("train", n_train), ("val", n_val), ("test", None)):
        for task in ("bscan", "semseg"):
            (root / split / task).mkdir(parents=True, exist_ok=True)
        if split == "test":
            for v in range(SEG_TEST_VOLUMES):
                for sl in range(SEG_TEST_SLICES):
                    img, lab = sample(*SEG_TEST_HW)
                    np.save(root / split / "bscan" / f"scan{v}_{sl}.npy", img)
                    Image.fromarray(lab).save(
                        root / split / "semseg" / f"scan{v}_{sl}.png")
            continue
        for i in range(n):
            img, lab = sample(size, size)
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
    random MIRAGE-Base weights; then --test on checkpoint-best (the test
    split's PNG export, exact launches), run_seg_eval on the export (the
    layers/lesions CSVs), --infer_only finding the export and skipping; the
    export against the LUT of the argmax of the same forward taken from the
    model, its logits against the plain path's; the bare train step:
    kernel step vs plain step, exact launch counts, ms/step and a profile;
    then --output_adapter linear, segmenter and dpt through the entry point
    (2 steps and a validation pass each, exact launches), and the
    Segmenter's step kernel vs plain with its launches per step and per
    eval forward."""
    import shutil

    import numpy as np
    import torch
    from PIL import Image

    from mirage_tpu_torch.api.wrapper import build_model as build_pretrain
    from mirage_tpu_torch.cli import run_seg_eval
    from mirage_tpu_torch.cli import run_seg_tuning as rst
    from mirage_tpu_torch.cli.config import parse_with_yaml
    from mirage_tpu_torch.data.augment import SemSegTransform
    from mirage_tpu_torch.data.folder import MultiTaskImageFolder
    from mirage_tpu_torch.ops import runtime
    from mirage_tpu_torch.train import checkpoint as ckpt
    from mirage_tpu_torch.train.steps import init_train_state, make_train_step

    counters = _launch_counters()

    def reset():
        for fn, attr in counters.values():
            setattr(fn, attr, 0)

    def read():
        return {k: getattr(fn, attr) for k, (fn, attr) in counters.items()}

    t0 = time.perf_counter()
    root = workdir / "seg"
    shutil.rmtree(root, ignore_errors=True)  # a finished run would skip
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

    # 1b. --test on checkpoint-best: one eval forward a batch of the test
    # split, a PNG a slice; run_seg_eval on them; --infer_only then skips
    run_dir = Path(out["output_dir"])
    n_test = SEG_TEST_VOLUMES * SEG_TEST_SLICES
    reset()
    t5 = time.perf_counter()
    test_stats = rst.main(argv + ["--test"])
    torch.cuda.synchronize()
    test_s = time.perf_counter() - t5
    test_counts = read()
    want_test = {k: -(-n_test // SEG_BATCH) * v
                 for k, v in SEG_PER_EVAL.items()}
    pngs = sorted(p.name for p in (run_dir / "preds").iterdir())
    log(f"[seg] --test: {test_stats} in {test_s:.1f}s; {len(pngs)} PNGs; "
        f"launches {test_counts}, expected {want_test}")
    if test_counts != want_test or pngs != sorted(
            f"scan{v}_{sl}.png" for v in range(SEG_TEST_VOLUMES)
            for sl in range(SEG_TEST_SLICES)):
        raise AssertionError(f"--test: launches {test_counts}, PNGs {pngs}")
    t6 = time.perf_counter()
    rows = run_seg_eval.main(["-d", str(root), "-m", str(run_dir)])
    eval_s = time.perf_counter() - t6
    csv_rows = sum(len(list(open(run_dir / f"results_{part}.csv"))) - 1
                   for part in ("layers", "lesions"))
    scores = [r[k] for r in rows for k in ("Dice", "IoU")]
    log(f"[seg] run_seg_eval in {eval_s:.1f}s: {csv_rows} CSV rows, mean "
        f"Dice {np.mean([r['Dice'] for r in rows]):.4f}, IoU "
        f"{np.mean([r['IoU'] for r in rows]):.4f}")
    if not (csv_rows == len(rows) == SEG_TEST_VOLUMES * (SEG_CLASSES - 1)
            and all(np.isfinite(v) and 0.0 <= v <= 1.0 for v in scores)):
        raise AssertionError(f"run_seg_eval: {csv_rows} CSV rows, {rows}")
    t7 = time.perf_counter()
    if rst.main(argv + ["--test", "--infer_only"]) is not None:
        raise AssertionError("--infer_only did not skip a finished export")
    skip_s = time.perf_counter() - t7

    # 2. the bare step, built as the entry point builds it
    args = rst.process_args(parse_with_yaml(rst.get_parser(), argv))
    _, model, opt, _, loss_fn = rst.setup(args, torch.device("cuda"))
    state = init_train_state(model, opt)
    step = make_train_step(loss_fn, opt)

    # the export against the same forward taken from the model (the best
    # checkpoint, the test split's one batch as the CLI's loader makes it),
    # its logits against the plain path's; the export's own time
    ckpt.load_best_checkpoint(args.output_dir, state)
    test_ds = MultiTaskImageFolder(str(data / "test"), args.all_domains,
                                   mapping=args.mapping,
                                   transform=SemSegTransform(False, 1024))
    items = [test_ds[i] for i in range(len(test_ds))]
    x = torch.from_numpy(np.stack([it[0]["bscan"] for it in items])).cuda()
    with torch.no_grad():
        logits_k = model.forward_light({"bscan": x})["semseg"].float()
        with runtime.plain_on_card():
            logits_p = model.forward_light({"bscan": x})["semseg"].float()
    logits_rel = ((logits_k - logits_p).norm() / logits_p.norm()).item()
    lut = np.zeros(args.num_classes, np.uint8)
    for idx, value in args.inverse_mapping.items():
        lut[idx] = value
    pred = lut[logits_k.argmax(1).cpu().numpy()]
    same = [np.array_equal(np.asarray(Image.open(
        run_dir / "preds" / f"{it[2]}.png")), p) for it, p in zip(items, pred)]
    export_dir = root / "export_timing"
    export_dir.mkdir()
    t8 = time.perf_counter()
    for it, p in zip(items, pred):
        Image.fromarray(p).save(export_dir / f"{it[2]}.png")
    export_s = time.perf_counter() - t8
    log(f"[seg] the export against the model's own forward: {same}; "
        f"logits against the plain path's rel-L2 {logits_rel:.3e} (bar "
        f"{MODEL_REL_L2}); wall s: test pass {test_s:.2f} (its {n_test} "
        f"PNGs written in {export_s:.3f}), run_seg_eval {eval_s:.2f}, the "
        f"--infer_only skip {skip_s:.2f}")
    if not all(same) or not logits_rel <= MODEL_REL_L2:
        raise AssertionError(f"exported PNGs {same}, logits rel-L2 "
                             f"{logits_rel}")
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
    del state, step, model, opt, loss_fn

    # 3. the other heads through the entry point: 2 steps and the
    # validation pass each
    t9 = time.perf_counter()
    heads = {}
    for head, (per_step, per_eval) in SEG_HEADS.items():
        hargv = argv + ["--output_adapter", head]
        reset()
        t = time.perf_counter()
        res = rst.main(hargv)
        torch.cuda.synchronize()
        counts = read()
        want = {k: steps * per_step[k] + evals * per_eval[k]
                for k in SEG_PER_STEP}
        heads[head] = {"seconds": time.perf_counter() - t, "counts": counts,
                       "loss": res["last_epoch"].get("train/loss"),
                       "val": {k: v for k, v in res["last_epoch"].items()
                               if k.startswith("val/")}}
        log(f"[seg] --output_adapter {head}: {heads[head]}, expected "
            f"launches {want}")
        if counts != want or not np.isfinite(heads[head]["loss"]):
            raise AssertionError(f"{head} head: launches {counts} != {want} "
                                 f"or loss {heads[head]['loss']}")

    # the Segmenter's blocks take the kernels: its step kernel vs plain,
    # and its launches per train step and per eval forward
    sargs = rst.process_args(parse_with_yaml(
        rst.get_parser(), argv + ["--output_adapter", "segmenter"]))
    _, smodel, sopt, _, sloss = rst.setup(sargs, torch.device("cuda"))
    sstate = init_train_state(smodel, sopt)
    snames = [n for n, p in sstate["params"].items() if p.requires_grad]
    shead = smodel.output_adapters["semseg"]

    def seg_loss_and_grads():
        loss, _ = sloss(batch, generator=rst.step_generator(SEED, 0, "cuda"))
        return loss.detach(), torch.autograd.grad(
            loss, [sstate["params"][n] for n in snames])

    def seg_agreement():
        """The kernel step against the plain step (bf16), and each against
        the plain step in float32."""
        runs = {"kernel": seg_loss_and_grads()}
        with runtime.plain_on_card():
            runs["plain"] = seg_loss_and_grads()
            smodel.compute_dtype = torch.float32
            runs["f32"] = seg_loss_and_grads()
            smodel.compute_dtype = torch.bfloat16
        return {f"{a} vs {b}": _agreement(*runs[a], *runs[b], snames)
                for a, b in (("kernel", "plain"), ("kernel", "f32"),
                             ("plain", "f32"))}

    # At the init's class embeddings (trunc-normal 0.02) a patch's class
    # scores differ by ~1e-3 and mask_norm's LN over them magnifies bf16
    # rounding: the plain bf16 step alone then misses float32 by more than
    # the bars. Reported, then held to the bars with the class embeddings
    # redrawn at the RMS of the projected patch tokens they are compared
    # with (the scale a trained head's class tokens take).
    seg_init = seg_agreement()
    with torch.no_grad():
        enc = smodel.encoder(smodel.process_input(
            {"bscan": batch["bscan"]})[0])
        rms = shead.proj_dec(enc[:, :-smodel.num_global_tokens].to(
            torch.float32)).pow(2).mean().sqrt().item()
        shead.cls_emb.normal_(0.0, rms, generator=torch.Generator(
            device="cuda").manual_seed(SEED))
    del enc
    seg_agree = seg_agreement()
    log(f"[seg] Segmenter head, one step (bf16, card, same drop-path "
        f"draws), at the init's class embeddings: {seg_init}; with them "
        f"at the projected tokens' RMS {rms:.4f}: {seg_agree}")
    kp = seg_agree["kernel vs plain"]
    if not (kp["loss_rel"] <= TRAIN_LOSS_REL
            and kp["worst_leaf_rel_l2"] <= TRAIN_LEAF_REL):
        raise AssertionError(f"Segmenter kernel step disagrees with the "
                             f"plain step: {kp}")
    sstep = make_train_step(sloss, sopt)
    reset()
    sstate, _ = sstep(sstate, batch, rst.step_generator(SEED, 1, "cuda"), lr)
    torch.cuda.synchronize()
    seg_step_counts = read()
    reset()
    with torch.no_grad():
        smodel.forward_light({"bscan": batch["bscan"]})
    torch.cuda.synchronize()
    seg_eval_counts = read()
    log(f"[seg] Segmenter launches a step {seg_step_counts}, an eval "
        f"forward {seg_eval_counts}; the heads' part of the phase "
        f"{time.perf_counter() - t9:.1f}s")
    if (seg_step_counts, seg_eval_counts) != SEG_HEADS["segmenter"]:
        raise AssertionError(f"Segmenter launches: step {seg_step_counts}, "
                             f"eval {seg_eval_counts}")
    del sstate, smodel, sopt, sloss, sstep
    return {"batch": b, "ms_per_step": dt * 1e3, "img_per_s": b / dt,
            "peak_gib": peak, "agreement": agree, "cli": out,
            "cli_seconds": cli_s, "cli_counts": cli_counts,
            "eval_counts": eval_counts, "step_counts": step_counts,
            "losses": losses, "profile": prof, "card": card,
            "test": {"stats": test_stats, "counts": test_counts,
                     "seconds": test_s, "export_seconds": export_s,
                     "eval_seconds": eval_s, "infer_only_skip_s": skip_s,
                     "logits_rel_l2": logits_rel, "csv_rows": csv_rows},
            "heads": heads, "segmenter_agreement": seg_agree,
            "segmenter_agreement_at_init": seg_init,
            "segmenter_counts": {"step": seg_step_counts,
                                 "eval": seg_eval_counts}}


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
                "mlp_block": 12, "mlp_block_bwd": 12, "attention_bwd": 12,
                **OPT_STEP}
CLS_PER_STEP_ON = {**CLS_PER_STEP, "mlp_block_bwd": 0,
                   "mlp_block_acc_bwd": 12, "fused_adamw": 1}
CLS_PER_EVAL = {**CLS_ZERO, "attn_half_block": 12, "mlp_block": 12}


def _cls_dataset(root, rng, shape=(496, 768)):
    """Seeded non-square uint8 images of ``shape`` (by default B-scans of
    496 × 768, the shape of a common OCT export; (H, W, 3) for RGB) in the
    class-folder layout, a per-class brightness offset so that the classes
    differ."""
    import numpy as np

    for split, n in CLS_SPLITS.items():
        for k, c in enumerate(CLS_CLASSES):
            d = root / split / c
            d.mkdir(parents=True, exist_ok=True)
            for i in range(n):
                img = rng.random(shape, dtype=np.float32) * 160 + 40 * k
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
    results = bare_cls_steps("cls", argv, [
        ("full fine-tune", [], {}, CLS_PER_STEP),
        ("full fine-tune, switches on", [], SWITCHES_ON, CLS_PER_STEP_ON),
        ("linear probe", ["--linear_probing"], {},
         {**CLS_ZERO, "attn_half_block": 12, "mlp_block": 12, **OPT_STEP})],
        reset, read, card)
    return {"batch": CLS_BATCH, "cli": dict(stats), "cli_seconds": cli_s,
            "cli_counts": cli_counts, "steps": results, "card": card}


def bare_cls_steps(tag, argv, ways, reset, read, card, batch_size=CLS_BATCH,
                   steps=CLS_STEPS):
    """The classification tuning step at ``batch_size``, built as
    run_cls_tuning's ``setup`` builds it from ``argv``, each of ``ways``
    ((way, extra flags, switches, launches a step)): one
    forward and backward against the plain path on the card (phase 5's
    bars) with exact launches, one step changing every trainable tensor (the
    head's alone under linear probing), then ``steps`` timed steps with
    exact launches, the peak memory and one step under torch.profiler. A
    way without switches builds its model; one with switches reuses the
    previous way's. Returns way -> results."""
    import numpy as np
    import torch

    from mirage_tpu_torch.cli import run_cls_tuning as rct
    from mirage_tpu_torch.cli.config import parse_with_yaml
    from mirage_tpu_torch.data.folder import ImageFolder
    from mirage_tpu_torch.ops import runtime
    from mirage_tpu_torch.ops.fused_adamw import fused_adamw
    from mirage_tpu_torch.train.steps import init_train_state, make_train_step

    ds = None
    results = {}
    for way, extra, switches, per_step in ways:
        if not switches:  # the switches-on way reuses the previous model
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
                     for i in range(batch_size)]
            batch = {"images": torch.from_numpy(np.stack(
                         [it[0] for it in items])).cuda(),
                     "targets": torch.tensor([it[1] for it in items]).cuda(),
                     "weights": torch.ones(batch_size, device="cuda")}
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
            log(f"[{tag}] {way}: one step, kernel path vs plain path (bf16, "
                f"card): {agree}")
            _check_agreement(f"{tag} {way}", agree)
            want_pass = {**per_step, **NO_OPT}
            if one_pass != want_pass:
                raise AssertionError(f"{tag} {way}: launches in one forward+"
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
            for _ in range(steps):
                state, m = step(state, batch, None, lr)
                metrics.append(m["loss"])
            torch.cuda.synchronize()
            dt = (time.perf_counter() - t2) / steps
            counts = read()
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            prof = profile_forward(lambda: step(state, batch, None, lr),
                                   top_n=20)
        losses = [v.item() for v in metrics]
        expected = {k: v * steps for k, v in per_step.items()}
        # B11 takes every trainable leaf
        leaves = fused_adamw.last_routed_count
        want_leaves = len(names)
        log(f"[{tag}] {way}: {steps} steps, launches {counts}, expected "
            f"{expected}; B11 leaves {leaves}, expected {want_leaves}; "
            f"losses {losses}; {dt * 1e3:.2f} ms/step, "
            f"{batch_size / dt:.1f} img/s, peak memory {peak:.2f} GiB, on "
            f"{card}; one step under torch.profiler: "
            f"{prof if prof else 'no device kernels seen (not measured)'}")
        if counts != expected or leaves != want_leaves \
                or not all(np.isfinite(losses)):
            raise AssertionError(f"{tag} {way}: launches {counts}, leaves "
                                 f"{leaves}, losses {losses}")
        if "--linear_probing" in extra and changed != ["head.bias",
                                                        "head.weight"]:
            raise AssertionError(f"{tag} linear probe changed {changed}")
        if "--linear_probing" not in extra and len(changed) != len(names):
            raise AssertionError(f"{tag} full fine-tune changed "
                                 f"{len(changed)} of {len(names)} trainable "
                                 f"tensors")
        results[way] = {"agreement": agree, "counts": counts,
                        "one_pass": one_pass, "b11_leaves": leaves,
                        "ms_per_step": dt * 1e3,
                        "img_per_s": batch_size / dt, "peak_gib": peak,
                        "losses": losses, "changed_tensors": len(changed),
                        "profile": prof}
    return results


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
    from mirage_tpu_torch.api.convert import (load_safetensors,
                                              load_torch_checkpoint,
                                              save_safetensors)
    from mirage_tpu_torch.api.wrapper import MIRAGEWrapper
    from mirage_tpu_torch.cli import hf_push, infer

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

    # cli/hf_push: push the weights (encoder only), load them back on the
    # card; the pushed tensors bit-equal to the checkpoint's, the features
    # bit-equal to hf.py's from the .pth
    push_dir = root / "MIRAGE-Large"
    t2 = time.perf_counter()
    hf_push.main(["-t", "push", "-s", "large", "--weights", str(path),
                  "--path", str(push_dir)])
    pushed = load_safetensors(str(push_dir / "model.safetensors"))
    source = {k: v for k, v in load_torch_checkpoint(str(path))["model"]
              .items() if "output_adapters" not in k}
    push_same = sorted(pushed) == sorted(source) and all(
        torch.equal(pushed[k], source[k]) for k in source)
    f_push = hf_push.main(["-t", "load", "-s", "large", "--path",
                           str(push_dir), "--device", "cuda"])
    zeros = np.zeros((1, 1, 512, 512), np.float32)
    f_src = hf.MIRAGEWrapper.from_pretrained(str(path), size="large")(
        {"bscan": zeros, "slo": zeros})
    torch.cuda.synchronize()
    push_s = time.perf_counter() - t2
    load_same = f_push.is_cuda and torch.equal(f_push, f_src)
    log(f"[infer] hf_push push + load in {push_s:.1f}s: {len(pushed)} "
        f"tensors bit-equal to the checkpoint's encoder {push_same}; load's "
        f"features {tuple(f_push.shape)} on {f_push.device} bit-equal to "
        f"hf.py's from the .pth {load_same}")
    if not (push_same and load_same
            and tuple(f_push.shape) == (1, 513, 1024)):
        raise AssertionError(f"hf_push: tensors equal {push_same}, features "
                             f"equal {load_same}")
    return {"cli_seconds": cli_s, "pngs": pngs, "features_max_abs": feat_err,
            "hf_vs_wrapper_max_abs": hf_err, "features_max": scale,
            "safetensors_bit_equal_to_pth": same, "load_seconds": load_s,
            "hf_push_seconds": push_s}


# ------------------------------------------------------------------ phase 9

BENCH_STEPS = 2  # timed steps of each train row, after one warm-up step
# the bench's A/B ops of S1, S3, S4, S7: name -> (TPU kernel file:line,
# launcher -> kernel, wrapper, sources, the bench module that drives it)
BENCH_KERNELS = {
    "block_attention_chain": (
        "scripts/bench_attn2.py:21",
        "make_block :15 -> pallas_call :21 over _block_attn_kernel",
        "mirage_tpu_torch/ops/block_attention.py", ["attention.cu"],
        "mirage_tpu_torch/bench/attn2.py"),
    "gemm_s8": (
        "scripts/bench_int8.py:64", "probe_pallas_int8 :48 -> kern :56",
        "mirage_tpu_torch/ops/quant.py", ["quant.cu"],
        "mirage_tpu_torch/bench/int8.py"),
    "mlp_block_lnfold": (
        "scripts/bench_lnfold.py:63",
        "mlp_lnfold :85 -> _mlp_lnfold_kernel :63",
        "mirage_tpu_torch/ops/fused_mlp.py",
        ["layernorm.cu", "gemm.cu", "gemm_lnfold.cu"],
        "mirage_tpu_torch/bench/lnfold.py"),
    "attn_half_block_prenormed": (
        "scripts/bench_lnfold.py:105",
        "attn_prenormed :140 -> _attn_prenormed_kernel :105",
        "mirage_tpu_torch/ops/block_attention.py",
        ["gemm.cu", "attention.cu"], "mirage_tpu_torch/bench/lnfold.py"),
    "attn_half_block_masked": (
        "scripts/bench_pad264.py:24",
        "make_attn :67 -> _attn_half_masked_kernel :24",
        "mirage_tpu_torch/ops/block_attention.py",
        ["layernorm.cu", "gemm.cu", "attention.cu"],
        "mirage_tpu_torch/bench/pad264.py"),
    "mlp_block_padded": (
        "scripts/bench_pad264.py:100",
        "make_mlp_flat :100, make_mlp_3d :125 -> _mlp_kernel",
        "mirage_tpu_torch/ops/fused_mlp.py", ["layernorm.cu", "gemm.cu"],
        "mirage_tpu_torch/bench/pad264.py"),
}
# S2, S5, S6: one entry of the `kernels` line per bench row (the rows of B1
# and B2 themselves excepted); op -> (wrapper, sources), bench module ->
# (its file, the TPU launcher -> kernel of each row's `replaces`)
BENCH_OPS = {
    "attn_half_block_phased": ("mirage_tpu_torch/ops/block_attention.py",
                               ["layernorm.cu", "gemm.cu",
                                "attention_phased.cu"]),
    "mlp_block_modes": ("mirage_tpu_torch/ops/fused_mlp.py",
                        ["layernorm.cu", "gemm.cu"]),
    "mlp_block_chunked": ("mirage_tpu_torch/ops/fused_mlp.py",
                          ["layernorm.cu", "mlp_chunked.cu"]),
}
BENCH_LAUNCHERS = {
    "scripts/bench_attn_half.py:16": "v2_call :54 -> _v2_kernel :16",
    "scripts/bench_vpu.py:44": "make_attn :215 -> _attn_kernel_v :44",
    "scripts/bench_vpu.py:88": "make_attn_pipe2 :140 -> _attn_kernel_pipe2 :88",
    "scripts/bench_vpu.py:167": "make_mlp_pipe2 :194 -> _mlp_kernel_pipe2 :167",
    "scripts/bench_vpu.py:240": "make_mlp :272 -> _mlp_kernel_v :240",
    "scripts/bench_overlap.py:32": "make_mlp :61 -> _mlp_kernel_chunked :32",
    "scripts/bench_overlap.py:90": "make_attn :133 -> _attn_half_grouped :90",
}
# the headline as PERF.md §5 records it before these kernels were added
HEADLINE_BEFORE = "2303.7-2322.1 img/s (NVIDIA H100 80GB HBM3, 700.00 W)"


def _bench_counters():
    from mirage_tpu_torch.ops import block_attention as ba
    from mirage_tpu_torch.ops import fused_mlp as fm
    from mirage_tpu_torch.ops import quant as q
    from mirage_tpu_torch.ops import runtime

    return {"attn_half_block": ba.attn_half_block,
            "attention_fwd": runtime.attention, "gemm": runtime.gemm,
            "mlp_block": fm.mlp_block,
            "xattn_half_block": ba.xattn_half_block,
            "block_attention": ba.block_attention,
            "gemm_s8": q.gemm_s8, "mlp_block_lnfold": fm.mlp_block_lnfold,
            "attn_half_block_prenormed": ba.attn_half_block_prenormed,
            "attn_half_block_masked": ba.attn_half_block_masked,
            "attn_half_block_phased": ba.attn_half_block_phased,
            "mlp_block_modes": fm.mlp_block_modes,
            "mlp_block_chunked": fm.mlp_block_chunked}


def phase_bench(card):
    """The port's bench (python -m mirage_tpu_torch.bench) through its entry
    points: the headline (bench.py's MIRAGE-Large reconstruction at batch
    512, seeded weights) with exact launch counts; the A/B
    cases S1, S3, S4, S7, S2, S5 and S6, each checked against its plain
    version and then timed; the five scripts/bench_train.py rows (one warm-up step and
    BENCH_STEPS timed steps each). Every launch counter is 0 before the
    bench runs and read after it; each op of the path must have launched."""
    import torch

    from mirage_tpu_torch.bench import __main__ as head
    from mirage_tpu_torch.bench import (attn2, attn_half, int8, lnfold,
                                        overlap, pad264, train, vpu)

    counters = _bench_counters()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    headline = head.headline()
    torch.cuda.empty_cache()
    counts = {k: fn.launches for k, fn in counters.items()}
    want = {k: v * (head.ITERS + 1) for k, v in PER_RECONSTRUCT.items()}
    log(json.dumps(headline))
    log(f"[bench] headline {headline['value']:.1f} img/s on {card}; before "
        f"the S2/S5/S6 kernels {HEADLINE_BEFORE}")
    log(f"[bench] headline launches {counts} (expected {want} over "
        f"{head.ITERS + 1} forwards)")
    if {k: counts[k] for k in want} != want:
        raise AssertionError(f"headline launches {counts} != {want}")
    cases = {}
    for name, mod in (("attn2", attn2), ("int8", int8), ("lnfold", lnfold),
                      ("pad264", pad264), ("attn_half", attn_half),
                      ("vpu", vpu), ("overlap", overlap)):
        t1 = time.perf_counter()
        cases[name] = mod.run()
        for row in cases[name]:
            log(f"[bench] {json.dumps(row)}")
        log(f"[bench] {name} in {time.perf_counter() - t1:.1f}s")
    sweep = overlap.rows_sweep()
    for row in sweep:
        log(f"[bench] {json.dumps(row)}")
    chunk_rows = [r for r in cases["overlap"] if r["op"] == "mlp_block_chunked"]
    b2_row = next(r for r in cases["overlap"] if r["case"].endswith("mlp/v0"))
    log("[bench] S6a R sweep (ms): " + ", ".join(
        f"R={r['rows_per_cluster']} {r['ms']:.4f} ({r['l2_bytes'] / 1e9:.2f} "
        f"GB from L2)" for r in sweep) + "; the op (R="
        f"{chunk_rows[0]['cluster'][1]}) at 2/4/8 chunks " + " / ".join(
            f"{r['ms']:.4f}" for r in chunk_rows) + f"; B2 {b2_row['ms']:.4f}, "
        f"library {chunk_rows[0]['library_ms']:.4f}")
    t1 = time.perf_counter()
    rows = train.run(steps=BENCH_STEPS)
    for row in rows:
        log(f"[bench] {json.dumps(row)}")
    log(f"[bench] train rows in {time.perf_counter() - t1:.1f}s")
    counts = {k: fn.launches for k, fn in counters.items()}
    log(f"[bench] launches over the whole bench {counts}")
    idle = [k for k, v in counts.items() if not v]
    if idle:
        raise AssertionError(f"bench: {idle} never launched")
    return {"headline": headline, "cases": cases, "train": rows,
            "s6a_rows_sweep": sweep, "counts": counts,
            "seconds": time.perf_counter() - t0, "card": card}


def _bench_entries(res):
    """Entries of the `kernels` line for the bench's A/B ops: per call (S1:
    per chain layer) at the JAX script's own shape, launches from the
    bench's run."""
    cases = res["cases"]
    pick = {
        "block_attention_chain": cases["attn2"][0],
        "gemm_s8": next(r for r in cases["int8"] if r["probe"]),
        "mlp_block_lnfold": cases["lnfold"][0],
        "attn_half_block_prenormed": cases["lnfold"][1],
        "attn_half_block_masked": next(
            r for r in cases["pad264"] if r["op"] == "attn_half_block_masked"),
        "mlp_block_padded": next(
            r for r in cases["pad264"] if r["op"] == "mlp_block"
            and r["shape"][1] != r["n_valid"]),
    }
    # B6 also runs in the train rows: the chain's launches are its own
    launches = {"block_attention_chain": pick["block_attention_chain"][
                    "launches"],
                "mlp_block_padded": sum(
                    r["launches"] for r in cases["pad264"]
                    if r["op"] == "mlp_block"
                    and r["shape"][1] != r["n_valid"])}
    entries = []
    for name, row in pick.items():
        replaces, tpu_kernel, source, csrc, module = BENCH_KERNELS[name]
        entries.append({
            "name": name, "route": "cuda", "source": source,
            "csrc": [CSRC + f for f in csrc], "bench": module,
            "replaces": replaces, "tpu_kernel": tpu_kernel,
            "launches": launches.get(name, res["counts"].get(name)),
            "launches_are": "the bench's timed calls (phase 9); the checks "
                            "against the plain versions excluded",
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "kernel_ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
            "library": row.get("library", "composite of F.layer_norm, "
                                          "F.linear, F.gelu, "
                                          "F.scaled_dot_product_attention"),
            "times_are": row.get("times_are", f"per call at {row['shape']}"),
            "row": row})
    for module in ("attn_half", "vpu", "overlap"):
        for row in cases[module]:
            if row["op"] not in BENCH_OPS:
                continue  # B1's and B2's own rows (S6's v0)
            source, csrc = BENCH_OPS[row["op"]]
            entries.append({
                "name": f"{row['op']} [{row['case']}]", "route": "cuda",
                "source": source, "csrc": [CSRC + f for f in csrc],
                "bench": f"mirage_tpu_torch/bench/{module}.py",
                "replaces": row["replaces"],
                "tpu_kernel": BENCH_LAUNCHERS[row["replaces"]],
                "launches": row["launches"],
                "launches_are": "the row's timed calls (phase 9); the check "
                                "against the plain version excluded",
                "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                "kernel_ms": row["ms"], "plain_ms": row["plain_ms"],
                "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
                "library_ms": row["library_ms"],
                "library": "composite of F.layer_norm, F.linear, F.gelu, "
                           "F.scaled_dot_product_attention",
                "times_are": f"per call at {row['shape']}", "row": row})
    return entries


# ----------------------------------------------------------------- phase 10

PRETRAIN_CONFIG = "configs/pretrain_mirage_98_1600e.yaml"
PRETRAIN_SAMPLES = 512  # two batches of 256: two steps an epoch
# the pixel-space loss against the token-space loss on one batch, bf16 on
# the card: the same bf16 predictions and float32 loss math, summed in
# another order (over pixels or over patches)
LOSS_SPACE_REL = 1e-3


def _pretrain_dataset(root, rng, n):
    """Seeded uint8 B-scans and SLOs at 512² and layer-map labels 0-12 at
    128², as .npy in the per-task folders of MultiTaskPretDatasetFolder."""
    import numpy as np

    for task, size, high in (("bscan", 512, 256), ("slo", 512, 256),
                             ("bscanlayermap", 128, 13)):
        (root / task).mkdir(parents=True, exist_ok=True)
        for i in range(n):
            np.save(root / task / f"s{i:04d}.npy",
                    rng.integers(0, high, (size, size), dtype=np.uint8))


# the library's bilinear output against its plain version (float32 sums in
# another order), and the share of nearest-warped label pixels that must
# agree (scipy rounds the .5 boundary its own way): tests/test_native.py's
# bars for the JAX package's library
SPLIT_ATOL = 1e-5
SPLIT_LABELS = 0.995


def host_line():
    """The host's CPU (its model name, or where the machine reports it as
    unknown its vendor, family and model numbers) and core count: the
    loader's numbers depend on them, not on the card."""
    import os

    info = {}
    for ln in Path("/proc/cpuinfo").read_text().splitlines():
        key, _, value = ln.partition(":")
        info.setdefault(key.strip(), value.strip())
    model = info.get("model name", "unknown")
    if model == "unknown":
        model = (f"{info.get('vendor_id', '?')} family "
                 f"{info.get('cpu family', '?')} model "
                 f"{info.get('model', '?')}")
    return f"{model}, os.cpu_count() {os.cpu_count()}"


def sample_split(ds, aug, n=16):
    """One sample's read and augmentation split into its stages (the read,
    the affine warp of each task, the resizes, the rest: flip, intensity
    shift, clip and the dtype conversion), ms on one thread, through the
    host library and through the plain versions (``resize_np_ref``,
    ``affine_warp_ref``) on the same n samples and seeds. The stages are
    timed by wrapping the module's ``affine_warp`` and ``resize_np`` around
    the real ``PretrainAugment`` call, after one warm-up sample of each
    path. Fails unless the two paths agree:
    images within SPLIT_ATOL, label maps at SPLIT_LABELS of their pixels."""
    import numpy as np

    from mirage_tpu_torch.data import augment as A

    impl = {"library": (A.affine_warp, A.resize_np),
            "plain": (A.affine_warp_ref, A.resize_np_ref)}
    saved = (A.affine_warp, A.resize_np)
    stages = {p: {} for p in impl}
    outs = {p: [] for p in impl}

    def timed(fn, calls):
        def wrapped(*a, **k):
            t = time.perf_counter()
            out = fn(*a, **k)
            calls.append(time.perf_counter() - t)
            return out
        return wrapped

    for path in impl:  # warm-up: imports, the library's build and load
        A.affine_warp, A.resize_np = impl[path]
        aug(ds.load_raw(0)[0], np.random.default_rng(0))
    try:
        for i in range(n):
            t = time.perf_counter()
            raw, _ = ds.load_raw(i)
            read_s = time.perf_counter() - t
            for path in impl:
                warps, resizes = [], []
                A.affine_warp = timed(impl[path][0], warps)
                A.resize_np = timed(impl[path][1], resizes)
                t = time.perf_counter()
                outs[path].append(aug({k: v.copy() for k, v in raw.items()},
                                      np.random.default_rng(i)))
                total = time.perf_counter() - t
                st = stages[path]
                st["read"] = st.get("read", 0.0) + read_s
                for task, w in zip(raw, warps):
                    st[f"warp {task}"] = st.get(f"warp {task}", 0.0) + w
                st["resize"] = st.get("resize", 0.0) + sum(resizes)
                st["rest"] = st.get("rest", 0.0) + total - sum(warps) \
                    - sum(resizes)
    finally:
        A.affine_warp, A.resize_np = saved
    ms = {p: {k: v / n * 1e3 for k, v in st.items()}
          for p, st in stages.items()}
    for p in ms:
        ms[p]["sample"] = sum(ms[p].values())
    err, same = 0.0, []
    for a, b in zip(outs["library"], outs["plain"]):
        for task in a:
            if np.issubdtype(a[task].dtype, np.integer):
                same.append(float((a[task] == b[task]).mean()))
            else:
                err = max(err, float(np.abs(a[task] - b[task]).max()))
    agree = {"max_abs": err, "labels_equal_min": min(same)}
    if not (err <= SPLIT_ATOL and min(same) >= SPLIT_LABELS):
        raise AssertionError(f"the host library against the plain "
                             f"augmentation: {agree} (bars {SPLIT_ATOL}, "
                             f"{SPLIT_LABELS})")
    return {"ms": ms, "agreement": agree, "samples": n, "host": host_line()}


def phase_pretrain(workdir, card, bare=None):
    """The pretraining entry point, run_pretraining.main, with
    configs/pretrain_mirage_98_1600e.yaml (ViT-B MultiMAE: 768 wide, 12
    layers, 12 heads; bscan and slo 512² at patch 32, the layer map 128² at
    patch 8; 98 visible tokens + 1 global; three 256/2/8 decoders; batch
    256, bf16, AdamW) on a seeded dataset of 512 samples, warm-started from
    a seeded ViT-B state dict with MAE's blocks.{i} keys: one epoch of two
    steps, then a second run that resumes at epoch 1. Exact launch counts a
    train step (the epoch-0 debug forward's read apart), finite losses, the
    warm start leaf for leaf, the pixel-space loss against the token-space
    loss on one loader batch, the wall time a step and the loader's share
    of it beside phase 5's bare step (``bare``), and the peak memory with
    and without --remat."""
    import shutil

    import numpy as np
    import torch

    from mirage_tpu_torch import hf
    from mirage_tpu_torch.api.convert import (load_torch_checkpoint,
                                              rename_keys)
    from mirage_tpu_torch.cli import hf_push
    from mirage_tpu_torch.cli import run_pretraining as rp
    from mirage_tpu_torch.cli.config import parse_with_yaml
    from mirage_tpu_torch.data.augment import PretrainAugment
    from mirage_tpu_torch.data.folder import MultiTaskPretDatasetFolder
    from mirage_tpu_torch.data.loader import DataLoader, to_device
    from mirage_tpu_torch.masking.masking import generate_random_masks
    from mirage_tpu_torch.losses.masked import (masked_ce_loss,
                                                masked_mse_loss)
    from mirage_tpu_torch.ops import runtime
    from mirage_tpu_torch.train.steps import (init_train_state,
                                              make_train_step, step_generator)

    counters = {**_launch_counters(),
                "layernorm": (runtime.layernorm, "launches"),
                "layernorm_bwd": (runtime.layernorm_bwd, "launches")}

    def reset():
        for fn, attr in counters.values():
            setattr(fn, attr, 0)

    def read():
        return {k: getattr(fn, attr) for k, (fn, attr) in counters.items()
                if k in PER_STEP or k in LN_OPS}

    def per_steps(n):
        want = {k: v * n for k, v in PER_STEP.items()}
        for name, ops in LN_OPS.items():
            want[name] = sum(want[op] for op in ops)
        return want

    root = workdir / "pretrain"
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    data, out = root / "data", root / "out"
    _pretrain_dataset(data, np.random.default_rng(SEED), PRETRAIN_SAMPLES)
    argv = ["-c", str(ROOT / PRETRAIN_CONFIG), "--data_path", str(data),
            "--output_dir", str(out), "--device", "cuda",
            "--num_workers", "8"]
    args = rp.process_args(parse_with_yaml(rp.get_parser(), argv))
    sd = rename_keys(rp.build_model(
        args, torch.Generator().manual_seed(SEED + 1)).state_dict(),
        {r"^encoder\.": "blocks."})
    weights = root / "vitb_seed1.pth"
    torch.save({"model": sd}, weights)
    del sd
    log(f"[pretrain] {PRETRAIN_SAMPLES} samples and ViT-B weights (seed "
        f"{SEED + 1}, blocks.{{i}} keys) in {time.perf_counter() - t0:.1f}s")

    # 1. the entry point: epoch 0 (two steps, the debug forward at step 0),
    # then a run to two epochs that resumes at epoch 1. The config's 40
    # warm-up epochs exceed a one-epoch schedule (train/schedules.py), so
    # one warm-up epoch here.
    cli_argv = argv + ["--weights", str(weights), "--max_steps_per_epoch",
                       "2", "--save_ckpt_freq", "1", "--log_freq", "1",
                       "--warmup_epochs", "1"]
    runs = {}
    for epochs in (1, 2):
        reset()
        t1 = time.perf_counter()
        res = rp.main(cli_argv + ["--epochs", str(epochs)])
        torch.cuda.synchronize()
        runs[epochs] = {"counts": read(), "seconds": time.perf_counter() - t1,
                        "log": res["log"], "step_s": res["step_s"],
                        "wait_s": res["wait_s"]}
        log(f"[pretrain] run_pretraining --epochs {epochs}: "
            f"{runs[epochs]}")
        del res
    rows = [json.loads(line) for line in open(out / "log.txt")]
    if [r["epoch"] for r in rows] != [0, 1] \
            or [r["epoch"] for r in runs[2]["log"]] != [1] \
            or not all((out / f"checkpoint-{e}").is_dir() for e in (0, 1)):
        raise AssertionError(f"resume: log.txt epochs "
                             f"{[r['epoch'] for r in rows]}, the second run "
                             f"{runs[2]['log']}")
    if not all(np.isfinite(v) for r in rows for v in r.values()):
        raise AssertionError(f"non-finite metrics in log.txt: {rows}")

    # cli/hf_push -t export of checkpoint-1 (the model rebuilt from its
    # meta.json), read by hf.py on the card: its float32 features against
    # the checkpoint's model's own (the port's kernels, float32)
    t5 = time.perf_counter()
    export = hf_push.main(["-t", "export", "--weights",
                           str(out / "checkpoint-1"),
                           "--path", str(root / "hf" / "model.safetensors")])
    export_s = time.perf_counter() - t5
    f32_args = rp.process_args(parse_with_yaml(
        rp.get_parser(), argv + ["--dtype", "float32"]))
    ck_model = rp.build_model(f32_args)
    ck_model.load_state_dict(torch.load(
        out / "checkpoint-1" / "checkpoint.pth", map_location="cpu",
        weights_only=False)["params"], strict=True)
    ck_model = ck_model.cuda()
    reader = hf.MIRAGEWrapper.from_pretrained(
        str(root / "hf"), size="base", modalities="bscan-slo",
        input_size=512, patch_size=32)
    xrng = np.random.default_rng(SEED + 5)
    x = {d: xrng.random((8, 1, 512, 512), dtype=np.float32)
         for d in ("bscan", "slo")}
    with torch.no_grad():
        want_f = ck_model.features({d: torch.from_numpy(v).cuda()
                                    for d, v in x.items()})
    got_f = reader(x)
    export_err = (got_f - want_f).abs().max().item()
    log(f"[pretrain] hf_push -t export of checkpoint-1 in {export_s:.1f}s "
        f"-> {export}; hf.py's batch-8 float32 features {tuple(got_f.shape)} "
        f"against the checkpoint's model's: max_abs {export_err:.3e} "
        f"(features up to {want_f.abs().max().item():.2f}; bar {HF_ATOL})")
    if not export_err <= HF_ATOL or got_f.shape != want_f.shape:
        raise AssertionError(f"hf_push export: features differ by "
                             f"{export_err}")
    del ck_model, reader, got_f, want_f

    # 2. the model, optimizer and loss as main builds them; the warm start
    args = rp.process_args(parse_with_yaml(rp.get_parser(), cli_argv))
    model, opt, loss_fn = rp.setup(args, torch.device("cuda"))
    pth = load_torch_checkpoint(str(weights))["model"]
    enc = {k: v for k, v in model.state_dict().items()
           if k.startswith("encoder.")}
    off = [k for k, v in enc.items()
           if not torch.equal(v.cpu(), pth["blocks." + k[len("encoder."):]])]
    if off or len(enc) != 12 * 12:
        raise AssertionError(f"warm start: {len(off)} of {len(enc)} encoder "
                             f"leaves differ from {weights.name}: {off[:4]}")
    del pth

    # one loader batch, as main makes it
    aug = PretrainAugment({d: args.input_size[d] for d in args.in_domains},
                          hflip=args.hflip,
                          intensity_shift=args.intensity_shift,
                          affine=args.affine)
    ds = MultiTaskPretDatasetFolder(str(data), args.in_domains, transform=aug)
    t2 = time.perf_counter()
    for i in range(16):
        ds[(i, np.random.default_rng(i))]
    sample_ms = (time.perf_counter() - t2) / 16 * 1e3
    # one sample's stages through the host library and the plain versions
    split = sample_split(ds, aug)
    log(f"[pretrain] one sample's read and augmentation by stage, ms on one "
        f"thread (library, then plain): {split}")
    # the 8-worker loader's rate over every sample, in batches of 32 so
    # that all 8 workers are busy: the interval of a 256-sample batch
    loader = DataLoader(ds, 32, num_workers=8, seed=SEED)
    t3 = time.perf_counter()
    for _ in loader:
        pass
    interval_s = (time.perf_counter() - t3) / len(ds) * args.batch_size
    loader = DataLoader(ds, args.batch_size, shuffle=True, drop_last=True,
                        num_workers=8, seed=SEED)
    t3 = time.perf_counter()
    batches = [bt for bt, _, _ in loader]
    epoch_s = time.perf_counter() - t3
    torch.cuda.synchronize()
    t4 = time.perf_counter()
    batch = to_device(batches[0], "cuda", args.in_domains)
    torch.cuda.synchronize()
    copy_ms = (time.perf_counter() - t4) * 1e3
    del batches

    # 3. the debug forward's launches (the first run's epoch 0 had one)
    reset()
    rp.debug_forward(model, batch, args, 0)
    torch.cuda.synchronize()
    debug = read()
    want = per_steps(2)
    got1 = {k: runs[1]["counts"][k] - debug[k] for k in want}
    log(f"[pretrain] launches: debug forward {debug}; run 1 less it "
        f"{got1}, run 2 {runs[2]['counts']}, expected {want} each")
    if got1 != want or runs[2]["counts"] != want:
        raise AssertionError(f"pretraining launches: run 1 less the debug "
                             f"forward {got1}, run 2 {runs[2]['counts']}, "
                             f"expected {want}")

    # 4. the pixel-space loss against the token-space loss
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    n_task = [args.grid_size[d][0] * args.grid_size[d][1]
              for d in args.in_domains]
    masks, _, _ = generate_random_masks(gen, n_task, args.batch_size,
                                        args.num_encoded_tokens)
    task_masks = dict(zip(args.in_domains, masks))
    with torch.no_grad():
        loss, tasks = rp.make_loss(model, args)(
            batch, task_masks=task_masks, num_visible=args.num_encoded_tokens)
        losses = {"token": {"loss": loss.item(),
                            **{k: v.item() for k, v in tasks.items()}}}
        # the same forward's reconstructions through the pixel-space forms
        preds, _ = model(batch, task_masks=task_masks,
                         num_visible=args.num_encoded_tokens,
                         deterministic=False, pixel_outputs=True)
        tasks = {}
        for task, pred in preds.items():
            patch = args.patch_size[task][0]
            if rp.DOMAIN_DEFAULTS[task]["loss"] == "ce":
                value = masked_ce_loss(pred, batch[task], task_masks[task],
                                       patch_size=patch)
            else:
                value = masked_mse_loss(
                    pred.float(), batch[task].float(), task_masks[task],
                    patch_size=patch, norm_pix=args.norm_pix_loss)
            tasks[task] = value.item()
        losses["pixel"] = {"loss": sum(tasks.values()), **tasks}
    rel = abs(losses["pixel"]["loss"] - losses["token"]["loss"]) / abs(
        losses["token"]["loss"])
    log(f"[pretrain] one loader batch, pixel-space {losses['pixel']} against "
        f"token-space {losses['token']} (bf16, card): relative {rel:.3e}")
    if not rel <= LOSS_SPACE_REL:
        raise AssertionError(f"pixel-space loss {losses['pixel']} against "
                             f"token-space {losses['token']}: relative "
                             f"{rel} > {LOSS_SPACE_REL}")

    # 5. peak memory of one step with --remat true and false, at the
    # config's drop-path 0 (the half-block ops) and at 0.1 (the blocks
    # checkpointed)
    state = init_train_state(model, opt)
    step = make_train_step(loss_fn, opt)
    memory = {}
    for rate in (0.0, 0.1):
        model.drop_path_rate = rate
        for remat in (True, False):
            model.encoder.remat = remat
            step(state, batch, step_generator(SEED, 0, "cuda"), 1e-4)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            step(state, batch, step_generator(SEED, 1, "cuda"), 1e-4)
            torch.cuda.synchronize()
            memory[f"drop_path {rate}, remat {remat}"] = {
                "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                "before_step_gib": base / 2 ** 30}
    log(f"[pretrain] peak memory of one step: {memory}, on {card}")

    walls = runs[1]["step_s"][1:] + runs[2]["step_s"][1:]
    waits = runs[1]["wait_s"][1:] + runs[2]["wait_s"][1:]
    firsts = [runs[e]["wait_s"][0] for e in (1, 2)]
    wall_ms = sum(walls) / len(walls) * 1e3
    ready_ms = (sum(walls) - sum(waits)) / len(walls) * 1e3
    timing = {"wall_ms_per_step": wall_ms, "ready_ms_per_step": ready_ms,
              "wait_share": sum(waits) / sum(walls),
              "wall_ms": [t * 1e3 for e in (1, 2)
                          for t in runs[e]["step_s"]],
              "wait_ms": [t * 1e3 for e in (1, 2)
                          for t in runs[e]["wait_s"]],
              "first_batch_wait_s": firsts, "sample_ms_one_thread": sample_ms,
              "sample_split": split, "batch_interval_s_8_workers": interval_s,
              "loader_epoch_s": epoch_s, "batch_copy_ms": copy_ms,
              "bare_step_ms": bare["ms_per_step"] if bare else None}
    log(f"[pretrain] the CLI's step: {wall_ms:.2f} ms (host clock, each "
        f"step ends at its synchronising metrics read; the steps after each "
        f"run's first), loader wait {timing['wait_share']:.1%} of it, "
        f"{ready_ms:.2f} ms without the wait (the batch's copy to the card "
        f"alone {copy_ms:.2f} ms); the "
        f"first step of each run waited {firsts} s; one sample's read and "
        f"augmentation {sample_ms:.1f} ms on one thread; the 8-worker "
        f"loader gives a batch of {args.batch_size} every {interval_s:.2f} "
        f"s; an epoch of "
        f"{PRETRAIN_SAMPLES // args.batch_size} batches from the 8-worker "
        f"loader {epoch_s:.2f} s; phase 5's bare step "
        f"{timing['bare_step_ms']} ms; on {card}")
    return {"runs": runs, "debug_counts": debug, "per_step": per_steps(1),
            "losses": losses, "loss_space_rel": rel, "memory": memory,
            "timing": timing, "export_max_abs": export_err, "card": card}


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
                **SERVE_KERNELS, **ATTN_BWD_KERNELS, **DEC_KERNELS}[name]
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
            **({"sdpa_bwd_ms": per_path_sum("sdpa_bwd_ms")}
               if all("sdpa_bwd_ms" in r for r in main_rows) else {}),
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


def _ln_entries(rows, pretrain):
    """The LN kernel's entries of the `kernels` line (forward and backward):
    times summed over one batch-256 pretraining step (per-call time × its
    launches at each shape), launches from the second pretraining run of
    phase 10 (two train steps, no debug forward)."""
    launches = pretrain["runs"][2]["counts"]
    entries = []
    for name, replaces, tpu_kernel in (
            ("layernorm", "mirage_tpu/ops/block_attention.py:251",
             "the LN prologue of _attn_half_kernel :251, _xattn_half_kernel "
             ":745 and fused_mlp.py:_mlp_kernel :58"),
            ("layernorm_bwd", "mirage_tpu/ops/block_attention.py:549",
             "the LN tail of _attn_half_bwd_dx_kernel :549 and fused_mlp.py:"
             "_mlp_bwd_dx_kernel :453")):
        step = [r for r in rows[name] if r["calls_per_step"]]
        total = lambda k: sum(r[k] * r["calls_per_step"] for r in step)  # noqa
        entries.append({
            "name": name, "route": "cuda",
            "source": "mirage_tpu_torch/csrc/layernorm.cu",
            "csrc": [CSRC + "layernorm.cu"], "replaces": replaces,
            "tpu_kernel": tpu_kernel, "launches": launches[name],
            "launches_per_step": pretrain["per_step"][name],
            "max_abs_err": max(r["max_abs_err"] for r in rows[name]),
            "ms": total("ms"), "kernel_ms": total("ms"),
            "plain_ms": total("plain_ms"), "bound_ms": total("bound_ms"),
            "bound_by": "bytes", "library_ms": total("library_ms"),
            "library": "F.layer_norm" + (" (its autograd backward alone)"
                                         if name == "layernorm_bwd" else ""),
            "times_are": f"sum over one batch-{TRAIN_BATCH} pretraining "
                         f"step; launches from two steps of "
                         f"run_pretraining (phase 10)",
            "shapes": rows[name]})
    return entries


# ----------------------------------------------------------------- phase 11

PARALLEL_LAYOUTS = ("dp", "fsdp", "tp", "tp_fsdp")
PARALLEL_STEPS = 3  # timed steps a layout, after the two compared ones
PARALLEL_LR = 1e-4
PARALLEL_TIMEOUT = 600  # seconds for a worker of (b) to join
# a tensor-parallel pretraining step: the encoder's blocks take
# Block.tp_forward (LN, the qkv product, B6 on H/t heads, the proj product;
# B2 and B5 with residual=False) in place of B1 / B4
PER_STEP_TP = {**PER_STEP, "attn_half_block": 0, "attn_half_block_bwd": 0,
               "block_attention": 18, "block_attention_bwd": 18}
# ops/linear.py's ops a step: the LN and the qkv and proj products of the
# 12 tensor-parallel blocks
DENSE_PER_STEP = {"linear": 0, "linear_bwd": 0, "layer_norm": 0,
                  "layer_norm_bwd": 0}
DENSE_PER_STEP_TP = {"linear": 24, "linear_bwd": 24, "layer_norm": 12,
                     "layer_norm_bwd": 12}
# the kernels of a step by their launchers' counts (reported, and each
# must launch)
RAW_COUNTERS = ("gemm", "attention", "attention_bwd", "mlp_bwd_hidden",
                "mlp_bwd_dyln", "layernorm", "layernorm_bwd")
# tensor-local shapes of the pretraining step (batch 256 × 99 tokens):
# (label, width, heads, t); the first is the one (b) runs
TP_SHAPES = [("ViT-B t=2", 768, 12, 2), ("ViT-B t=4", 768, 12, 4),
             ("ViT-L t=4", 1024, 16, 4), ("ViT-L t=8", 1024, 16, 8)]
TP_ROWS = TRAIN_BATCH * 99
# phase 11's `kernels` entries: name -> (TPU kernel file:line, the TPU
# kernels it serves on the tensor-parallel path, source, sources)
PARALLEL_KERNELS = {
    "gemm": ("mirage_tpu/ops/fused_mlp.py:58",
             "the products of _mlp_kernel :58 (fc1 at 4D/t columns, fc2 at "
             "4D/t rows) and, in place of XLA's, _tp_block_apply's qkv and "
             "proj (nn/block.py:191,207)", CSRC + "gemm_pingpong.cuh",
             ["gemm_pingpong.cuh", "gemm.cu"]),
    "attention_fwd": ("mirage_tpu/ops/block_attention.py:58",
                      "_block_attn_fwd :88 -> _block_attn_kernel :58 (B6) "
                      "on H/t heads", CSRC + "attention_fwd.cuh",
                      ["attention_fwd.cuh", "attention.cu"]),
    "attention_bwd": ("mirage_tpu/ops/block_attention.py:111",
                      "_block_attn_bwd :169 -> _block_attn_bwd_kernel :111 "
                      "(B6) on H/t heads", CSRC + "attention_bwd.cuh",
                      ["attention_bwd.cuh", "attention_bwd.cu"]),
    "mlp_bwd_hidden": ("mirage_tpu/ops/fused_mlp.py:453",
                       "the hidden stage of _mlp_bwd_dx_kernel :453 (B5) at "
                       "4D/t hidden", CSRC + "mlp_bwd.cu", ["mlp_bwd.cu"]),
    "mlp_bwd_dyln": ("mirage_tpu/ops/fused_mlp.py:453",
                     "dyln of _mlp_bwd_dx_kernel :453 (B5) at 4D/t hidden; "
                     "dx of the qkv and proj products", CSRC + "mlp_bwd.cu",
                     ["mlp_bwd.cu"]),
    "layernorm": ("mirage_tpu/ops/fused_mlp.py:58",
                  "the LN prologue of _mlp_kernel :58 and, in place of "
                  "XLA's, _tp_block_apply's norm1", CSRC + "layernorm.cu",
                  ["layernorm.cu"]),
    "layernorm_bwd": ("mirage_tpu/ops/fused_mlp.py:453",
                      "the LN tail of _mlp_bwd_dx_kernel :453 and, in place "
                      "of XLA's, _tp_block_apply's norm1 backward",
                      CSRC + "layernorm.cu", ["layernorm.cu"]),
}


def _parallel_counters():
    from mirage_tpu_torch.ops import linear as dense
    from mirage_tpu_torch.ops import runtime

    return {**_launch_counters(),
            "linear": (dense.linear, "launches"),
            "linear_bwd": (dense.linear, "bwd_launches"),
            "layer_norm": (dense.layer_norm, "launches"),
            "layer_norm_bwd": (dense.layer_norm, "bwd_launches"),
            "gemm": (runtime.gemm, "launches"),
            "attention": (runtime.attention, "launches"),
            "mlp_bwd_hidden": (runtime.mlp_bwd_hidden, "launches"),
            "mlp_bwd_dyln": (runtime.mlp_bwd_dyln, "launches"),
            "layernorm": (runtime.layernorm, "launches"),
            "layernorm_bwd": (runtime.layernorm_bwd, "launches")}


def _parallel_expected(layout):
    """The ops' launches a step in ``layout``."""
    tp = layout in ("tp", "tp_fsdp")
    return {**(PER_STEP_TP if tp else PER_STEP),
            **(DENSE_PER_STEP_TP if tp else DENSE_PER_STEP)}


def _parallel_batch():
    """Phase 5's inputs at batch 256 from a numpy seed, with one set of
    masks (98 visible tokens a sample) carried as batch leaves
    "mask_<task>", so they shard with the batch: numpy arrays."""
    import numpy as np
    import torch

    from mirage_tpu_torch.masking.masking import generate_random_masks

    b = TRAIN_BATCH
    rng = np.random.default_rng(SEED + 11)
    batch = {"bscan": rng.random((b, 1, 512, 512), dtype=np.float32),
             "slo": rng.random((b, 1, 512, 512), dtype=np.float32),
             "bscanlayermap": rng.integers(0, 13, (b, 128, 128))}
    masks, _, _ = generate_random_masks(
        torch.Generator().manual_seed(SEED + 11), [256, 256, 256], b, 98)
    for task, m in zip(TRAIN_DOMAINS, masks):
        batch[f"mask_{task}"] = m.numpy()
    return batch


def _masked_loss(model):
    """The pretraining loss with the masks of the batch."""
    from mirage_tpu_torch.train.steps import make_pretrain_loss

    base = make_pretrain_loss(model, TRAIN_DOMAIN_CONF,
                              num_encoded_tokens=98)

    def loss_fn(batch, generator=None):
        return base({t: batch[t] for t in TRAIN_DOMAINS}, generator,
                    task_masks={t: batch[f"mask_{t}"]
                                for t in TRAIN_DOMAINS}, num_visible=98)
    return loss_fn


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _timed_steps(step, state, batch, gen, counters, n):
    """``n`` steps after resetting the counters: (state, ms a step by the
    host clock after a synchronise, the device ms of each step by CUDA
    events, the counts, the last metrics)."""
    import torch

    for fn, attr in counters.values():
        setattr(fn, attr, 0)
    events = [torch.cuda.Event(enable_timing=True) for _ in range(n + 1)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    events[0].record()
    for i in range(n):
        state, m = step(state, batch, gen, PARALLEL_LR)
        events[i + 1].record()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / n * 1e3
    dev = [events[i].elapsed_time(events[i + 1]) for i in range(n)]
    counts = {k: getattr(fn, attr) for k, (fn, attr) in counters.items()}
    return state, ms, dev, counts, m


def _check_counts(what, counts, expected, steps):
    want = {k: v * steps for k, v in expected.items()}
    got = {k: counts[k] for k in want}
    if got != want:
        raise AssertionError(f"{what}: launches {got} != {want}")
    silent = [k for k in RAW_COUNTERS if not counts[k]]
    if silent:
        raise AssertionError(f"{what}: kernels launched no time: {silent}")


def _step_grads(state, names):
    """The gradients the sharded step left in .grad, whole (one process)."""
    from mirage_tpu_torch.train.optim import local

    return [local(state["params"][n].grad) for n in names]


def phase_parallel_one(workdir, card):
    """(a) One process, NCCL, world 1: phase 5's pretraining step (ViT-B,
    batch 256, bf16) with injected masks under dp (DDP), fsdp (FSDP2), tp
    (t = 1) and tp_fsdp (1 × 1), each from the same weights: its first
    step's loss, grad norm and every gradient, and its second step's loss,
    against the bare step's (make_train_step without a mesh) within phase
    5's bars; exact launch counts of each (the tp layouts through
    Block.tp_forward); ms a step beside the bare step's. Then the
    pretraining command line, one step with --distributed --num_processes
    1 on a seeded dataset of 256 samples. Returns the results and the bare
    step's reference (loss, norms, gradients) for (b)."""
    import shutil

    import numpy as np
    import torch
    import torch.distributed as dist

    from mirage_tpu_torch.cli import run_pretraining as rp
    from mirage_tpu_torch.parallel.mesh import init_distributed, make_mesh
    from mirage_tpu_torch.train.steps import (init_train_state,
                                              make_train_step, shard_state)

    counters = _parallel_counters()
    init_distributed("cuda", init_method=f"tcp://localhost:{_free_port()}",
                     world_size=1, rank=0)
    mesh = make_mesh({"data": 1}, "cuda")
    batch = {k: torch.from_numpy(v).cuda()
             for k, v in _parallel_batch().items()}
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    # the bare step: one forward and backward, then the steps
    model, opt = _train_model()
    loss_fn = _masked_loss(model)
    state = init_train_state(model, opt)
    names = [n for n, p in state["params"].items() if p.requires_grad]
    loss0, _ = loss_fn(batch)
    grads0 = torch.autograd.grad(loss0, [state["params"][n] for n in names])
    loss0 = loss0.detach()
    step = make_train_step(loss_fn, opt)
    ref = {"loss": [], "grad_norm": []}
    for _ in range(2):
        state, m = step(state, batch, gen, PARALLEL_LR)
        ref["loss"].append(m["loss"].item())
        ref["grad_norm"].append(m["grad_norm"].item())
    state, ms, dev, counts, _ = _timed_steps(step, state, batch, gen,
                                             counters, PARALLEL_STEPS)
    _check_counts("bare step", counts, _parallel_expected("dp"),
                  PARALLEL_STEPS)
    out = {"bare": {**ref, "ms_per_step": ms, "device_ms": dev,
                    "counts": counts}}
    log(f"[parallel] bare step: losses {ref['loss']}, grad norms "
        f"{ref['grad_norm']}, {ms:.2f} ms a step, launches {counts}")
    del model, state, step, loss_fn
    torch.cuda.empty_cache()

    for layout in PARALLEL_LAYOUTS:
        model, opt = _train_model()
        loss_fn = _masked_loss(model)
        state = shard_state(init_train_state(model, opt), mesh, model,
                            tp_num_heads=model.num_heads, layout=layout)
        step = make_train_step(loss_fn, opt, mesh=mesh)
        state, m1 = step(state, batch, gen, PARALLEL_LR)
        agree = _agreement(m1["loss"], _step_grads(state, names), loss0,
                           grads0, names)
        state, m2 = step(state, batch, gen, PARALLEL_LR)
        agree["step2_loss"], agree["bare_step2_loss"] = (
            m2["loss"].item(), ref["loss"][1])
        agree["step2_loss_rel"] = abs(m2["loss"].item() - ref["loss"][1]) \
            / abs(ref["loss"][1])
        agree["grad_norm_step2"] = m2["grad_norm"].item()
        log(f"[parallel] {layout} (world 1): {agree}")
        _check_agreement(f"{layout} step (world 1)", agree)
        if agree["step2_loss_rel"] > TRAIN_LOSS_REL:
            raise AssertionError(f"{layout}: second step's loss {agree}")
        state, ms, dev, counts, m = _timed_steps(step, state, batch, gen,
                                                 counters, PARALLEL_STEPS)
        _check_counts(f"{layout} (world 1)", counts,
                      _parallel_expected(layout), PARALLEL_STEPS)
        if not np.isfinite(m["loss"].item()):
            raise AssertionError(f"{layout}: loss {m['loss'].item()}")
        out[layout] = {"agreement": agree, "ms_per_step": ms,
                       "device_ms": dev, "counts": counts,
                       "bare_ms_per_step": out["bare"]["ms_per_step"]}
        log(f"[parallel] {layout} (world 1): {ms:.2f} ms a step (bare "
            f"{out['bare']['ms_per_step']:.2f}), device ms {dev}, launches "
            f"{counts}, on {card}")
        del model, state, step, loss_fn
        torch.cuda.empty_cache()

    # the command line, one step in the group of one
    root = workdir / "parallel"
    shutil.rmtree(root, ignore_errors=True)
    _pretrain_dataset(root / "data", np.random.default_rng(SEED + 12),
                      TRAIN_BATCH)
    argv = ["-c", str(ROOT / PRETRAIN_CONFIG), "--data_path",
            str(root / "data"), "--output_dir", str(root / "out"),
            "--device", "cuda", "--num_workers", "8", "--distributed",
            "--num_processes", "1", "--process_id", "0", "--epochs", "1",
            "--warmup_epochs", "0", "--max_steps_per_epoch", "1",
            "--debug_images", "false", "--log_freq", "1"]
    for fn, attr in counters.values():
        setattr(fn, attr, 0)
    t0 = time.perf_counter()
    res = rp.main(argv)
    torch.cuda.synchronize()
    counts = {k: getattr(fn, attr) for k, (fn, attr) in counters.items()}
    cli = {"seconds": time.perf_counter() - t0, "counts": counts,
           "log": res["log"], "step_s": res["step_s"]}
    log(f"[parallel] run_pretraining --distributed --num_processes 1: {cli}")
    _check_counts("run_pretraining --distributed", counts,
                  _parallel_expected("dp"), 1)
    if res["state"]["layout"].kind != "dp" or not np.isfinite(
            res["log"][-1]["train_loss"]) or not (
            root / "out" / "checkpoint-0").is_dir():
        raise AssertionError(f"run_pretraining --distributed: {cli}")
    out["cli"] = cli
    del res
    dist.destroy_process_group()
    torch.cuda.empty_cache()
    ref["step1_loss"] = loss0.item()
    ref["grads"] = {n: g.float().cpu() for n, g in zip(names, grads0)}
    return out, ref


def _parallel_worker(rank, world, store, outdir):
    """A process of (b): gloo on cuda:0, the tp = 2 and dp = 2 steps from
    phase 5's weights at global batch 256 with the same masks; rank 0
    gathers the first step's gradients in the standard layout and holds
    them to (a)'s bare step."""
    import datetime
    import traceback

    outdir = Path(outdir)
    try:
        import torch
        import torch.distributed as dist

        sys.path.insert(0, str(ROOT))
        from mirage_tpu_torch.parallel.mesh import local_batch, make_mesh
        from mirage_tpu_torch.train.optim import local
        from mirage_tpu_torch.train.steps import (gather_leaf,
                                                  init_train_state,
                                                  make_train_step,
                                                  shard_state)

        torch.cuda.set_device(0)
        dist.init_process_group(
            "gloo", init_method=f"file://{store}", rank=rank,
            world_size=world,
            timeout=datetime.timedelta(seconds=PARALLEL_TIMEOUT))
        counters = _parallel_counters()
        ref = torch.load(outdir / "ref.pt") if rank == 0 else None
        whole = {k: torch.from_numpy(v).cuda()
                 for k, v in _parallel_batch().items()}
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        results = {}
        for layout, axes in (("tp", {"tensor": world}),
                             ("dp", {"data": world})):
            mesh = make_mesh(axes, "cpu")  # gloo: no device mesh on the card
            model, opt = _train_model()
            state = shard_state(init_train_state(model, opt), mesh, model,
                                tp_num_heads=model.num_heads, layout=layout)
            step = make_train_step(_masked_loss(model), opt, mesh=mesh)
            batch = local_batch(whole, mesh)
            names = [n for n, p in state["params"].items()
                     if p.requires_grad]
            state, m1 = step(state, batch, gen, PARALLEL_LR)
            lay = state["layout"]
            grads = [gather_leaf(local(state["params"][n].grad).float()
                                 .cpu(), n, lay, state["params"][n])
                     for n in names]
            res = {"loss": [m1["loss"].item()],
                   "grad_norm": [m1["grad_norm"].item()]}
            if rank == 0:
                res["agreement"] = _agreement(
                    m1["loss"].cpu(), grads, torch.tensor(ref["step1_loss"]),
                    [ref["grads"][n] for n in names], names)
            del grads
            state, m2 = step(state, batch, gen, PARALLEL_LR)
            res["loss"].append(m2["loss"].item())
            res["grad_norm"].append(m2["grad_norm"].item())
            state, ms, dev, counts, _ = _timed_steps(
                step, state, batch, gen, counters, PARALLEL_STEPS)
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            res.update({"ms_per_step": ms, "device_ms": dev,
                        "counts": counts, "local_batch": len(batch["bscan"]),
                        "peak_gib": peak})
            results[layout] = res
            del model, state, step, lay
            torch.cuda.empty_cache()
        torch.save(results, outdir / f"rank{rank}.pt")
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:
        (outdir / f"err{rank}").write_text(traceback.format_exc())
        raise


def phase_parallel_two(workdir, card, ref):
    """(b) Two processes on cuda:0 over gloo (it carries all-reduce and
    broadcast of CUDA tensors, and two NCCL ranks may not share a GPU; so
    tp = 2 and dp = 2 run here, and fsdp > 1 is held on the CPU): ViT-B at
    global batch 256, two steps from phase 5's weights with (a)'s masks;
    the first step's loss, grad norm and gradients (gathered, standard
    layout) and the second step's loss against (a)'s bare step within phase
    5's bars; exact launch counts; each rank's ms a step (two processes
    share the card: printed, not compared)."""
    import multiprocessing
    import shutil

    import torch

    outdir = workdir / "parallel2"
    shutil.rmtree(outdir, ignore_errors=True)
    outdir.mkdir(parents=True)
    torch.save(ref, outdir / "ref.pt")
    ctx = multiprocessing.get_context("spawn")
    world = 2
    procs = [ctx.Process(target=_parallel_worker,
                         args=(r, world, str(outdir / "store"), str(outdir)))
             for r in range(world)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(PARALLEL_TIMEOUT)
    finally:
        hung = [p for p in procs if p.is_alive()]
        for p in hung:
            p.kill()
            p.join(30)
    errs = [f.read_text() for f in sorted(outdir.glob("err*"))]
    codes = [p.exitcode for p in procs]
    if hung or errs or any(codes):
        raise AssertionError(f"(b) workers: exit codes {codes}, hung "
                             f"{len(hung)}\n" + "\n".join(errs))
    ranks = [torch.load(outdir / f"rank{r}.pt") for r in range(world)]
    out = {"seconds": time.perf_counter() - t0}
    for layout in ("tp", "dp"):
        r0 = ranks[0][layout]
        agree = dict(r0["agreement"])
        agree["step2_loss_rel"] = abs(r0["loss"][1] - ref["loss"][1]) \
            / abs(ref["loss"][1])
        by_rank = [r[layout] for r in ranks]
        log(f"[parallel] {layout} = 2 (two processes, gloo, cuda:0): "
            f"{agree}; ms a step by rank "
            f"{[r['ms_per_step'] for r in by_rank]}, device ms "
            f"{[r['device_ms'] for r in by_rank]}, launches {r0['counts']}, "
            f"on {card}")
        _check_agreement(f"{layout} = 2", agree)
        if agree["step2_loss_rel"] > TRAIN_LOSS_REL:
            raise AssertionError(f"{layout} = 2: second step's loss {agree}")
        for r, res in enumerate(ranks):
            _check_counts(f"{layout} = 2, rank {r}", res[layout]["counts"],
                          _parallel_expected(layout), PARALLEL_STEPS)
        out[layout] = {"agreement": agree,
                       "ranks": [res[layout] for res in ranks]}
    return out


def mlp_bwd_rows(cases):
    """csrc/mlp_bwd.cu's two products alone at ``cases`` ((label, (m, d,
    h), calls a step of the hidden stage, [(label, (m, h, d), out dtype,
    calls a step)] of dyln)), bf16: the hidden stage against its plain
    version in float32 from the same inputs (dh and db1 at BWD_REL_L2 /
    BWD_REL_MAX, act at the bf16 bars), dyln = dh · W1 against float32
    math; reruns bit for bit; timed beside the plain versions and (dyln)
    torch.matmul."""
    import torch

    from mirage_tpu_torch.ops import runtime
    from mirage_tpu_torch.ops.fused_mlp import mlp_bwd_hidden_ref

    gen = torch.Generator().manual_seed(SEED + 13)

    def rn(*s, scale=1.0):
        return (torch.randn(*s, generator=gen) * scale).to(
            torch.bfloat16).cuda()

    def check(what, got, want, rel_l2_bar, rel_max_bar):
        diff = got.float() - want
        err = {"max_abs": diff.abs().max().item(),
               "rel_l2": (diff.norm() / want.norm()).item(),
               "rel_max": (diff.abs().max() / want.abs().max()).item()}
        if not (bool(torch.isfinite(got).all())
                and err["rel_l2"] <= rel_l2_bar
                and err["rel_max"] <= rel_max_bar):
            raise AssertionError(f"{what}: kernel disagrees with its plain "
                                 f"version: {err}")
        return err

    hidden_rows, dyln_rows = [], []
    for label, (m, d, h), calls, dylns in cases:
        y, dy = rn(m, d), rn(m, d)
        w1, w2 = rn(h, d, scale=d ** -0.5), rn(d, h, scale=h ** -0.5)
        b1 = (torch.randn(h, generator=gen) * 0.02).cuda()
        got = runtime.mlp_bwd_hidden(y, dy, w1, b1, w2)
        again = runtime.mlp_bwd_hidden(y, dy, w1, b1, w2)
        torch.cuda.synchronize()
        if not all(torch.equal(a, c) for a, c in zip(got, again)):
            raise AssertionError(f"mlp_bwd_hidden {label}: a rerun differs")
        wdh, wact, wdb1 = mlp_bwd_hidden_ref(y.float(), dy.float(),
                                             w1.float(), b1, w2.float())
        errs = {"dh": check(f"mlp_bwd_hidden {label} dh", got[0], wdh,
                            BWD_REL_L2, BWD_REL_MAX),
                "act": check(f"mlp_bwd_hidden {label} act", got[1], wact,
                             BF16_REL_L2, BWD_REL_MAX),
                "db1": check(f"mlp_bwd_hidden {label} db1", got[2].sum(0),
                             wdb1, BWD_REL_L2, BWD_REL_MAX)}
        del got, again, wdh, wact, wdb1
        flops = 4 * m * d * h
        nbytes = 2 * (2 * m * d + 2 * h * d + 2 * m * h) + 4 * h \
            + 4 * -(-m // 16) * h
        bound_ms, bound_by = _bound((flops, nbytes))
        row = {"label": label, "shape": [m, d, h], "dtype": "bf16",
               "errors": errs, "max_abs_err": max(
                   e["max_abs"] for e in errs.values()),
               "rerun_bit_identical": True,
               "ms": cuda_ms(lambda: runtime.mlp_bwd_hidden(
                   y, dy, w1, b1, w2)),
               "plain_ms": cuda_ms(lambda: mlp_bwd_hidden_ref(
                   y, dy, w1, b1, w2), iters=5),
               "library_ms": None,
               "library": "none: no one PyTorch call computes the hidden "
                          "stage",
               "bound_ms": bound_ms, "bound_by": bound_by,
               "calls_per_step": calls}
        log(f"[parallel] mlp_bwd_hidden {label} ({m}, {d}, {h}): {errs}; "
            f"kernel {row['ms']:.4f} ms plain {row['plain_ms']:.4f} ms bound "
            f"{bound_ms:.4f} ms ({bound_by})")
        hidden_rows.append(row)
        del y, dy, w1, w2, b1
        for dlabel, (dm, dh_, dd), out_dtype, dcalls in dylns:
            g, w = rn(dm, dh_), rn(dh_, dd, scale=dh_ ** -0.5)
            got = runtime.mlp_bwd_dyln(g, w, out_dtype=out_dtype)
            again = runtime.mlp_bwd_dyln(g, w, out_dtype=out_dtype)
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                raise AssertionError(f"mlp_bwd_dyln {dlabel}: a rerun "
                                     f"differs")
            err = check(f"mlp_bwd_dyln {dlabel}", got, g.float() @ w.float(),
                        BWD_REL_L2, BWD_REL_MAX)
            del got, again
            out_bytes = 4 if out_dtype == torch.float32 else 2
            bound_ms, bound_by = _bound((2 * dm * dh_ * dd, 2 * dm * dh_
                                         + 2 * dh_ * dd + out_bytes * dm * dd))
            drow = {"label": dlabel, "shape": [dm, dh_, dd], "dtype": "bf16",
                    "out_dtype": str(out_dtype).split(".")[-1],
                    "errors": {"dyln": err}, "max_abs_err": err["max_abs"],
                    "rerun_bit_identical": True,
                    "ms": cuda_ms(lambda: runtime.mlp_bwd_dyln(
                        g, w, out_dtype=out_dtype)),
                    "plain_ms": cuda_ms(lambda: g.float() @ w.float(),
                                        iters=5),
                    "library_ms": cuda_ms(lambda: torch.matmul(g, w)),
                    "library": "torch.matmul in bf16",
                    "bound_ms": bound_ms, "bound_by": bound_by,
                    "calls_per_step": dcalls}
            log(f"[parallel] mlp_bwd_dyln {dlabel} ({dm}, {dh_}, {dd}): "
                f"{err}; kernel {drow['ms']:.4f} ms plain "
                f"{drow['plain_ms']:.4f} ms matmul {drow['library_ms']:.4f} "
                f"ms bound {bound_ms:.4f} ms ({bound_by})")
            dyln_rows.append(drow)
            del g, w
    return hidden_rows, dyln_rows


def phase_parallel_kernels():
    """(c) The kernels of the tensor-parallel step against their plain
    versions at the tensor-local shapes of TP_SHAPES (phase 2's bars): the
    GEMM (qkv 3·D/t columns with its bias, proj D/t columns in with no
    bias, fc1 4·D/t columns with GELU, fc2 4·D/t in with no bias), B6's
    attention forward and backward on H/t heads, and csrc/mlp_bwd.cu's
    hidden stage at 4·D/t and its dyln product (B5's, and dx of the qkv and
    proj products). ``calls_per_step``: the launches a ViT-B t = 2 step
    makes at that shape (the shape (b) runs); the other rows are checked
    and timed per call."""
    import torch

    gemm, fwd, bwd, mlp = [], [], [], []
    calls = {}
    for i, (label, d, heads, t) in enumerate(TP_SHAPES):
        per = 12 if i == 0 else 0
        m, hl = TP_ROWS, heads // t
        for name, shape, epi in (("qkv", (m, 3 * d // t, d), "bias"),
                                 ("proj", (m, d, d // t), "none"),
                                 ("fc1", (m, 4 * d // t, d), "gelu"),
                                 ("fc2", (m, d, 4 * d // t), "none")):
            gemm.append((f"{label} {name}", shape, epi, f"{per} / step"))
            calls[f"{label} {name}"] = per
        fwd.append((f"{label} B6", (TRAIN_BATCH, 99, 99, hl, 64), False,
                    "attention", per))
        bwd.append((f"{label} B6", (TRAIN_BATCH, 99, 99, hl, 64), False,
                    "attention_bwd", per))
        mlp.append((f"{label} B5", (m, d, 4 * d // t), per, [
            (f"{label} B5 dyln", (m, 4 * d // t, d), torch.float32, per),
            (f"{label} qkv dx", (m, 3 * d // t, d), torch.bfloat16, per),
            (f"{label} proj dx", (m, d, d // t), torch.bfloat16, per)]))
    rows = {"gemm": gemm_rows(gemm, calls, "calls_per_step"),
            "attention_fwd": attention_core_rows(
                "attention", {c[0]: c[4] for c in fwd}, fwd,
                "calls_per_step"),
            "attention_bwd": attention_bwd_core_rows(bwd)}
    rows["mlp_bwd_hidden"], rows["mlp_bwd_dyln"] = mlp_bwd_rows(mlp)
    return rows


def phase_parallel(workdir, card):
    one, ref = phase_parallel_one(workdir, card)
    two = phase_parallel_two(workdir, card, ref)
    del ref
    return {"world_1": one, "two_processes": two,
            "kernels": phase_parallel_kernels()}


def _parallel_entries(par, ln_rows):
    """Phase 11's entries of the `kernels` line: the kernels of the
    tensor-parallel step, times summed over one ViT-B t = 2 pretraining
    step's tensor-local calls (per-call time × calls at each shape; the
    other shapes checked and timed per call), launches from rank 0 of
    (b)'s tp = 2 run (PARALLEL_STEPS steps), the LN rows from phase 2 at
    the shapes the step runs them."""
    rows = dict(par["kernels"])
    tp_calls = {"layernorm": {"pretraining encoder": 36,
                              "pretraining decoders": 12},
                "layernorm_bwd": {"pretraining encoder": 24,
                                  "pretraining decoders": 6}}
    for name, calls in tp_calls.items():
        rows[name] = [dict(r, calls_per_step=calls.get(r["label"], 0))
                      for r in ln_rows[name]]
    counts = par["two_processes"]["tp"]["ranks"][0]["counts"]
    entries = []
    for name, (replaces, tpu_kernel, source, csrc) in \
            PARALLEL_KERNELS.items():
        rs = rows[name]
        main = [r for r in rs if r.get("calls_per_step")]

        def total(k):
            if any(r.get(k) is None for r in main):
                return None
            return sum(r[k] * r["calls_per_step"] for r in main)

        top = max(main, key=lambda r: r["bound_ms"] * r["calls_per_step"])
        launches = counts["attention" if name == "attention_fwd" else name]
        entries.append({
            "name": f"{name} [tensor-parallel]", "route": "cuda",
            "source": source, "csrc": [CSRC + f for f in csrc],
            "replaces": replaces, "tpu_kernel": tpu_kernel,
            "launches": launches,
            "launches_per_step": launches // PARALLEL_STEPS,
            "launches_are": f"rank 0 of the tp = 2 run (phase 11 (b)), "
                            f"{PARALLEL_STEPS} timed steps, the decoders' "
                            f"launches included",
            "max_abs_err": max(r["max_abs_err"] for r in rs),
            "ms": total("ms"), "kernel_ms": total("ms"),
            "plain_ms": total("plain_ms"), "bound_ms": total("bound_ms"),
            "bound_by": top["bound_by"], "library_ms": total("library_ms"),
            "library": top.get("library"),
            "times_are": "sum over the calls of one ViT-B t = 2 "
                         "pretraining step at the shapes listed; the "
                         "other rows are checked and timed per call",
            "shapes": rs})
    return entries


# ----------------------------------------------------------------- phase 12

PIPE_MICRO = 4  # M of the two-stage pipeline: ViT-B batch 256, 64 a microbatch
PIPE_STEPS = 3  # timed steps a run, after the two compared ones
PIPE_TIMEOUT = 600  # seconds for a worker of (a) to join
# the launches of a two-stage pipeline step on each rank: its 6 encoder
# blocks run B1/B4 and B2/B5 once a microbatch (6 x 4), the decoders (6 B2/B5
# blocks, 6 B6) replicated on both stages; one attention backward kernel in
# each B4 and B6 backward
PER_STEP_PP = {**PER_STEP, "attn_half_block": 24, "attn_half_block_bwd": 24,
               "mlp_block": 30, "mlp_block_bwd": 30, "attention_bwd": 30}
# the rows of a microbatch (64 or 32 samples of 99 tokens) at S = 2, M = 4
# and S = 4, M = 8
PIPE_ROWS = {"S=2 M=4": 64 * 99, "S=4 M=8": 32 * 99}
SERVE_MESH_BATCHES = (BATCH, 3, 1)
SERVE_MESH_REQUESTS = 16
# phase 12's `kernels` entries beside the ops' own tables: LN forward and
# backward
PIPE_LN = {"layernorm": ("mirage_tpu/ops/block_attention.py:251",
                         "the LN prologue of _attn_half_kernel :251 and "
                         "fused_mlp.py:_mlp_kernel :58"),
           "layernorm_bwd": ("mirage_tpu/ops/block_attention.py:549",
                             "the LN tail of _attn_half_bwd_dx_kernel :549 "
                             "and fused_mlp.py:_mlp_bwd_dx_kernel :453")}


def _pipe_model(remat=False):
    """Phase 5's model with the pipeline flag (M = PIPE_MICRO) and
    ``remat``."""
    model, opt = _train_model()
    model.encoder.remat = remat
    model.pp = ("pipe", PIPE_MICRO)
    return model, opt


def phase_pipeline_one(card):
    """(a) in one process: phase 5's bare step (batch 256, injected masks;
    the reference of (a)), then the pipeline flag on a mesh with pipe = 1
    (NCCL, world 1: the JAX package's degenerate one-stage view, here the
    data-parallel step), which must equal the bare step with the same
    launches. Returns its results and the bare step's reference."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from mirage_tpu_torch.parallel.mesh import init_distributed, make_mesh
    from mirage_tpu_torch.train.steps import (init_train_state,
                                              make_train_step, shard_state)

    counters = _parallel_counters()
    bare, ref, (loss0, grads0) = _bare_reference(card)
    out = {"bare": bare}
    names = ref["names"]
    batch = {k: torch.from_numpy(v).cuda()
             for k, v in _parallel_batch().items()}
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    init_distributed("cuda", init_method=f"tcp://localhost:{_free_port()}",
                     world_size=1, rank=0)
    mesh = make_mesh({"data": 1, "pipe": 1}, "cuda")
    model, opt = _pipe_model()
    loss_fn = _masked_loss(model)
    state = shard_state(init_train_state(model, opt), mesh, model)
    step = make_train_step(loss_fn, opt, mesh=mesh, pp=True)
    state, m1 = step(state, batch, gen, PARALLEL_LR)
    agree = _agreement(m1["loss"], _step_grads(state, names), loss0, grads0,
                       names)
    state, m2 = step(state, batch, gen, PARALLEL_LR)
    agree["step2_loss_rel"] = abs(m2["loss"].item() - ref["loss"][1]) \
        / abs(ref["loss"][1])
    _check_agreement("pipe = 1 step", agree)
    if agree["step2_loss_rel"] > TRAIN_LOSS_REL:
        raise AssertionError(f"pipe = 1: second step's loss {agree}")
    state, ms, dev, counts, m = _timed_steps(step, state, batch, gen,
                                             counters, PIPE_STEPS)
    _check_counts("pipe = 1", counts, _parallel_expected("dp"), PIPE_STEPS)
    if not np.isfinite(m["loss"].item()):
        raise AssertionError(f"pipe = 1: loss {m['loss'].item()}")
    out["pipe_1"] = {"layout": state["layout"].kind, "agreement": agree,
                     "ms_per_step": ms, "device_ms": dev, "counts": counts}
    log(f"[pipeline] pipe = 1 (world 1, layout {state['layout'].kind}): "
        f"{agree}; {ms:.2f} ms a step (bare {out['bare']['ms_per_step']:.2f})"
        f", launches {counts}, on {card}")
    del model, state, step, loss_fn, grads0
    dist.destroy_process_group()
    torch.cuda.empty_cache()
    return out, ref


def _bare_reference(card):
    """Phase 5's bare step (batch 256, (a)'s injected masks) on the current
    card: the first step's loss and gradients, two steps' losses and grad
    norms, then PIPE_STEPS timed steps with exact launches. Returns (its
    results, the reference the pipelines are held to (host tensors), the
    first step's loss and gradients on the card)."""
    import torch

    from mirage_tpu_torch.train.steps import init_train_state, make_train_step

    counters = _parallel_counters()
    batch = {k: torch.from_numpy(v).cuda()
             for k, v in _parallel_batch().items()}
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    model, opt = _train_model()
    loss_fn = _masked_loss(model)
    state = init_train_state(model, opt)
    names = [n for n, p in state["params"].items() if p.requires_grad]
    loss0, _ = loss_fn(batch)
    grads0 = torch.autograd.grad(loss0, [state["params"][n] for n in names])
    loss0 = loss0.detach()
    step = make_train_step(loss_fn, opt)
    ref = {"loss": [], "grad_norm": []}
    for _ in range(2):
        state, m = step(state, batch, gen, PARALLEL_LR)
        ref["loss"].append(m["loss"].item())
        ref["grad_norm"].append(m["grad_norm"].item())
    state, ms, dev, counts, _ = _timed_steps(step, state, batch, gen,
                                             counters, PIPE_STEPS)
    _check_counts("bare step", counts, _parallel_expected("dp"), PIPE_STEPS)
    bare = {**ref, "ms_per_step": ms, "device_ms": dev, "counts": counts}
    log(f"[pipeline] bare step: losses {ref['loss']}, grad norms "
        f"{ref['grad_norm']}, {ms:.2f} ms a step on {card}")
    del model, state, step, loss_fn
    torch.cuda.empty_cache()
    ref.update({"step1_loss": loss0.item(), "names": names,
                "grads": {n: g.float().cpu() for n, g in zip(names, grads0)}})
    return bare, ref, (loss0, grads0)


def _pipeline_worker(rank, world, store, outdir):
    """A process of (a): gloo on cuda:0, stage ``rank`` of a two-stage
    pipeline (M = PIPE_MICRO) over phase 5's weights and masks, plain and
    with remat; rank 0 gathers the first step's gradients in the standard
    layout and holds them to the bare step."""
    import datetime
    import traceback

    outdir = Path(outdir)
    try:
        import torch
        import torch.distributed as dist

        sys.path.insert(0, str(ROOT))
        from mirage_tpu_torch.parallel.mesh import make_mesh
        from mirage_tpu_torch.train.steps import (gather_pp,
                                                  init_train_state,
                                                  make_train_step,
                                                  shard_state)

        torch.cuda.set_device(0)
        dist.init_process_group(
            "gloo", init_method=f"file://{store}", rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=PIPE_TIMEOUT))
        counters = _parallel_counters()
        ref = torch.load(outdir / "ref.pt")
        batch = {k: torch.from_numpy(v).cuda()
                 for k, v in _parallel_batch().items()}
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        results = {}
        for remat in (False, True):
            mesh = make_mesh({"pipe": world}, "cpu")  # gloo: no device mesh
            model, opt = _pipe_model(remat)
            state = shard_state(init_train_state(model, opt), mesh, model)
            lay = state["layout"]
            step = make_train_step(_masked_loss(model), opt, mesh=mesh,
                                   pp=True)
            state, m1 = step(state, batch, gen, PARALLEL_LR)
            params = state["params"]
            parts = {n: (torch.zeros_like(p) if p.grad is None else p.grad)
                     .float() for n, p in params.items()}
            whole = gather_pp(parts, lay)
            del parts
            res = {"loss": [m1["loss"].item()],
                   "grad_norm": [m1["grad_norm"].item()],
                   "blocks": sorted({int(n.split(".")[1]) for n in params
                                     if n.startswith("encoder.")})}
            if rank == 0:
                res["agreement"] = _agreement(
                    m1["loss"].cpu(), [whole[n] for n in ref["names"]],
                    torch.tensor(ref["step1_loss"]),
                    [ref["grads"][n] for n in ref["names"]], ref["names"])
            del whole
            state, m2 = step(state, batch, gen, PARALLEL_LR)
            res["loss"].append(m2["loss"].item())
            res["grad_norm"].append(m2["grad_norm"].item())
            torch.cuda.reset_peak_memory_stats()
            state, ms, dev, counts, _ = _timed_steps(
                step, state, batch, gen, counters, PIPE_STEPS)
            res.update({"ms_per_step": ms, "device_ms": dev,
                        "counts": counts,
                        "peak_gib": torch.cuda.max_memory_allocated()
                        / 2 ** 30})
            results["remat" if remat else "plain"] = res
            del model, state, step, lay, params
            torch.cuda.empty_cache()
        torch.save(results, outdir / f"rank{rank}.pt")
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:
        (outdir / f"err{rank}").write_text(traceback.format_exc())
        raise


def phase_pipeline_two(workdir, card, ref):
    """(a) on two processes: cuda:0 shared over gloo (two NCCL ranks may
    not share a card), pipe = 2, M = PIPE_MICRO, ViT-B at batch 256 from
    phase 5's weights and (a)'s masks, plain and with remat: the first
    step's loss, grad norm and every gradient (gathered to the standard
    layout) and the second step's loss against the bare step within phase
    5's bars, exact launches on each rank (PER_STEP_PP), each rank's ms a
    step (printed, not compared: the processes share the card)."""
    import multiprocessing
    import shutil

    import torch

    outdir = workdir / "pipeline2"
    shutil.rmtree(outdir, ignore_errors=True)
    outdir.mkdir(parents=True)
    torch.save(ref, outdir / "ref.pt")
    ctx = multiprocessing.get_context("spawn")
    world = 2
    procs = [ctx.Process(target=_pipeline_worker,
                         args=(r, world, str(outdir / "store"), str(outdir)))
             for r in range(world)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(PIPE_TIMEOUT)
    finally:
        hung = [p for p in procs if p.is_alive()]
        for p in hung:
            p.kill()
            p.join(30)
    errs = [f.read_text() for f in sorted(outdir.glob("err*"))]
    codes = [p.exitcode for p in procs]
    if hung or errs or any(codes):
        raise AssertionError(f"(a) workers: exit codes {codes}, hung "
                             f"{len(hung)}\n" + "\n".join(errs))
    ranks = [torch.load(outdir / f"rank{r}.pt") for r in range(world)]
    out = {"seconds": time.perf_counter() - t0}
    for run in ("plain", "remat"):
        r0 = ranks[0][run]
        agree = dict(r0["agreement"])
        agree["step2_loss_rel"] = abs(r0["loss"][1] - ref["loss"][1]) \
            / abs(ref["loss"][1])
        by_rank = [r[run] for r in ranks]
        log(f"[pipeline] pipe = 2, M = {PIPE_MICRO}, {run} (two processes, "
            f"gloo, cuda:0): {agree}; blocks by rank "
            f"{[r['blocks'] for r in by_rank]}; ms a step by rank "
            f"{[r['ms_per_step'] for r in by_rank]}, device ms "
            f"{[r['device_ms'] for r in by_rank]}, peak GiB "
            f"{[r['peak_gib'] for r in by_rank]}, launches "
            f"{r0['counts']}, on {card}")
        _check_agreement(f"pipe = 2 {run}", agree)
        if agree["step2_loss_rel"] > TRAIN_LOSS_REL:
            raise AssertionError(f"pipe = 2 {run}: second step's loss "
                                 f"{agree}")
        if [r["blocks"] for r in by_rank] != [list(range(6)),
                                               list(range(6, 12))]:
            raise AssertionError(f"pipe = 2 {run}: stages hold "
                                 f"{[r['blocks'] for r in by_rank]}")
        for r, res in enumerate(by_rank):
            _check_counts(f"pipe = 2 {run}, rank {r}", res["counts"],
                          {**PER_STEP_PP, **DENSE_PER_STEP}, PIPE_STEPS)
        out[run] = {"agreement": agree, "ranks": by_rank}
    return out


def phase_serve_mesh(workdir, card, path):
    """(b) The wrapper's mesh on cuda:0 (MIRAGE-Large, bf16, phase 4's
    weights): a mesh of one bit-equal to the plain wrapper at batch 64, 3
    and 1, for __call__ and features, with exact launches; two replicas on
    cuda:0 (two threads, two streams; the device list given, the card being
    single) within phase 4's bar of the plain wrapper, the largest
    difference, img/s beside one replica's, and how far the replicas'
    device time overlapped; then the server over the mesh of one answering
    HTTP requests, p50 / p95."""
    import numpy as np
    import torch

    from mirage_tpu_torch.api.wrapper import MIRAGEWrapper
    from mirage_tpu_torch.cli.serve import device_names, make_model_fns
    from mirage_tpu_torch.ops import runtime
    from mirage_tpu_torch.ops.block_attention import (attn_half_block,
                                                      xattn_half_block)
    from mirage_tpu_torch.ops.fused_mlp import mlp_block
    from mirage_tpu_torch.parallel.mesh import make_serve_mesh
    from mirage_tpu_torch.serve import MIRAGEServer, pow2_padded

    ops = {"attn_half_block": attn_half_block, "mlp_block": mlp_block,
           "xattn_half_block": xattn_half_block,
           "attention_fwd": runtime.attention, "gemm": runtime.gemm}

    def reset():
        for fn in ops.values():
            fn.launches = 0

    def read():
        return {name: fn.launches for name, fn in ops.items()}

    kw = dict(weights=str(path), compute_dtype=torch.bfloat16,
              device="cuda")
    plain = MIRAGEWrapper(**kw)
    one = MIRAGEWrapper(**kw, mesh={"data": 1})
    two = MIRAGEWrapper(**kw, mesh=make_serve_mesh(
        {"data": 2}, "cuda", devices=["cuda:0", "cuda:0"]))
    rng = np.random.default_rng(SEED + 20)
    out = {"bit_equal": {}}
    try:
        for b in SERVE_MESH_BATCHES:
            x = {"bscan": rng.random((b, 1, 512, 512), dtype=np.float32)}
            want = plain(x)
            reset()
            got = one(x)
            torch.cuda.synchronize()
            counts = read()
            exp = {k: PER_RECONSTRUCT[k] for k in ops}
            if counts != exp:
                raise AssertionError(f"mesh of one, batch {b}: launches "
                                     f"{counts} != {exp}")
            eq = all(torch.equal(got[t], want[t]) for t in want)
            feq = torch.equal(one.features(x), plain.features(x))
            out["bit_equal"][b] = {"call": eq, "features": feq}
            if not (eq and feq):
                raise AssertionError(f"mesh of one, batch {b}: not "
                                     f"bit-equal to the plain wrapper "
                                     f"(call {eq}, features {feq})")
        log(f"[pipeline] serving mesh of one on cuda:0: bit-equal to the "
            f"plain wrapper at batches {SERVE_MESH_BATCHES} (call and "
            f"features), launches {PER_RECONSTRUCT} a call")

        x = {"bscan": rng.random((BATCH, 1, 512, 512), dtype=np.float32)}
        want = plain(x)
        reset()
        got = two(x)
        torch.cuda.synchronize()
        counts = read()
        agree = {}
        for t in want:
            d = (got[t].float() - want[t].float())
            agree[t] = {"max_abs": d.abs().max().item(),
                        "rel_l2": (d.norm() / want[t].float().norm()).item()}
        exp = {k: 2 * PER_RECONSTRUCT[k] for k in ops}
        log(f"[pipeline] serving mesh, two replicas on cuda:0 (two threads, "
            f"two streams): against the plain wrapper {agree}; launches "
            f"{counts} (two replicas' forwards: {exp} expected)")
        bad = {t: a for t, a in agree.items()
               if not a["rel_l2"] <= MODEL_REL_L2}
        if bad or counts != exp:
            raise AssertionError(f"two replicas: {bad} above rel_l2 "
                                 f"{MODEL_REL_L2}, or launches {counts} != "
                                 f"{exp}")
        times = {}
        for name, w in (("plain", plain), ("two replicas", two),
                        ("plain", plain), ("two replicas", two)):
            for _ in range(2):
                w(x)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(5):
                w(x)
            torch.cuda.synchronize()
            times.setdefault(name, []).append(
                BATCH * 5 / (time.perf_counter() - t0))
        spans = two.device_spans()
        (s0, e0), (s1, e1) = spans
        union = max(e0, e1) - min(s0, s1)
        overlap = max(0.0, min(e0, e1) - max(s0, s1)) / union
        out["two_replicas"] = {"agreement": agree, "launches": counts,
                               "img_per_s": times, "device_spans_ms": spans,
                               "overlap": overlap, "card": card}
        log(f"[pipeline] batch {BATCH}: img/s plain wrapper "
            f"{times['plain']}, two replicas on one card "
            f"{times['two replicas']}; the replicas' device spans (ms) "
            f"{spans}: {overlap:.1%} of their union overlapped; on {card}")

        reconstruct, features = make_model_fns(one, one.in_domains)
        server = MIRAGEServer(
            reconstruct_fn=pow2_padded(reconstruct),
            features_fn=pow2_padded(features), max_batch=16,
            max_wait_ms=5, device=device_names(one), n_params=one.n_params,
            request_timeout_s=300)
        httpd = server.serve(host="127.0.0.1", port=0, background=True)
        url = f"http://127.0.0.1:{httpd.server_address[1]}"
        images = rng.random((SERVE_MESH_REQUESTS, 512, 512),
                            dtype=np.float32)
        try:
            with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
                health = json.loads(r.read())
            _post(url + "/v1/reconstruct", {"bscan": images[0]})  # warm
            lat = []
            for img in images:
                t0 = time.perf_counter()
                res = _post(url + "/v1/reconstruct", {"bscan": img})
                lat.append((time.perf_counter() - t0) * 1e3)
                if not all(np.isfinite(v).all() for v in res.values()):
                    raise AssertionError("non-finite answer")
        finally:
            server.close()
        p50, p95 = np.percentile(lat, [50, 95])
        if health["device"] != device_names(one):
            raise AssertionError(f"/healthz names {health['device']}")
        out["server"] = {"requests": len(lat), "p50_ms": float(p50),
                         "p95_ms": float(p95), "healthz": health,
                         "card": card}
        log(f"[pipeline] server over the mesh of one (/healthz device "
            f"{health['device']!r}): {len(lat)} sequential reconstruct "
            f"requests, p50 {p50:.2f} ms, p95 {p95:.2f} ms, on {card}")
    finally:
        one.close()
        two.close()
    del plain, one, two
    torch.cuda.empty_cache()
    return out


def phase_pipeline_kernels():
    """(c) The kernels at the new shapes against their plain versions
    (phase 2's bars): the GEMM's four ViT-B products at a microbatch of S =
    2, M = 4 (6336 rows) and S = 4, M = 8 (3168), the serving products at a
    replica's batch 32 of MIRAGE-Large (8224 rows); B1 and B2 and their
    backwards B4 and B5 at microbatches of 64 and 32; B1, B2 and B3 at a
    replica's batch 32; the LN forward and backward at (6336, 768).
    ``calls_per_step``: the launches of one rank's step of (a) at that
    shape; ``calls_per_forward``: one replica's reconstruct forward."""
    import torch

    gemm, fwd, bwd = [], [], []
    for i, (label, m) in enumerate(PIPE_ROWS.items()):
        per = 24 if i == 0 else 0
        for name, shape, epi in (("qkv", (m, 2304, 768), "bias"),
                                 ("proj", (m, 768, 768), "res"),
                                 ("fc1", (m, 3072, 768), "gelu"),
                                 ("fc2", (m, 768, 3072), "res")):
            gemm.append((f"pipeline {label} {name}", shape, epi,
                         f"{per} / step"))
        b = m // 99
        fwd += [("attn_half_block", f"pipeline {label}", (b, 99, 768, 12),
                 {}, per),
                ("mlp_block", f"pipeline {label}", (b, 99, 768), {}, per)]
        bwd += [("attn_half_block_bwd", f"pipeline {label}",
                 (b, 99, 768, 12), {}, per),
                ("mlp_block_bwd", f"pipeline {label}", (b, 99, 768), {},
                 per)]
    rows = {"pipeline": {
        "gemm": gemm_rows(gemm, {g[0]: int(g[3].split()[0]) for g in gemm},
                          "calls_per_step"),
        **fwd_op_rows(fwd, torch.Generator().manual_seed(SEED + 21),
                      "calls_per_step")}}
    bwd_op_rows(bwd, torch.Generator().manual_seed(SEED + 22),
                rows["pipeline"])
    ln = layernorm_rows(
        [("pipeline S=2 M=4", (PIPE_ROWS["S=2 M=4"], 768), 0, 96)],
        [("pipeline S=2 M=4", (PIPE_ROWS["S=2 M=4"], 768), 48, 0)])
    rows["pipeline"].update(ln)
    m = 32 * 257
    serve_gemm = [(f"serving replica {name}", shape, epi, "24 / forward")
                  for name, shape, epi in (
                      ("qkv", (m, 3072, 1024), "bias"),
                      ("proj", (m, 1024, 1024), "res"),
                      ("fc1", (m, 4096, 1024), "gelu"),
                      ("fc2", (m, 1024, 4096), "res"))]
    rows["serving"] = {
        "gemm": gemm_rows(serve_gemm, {g[0]: 24 for g in serve_gemm}),
        **fwd_op_rows([
            ("attn_half_block", "serving replica encoder",
             (32, 257, 1024, 16), {}, 24),
            ("attn_half_block", "serving replica decoder",
             (32, 256, 256, 8), {}, 6),
            ("mlp_block", "serving replica encoder", (32, 257, 1024), {},
             24),
            ("mlp_block", "serving replica decoder", (32, 256, 256), {}, 9),
            ("xattn_half_block", "serving replica decoder residual=False",
             (32, 256, 257, 256, 8), {"residual": False}, 3)],
            torch.Generator().manual_seed(SEED + 23))}
    return rows


def phase_pipeline(workdir, card):
    one, ref = phase_pipeline_one(card)
    two = phase_pipeline_two(workdir, card, ref)
    del ref
    serve = phase_serve_mesh(workdir, card, _large_weights(workdir))
    return {"world_1": one, "two_processes": two,
            "serving_mesh": serve, "kernels": phase_pipeline_kernels()}


def _pipeline_entries(pipe):
    """Phase 12's entries of the `kernels` line: B1, B2, B4, B5 and the
    GEMM and LN at a pipeline stage's microbatch, times summed over one
    rank's step of (a) (per-call time × its launches at each shape),
    launches from rank 0 of (a)'s plain run; B1, B2, B3 and the GEMM at a
    serving replica's batch, times summed over one replica's forward,
    launches from the two-replica call of (b)."""
    counts = pipe["two_processes"]["plain"]["ranks"][0]["counts"]
    steps = f"rank 0 of phase 12 (a)'s pipe = 2 plain run, {PIPE_STEPS} " \
            f"timed steps (the replicated decoders' launches included)"
    rows = pipe["kernels"]["pipeline"]
    entries = _kernel_entries(
        {k: rows[k] for k in ("attn_half_block", "mlp_block",
                              "attn_half_block_bwd", "mlp_block_bwd",
                              "gemm")},
        counts, {k: counts[k] // PIPE_STEPS for k in counts}, "step",
        f"sum over one rank's step of a two-stage pipeline (ViT-B, batch "
        f"256, M = {PIPE_MICRO}) at the microbatch shapes; launches from "
        + steps)
    for name, (replaces, tpu_kernel) in PIPE_LN.items():
        main = [r for r in rows[name] if r["calls_per_step"]]
        total = lambda k: sum(r[k] * r["calls_per_step"] for r in main)  # noqa
        entries.append({
            "name": name, "route": "cuda",
            "source": CSRC + "layernorm.cu", "csrc": [CSRC + "layernorm.cu"],
            "replaces": replaces, "tpu_kernel": tpu_kernel,
            "launches": counts[name],
            "launches_per_step": counts[name] // PIPE_STEPS,
            "max_abs_err": max(r["max_abs_err"] for r in rows[name]),
            "ms": total("ms"), "kernel_ms": total("ms"),
            "plain_ms": total("plain_ms"), "bound_ms": total("bound_ms"),
            "bound_by": "bytes", "library_ms": total("library_ms"),
            "library": "F.layer_norm" + (" (its autograd backward alone)"
                                         if name == "layernorm_bwd" else ""),
            "times_are": "the encoder's LNs of one rank's step at the "
                         "microbatch shape; launches from " + steps,
            "shapes": rows[name]})
    for e in entries:
        e["name"] += " [pipeline]"
    serve = pipe["kernels"]["serving"]
    launches = pipe["serving_mesh"]["two_replicas"]["launches"]
    serve_entries = _kernel_entries(
        serve, launches, {k: v // 2 for k, v in launches.items()},
        "forward", "sum over one replica's batch-32 reconstruct forward "
        "(MIRAGE-Large, bf16); launches from the two-replica batch-64 call "
        "of phase 12 (b) (two forwards, checked equal to twice one "
        "forward's)")
    for e in serve_entries:
        e["name"] += " [serving mesh]"
    return entries + serve_entries

# ----------------------------------------------------------------- phase 13

VIT_BATCH_512 = 16  # the full fine-tune step at 512² (1025 tokens)
VIT_STEPS_512 = 3  # timed steps at 512², after the compared one
# the launches of the ViT-L/16 classifier (24 layers, 16 heads, 1024 wide)
# at 224² (197 tokens; 197 = 3·64 + 5, a key tail of 5 issued 8 wide): a
# full fine-tune step takes route (b) above 128 tokens (B6, the bf16
# attention backward in each B6 backward, B2 / B5) and B11 over every
# trainable leaf (a linear probe's step over the head's two), the
# switches-on step B7, the linear probe's grad-free encoder and every eval
# forward the
# fused halves B1 + B2 (MIRAGE_BLOCK_FUSE=all: B10 alone); at 512² (1025
# tokens, above 512) B8 forward and backward with B2 / B5
VIT_ZERO = {k: 0 for k in (*PER_STEP, "flash_attention",
                           "flash_attention_bwd")}
VIT_PER_STEP = {**VIT_ZERO, "block_attention": 24, "block_attention_bwd": 24,
                "mlp_block": 24, "mlp_block_bwd": 24, "attention_bwd": 24,
                **OPT_STEP}
VIT_PER_STEP_ON = {**VIT_PER_STEP, "mlp_block_bwd": 0,
                   "mlp_block_acc_bwd": 24, "fused_adamw": 1}
VIT_PER_EVAL = {**VIT_ZERO, "attn_half_block": 24, "mlp_block": 24}
VIT_PER_STEP_512 = {**VIT_ZERO, "flash_attention": 24,
                    "flash_attention_bwd": 24, "flash_bwd": 24,
                    "mlp_block": 24, "mlp_block_bwd": 24, **OPT_STEP}
VIT_PER_EVAL_512 = {**VIT_ZERO, "flash_attention": 24, "mlp_block": 24}
VIT_B_PER_EVAL = {**VIT_ZERO, "attn_half_block": 12, "mlp_block": 12}
VIT_PROBE_STEP = {**VIT_PER_EVAL, **OPT_STEP}


def _vit_eval(tag, model, x, want_counts, reset, read, card, switches=None):
    """One eval forward on the kernel path against the plain path on the
    card (MODEL_REL_L2) with exact launches (``fused_block``: B10's, read
    apart), then both timed."""
    import torch

    from mirage_tpu_torch.ops import runtime
    from mirage_tpu_torch.ops.fused_block import fused_block

    with torch.no_grad(), runtime.switched(switches or {}):
        reset()
        fused_before = fused_block.launches
        got = model(x)
        torch.cuda.synchronize()
        counts = {**read(), "fused_block": fused_block.launches
                  - fused_before}
        with runtime.plain_on_card():
            want = model(x)
        rel = ((got - want).norm() / want.norm()).item()
        ok = bool(torch.isfinite(got).all()) and rel <= MODEL_REL_L2
        del got, want
        ms = cuda_ms(lambda: model(x), iters=5, warmup=1)
        with runtime.plain_on_card():
            plain_ms = cuda_ms(lambda: model(x), iters=2, warmup=1,
                               repeats=1)
    log(f"[vit] {tag}: logits rel_l2 {rel:.3e} against the plain path (bar "
        f"{MODEL_REL_L2}); launches {counts}, expected {want_counts}; "
        f"{ms:.2f} ms a forward (plain {plain_ms:.2f}), on {card}")
    if not ok or counts != want_counts:
        raise AssertionError(f"vit {tag}: rel_l2 {rel}, launches {counts}")
    return {"rel_l2": rel, "counts": counts, "ms": ms, "plain_ms": plain_ms,
            "img_per_s": x.shape[0] / ms * 1e3}


def phase_vit(workdir, card):
    """The baseline ViT classifiers (models/vit.py) through run_cls_tuning
    at ViT-L/16 width (1024 wide, 24 layers, 16 heads; ImageNet-normalised
    RGB at 224² -> 197 tokens), from a seeded timm-keyed 224-grid checkpoint
    named vit_large (its 1000-class head replaced by a fresh 3-class one),
    on a seeded RGB class folder. (a) The entry point at batch 64: two
    full fine-tune steps, a validation pass and the test pass, then --eval
    and --save_predictions; the same as a linear probe; exact launches.
    (b) The bare step at batch 64 three ways (default switches, the
    switches on, the linear probe) against the plain step (phase 7's
    ``bare_cls_steps``); the eval forward under MIRAGE_BLOCK_FUSE=off and
    all (B10) against the plain path. (c) At 512² from the 224-grid
    checkpoint (pos_embed resized to 32²; 1025 tokens): the eval forward at
    batch 64 and the full fine-tune step at batch 16, both through B8,
    against the plain path, with exact launches, ms a step, peak memory and
    a profile. (d) B1, B2, B6 forward and backward, B5 and B10 at (64, 197,
    1024) and B8 at 1025 tokens against their plain versions (phase 2's
    bars), timed beside the library and the bound. (e) The ViT-B/16 eval
    forward at batch 64 against the plain path."""
    import shutil

    import numpy as np
    import torch

    from mirage_tpu_torch.api.convert import interpolate_vit_pos_embed
    from mirage_tpu_torch.api.fm_configs import ViTBaseClsFM, ViTLargeClsFM
    from mirage_tpu_torch.cli import run_cls_tuning as rct
    from mirage_tpu_torch.models.vit import vit_factory
    from mirage_tpu_torch.ops import runtime
    from mirage_tpu_torch.train.optim import GroupedOptimizer, OptimizerConfig
    from mirage_tpu_torch.train.steps import (init_train_state, make_cls_loss,
                                              make_train_step)

    counters = _launch_counters()

    def reset():
        for fn, attr in counters.values():
            setattr(fn, attr, 0)

    def read():
        return {k: getattr(fn, attr) for k, (fn, attr) in counters.items()
                if k in VIT_ZERO}

    def times(per, n):
        return {k: v * n for k, v in per.items()}

    t0 = time.perf_counter()
    root = workdir / "vit"
    shutil.rmtree(root, ignore_errors=True)
    _cls_dataset(root / "data" / "OCTID", np.random.default_rng(SEED),
                 (256, 320, 3))
    weights = root / "vit_large_patch16_224_seed0.pth"
    sd = vit_factory["vit_large_patch16"](
        num_classes=1000, device="cpu",
        generator=torch.Generator().manual_seed(SEED)).state_dict()
    torch.save(sd, weights)
    log(f"[vit] RGB class folder and timm-keyed ViT-L/16 weights (224 grid, "
        f"1000 classes, seed {SEED}) in {time.perf_counter() - t0:.1f}s")

    # (a) the entry point: fine-tune and linear probe, then --eval and
    # --save_predictions from each one's checkpoint-best
    argv = ["--data_root", str(root / "data"), "--data_set", "OCTID",
            "--weights", str(weights), "--device", "cuda", "--epochs", "1",
            "--batch_size", str(CLS_BATCH), "--max_steps_per_epoch", "2",
            "--output_dir", str(root / "out"), "--num_workers", "8",
            "--seed", str(SEED)]
    cli = {}
    runs = root / "out" / "v1" / str(SEED) / "OCTID"
    for way, extra, per_step, kind in (
            ("full fine-tune", [], VIT_PER_STEP, "finetune"),
            ("linear probe", ["--linear_probing"], VIT_PROBE_STEP,
             "linear")):
        reset()
        t1 = time.perf_counter()
        stats = rct.main(argv + extra)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t1
        counts = read()
        want = {k: 2 * per_step[k] + 2 * VIT_PER_EVAL[k] for k in VIT_ZERO}
        run = next(p for p in runs.iterdir()
                   if p.name.startswith(f"ViTLargeClsFM_{kind}_"))
        rows = (run / "train_eval.csv").read_text().splitlines()
        reset()
        again = rct.main(argv + extra + ["--eval"])
        eval_counts = read()
        reset()
        saved = rct.main(argv + extra + ["--save_predictions"])
        pred_counts = read()
        with np.load(run / "predictions.npz") as z:
            probs = z["prediction_list"]
        missing = [m for m in ("sklearn", "pandas", "jax", "mirage_tpu")
                   if m in sys.modules]
        log(f"[vit] run_cls_tuning {way} in {secs:.1f}s: {run.name}; test "
            f"stats {dict(stats)}; train_eval.csv {rows}; launches {counts}, "
            f"expected {want}; --eval bacc {again['bacc']}, launches "
            f"{eval_counts}; --save_predictions {probs.shape}, launches "
            f"{pred_counts}; imported of sklearn/pandas/jax/mirage_tpu: "
            f"{missing}")
        loss = float(rows[-1].split(",")[1])
        if not (np.isfinite(loss) and len(rows) == 2
                and (run / "checkpoint-best").is_dir()
                and len((run / "valid_eval.csv").read_text().splitlines())
                == 2 and (run / "test_eval.csv").is_file()) or missing:
            raise AssertionError(f"vit {way}: loss {loss}, outputs of {run}")
        if counts != want or eval_counts != VIT_PER_EVAL \
                or pred_counts != VIT_PER_EVAL:
            raise AssertionError(f"vit {way} launches: {counts}, --eval "
                                 f"{eval_counts}, --save_predictions "
                                 f"{pred_counts}")
        if again["bacc"] != stats["bacc"] or saved is not None \
                or probs.shape != (2 * len(CLS_CLASSES), 3) \
                or not np.allclose(probs.sum(1), 1, atol=1e-5):
            raise AssertionError(f"vit {way}: --eval {again}, predictions "
                                 f"{probs.shape}")
        cli[way] = {"seconds": secs, "stats": dict(stats), "counts": counts,
                    "eval": dict(again), "run": run.name}

    # (b) the bare step three ways, then the eval forward
    steps = bare_cls_steps("vit", argv, [
        ("full fine-tune", [], {}, VIT_PER_STEP),
        ("full fine-tune, switches on", [], SWITCHES_ON, VIT_PER_STEP_ON),
        ("linear probe", ["--linear_probing"], {}, VIT_PROBE_STEP)],
        reset, read, card)
    torch.cuda.empty_cache()
    fm = ViTLargeClsFM(linear_probing=False)
    gen = torch.Generator().manual_seed(SEED + 30)
    model = fm.build_model(num_classes=3, pool="global", weights=str(weights),
                           input_size=224, compute_dtype=torch.bfloat16,
                           device="cuda")
    x = torch.randn(CLS_BATCH, 3, 224, 224, generator=gen).cuda()
    evals = {"224 off": _vit_eval(
        "ViT-L eval at 224², batch 64", model, x,
        {**VIT_PER_EVAL, "fused_block": 0}, reset, read, card)}
    evals["224 all"] = _vit_eval(
        "ViT-L eval at 224², batch 64, MIRAGE_BLOCK_FUSE=all", model, x,
        {**VIT_ZERO, "fused_block": 24}, reset, read, card,
        {"MIRAGE_BLOCK_FUSE": "all"})
    del model, x

    # (c) 512² from the 224-grid checkpoint: 1025 tokens, B8
    model = fm.build_model(num_classes=3, pool="global", weights=str(weights),
                           input_size=512, compute_dtype=torch.bfloat16,
                           device="cuda")
    pos = torch.from_numpy(interpolate_vit_pos_embed(sd["pos_embed"], 32))
    if not torch.equal(model.pos_embed.detach().cpu(), pos):
        raise AssertionError("vit: pos_embed not resized to the 32² grid")
    del sd
    x = torch.randn(CLS_BATCH, 3, 512, 512, generator=gen).cuda()
    evals["512 off"] = _vit_eval(
        "ViT-L eval at 512² (1025 tokens), batch 64", model, x,
        {**VIT_PER_EVAL_512, "fused_block": 0}, reset, read, card)
    del x
    opt = GroupedOptimizer(OptimizerConfig(
        opt="adamw", betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-2))
    state = init_train_state(model, opt)
    loss_fn = make_cls_loss(model, 0.1)
    step = make_train_step(loss_fn, opt)
    batch = {"images": torch.randn(VIT_BATCH_512, 3, 512, 512,
                                   generator=gen).cuda(),
             "targets": torch.arange(VIT_BATCH_512).cuda() % 3,
             "weights": torch.ones(VIT_BATCH_512, device="cuda")}
    names = [n for n, p in state["params"].items() if p.requires_grad]

    def loss_and_grads():
        loss, _ = loss_fn(batch)
        return loss.detach(), torch.autograd.grad(
            loss, [state["params"][n] for n in names])

    reset()
    loss_k, grads_k = loss_and_grads()
    torch.cuda.synchronize()
    one_pass = read()
    with runtime.plain_on_card():
        loss_p, grads_p = loss_and_grads()
    agree = _agreement(loss_k, grads_k, loss_p, grads_p, names)
    del grads_k, grads_p
    torch.cuda.empty_cache()
    log(f"[vit] full fine-tune at 512², batch {VIT_BATCH_512}: kernel path "
        f"vs plain path (bf16, card): {agree}; launches {one_pass}")
    _check_agreement("vit 512²", agree)
    if one_pass != {**VIT_PER_STEP_512, **NO_OPT}:
        raise AssertionError(f"vit 512² launches {one_pass} != "
                             f"{({**VIT_PER_STEP_512, **NO_OPT})}")
    step(state, batch, None, 1e-5)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset()
    t2 = time.perf_counter()
    losses = []
    for _ in range(VIT_STEPS_512):
        state, m = step(state, batch, None, 1e-5)
        losses.append(m["loss"])
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t2) / VIT_STEPS_512
    counts = read()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    prof = profile_forward(lambda: step(state, batch, None, 1e-5), top_n=20)
    losses = [v.item() for v in losses]
    log(f"[vit] full fine-tune at 512², batch {VIT_BATCH_512}: "
        f"{VIT_STEPS_512} steps, launches {counts}; losses {losses}; "
        f"{dt * 1e3:.2f} ms/step, {VIT_BATCH_512 / dt:.1f} img/s, peak "
        f"memory {peak:.2f} GiB, on {card}; one step under torch.profiler: "
        f"{prof if prof else 'no device kernels seen (not measured)'}")
    if counts != times(VIT_PER_STEP_512, VIT_STEPS_512) \
            or not all(np.isfinite(losses)):
        raise AssertionError(f"vit 512² steps: launches {counts}, losses "
                             f"{losses}")
    step_512 = {"agreement": agree, "counts": counts, "one_pass": one_pass,
                "ms_per_step": dt * 1e3, "img_per_s": VIT_BATCH_512 / dt,
                "peak_gib": peak, "losses": losses, "profile": prof}
    del model, state, step, loss_fn, batch, opt
    torch.cuda.empty_cache()

    # (d) the kernels at the ViT-L shapes against their plain versions
    kgen = torch.Generator().manual_seed(SEED + 31)
    shape = (CLS_BATCH, 197, 1024, 16)
    eval_rows = fwd_op_rows([
        ("attn_half_block", "ViT-L 224²", shape, {}, 24),
        ("mlp_block", "ViT-L 224²", shape[:3], {}, 24)], kgen)
    step_rows = {"mlp_block": [dict(r, calls_per_step=24)
                               for r in eval_rows["mlp_block"]]}
    bwd_op_rows([("block_attention", "ViT-L 224²", shape, {}, 24),
                 ("block_attention_bwd", "ViT-L 224²", shape, {}, 24),
                 ("mlp_block_bwd", "ViT-L 224²", shape[:3], {}, 24)], kgen,
                step_rows)
    fused_rows = fused_block_rows([("ViT-L 224²", shape, 24)], kgen, {})
    flash_rows = flash_op_rows([
        ("ViT-L 512² step", (VIT_BATCH_512, 16, 1025, 64), 24)], kgen, {})

    # (e) the ViT-B/16 eval forward
    model = ViTBaseClsFM(linear_probing=False).build_model(
        num_classes=3, pool="cls", weights="", input_size=224,
        compute_dtype=torch.bfloat16, device="cuda")
    x = torch.randn(CLS_BATCH, 3, 224, 224, generator=gen).cuda()
    evals["ViT-B 224 off"] = _vit_eval(
        "ViT-B/16 eval at 224², batch 64", model, x,
        {**VIT_B_PER_EVAL, "fused_block": 0}, reset, read, card)
    del model, x
    torch.cuda.empty_cache()
    return {"batch": CLS_BATCH, "cli": cli, "steps": steps, "evals": evals,
            "step_512": step_512, "card": card,
            "kernels": {"eval": eval_rows, "step": step_rows,
                        "fused_block": fused_rows["fused_block"],
                        "flash": flash_rows}}


def _vit_entries(vit):
    """Phase 13's entries of the `kernels` line: B6 forward and backward,
    B2 and B5 of a ViT-L full fine-tune step at 197 tokens (launches from
    the bare step's timed steps), B1 and B2 of its eval forward (launches
    from the linear probe's, which runs the same forward), B10 under
    MIRAGE_BLOCK_FUSE=all and B8 forward and backward of the 512² step at
    batch 16; times summed over one such pass (per-call time × calls)."""
    rows = vit["kernels"]
    step_counts = vit["steps"]["full fine-tune"]["counts"]
    probe_counts = vit["steps"]["linear probe"]["counts"]
    entries = _kernel_entries(
        rows["step"], step_counts, VIT_PER_STEP, "step",
        f"sum over one batch-{CLS_BATCH} ViT-L/16 full fine-tune step at 197 "
        f"tokens; launches from {CLS_STEPS} such steps")
    entries += _kernel_entries(
        rows["eval"], probe_counts, VIT_PER_EVAL, "forward",
        f"sum over one batch-{CLS_BATCH} ViT-L/16 eval forward at 197 "
        f"tokens; launches from {CLS_STEPS} linear-probe steps (the same "
        f"grad-free forward)")
    entries += _kernel_entries(
        {"fused_block": rows["fused_block"]},
        {"fused_block": vit["evals"]["224 all"]["counts"]["fused_block"]},
        {"fused_block": 24}, "forward",
        f"sum over one batch-{CLS_BATCH} ViT-L/16 eval forward at 197 tokens "
        f"under MIRAGE_BLOCK_FUSE=all; launches from that forward")
    counts_512 = vit["step_512"]["counts"]
    entries += _kernel_entries(
        {k: rows["flash"][k] for k in ("flash_attention",
                                       "flash_attention_bwd")},
        counts_512, VIT_PER_STEP_512, "step",
        f"sum over one batch-{VIT_BATCH_512} ViT-L/16 full fine-tune step "
        f"at 512² (1025 tokens); launches from {VIT_STEPS_512} such steps")
    for e in entries:
        e["name"] += " [vit]"
    return entries


# ----------------------------------------------------------------- phase 14

# The decoders' tails as one task stack (MIRAGE_DEC_BATCH=on): the three
# decoders of the reconstruct forward and of the pretraining step (width
# 256, hidden 1024, 8 heads, 256 queries; B3's keys: a reconstruct
# forward's 257 visible tokens)
DEC_TASKS, DEC_DIM, DEC_HEADS, DEC_QUERIES, DEC_CONTEXT = 3, 256, 8, 256, 257
DEC_ABBA_ROUNDS = 8  # ABBA rounds a case (mirage_tpu_torch/bench/decbatch.py)
DEC_STEP_ITERS, DEC_FORWARD_ITERS = 3, 5  # calls a round
DEC_BLOCK_CONTEXTS = (257, 600)  # DecoderBlock's keys: B3's; B8's above 512
# the counters phase 14 reads: an op's or launcher's attribute -> the
# suffix of its name
_DEC_SUFFIX = {"launches": "", "task_launches": " [tasks]",
               "bwd_launches": "_bwd", "task_bwd_launches": "_bwd [tasks]",
               "acc_bwd_launches": "_acc_bwd",
               "task_acc_bwd_launches": "_acc_bwd [tasks]"}
# launches of one batch-64 MIRAGE-Large reconstruct forward (phase 4's):
# off, the 24 encoder blocks and three decoders of B3 + B2 and two blocks;
# on, the encoder's as before and each decoder op once over the task stack
# (the attention core: the encoder's 24 and one a decoder op over T·B rows)
DEC_PER_FORWARD = {
    "off": {"attn_half_block": 30, "xattn_half_block": 3, "mlp_block": 33,
            "layernorm": 69, "gemm": 135, "attention_fwd": 33},
    "on": {"attn_half_block": 24, "attn_half_block [tasks]": 2,
           "xattn_half_block [tasks]": 1, "mlp_block": 24,
           "mlp_block [tasks]": 3, "layernorm": 48, "layernorm [tasks]": 7,
           "gemm": 96, "gemm [tasks]": 13, "attention_fwd": 27}}
# launches of one batch-256 pretraining step's forward and backward (phase
# 5's, remat on: no block of it is rerun): the decoders' two blocks a task
# take B6 and B2/B5, their cross-attention and its MLP the plain path
DEC_PER_STEP = {
    "off": {"attn_half_block": 12, "attn_half_block_bwd": 12,
            "mlp_block": 18, "mlp_block_bwd": 18, "block_attention": 6,
            "block_attention_bwd": 6, "layernorm": 60, "layernorm_bwd": 30,
            "gemm": 72, "attention_fwd": 30, "attention_bwd": 18,
            "mlp_bwd_hidden": 18, "mlp_bwd_dyln": 42},
    "on": {"attn_half_block": 12, "attn_half_block_bwd": 12,
           "mlp_block": 12, "mlp_block [tasks]": 2, "mlp_block_bwd": 12,
           "mlp_block_bwd [tasks]": 2, "block_attention": 2,
           "block_attention_bwd": 2, "layernorm": 48, "layernorm [tasks]": 4,
           "layernorm_bwd": 24, "layernorm_bwd [tasks]": 2, "gemm": 60,
           "gemm [tasks]": 4, "attention_fwd": 26, "attention_bwd": 14,
           "mlp_bwd_hidden": 12, "mlp_bwd_hidden [tasks]": 2,
           "mlp_bwd_dyln": 36, "mlp_bwd_dyln [tasks]": 2}}
# the same step with MIRAGE_MLP_BWD=accumulate too: the MLP backwards as B7,
# the decoders' over the stack (csrc/wgrad.cu's task-strided kernels)
DEC_PER_STEP_ACC = {
    **{k: v for k, v in DEC_PER_STEP["on"].items()
       if not k.startswith("mlp_block_bwd")},
    "mlp_block_acc_bwd": 12, "mlp_block_acc_bwd [tasks]": 2,
    "weight_grad": 24, "weight_grad [tasks]": 4, "colsum": 24,
    "colsum [tasks]": 4}
# launches of one DecoderBlock forward and backward: B6 for its
# self-attention, B2/B5 for its MLP, B8 for the cross-attention at 512 keys
# or more (the plain path below)
_DEC_BLOCK = {"block_attention": 1, "block_attention_bwd": 1,
              "mlp_block": 1, "mlp_block_bwd": 1, "layernorm": 2,
              "layernorm_bwd": 1, "gemm": 2, "attention_fwd": 1,
              "attention_bwd": 1, "mlp_bwd_hidden": 1, "mlp_bwd_dyln": 1}
DEC_BLOCK_PER_CALL = {257: _DEC_BLOCK,
                      600: {**_DEC_BLOCK, "flash_attention": 1,
                            "flash_attention_bwd": 1}}
# the task-strided ops and kernels: name -> (TPU kernel file:line, the TPU
# kernel jax.vmap lifts, port source, CUDA sources)
DEC_KERNELS = {
    "attn_half_block [tasks]": (
        "mirage_tpu/ops/block_attention.py:251",
        "_attn_half_kernel :251 under jax.vmap (spatial_output.py:314)",
        "mirage_tpu_torch/ops/block_attention.py",
        ["layernorm.cu", "gemm.cu", "gemm_pingpong.cuh", "attention.cu"]),
    "xattn_half_block [tasks]": (
        "mirage_tpu/ops/block_attention.py:745",
        "_xattn_half_kernel :745 under jax.vmap (spatial_output.py:314)",
        "mirage_tpu_torch/ops/block_attention.py",
        ["layernorm.cu", "gemm.cu", "gemm_pingpong.cuh", "attention.cu"]),
    "mlp_block [tasks]": (
        "mirage_tpu/ops/fused_mlp.py:58",
        "_mlp_kernel :58 under jax.vmap (spatial_output.py:314)",
        "mirage_tpu_torch/ops/fused_mlp.py",
        ["layernorm.cu", "gemm.cu", "gemm_pingpong.cuh"]),
    "gemm [tasks]": (
        "mirage_tpu/ops/fused_mlp.py:58",
        "the products of _mlp_kernel :58, block_attention.py:"
        "_attn_half_kernel :251 and :_xattn_half_kernel :745 under jax.vmap",
        "mirage_tpu_torch/csrc/gemm.cu", ["gemm.cu", "gemm_pingpong.cuh"]),
    "layernorm [tasks]": (
        "mirage_tpu/ops/block_attention.py:251",
        "the LN prologue of _attn_half_kernel :251, _xattn_half_kernel :745 "
        "and fused_mlp.py:_mlp_kernel :58 under jax.vmap",
        "mirage_tpu_torch/csrc/layernorm.cu", ["layernorm.cu"]),
    "layernorm_bwd [tasks]": (
        "mirage_tpu/ops/fused_mlp.py:453",
        "the LN tail of fused_mlp.py:_mlp_bwd_dx_kernel :453 under jax.vmap",
        "mirage_tpu_torch/csrc/layernorm.cu", ["layernorm.cu"]),
    "mlp_block_bwd [tasks]": (
        "mirage_tpu/ops/fused_mlp.py:453",
        "_mlp_block_bwd_defused :469 -> _mlp_bwd_dx_kernel :453 under "
        "jax.vmap", "mirage_tpu_torch/ops/fused_mlp.py",
        ["layernorm.cu", "mlp_bwd.cu"]),
    "mlp_block_acc_bwd [tasks]": (
        "mirage_tpu/ops/fused_mlp.py:311",
        "_mlp_block_bwd_pallas :240 -> _mlp_bwd_kernel :311 under jax.vmap",
        "mirage_tpu_torch/ops/fused_mlp.py",
        ["layernorm.cu", "mlp_bwd.cu", "wgrad.cu"]),
}


def _dec_counters():
    """name -> (function, attribute) of every launch count phase 14 reads."""
    from mirage_tpu_torch.ops import block_attention as ba
    from mirage_tpu_torch.ops import flash_attention as fa
    from mirage_tpu_torch.ops import fused_mlp as fm
    from mirage_tpu_torch.ops import runtime

    out = {}
    for name, fn, attrs in (
            ("attn_half_block", ba.attn_half_block,
             ("launches", "task_launches", "bwd_launches")),
            ("xattn_half_block", ba.xattn_half_block,
             ("launches", "task_launches")),
            ("mlp_block", fm.mlp_block,
             ("launches", "task_launches", "bwd_launches",
              "task_bwd_launches", "acc_bwd_launches",
              "task_acc_bwd_launches")),
            ("block_attention", ba.block_attention,
             ("launches", "bwd_launches")),
            ("flash_attention", fa.flash_attention,
             ("launches", "bwd_launches")),
            ("attention_fwd", runtime.attention, ("launches",)),
            ("attention_bwd", runtime.attention_bwd, ("launches",)),
            *((n, getattr(runtime, n), ("launches", "task_launches"))
              for n in ("layernorm", "layernorm_bwd", "gemm",
                        "mlp_bwd_hidden", "mlp_bwd_dyln", "weight_grad",
                        "colsum"))):
        for attr in attrs:
            out[name + _DEC_SUFFIX[attr]] = (fn, attr)
    return out


def _dec_count(fn):
    """fn() with every phase-14 launch count at 0 first: (its value, the
    counts after a synchronise)."""
    import torch

    counters = _dec_counters()
    for f, attr in counters.values():
        setattr(f, attr, 0)
    out = fn()
    torch.cuda.synchronize()
    return out, {k: getattr(f, attr) for k, (f, attr) in counters.items()}


def _dec_check_counts(what, got, want):
    want = {k: want.get(k, 0) for k in got}
    if got != want:
        bad = {k: (got[k], want[k]) for k in got if got[k] != want[k]}
        raise AssertionError(f"{what}: launches (got, expected) {bad}")


def _dec_rn(gen, *shape, scale=1.0):
    import torch

    return (torch.randn(*shape, generator=gen) * scale).to(
        torch.bfloat16).cuda()


def _dec_stack(op, shape, gen):
    """An op's bf16 operands for DEC_TASKS tasks of per-task ``shape``:
    the activations (x; B3's context too) concatenated task-major, each
    weight stacked on a leading task axis, then the head count."""
    import torch

    sets = [_op_inputs(op, shape, torch.bfloat16, gen)
            for _ in range(DEC_TASKS)]
    acts = 2 if op == "xattn_half_block" else 1
    heads = [] if op == "mlp_block" else [sets[0][-1]]
    n_w = len(sets[0]) - acts - len(heads)
    return ([torch.cat([s[i] for s in sets]) for i in range(acts)]
            + [torch.stack([s[acts + i] for s in sets]).contiguous()
               for i in range(n_w)] + heads)


def _dec_tasks(fn, acts, args):
    """fn on each task's activation rows (the first ``acts`` of ``args``)
    and weights, the outputs concatenated (a tuple's second and later
    outputs, the weights' gradients, stacked): what DEC_TASKS separate
    calls compute."""
    import torch

    t = DEC_TASKS
    outs = [fn(*[a.chunk(t)[i].contiguous() for a in args[:acts]],
               *[w[i] if torch.is_tensor(w) else w for w in args[acts:]])
            for i in range(t)]
    if not isinstance(outs[0], tuple):
        return torch.cat(outs)
    return (torch.cat([o[0] for o in outs]),) + tuple(
        None if o[0] is None else torch.stack(o)
        for o in list(zip(*outs))[1:])


def _dec_library(op):
    """The task stack's function from PyTorch library calls over the stacked
    weights (F.layer_norm a task, torch.bmm / baddbmm, F.gelu,
    F.scaled_dot_product_attention over the T·B batch; a backward by
    torch.autograd.grad): a yardstick, never called by the port."""
    import torch
    import torch.nn.functional as F

    t = DEC_TASKS

    def ln(x, w, b):
        return torch.cat([F.layer_norm(xt, (x.shape[-1],), wt.to(x.dtype),
                                       bt.to(x.dtype), 1e-6)
                          for xt, wt, bt in zip(x.chunk(t), w, b)])

    def lin(x, w, b=None):
        xt = x.reshape(t, -1, x.shape[-1])
        y = (torch.bmm(xt, w.transpose(1, 2)) if b is None else
             torch.baddbmm(b.unsqueeze(1), xt, w.transpose(1, 2)))
        return y.reshape(*x.shape[:-1], w.shape[1])

    def heads(x, h):
        b, n, c = x.shape
        return x.view(b, n, h, c // h).transpose(1, 2)

    def merge(x):
        b, h, n, dh = x.shape
        return x.transpose(1, 2).reshape(b, n, h * dh)

    if op == "layernorm":
        return ln
    if op == "gemm":
        def fn(a, w, b, res=None, gelu=False):
            y = lin(a, w, b)
            y = F.gelu(y) if gelu else y
            return y if res is None else res + y
        return fn
    if op == "attn_half_block":
        def fn(x, lw, lb, wqkv, bqkv, wp, bp, h):
            q, k, v = lin(ln(x, lw, lb), wqkv, bqkv).chunk(3, dim=-1)
            o = F.scaled_dot_product_attention(heads(q, h), heads(k, h),
                                               heads(v, h))
            return x + lin(merge(o), wp, bp)
        return fn
    if op == "xattn_half_block":
        def fn(x, c, qw, qb, cw, cb, wq, bq, wkv, bkv, wp, bp, h,
               residual=True):
            q = lin(ln(x, qw, qb), wq, bq)
            k, v = lin(ln(c, cw, cb), wkv, bkv).chunk(2, dim=-1)
            o = F.scaled_dot_product_attention(heads(q, h), heads(k, h),
                                               heads(v, h))
            out = lin(merge(o), wp, bp)
            return x + out if residual else out
        return fn

    def mlp(x, lw, lb, w1, b1, w2, b2):
        return x + lin(F.gelu(lin(ln(x, lw, lb), w1, b1)), w2, b2)
    if op == "mlp_block":
        return mlp

    def bwd(dy, *args):  # the MLP half's forward and its backward
        args = [a.detach().requires_grad_() for a in args]
        return torch.autograd.grad(mlp(*args), args, dy)
    return bwd


def _dec_errs(what, names, got, want, fwd):
    """Each output against ``want``: max-abs, relative max and relative L2,
    within phase 2's forward (``fwd``) or backward bars."""
    import torch

    errs = {}
    for n, g, w in zip(names, got, want):
        if g is None:
            continue
        d = g.float() - w.float()
        e = errs[n] = {"max_abs": d.abs().max().item(),
                       "rel_max": (d.abs().max()
                                   / w.float().abs().max()).item(),
                       "rel_l2": (d.norm() / w.float().norm()).item()}
        ok = ((e["max_abs"] <= BF16_MAX_ABS and e["rel_l2"] <= BF16_REL_L2)
              if fwd else
              (e["rel_l2"] <= BWD_REL_L2 and e["rel_max"] <= BWD_REL_MAX))
        if not (ok and bool(torch.isfinite(g).all())):
            raise AssertionError(f"{what} {n}: {e} above the bars")
    return errs


def _dec_case(rows, name, label, shape, kernel, one_task, ref, plain,
              yardstick, names, fwd, work, key, calls, **extra):
    """One row of phase 14: ``kernel()`` (the task-strided call) rerun bit
    for bit; against ``one_task()`` (DEC_TASKS separate calls), bit for bit
    where ``fwd`` (and every forward output), within phase 2's backward
    bars otherwise; against ``ref()`` (its plain version in float32 from
    the same inputs) within phase 2's bars; then the kernel, the one-task
    calls, ``plain()`` (the plain version on the bf16 inputs) and
    ``yardstick()`` (the library's, described by ``library`` in ``extra``)
    timed with CUDA events beside the bound of ``work``."""
    import torch

    from mirage_tpu_torch.ops import runtime

    def tup(v):
        return v if isinstance(v, tuple) else (v,)

    got = tup(kernel())
    if not all(torch.equal(a, b) for a, b in zip(got, tup(kernel()))
               if a is not None):
        raise AssertionError(f"{name} {label}: a rerun is not bit-identical")
    split = tup(one_task())
    bit_equal = all(torch.equal(a, b) for a, b in zip(got, split)
                    if a is not None)
    if fwd and not bit_equal:
        raise AssertionError(f"{name} {label}: not bit-equal to "
                             f"{DEC_TASKS} one-task calls")
    vs_split = _dec_errs(f"{name} {label} vs one-task calls", names, got,
                         split, fwd)
    del split
    with runtime.plain_on_card():
        want = tup(ref())
    errs = _dec_errs(f"{name} {label}", names, got, want, fwd)
    del got, want
    flops, nbytes = work
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    ms = cuda_ms(kernel, iters=10)
    one_ms = cuda_ms(one_task, iters=10)
    with runtime.plain_on_card():
        plain_ms = cuda_ms(plain, iters=3, warmup=1)
    library_ms = cuda_ms(yardstick, iters=10)
    row = {"label": label, "shape": list(shape), "dtype": "bf16",
           "tasks": DEC_TASKS, "errors": errs, "vs_one_task_calls": vs_split,
           "bit_equal_to_one_task_calls": bit_equal,
           "max_abs_err": max(e["max_abs"] for e in errs.values()),
           "rerun_bit_identical": True, "ms": ms, "one_task_calls_ms": one_ms,
           "plain_ms": plain_ms, "library_ms": library_ms,
           "bound_ms": max(t_ops, t_bytes),
           "bound_by": "operations" if t_ops >= t_bytes else "bytes",
           key: calls, **extra}
    log(f"[decbatch] {name} {label} {list(shape)} ({DEC_TASKS} tasks): "
        f"errors {errs}; bit-equal to the one-task calls: {bit_equal} "
        f"({vs_split}); {ms:.4f} ms, {DEC_TASKS} one-task calls "
        f"{one_ms:.4f} ms, plain {plain_ms:.4f} ms, library "
        f"{library_ms:.4f} ms, bound {row['bound_ms']:.4f} ms "
        f"({row['bound_by']})")
    rows.setdefault(name, []).append(row)


def dec_kernel_rows():
    """Each task-strided op and kernel at the decoders' shapes (bf16,
    DEC_TASKS tasks): the forward ops (B1, B2, B3), the GEMM and the LN
    forward bit-equal to DEC_TASKS one-task calls, the backwards (B5,
    B7-MLP, the LN's) within phase 2's bars of them (dx of the LN backward
    bit-equal), every one against its plain version (phase 2's bars) and
    rerun bit for bit; timed beside the one-task calls, the plain version
    and the library (_dec_case). name -> rows."""
    import torch

    from mirage_tpu_torch.nn.layers import gelu, layer_norm, linear
    from mirage_tpu_torch.ops import block_attention as ba
    from mirage_tpu_torch.ops import fused_mlp as fm
    from mirage_tpu_torch.ops import runtime

    gen = torch.Generator().manual_seed(SEED + 14)
    rows = {}
    t, d, h, q, c = DEC_TASKS, DEC_DIM, DEC_HEADS, DEC_QUERIES, DEC_CONTEXT

    def f32(args):
        return [a.float() if torch.is_tensor(a) else a for a in args]

    # the forward ops: (op, label, per-task shape, kwargs, path key, calls)
    ops = {"attn_half_block": (ba.attn_half_block, ba.attn_half_block_ref),
           "xattn_half_block": (ba.xattn_half_block,
                                ba.xattn_half_block_ref),
           "mlp_block": (fm.mlp_block, fm.mlp_block_ref)}
    for op, label, shape, kw, key, calls in (
            ("attn_half_block", "serving decoder block", (BATCH, q, d, h),
             {}, "calls_per_forward", 2),
            ("xattn_half_block", "serving decoder cross-attention",
             (BATCH, q, c, d, h), {"residual": False}, "calls_per_forward",
             1),
            ("mlp_block", "serving decoder MLP", (BATCH, q, d), {},
             "calls_per_forward", 3),
            ("mlp_block", "pretraining decoder MLP", (TRAIN_BATCH, q, d), {},
             "calls_per_step", 2)):
        kernel, ref = ops[op]
        args = _dec_stack(op, shape, gen)
        acts = 2 if op == "xattn_half_block" else 1
        lib = _dec_library(op)
        flops, nbytes = _work(op, shape, 2)
        _dec_case(rows, f"{op} [tasks]", label, (t * shape[0], *shape[1:]),
                  lambda: kernel(*args, **kw),
                  lambda: _dec_tasks(lambda *a: kernel(*a, **kw), acts, args),
                  lambda: ref(*f32(args), **kw), lambda: ref(*args, **kw),
                  lambda: lib(*args, **kw), ["out"], True,
                  (t * flops, t * nbytes), key, calls,
                  library="F.layer_norm a task, torch.baddbmm over the "
                          "stacked weights, F.gelu and F.scaled_dot_product_"
                          "attention over the T·B batch")
        del args

    # the GEMM: (label, rows a task, N, K, epilogue, path key, calls)
    for label, m, n, k, epi, key, calls in (
            ("serving decoder qkv", BATCH * q, 3 * d, d, "bias",
             "calls_per_forward", 2),
            ("serving decoder proj", BATCH * q, d, d, "residual",
             "calls_per_forward", 2),
            ("serving cross-attention q, proj", BATCH * q, d, d, "bias",
             "calls_per_forward", 2),
            ("serving cross-attention kv", BATCH * c, 2 * d, d, "bias",
             "calls_per_forward", 1),
            ("serving decoder fc1", BATCH * q, 4 * d, d, "gelu",
             "calls_per_forward", 3),
            ("serving decoder fc2", BATCH * q, d, 4 * d, "residual",
             "calls_per_forward", 3),
            ("pretraining decoder fc1", TRAIN_BATCH * q, 4 * d, d, "gelu",
             "calls_per_step", 2),
            ("pretraining decoder fc2", TRAIN_BATCH * q, d, 4 * d,
             "residual", "calls_per_step", 2)):
        gelu_on = epi == "gelu"
        args = [_dec_rn(gen, t * m, k), _dec_rn(gen, t, n, k, scale=k ** -0.5),
                _dec_rn(gen, t, n, scale=0.02)]
        if epi == "residual":
            args.append(_dec_rn(gen, t * m, n))
        acts = 2 if epi == "residual" else 1
        order = [args[0]] + args[3:] + args[1:3]  # activations first

        def launch(a, *rest):
            res, (w, b) = (rest[0], rest[1:]) if len(rest) == 3 else \
                (None, rest)
            return runtime.gemm(a, w, b, residual=res, gelu=gelu_on)

        def plain(a, *rest):
            res, (w, b) = (rest[0], rest[1:]) if len(rest) == 3 else \
                (None, rest)
            y = linear(a, w, b)
            y = gelu(y) if gelu_on else y
            return y if res is None else res + y.to(res.dtype)

        lib = _dec_library("gemm")
        nbytes = 2 * (t * m * k + t * n * k + t * m * n * (1 + acts - 1)) \
            + 4 * t * n
        _dec_case(rows, "gemm [tasks]", label, (t * m, n, k),
                  lambda: launch(*order),
                  lambda: _dec_tasks(launch, acts, order),
                  lambda: _dec_tasks(plain, acts, f32(order)),
                  lambda: _dec_tasks(plain, acts, order),
                  lambda: lib(args[0], args[1], args[2],
                              args[3] if acts == 2 else None, gelu_on),
                  ["out"], True, (2 * t * m * n * k, nbytes), key, calls,
                  epilogue=epi, library="torch.baddbmm over the stacked "
                                        "weights (then F.gelu, the residual)")
        del args, order

    # the LN forward: (label, rows a task, path key, calls)
    lib = _dec_library("layernorm")
    for label, m, key, calls in (
            ("serving decoder queries", BATCH * q, "calls_per_forward", 6),
            ("serving cross-attention context", BATCH * c,
             "calls_per_forward", 1),
            ("pretraining decoder rows", TRAIN_BATCH * q, "calls_per_step",
             4)):
        args = [_dec_rn(gen, t * m, d),
                (1 + 0.1 * torch.randn(t, d, generator=gen)).cuda(),
                (0.02 * torch.randn(t, d, generator=gen)).cuda()]
        _dec_case(rows, "layernorm [tasks]", label, (t * m, d),
                  lambda: runtime.layernorm(*args),
                  lambda: _dec_tasks(runtime.layernorm, 1, args),
                  lambda: layer_norm(args[0].float(), *args[1:]),
                  lambda: layer_norm(*args), lambda: lib(*args), ["y"], True,
                  (0, 4 * t * m * d + 8 * t * d), key, calls,
                  instantiation=_ln_instantiation(m, d, False),
                  library="F.layer_norm a task")
        del args

    # the backwards at the pretraining decoders' rows: B5 and B7-MLP over
    # the stack, and the LN backward they end in
    shape = (TRAIN_BATCH, q, d)
    full = _dec_stack("mlp_block", shape, gen)  # x, the six weights
    args = full[:6]  # a backward takes no b2
    dy = _dec_rn(gen, t * TRAIN_BATCH, q, d)
    names = ["dx", "dgamma", "dbeta", "dw1", "db1", "dw2", "db2"]
    flops, nbytes = _bwd_work("mlp_block_bwd", shape, 2)
    lib = _dec_library("mlp_block_bwd")

    def ref_bwd(x, g, *w):
        return fm.mlp_block_bwd_ref(x, g, *w)

    for name, bwd, switch in (
            ("mlp_block_bwd [tasks]", fm._mlp_bwd, "defused"),
            ("mlp_block_acc_bwd [tasks]", fm._mlp_bwd_acc, "accumulate")):
        _dec_case(rows, name, "pretraining decoder MLP",
                  (t * TRAIN_BATCH, q, d),
                  lambda: bwd(args[0], dy, *args[1:]),
                  lambda: _dec_tasks(bwd, 2, [args[0], dy] + args[1:]),
                  lambda: _dec_tasks(ref_bwd, 2, f32([args[0], dy])
                                     + f32(args[1:])),
                  lambda: _dec_tasks(ref_bwd, 2, [args[0], dy] + args[1:]),
                  lambda: lib(dy, *full), names, False,
                  (t * flops, t * nbytes), "calls_per_step", 2,
                  switch=f"MIRAGE_MLP_BWD={switch}",
                  library="the forward from F.layer_norm a task, "
                          "torch.baddbmm over the stacked weights and F.gelu"
                          ", and its torch.autograd.grad")
    x2, dy2 = args[0].view(-1, d), dy.view(-1, d)
    dyln = torch.randn(x2.shape, generator=gen).cuda()
    ln_args = [x2, args[1], dyln, dy2]

    def ln_lib():
        xs, ws = x2.detach().requires_grad_(), args[1].detach() \
            .requires_grad_()
        y = _dec_library("layernorm")(xs, ws, args[2])
        return torch.autograd.grad(y, (xs, ws), dyln.to(y.dtype))

    def ln_ref(x, w, g, dy):
        dx, dgamma, dbeta = ba.ln_bwd_ref(x, g, w, dy)
        return dx.to(x.dtype), dgamma, dbeta

    def ln_one(x, w, g, dy):
        return runtime.layernorm_bwd(x, w, g, dy)

    _dec_case(rows, "layernorm_bwd [tasks]", "pretraining decoder rows",
              tuple(x2.shape), lambda: runtime.layernorm_bwd(*ln_args),
              lambda: _dec_tasks(ln_one, 1, [x2] + ln_args[1:2]
                                 + [dyln.view(t, -1, d), dy2.view(t, -1, d)]),
              lambda: _dec_tasks(ln_ref, 1, [x2.float()] + ln_args[1:2]
                                 + [dyln.view(t, -1, d), dy2.view(t, -1, d)]),
              lambda: _dec_tasks(ln_ref, 1, [x2] + ln_args[1:2]
                                 + [dyln.view(t, -1, d), dy2.view(t, -1, d)]),
              ln_lib, ["dx", "dgamma", "dbeta"], False,
              (0, x2.numel() * (2 + 4 + 2 + 2) + 8 * t * d * 2),
              "calls_per_step", 2,
              instantiation=_ln_instantiation(TRAIN_BATCH * q, d, True),
              library="F.layer_norm a task and its torch.autograd.grad")
    ln_row = rows["layernorm_bwd [tasks]"][-1]
    if ln_row["vs_one_task_calls"]["dx"]["max_abs"] != 0:
        raise AssertionError("layernorm_bwd [tasks]: dx not bit-equal to the "
                             "one-task launches")
    del full, args, dy, x2, dy2, dyln, ln_args
    return rows


def _dec_step(card):
    """Phase 5's pretraining step (ViT-B at batch 256, three 256/2/8
    decoders, remat on, injected masks, 98 visible tokens, bf16) with
    MIRAGE_DEC_BATCH on against off: the loss, the grad norm and every
    leaf's gradient within phase 5's bars (the decoders' worst leaf
    reported apart), exact launches of one forward and backward in each
    (DEC_PER_STEP), and with MIRAGE_MLP_BWD=accumulate too
    (DEC_PER_STEP_ACC) against off. Returns (the result, the step
    function to time)."""
    import numpy as np
    import torch

    from mirage_tpu_torch.api.wrapper import build_model
    from mirage_tpu_torch.masking.masking import generate_random_masks
    from mirage_tpu_torch.ops import runtime
    from mirage_tpu_torch.train.optim import GroupedOptimizer, OptimizerConfig
    from mirage_tpu_torch.train.steps import (init_train_state,
                                              make_pretrain_loss,
                                              make_train_step)

    t0 = time.perf_counter()
    model = build_model("miragepre_base", TRAIN_ARGS, TRAIN_DOMAINS, 512, 32,
                        compute_dtype=torch.bfloat16,
                        generator=torch.Generator().manual_seed(SEED),
                        remat=True).cuda()
    opt = GroupedOptimizer(OptimizerConfig(
        opt="adamw", betas=(0.9, 0.95), weight_decay=0.05, clip_grad=1.0))
    loss_fn = make_pretrain_loss(model, TRAIN_DOMAIN_CONF,
                                 num_encoded_tokens=98, alphas=1.0)
    state = init_train_state(model, opt)
    step = make_train_step(loss_fn, opt)
    b = TRAIN_BATCH
    rng = np.random.default_rng(SEED)
    batch = {"bscan": rng.random((b, 1, 512, 512), dtype=np.float32),
             "slo": rng.random((b, 1, 512, 512), dtype=np.float32),
             "bscanlayermap": rng.integers(0, 13, (b, 128, 128))}
    batch = {k: torch.from_numpy(v).cuda() for k, v in batch.items()}
    masks, _, _ = generate_random_masks(
        torch.Generator().manual_seed(SEED), [256, 256, 256], b, 98)
    masks = {k: m.cuda() for k, m in zip(TRAIN_DOMAINS, masks)}
    names = [n for n, p in state["params"].items() if p.requires_grad]
    log(f"[decbatch] the ViT-B pretraining step (remat on) built in "
        f"{time.perf_counter() - t0:.1f}s")

    def loss_and_grads():
        loss, _ = loss_fn(batch, task_masks=masks, num_visible=98)
        return loss.detach(), torch.autograd.grad(
            loss, [state["params"][n] for n in names])

    runs = {}
    for label, switches, want in (
            ("off", {"MIRAGE_DEC_BATCH": "off"}, DEC_PER_STEP["off"]),
            ("on", {"MIRAGE_DEC_BATCH": "on"}, DEC_PER_STEP["on"]),
            ("on, accumulate", {"MIRAGE_DEC_BATCH": "on",
                                "MIRAGE_MLP_BWD": "accumulate"},
             DEC_PER_STEP_ACC)):
        with runtime.switched(switches):
            (loss, grads), counts = _dec_count(loss_and_grads)
        _dec_check_counts(f"step, {label}", counts, want)
        runs[label] = (loss, grads, counts)
    off_loss, off_grads, _ = runs["off"]
    out = {"counts": {k: v[2] for k, v in runs.items()}}
    for label in ("on", "on, accumulate"):
        loss, grads, _ = runs[label]
        agree = _agreement(loss, grads, off_loss, off_grads, names)
        dec = {n: ((g - w).norm() / w.norm()).item()
               for n, g, w in zip(names, grads, off_grads)
               if n.startswith("output_adapters.") and w.norm() > 0}
        worst = max(dec, key=dec.get)
        agree["worst_decoder_leaf"] = worst
        agree["worst_decoder_leaf_rel_l2"] = dec[worst]
        agree["decoder_leaves"] = len(dec)
        log(f"[decbatch] step with {label} against off: {agree}")
        _check_agreement(f"decbatch step ({label})", agree)
        out[label] = agree
    del runs, off_grads

    def call():
        step(state, batch, None, 1e-4, task_masks=masks, num_visible=98)

    return out, call


def _dec_forward(wrapper, x):
    """Phase 4's batch-64 MIRAGE-Large reconstruct forward with
    MIRAGE_DEC_BATCH on against off: exact launches (DEC_PER_FORWARD), the
    outputs within phase 4's bar of each other and of the plain path.
    Returns (the result, the forward to time)."""
    import torch

    from mirage_tpu_torch.ops import runtime

    outs, counts = {}, {}
    for label in ("off", "on"):
        with runtime.switched({"MIRAGE_DEC_BATCH": label}):
            outs[label], counts[label] = _dec_count(lambda: wrapper(x))
        _dec_check_counts(f"forward, {label}", counts[label],
                          DEC_PER_FORWARD[label])
    with runtime.plain_on_card():
        want = wrapper(x)
    agree = {}
    for task in want:
        on, off, w = (outs["on"][task].float(), outs["off"][task].float(),
                      want[task].float())
        agree[task] = {
            "max_abs_on_vs_off": (on - off).abs().max().item(),
            "rel_l2_on_vs_off": ((on - off).norm() / off.norm()).item(),
            "bit_equal_on_off": bool(torch.equal(outs["on"][task],
                                                  outs["off"][task])),
            "rel_l2_on_vs_plain": ((on - w).norm() / w.norm()).item()}
        a = agree[task]
        if not (a["rel_l2_on_vs_off"] <= MODEL_REL_L2
                and a["rel_l2_on_vs_plain"] <= MODEL_REL_L2
                and bool(torch.isfinite(on).all())):
            raise AssertionError(f"decbatch forward {task}: {a} (bar "
                                 f"{MODEL_REL_L2})")
    log(f"[decbatch] the batch-{BATCH} forward with MIRAGE_DEC_BATCH=on "
        f"against off and the plain path: {agree}")
    return {"counts": counts, "agreement": agree}, lambda: wrapper(x)


def _dec_block_rows():
    """nn/block.py:DecoderBlock at decoder width (batch 64, 256 queries,
    DEC_BLOCK_CONTEXTS context tokens; 600 takes B8), bf16 activations
    with float32 parameters: its forward and backward (the input's, the
    context's and every parameter's gradient) against its plain version
    in float32 on the same values (phase 2's bars), exact launches of one
    call (DEC_BLOCK_PER_CALL), ms of a forward and backward beside the
    plain version's."""
    import torch

    from mirage_tpu_torch.nn import init as vinit
    from mirage_tpu_torch.nn.block import DecoderBlock
    from mirage_tpu_torch.ops import runtime

    gen = torch.Generator().manual_seed(SEED + 15)
    block = vinit.init_weights(DecoderBlock(DEC_DIM, DEC_HEADS), gen).cuda()
    params = list(block.parameters())
    names = [n for n, _ in block.named_parameters()]
    rows = []
    for nc in DEC_BLOCK_CONTEXTS:
        x = _dec_rn(gen, BATCH, DEC_QUERIES, DEC_DIM)
        ctx = _dec_rn(gen, BATCH, nc, DEC_DIM)
        dy = _dec_rn(gen, BATCH, DEC_QUERIES, DEC_DIM)

        def run(x, ctx):
            xs, cs = x.detach().requires_grad_(), ctx.detach() \
                .requires_grad_()
            out = block(xs, cs)
            return (out,) + torch.autograd.grad(out, [xs, cs] + params,
                                                dy.to(out.dtype))

        got, counts = _dec_count(lambda: run(x, ctx))
        _dec_check_counts(f"DecoderBlock at {nc} keys", counts,
                          DEC_BLOCK_PER_CALL[nc])
        with runtime.plain_on_card():
            want = run(x.float(), ctx.float())
        errs = _dec_errs(f"DecoderBlock at {nc} keys", ["out"], got[:1],
                         want[:1], True)
        errs.update(_dec_errs(f"DecoderBlock at {nc} keys",
                              ["dx", "dcontext"] + names, got[1:], want[1:],
                              False))
        ms = cuda_ms(lambda: run(x, ctx), iters=5)
        with runtime.plain_on_card():
            plain_ms = cuda_ms(lambda: run(x, ctx), iters=3, warmup=1)
        row = {"shape": [BATCH, DEC_QUERIES, nc, DEC_DIM, DEC_HEADS],
               "counts": counts, "errors": errs,
               "worst_rel_l2": max(e["rel_l2"] for e in errs.values()),
               "forward_backward_ms": ms, "plain_ms": plain_ms}
        log(f"[decbatch] DecoderBlock {row['shape']}: launches {counts}; "
            f"worst rel_l2 {row['worst_rel_l2']:.3e}; forward and backward "
            f"{ms:.4f} ms, plain {plain_ms:.4f} ms")
        rows.append(row)
        del x, ctx, dy, got, want
    return rows


def phase_decbatch(workdir, card, large):
    """Phase 14 (module docstring): the task-strided kernels, the forward
    and the step with MIRAGE_DEC_BATCH on against off, DecoderBlock, and
    the ABBA timings of mirage_tpu_torch/bench/decbatch.py."""
    import numpy as np
    import torch

    from mirage_tpu_torch.api.wrapper import MIRAGEWrapper
    from mirage_tpu_torch.bench import decbatch

    t0 = time.perf_counter()
    kernels = dec_kernel_rows()
    blocks = _dec_block_rows()
    wrapper = MIRAGEWrapper(weights=str(large), compute_dtype=torch.bfloat16,
                            device="cuda")
    rng = np.random.default_rng(SEED + 14)
    x = {"bscan": torch.from_numpy(
        rng.random((BATCH, 1, 512, 512), dtype=np.float32)).cuda()}
    forward, fwd_call = _dec_forward(wrapper, x)
    step, step_call = _dec_step(card)
    timing = {}
    for case, call, iters in (("forward", fwd_call, DEC_FORWARD_ITERS),
                              ("step", step_call, DEC_STEP_ITERS)):
        timing[case] = decbatch.abba({a: call for a in decbatch.ARMS},
                                     DEC_ABBA_ROUNDS, iters, True)
        log(f"[decbatch] ABBA {case} ({DEC_ABBA_ROUNDS} rounds of {iters}) "
            f"on {card}: {timing[case]}")
    del wrapper
    torch.cuda.empty_cache()
    log(f"[decbatch] phase 14 in {time.perf_counter() - t0:.1f}s")
    return {"kernels": kernels, "decoder_block": blocks, "forward": forward,
            "step": step, "timing": timing, "card": card}


def _decbatch_entries(dec):
    """Phase 14's entries of the `kernels` line: the task-strided ops and
    kernels on the reconstruct forward (launches from its batch-64 forward
    with MIRAGE_DEC_BATCH=on) and on the pretraining step (launches from
    its forward and backward with the switch on; B7-MLP's with
    MIRAGE_MLP_BWD=accumulate too); times summed over one such pass."""
    rows = dec["kernels"]
    entries = []
    for path, key, counts, per_path, suffix, times in (
            ("forward", "calls_per_forward", dec["forward"]["counts"]["on"],
             DEC_PER_FORWARD["on"], " [decbatch forward]",
             f"sum over one batch-{BATCH} MIRAGE-Large reconstruct forward "
             f"with MIRAGE_DEC_BATCH=on; launches from that forward"),
            ("step", "calls_per_step", dec["step"]["counts"]["on"],
             DEC_PER_STEP["on"], " [decbatch step]",
             f"sum over one batch-{TRAIN_BATCH} pretraining step with "
             f"MIRAGE_DEC_BATCH=on; launches from its forward and backward"),
            ("step", "calls_per_step",
             dec["step"]["counts"]["on, accumulate"], DEC_PER_STEP_ACC,
             " [decbatch step, accumulate]",
             f"sum over one batch-{TRAIN_BATCH} pretraining step with "
             f"MIRAGE_DEC_BATCH=on and MIRAGE_MLP_BWD=accumulate; launches "
             f"from its forward and backward")):
        acc = "accumulate" in suffix
        picked = {name: [r for r in rs if r.get(key)]
                  for name, rs in rows.items()
                  if ("acc_bwd" in name) == acc}
        picked = {k: v for k, v in picked.items() if v}
        for e in _kernel_entries(picked, counts, per_path, path, times):
            e["name"] += suffix
            entries.append(e)
    return entries


# ------------------------------------------------------------ --multi-card

# the pipelines of --multi-card, one process a card over NCCL: (label, mesh
# axes, M); each stage runs B1/B4 and B2/B5 24 times a step in both (6
# blocks x 4 microbatches of 32, 3 blocks x 8 microbatches of 32), so
# PER_STEP_PP holds on every rank
MULTI_PIPES = [("data 2 x pipe 2", {"data": 2, "pipe": 2}, 4),
               ("pipe 4", {"pipe": 4}, 8)]
MULTI_TIMEOUT = 600  # seconds for a process of --multi-card to join


def _multi_pipeline_worker(rank, world, port, outdir):
    """A process of --multi-card: NCCL on cuda:rank; each pipeline of
    MULTI_PIPES from phase 5's weights and (a)'s masks at global batch 256;
    rank 0 gathers the first step's gradients in the standard layout and
    holds them to the bare step."""
    import datetime
    import traceback

    outdir = Path(outdir)
    try:
        import torch
        import torch.distributed as dist

        sys.path.insert(0, str(ROOT))
        from mirage_tpu_torch.parallel.mesh import (init_distributed,
                                                    local_batch, make_mesh)
        from mirage_tpu_torch.train.steps import (gather_pp,
                                                  init_train_state,
                                                  make_train_step,
                                                  shard_state)

        init_distributed(f"cuda:{rank}",
                         init_method=f"tcp://localhost:{port}",
                         world_size=world, rank=rank,
                         timeout=datetime.timedelta(seconds=MULTI_TIMEOUT))
        counters = _parallel_counters()
        ref = torch.load(outdir / "ref.pt")
        whole = {k: torch.from_numpy(v).cuda()
                 for k, v in _parallel_batch().items()}
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        results = {}
        for label, axes, micro in MULTI_PIPES:
            mesh = make_mesh(dict(axes), "cuda")
            model, opt = _train_model()
            model.pp = ("pipe", micro)
            state = shard_state(init_train_state(model, opt), mesh, model)
            step = make_train_step(_masked_loss(model), opt, mesh=mesh,
                                   pp=True)
            batch = local_batch(whole, mesh)
            state, m1 = step(state, batch, gen, PARALLEL_LR)
            params = state["params"]
            whole_grads = gather_pp(
                {n: (torch.zeros_like(p) if p.grad is None else p.grad)
                 .float() for n, p in params.items()}, state["layout"])
            res = {"loss": [m1["loss"].item()],
                   "grad_norm": [m1["grad_norm"].item()],
                   "blocks": sorted({int(n.split(".")[1]) for n in params
                                     if n.startswith("encoder.")})}
            if rank == 0:
                res["agreement"] = _agreement(
                    m1["loss"].cpu(), [whole_grads[n] for n in ref["names"]],
                    torch.tensor(ref["step1_loss"]),
                    [ref["grads"][n] for n in ref["names"]], ref["names"])
            del whole_grads
            state, m2 = step(state, batch, gen, PARALLEL_LR)
            res["loss"].append(m2["loss"].item())
            res["grad_norm"].append(m2["grad_norm"].item())
            torch.cuda.reset_peak_memory_stats()
            state, ms, dev, counts, _ = _timed_steps(
                step, state, batch, gen, counters, PIPE_STEPS)
            res.update({"ms_per_step": ms, "device_ms": dev,
                        "counts": counts,
                        "peak_gib": torch.cuda.max_memory_allocated()
                        / 2 ** 30})
            results[label] = res
            del model, state, step, params
            torch.cuda.empty_cache()
        torch.save(results, outdir / f"rank{rank}.pt")
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:
        (outdir / f"err{rank}").write_text(traceback.format_exc())
        raise


def multi_card_pipelines(workdir, card, n):
    """--multi-card's pipelines: the bare step on cuda:0 (the reference),
    then ``n`` processes, one a card, over NCCL (sends and receives by
    ``batch_isend_irecv``) through each of MULTI_PIPES: the first step's
    loss, grad norm and every gradient and the second step's loss against
    the bare step (phase 5's bars), each stage's blocks, exact launches on
    every rank, each rank's ms a step."""
    import multiprocessing
    import shutil

    import torch

    bare, ref, _ = _bare_reference(card)
    torch.cuda.empty_cache()
    outdir = workdir / "multi_card"
    shutil.rmtree(outdir, ignore_errors=True)
    outdir.mkdir(parents=True)
    torch.save(ref, outdir / "ref.pt")
    ctx = multiprocessing.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=_multi_pipeline_worker,
                         args=(r, n, port, str(outdir))) for r in range(n)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(MULTI_TIMEOUT)
    finally:
        hung = [p for p in procs if p.is_alive()]
        for p in hung:
            p.kill()
            p.join(30)
    errs = [f.read_text() for f in sorted(outdir.glob("err*"))]
    codes = [p.exitcode for p in procs]
    if hung or errs or any(codes):
        raise AssertionError(f"--multi-card workers: exit codes {codes}, "
                             f"hung {len(hung)}\n" + "\n".join(errs))
    ranks = [torch.load(outdir / f"rank{r}.pt") for r in range(n)]
    out = {"bare": bare}
    for label, axes, micro in MULTI_PIPES:
        r0 = ranks[0][label]
        agree = dict(r0["agreement"])
        agree["step2_loss_rel"] = abs(r0["loss"][1] - ref["loss"][1]) \
            / abs(ref["loss"][1])
        by_rank = [r[label] for r in ranks]
        log(f"[multi-card] {label}, M = {micro}, NCCL, one process a card: "
            f"{agree}; blocks by rank {[r['blocks'] for r in by_rank]}; ms "
            f"a step by rank {[r['ms_per_step'] for r in by_rank]} (bare "
            f"{bare['ms_per_step']:.2f} on one card), device ms "
            f"{[r['device_ms'] for r in by_rank]}, peak GiB "
            f"{[r['peak_gib'] for r in by_rank]}, launches {r0['counts']}, "
            f"on {n} x {card}")
        _check_agreement(f"{label} (NCCL)", agree)
        if agree["step2_loss_rel"] > TRAIN_LOSS_REL:
            raise AssertionError(f"{label}: second step's loss {agree}")
        for r, res in enumerate(by_rank):
            _check_counts(f"{label}, rank {r}", res["counts"],
                          {**PER_STEP_PP, **DENSE_PER_STEP}, PIPE_STEPS)
        out[label] = {"agreement": agree, "ranks": by_rank}
    return out


def multi_card_serving(workdir, card, n):
    """--multi-card's serving mesh: the wrapper (MIRAGE-Large, bf16) with
    one replica on each of ``n`` cards (one thread and stream a card, each
    card's launch state its own) against the plain wrapper on cuda:0 at
    batch 64, 3 and 1, for __call__ and features (phase 4's bar, the
    largest difference and whether it is bit-equal printed); img/s beside
    the plain wrapper's; each card's device time."""
    import numpy as np
    import torch

    from mirage_tpu_torch.api.wrapper import MIRAGEWrapper
    from mirage_tpu_torch.ops import runtime
    from mirage_tpu_torch.ops.block_attention import (attn_half_block,
                                                      xattn_half_block)
    from mirage_tpu_torch.ops.fused_mlp import mlp_block

    ops = {"attn_half_block": attn_half_block, "mlp_block": mlp_block,
           "xattn_half_block": xattn_half_block,
           "attention_fwd": runtime.attention, "gemm": runtime.gemm}

    def counted(call, per, b):
        """call() with the ops' counts set to 0 first; raises unless each
        of the n replicas' forwards launched ``per``."""
        for fn in ops.values():
            fn.launches = 0
        res = call()
        for i in range(n):
            torch.cuda.synchronize(i)
        counts = {name: fn.launches for name, fn in ops.items()}
        exp = {k: n * per[k] for k in ops}
        if counts != exp:
            raise AssertionError(f"serving mesh, batch {b}: launches "
                                 f"{counts} != {exp}")
        return res, counts

    path = _large_weights(workdir)
    kw = dict(weights=str(path), compute_dtype=torch.bfloat16,
              device="cuda")
    plain = MIRAGEWrapper(**kw)
    mesh = MIRAGEWrapper(**kw, mesh={"data": n})
    rng = np.random.default_rng(SEED + 30)
    out = {"devices": [str(d) for d in mesh.mesh.devices], "agreement": {}}
    try:
        for b in SERVE_MESH_BATCHES:
            x = {"bscan": rng.random((b, 1, 512, 512), dtype=np.float32)}
            got, counts = counted(lambda: mesh(x), PER_RECONSTRUCT, b)
            feats, feat_counts = counted(lambda: mesh.features(x),
                                         PER_FEATURES, b)
            want = plain(x)
            pairs = [(t, got[t], want[t]) for t in want]
            pairs.append(("features", feats, plain.features(x)))
            agree = {}
            for t, got, want in pairs:
                d = got.float() - want.float()
                agree[t] = {"max_abs": d.abs().max().item(),
                            "rel_l2": (d.norm() / want.float().norm()).item(),
                            "bit_equal": torch.equal(got, want)}
            out["agreement"][b] = agree
            log(f"[multi-card] serving mesh over {out['devices']}, batch "
                f"{b}: {agree}; launches {counts} a call, {feat_counts} "
                f"a features call ({n} replicas' forwards, as expected)")
            bad = {t: a for t, a in agree.items()
                   if not a["rel_l2"] <= MODEL_REL_L2}
            if bad:
                raise AssertionError(f"serving mesh, batch {b}: {bad} above "
                                     f"rel_l2 {MODEL_REL_L2}")
        x = {"bscan": rng.random((BATCH, 1, 512, 512), dtype=np.float32)}
        times = {}
        for name, w in (("plain", plain), ("mesh", mesh), ("plain", plain),
                        ("mesh", mesh)):
            for _ in range(2):
                w(x)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(5):
                w(x)
            for i in range(n):
                torch.cuda.synchronize(i)
            times.setdefault(name, []).append(
                BATCH * 5 / (time.perf_counter() - t0))
        out.update({"img_per_s": times,
                    "device_spans_ms": mesh.device_spans(), "card": card})
        log(f"[multi-card] batch {BATCH}: img/s plain wrapper (cuda:0) "
            f"{times['plain']}, {n} replicas {times['mesh']}; each card's "
            f"device span (ms, from its own start) "
            f"{out['device_spans_ms']}; on {n} x {card}")
    finally:
        mesh.close()
    return out


def multi_card(workdir, card):
    """``--multi-card``: the paths that exist only across cards, on every
    card of the machine (at least two): the pipelines over NCCL, then the
    serving mesh over the cards."""
    import torch

    n = torch.cuda.device_count()
    if n < 2:
        raise RuntimeError(f"--multi-card needs two cards or more, {n} "
                           f"found")
    log("[multi-card] cards: " + "; ".join(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()))
    pipes = multi_card_pipelines(workdir, card, n) if n == 4 else None
    return {"cards": n, "pipelines": pipes,
            "serving": multi_card_serving(workdir, card, n)}


# ----------------------------------------------------------------- phase 15

# SAM ViT-H's relative-position attention at batch 4 of 1024² images:
# (batch, grid rows, grid columns, heads, dh, window; 0: global)
SAM_SHAPES = ((4, 64, 64, 16, 80, 14), (4, 64, 64, 16, 80, 0))
# its calls in one step of the SAM encoder: 28 windowed blocks, 4 global
SAM_PER_STEP = {14: 28, 0: 4}


def _relpos_work(shape):
    """(FLOPs, bytes) of one call: the attention over each window's keys
    for the real queries, the bias products 2·n·dh·k twice a head, q, k, v
    and the output of the real tokens once (benchmark/work_sam.py)."""
    b, h, w, heads, dh, window = shape
    n, k = h * w, window or h
    return (4 * b * heads * n * k * k * dh + b * heads * 4 * n * dh * k,
            b * heads * dh * 4 * n * 2)


def _relpos_windowed_bytes(shape):
    """Bytes a windowed call's TMA loads and stores, modelled from the
    shape (csrc/relpos_attention.cu's windowed mode): Q, K and V of each
    (window, head)'s 16 × 16 slots and b_k's 8 rows loaded once, the real
    tokens' output stored. Slots past the grid (zero-filled) and the
    columns read from the next window (mostly L2 hits) count as moved, so
    this is L2 plus HBM traffic, above what HBM alone carries."""
    b, h, w, heads, dh, window = shape
    items = b * -(-h // window) * -(-w // window) * heads
    return (items * (3 * 16 * 16 + 8) + b * h * w * heads) * dh * 2


def phase_sam(card):
    """SAM ViT-H's relative-position attention (csrc/relpos_attention.cu)
    alone at its full shapes, a windowed and a global layer: the kernel
    against its plain version (float32 math from the same bf16 inputs),
    rerun bit for bit, timed with its host cost (``ms``) and the device's
    alone (``device_ms``), its kernel by torch.profiler, beside the plain
    version on the card and the bound. The windowed call's TMA traffic
    (:func:`_relpos_windowed_bytes`, a model) is logged apart from the rows,
    which carry what was measured and the bound."""
    import torch

    from mirage_tpu_torch.ops import runtime
    from mirage_tpu_torch.ops.relpos_attention import (relpos_attention,
                                                       relpos_attention_ref)

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = []
    for shape in SAM_SHAPES:
        b, h, w, heads, dh, window = shape
        k, d3 = window or h, 3 * heads * dh

        def rand(*size, scale=1.0):
            return (scale * torch.randn(size, device="cuda",
                                        generator=gen)).bfloat16()

        qkv, bias = rand(b, h, w, d3), rand(d3, scale=0.1)
        tab_h, tab_w = rand(2 * k - 1, dh, scale=0.1), rand(2 * k - 1, dh,
                                                             scale=0.1)
        args = (qkv, bias, tab_h, tab_w, heads, window)
        with torch.no_grad():
            got, again = relpos_attention(*args), relpos_attention(*args)
            with runtime.plain_on_card():
                want = relpos_attention_ref(*(t.float() for t in args[:4]),
                                            heads, window)
                plain_ms = cuda_ms(lambda: relpos_attention_ref(*args),
                                   iters=3, warmup=1)
            ms = cuda_ms(lambda: relpos_attention(*args))
            dev_ms = device_ms(lambda: relpos_attention(*args))
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                for _ in range(5):
                    relpos_attention(*args)
                torch.cuda.synchronize()
        split = {}
        for start, end, name in device_kernels(prof):
            key = name.removeprefix("void ").split("<")[0].split("(")[0]
            split[key] = split.get(key, 0.0) + (end - start) / 1e3 / 5
        diff = got.float() - want
        rel = float(diff.norm() / want.norm())
        max_abs = float(diff.abs().max())
        bound_ms, bound_by = _bound(_relpos_work(shape))
        row = {"shape": list(shape), "dtype": "bf16", "rel_l2": rel,
               "max_abs_err": max_abs, "rerun_bit_equal":
                   bool(torch.equal(got, again)), "ms": ms,
               "device_ms": dev_ms, "kernels_ms": split, "plain_ms": plain_ms,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "bound_share": bound_ms / dev_ms,
               "calls_per_step": SAM_PER_STEP[window]}
        log(f"[sam] {'window ' + str(window) if window else 'global'} "
            f"{shape}: rel {rel:.2e} max {max_abs:.2e}, {ms:.3f} ms "
            f"({dev_ms:.3f} device; {split}), plain {plain_ms:.3f}, bound "
            f"{bound_ms:.4f} ({bound_by}); {card}")
        if window:
            moved = _relpos_windowed_bytes(shape)
            log(f"[sam] window {window}: modelled, not measured: the TMA "
                f"moves {moved / 1e6:.1f} MB a call, {moved / dev_ms / 1e9:.2f}"
                f" TB/s of L2 plus HBM traffic over its device time")
        if not row["rerun_bit_equal"]:
            raise AssertionError(f"relpos attention {shape} reruns differ")
        if rel > BF16_REL_L2 or max_abs > BF16_MAX_ABS:
            raise AssertionError(f"relpos attention {shape}: rel {rel}, "
                                 f"max {max_abs}")
        rows.append(row)
        del qkv, got, again, want
        torch.cuda.empty_cache()
    return {"shapes": rows, "encoder": sam_encoder_forward(card)}


def sam_encoder_forward(card, calls=3):
    """The SAM ViT-H encoder's grad-free forward at batch 4 of 1024²
    images, bf16 compute (the frozen-encoder step's): the op's calls
    counted from 0 over one forward, then ``calls`` forwards under
    torch.profiler with the port's spans: the relative-position kernels
    (named relpos_attn*) a forward and their device time, the port's
    launches a forward (counted to its spans: ``mirage.forward``,
    ``.encoder`` and the blocks'), and the forward's time
    (CUDA events)."""
    import torch

    from mirage_tpu_torch.adapters.input_adapters import PatchedInputAdapter
    from mirage_tpu_torch.models.sam import sam_factory
    from mirage_tpu_torch.ops import runtime
    from mirage_tpu_torch.utils import profiling

    b, size = SAM_SHAPES[0][0], 1024
    with torch.device("cuda"):
        model = sam_factory["sam_vit_h"](
            {"bscan": PatchedInputAdapter(3, 1, 16, size)}, None,
            compute_dtype=torch.bfloat16)
    model.requires_grad_(False)
    x = torch.rand((b, 3, size, size), device="cuda",
                   generator=torch.Generator(device="cuda").manual_seed(SEED))

    def forward():
        return model.forward_light({"bscan": x}, frozen_encoder=True)

    forward()
    torch.cuda.synchronize()
    runtime.relpos_attention.launches = 0
    out = forward()
    torch.cuda.synchronize()
    op_calls = runtime.relpos_attention.launches
    ms = cuda_ms(forward, iters=5, warmup=1)
    forget_spans()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            forward()
        torch.cuda.synchronize()
    spans = profiling.summary()
    forget_spans()
    relpos = [(end - start) / 1e3 for start, end, name in device_kernels(prof)
              if name.removeprefix("void ").startswith("relpos_attn")]
    got = {"batch": b, "image": size,
           "op_calls_per_forward": op_calls,
           "relpos_kernels_per_forward": len(relpos) / calls,
           "relpos_ms_per_forward": sum(relpos) / calls,
           "port_launches_per_forward":
               sum(r["launches"] for r in spans.values()) / calls,
           "forward_ms": ms, "finite": bool(torch.isfinite(out).all())}
    log(f"[sam] encoder forward, batch {b} at {size}²: {ms:.3f} ms, "
        f"{op_calls} relpos calls, {got['relpos_kernels_per_forward']} "
        f"relpos kernels ({got['relpos_ms_per_forward']:.3f} ms), "
        f"{got['port_launches_per_forward']} port launches; {card}")
    want = sum(SAM_PER_STEP.values())
    if op_calls != want or got["relpos_kernels_per_forward"] != want:
        raise AssertionError(f"SAM encoder forward: {op_calls} relpos calls "
                             f"and {got['relpos_kernels_per_forward']} "
                             f"kernels, expected {want} of each")
    if not got["finite"]:
        raise AssertionError("SAM encoder forward: non-finite embedding")
    del model, x, out
    torch.cuda.empty_cache()
    return got


def _sam_entries(sam):
    """Phase 15's entry of the `kernels` line: the relative-position
    attention over one grad-free batch-4 forward of the SAM ViT-H encoder
    (the frozen-encoder step's), its calls, launches and device time
    counted in that forward; the plain version and the bound are the
    per-call rows times the calls counted."""
    rows, enc = sam["shapes"], sam["encoder"]
    share = {r["shape"][-1]: SAM_PER_STEP[r["shape"][-1]]
             / sum(SAM_PER_STEP.values()) for r in rows}

    def total(k):
        return sum(r[k] * share[r["shape"][-1]] * enc["op_calls_per_forward"]
                   for r in rows)

    return [{"name": "relpos_attention", "route": "cuda",
             "source": "mirage_tpu_torch/ops/relpos_attention.py",
             "csrc": [CSRC + "relpos_attention.cu",
                      CSRC + "attention_fwd.cuh"],
             "replaces": "none: the JAX package has no SAM encoder",
             "tpu_kernel": "none",
             "calls_per_step": enc["op_calls_per_forward"],
             "launches_per_step": enc["relpos_kernels_per_forward"],
             "max_abs_err": max(r["max_abs_err"] for r in rows),
             "ms": enc["relpos_ms_per_forward"],
             "kernel_ms": enc["relpos_ms_per_forward"],
             "plain_ms": total("plain_ms"), "bound_ms": total("bound_ms"),
             "bound_by": max(rows, key=lambda r: r["bound_ms"])["bound_by"],
             "encoder_forward_ms": enc["forward_ms"],
             "port_launches_per_forward": enc["port_launches_per_forward"],
             "times_are": "device alone, measured over one grad-free "
                          "batch-4 forward of the SAM ViT-H encoder (the "
                          "frozen-encoder step's); plain and bound: per call "
                          "times the calls counted",
             "shapes": rows}]


PHASES = ("build", "kernels", "golden", "serve", "train", "seg", "cls",
          "infer", "bench", "pretrain", "parallel", "pipeline", "vit",
          "decbatch", "sam")


def main(argv=None):
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES)
                    + " (a partial run prints no result line)")
    ap.add_argument("--mlp-bwd-split", action="store_true",
                    help="only time B5 and B7-MLP at their three shapes and "
                    "split them into launches (mlp_bwd_timing; it runs in an "
                    "older checkout too); prints no result line")
    ap.add_argument("--attn-split", nargs="?", const=str(
                        ROOT / "mirage_tpu_torch" / "csrc"), metavar="CSRC",
                    help="only time the attention forward (csrc/attention.cu"
                    ", csrc/flash_attention.cu, built from CSRC, default this"
                    " checkout's) at its main-path shapes, whole and without "
                    "P·V, the softmax or every product (attn_split); prints "
                    "no result line")
    ap.add_argument("--attn-bwd-split", nargs="?", const=str(
                        ROOT / "mirage_tpu_torch" / "csrc"), metavar="CSRC",
                    help="only time the bf16 attention backward (csrc/"
                    "attention_bwd.cu, csrc/flash_attention.cu, built from "
                    "CSRC, default this checkout's) at its path shapes, whole "
                    "and without the dQ products, the dK/dV kernel, the "
                    "softmax and delta, or every product, and split B4's "
                    "chain into launches (attn_bwd_split); prints no result "
                    "line")
    ap.add_argument("--gemm-split", nargs="?", const=str(
                        ROOT / "mirage_tpu_torch" / "csrc"), metavar="CSRC",
                    help="only time the bf16 and int8 GEMMs (csrc/gemm.cu, "
                    "csrc/quant.cu, built from CSRC, default this checkout's)"
                    " at their path shapes, whole and without the epilogue's "
                    "math, the store or every product, beside torch.matmul, "
                    "the F.linear composition or torch._int_mm, and B9's "
                    "backward (gemm_split); prints no result line")
    ap.add_argument("--multi-card", action="store_true",
                    help="only the paths that exist across cards, on every "
                    "card of the machine: the pipelines over NCCL (data 2 x "
                    "pipe 2, pipe 4; four cards) and the serving mesh over "
                    "the cards (multi_card); prints no result line")
    ap.add_argument("--adamw", action="store_true",
                    help="only the AdamW step over MIRAGE-Base's and -Large's "
                    "pretraining leaves, the leaf table against the foreach "
                    "route (adamw_rows); prints no result line")
    ap.add_argument("--ln-ab", action="store_true",
                    help="only the LN kernel's rows, the bench's headline and "
                    "the bare pretraining step (ln_ab; it runs in an older "
                    "checkout too); prints no result line")
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
    if opts.mlp_bwd_split:
        log(json.dumps({"mlp_bwd": mlp_bwd_timing(), "card": card}))
        return 0
    if opts.ln_ab:
        log(json.dumps({"ln_ab": ln_ab(card), "card": card}))
        return 0
    if opts.adamw:
        log(json.dumps({"adamw": adamw_rows(card)}))
        return 0
    if opts.multi_card:
        phase_build()
        log(json.dumps({"multi_card": multi_card(workdir, card),
                        "card": card}))
        return 0
    if opts.attn_split:
        log(json.dumps({"attn_split": attn_split(opts.attn_split),
                        "card": card}))
        return 0
    if opts.gemm_split:
        log(json.dumps({"gemm_split": gemm_split(opts.gemm_split),
                        "card": card}))
        return 0
    if opts.attn_bwd_split:
        log(json.dumps({"attn_bwd_split": attn_bwd_split(opts.attn_bwd_split),
                        "card": card}))
        return 0

    if "build" in phases:
        phase_build()
    fwd_rows = bwd_rows = seg_rows = golden = train = seg = cls = None
    infer = bench = pretrain = ln_rows = parallel = pipeline = vit = None
    decbatch = adamw = sam = None
    if "kernels" in phases:
        from mirage_tpu_torch.ops.fused_mlp import mlp_block_fwd_stash3d
        from mirage_tpu_torch.ops.quant import mlp_block_q

        fwd_rows = phase_kernels()
        bwd_rows = phase_backward({})
        seg_rows = phase_seg_kernels({})
        acc_pre_rows, acc_cls_rows = phase_acc_kernels()
        adamw = adamw_rows(card)
        # the attention backward kernel's rows on the paths B7-attention
        # (with B6) and B6 in classification take
        acc_pre_rows["attention_bwd"] = bwd_rows["attention_bwd"]
        acc_cls_rows["attention_bwd"] = [
            dict(r, calls_per_step=r["calls_per_cls_step"])
            for r in bwd_rows["attention_bwd"] if "calls_per_cls_step" in r]
        serve_rows = phase_serve_kernels({})
        s8_rows = gemm_s8_rows()
        ln_rows = layernorm_rows()
        op_launches = {"mlp_block_q": mlp_block_q.launches,
                       "mlp_block_fwd_stash3d": mlp_block_fwd_stash3d.launches}
    if "golden" in phases:
        golden = phase_golden(workdir)
    if {"serve", "infer", "decbatch"} & set(phases):
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
    if "bench" in phases:
        bench = phase_bench(card)
    if "pretrain" in phases:
        pretrain = phase_pretrain(workdir, card, train)
    if "parallel" in phases:
        parallel = phase_parallel(workdir, card)
    if "pipeline" in phases:
        pipeline = phase_pipeline(workdir, card)
    if "vit" in phases:
        vit = phase_vit(workdir, card)
    if "decbatch" in phases:
        decbatch = phase_decbatch(workdir, card, large)
    if "sam" in phases:
        sam = phase_sam(card)
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
               + _op_entries(serve_rows, op_launches)
               + _bench_entries(bench)
               + _ln_entries(ln_rows, pretrain)
               + _parallel_entries(parallel, ln_rows)
               + _pipeline_entries(pipeline)
               + _vit_entries(vit)
               + _decbatch_entries(decbatch)
               + _sam_entries(sam))
    log(json.dumps({"golden_max_abs": golden, "throughput": tput,
                    "gemm_s8": s8_rows,
                    "train": train, "seg": seg, "cls": cls, "infer": infer,
                    "bench": bench, "layernorm": ln_rows,
                    "pretrain": pretrain, "parallel": parallel,
                    "pipeline": pipeline, "vit": vit, "decbatch": decbatch,
                    "adamw": adamw, "sam": sam,
                    "seconds": time.perf_counter() - t_start}))
    log(card)
    log(json.dumps({"kernels": entries}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
