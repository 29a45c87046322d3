"""S5 · scripts/bench_vpu.py on the card: what B1's and B2's stages that are
not products cost.

The script times ablations of the two halves at (64, 257, 1024, 16), each
a 24-layer chain, replacing one stage with cheap (and, for "skip", wrong)
math to expose its cost:

- ``make_attn`` (:215) → ``_attn_kernel_v`` (:44): B1 in three phases
  (every head's scores, one softmax, every P·V) with ``ln`` two-pass
  ("v0"), ``onepass`` or ``skip`` (y = x) and ``smax`` ``exp`` ("v0"),
  ``exp2``, ``nomax`` or ``skip`` (P = the raw scores, l = their sum);
- ``make_attn_pipe2`` (:140) → ``_attn_kernel_pipe2`` (:88): "v0" with two
  batch elements per program, one's products between the other's softmax;
- ``make_mlp`` (:272) → ``_mlp_kernel_v`` (:240): B2 with ``ln`` as above
  and ``act`` A&S 7.1.26 ("v0", the script's ``_erf``), ``hastings`` (A&S
  7.1.28), ``skip`` (no activation) and ``bf16`` (the A&S polynomial in
  bf16, which the script never ran on its TPU, :345);
- ``make_mlp_pipe2`` (:194) → ``_mlp_kernel_pipe2`` (:167): "v0" two
  elements at a time.

On the card the attention cases are ``attn_half_block_phased`` with all 16
heads in one group (csrc/attention_phased.cu: a cluster of 8 CTAs; the
softmax mode a run-time switch over code specialised per mode, the LN
kernel's one-pass mode, no LN launch for "skip"), the MLP
cases ``mlp_block_modes`` (csrc/gemm.cu's GELU epilogue instantiated per
formula; the plain epilogue for "skip"). The two "pipe2" cases compute the
"v0" function: a CUDA launch already overlaps the batch elements across
its CTAs, so they run the same chains, and their rows say so.

Each case is held to its plain version of the same mode in float32 on the
same bf16 inputs at the bench's bars, except ``smax=skip``: its division by
the sum of raw scores is ill-conditioned by construction, so its attention
core is held to its plain version on the unnormalised P·V before the
division (rel-L2 1e-2, max-abs 2 % of the largest element), and its row
says so. Each row gives its time less "v0"'s: the cost of the stage it
replaces.
"""

import torch

from mirage_tpu_torch import bench
from mirage_tpu_torch.nn.layers import linear
from mirage_tpu_torch.ops import runtime
from mirage_tpu_torch.ops.block_attention import (attn_half_block_phased,
                                                  attn_half_block_phased_ref,
                                                  ln_mode_ref,
                                                  phased_attention_ref)
from mirage_tpu_torch.ops.fused_mlp import (mlp_block_modes,
                                            mlp_block_modes_ref)

REPS = 24  # bench_vpu.py:26
# (batch, tokens, width, heads): bench_vpu.py:312, and the dry run's
SHAPE, TINY = (64, 257, 1024, 16), (2, 17, 64, 4)
# bench_vpu.py:328-350: (tag, modes), in the script's order, then act=bf16
ATTN_CASES = [("v0", {}), ("ln-skip", {"ln": "skip"}),
              ("ln-onepass", {"ln": "onepass"}),
              ("smax-skip", {"smax": "skip"}),
              ("smax-nomax", {"smax": "nomax"}),
              ("smax-exp2", {"smax": "exp2"}), ("pipe2", {})]
MLP_CASES = [("v0", {}), ("ln-skip", {"ln": "skip"}),
             ("ln-onepass", {"ln": "onepass"}), ("act-skip", {"act": "skip"}),
             ("act-hastings", {"act": "hastings"}),
             ("act-bf16", {"act": "bf16"}), ("pipe2", {})]
REPLACES = {"attn": "scripts/bench_vpu.py:44",
            "attn-pipe2": "scripts/bench_vpu.py:88",
            "mlp": "scripts/bench_vpu.py:240",
            "mlp-pipe2": "scripts/bench_vpu.py:167"}
PIPE2 = ("two batch elements per TPU program; a CUDA launch overlaps the "
         "batch elements across its CTAs, so this is the v0 chain")
SKIP_CHECK = ("smax=skip divides by the sum of raw scores (ill-conditioned "
              "by construction): held to its plain version on the "
              "unnormalised P·V before the division")


def _check_skip_core(x, p, h):
    """smax=skip's attention core against its plain version before the
    division, on the qkv of the case's bf16 inputs."""
    b, n, d = x.shape
    with runtime.plain_on_card():
        qkv = linear(ln_mode_ref(x, *p[:2], "two_pass"), *p[2:4])
        want = phased_attention_ref(qkv.float(), h, "skip", divide=False)
    if runtime.use_kernel(x):
        got = qkv.new_empty(b, n, d)
        runtime.attention_phased(qkv, qkv[:, :, d:], qkv[:, :, 2 * d:], got,
                                 heads=h, dh=d // h, group=h,
                                 scale=(d // h) ** -0.5, smax="skip",
                                 divide=False)
    else:
        got = phased_attention_ref(qkv, h, "skip", divide=False)
    return bench.check("S5 smax=skip unnormalised P·V", got, want,
                       max_abs=2e-2 * want.abs().max().item())


@torch.no_grad()
def run(size="large", device="cuda", measure=True):
    """Rows: every attention and MLP case of the script, checked, then
    timed, with its time less v0's."""
    shape = bench.sizes(size, SHAPE, TINY)
    b, n, d, h = shape
    x, attn_p, mlp_p = bench.half_inputs(shape, device, 0.02)  # :314
    f32 = lambda ts: [t.float() for t in ts]  # noqa: E731
    rows = []
    for which, cases in (("attn", ATTN_CASES), ("mlp", MLP_CASES)):
        op = attn_half_block_phased if which == "attn" else mlp_block_modes
        v0_ms = None
        for tag, modes in cases:
            if which == "attn":
                def fn(modes=modes):
                    return attn_half_block_phased(x, *attn_p, h, h, **modes)
                def want_fn(modes=modes):
                    return attn_half_block_phased_ref(
                        x.float(), *f32(attn_p), h, h, **modes)
                def library():
                    return bench.library_attn_half(x, *attn_p, h)
            else:
                def fn(modes=modes):
                    return mlp_block_modes(x, *mlp_p, **modes)
                def want_fn(modes=modes):
                    return mlp_block_modes_ref(x.float(), *f32(mlp_p),
                                               **modes)

                def library():
                    return bench.library_mlp(x, *mlp_p)
            name = f"S5 {which}/{tag}"
            if modes.get("smax") == "skip":
                err = _check_skip_core(x, attn_p, h)
                fn()
            else:
                got = fn()
                with runtime.plain_on_card():
                    want = want_fn()
                err = bench.check(name, got, want)
            key = which + ("-pipe2" if tag == "pipe2" else "")
            bound_ms, bound_by = bench.bound(*bench.half_work(b, n, d, which))
            row = {"case": f"S5 vpu {which}/{tag}", "op": op.__name__,
                   "replaces": REPLACES[key], "shape": list(shape),
                   "modes": {"ln": "two_pass", **({"smax": "exp"} if which ==
                                                  "attn" else {"act": "as26"}),
                             **modes},
                   "bound_ms": bound_ms, "bound_by": bound_by, **err}
            if which == "attn":
                row["heads_per_block"] = h
            if tag == "pipe2":
                row["pipe2"] = PIPE2
            if modes.get("smax") == "skip":
                row["check"] = SKIP_CHECK
            if not measure:
                rows.append({**row, "measured": False})
                continue
            timed = bench.time_op(fn, library, REPS)
            if tag == "v0":
                v0_ms = timed["ms"]
            rows.append({**row, **timed, "minus_v0_ms": timed["ms"] - v0_ms})
    return rows
