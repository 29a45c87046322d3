"""S3 · scripts/bench_int8.py on the card: does int8 pay on an H100?

``probe_pallas_int8`` (:48) runs an s8·s8 -> s32 dot at (16384, 1024) ·
(1024, 4096), checks it exact against an int32 product and times it;
``time_matmul`` (:17) times int8 against bf16 products at :98-103's four
shapes (the MLP's fc1 and fc2 and the qkv projection at M = 512·257, and a
large square). On the card:

- int8: ``ops/quant.py:gemm_s8`` (B12's wgmma int8 GEMM, csrc/quant.cu,
  storing the raw s32 accumulator), checked bit for bit against the exact
  int32 product, then timed;
- bf16: the port's wgmma GEMM (``runtime.gemm``) with a float32 output, as
  the script's ``preferred_element_type=float32``, checked at the bench's
  bars against the float32 product of the same bf16 operands (and timed
  once more with the bf16 output of the main path's GEMMs);
- the yardsticks ``torch._int_mm`` (cuBLASLt s8·s8 -> s32) and
  ``torch.mm(..., out_dtype=torch.float32)`` (cuBLAS bf16), which the port
  never calls.

Operands are made on the card from seed 0: int8 uniform in [-127, 127),
bf16 standard normal; the weight in the port's (N, K) layout.
"""

import torch

from mirage_tpu_torch import bench
from mirage_tpu_torch.ops import runtime
from mirage_tpu_torch.ops.quant import gemm_s8, gemm_s8_ref

# (M, K, N): bench_int8.py:98-103 and the probe's :48; the dry run's
SHAPES = [(512 * 257, 1024, 4096), (512 * 257, 4096, 1024),
          (512 * 257, 1024, 3072), (16384, 8192, 8192)]
PROBE = (16384, 1024, 4096)
TINY_SHAPES, TINY_PROBE = [(40, 64, 32)], (48, 32, 64)
REPLACES = "scripts/bench_int8.py:64"


def operands(m, k, n, device):
    g = torch.Generator(device=device).manual_seed(0)
    a = torch.randint(-127, 127, (m, k), generator=g, device=device,
                      dtype=torch.int8)
    w = torch.randint(-127, 127, (n, k), generator=g, device=device,
                      dtype=torch.int8)
    ab = torch.randn(m, k, generator=g, device=device).to(torch.bfloat16)
    wb = torch.randn(n, k, generator=g, device=device).to(torch.bfloat16)
    return a, w, ab, wb


def bounds(m, k, n):
    """{"int8": (ms, by), "bf16": (ms, by)}: 2·M·N·K operations at each
    type's peak; bytes: the operands once and the 4-byte (M, N) output."""
    ops = 2 * m * n * k
    return {"int8": bench.bound(ops, m * k + n * k + 4 * m * n,
                                bench.PEAK_INT8_OPS),
            "bf16": bench.bound(ops, 2 * (m * k + n * k) + 4 * m * n)}


@torch.no_grad()
def run(size="large", device="cuda", measure=True):
    """One row per shape (the probe's first): int8 and bf16, each checked
    then timed, beside their bounds and the library calls."""
    shapes = ([bench.sizes(size, PROBE, TINY_PROBE)]
              + bench.sizes(size, SHAPES, TINY_SHAPES))
    rows = []
    for m, k, n in shapes:
        a, w, ab, wb = operands(m, k, n, device)
        got = gemm_s8(a, w)
        with runtime.plain_on_card():
            want = gemm_s8_ref(a, w)
        exact = bool(torch.equal(got, want))
        max_abs = (got.double() - want.double()).abs().max().item()
        del got, want
        if not exact:
            raise AssertionError(f"S3 gemm_s8 {(m, k, n)}: not exact "
                                 f"(max-abs {max_abs})")
        bf16 = (lambda: runtime.gemm(ab, wb, out_dtype=torch.float32)
                if measure else ab.float() @ wb.float().t())
        err = bench.check(f"S3 bf16 gemm {(m, k, n)}", bf16(),
                          ab.float() @ wb.float().t(), max_abs=float("inf"))
        b = bounds(m, k, n)
        row = {"case": f"S3 int8 {(m, k, n)}", "op": "gemm_s8",
               "replaces": REPLACES, "shape": [m, k, n],
               "probe": (m, k, n) == shapes[0], "max_abs_err": max_abs,
               "exact": exact, "bf16_rel_l2_err": err["rel_l2_err"],
               "bound_ms": b["int8"][0], "bound_by": b["int8"][1],
               "bf16_bound_ms": b["bf16"][0], "bf16_bound_by": b["bf16"][1]}
        if not measure:
            rows.append({**row, "measured": False})
            continue
        start = runtime.launch_counts()
        ms = bench.cuda_ms(lambda: gemm_s8(a, w), iters=10)
        launches = dict(runtime.launch_counts() - start)
        with runtime.plain_on_card():
            plain_ms = bench.cuda_ms(lambda: gemm_s8(a, w), iters=2,
                                     warmup=1)
        library_ms = bench.cuda_ms(lambda: torch._int_mm(a, w.t()), iters=10)
        bf16_ms = bench.cuda_ms(bf16, iters=10)
        bf16_out_ms = bench.cuda_ms(lambda: runtime.gemm(ab, wb), iters=10)
        bf16_library_ms = bench.cuda_ms(
            lambda: torch.mm(ab, wb.t(), out_dtype=torch.float32), iters=10)
        rows.append({**row, "ms": ms, "plain_ms": plain_ms,
                     "library_ms": library_ms, "bf16_ms": bf16_ms,
                     "bf16_bf16_out_ms": bf16_out_ms,
                     "bf16_library_ms": bf16_library_ms,
                     "int8_speedup_over_bf16": bf16_ms / ms,
                     "int8_tops": 2 * m * n * k / ms / 1e9,
                     "bf16_tflops": 2 * m * n * k / bf16_ms / 1e9,
                     "launches": launches,
                     "library": "torch._int_mm (cuBLASLt s8·s8 -> s32)",
                     **bench.card()})
        del a, w, ab, wb
    return rows
