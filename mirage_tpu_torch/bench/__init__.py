"""The port's bench: what the JAX package's bench scripts time, on the card.

    python -m mirage_tpu_torch.bench            # the headline (bench.py)
    python -m mirage_tpu_torch.bench --all      # and the five train rows
    python -m mirage_tpu_torch.bench --ab       # the A/B cases S1-S7

Each module is named after the JAX file it ports: ``__main__`` (bench.py:
MIRAGE-Large reconstruction at batch 512), ``train`` (scripts/
bench_train.py's pretraining, seg and cls rows), ``attn2`` (S1, scripts/
bench_attn2.py), ``attn_half`` (S2, scripts/bench_attn_half.py), ``int8``
(S3, scripts/bench_int8.py), ``lnfold`` (S4, scripts/bench_lnfold.py),
``vpu`` (S5, scripts/bench_vpu.py), ``overlap`` (S6, scripts/
bench_overlap.py) and ``pad264`` (S7, scripts/bench_pad264.py). Every A/B
case is checked against its plain version before it is timed. A
measurement runs on the card only: without one the bench exits non-zero,
and ``--dry-run --device cpu`` runs the same code at a tiny size and prints
rows marked ``"measured": false`` with no time in them.

This module holds what the cases share: the card's name and power limit,
CUDA-event timing, the bound of a call and the agreement bars.
"""

import functools
import subprocess

import torch

# H100 SXM, dense (NVIDIA's data sheet): bf16 and int8 tensor-core rates,
# device-memory rate
PEAK_BF16_FLOPS, PEAK_INT8_OPS, PEAK_BYTES = 989e12, 1979e12, 3.35e12
# a bf16 kernel against its float32 plain version on the same bf16 inputs
# (the bars chip_smoke.py holds every forward op to): max-abs and rel-L2
BF16_MAX_ABS, BF16_REL_L2 = 5e-2, 1e-2


@functools.lru_cache(maxsize=1)
def card():
    """{"device": name, "power_limit": as nvidia-smi reports it}."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return {"device": torch.cuda.get_device_name(0),
            "power_limit": out.strip().splitlines()[0].rsplit(",", 1)[1]
            .strip()}


def cuda_ms(fn, iters=20, warmup=3, repeats=3):
    """Milliseconds per call of ``fn`` from CUDA events around ``iters``
    calls, the median of ``repeats`` such runs, after ``warmup`` calls."""
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


def chain_ms(fn, x, iters):
    """Milliseconds per call of ``x = fn(x)`` chained ``iters`` times (each
    call takes the last one's output, as the JAX scripts chain them), after
    one warm-up call."""
    fn(x)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        x = fn(x)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_op(fn, library, iters):
    """The timed fields of an A/B row: ``fn``'s ms per call, its plain
    version's (the same call under ``runtime.plain_on_card``), the library
    yardstick's, the C entries the timed calls launched (entry ->
    launches), and the card."""
    from mirage_tpu_torch.ops import runtime

    start = runtime.launch_counts()
    ms = cuda_ms(fn, iters=iters)
    launches = dict(runtime.launch_counts() - start)
    with runtime.plain_on_card():
        plain_ms = cuda_ms(fn, iters=2, warmup=1)
    return {"ms": ms, "plain_ms": plain_ms,
            "library_ms": cuda_ms(library, iters=iters),
            "launches": launches, "ms_per_24_layers": ms * 24, **card()}


def half_inputs(shape, device, x_scale, dtype=torch.bfloat16):
    """The JAX scripts' inputs of one half-block (bench_vpu.py:313-324 and
    its siblings): x = x_scale·randn (B, N, D) from seed 1, and unit LN,
    zero biases and 0.02-scaled weights in torch Linear layout from seed 0:
    (x, attention (γ, β, Wqkv, bqkv, Wproj, bproj), MLP (γ, β, W1, b1, W2,
    b2))."""
    b, n, d = shape[:3]
    x = (torch.randn(b, n, d, generator=torch.Generator().manual_seed(1))
         * x_scale).to(device, dtype)
    g = torch.Generator().manual_seed(0)

    def rn(*s):
        return (torch.randn(*s, generator=g) * 0.02).to(device, dtype)

    ones = torch.ones(d, device=device, dtype=dtype)
    zeros = torch.zeros(d, device=device, dtype=dtype)
    attn = (ones, zeros, rn(3 * d, d), zeros.repeat(3), rn(d, d), zeros)
    mlp = (ones, zeros, rn(4 * d, d), zeros.repeat(4), rn(d, 4 * d), zeros)
    return x, attn, mlp


def half_work(b, n, d, which):
    """(FLOPs, bytes) of one attention or MLP half over (b, n, d): the
    products (and 4·b·n²·d of attention), x and out once, the weights and
    vectors once, in bf16."""
    m = b * n
    if which == "attn":
        return (2 * m * d * 4 * d + 4 * b * n * n * d,
                2 * (2 * m * d + 4 * d * d + 6 * d))
    return 2 * m * d * 8 * d, 2 * (2 * m * d + 8 * d * d + 7 * d)


def bound(flops, nbytes, peak=PEAK_BF16_FLOPS):
    """(ms, "operations" | "bytes"): the least time the card could take,
    the larger of the operations over the peak rate and the bytes (each
    input read once, each output written once) over the memory rate."""
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def agreement(got, want):
    """max-abs and rel-L2 error of ``got`` against ``want``, in float."""
    d = got.float() - want.float()
    return {"max_abs_err": d.abs().max().item(),
            "rel_l2_err": (d.norm() / want.float().norm()).item()}


def check(name, got, want, max_abs=BF16_MAX_ABS, rel_l2=BF16_REL_L2):
    """The agreement of ``got`` with ``want``; raises above the bars or on
    a non-finite value."""
    err = agreement(got, want)
    if not (err["max_abs_err"] <= max_abs and err["rel_l2_err"] <= rel_l2
            and bool(torch.isfinite(got.float()).all())):
        raise AssertionError(f"{name}: {err} above the bars (max-abs "
                             f"{max_abs}, rel-L2 {rel_l2}) or not finite")
    return err


def sizes(size, full, tiny):
    """The case's shape at ``size``: "large" (the JAX script's own) or
    "tiny" (the CPU dry run)."""
    if size not in ("large", "tiny"):
        raise ValueError(f"size {size!r} is not 'large' or 'tiny'")
    return full if size == "large" else tiny


# ------------------------------------------------- the library yardsticks
# The same functions from PyTorch library calls (F.layer_norm, F.linear,
# F.gelu, F.scaled_dot_product_attention): timed beside the port's kernels,
# never called by the port.

def library_attn_half(x, ln_w, ln_b, wqkv, bqkv, wproj, bproj, num_heads,
                      n_valid=None, y=None):
    """x + proj(SDPA(qkv)), qkv from LN(x) (or from ``y``), the keys and
    values of the first ``n_valid`` rows."""
    import torch.nn.functional as F

    b, n, d = x.shape
    if y is None:
        y = F.layer_norm(x, (d,), ln_w, ln_b, 1e-6)
    q, k, v = F.linear(y, wqkv, bqkv).view(b, n, 3, num_heads,
                                            d // num_heads).permute(
        2, 0, 3, 1, 4)
    if n_valid is not None:
        k, v = k[:, :, :n_valid], v[:, :, :n_valid]
    o = F.scaled_dot_product_attention(q, k, v)
    return x + F.linear(o.transpose(1, 2).reshape(b, n, d), wproj, bproj)


def library_mlp(x, ln_w, ln_b, w1, b1, w2, b2):
    """x + fc2(GELU(fc1(LN(x))))."""
    import torch.nn.functional as F

    y = F.layer_norm(x, (x.shape[-1],), ln_w, ln_b, 1e-6)
    return x + F.linear(F.gelu(F.linear(y, w1, b1)), w2, b2)
