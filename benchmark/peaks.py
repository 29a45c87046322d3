"""The card's peaks and the least time of a piece of work.

NVIDIA H100 SXM, dense rates without sparsity, from NVIDIA's data sheet:
989 TFLOP/s in bf16 on the tensor cores and 3.35 TB/s of HBM3, at the full
700 W power limit. A run reports the card's name and power limit beside
its numbers, since a card held below 700 W runs slower under load.
"""

import subprocess

PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12


def bound(flops, nbytes, peak=PEAK_BF16_FLOPS):
    """(ms, "operations" | "bytes"): the least time the card could take,
    the larger of the operations over the peak rate and the bytes over the
    memory rate."""
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def query(fields="power.limit"):
    """nvidia-smi's reading of ``fields`` on the first card, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return out.strip().splitlines()[0].strip() if out.strip() else None


def power_limit():
    """The card's power limit as nvidia-smi reports it, or None."""
    return query("power.limit")
