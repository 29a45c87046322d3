"""mfu.<mode>: the model FLOPs the window's calls needed (benchmark/work.py:
the forward, and in training the gradients the configuration takes; no
recomputation) over the window's time, as a share of the card's bf16
dense peak, in %. The window is the traced run's."""

from benchmark import peaks


def read(rec, mode):
    if rec["device"]["platform"] != "gpu":  # a device number, never a CPU one
        return None
    if rec["mode"] != mode or rec["trace"] is None:
        return None
    return rec["flops"] / rec["window_s"] / peaks.PEAK_BF16_FLOPS * 100.0
