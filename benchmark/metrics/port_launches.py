"""port_launches.<mode>: the port's own kernel launches (its ``csrc/``
entries, counted in ``ops/runtime.py:_launch`` toward the open span) a call
of the mode's entry over the traced window; beside ``kernels_per_step``
it splits the device's kernels into the port's and PyTorch's
(``benchmark/spans.py``)."""

from benchmark import spans


def read(rec, mode):
    got = spans.summary(rec, mode)
    if got is None:
        return None
    rows, calls = got
    return sum(r["launches"] for r in rows.values()) / calls
