"""The port's spans over a traced window, for the readers of the metrics
that the program's own spans and launch counter feed
(``metrics/self_ms.py``, ``metrics/port_launches.py``).

While the profiler runs, ``mirage_tpu_torch/utils/profiling.py`` records
each span of the program (``mirage.<part>``) with its host time and the
port's kernel launches counted to it; its ``summary()`` gives, by span
name, the calls, total and self milliseconds and launches. A step is the
span ``mirage.step``, a request ``mirage.request``. A program without that
recorder (an older checkout) gives nothing, and the readers report
nothing.
"""

# the span of one call of each mode's entry
ROOTS = {"train": "mirage.step", "infer": "mirage.request"}


def summary(rec, mode):
    """(span name -> summary row, the calls of the mode's root span) for a
    traced run of ``mode`` on a card; None off the card, for another mode,
    untraced, or where the program recorded no root span."""
    if rec["device"]["platform"] != "gpu":  # a device run's, never a CPU's
        return None
    if rec["mode"] != mode or rec.get("trace") is None or mode not in ROOTS:
        return None
    try:
        from mirage_tpu_torch.utils import profiling

        rows = profiling.summary()
    except (ImportError, AttributeError):  # a program without spans
        return None
    root = rows.get(ROOTS[mode])
    if not root or not root["calls"]:
        return None
    return rows, root["calls"]
