"""self_ms.<mode>_<part>: the host's self time a call of the program's span
``mirage.<part>`` (its time less its child spans'), summed over the traced
window and divided by the calls of the mode's entry (``mirage.step`` or
``mirage.request`` spans); ms. The self times of a mode's spans add up to
the host time of its calls (``benchmark/spans.py``)."""

from benchmark import spans


def read(rec, mode):
    kind, _, part = (mode or "").partition("_")
    got = spans.summary(rec, kind)
    if got is None or not part:
        return None
    rows, calls = got
    row = rows.get(f"mirage.{part}")
    return None if row is None else row["self_ms"] / calls
