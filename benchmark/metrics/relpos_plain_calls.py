"""relpos_plain_calls.<mode>: the calls of the relative-position attention
that took its plain PyTorch version (the ``relpos_attn_plain`` tallies of
the program's spans, ``ops/relpos_attention.py``) a call of the mode's
entry over the traced window; the frozen encoder's should take the kernel
(``relpos_attn_kernel``) every time. Nothing where the program tallied
neither route (``benchmark/spans.py``)."""

from benchmark import spans

ROUTES = ("relpos_attn_plain", "relpos_attn_kernel")


def read(rec, mode):
    got = spans.summary(rec, mode)
    if got is None:
        return None
    rows, calls = got
    counts = [r.get("counts") or {} for r in rows.values()]
    if not any(k in c for c in counts for k in ROUTES):
        return None
    return sum(c.get(ROUTES[0], 0) for c in counts) / calls
