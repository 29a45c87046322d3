"""dispatch_ms.<mode>: the host's time a call of the entry (a request, or
a step), from the call to its return, less the time it spent blocked in
CUDA calls that wait for the card; the mean over the traced window's
calls."""


def read(rec, mode):
    t = rec["trace"]
    if rec["mode"] != mode or t is None:
        return None
    return t["dispatch_ms"]
