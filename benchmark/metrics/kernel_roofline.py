"""kernel_roofline.<mode>: the least time the window's work could take on
the card (benchmark/work.py: per op, max(FLOPs / peak, bytes / bandwidth),
counted from shapes whatever implements them) over the time the device was
busy in the traced window, in %."""


def read(rec, mode):
    if rec["device"]["platform"] != "gpu":  # a device number, never a CPU one
        return None
    t = rec["trace"]
    if rec["mode"] != mode or t is None or not t["busy_s"]:
        return None
    return rec["least_s"] / t["busy_s"] * 100.0
