"""relpos_attn_roofline.<mode>: the least time of the window's calls of the
relative-position attention (benchmark/work_sam.py: per call, max(FLOPs /
peak, bytes / bandwidth), counted from shapes whatever implements it) over
the device time of its kernels (names starting ``relpos_attn``) in the
traced window, in %. Nothing where no such kernel ran."""


def read(rec, mode):
    if rec["device"]["platform"] != "gpu":  # a device number, never a CPU one
        return None
    if rec["mode"] != mode or rec.get("trace") is None:
        return None
    seconds, least = rec.get("relpos_attn_s"), rec.get("relpos_attn_least_s")
    if not seconds or least is None:
        return None
    return least / seconds * 100.0
