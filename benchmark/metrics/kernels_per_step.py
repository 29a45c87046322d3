"""kernels_per_step.<mode>: device kernels in the traced window, the port's
and PyTorch's, over the calls of the entry (requests or steps) in it."""


def read(rec, mode):
    if rec["device"]["platform"] != "gpu":  # a device number, never a CPU one
        return None
    t = rec["trace"]
    if rec["mode"] != mode or t is None or not rec["calls"]:
        return None
    return t["kernels"] / rec["calls"]
