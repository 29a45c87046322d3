"""idle_pct.<mode>: the share of the traced window in which no operation
ran on the device, in %."""


def read(rec, mode):
    if rec["device"]["platform"] != "gpu":  # a device number, never a CPU one
        return None
    t = rec["trace"]
    if rec["mode"] != mode or t is None or not t["window_s"]:
        return None
    return (1.0 - t["busy_s"] / t["window_s"]) * 100.0
