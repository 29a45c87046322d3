"""peak_mem_gib.<mode>: torch.cuda.max_memory_allocated() over the window,
after reset_peak_memory_stats(), in GiB."""


def read(rec, mode):
    if rec["device"]["platform"] != "gpu":  # a device number, never a CPU one
        return None
    if rec["mode"] != mode or rec["peak_window_bytes"] is None:
        return None
    return rec["peak_window_bytes"] / 2 ** 30
