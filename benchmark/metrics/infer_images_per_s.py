"""infer_images_per_s: B-scans of every request completed in the window,
over the window's time (host clock, ended by a synchronize)."""


def read(rec, mode):
    if rec["mode"] != "infer":
        return None
    return rec["units"] / rec["window_s"]
