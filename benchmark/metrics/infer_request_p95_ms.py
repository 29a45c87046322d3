"""infer_request_p95_ms: the 95th percentile, over every request of the
window, of its time from the call to its outputs being ready on the card
(linear interpolation between order statistics)."""

import numpy as np


def read(rec, mode):
    if rec["mode"] != "infer" or not rec["latencies_ms"]:
        return None
    return float(np.percentile(rec["latencies_ms"], 95))
