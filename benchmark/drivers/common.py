"""What every driver shares: the clock, the traced window, the device's
record, and freeing the program before the reference runs."""

import contextlib
import gc
import sys
import time

import torch

from benchmark import peaks, trace


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class Window:
    """The measured window: opened after set-up, under the profiler when
    ``traced``; :meth:`call` brackets each call of the entry. Once closed,
    ``seconds`` is its length on the host clock, ``peak_bytes`` the
    device's peak allocation in it, and ``facts`` the reduced trace."""

    def __init__(self, device, traced):
        self.device, self.traced = torch.device(device), traced
        self.prof = None
        self.facts = None
        self.calls = []

    def __enter__(self):
        # set-up's objects leave the collector's generations, so the
        # window's collections do not walk them
        gc.collect()
        gc.freeze()
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        if self.traced:
            act = torch.profiler.ProfilerActivity
            self.prof = torch.profiler.profile(activities=[
                act.CUDA if self.device.type == "cuda" else act.CPU])
            self.prof.__enter__()
        sync(self.device)
        self.ns0 = time.time_ns()
        self.t0 = time.perf_counter()
        return self

    def done(self):
        """Seconds since the window opened."""
        return time.perf_counter() - self.t0

    @contextlib.contextmanager
    def call(self):
        """One call of the entry, from the call to its return."""
        start = time.time_ns()
        yield
        if self.traced:
            self.calls.append((start, time.time_ns()))

    def __exit__(self, *exc):
        sync(self.device)
        self.seconds = time.perf_counter() - self.t0
        gc.unfreeze()
        ns1 = time.time_ns()
        self.peak_bytes = (torch.cuda.max_memory_allocated()
                           if self.device.type == "cuda" else None)
        if self.device.type == "cuda":  # the card's state, for the record
            print("card at the window's end (clocks.sm, power.draw, "
                  "temperature.gpu): " + str(peaks.query(
                      "clocks.sm,power.draw,temperature.gpu")),
                  file=sys.stderr)
        if self.traced:
            self.prof.__exit__(*exc)
            if exc[0] is None:
                self.facts = trace.reduce(self.prof, (self.ns0, ns1),
                                          self.calls)
            self.prof = None
        return False


def device_record(device, window):
    """The result's ``device``: platform, card name, count, the peak
    memory of the run so far, and with a trace its busy and window time."""
    dev = torch.device(device)
    if dev.type == "cuda":
        rec = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
               "count": 1,
               "memory_peak_bytes": torch.cuda.max_memory_allocated(),
               "power_limit": peaks.power_limit()}
    else:
        rec = {"platform": "cpu", "kind": "cpu", "count": 1,
               "memory_peak_bytes": 0}
    if window.facts is not None:
        rec["busy_s"] = window.facts["busy_s"]
        rec["window_s"] = window.facts["window_s"]
    return rec


def breakdown(window):
    if window.facts is None:
        return None
    return {"device_ops": window.facts["device_ops"],
            "idle_gaps": window.facts["idle_gaps"]}


def free():
    """Returns the program's freed memory to the card."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def worst_gap(prog, ref):
    """max over leaves of |prog − ref| / max(ref, the median of ref): the
    gap between two norms of each leaf against the larger of the
    reference's norm and the median leaf's."""
    import statistics

    med = statistics.median(ref.values())
    worst = 0.0
    for n, r in ref.items():
        gap = abs(prog[n] - r) / max(r, med, 1e-30)
        worst = max(worst, gap if gap == gap else float("inf"))
    return worst
