"""What a traced window says: the device's busy time, its kernels, the
host's dispatch time a call, and where the time went.

The profiler records CUDA activity only (kernels, copies and sets on the
device, and the CUDA runtime and driver calls on the host): no per-op
host events, whose cost would slow a host-paced step under the trace.
The window and each call of the entry (a request, or a step) are bracketed
by the benchmark's own ``time.time_ns()`` readings, the clock the
profiler's timestamps are in. :func:`reduce` reads the raw events
(kineto's, without building the profiler's per-op tables, which at a
million events would take minutes): the busy time is the union of the
device intervals inside the window; blocking CUDA calls are the runtime's
synchronisations and synchronous copies, whose time inside a call is the
host waiting for the card.
"""

import numpy as np

TOP = 10


def _blocking(name):
    return "Synchronize" in name or name in ("cudaMemcpy", "cuMemcpy",
                                             "cuMemcpyDtoH_v2")


def _is_runtime(name):
    return name.startswith("cuda") or (name.startswith("cu")
                                       and name[2:3].isupper())


def _annotation(ev):
    """A ``record_function`` range mirrored on the device, not work."""
    flag = getattr(ev, "is_user_annotation", None)
    return bool(flag()) if flag is not None else False


def _union(starts, ends):
    """Merged [start, end) intervals of the given ones, sorted."""
    if not len(starts):
        return np.zeros(0), np.zeros(0)
    order = np.argsort(starts, kind="stable")
    s, e = starts[order], ends[order]
    run_end = np.maximum.accumulate(e)
    new = np.ones(len(s), dtype=bool)
    new[1:] = s[1:] > run_end[:-1]
    idx = np.flatnonzero(new)
    m_start = s[idx]
    m_end = np.append(run_end[idx[1:] - 1], run_end[-1])
    return m_start, m_end


def reduce(prof, window, calls):
    """{window_s, busy_s, kernels, dispatch_ms, device_ops, idle_gaps} of a
    finished ``torch.profiler.profile``, for the window (start, end) and
    the calls [(start, end)] in ``time.time_ns()``."""
    events = prof.profiler.kineto_results.events()
    dev_s, dev_e, dev_name = [], [], []
    host = []  # (start, end, name) of the CUDA calls on the host
    for ev in events:
        name = ev.name()
        start = ev.start_ns()
        end = start + ev.duration_ns()
        if str(ev.device_type()).endswith("CPU"):
            if _is_runtime(name):
                host.append((start, end, name))
        elif not _annotation(ev):
            dev_s.append(start)
            dev_e.append(end)
            dev_name.append(name)
    ws, we = window
    dev_s = np.asarray(dev_s, dtype=np.int64)
    dev_e = np.asarray(dev_e, dtype=np.int64)
    inside = (dev_e > ws) & (dev_s < we)
    if len(dev_s) and not inside.any():
        raise RuntimeError("device events lie outside the window: the "
                           "profiler's clock is not time.time_ns()")
    names = [n for n, k in zip(dev_name, inside) if k]
    s = np.clip(dev_s[inside], ws, we)
    e = np.clip(dev_e[inside], ws, we)
    kernels = sum(1 for n in names
                  if not n.startswith(("Memcpy", "Memset")))
    m_start, m_end = _union(s, e)
    busy_ns = int((m_end - m_start).sum())

    by_name = {}
    for n, d in zip(names, (e - s).tolist()):
        by_name[n] = by_name.get(n, 0) + d
    device_ops = [[n, d / 1e9] for n, d in
                  sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]]

    # idle gaps: between merged device intervals, and at the window's ends,
    # named by the CUDA call the host was in at the gap's middle
    edges_s = np.concatenate([[ws], m_end])
    edges_e = np.concatenate([m_start, [we]])
    gaps = edges_e - edges_s
    h_s = np.asarray([h[0] for h in host], dtype=np.int64)
    h_e = np.asarray([h[1] for h in host], dtype=np.int64)
    idle_gaps = []
    for i in np.argsort(-gaps, kind="stable")[:TOP]:
        if gaps[i] <= 0:
            break
        mid = (edges_s[i] + edges_e[i]) // 2
        hit = np.flatnonzero((h_s <= mid) & (h_e >= mid))
        label = ("host in " + host[hit[np.argmax(h_s[hit])]][2]) if len(hit) \
            else "host in Python, no CUDA call"
        idle_gaps.append([label, float(gaps[i]) / 1e9])

    block = [i for i, h in enumerate(host) if _blocking(h[2])]
    b_s, b_e = h_s[block], h_e[block]
    dispatch = []
    for cs, ce in calls:
        held = np.clip(np.minimum(b_e, ce) - np.maximum(b_s, cs), 0, None)
        dispatch.append((ce - cs - int(held.sum())) / 1e6)
    return {"window_s": (we - ws) / 1e9, "busy_s": busy_ns / 1e9,
            "kernels": kernels,
            "dispatch_ms": float(np.mean(dispatch)) if dispatch else None,
            "device_ops": device_ops, "idle_gaps": idle_gaps}
