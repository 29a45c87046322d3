"""Profiler traces and named spans.

Counterpart of ``mirage_tpu/utils/profiling.py`` on ``torch.profiler``:
:func:`trace` writes a Chrome trace of the host and, where a card is
present, the device into a directory (TensorBoard's and Perfetto's format),
or does nothing for no directory; :func:`annotate` names a span in it.
"""

import contextlib
import os
from typing import Optional


@contextlib.contextmanager
def trace(log_dir: Optional[str]):
    """Traces the block into ``log_dir`` (nothing when it is empty)."""
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield


def annotate(name: str):
    """A named span of host work (``torch.profiler.record_function``)."""
    from torch.profiler import record_function

    return record_function(name)
