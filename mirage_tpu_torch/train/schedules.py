"""Learning-rate and weight-decay schedules.

The port's own copy of ``mirage_tpu/train/schedules.py`` (reference
mutils/native_scaler.py:64-88): a per-step array with a linear warmup and a
half cosine, indexed by step on the host.
"""

import math

import numpy as np


def cosine_scheduler(base_value, final_value, epochs, niter_per_ep,
                     warmup_epochs=0, start_warmup_value=0, warmup_steps=-1):
    warmup_schedule = np.array([])
    warmup_iters = warmup_epochs * niter_per_ep
    if warmup_steps > 0:
        warmup_iters = warmup_steps
    if warmup_epochs > 0:
        warmup_schedule = np.linspace(start_warmup_value, base_value,
                                      warmup_iters)
    n = epochs * niter_per_ep - warmup_iters
    iters = np.arange(n)
    schedule = final_value + 0.5 * (base_value - final_value) * (
        1 + np.cos(math.pi * iters / n))
    schedule = np.concatenate((warmup_schedule, schedule))
    assert len(schedule) == epochs * niter_per_ep
    return schedule
