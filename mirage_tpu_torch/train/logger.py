"""Training logs: smoothed meters, a per-epoch logger, JSON-lines run logs.

A fork of ``mirage_tpu/train/logger.py`` (reference mutils/logger.py:
SmoothedValue, MetricLogger.log_every with ETA, iteration and data time
and peak device memory; log.txt with one JSON line per epoch). The peak
memory is ``torch.cuda.max_memory_allocated`` on a CUDA run.
"""

import datetime
import json
import os
import time
from collections import defaultdict, deque
from typing import Optional

import numpy as np
import torch


class SmoothedValue:
    def __init__(self, window_size: int = 20,
                 fmt: str = "{median:.4f} ({global_avg:.4f})"):
        self.deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt

    def update(self, value, n: int = 1):
        value = float(value)
        self.deque.append(value)
        self.count += n
        self.total += value * n

    @property
    def median(self):
        return float(np.median(self.deque)) if self.deque else 0.0

    @property
    def avg(self):
        return float(np.mean(self.deque)) if self.deque else 0.0

    @property
    def global_avg(self):
        return self.total / max(self.count, 1)

    @property
    def max(self):
        return max(self.deque) if self.deque else 0.0

    @property
    def value(self):
        return self.deque[-1] if self.deque else 0.0

    def __str__(self):
        return self.fmt.format(median=self.median, avg=self.avg,
                               global_avg=self.global_avg, max=self.max,
                               value=self.value)


def device_peak_memory_mb() -> Optional[float]:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        return torch.cuda.max_memory_allocated() / (1024.0 * 1024.0)
    return None


class MetricLogger:
    def __init__(self, delimiter: str = "  ", print_fn=print):
        self.meters = defaultdict(SmoothedValue)
        self.delimiter = delimiter
        self.print = print_fn

    def update(self, **kwargs):
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def __str__(self):
        return self.delimiter.join(f"{name}: {meter}"
                                   for name, meter in self.meters.items())

    def log_every(self, iterable, print_freq: int, header: str = ""):
        i = 0
        start_time = end = time.time()
        iter_time = SmoothedValue(fmt="{avg:.4f}")
        data_time = SmoothedValue(fmt="{avg:.4f}")
        total = len(iterable) if hasattr(iterable, "__len__") else None
        space = len(str(total)) if total else 6
        for obj in iterable:
            data_time.update(time.time() - end)
            yield obj
            iter_time.update(time.time() - end)
            if i % print_freq == 0 or (total and i == total - 1):
                eta = ""
                if total:
                    eta_s = iter_time.global_avg * (total - i)
                    eta = f"eta: {datetime.timedelta(seconds=int(eta_s))}  "
                mem = device_peak_memory_mb()
                mem_s = f"  mem: {mem:.0f}MB" if mem is not None else ""
                count = f"[{i:{space}d}/{total}]" if total else f"[{i}]"
                self.print(f"{header} {count}  {eta}{self}  "
                           f"time: {iter_time}  data: {data_time}{mem_s}")
            i += 1
            end = time.time()
        total_time = time.time() - start_time
        self.print(f"{header} Total time: "
                   f"{datetime.timedelta(seconds=int(total_time))} "
                   f"({total_time / max(i, 1):.4f} s / it)")


def append_log(output_dir: str, record: dict, filename: str = "log.txt"):
    """One JSON line per epoch."""
    os.makedirs(output_dir, exist_ok=True)
    with open(os.path.join(output_dir, filename), "a") as f:
        f.write(json.dumps(record) + "\n")
