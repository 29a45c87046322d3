"""Batched data loading with threaded prefetch.

A fork of ``mirage_tpu/data/loader.py``: fixed-shape numpy batches built on
a thread pool, one ``np.random.Generator`` per (epoch, sample) derived from
a base seed, so the shuffle order and the augmentation draws do not depend
on worker scheduling. The training loop moves a batch to the device.
"""

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Iterator

import numpy as np


def default_collate(items):
    """Stacks a list of samples: dicts, tuples and arrays recursively."""
    first = items[0]
    if isinstance(first, dict):
        return {k: np.stack([it[k] for it in items]) for k in first}
    if isinstance(first, tuple):
        return tuple(default_collate([it[i] for it in items])
                     for i in range(len(first)))
    if isinstance(first, np.ndarray):
        return np.stack(items)
    if first is None:
        return None
    return np.asarray(items)


class DataLoader:
    def __init__(self, dataset, batch_size: int, *, shuffle: bool = False,
                 drop_last: bool = False, num_workers: int = 8, seed: int = 0,
                 collate_fn: Callable = default_collate, prefetch: int = 2):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.seed = seed
        self.collate_fn = collate_fn
        self.prefetch = prefetch
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def _epoch_indices(self) -> np.ndarray:
        n = len(self.dataset)
        if self.shuffle:
            return np.random.default_rng((self.seed, self.epoch)).permutation(n)
        return np.arange(n)

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last \
            else -(-n // self.batch_size)

    def __iter__(self) -> Iterator[Any]:
        indices = self._epoch_indices()
        nb = len(self)
        batches = [indices[i * self.batch_size:(i + 1) * self.batch_size]
                   for i in range(nb)]
        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def fetch_one(i: int):
            def load(j):
                rng = np.random.default_rng((self.seed, self.epoch, 1, int(j)))
                return self.dataset[(int(j), rng)]

            return self.collate_fn([load(j) for j in batches[i]])

        def safe_put(item) -> bool:
            """A bounded put that gives up once the consumer has left."""
            while not stop.is_set():
                try:
                    out_q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer(pool):
            window = self.num_workers + self.prefetch
            try:
                futures, next_submit = {}, 0
                for i in range(nb):
                    while next_submit < nb and next_submit < i + window:
                        futures[next_submit] = pool.submit(fetch_one,
                                                           next_submit)
                        next_submit += 1
                    if not safe_put(("ok", futures.pop(i).result())):
                        return
            except BaseException as e:  # handed to the consumer
                safe_put(("err", e))
            finally:
                safe_put(("end", None))

        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            t = threading.Thread(target=producer, args=(pool,), daemon=True)
            t.start()
            try:
                while True:
                    kind, item = out_q.get()
                    if kind == "end":
                        break
                    if kind == "err":
                        raise item
                    yield item
            finally:
                stop.set()
