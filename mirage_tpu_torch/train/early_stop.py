"""Dual-metric early stopping.

The port's own copy of ``mirage_tpu/train/early_stop.py`` (reference
mutils/classification.py:26-74): a primary metric (e.g. BAcc, greater is
better) with a secondary tie-breaker (e.g. the validation loss); patience
counts only from ``start_from``; a call returns True when the new values
are the best.
"""


class EarlyStopping:
    def __init__(self, patience: int = 50, delta: float = 0.01,
                 greater_is_better: bool = False, delta_two: float = 0.01,
                 greater_is_better_two: bool = False, start_from: int = 0):
        self.patience = patience
        self.delta = delta
        self.delta_two = delta_two
        self.counter = 0
        self.best_value = None
        self.best_value_two = None
        self.early_stop = False
        self.start_from = start_from
        self.sign = 1.0 if greater_is_better else -1.0
        self.sign_two = 1.0 if greater_is_better_two else -1.0

    def is_better(self, x, y) -> bool:
        return self.sign * (x - y) > self.delta

    def is_better_two(self, x, y) -> bool:
        return self.sign_two * (x - y) > self.delta_two

    def is_same(self, x, y) -> bool:
        return abs(x - y) < self.delta

    def __call__(self, value, value_two, epoch) -> bool:
        """True if (value, value_two) is the new best."""
        if (self.best_value is None
                or self.is_better(value, self.best_value)
                or (self.is_same(value, self.best_value)
                    and self.is_better_two(value_two, self.best_value_two))):
            self.best_value = value
            self.best_value_two = value_two
            self.counter = 0
            return True
        if epoch >= self.start_from:
            self.counter += 1
            if self.counter >= self.patience:
                self.early_stop = True
        return False
