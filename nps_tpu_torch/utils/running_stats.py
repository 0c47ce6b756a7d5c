"""Welford running statistics on the host (counterpart of
``nps_tpu/utils/running_stats.py``): running mean, variance, minimum and
maximum in the linear or the log domain, pushed a batch at a time. An
offline analysis utility, not on the training path."""

import numpy as np


class RunningStats:
    def __init__(self, log_domain=False):
        self.log_domain = log_domain
        self.n = 0
        self.mean = 0.0
        self.m2 = 0.0
        self.min = np.inf
        self.max = -np.inf

    def push(self, values):
        values = np.asarray(values, dtype=np.float64).ravel()
        if self.log_domain:
            values = np.log(values)
        m = values.size
        n_new = self.n + m
        delta = values.mean() - self.mean
        self.mean += delta * m / n_new
        self.m2 += values.var() * m + delta ** 2 * self.n * m / n_new
        self.n = n_new
        self.min = min(self.min, values.min(initial=np.inf))
        self.max = max(self.max, values.max(initial=-np.inf))

    @property
    def var(self):
        return self.m2 / self.n if self.n else 0.0

    @property
    def std(self):
        return float(np.sqrt(self.var))

    def summary(self):
        return dict(n=self.n, mean=self.mean, var=self.var, std=self.std,
                    min=self.min, max=self.max)
