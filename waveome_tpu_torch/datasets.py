"""Simulated longitudinal omics data (a copy of ``bench.simulate``, the JAX
reference's benchmark data, in plain numpy).

``simulate`` draws ``n_units`` subjects with ``n_per`` evenly spaced time
points in [-2, 2] each and ``n_outcomes`` outcome columns of four kinds in
turn: a shared sinusoid in time, a sinusoid for the female subjects only,
a linear trend plus a random subject offset, and a constant. Every outcome
gets independent noise of standard deviation 0.3. The same seed gives the
same numbers bit for bit as the reference.
"""

from __future__ import annotations

import numpy as np


def simulate(n_units: int = 50, n_per: int = 10, n_outcomes: int = 256,
             seed: int = 0):
    """Returns ``(X, Ys)``: the design (N, 3) with columns (subject id,
    time, female) and the outcomes (N, n_outcomes), N = n_units·n_per."""
    rng = np.random.default_rng(seed)
    ids = np.repeat(np.arange(n_units), n_per).astype(np.float64)
    time_col = np.tile(np.linspace(-2, 2, n_per), n_units)
    female = np.repeat((np.arange(n_units) % 2).astype(np.float64), n_per)
    X = np.column_stack([ids, time_col, female])
    n = X.shape[0]
    Ys = np.empty((n, n_outcomes))
    for b in range(n_outcomes):
        kind = b % 4
        if kind == 0:
            f = np.sin(1.5 * time_col + rng.uniform(0, 3))
        elif kind == 1:
            f = female * np.cos(1.5 * time_col + rng.uniform(0, 3))
        elif kind == 2:
            f = 0.8 * time_col + rng.normal(size=n_units)[ids.astype(int)]
        else:
            f = rng.normal() * np.ones(n)
        Ys[:, b] = f + 0.3 * rng.normal(size=n)
    return X, Ys
