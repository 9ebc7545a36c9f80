"""Inputs of the benchmark, made from the seed and handed to both sides.

``make_data`` is a frozen copy of ``gaussian_processes_tpu_torch/utils/config.py::
make_data`` (numpy only), so the benchmark draws config #3's data itself.
``device_generator`` and the ``draw_*`` functions make the fresh inputs of
config #4's calls on the card: the same (seed, stream, index) gives the same
arrays on the same device, so the reference gets exactly what the program got.
"""

from __future__ import annotations

import math

import numpy as np
import torch

#: stream ids mixed into per-call seeds
STREAMS = {"warm": 1, "call": 2, "data": 3, "request": 4, "chains": 5, "check": 6}


def make_data(n, noise, freq, seed, x_lo, x_hi, dtype="float64"):
    """Copy of ``utils/config.py::make_data`` for the scattered layout (a
    ``DataConfig`` spelled out): sorted uniform x and y = sin(freq x) +
    noise eps from ``np.random.default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(x_lo, x_hi, n)).astype(dtype)
    y = (np.sin(freq * x) + noise * rng.standard_normal(n)).astype(dtype)
    return x, y


def derive_seed(seed: int, stream: str, index: int = 0) -> int:
    """A 63-bit seed for (run seed, stream, call index); any whole seed."""
    words = [int(seed) % (1 << 64), STREAMS[stream], int(index)]
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0]) >> 1


def device_generator(seed: int, stream: str, index: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(derive_seed(seed, stream, index))


def draw_uniform(gen, n, lo, hi, dtype, device):
    return torch.rand(n, generator=gen, dtype=dtype, device=device) * (hi - lo) + lo


def draw_fit_data(seed, stream, index, cfg, dtype, device):
    """(x, y) of one call: n sorted uniform x on [x_lo, x_hi], y = sin(freq x)
    + data_noise eps, drawn on ``device``."""
    gen = device_generator(seed, stream, index, device)
    x = torch.sort(draw_uniform(gen, cfg["n"], cfg["x_lo"], cfg["x_hi"], dtype, device)).values
    eps = torch.randn(cfg["n"], generator=gen, dtype=dtype, device=device)
    return x, torch.sin(cfg["freq"] * x) + cfg["data_noise"] * eps


def draw_test_points(seed, stream, index, n_test, cfg, dtype, device):
    """One request's n_test points, uniform on [x_lo, x_hi]."""
    gen = device_generator(seed, stream, index, device)
    return draw_uniform(gen, n_test, cfg["x_lo"], cfg["x_hi"], dtype, device)


def sample_indices(seed: int, count: int, k: int) -> list:
    """``k`` distinct call indices out of ``count`` drawn from the seed (the
    last call always among them), sorted."""
    k = min(k, count)
    if k <= 0:
        return []
    rng = np.random.default_rng(derive_seed(seed, "check"))
    rest = rng.choice(count - 1, size=k - 1, replace=False) if k > 1 else []
    return sorted({count - 1, *map(int, rest)})


def percentile(values, q: float) -> float:
    """The q-th percentile by linear interpolation between order statistics."""
    v = sorted(values)
    pos = (len(v) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def worse(a: float, b: float) -> float:
    """The larger of two readings; NaN when either is NaN."""
    return a + b if a != a or b != b else max(a, b)
