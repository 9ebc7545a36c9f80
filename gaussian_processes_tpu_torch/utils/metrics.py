"""Structured metrics logging.

Counterpart of ``gaussian_processes_tpu/utils/metrics.py`` (which imports no
JAX; copied so the port never imports the JAX package): a lightweight JSONL
logger, one JSON object per event to stdout and/or a file, and the
samplers' health summary.
"""

from __future__ import annotations

import json
import sys
import time
from typing import IO, Optional


class MetricsLogger:
    def __init__(self, path: Optional[str] = None, stream: Optional[IO] = None,
                 echo: bool = True):
        self._file = open(path, "a") if path else None
        self._stream = stream if stream is not None else (sys.stdout if echo else None)
        self._t0 = time.time()

    def log(self, event: str, **fields) -> dict:
        rec = {"event": event, "t": round(time.time() - self._t0, 4), **fields}
        line = json.dumps(rec, default=float)
        if self._file:
            self._file.write(line + "\n")
            self._file.flush()
        if self._stream:
            print(line, file=self._stream, flush=True)
        return rec

    def close(self):
        if self._file:
            self._file.close()
            self._file = None



def summarize_nuts(result) -> dict:
    """Standard sampler health summary from a NUTS or ChEES result (tensors
    on any device)."""
    import numpy as np
    import torch

    def host(a):
        return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)

    acc = host(result.accept_prob)
    return {
        "n_samples": int(acc.shape[0]),
        "n_chains": int(acc.shape[1]),
        "accept_rate": float(acc.mean()),
        "divergence_frac": float(host(result.diverging).mean()),
        "mean_leapfrog": float(host(result.num_leapfrog).mean()),
        "step_size": float(host(result.step_size)),
    }
