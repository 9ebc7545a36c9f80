"""Timing, tracing and the program's counters.

Counterpart of ``gaussian_processes_tpu/utils/profiling.py``, and the
package's one place for tracing:

* ``counts`` — the package's one ``collections.Counter``, always on.  Kernel
  wrappers count their launches under the kernel's name (``pairwise_k``,
  ``chol_tile``, ...; ``ops.launch_counts`` is this object), the program its
  events under dotted names: ``inference.host_syncs`` (each read of a device
  value to the host in the samplers), ``core.value_and_grad`` (each batched
  log-density evaluation) and ``core.rows`` (the positions it evaluates: C
  for a (C, D) batch, 1 for a point), ``core.grad_contracted`` (the rows
  whose kernel-parameter gradient took B2a contracted, the Jacobian never
  stored: C for each leaf-family ``log_marginal_value_and_grad_chains``),
  ``solve.diag_inverses`` (the diagonal
  blocks a block-cyclic substitution inverts, m_loc a solve),
  ``parallel.collectives`` (each ``RankMesh`` collective, the identity of
  one rank too) and ``parallel.checkpoints`` (each chain-sharded state
  written and read back).  A counter adds a Python int and never reads a
  tensor.
* ``span`` — a named range of the program, ``gp.<layer>.<what>``, on the
  profiler's clock, which the device events share.  Spans are off unless
  ``spans_enabled`` or ``trace`` turns them on: an off span is a flag test
  and one shared do-nothing context, with no torch call (a
  ``record_function`` costs microseconds even with no profiler running).
  No span sits inside a per-block or per-leaf loop.
* ``trace`` — a ``torch.profiler`` trace of the enclosed block with the
  spans on, written as a Chrome trace.
* ``timed`` — best-of wall time of a call.  On a CUDA device it brackets the
  call with CUDA events after ``torch.cuda.synchronize()``; on the CPU it
  reads the host clock, and the caller labels the result with the device.
"""

from __future__ import annotations

import collections
import contextlib
import os
import time
from typing import Optional

import torch

#: kernel launches by kernel name and program events by dotted name
counts: collections.Counter = collections.Counter()

_OFF = contextlib.nullcontext()
_spans_on = False


def span(name: str):
    """A ``torch.profiler`` range named ``name`` while spans are on, else
    one shared context that does nothing."""
    if not _spans_on:
        return _OFF
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def spans_enabled(flag: bool = True):
    """Turn the program's spans on (or off) for the enclosed block."""
    global _spans_on
    before, _spans_on = _spans_on, bool(flag)
    try:
        yield
    finally:
        _spans_on = before


@contextlib.contextmanager
def trace(profile_dir: Optional[str]):
    """Chrome trace of the enclosed block, the program's ``gp.*`` spans on,
    in ``profile_dir/trace.json`` (no-op if None)."""
    if not profile_dir:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof, spans_enabled():
        yield
    prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))


def timed(fn, *args, device, warmup: int = 1, iters: int = 3) -> float:
    """Best-of wall time of ``fn(*args)`` in seconds on ``device``."""
    device = torch.device(device)

    if device.type == "cuda":
        def run():
            torch.cuda.synchronize(device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(*args)
            end.record()
            torch.cuda.synchronize(device)
            return start.elapsed_time(end) / 1e3
    else:
        def run():
            t0 = time.perf_counter()
            fn(*args)
            return time.perf_counter() - t0

    for _ in range(warmup):
        run()
    return min(run() for _ in range(iters))
