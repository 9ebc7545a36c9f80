"""Run one cell of BENCHMARK.json once and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  It needs as many CUDA cards as the cell asks
for, and exits non-zero without a result line when they are missing, when
the program cannot be loaded, or when JAX or the JAX package is loaded.
The last line of standard output is the result: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with ``--trace 1``
its per-layer metrics), ``device`` and, traced, ``breakdown``; ``checks``,
last, holds each number compared with its limit, which also end standard
error.  ``--control tf32`` puts the reference, in TF32, in the program's
place (the check must then fail); the benchmark's own runs never pass it.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def finite_json(value):
    """``value`` with every non-finite float spelled as a string, so the
    line stays JSON."""
    if isinstance(value, float) and not math.isfinite(value):
        return repr(value)
    if isinstance(value, dict):
        return {k: finite_json(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [finite_json(v) for v in value]
    return value


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="perfbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", choices=("tf32",), default=None)
    args = ap.parse_args(argv)

    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("NCCL_SHM_DISABLE", "1")

    from perfbench import guard, harness

    try:
        import gaussian_processes_tpu_torch  # noqa: F401  (the program under test)
    except ImportError as err:
        print(f"perfbench: the program cannot be loaded: {err}", file=sys.stderr)
        return 5
    findings = guard.source_findings()
    if findings:
        print("perfbench: the import guard failed:\n  " + "\n  ".join(findings), file=sys.stderr)
        return 3
    cell = harness.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"perfbench: {args.workload} needs {cell.chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    result = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                              device="cuda:0", control=args.control, t_process=T_PROCESS)
    loaded = guard.forbidden_loaded()
    if loaded:
        print(f"perfbench: forbidden modules loaded in this process: {loaded}", file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(finite_json(result)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
