"""One run of one cell: set-up, the measured window, the check, the result.

Everything is found by name from ``BENCHMARK.json``: the cell's
configuration file, its traffic mix ``traffic/<mix>.json``, the kind module
``kinds/<kind>.py`` that the mix names, and each per-layer metric's reader
``metrics/<metric>.py`` (or ``metrics/<family>.py`` for ``<family>.<part>``).
A kind module provides

    setup(ctx) -> state                  build the program's objects, warm up
    call(ctx, state, i) -> record        one call of the window, synchronised
    end_to_end(ctx, state, records, window_s) -> {metric: value}
    counters(ctx, state, records) -> {name: number}   for per-layer readers
    release(ctx, state) -> kept          free the program's state, keep what
                                         the check needs
    check(ctx, records, kept) -> [(name, value, limit)]   against the reference

The window is a closed loop with one caller: a call, a synchronisation, the
next call, until ``seconds`` have passed; it is measured to the end of its
last call.  A traced run (``--trace 1``) profiles the window, cut to the
mix's ``trace_seconds`` where it names one, and reports the per-layer
metrics instead of the end-to-end ones.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import math
import sys
import time
from pathlib import Path

import torch

from perfbench import data, profile

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def log(*parts):
    print("[perfbench]", *parts, file=sys.stderr, flush=True)


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(f"no module at {path}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclasses.dataclass
class Cell:
    name: str
    config_name: str
    traffic_name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str) -> Cell:
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    cfg_entry = next(c for c in manifest["configs"] if c["name"] == w["config"])
    config = json.loads((ROOT / cfg_entry["file"]).read_text())
    traffic = json.loads((BENCH / "traffic" / f"{w['traffic']}.json").read_text())
    e2e = [m for m in manifest["end_to_end"] if _reports(m, name)]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in manifest["per_layer"]
                 if (name in m["workloads"] if "workloads" in m else m["moves"] in e2e_names)]
    return Cell(name=name, config_name=w["config"], traffic_name=w["traffic"],
                chips=w["chips"], config=config, traffic=traffic, end_to_end=e2e,
                per_layer=per_layer)


def kind_module(kind: str):
    return load_module(BENCH / "kinds" / f"{kind}.py", f"perfbench_kind_{kind}")


def metric_reader(name: str):
    """``metrics/<name>.py``, else ``metrics/<family>.py`` for ``<family>.<part>``."""
    exact = BENCH / "metrics" / f"{name}.py"
    path = exact if exact.is_file() else BENCH / "metrics" / f"{name.split('.')[0]}.py"
    return load_module(path, "perfbench_metric_" + path.stem.replace(".", "_")).read


def layer_table() -> list:
    """[(layer, [kernel-name substrings])] from ``layers.json`` and any
    ``layers.d/*.json`` (a later change adds its own file), in that order."""
    files = [BENCH / "layers.json", *sorted((BENCH / "layers.d").glob("*.json"))]
    table = []
    for f in files:
        if f.is_file():
            table += [(e["layer"], e["match"]) for e in json.loads(f.read_text())]
    return table


@dataclasses.dataclass
class Context:
    cell: Cell
    seed: int
    device: torch.device
    control: str | None = None  # "tf32": the reference in the program's place
    tracing: bool = False

    @property
    def config(self) -> dict:
        return self.cell.config

    @property
    def traffic(self) -> dict:
        return self.cell.traffic

    def synchronize(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


@dataclasses.dataclass
class TraceRun:
    """What a per-layer reader reads: the traced window and the counters."""

    cell: Cell
    window_s: float
    busy_s: float
    device_s: float
    by_layer: dict
    counters: dict


def _finite(x) -> bool:
    return isinstance(x, (int, float)) and math.isfinite(x)


def run_cell(name: str, seed: int, seconds: float, trace: bool, *, device="cuda",
             overrides: dict | None = None, traffic_overrides: dict | None = None,
             control: str | None = None,
             t_process: float | None = None) -> dict:
    """Run cell ``name`` once and return the result object (the result line
    plus ``checks``).  ``overrides`` and ``traffic_overrides`` replace
    entries of the configuration and the mix (the CPU tests' small sizes);
    ``control`` puts the reference in the program's place."""
    t0 = time.perf_counter() if t_process is None else t_process
    cell = load_cell(name)
    cell.config = {**cell.config, **(overrides or {})}
    cell.traffic = {**cell.traffic, **(traffic_overrides or {})}
    device = torch.device(device)
    ctx = Context(cell=cell, seed=int(seed), device=device, control=control, tracing=trace)
    kind = kind_module(cell.traffic["kind"])
    build_s = None
    if device.type == "cuda":
        torch.cuda.set_device(device)
        from gaussian_processes_tpu_torch.ops import _build

        tb = time.perf_counter()
        _build.library()  # the kernel library: built by the first run in a checkout
        build_s = time.perf_counter() - tb
        torch.cuda.reset_peak_memory_stats(device)

    state = kind.setup(ctx)
    ctx.synchronize()
    if trace and cell.traffic.get("trace_seconds"):
        seconds = min(seconds, cell.traffic["trace_seconds"])
    records, out = [], {}
    with profile.traced(trace, out):
        window_start = time.perf_counter()
        # the kernel library's build (a fresh checkout's first run) is kept
        # apart in ``build_s``; loading the cached library takes milliseconds
        setup_s = window_start - t0 - (build_s or 0.0)
        deadline = window_start + seconds
        while True:
            a = time.perf_counter()
            rec = kind.call(ctx, state, len(records))
            b = time.perf_counter()
            rec["latency_s"] = b - a
            records.append(rec)
            if b >= deadline:
                break
    window_s = b - window_start
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0

    if trace:
        tr = out["trace"]
        run = TraceRun(cell=cell, window_s=tr.window[1] - tr.window[0],
                       busy_s=profile.busy_seconds(tr), device_s=profile.device_seconds(tr),
                       by_layer=profile.seconds_by_layer(tr, layer_table()),
                       counters=kind.counters(ctx, state, records))
        metrics = {}
        for m in cell.per_layer:
            value = metric_reader(m["name"])(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        breakdown = {"device_ops": profile.top_device_ops(tr),
                     "idle_gaps": profile.idle_gaps(tr)}
        log(f"traced window {run.window_s:.3f} s, device busy {run.busy_s:.3f} s, "
            f"device events {run.device_s:.3f} s; by layer "
            + ", ".join(f"{k} {v:.4f} s" for k, v in sorted(run.by_layer.items(),
                                                            key=lambda kv: -kv[1])))
    else:
        values = kind.end_to_end(ctx, state, records, window_s)
        values["setup_s"] = setup_s
        values["peak_gb"] = peak / 1e9
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    attempted = len(records)
    failed = sum(1 for r in records if not bool(r.get("finite", True)))
    log(f"{cell.name}: seed {seed}, {attempted} calls in {window_s:.4f} s, set-up "
        f"{setup_s:.3f} s" + (f" (kernel library {build_s:.3f} s)" if build_s is not None else ""))
    lat = [r["latency_s"] * 1e3 for r in records]
    third = max(1, attempted // 3)
    log("call ms: quartiles " + ", ".join(f"{data.percentile(lat, q):.3f}" for q in (25, 50, 75))
        + f", max {max(lat):.3f}; median of the first third {data.percentile(lat[:third], 50):.3f},"
        f" of the last third {data.percentile(lat[-third:], 50):.3f}")

    kept = kind.release(ctx, state)
    del state
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    tc = time.perf_counter()
    checks = list(kind.check(ctx, records, kept))
    checks.append(("failed_calls", float(failed), 0.0))
    log(f"check against the reference took {time.perf_counter() - tc:.3f} s")
    correct = all(_finite(v) and v <= lim for _, v, lim in checks)

    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics,
              "device": {"platform": "gpu" if device.type == "cuda" else device.type,
                         "kind": (torch.cuda.get_device_name(device) if device.type == "cuda"
                                  else "cpu"),
                         "count": 1, "memory_peak_bytes": int(peak)}}
    if trace:
        result["device"].update(busy_s=run.busy_s, window_s=run.window_s)
        result["breakdown"] = breakdown
    result["build_s"] = build_s  # the kernel library's build or load, outside setup_s
    result["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    return result
