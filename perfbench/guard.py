"""The import guard.

* ``forbidden_loaded()``: modules whose top-level name (the part before the
  first dot, compared whole) is ``jax``, ``jaxlib``, ``flax`` or the JAX
  package ``gaussian_processes_tpu``; the port's name only begins with it.
* ``source_findings()``: a scan of the benchmark's own files: none imports
  JAX or the JAX package, ``reference/`` imports nothing of the program, and
  no file names a path under ``benchmarks/`` (the JAX package's records).
"""

from __future__ import annotations

import ast
import sys
from pathlib import Path

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "gaussian_processes_tpu"})
PROGRAM = "gaussian_processes_tpu_torch"
BENCH = Path(__file__).resolve().parent


def top_level(module_name: str) -> str:
    return module_name.split(".", 1)[0]


def forbidden_loaded(modules=None) -> list:
    modules = sys.modules if modules is None else modules
    return sorted({top_level(m) for m in modules if top_level(m) in FORBIDDEN})


def imported_top_levels(source: str) -> set:
    names = set()
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            names |= {top_level(a.name) for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.add(top_level(node.module))
    return names


def source_findings(root: Path = BENCH) -> list:
    """What the scan found, one line each; empty when the guard holds.  The
    tests directory is left out: a test of this guard has to name what it
    looks for."""
    found = []
    for path in sorted(root.rglob("*.py")):
        rel = path.relative_to(root)
        if rel.parts[0] == "tests":
            continue
        text = path.read_text()
        bad = imported_top_levels(text) & FORBIDDEN
        if bad:
            found.append(f"{rel} imports {sorted(bad)}")
        if rel.parts[0] == "reference" and PROGRAM in imported_top_levels(text):
            found.append(f"{rel} imports the program {PROGRAM}")
        if rel != Path("guard.py") and "benchmarks/" in text:
            found.append(f"{rel} names a path under benchmarks/")
    return found
