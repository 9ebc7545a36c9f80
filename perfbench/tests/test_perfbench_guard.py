"""The import guard: no JAX and no JAX package anywhere in a run, no program
module in the reference, no path under the JAX package's records.

    python -m pytest perfbench/tests -q
"""

from __future__ import annotations

import shutil
import subprocess
import sys
from pathlib import Path

from perfbench import guard

ROOT = Path(__file__).resolve().parents[2]
JAX_RECORDS = "bench" + "marks/"


def test_the_benchmark_passes_its_own_scan():
    assert guard.source_findings() == []


def test_top_level_names_are_compared_whole():
    modules = {"jax.numpy": 1, "jaxlib": 1, "flax.linen": 1, "gaussian_processes_tpu.ops": 1,
               "gaussian_processes_tpu_torch": 1, "gaussian_processes_tpu_torch.parallel": 1,
               "jaxtyping": 1, "perfbench": 1}
    assert guard.forbidden_loaded(modules) == ["flax", "gaussian_processes_tpu", "jax", "jaxlib"]
    assert guard.forbidden_loaded({"gaussian_processes_tpu_torch.ops": 1}) == []


def test_the_scan_finds_planted_imports(tmp_path):
    tree = tmp_path / "perfbench"
    shutil.copytree(ROOT / "perfbench", tree, ignore=shutil.ignore_patterns("__pycache__"))
    (tree / "kinds" / "planted.py").write_text("import jax.numpy as jnp\n")
    (tree / "reference" / "planted.py").write_text(
        "from gaussian_processes_tpu_torch.ops import pairwise\n")
    (tree / "metrics" / "planted.py").write_text(f"PATH = '{JAX_RECORDS}bayes1m.npz'\n")
    (tree / "metrics" / "fine.py").write_text("import gaussian_processes_tpu_torch\n")
    found = guard.source_findings(tree)
    assert len(found) == 3
    assert any("kinds/planted.py imports ['jax']" in f for f in found)
    assert any("reference/planted.py imports the program" in f for f in found)
    assert any("metrics/planted.py names a path" in f for f in found)


def test_the_reference_loads_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import perfbench.reference.dense, perfbench.reference.posterior, "
            "perfbench.reference.samplers, perfbench.reference.arith\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('gaussian_processes_tpu_torch', 'gaussian_processes_tpu', 'jax'))\n"
            "print(bad)\n") % str(ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_a_run_without_the_program_prints_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "config4.fit",
                          "--seed", str(2 ** 31 + 7), "--seconds", "1", "--trace", "0"],
                         cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_a_run_without_a_card_prints_no_result():
    import torch

    if torch.cuda.is_available():
        return  # the look for a card succeeds here; the CPU test machine has none
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "config3.nuts",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""
