"""On the card, at each cell's own size: a short sound run is correct, and
the control (the reference in TF32 in the program's place) is not.

    python -m pytest -p no:cacheprovider -m gpu perfbench/tests/test_perfbench_gpu.py -q

(about six minutes on one H100; skipped without a card).
"""

from __future__ import annotations

import pytest

from perfbench import harness

CELLS = ["config4.fit", "config4.predict", "config3.nuts", "config3.chees"]
SEED = 2 ** 31 + 90210


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA card")
    return "cuda:0"


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_a_short_run_at_full_size_is_correct(card, cell):
    result = harness.run_cell(cell, SEED, 5.0, False, device=card)
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu" and result["failed"] == 0


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_at_full_size_is_not_correct(card, cell):
    result = harness.run_cell(cell, SEED + 1, 5.0, False, device=card, control="tf32")
    assert not result["correct"], result["checks"]
