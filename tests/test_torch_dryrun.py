"""Port dryrun (gaussian_processes_tpu_torch/dryrun.py) against ``__graft_entry__.py``.

* ``dryrun_multichip(8)``, through the module's command line
  (``--multichip --device cpu``), over eight gloo ranks brought up once for
  the file by a module fixture: every rank finishes, and rank 0 prints the
  JAX package's OK line with the same fields (16 chains, a 2 x 4 grid).
* ``entry()``'s flagship step against ``__graft_entry__.entry()``'s, both in
  float64 on the port's example inputs (which are the JAX entry's, up to
  float32 rounding of sin): lml, predictive mean and variance to 1e-10.
* ``dryrun_multichip`` refuses a rank count other than the group's.
"""

import contextlib
import importlib.util
import io
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_parallel import REPO, launch_ranks, wait_ranks
from torch_threads import one_thread  # noqa: F401  (an autouse fixture)

WORLD = 8
OK_LINE = ("dryrun_multichip(8): OK (dp chains=16, tp grid=2x4, block-cyclic chol lml match, "
           "row-sharded matrix-free fit/MLE/Bayes, data-sharded SGPR)")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    return wait_ranks(launch_ranks(__file__, WORLD, out), out)


def test_dryrun_multichip_over_eight_ranks(ranks):
    assert [r["rc"] for r in ranks] == [0] * WORLD
    assert OK_LINE in ranks[0]["stdout"].splitlines()
    assert all(OK_LINE not in r["stdout"] for r in ranks[1:])  # one line, from rank 0


def _graft_entry():
    spec = importlib.util.spec_from_file_location("__graft_entry__", REPO / "__graft_entry__.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_entry_step_matches_jax_entry_in_float64():
    import jax.numpy as jnp

    from gaussian_processes_tpu_torch import dryrun

    step, args = dryrun.entry("cpu")
    jstep, jargs = _graft_entry().entry()
    assert [tuple(a.shape) for a in args] == [tuple(a.shape) for a in jargs]
    for a, ja in zip(args, jargs):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(ja), rtol=0, atol=1e-6)
    a64 = [a.double() for a in args]
    got = step(*a64)
    want = jstep(*(jnp.asarray(a.numpy()) for a in a64))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-10, atol=1e-12)


def test_dryrun_multichip_needs_the_group_size():
    from gaussian_processes_tpu_torch import dryrun

    with pytest.raises(ValueError, match="process group of 2 ranks"):
        dryrun.dryrun_multichip(2, device="cpu")


# ---------------------------------------------------------------------------
# rank side: ``python tests/test_torch_dryrun.py OUT_DIR`` under a launcher


def _rank_main(out_dir):
    torch.set_num_threads(1)
    import os

    from gaussian_processes_tpu_torch import dryrun

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = dryrun.main(["--multichip", "--device", "cpu"])
    torch.save({"rc": rc, "stdout": buf.getvalue()},
               Path(out_dir) / f"rank{os.environ['RANK']}.pt")


if __name__ == "__main__":
    sys.path.insert(0, str(REPO))
    _rank_main(sys.argv[1])
