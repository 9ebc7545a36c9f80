"""The port's ``sym_K`` and the ``ops`` exports against the JAX package.

* Every leaf's ``sym_K`` is the JAX package's expression (``sympy.simplify``
  of the difference is 0, over the same symbols), and its ``lambdify`` is
  the port's ``forward`` in float64; ARD kernels and Sum/Product trees
  raise, as in the JAX package.
* ``ops.__all__`` holds every name of the JAX package's but ``host`` (a
  host oracle the port does not carry), and ``tile_program``'s function is
  the JAX package's on the trees of ``test_torch_folded_tree.py``.
* Every ``tests/test_torch_*.py`` takes ``one_thread`` from
  ``torch_threads.py`` and none defines its own.
"""

import ast
from pathlib import Path

import numpy as np
import pytest
import sympy as sp
import torch

import gaussian_processes_tpu as gpt
import gaussian_processes_tpu_torch as gpx
import gaussian_processes_tpu_torch.ops as tops
from gaussian_processes_tpu.ops import pairwise as jpw
from gaussian_processes_tpu_torch.convert import kernel_from_spec

from test_torch_folded_tree import TREES, _jax_kernel
from torch_threads import one_thread  # noqa: F401  (an autouse fixture)

LEAVES = {
    "se": (gpt.GaussianKernel, gpx.GaussianKernel, (1.3, 0.7)),
    "periodic": (gpt.PeriodicKernel, gpx.PeriodicKernel, (0.9, 1.1, 2.0)),
    "matern32": (gpt.Matern32Kernel, gpx.Matern32Kernel, (1.3, 0.7)),
    "matern52": (gpt.Matern52Kernel, gpx.Matern52Kernel, (1.1, 0.9)),
    "rq": (gpt.RationalQuadraticKernel, gpx.RationalQuadraticKernel, (0.9, 1.1, 1.5)),
}


@pytest.mark.parametrize("name", list(LEAVES))
def test_sym_k_is_the_jax_expression(name):
    jcls, tcls, _ = LEAVES[name]
    texpr, td, tparams = tcls.sym_K()
    jexpr, jd, jparams = jcls.sym_K()
    assert (td, tparams) == (jd, jparams)
    assert sp.simplify(texpr - jexpr) == 0
    assert [str(p) for p in tparams] == list(tcls.param_names)


@pytest.mark.parametrize("name", list(LEAVES))
def test_sym_k_lambdified_equals_forward(name):
    _, tcls, theta = LEAVES[name]
    expr, d, params = tcls.sym_K()
    fn = sp.lambdify((d, *params), expr, "numpy")
    x1 = np.linspace(-3.0, 3.0, 13)
    x2 = np.linspace(-2.5, 2.9, 11)
    want = fn(np.abs(x1[:, None] - x2[None, :]), *theta)  # d >= 0 where sympy assumed it
    got = tcls(*theta, dtype=torch.float64)(torch.as_tensor(x1), torch.as_tensor(x2))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-13, atol=1e-15)


def test_sym_k_raises_for_ard_and_trees():
    with pytest.raises(NotImplementedError):
        gpx.ARDGaussianKernel.sym_K()
    with pytest.raises(NotImplementedError):
        kernel_from_spec(TREES["qp"]).sym_K()


def test_ops_exports_the_jax_names_but_host():
    import gaussian_processes_tpu.ops as jops

    missing = set(jops.__all__) - set(tops.__all__)
    assert missing == {"host"}
    for name in ("toeplitz", "kronecker", "ski"):
        assert getattr(tops, name).__name__ == f"gaussian_processes_tpu_torch.ops.{name}"


@pytest.mark.parametrize("name", ["leaf"] + list(TREES))
def test_tile_program_matches_jax(name):
    spec = ("rq", (0.9, 1.1, 1.5)) if name == "leaf" else TREES[name]
    jk, tk = _jax_kernel(spec), kernel_from_spec(spec)
    rng = np.random.default_rng(2)
    x1, x2 = np.sort(rng.uniform(-3, 3, 40)), np.sort(rng.uniform(-3, 3, 30))
    jfn, jparams = jpw.tile_program(jk)
    tfn, tparams = tops.tile_program(tk)
    np.testing.assert_array_equal(tparams.numpy(), np.asarray(jparams))
    want = np.asarray(jfn(x1[:, None] - x2[None, :], *jparams))
    got = tfn(torch.as_tensor(x1), torch.as_tensor(x2), tparams).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-13, atol=1e-15 * np.abs(want).max())
    np.testing.assert_allclose(got, tk(torch.as_tensor(x1), torch.as_tensor(x2)).numpy(),
                               rtol=1e-13, atol=1e-15 * np.abs(want).max())


def test_tile_program_refuses_ard():
    with pytest.raises(TypeError):
        tops.tile_program(gpx.ARDGaussianKernel(1.0, torch.ones(2, dtype=torch.float64)))


def test_every_port_test_file_runs_on_one_thread():
    files = sorted(Path(__file__).resolve().parent.glob("test_torch_*.py"))
    assert files
    unpinned, own = [], []
    for path in files:
        body = ast.parse(path.read_text()).body
        if not any(isinstance(node, ast.ImportFrom) and node.module == "torch_threads"
                   and "one_thread" in {a.name for a in node.names} for node in body):
            unpinned.append(path.name)
        if any(isinstance(node, ast.FunctionDef) and node.name == "one_thread" for node in body):
            own.append(path.name)
    assert unpinned == [], f"import one_thread from torch_threads in {unpinned}"
    assert own == [], f"take one_thread from torch_threads instead of defining it in {own}"
