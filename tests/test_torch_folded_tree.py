"""The folded element that kernels B1 and B4 evaluate, against the JAX package.

Plain versions only (the kernels themselves run on the card:
tests/test_torch_gpu.py), on numpy-seeded inputs, float64 unless said:

* the sum-of-products form a tree reaches the kernels in (``_tree_flat``,
  ``_tree_program``), evaluated step for step as the kernels do
  (``folded_values``), against the JAX package's composed ``tile_program``
  function within 1e-12 relative: the three trees of chip_smoke.py, the
  8-leaf worst case (a + b + c)(d + e + f)(g + h) of 18 products, and a
  tree of every leaf family;
* every leaf family's folded B1 (``pairwise_matrix_folded``) and B4
  (``matvec_folded_reference``) plain versions, RQ at a = 0.7, 1.5 and
  940, against the JAX ``k_fn`` (and K V): within 1e-12 in float64 and 5e-6
  of the float64 value in float32 (relative, with the same fraction of the
  array's largest value as the absolute floor; PERF.md section 2 gives the
  measured errors);
* the hand-reduced sine against ``torch.sin`` and the JAX periodic leaf
  for |u| up to 1e4 periods.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gaussian_processes_tpu as gpt
from gaussian_processes_tpu.models import composite as jcomp
from gaussian_processes_tpu.ops import pairwise as jpw
from gaussian_processes_tpu_torch.convert import kernel_from_spec
from gaussian_processes_tpu_torch.ops import pairwise as tpw
from torch_threads import one_thread  # noqa: F401  (an autouse fixture)

LEAVES = {"se": gpt.GaussianKernel, "periodic": gpt.PeriodicKernel,
          "matern32": gpt.Matern32Kernel, "matern52": gpt.Matern52Kernel,
          "rq": gpt.RationalQuadraticKernel}
SE, PER = ("se", (1.2, 0.6)), ("periodic", (1.0, 1.3, 2.0))


def _leaf(i):
    """The 8-leaf worst case's leaves: SE, Matérn 5/2 and periodic in turn."""
    return [("se", (1.0 + 0.1 * i, 0.7 + 0.2 * i)), ("matern52", (1.0, 0.9 + 0.1 * i)),
            ("periodic", (1.0, 1.1, 1.5 + 0.1 * i))][i % 3]


# chip_smoke.py's TREES, the worst case for the leaf limit, every family
TREES = {
    "qp": ("prod", SE, PER),
    "sum_of_products": ("sum", ("prod", ("matern52", (1.0, 0.7)), ("rq", (1.0, 1.3, 0.7))),
                        ("prod", PER, ("matern32", (0.8, 2.0)))),
    "product_of_sum": ("prod", ("sum", SE, PER), ("se", (0.5, 2.0))),
    "worst_case_18": ("prod", ("prod", ("sum", ("sum", _leaf(0), _leaf(1)), _leaf(2)),
                               ("sum", ("sum", _leaf(3), _leaf(4)), _leaf(5))),
                      ("sum", _leaf(6), _leaf(7))),
    "every_family": ("sum", ("prod", ("se", (0.9, 1.4)), ("rq", (1.1, 0.8, 2.5))),
                     ("prod", ("sum", ("matern32", (0.7, 1.2)), ("periodic", (1.0, 0.9, 1.3))),
                      ("matern52", (1.2, 2.0)))),
}
FAMILIES = {"se": ("se", (1.3, 0.7)), "periodic": ("periodic", (0.9, 1.1, 2.0)),
            "matern32": ("matern32", (1.3, 0.7)), "matern52": ("matern52", (1.1, 0.9)),
            "rq_a0.7": ("rq", (0.9, 1.1, 0.7)), "rq_a1.5": ("rq", (0.9, 1.1, 1.5)),
            "rq_a940": ("rq", (0.9, 1.1, 940.0))}
TOL = {torch.float64: 1e-12, torch.float32: 5e-6}


def _jax_kernel(spec):
    if spec[0] in ("sum", "prod"):
        cls = jcomp.SumKernel if spec[0] == "sum" else jcomp.ProductKernel
        return cls(_jax_kernel(spec[1]), _jax_kernel(spec[2]))
    return LEAVES[spec[0]](*(jnp.float64(v) for v in spec[1]))


def _close(got, want, tol):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got, dtype=np.float64), want, rtol=tol,
                               atol=tol * np.abs(want).max())


def _inputs(n, m, seed, dtype=np.float64):
    """Sorted uniform points on [-3, 3], rounded to ``dtype``."""
    rng = np.random.default_rng(seed)
    return (np.sort(rng.uniform(-3, 3, n)).astype(dtype).astype(np.float64),
            np.sort(rng.uniform(-3, 3, m)).astype(dtype).astype(np.float64))


@pytest.mark.parametrize("name", list(TREES))
def test_flat_program_matches_jax_tile_program(name):
    spec = TREES[name]
    jk, tk = _jax_kernel(spec), kernel_from_spec(spec)
    x1, x2 = _inputs(90, 70, seed=1)
    fn, params = jpw.tile_program(jk)
    want = fn(jnp.asarray(x1)[:, None] - jnp.asarray(x2)[None, :], *params)
    (k,), (scale,) = tpw.folded_values(tk, torch.tensor(x1), torch.tensor(x2))
    _close(k * scale, want, 1e-12)
    _close(tpw.pairwise_matrix_folded(tk, torch.tensor(x1), torch.tensor(x2)), want, 1e-12)
    leaves, masks = tpw._tree_flat(tpw._tree_structure(tk))
    code = list(tpw._tree_program(tpw._tree_structure(tk)))
    assert code[0] == len(leaves) and code[1 + 2 * len(leaves)] == len(masks)
    assert code[2 + 2 * len(leaves):] == list(masks)
    if name == "worst_case_18":
        assert len(leaves) == tpw.MAX_TREE_LEAVES and len(masks) == 18
        assert all(bin(mask).count("1") == 3 for mask in masks)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_folded_leaves_match_jax_k_fn(family, dtype):
    """B1's and B4's plain versions of the folded leaf against the JAX
    ``k_fn`` on the same (dtype-rounded) inputs."""
    spec = FAMILIES[family]
    jk = _jax_kernel(spec)
    tk = kernel_from_spec(spec).to(dtype=dtype)
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    x1, x2 = _inputs(120, 90, seed=2, dtype=np_dtype)
    want = np.asarray(jk(x1, x2))
    tol = TOL[dtype]
    _close(tpw.pairwise_matrix_folded(tk, torch.tensor(x1, dtype=dtype),
                                      torch.tensor(x2, dtype=dtype)), want, tol)
    v = np.random.default_rng(3).standard_normal((120, 3)).astype(np_dtype).astype(np.float64)
    got = tpw.matvec_folded_reference(tk, torch.tensor(x1, dtype=dtype),
                                      torch.tensor(v, dtype=dtype))
    Kj = np.asarray(jk(x1, x1))
    np.testing.assert_array_less(np.abs(got.double().numpy() - Kj @ v),
                                 tol * (np.abs(Kj) @ np.abs(v)) + 1e-300)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_reduced_sine_matches_torch_sin_and_the_jax_leaf(dtype):
    """sin_reduced(u)^2 = sin(u)^2 for |u| up to 1e4 periods (within a few
    ulp of the argument's own rounding), and the folded periodic leaf
    equals the JAX one out to distances of 1e4 periods."""
    u = torch.tensor(np.random.default_rng(4).uniform(-2e4 * math.pi, 2e4 * math.pi, 20001),
                     dtype=dtype)
    got = tpw.sin_reduced(u).double()
    want = torch.sin(u.double())
    tol = 1e-15 if dtype == torch.float64 else 4e-7
    assert float((got.abs() - want.abs()).abs().max()) < tol
    assert float((got * got - want * want).abs().max()) < 2 * tol
    p = 1.7
    d = np.concatenate([[0.0], np.random.default_rng(5).uniform(-2e4 * math.pi * p,
                                                                2e4 * math.pi * p, 999)])
    jk = _jax_kernel(("periodic", (0.9, 1.1, p)))
    want = np.asarray(jk(d, np.zeros(1)))[:, 0]
    tk = kernel_from_spec(("periodic", (0.9, 1.1, p)))
    got = tpw.pairwise_matrix_folded(tk, torch.tensor(d), torch.zeros(1, dtype=torch.float64))
    # an argument of 1e4 periods carries 1e4 pi eps of its own rounding
    _close(got[:, 0], want, 1e-11)


def test_log1p_base_keeps_its_relative_accuracy():
    """RQ's log: the float32 series below q = 1/16 is within 2^-22 of
    log2(1 + q) relative, where 1 + q has lost q's digits; above it the
    plain version takes log2(1 + q) (the kernel lg2.approx).  float64 takes
    ln(1 + q): within an ulp of 1 absolute, which a = 940 turns into 2e-13
    of the value at most."""
    q = torch.logspace(-30, 4, 3001, dtype=torch.float64)
    got = tpw.log1p_base(q.float()).double()
    want = torch.log1p(q.float().double()) / math.log(2.0)
    small = q.float().double() < 0.0625
    assert float(((got - want).abs() / want)[small].max()) < 2.0 ** -22
    assert float(((got - want).abs() / want)[~small].max()) < 2e-6
    np.testing.assert_allclose(tpw.log1p_base(q).numpy(), np.log1p(q.numpy()), rtol=1e-15,
                               atol=2.3e-16)


@pytest.mark.parametrize("a", [1.5, 940.0, 1e4])
def test_rq_derivatives_keep_float32_accuracy_at_large_a(a):
    """The RQ Jacobian and Hessian take ln B = log1p(z/a) and z/(aB) - ln B
    as a series (models/rq.py ``_terms``): in float32 every plane stays
    within 1e-5 of the float64 value (relative, with 1e-6 of the plane's
    largest value as the floor) where a is large, as config #2's RQ MLE
    drives it; the float64 planes equal the JAX package's."""
    x1, x2 = _inputs(80, 60, seed=6)
    jk = _jax_kernel(("rq", (0.9, 1.1, a)))
    k64 = kernel_from_spec(("rq", (0.9, 1.1, a)))
    k32 = kernel_from_spec(("rq", (0.9, 1.1, a))).to(dtype=torch.float32)
    t1, t2 = torch.tensor(x1), torch.tensor(x2)
    for got, want, want_jax in ((k32.jacobian(t1.float(), t2.float()), k64.jacobian(t1, t2),
                                 jk.jacobian(x1, x2)),
                                (k32.hessian(t1.float(), t2.float()), k64.hessian(t1, t2),
                                 jk.hessian(x1, x2))):
        got, want = got.double().numpy(), want.numpy()
        planes = want.reshape(-1, *want.shape[-2:])
        for g, w in zip(got.reshape(planes.shape), planes):
            np.testing.assert_array_less(np.abs(g - w), 1e-5 * np.abs(w) + 1e-6 * np.abs(w).max()
                                         + 1e-300)
        _close(want, want_jax, 1e-10)
