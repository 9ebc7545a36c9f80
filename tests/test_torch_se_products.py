"""B4's and B5's folded arithmetic against the JAX package.

Kernels B4 and B5 (csrc/matvec.cuh) fold every constant out of the element:
SE is t = (x_i - x_j) s with s = c / w, E = exp2(-t^2) in float32 (exp in
float64), the Jacobian's values E and E t^2, and h^2, 2h, h^2 / (c^2 w)
multiply the row sums once; periodic likewise with g = sin(d / 2p) 2s.  On
the CPU that arithmetic (``matvec_folded_reference``,
``jacvec_folded_reference``, ``folded_values``) is held against the JAX
package's fused matvec and Jacobian product (Pallas kernels in interpret
mode, as tests/test_pairwise_pallas.py runs them) on numpy-seeded inputs, for
SE and periodic and r in {1, 8, 9}.

Tolerances: the product against the row sums of |K| |V| (of |dK/dtheta_p| |U|
for the Jacobian), 1e-10 of them in float64 and 1e-5 in float32, the kernel
tests' allowance.  One case takes the matrix-free workload's conditioning
(sorted uniform x on [-pi, pi], 100 points per lengthscale at N = 65536) and
holds the float32 form to 0.05 of that allowance against a float64 K of the
same float32 inputs; coordinates pre-scaled by s before the difference, which
lose float32 digits at |x| s ~ 278, exceed it there.
"""


import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gaussian_processes_tpu as gpt
import gaussian_processes_tpu_torch as gpx
from gaussian_processes_tpu.ops import pairwise as jpw
from gaussian_processes_tpu_torch.ops import pairwise as tpw
from torch_threads import one_thread  # noqa: F401  (an autouse fixture)

BLOCK = (128, 128)
TOL = {"float64": 1e-10, "float32": 1e-5}
FAMILIES = {
    "se": (gpt.GaussianKernel, gpx.GaussianKernel, (1.2, 0.6)),
    "periodic": (gpt.PeriodicKernel, gpx.PeriodicKernel, (1.1, 0.9, 2.3)),
}


def _problem(family, r, dtype, n=150):
    rng = np.random.default_rng(100 * r + len(family))
    x = np.sort(rng.uniform(-3, 3, n))
    v = rng.standard_normal((n, r))
    jcls, tcls, theta = FAMILIES[family]
    jk = jcls(*(jnp.asarray(t, dtype) for t in theta))
    tk = tcls(*theta, dtype=getattr(torch, dtype))
    return x, v, jk, tk


def _t(a, dtype):
    return torch.as_tensor(np.asarray(a), dtype=getattr(torch, dtype))


def _jacobian64(tk, x):
    k64 = tk.with_params(tk.params.double())
    x64 = torch.as_tensor(x, dtype=torch.float64)
    return tpw.pairwise_jacobian_reference(k64, x64, x64).numpy()


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("r", [1, 8, 9])
@pytest.mark.parametrize("family", ["se", "periodic"])
def test_folded_matvec_matches_jax(family, r, dtype):
    x, v, jk, tk = _problem(family, r, dtype)
    want = np.asarray(jpw.kernel_matvec_fused(jk, jnp.asarray(x, dtype), jnp.asarray(v, dtype),
                                              0.0, 0.0, block=BLOCK, interpret=True),
                      dtype=np.float64)
    k64 = tk.with_params(tk.params.double())
    x64 = torch.as_tensor(x)
    allowance = TOL[dtype] * (tpw.pairwise_matrix_reference(k64, x64, x64).numpy()
                              @ np.abs(v))
    got = tpw.matvec_folded_reference(tk, _t(x, dtype), _t(v, dtype), block_size=64)
    assert got.dtype == getattr(torch, dtype) and got.shape == (x.shape[0], r)
    assert np.all(np.abs(got.double().numpy() - want) <= allowance)
    # a single right-hand side as a vector
    got1 = tpw.matvec_folded_reference(tk, _t(x, dtype), _t(v[:, 0], dtype))
    assert got1.shape == (x.shape[0],)
    assert np.all(np.abs(got1.double().numpy() - want[:, 0]) <= allowance[:, 0])


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("r", [1, 8, 9])
@pytest.mark.parametrize("family", ["se", "periodic"])
def test_folded_jacvec_matches_jax(family, r, dtype):
    x, u, jk, tk = _problem(family, r, dtype)
    want = np.asarray(jpw.kernel_jacvec_fused(jk, jnp.asarray(x, dtype), jnp.asarray(u, dtype),
                                              block=BLOCK, interpret=True), dtype=np.float64)
    allowance = TOL[dtype] * (np.abs(_jacobian64(tk, x)) @ np.abs(u))
    got = tpw.jacvec_folded_reference(tk, _t(x, dtype), _t(u, dtype), block_size=64)
    assert got.dtype == getattr(torch, dtype) and got.shape == (tk.n_params, x.shape[0], r)
    assert np.all(np.abs(got.double().numpy() - want) <= allowance)


@pytest.mark.parametrize("family", ["se", "periodic"])
def test_folded_values_are_the_closed_forms(family):
    """scale[p] * planes[p] is k (one plane) or dK/dtheta_p, entry by entry."""
    x, _, _, tk = _problem(family, 1, "float64", n=60)
    x64 = torch.as_tensor(x)
    planes, scale = tpw.folded_values(tk, x64, x64[:40])
    assert len(planes) == 1
    np.testing.assert_allclose((scale[0] * planes[0]).numpy(),
                               tpw.pairwise_matrix_reference(tk, x64, x64[:40]).numpy(),
                               rtol=1e-12, atol=1e-300)
    planes, scale = tpw.folded_values(tk, x64, x64[:40], jac=True)
    want = tpw.pairwise_jacobian_reference(tk, x64, x64[:40]).numpy()
    assert len(planes) == tk.n_params
    for p, plane in enumerate(planes):
        np.testing.assert_allclose((scale[p] * plane).numpy(), want[p], rtol=1e-11,
                                   atol=1e-14 * np.abs(want[p]).max())


def _workload(n=4096, n_full=65536, r=9):
    """The matrix-free workload's conditioning: float32 inputs, and the
    float64 K of those same inputs."""
    rng = np.random.default_rng(0)
    x = torch.as_tensor(np.sort(rng.uniform(-np.pi, np.pi, n)), dtype=torch.float32)
    k = gpx.GaussianKernel(1.0, 100.0 * 2 * np.pi / n_full, dtype=torch.float32)
    v = rng.standard_normal((n, r))
    x64 = x.double().numpy()
    K64 = np.exp(-0.5 * ((x64[:, None] - x64[None, :]) / float(k.params[1])) ** 2)
    return x, k, v, K64


def _share_of_allowance(K32, K64, v):
    """The largest row error of K32 V, the contraction taken in float64, as a
    share of 1e-5 of the row sums of |K| |V|."""
    err = np.abs((K32.double().numpy() - K64) @ v)
    return float((err / (TOL["float32"] * (K64 @ np.abs(v)))).max())


@pytest.mark.parametrize("r", [1, 9])
def test_float32_form_at_the_workloads_conditioning(r):
    """The difference is taken first and then scaled.  Scaling x itself, as
    B4-ARD does for coordinates that stay small, would put |x s| above 250
    here and use about 0.19 of the allowance at r = 9: the limit of 0.05
    refuses it."""
    x, k, v, K64 = _workload(r=r)
    planes, scale = tpw.folded_values(k, x, x)
    assert planes[0].dtype == torch.float32
    assert _share_of_allowance(planes[0] * float(scale[0]), K64, v) <= 0.05
