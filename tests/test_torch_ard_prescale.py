"""B4-ARD's and B6's pre-scaled coordinates against the JAX package.

Kernels B4-ARD (csrc/ard_matvec.cuh) and B6 (csrc/ard_pairwise.cu) take
coordinates scaled once per call by ``ard_prescale`` (``ard_scale``) and
evaluate k = h^2 exp2(-sum_d (xs_i - xs_j)^2) in float32 (exp in float64).
On the CPU that reformulation is held against the JAX package's fused ARD
matvec and ARD K builder (Pallas kernels in interpret mode, as
tests/test_pairwise_pallas.py runs them), on numpy-seeded inputs, for D in
{1, 3, 8} and r in {1, 8}:

* the plain product and K on inputs pre-scaled by 1 / w with unit
  lengthscales;
* the kernel's own arithmetic (``ard_matvec_prescaled_reference`` on
  ``ard_prescale``'s coordinates);
* B6's arithmetic, K by ``pairwise_ard_prescaled_reference``, against the
  JAX ARD K builder, with and without the diagonal.

Tolerances: float64 rtol 1e-10 (K elementwise, the product against the row
sums of |K| |V|); float32 1e-5 of the row sums of |K| |V| for the product and
1e-5 relative plus 1e-6 of the largest entry for K, the kernel tests' float32
allowance (the pre-scaling and exp2 move an entry by a few float32 ulp).
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

H = 1.2
BLOCK = (128, 128)
TOL = {"float64": 1e-10, "float32": 1e-5}


def _problem(D, r, n=150):
    rng = np.random.default_rng(10 * D + r)
    x = rng.uniform(-2, 2, (n, D))
    v = rng.standard_normal((n, r))
    w = np.linspace(0.6, 2.1, D)
    return x, v, w


def _row_allowance(x, v, w, tol):
    d = (x[:, None, :] - x[None, :, :]) / w
    K = H * H * np.exp(-0.5 * np.sum(d * d, axis=-1))
    return tol * (np.abs(K) @ np.abs(v))


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("r", [1, 8])
@pytest.mark.parametrize("D", [1, 3, 8])
def test_prescaled_product_matches_jax(D, r, dtype):
    x, v, w = _problem(D, r)
    tdt = getattr(torch, dtype)
    jk = gpt.ARDGaussianKernel(h=jnp.asarray(H, dtype), w=jnp.asarray(w, dtype))
    jx, jv = jnp.asarray(x, dtype), jnp.asarray(v, dtype)
    want = np.asarray(jpw.kernel_matvec_fused(jk, jx, jv, 0.0, 0.0, block=BLOCK, interpret=True),
                      dtype=np.float64)
    want_K = np.asarray(jpw.pairwise_matrix_ard(jk, jx, jx, block=BLOCK, interpret=True),
                        dtype=np.float64)
    allowance = _row_allowance(x, v, w, TOL[dtype])

    tx = torch.as_tensor(x, dtype=tdt)
    tv = torch.as_tensor(v, dtype=tdt)
    unit = gpx.ARDGaussianKernel(H, torch.ones(D, dtype=tdt), dtype=tdt)
    xs_unit = tx / torch.as_tensor(w, dtype=tdt)
    # the plain product and K on inputs scaled by 1 / w, unit lengthscales
    got = tpw.kernel_matvec_fused_reference(unit, xs_unit, tv, 0.0).double().numpy()
    assert np.all(np.abs(got - want) <= allowance)
    got_K = tpw.pairwise_matrix_ard_reference(unit, xs_unit, xs_unit).double().numpy()
    atol = 0.0 if dtype == "float64" else 1e-6 * np.abs(want_K).max()
    np.testing.assert_allclose(got_K, want_K, rtol=TOL[dtype], atol=atol)
    # B4-ARD's own arithmetic on the coordinates its wrapper hands it
    k = gpx.ARDGaussianKernel(H, torch.as_tensor(w, dtype=tdt), dtype=tdt)
    xs = tpw.ard_prescale(k, tx)
    assert xs.dtype == tdt and xs.shape == tx.shape and xs.is_contiguous()
    got = tpw.ard_matvec_prescaled_reference(k.h, xs, tv).double().numpy()
    assert np.all(np.abs(got - want) <= allowance)


@pytest.mark.parametrize("with_diag", [False, True])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("D", [1, 3, 8])
def test_prescaled_K_matches_jax(D, dtype, with_diag):
    """B6's arithmetic (``pairwise_ard_prescaled_reference`` on the
    coordinates ``ard_prescale`` gives) against JAX's ARD K builder, on a
    rectangular (150, 97) block and on the square block with its diagonal:
    float64 rtol 1e-10; float32 1e-5 relative plus 1e-6 of the largest
    entry."""
    x, _, w = _problem(D, 1)
    x2 = np.random.default_rng(D).uniform(-2, 2, (97, D))
    tdt = getattr(torch, dtype)
    jk = gpt.ARDGaussianKernel(h=jnp.asarray(H, dtype), w=jnp.asarray(w, dtype))
    k = gpx.ARDGaussianKernel(H, torch.as_tensor(w, dtype=tdt), dtype=tdt)
    diag = dict(noise=0.3, jitter=1e-6) if with_diag else {}
    for b in (x2, x):
        want = np.asarray(jpw.pairwise_matrix_ard(jk, jnp.asarray(x, dtype), jnp.asarray(b, dtype),
                                                  block=BLOCK, interpret=True, **diag),
                          dtype=np.float64)
        tx, tb = torch.as_tensor(x, dtype=tdt), torch.as_tensor(b, dtype=tdt)
        d = tpw._diag_term(0.3, 1e-6, tx) if with_diag else None
        got = tpw.pairwise_ard_prescaled_reference(k.h, tpw.ard_prescale(k, tx),
                                                   tpw.ard_prescale(k, tb), diag=d)
        assert got.dtype == tdt and got.shape == want.shape
        atol = 0.0 if dtype == "float64" else 1e-6 * np.abs(want).max()
        np.testing.assert_allclose(got.double().numpy(), want, rtol=TOL[dtype], atol=atol)


def test_ard_scale_is_prescales_factor():
    x, _, w = _problem(8, 1, n=30)
    for dtype in (torch.float32, torch.float64):
        k = gpx.ARDGaussianKernel(H, torch.as_tensor(w, dtype=dtype), dtype=dtype)
        tx = torch.as_tensor(x, dtype=dtype)
        s = tpw.ard_scale(k, tx)
        assert s.dtype == dtype and s.shape == (8,)
        assert torch.equal(tx * s, tpw.ard_prescale(k, tx))


def test_prescale_folds_the_exponent_base():
    """c^2 = log2(e) / 2 in float32 (exp2), 1 / 2 in float64 (exp)."""
    x, v, w = _problem(3, 1, n=20)
    for dtype, c2 in ((torch.float32, 0.5 * np.log2(np.e)), (torch.float64, 0.5)):
        k = gpx.ARDGaussianKernel(H, torch.as_tensor(w, dtype=dtype), dtype=dtype)
        xs = tpw.ard_prescale(k, torch.as_tensor(x, dtype=dtype)).double().numpy()
        np.testing.assert_allclose(xs * xs, c2 * (x / w) ** 2, rtol=1e-6)
