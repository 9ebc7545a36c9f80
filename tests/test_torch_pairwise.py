"""Plain twins of kernels B1, B2a, B2b against the JAX Pallas builders.

The JAX builders run in interpret mode on the CPU, as
tests/test_pairwise_pallas.py runs them; the port's wrappers take their
plain PyTorch versions for CPU tensors.  Same numpy-seeded inputs, float64,
rtol 1e-12.  Hessian planes also take an atol of 1e-12 of the array's
largest value: d2K/dw2 has a zero crossing where the closed form cancels
(d^4/w^6 - 3 d^2/w^4), and there a one-ulp difference between the two
libraries' exp is no longer small relative to the result.  The kernels
themselves run on the card (tests/test_torch_gpu.py, chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gaussian_processes_tpu as gpt
import gaussian_processes_tpu_torch as gpx
from gaussian_processes_tpu.ops import pairwise as jpw
from gaussian_processes_tpu_torch.ops import _build
from gaussian_processes_tpu_torch.ops import pairwise as tpw
from torch_threads import one_thread  # noqa: F401  (an autouse fixture)

RTOL = 1e-12

FAMILIES = {
    "se": (gpt.GaussianKernel, gpx.GaussianKernel, (1.3, 0.7)),
    "periodic": (gpt.PeriodicKernel, gpx.PeriodicKernel, (0.9, 1.1, 2.0)),
}

SHAPES = [(64, 64), (300, 200), (129, 257)]


def _pair(family):
    jcls, tcls, theta = FAMILIES[family]
    return jcls(*(jnp.asarray(v) for v in theta)), tcls(*theta, dtype=torch.float64)


def _inputs(n, m, seed=0):
    rng = np.random.default_rng(seed)
    return np.sort(rng.uniform(-3, 3, n)), np.sort(rng.uniform(-3, 3, m))


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _close_planes(got, want):
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * np.abs(want).max())


@pytest.mark.parametrize("family", list(FAMILIES))
@pytest.mark.parametrize("n,m", SHAPES)
def test_matrix_twin_matches_pallas(family, n, m):
    jk, tk = _pair(family)
    x1, x2 = _inputs(n, m)
    want = jpw.pairwise_matrix(jk, x1, x2, block=(128, 128), interpret=True)
    got = tpw.pairwise_matrix_reference(tk, _t(x1), _t(x2))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL)
    # the wrapper takes the twin for CPU tensors
    np.testing.assert_array_equal(tpw.pairwise_matrix(tk, _t(x1), _t(x2)).numpy(),
                                  got.numpy())


@pytest.mark.parametrize("family", list(FAMILIES))
@pytest.mark.parametrize("n,m", [(200, 200), (130, 70)])
def test_matrix_twin_with_diag_matches_pallas(family, n, m):
    jk, tk = _pair(family)
    x1, x2 = _inputs(n, m, seed=1)
    want = jpw.pairwise_matrix(jk, x1, x2, noise=0.3, jitter=1e-6,
                               block=(128, 128), interpret=True)
    got = tpw.pairwise_matrix(tk, _t(x1), _t(x2), noise=0.3, jitter=1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL)
    ref = jpw.pairwise_matrix_reference(jk, x1, x2, noise=0.3, jitter=1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL)


@pytest.mark.parametrize("family", list(FAMILIES))
@pytest.mark.parametrize("n,m", SHAPES)
def test_jacobian_twin_matches_pallas(family, n, m):
    jk, tk = _pair(family)
    x1, x2 = _inputs(n, m, seed=2)
    want = jpw.pairwise_jacobian(jk, x1, x2, block=(128, 128), interpret=True)
    got = tpw.pairwise_jacobian(tk, _t(x1), _t(x2))
    assert got.shape == (tk.n_params, n, m)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL)


@pytest.mark.parametrize("family", list(FAMILIES))
@pytest.mark.parametrize("n,m", SHAPES)
def test_hessian_twin_matches_pallas(family, n, m):
    jk, tk = _pair(family)
    x1, x2 = _inputs(n, m, seed=3)
    want = np.asarray(jpw.pairwise_hessian(jk, x1, x2, block=(128, 128), interpret=True))
    got = tpw.pairwise_hessian(tk, _t(x1), _t(x2))
    P = tk.n_params
    assert got.shape == (P, P, n, m)
    _close_planes(got.numpy(), want)
    for p in range(P):
        for q in range(P):
            plane = tpw.pairwise_hessian(tk, _t(x1), _t(x2), pair=(p, q))
            assert plane.shape == (n, m)
            _close_planes(plane.numpy(), want[p, q])


@pytest.mark.parametrize("family,pair", [("se", (0, 0)), ("se", (0, 1)), ("se", (1, 1)),
                                         ("periodic", (0, 0)), ("periodic", (0, 1)),
                                         ("periodic", (0, 2)), ("periodic", (1, 1)),
                                         ("periodic", (1, 2)), ("periodic", (2, 2))])
@pytest.mark.parametrize("n,m", [(129, 257), (64, 64)])
def test_hessian_plane_folded_matches_pallas(family, pair, n, m):
    """B2b's one-plane arithmetic (constants folded per launch, one value's
    closed form) against the JAX Hessian's plane, float64: rtol 1e-10 with
    an atol of 1e-10 of the plane's largest value for the zero crossings of
    the second-derivative planes."""
    jk, tk = _pair(family)
    x1, x2 = _inputs(n, m, seed=4)
    want = np.asarray(jpw.pairwise_hessian(jk, x1, x2, block=(128, 128), interpret=True))
    for p, q in (pair, pair[::-1]):
        got = tpw.hessian_plane_folded(tk, _t(x1), _t(x2), (p, q)).numpy()
        assert got.shape == (n, m)
        np.testing.assert_allclose(got, want[p, q], rtol=1e-10,
                                   atol=1e-10 * np.abs(want[p, q]).max())


def test_cpu_wrappers_launch_nothing():
    _, tk = _pair("periodic")
    x = _t(np.linspace(-1, 1, 33))
    before = dict(_build.launch_counts)
    tpw.pairwise_matrix(tk, x, x, noise=0.1)
    tpw.pairwise_jacobian(tk, x, x)
    tpw.pairwise_hessian(tk, x, x, pair=(0, 2))
    assert dict(_build.launch_counts) == before


def test_inputs_are_checked():
    _, tk = _pair("se")
    x = _t(np.linspace(-1, 1, 8))
    with pytest.raises(ValueError, match="1-D"):
        tpw.pairwise_matrix(tk, x[:, None], x)
    with pytest.raises(TypeError, match="float32"):
        tpw.pairwise_matrix(tk, x, x.float())
    with pytest.raises(ValueError, match="scalar noise"):
        tpw.pairwise_matrix(tk, x, x, noise=torch.ones(8, dtype=torch.float64))
    with pytest.raises(RuntimeError, match="no pairwise kernel"):
        tpw.pairwise_matrix(tk, x.to("meta"), x.to("meta"))


def test_float32_twin_keeps_dtype():
    _, tk = _pair("periodic")
    x = torch.linspace(-2, 2, 50, dtype=torch.float32)
    K = tpw.pairwise_matrix(tk, x, x, noise=0.1, jitter=1e-6)
    assert K.dtype == torch.float32
    K64 = tpw.pairwise_matrix(tk, x.double(), x.double(), noise=0.1, jitter=1e-6)
    np.testing.assert_allclose(K.numpy(), K64.numpy(), rtol=1e-6, atol=1e-7)


# -- the build of the CUDA library, as far as it goes without nvcc ------------


def test_build_sources_and_hash():
    names = [p.name for p in _build.sources()]
    assert names == ["ard_matvec_f32.cu", "ard_matvec_f64.cu", "ard_pairwise.cu", "chol_tile.cu",
                     "matvec_ext_f32.cu", "matvec_ext_f64.cu", "matvec_f32.cu", "matvec_f64.cu",
                     "matvec_tree_f32.cu", "matvec_tree_f64.cu",
                     "pairwise.cu", "pairwise_ext_f32.cu", "pairwise_ext_f64.cu",
                     "ard_matvec.cuh", "closed_forms.cuh", "matvec.cuh", "pairwise.cuh",
                     "product_common.cuh", "splits.cuh"]
    h = _build.source_hash()
    assert len(h) == 16 and h == _build.source_hash()
    flags = " ".join(_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "fast_math" not in flags


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    if _build.Path("/usr/local/cuda/bin/nvcc").is_file():
        pytest.skip("this machine has a CUDA toolkit at /usr/local/cuda")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()


def test_entry_rejects_other_dtypes():
    with pytest.raises(TypeError, match="float32 or float64"):
        _build.entry("gp_pairwise_k", torch.float16)
