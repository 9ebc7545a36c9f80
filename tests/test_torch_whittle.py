"""Port Whittle densities (1-D and Kronecker) and their posteriors against the JAX package.

float64 on the CPU, numpy-seeded grid data: the log-likelihoods, the
centered and uncentered log posteriors and their gradients (autograd in the
port, ``jax.grad`` in the JAX package) agree to rel 1e-10, for one position
(D,) and for a (C, D) stack of chains.  At N=2^20, on the data of
benchmarks/demo_bayes1m.py, the float64 Whittle log-likelihood that
chip_smoke.py's posterior quadrature evaluates agrees with the JAX package's
to rel 1e-10 near the posterior's mode.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gaussian_processes_tpu as gpt
from gaussian_processes_tpu.inference import gp_model as jgm
from gaussian_processes_tpu.ops import kronecker as jkron
from gaussian_processes_tpu.ops import toeplitz as jt
from gaussian_processes_tpu_torch import ARDGaussianKernel, GaussianKernel
from gaussian_processes_tpu_torch.convert import kron_operator_from_numpy
from gaussian_processes_tpu_torch.inference import gp_model as tgm
from gaussian_processes_tpu_torch.ops import kronecker as tkron
from gaussian_processes_tpu_torch.ops import toeplitz as tt
from test_torch_toeplitz import close, grid, pair, t
from torch_threads import one_thread  # noqa: F401  (an autouse fixture)

F64 = jnp.float64


def _chains(u0, c=4, seed=0):
    return u0[None] + 0.3 * np.random.default_rng(seed).standard_normal((c, u0.shape[0]))


@pytest.mark.parametrize("name", ["se", "matern32", "periodic", "sum", "quasi_periodic", "rq"])
def test_whittle_log_marginal_matches_jax(name):
    jk, tk = pair(name)
    x, y = grid(512, seed=3)
    for spectrum in ("auto", "fft"):
        close(tt.whittle_log_marginal(tk, t(x), t(y), 0.2, 1e-6, spectrum),
              jt.whittle_log_marginal(jk, x, y, 0.2, 1e-6, spectrum))


@pytest.mark.parametrize("name,center", [("se", True), ("se", False), ("periodic", True),
                                         ("quasi_periodic", True), ("rq", False)])
def test_whittle_posterior_value_and_grad_match_jax(name, center):
    jk, tk = pair(name)
    x, y = grid(512, seed=4)
    u0 = np.log(np.concatenate([np.asarray(jk.params), [0.2]]))
    mu = u0 + 0.1
    jlp = jgm.make_log_posterior_whittle(jk, x, y, prior_mean=mu, prior_std=1.5, jitter=1e-6,
                                         center=center)
    tlp = tgm.make_log_posterior_whittle(tk, t(x), t(y), prior_mean=t(mu), prior_std=1.5,
                                         jitter=1e-6, center=center)
    jv, jg = jax.value_and_grad(jlp)(jnp.asarray(u0))
    tv, tg = tlp.value_and_grad(t(u0))
    close(tv, jv)
    close(tg, jg)
    U = _chains(u0, c=2 if name == "quasi_periodic" else 4)
    tV, tG = tlp.value_and_grad(t(U))
    if name == "quasi_periodic":
        # JAX's vmap of the checkpointed scan compiles for minutes on a busy
        # CPU: each row of the stack is held to JAX's single-position call
        one = [jax.value_and_grad(jlp)(jnp.asarray(u)) for u in U]
        jV, jG = jnp.stack([v for v, _ in one]), jnp.stack([g for _, g in one])
    else:
        jV, jG = jax.vmap(jax.value_and_grad(jlp))(jnp.asarray(U))
    close(tV, jV)
    close(tG, jG)
    # autograd through the density's call is its stashed gradient
    u = t(u0).requires_grad_()
    tlp(u).backward()
    close(u.grad, jg)


def test_whittle_centered_posterior_is_a_constant_shift():
    _, tk = pair("se")
    x, y = grid(1024, seed=5)
    u0 = torch.log(torch.tensor([1.2, 0.3, 0.2], dtype=torch.float64))
    kw = dict(prior_mean=u0, prior_std=1.0, jitter=1e-6)
    cen = tgm.make_log_posterior_whittle(tk, t(x), t(y), **kw)
    raw = tgm.make_log_posterior_whittle(tk, t(x), t(y), center=False, **kw)
    U = u0[None] + 0.2 * torch.randn((5, 3), generator=torch.Generator().manual_seed(1),
                                     dtype=torch.float64)
    diff = raw.value_and_grad(U)[0] - cen.value_and_grad(U)[0]
    np.testing.assert_allclose(diff.numpy(), diff[0].item(), rtol=1e-9)
    np.testing.assert_allclose(cen.value_and_grad(U)[1].numpy(),
                               raw.value_and_grad(U)[1].numpy(), rtol=1e-8, atol=1e-8)


def _kron_problem(n1=32, n2=32, seed=6):
    g1 = np.arange(n1) / n1
    g2 = np.arange(n2) / n2
    G1, G2 = np.meshgrid(g1, g2, indexing="ij")
    rng = np.random.default_rng(seed)
    y = (np.sin(2 * np.pi * 3 * G1) * np.cos(2 * np.pi * 2 * G2)
         + 0.1 * rng.standard_normal((n1, n2))).reshape(-1)
    jk = gpt.ARDGaussianKernel(F64(1.1), jnp.asarray([0.08, 0.12]))
    tk = ARDGaussianKernel(1.1, torch.tensor([0.08, 0.12], dtype=torch.float64))
    jop = jkron.KronOperator(axes=(jnp.asarray(g1), jnp.asarray(g2)))
    return jk, tk, jop, kron_operator_from_numpy((g1, g2)), y


@pytest.mark.parametrize("spectrum", ["auto", "fft"])
def test_kron_whittle_density_matches_jax(spectrum):
    jk, tk, jop, top, y = _kron_problem()
    close(tkron.kron_whittle_spectrum(tk, top, 0.1, 1e-6, spectrum),
          jkron.kron_whittle_spectrum(jk, jop, 0.1, 1e-6, spectrum))
    close(tkron.whittle_log_marginal_kron(tk, top, t(y), 0.1, 1e-6, spectrum),
          jkron.whittle_log_marginal_kron(jk, jop, y, 0.1, 1e-6, spectrum))


@pytest.mark.parametrize("center", [True, False])
@pytest.mark.parametrize("spectrum", ["auto", "fft"])
def test_kron_whittle_posterior_matches_jax(spectrum, center):
    jk, tk, jop, top, y = _kron_problem()
    u0 = np.log(np.array([1.1, 0.08, 0.12, 0.1]))
    jlp = jgm.make_log_posterior_whittle_kron(jk, jop, jnp.asarray(y), prior_mean=u0 - 0.1,
                                              prior_std=1.0, jitter=1e-6, center=center,
                                              spectrum=spectrum)
    tlp = tgm.make_log_posterior_whittle_kron(tk, top, t(y), prior_mean=t(u0 - 0.1),
                                              prior_std=1.0, jitter=1e-6, center=center,
                                              spectrum=spectrum)
    jv, jg = jax.value_and_grad(jlp)(jnp.asarray(u0))
    tv, tg = tlp.value_and_grad(t(u0))
    close(tv, jv)
    close(tg, jg)
    U = _chains(u0, c=3, seed=2) * np.array([1.0, 0.2, 0.2, 1.0])
    jV, jG = jax.vmap(jax.value_and_grad(jlp))(jnp.asarray(U))
    tV, tG = tlp.value_and_grad(t(U))
    close(tV, jV)
    close(tG, jG)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_se_alias_skip_changes_no_bit(dtype, monkeypatch):
    # at N=4096 over [-pi, pi) and w = 0.3 the SE density's aliases |l| >= 1
    # are exp(-z) with z >= (w pi N / 2pi)^2 / 2 ~ 3.8e5: exact zeros
    _, tk = pair("se")
    x, y = grid(4096, seed=7)
    u = torch.log(torch.tensor([[1.2, 0.3, 0.2], [0.9, 0.25, 0.15]], dtype=dtype))

    def value_and_grad():
        lp = tgm.make_log_posterior_whittle(tk.to(dtype), t(x).to(dtype), t(y).to(dtype),
                                            prior_mean=u[0], prior_std=1.0, jitter=1e-6)
        return lp.value_and_grad(u)

    assert tt._se_aliases_underflow(tk, u[:, :2].exp(), 2 * np.pi / (x[1] - x[0]))
    skipped = value_and_grad()
    monkeypatch.setattr(tt, "_se_aliases_underflow", lambda *a: False)
    full = value_and_grad()
    assert torch.equal(skipped[0], full[0]) and torch.equal(skipped[1], full[1])


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quadrature_likelihood_at_2_20_matches_jax():
    # the bayes-grid reference's data (float32 grid and y, cast up), at
    # (h, w, s) around the float64 posterior's mode (5.448, 0.06654, 0.10008)
    smoke = _chip_smoke()
    x, y = smoke.bayes_problem("cpu")
    x64, y64 = x.double(), y.double()
    hw = torch.tensor([[5.448, 0.06654], [4.9, 0.0630], [6.1, 0.0701]], dtype=torch.float64)
    s = torch.tensor([0.10008, 0.09990, 0.10030], dtype=torch.float64)
    got = smoke.whittle_lml_nodes64(x, y, hw, s)
    xj, yj = jnp.asarray(x64.numpy()), jnp.asarray(y64.numpy())
    for i, (h, w) in enumerate(hw.tolist()):
        jk = gpt.GaussianKernel(F64(h), F64(w))
        tk = GaussianKernel(h, w, dtype=torch.float64)
        for j, sj in enumerate(s.tolist()):
            want = jt.whittle_log_marginal(jk, xj, yj, sj, 1e-6)
            close(got[i, j], want)
            if i == j:
                close(tt.whittle_log_marginal(tk, x64, y64, sj, 1e-6), want)
