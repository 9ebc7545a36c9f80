"""Port pathwise sampling (models/pathwise.py) against the JAX package.

The port draws standard variates from a ``krylov.Draws`` in the order the
JAX functions consume their split keys.  ``record_draws`` runs a JAX
function with ``jax.random``'s samplers wrapped, keeps every outermost
variate in call order (a uniform's unit variate, before JAX scales it), and
``Replay`` hands them to the port in that order: both packages then compute
the same arithmetic on the same numbers, float64 on the CPU.  Frequencies
and the harmonic map agree to 1e-12, the samplers draw for draw to 1e-8 (the
iterative ones solve to tol 1e-10 or better).
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gaussian_processes_tpu as gpt
import gaussian_processes_tpu_torch as gpx
from gaussian_processes_tpu.models import pathwise as jpw
from gaussian_processes_tpu_torch.convert import (
    iterative_posterior_from_numpy,
    kernel_from_spec,
    posterior_from_numpy,
)
from gaussian_processes_tpu_torch.models import pathwise as tpw
from torch_threads import one_thread  # noqa: F401  (an autouse fixture)

F64 = jnp.float64
_SAMPLERS = ("normal", "uniform", "gamma", "chisquare", "categorical", "bernoulli",
             "rademacher", "choice")


@contextlib.contextmanager
def record_draws():
    """Wrap ``jax.random``'s samplers; yields the list of outermost draws."""
    drawn, depth, originals = [], [0], {name: getattr(jax.random, name) for name in _SAMPLERS}

    def wrap(name, fn):
        def sampler(key, *args, **kwargs):
            depth[0] += 1
            try:
                out = fn(key, *args, **kwargs)
            finally:
                depth[0] -= 1
            if depth[0] == 0:
                if name == "uniform":  # the unit variate the port scales itself
                    unit = {k: v for k, v in kwargs.items() if k not in ("minval", "maxval")}
                    drawn.append(np.asarray(fn(key, *args, **unit)))
                else:
                    drawn.append(np.asarray(out))
            return out
        return sampler

    for name, fn in originals.items():
        setattr(jax.random, name, wrap(name, fn))
    try:
        yield drawn
    finally:
        for name, fn in originals.items():
            setattr(jax.random, name, fn)


class Replay:
    """Hands out recorded draws in order, as ``krylov.Draws`` would draw them."""

    def __init__(self, arrays):
        self.arrays = list(arrays)

    def _next(self, shape, dtype, device):
        a = self.arrays.pop(0)
        assert tuple(a.shape) == tuple(shape), (a.shape, shape)
        return torch.as_tensor(np.array(a), device=device).to(dtype)

    def normal(self, shape, dtype, device):
        return self._next(shape, dtype, device)

    rademacher = uniform = normal

    def gamma(self, a, shape, dtype, device):
        return self._next(shape, dtype, device)

    chisquare = gamma

    def categorical(self, logits, shape, device):
        return self._next(shape, torch.int64, device)

    def bernoulli(self, p, shape, device):
        return self._next(shape, torch.bool, device)

    def choice(self, n, m, device):
        return self._next((m,), torch.int64, device)


SPECS = {
    "se": ("se", [1.2, 0.6]),
    "matern32": ("matern32", [1.1, 0.7]),
    "matern52": ("matern52", [0.9, 0.8]),
    "rq": ("rq", [1.0, 0.7, 1.5]),
    "periodic": ("periodic", [1.0, 1.2, 2.5]),
    "sum": ("sum", ("se", [1.0, 0.5]), ("periodic", [0.7, 1.1, 2.0])),
    "product": ("prod", ("matern52", [1.0, 0.9]), ("periodic", [1.0, 1.3, 2.2])),
}
_JAX = {"se": gpt.GaussianKernel, "matern32": gpt.Matern32Kernel, "matern52": gpt.Matern52Kernel,
        "rq": gpt.RationalQuadraticKernel, "periodic": gpt.PeriodicKernel}


def jax_kernel(spec):
    """The JAX package's kernel of a ``convert`` spec."""
    if spec[0] in ("sum", "prod"):
        cls = gpt.SumKernel if spec[0] == "sum" else gpt.ProductKernel
        return cls(jax_kernel(spec[1]), jax_kernel(spec[2]))
    return _JAX[spec[0]](*[F64(v) for v in spec[1]])


def _ard():
    w = np.array([0.7, 1.3])
    return (gpt.ARDGaussianKernel(h=F64(1.1), w=jnp.asarray(w)),
            gpx.ARDGaussianKernel(1.1, torch.as_tensor(w)))


def _close(got, want, rtol, atol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


@pytest.mark.parametrize("name", [*SPECS, "ard"])
def test_spectral_sample_every_family(name):
    key = jax.random.PRNGKey(3)
    if name == "ard":
        jk, tk = _ard()
    else:
        jk, tk = jax_kernel(SPECS[name]), kernel_from_spec(SPECS[name])
    with record_draws() as drawn:
        want = jpw._spectral_sample(jk, key, 64)
    got = tpw._spectral_sample(tk, Replay(drawn), 64)
    assert got.shape == want.shape
    _close(got, want, 1e-12)
    _close(tpw._k0(tk), jpw._k0(jk), 1e-14)


def test_periodic_harmonic_features_and_prior_features():
    jk, tk = jax_kernel(SPECS["periodic"]), kernel_from_spec(SPECS["periodic"])
    for got, want in ((tpw.periodic_harmonic_features(tk, 12), jpw.periodic_harmonic_features(jk, 12)),
                      (tpw.prior_features(tk, None, 25), jpw.prior_features(jk, None, 25))):
        for field in ("omega", "phase", "scale"):
            _close(getattr(got, field), getattr(want, field), 1e-12, 1e-15)
    t = np.linspace(-3, 3, 17)
    _close(got(torch.as_tensor(t)), want(t), 1e-12, 1e-14)
    # random features: frequencies, then phases
    jk, tk = jax_kernel(SPECS["sum"]), kernel_from_spec(SPECS["sum"])
    with record_draws() as drawn:
        want = jpw.prior_features(jk, jax.random.PRNGKey(1), 32)
    got = tpw.prior_features(tk, Replay(drawn), 32)
    for field in ("omega", "phase", "scale"):
        _close(getattr(got, field), getattr(want, field), 1e-12)
    _close(got(torch.as_tensor(t)), want(t), 1e-12, 1e-14)


def _problem(n=60, seed=0):
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(-3, 3, n))
    return x, np.sin(2 * x) + 0.1 * rng.standard_normal(n), np.linspace(-3, 3, 23)


@pytest.mark.parametrize("name", ["se", "rq", "product"])
def test_dense_pathwise_sampler_draw_for_draw(name):
    x, y, xo = _problem()
    jk = jax_kernel(SPECS[name])
    jpost = gpt.fit(jk, x, y, 0.2)
    tpost = posterior_from_numpy(SPECS[name], None, x, y, 0.2, jpost.L, jpost.alpha,
                                 jpost.log_marginal)
    with record_draws() as drawn:
        want = jpw.sample_posterior_pathwise(jpost, xo, jax.random.PRNGKey(5), 4, 128)
    got = tpw.sample_posterior_pathwise(tpost, torch.as_tensor(xo), Replay(drawn), 4, 128)
    assert got.shape == (4, xo.shape[0])
    _close(got, want, 1e-8, 1e-10)


@pytest.mark.parametrize("opts", [dict(precond_rank=20, num_iters=80),
                                  dict(num_iters=120),
                                  dict(structure="toeplitz", num_iters=80)],
                         ids=["pcg", "mbcg", "toeplitz"])
def test_iterative_pathwise_sampler_draw_for_draw(opts):
    x, y, xo = _problem(80, seed=1)
    if opts.get("structure") == "toeplitz":
        x = np.arange(80) * (6.0 / 80) - 3.0
    spec = SPECS["se"]
    jk = jax_kernel(spec)
    jpost = gpt.fit_iterative(jk, x, y, 0.3, jax.random.PRNGKey(0), num_probes=4,
                              num_iters=60, tol=1e-10)
    tpost = iterative_posterior_from_numpy(spec, None, x, y, 0.3, jpost.alpha,
                                           jpost.log_marginal, jpost.solve_residual, 4, 60)
    kw = dict(tol=1e-12, block_size=32, **opts)
    with record_draws() as drawn:
        want = jpw.sample_posterior_pathwise_iterative(jpost, xo, jax.random.PRNGKey(7), 3, 64,
                                                       **kw)
    got = tpw.sample_posterior_pathwise_iterative(tpost, torch.as_tensor(xo), Replay(drawn), 3,
                                                  64, **kw)
    _close(got, want, 1e-8, 1e-10)


def test_draws_give_standard_variates():
    """``krylov.Draws``' slice-4 variates (the replays above bypass them):
    shapes, dtypes and moments within 5 standard errors."""
    from gaussian_processes_tpu_torch.ops.krylov import Draws

    d, n, f64 = Draws(torch.Generator().manual_seed(3)), 40000, torch.float64

    def near(sample, mean, var):
        assert abs(float(sample.mean()) - mean) < 5 * np.sqrt(var / n)

    u = d.uniform((n,), f64, "cpu")
    assert u.dtype == f64 and float(u.min()) >= 0.0 and float(u.max()) < 1.0
    near(u, 0.5, 1 / 12)
    near(d.gamma(1.5, (n,), f64, "cpu"), 1.5, 1.5)
    near(d.chisquare(3.0, (n,), torch.float32, "cpu"), 3.0, 6.0)
    logits = torch.log(torch.tensor([0.2, 0.3, 0.5], dtype=f64))
    c = d.categorical(logits, (n,), "cpu")
    assert c.dtype == torch.int64 and set(c.unique().tolist()) == {0, 1, 2}
    near((c == 2).double(), 0.5, 0.25)
    b = d.bernoulli(torch.tensor(0.3), (n,), "cpu")
    assert b.dtype == torch.bool
    near(b.double(), 0.3, 0.21)
    idx = d.choice(100, 30, "cpu")
    assert idx.shape == (30,) and len(set(idx.tolist())) == 30 and int(idx.max()) < 100
    # a seed gives the same draws
    again = Draws(torch.Generator().manual_seed(3)).uniform((n,), f64, "cpu")
    assert torch.equal(u, again)
