"""The plain reference against the port on tiny inputs, in float64 on the CPU.

    python -m pytest perfbench/tests -q
"""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from perfbench.reference import arith as ar
from perfbench.reference import dense, samplers
from perfbench.reference.posterior import LogPosterior

F64 = torch.float64


def _data(n, seed=0):
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(-math.pi, math.pi, n))
    y = np.sin(2 * x) + 0.1 * rng.standard_normal(n)
    return torch.tensor(x, dtype=F64), torch.tensor(y, dtype=F64)


def test_tf32_round_keeps_ten_mantissa_bits():
    a = torch.tensor([1.0, 1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -11, -1.5 - 2.0 ** -12, 3e-3],
                     dtype=torch.float32)
    r = ar.tf32_round(a)
    assert r[0] == 1.0 and r[1] == 1.0  # a tie rounds to even
    assert r[2] == 1.0 + 2.0 ** -9  # ... and up to the even neighbour
    bits = r.view(torch.int32) & 0x1FFF
    assert torch.all(bits == 0)
    assert torch.allclose(r, a, rtol=2.0 ** -11)


@pytest.mark.parametrize("block", [32, 100, 512])
def test_blocked_cholesky_and_fit_match_the_port(block):
    import gaussian_processes_tpu_torch as gpx

    x, y = _data(300)
    alpha, lml, L = dense.fit(x, y, 1.3, 0.7, 0.1, 1e-4, ar.FLOAT64, block, keep_factor=True)
    K = dense.se_block(x, x, 1.3, 0.7) + (0.01 + 1e-4) * torch.eye(300, dtype=F64)
    assert torch.allclose(torch.tril(L), torch.linalg.cholesky(K), atol=1e-10)
    post = gpx.fit(gpx.GaussianKernel(1.3, 0.7, dtype=F64), x, y, 0.1, 1e-4)
    assert torch.allclose(alpha, post.alpha, rtol=1e-8, atol=1e-8)
    assert abs(float(lml - post.log_marginal)) < 1e-8 * abs(float(lml))
    assert dense.residual(x, y, alpha, 1.3, 0.7, 0.01 + 1e-4, rows=64) < 1e-10
    xo = torch.linspace(-3, 3, 17, dtype=F64)
    mean, var = dense.predict(L, x, alpha, xo, 1.3, 0.7, ar.FLOAT64, block)
    m_p, v_p = gpx.predict_diag(post, xo)
    assert torch.allclose(mean, m_p, atol=1e-9) and torch.allclose(var, v_p, atol=1e-9)


def test_blockcyclic_fit_matches_the_reference():
    from gaussian_processes_tpu_torch import GaussianKernel, parallel

    x, y = _data(512)
    mesh = parallel.make_chain_mesh(axis="shard", device="cpu")
    post = parallel.fit_blockcyclic(GaussianKernel(1.0, 1.0, dtype=F64), x, y, 0.1, mesh,
                                    block_size=64, jitter=1e-4)
    alpha, lml, L = dense.fit(x, y, 1.0, 1.0, 0.1, 1e-4, ar.FLOAT64, 128, keep_factor=True)
    assert torch.allclose(post.alpha, alpha, rtol=1e-7, atol=1e-7)
    assert abs(float(post.log_marginal - lml)) < 1e-8 * abs(float(lml))
    xo = torch.linspace(-3, 3, 50, dtype=F64)
    m, v = parallel.predict_diag_blockcyclic(post, xo, mesh)
    m_r, v_r = dense.predict(L, x, alpha, xo, 1.0, 1.0, ar.FLOAT64, 128)
    assert torch.allclose(m, m_r, atol=1e-9) and torch.allclose(v, v_r, atol=1e-9)


def test_log_posterior_matches_the_port():
    from gaussian_processes_tpu_torch import GaussianKernel
    from gaussian_processes_tpu_torch.inference import make_log_posterior

    x, y = _data(300, seed=3)
    u = torch.log(torch.tensor([[1.0, 1.0, 0.1], [0.7, 1.4, 0.12], [1.5, 0.5, 0.09]], dtype=F64))
    ref = LogPosterior(x, y, 0.0, 1.5, 1e-6, ar.FLOAT64)
    port = make_log_posterior(GaussianKernel(1.0, 1.0, dtype=F64), x, y, prior_std=1.5,
                              jitter=1e-6)
    v_r, g_r = ref.value_and_grad(u)
    v_p, g_p = port.value_and_grad(u)
    assert torch.allclose(v_r, v_p, rtol=1e-10, atol=1e-8)
    assert torch.allclose(g_r, g_p, rtol=1e-8, atol=1e-8)
    # the gradient is that of the value
    with torch.enable_grad():
        uu = u.clone().requires_grad_(True)
        (g_fd,) = torch.autograd.grad(port(uu).sum(), uu)
    assert torch.allclose(g_r, g_fd, rtol=1e-8, atol=1e-8)


def _sampler_problem():
    from gaussian_processes_tpu_torch import GaussianKernel
    from gaussian_processes_tpu_torch.inference import init_positions, make_log_posterior

    x, y = _data(120, seed=5)
    kernel = GaussianKernel(1.0, 1.0, dtype=F64)
    port = make_log_posterior(kernel, x, y, prior_std=1.5, jitter=1e-6)
    ref = LogPosterior(x, y, 0.0, 1.5, 1e-6, ar.FLOAT64)
    gen = torch.Generator().manual_seed(11)
    init = init_positions(kernel, 0.1, gen, n_chains=6, spread=0.2, dtype=F64)
    return port, ref, gen, init


def test_nuts_replay_is_the_ports_transition():
    from gaussian_processes_tpu_torch.inference import nuts

    port, ref, gen, init = _sampler_problem()
    state = nuts.init_sampler_state(port, init, gen, 0.05)
    state = nuts.continue_warmup(port, state, 40, start=0, stop=30, max_depth=8)
    for _ in range(3):
        g = gen.get_state()
        z0 = state.chains.z
        state, info = nuts.sample_step(port, state, max_depth=8)
        replay = torch.Generator()
        replay.set_state(g)
        z_ref, acc = samplers.nuts_transition(ref.value_and_grad, z0, replay, state.step_size,
                                              state.inv_mass, 8, draw_dtype=F64)
        assert torch.allclose(z_ref, state.chains.z, atol=1e-9)
        assert torch.allclose(acc, info.accept_prob, atol=1e-9)


def test_chees_replay_is_the_ports_transition():
    from gaussian_processes_tpu_torch.inference import chees

    port, ref, gen, init = _sampler_problem()
    state = chees.init_chees_state(port, init, gen, init_step_size=0.05)
    state = chees.chees_warmup(port, state, 40, start=0, stop=30)
    for _ in range(3):
        g = gen.get_state()
        z0 = state.chains.z
        state, info = chees.chees_step(port, state, adapt_traj=False)
        replay = torch.Generator()
        replay.set_state(g)
        z_ref, n = samplers.chees_transition(ref.value_and_grad, z0, replay, state.step_size,
                                             state.traj_length, state.inv_mass, 1000)
        assert n == info.num_leapfrog
        assert torch.allclose(z_ref, state.chains.z, atol=1e-9)
