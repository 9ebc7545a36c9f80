"""Port checkpoints (utils/checkpoint.py) and resumable samplers.

The counterpart of ``tests/test_checkpoint.py``: a tree of tensors, scalars
and generators survives ``save_pytree`` / ``load_pytree`` with its dtypes
and its random stream; a wrong template raises; a NUTS or ChEES run whose
warmup is split in two with a checkpoint written and read back between the
halves, and whose collection is split the same way, gives the same draws bit
for bit as one uninterrupted run.  The file layout is the JAX package's
(``leaf_i`` arrays and a JSON manifest), read back by its own loader.  The
sampler states cross from the JAX package through ``convert``.
"""

import numpy as np
import pytest
import torch

from gaussian_processes_tpu_torch import GaussianKernel
from gaussian_processes_tpu_torch.convert import (
    chees_state_from_numpy,
    sampler_state_from_numpy,
    sampler_state_to_numpy,
)
from gaussian_processes_tpu_torch.inference import chees as tchees
from gaussian_processes_tpu_torch.inference import make_log_posterior
from gaussian_processes_tpu_torch.inference import nuts as tnuts
from gaussian_processes_tpu_torch.utils import load_pytree, save_pytree

from torch_threads import one_thread  # noqa: F401  (an autouse fixture)


def _make_xy(rng, n):
    """``gaussian_processes_tpu.utils.testing.make_xy``'s recipe."""
    x = np.sort(rng.uniform(-np.pi, np.pi, size=n))
    return x, np.sin(x) + 0.1 * rng.standard_normal(n)


def _posterior(n=20, seed=0):
    x, y = _make_xy(np.random.default_rng(seed), n)
    k0 = GaussianKernel(1.0, 1.0, dtype=torch.float64)
    return make_log_posterior(k0, torch.as_tensor(x), torch.as_tensor(y), prior_std=1.5)


INIT = torch.log(torch.tensor([1.0, 1.0, 0.2], dtype=torch.float64)).expand(4, 3).clone()


def test_pytree_roundtrip_preserves_dtypes_and_generators(tmp_path):
    gen = torch.Generator().manual_seed(42)
    torch.rand(3, generator=gen)
    tree = {
        "a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
        "b": (torch.tensor(3, dtype=torch.int32), gen),
        "c": [torch.tensor([0.1, 0.2], dtype=torch.float64), 7, 0.5, None],
        "d": tnuts.ChainState(z=torch.ones(2, 1), logp=torch.zeros(2), grad=torch.ones(2, 1)),
    }
    path = str(tmp_path / "t.npz")
    save_pytree(path, tree)
    out = load_pytree(path, like=tree)
    assert torch.equal(out["a"], tree["a"]) and out["a"].dtype == torch.float32
    assert out["b"][0].dtype == torch.int32 and int(out["b"][0]) == 3
    assert out["c"][0].dtype == torch.float64 and torch.equal(out["c"][0], tree["c"][0])
    assert out["c"][1:] == [7, 0.5, None] and isinstance(out["c"][1], int)
    assert isinstance(out["d"], tnuts.ChainState) and torch.equal(out["d"].z, tree["d"].z)
    # the restored generator continues the saved stream
    assert torch.equal(torch.rand(4, generator=out["b"][1]), torch.rand(4, generator=gen))


def test_file_layout_is_the_jax_packages(tmp_path):
    from gaussian_processes_tpu.utils import load_pytree as jax_load

    tree = {"a": torch.arange(4, dtype=torch.float64), "b": torch.tensor(2, dtype=torch.int32)}
    path = str(tmp_path / "t.npz")
    save_pytree(path, tree)
    like = {"a": np.zeros(4), "b": np.int32(0)}
    out = jax_load(path, like=like)
    np.testing.assert_array_equal(np.asarray(out["a"]), np.arange(4.0))
    assert int(out["b"]) == 2


def test_load_wrong_structure_raises(tmp_path):
    path = str(tmp_path / "t.npz")
    save_pytree(path, {"a": torch.zeros(3)})
    with pytest.raises(ValueError, match="leaves"):
        load_pytree(path, like={"a": torch.zeros(3), "b": torch.zeros(2)})


def _reload(path, state):
    save_pytree(path, state)
    return load_pytree(path, like=state)


def test_nuts_resume_invariance(tmp_path):
    log_post = _posterior()
    opts = dict(max_depth=6)
    gen = torch.Generator().manual_seed(0)
    full = tnuts.collect(log_post, tnuts.warmup(log_post, INIT, gen, 60, **opts), 30, **opts)

    path = str(tmp_path / "sampler.npz")
    state = tnuts.init_sampler_state(log_post, INIT, torch.Generator().manual_seed(0))
    state = tnuts.continue_warmup(log_post, state, 60, stop=25, **opts)
    state = tnuts.continue_warmup(log_post, _reload(path, state), 60, start=25, **opts)
    first = tnuts.collect(log_post, state, 12, **opts)
    second = tnuts.collect(log_post, _reload(path, first.final), 18, **opts)
    assert torch.equal(full.positions, torch.cat([first.positions, second.positions]))
    assert torch.equal(full.final.inv_mass, second.final.inv_mass)


def test_chees_resume_invariance(tmp_path):
    log_post = _posterior(seed=1)
    full = tchees.sample_chees(log_post, INIT, torch.Generator().manual_seed(3), 60, 30)

    path = str(tmp_path / "chees.npz")
    state = tchees.init_chees_state(log_post, INIT, torch.Generator().manual_seed(3))
    state = tchees.chees_warmup(log_post, state, 60, stop=40)
    state = tchees.chees_warmup(log_post, _reload(path, state), 60, start=40)
    first = tchees.chees_collect(log_post, state, 10)
    second = tchees.chees_collect(log_post, _reload(path, first.final), 20)
    assert torch.equal(full.positions, torch.cat([first.positions, second.positions]))
    assert torch.equal(full.num_leapfrog, torch.cat([first.num_leapfrog, second.num_leapfrog]))
    assert torch.equal(full.traj_length, second.traj_length)


def _jax_state_arrays(state):
    """A JAX package sampler state as ``convert``'s flat dict."""
    out = {"z": state.chains.z, "logp": state.chains.logp, "grad": state.chains.grad,
           "da_log_step": state.da.log_step, "da_log_avg_step": state.da.log_avg_step,
           "da_avg_error": state.da.avg_error, "da_count": state.da.count,
           "da_mu": state.da.mu, "welford_mean": state.welford.mean,
           "welford_m2": state.welford.m2, "welford_count": state.welford.count,
           "inv_mass": state.inv_mass, "step_size": state.step_size}
    for name in ("traj_length", "traj_m", "traj_v", "traj_count"):
        if hasattr(state, name):
            out[name] = getattr(state, name)
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize("sampler", ["nuts", "chees"])
def test_sampler_state_crosses_from_jax_and_back(sampler, tmp_path):
    import jax
    import jax.numpy as jnp

    from gaussian_processes_tpu import GaussianKernel as JGaussian
    from gaussian_processes_tpu.inference import make_log_posterior as jmake
    from gaussian_processes_tpu.inference import chees as jchees
    from gaussian_processes_tpu.inference import nuts as jnuts

    x, y = _make_xy(np.random.default_rng(0), 20)
    jlp = jmake(JGaussian(h=jnp.asarray(1.0), w=jnp.asarray(1.0)), x, y, prior_std=1.5)
    init = jnp.asarray(INIT.numpy())
    if sampler == "nuts":
        jstate = jnuts.warmup(jlp, init, jax.random.key(0), num_warmup=20, max_depth=5)
        state = sampler_state_from_numpy(_jax_state_arrays(jstate), torch.Generator(),
                                         sharded=True)
    else:
        jstate = jchees.sample_chees(jlp, init, jax.random.key(0), 20, 2).final
        state = chees_state_from_numpy(_jax_state_arrays(jstate), torch.Generator(),
                                       torch.Generator())
    arrays = _jax_state_arrays(jstate)
    back = sampler_state_to_numpy(state)
    assert set(back) == set(arrays)
    for k in arrays:
        np.testing.assert_array_equal(back[k], arrays[k])
    # the converted state is a live sampler state: it samples and checkpoints
    log_post = _posterior()
    restored = _reload(str(tmp_path / "s.npz"), state)
    if sampler == "nuts":
        res = tnuts.collect(log_post, restored, 3, max_depth=5)
    else:
        res = tchees.chees_collect(log_post, restored, 3)
    assert bool(torch.isfinite(res.positions).all())
