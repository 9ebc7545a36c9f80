"""Port CLI and config against the JAX package; the port's import hygiene."""

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from gaussian_processes_tpu import cli as jcli
from gaussian_processes_tpu.utils import config as jconfig
from gaussian_processes_tpu_torch import cli as tcli
from gaussian_processes_tpu_torch.utils import config as tconfig
from torch_threads import one_thread  # noqa: F401  (an autouse fixture)

REPO = Path(__file__).resolve().parent.parent


def _f64(cfg):
    return dataclasses.replace(cfg, fit=dataclasses.replace(cfg.fit, dtype="float64"))


def test_run_config_fit_matches_jax(tmp_path):
    cfg = _f64(tconfig.CONFIGS["config1_fit_se500"])
    got = tcli.run_config(dataclasses.replace(cfg, metrics_path=str(tmp_path / "m.jsonl")),
                          device="cpu")
    want = jcli.run_config(_f64(jconfig.CONFIGS["config1_fit_se500"]))
    np.testing.assert_allclose(got["log_marginal"], want["log_marginal"], rtol=1e-8)
    np.testing.assert_allclose(got["pred_rmse_vs_truth"], want["pred_rmse_vs_truth"],
                               rtol=1e-6)
    assert got["pred_rmse_vs_truth"] < 0.05 and got["pred_var_min"] > 0
    assert got["device"] == "cpu" and "peak_flops" not in got  # no device metric from a CPU run
    events = [json.loads(line)["event"] for line in open(tmp_path / "m.jsonl")]
    assert events == ["start", "summary"]


def test_configs_and_make_data_are_identical():
    assert list(tconfig.CONFIGS) == list(jconfig.CONFIGS)
    for name, cfg in tconfig.CONFIGS.items():
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jconfig.CONFIGS[name])
    for name in ("config1_fit_se500", "config2_mle_periodic"):
        cfg = tconfig.CONFIGS[name].data
        for dtype in ("float32", "float64"):
            for got, want in zip(tconfig.make_data(cfg, dtype=dtype),
                                 jconfig.make_data(cfg, dtype=dtype)):
                assert got.dtype == want.dtype
                np.testing.assert_array_equal(got, want)
    grid = dataclasses.replace(tconfig.CONFIGS["config1_fit_se500"].data, layout="grid")
    for got, want in zip(tconfig.make_data(grid), jconfig.make_data(grid)):
        np.testing.assert_array_equal(got, want)


def test_make_kernel_matches_jax():
    for family in ("se", "periodic", "matern32", "matern52", "rq"):
        kc = tconfig.KernelConfig(family=family, h=1.2, w=0.7, p=3.14159265)
        tk = tconfig.make_kernel(kc, dtype=torch.float64)
        jk = jconfig.make_kernel(kc)
        assert type(tk).__name__ == type(jk).__name__
        np.testing.assert_array_equal(tk.params.numpy(), np.asarray(jk.params))
    with pytest.raises(ValueError, match="unknown kernel family"):
        tconfig.make_kernel(tconfig.KernelConfig(family="nope"))


# every task runs now; a task listed in NOT_PORTED (none is) would raise
# naming its ROADMAP item before touching data
UNPORTED = {
    "config3_nuts_64": lambda cfg: tcli.run_config(
        dataclasses.replace(cfg, task="nuts_multihost"), device="cpu"),
}


@pytest.mark.parametrize("name", list(UNPORTED))
def test_unported_tasks_name_their_roadmap_item(name, monkeypatch):
    monkeypatch.setitem(tcli.NOT_PORTED, "nuts_multihost", "slice 5")
    with pytest.raises(NotImplementedError, match="ROADMAP slice 5"):
        UNPORTED[name](tconfig.CONFIGS[name])


def test_not_ported_holds_only_later_slices():
    assert tcli.NOT_PORTED == {}


def test_run_config_sgpr_matches_jax_fit_sgpr():
    import jax.numpy as jnp

    import gaussian_processes_tpu as gpt
    from gaussian_processes_tpu_torch.models.sgpr import kmeans_inducing

    cfg = _f64(tconfig.CONFIGS["sparse1m_sgpr"])
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, n=4096))
    got = tcli.run_config(cfg, device="cpu")
    assert set(got) >= {"fit_wall_s", "elbo", "trace_gap", "m_inducing", "pred_finite"}
    assert got["m_inducing"] == 64 and got["pred_finite"] and got["fit_wall_s"] > 0
    assert "peak_memory_gb" not in got  # no device metric from a CPU run
    # the JAX package's bound at the port's own inducing points
    x, y, _ = jconfig.make_data(cfg.data, dtype="float64")
    z = kmeans_inducing(torch.Generator().manual_seed(cfg.data.seed), torch.as_tensor(x), 64,
                        iters=5)
    want = gpt.fit_sgpr(gpt.GaussianKernel(jnp.float64(1.0), jnp.float64(0.006)), x, y,
                        cfg.fit.noise, z.numpy(), jitter=cfg.fit.jitter)
    np.testing.assert_allclose(got["elbo"], float(want.log_marginal), rtol=1e-9)
    np.testing.assert_allclose(got["trace_gap"], float(want.trace_gap), rtol=1e-9)


def test_run_config_fit_large_matches_jax_fit():
    import jax.numpy as jnp

    import gaussian_processes_tpu as gpt

    cfg = _f64(tconfig.CONFIGS["config4_large_n"])
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, n=512))
    got = tcli.run_config(cfg, device="cpu")
    x, y, _ = jconfig.make_data(cfg.data, dtype="float64")
    want = gpt.fit(gpt.GaussianKernel(jnp.float64(1.0), jnp.float64(1.0)), x, y,
                   cfg.fit.noise, cfg.fit.jitter)
    np.testing.assert_allclose(got["log_marginal"], float(want.log_marginal), rtol=1e-8)
    assert got["pred_rmse_vs_truth"] < 0.05 and got["fit_wall_s"] > 0
    assert "peak_memory_gb" not in got  # no device metric from a CPU run
    # through fit_blockcyclic over a one-rank mesh, as the JAX CLI names it
    assert got["block_size"] == 64 and got["mesh"] == "{'shard': 1}"


def test_run_config_bayes_grid_small():
    cfg = tconfig.CONFIGS["grid1m_bayes_whittle"]
    cfg = dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, n=4096),
        nuts=dataclasses.replace(cfg.nuts, n_chains=4, num_warmup=30, num_samples=30))
    got = tcli.run_config(cfg, device="cpu")
    assert got["n_samples"] == 30 and got["n_chains"] == 4 and got["draws_finite"]
    assert len(got["posterior_mean"]) == 3 and np.all(np.isfinite(got["posterior_mean"]))
    assert 1 <= got["mean_leapfrog"] <= 32 and got["step_size"] > 0
    assert set(got["diagnostics"]) >= {"split_rhat", "ess", "max_rhat", "ess_per_s"}
    with pytest.raises(ValueError, match="layout='grid'"):
        tcli.run_config(dataclasses.replace(
            cfg, data=dataclasses.replace(cfg.data, layout="scattered")), device="cpu")


def _small(name, **nuts):
    cfg = _f64(tconfig.CONFIGS[name])
    return dataclasses.replace(cfg, nuts=dataclasses.replace(cfg.nuts, **nuts))


def test_run_config_mle_recovers_the_period():
    cfg = _small("config2_mle_periodic")
    cfg = dataclasses.replace(cfg, mle=dataclasses.replace(cfg.mle, num_steps=30))
    got = tcli.run_config(cfg, device="cpu")
    assert got["device"] == "cpu" and np.isfinite(got["log_marginal"])
    h, w, p, s = got["theta"]
    # the data are sin(2x) + 0.1 eps: period pi, noise 0.1 (the reference
    # found p = 0.4998 in its kernel's units and s = 0.098)
    assert abs(p - 0.5) < 0.01 and abs(s - 0.1) < 0.02, got["theta"]


@pytest.mark.parametrize("name", ["config3_chees_64", "config3_nuts_64"])
def test_run_config_samplers_report_their_summary(name):
    cfg = _small(name, n_chains=4, num_warmup=20, num_samples=10)
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, n=40))
    got = tcli.run_config(cfg, device="cpu")
    assert got["n_samples"] == 10 and got["n_chains"] == 4
    assert len(got["posterior_mean"]) == len(got["posterior_sd"]) == 3
    assert np.all(np.isfinite(got["posterior_mean"])) and got["samples_per_s"] > 0
    assert set(got["diagnostics"]) >= {"split_rhat", "ess", "max_rhat", "ess_per_s"}


def test_main_list_and_fit(capsys):
    assert tcli.main(["--list"]) == 0
    out = capsys.readouterr().out
    assert "config1_fit_se500" in out and "not ported" not in out
    assert "task=nuts_multihost n=500      ported" in out
    assert "config3_chees_64" in out and "task=chees          n=500      ported" in out
    assert "task=fit_large      n=65536    ported" in out
    assert "task=bayes_grid     n=1048576  ported" in out
    assert tcli.main(["config1_fit_se500", "--n", "64", "--device", "cpu"]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["event"] == "summary" and np.isfinite(summary["log_marginal"])
    assert tcli.main(["no_such_config"]) == 2


def test_cuda_request_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcli.run_config(tconfig.CONFIGS["config1_fit_se500"], device="cuda")


def test_package_imports_without_jax():
    code = (
        "import sys; import gaussian_processes_tpu_torch as g; "
        "import gaussian_processes_tpu_torch.cli, gaussian_processes_tpu_torch.convert; "
        "import gaussian_processes_tpu_torch.dryrun, gaussian_processes_tpu_torch.parallel; "
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m.startswith('gaussian_processes_tpu.') or m == 'gaussian_processes_tpu']; "
        "assert not bad, bad; print('ok')"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_port_sources_never_name_jax():
    for path in (REPO / "gaussian_processes_tpu_torch").rglob("*.py"):
        text = path.read_text()
        assert "import jax" not in text and "from jax" not in text, path
        assert "from gaussian_processes_tpu." not in text, path
        assert "import gaussian_processes_tpu\n" not in text, path
