"""The harness end to end on the CPU at tiny sizes, with faults planted in the
program underneath it: each must turn ``correct`` false, as must the
control (the reference in TF32 in the program's place).  Sound runs must
stay correct.  The look for a card is skipped: ``run_cell`` is called with
``device="cpu"``.

    python -m pytest perfbench/tests -q
"""

from __future__ import annotations

import dataclasses

import pytest
import torch

from perfbench import harness

SEED = 2 ** 31 + 4242
DENSE = {"n": 512, "block_size": 64}
DENSE_MIX = {"reference_block": 128, "check_calls": 2}
CHAINS = {"n": 96, "n_chains": 8, "num_warmup": 20}
# limits for this size, from its own readings on the CPU: sound runs read at most
# 0.006 nats, 0.019 and 1e-4; the control 0.37, 1.6 and 8.4e-3.  Per chain, the
# widest gaps of sound runs of 16 chains read at most 0.013 nats, 0.046 and 7.2e-4,
# one chain's lengthscale moved by 0.05 at least 0.25, 1.8 and 0.05.  NUTS's
# acceptance reads 0.02-0.11 from its target, and 0.48-0.66 with the adapted
# step size doubled
CHAINS_MIX = {"check_transitions": 2, "reference_block": 32,
              "limits": {"logp_gap": 0.05, "grad_gap": 0.2, "draw_gap": 2e-3, "accept_gap": 0.4},
              "chain_limits": {"logp_gap": 0.1, "grad_gap": 0.5, "draw_gap": 0.01},
              "chain_count": 0}


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def run(cell, control=None):
    dense = cell.startswith("config4")
    # the samplers' ESS wants a few transitions a chain
    return harness.run_cell(cell, SEED, 0.4 if dense else 2.0, False, device="cpu",
                            overrides=DENSE if dense else CHAINS,
                            traffic_overrides=DENSE_MIX if dense else CHAINS_MIX,
                            control=control)


def failed_checks(result):
    return sorted(k for k, c in result["checks"].items()
                  if not (c["value"] == c["value"] and c["value"] <= c["limit"]))


@pytest.mark.parametrize("cell", ["config4.fit", "config4.predict", "config3.nuts",
                                  "config3.chees"])
def test_sound_run_is_correct(cell):
    result = run(cell)
    assert result["correct"], result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert set(result["metrics"]) == {m["name"] for m in harness.load_cell(cell).end_to_end}


@pytest.mark.parametrize("cell", ["config4.fit", "config4.predict", "config3.nuts",
                                  "config3.chees"])
def test_control_is_not_correct(cell):
    result = run(cell, control="tf32")
    assert not result["correct"], result["checks"]


# --- faults in the block-cyclic fit and its predictions ----------------------


def _bc():
    from gaussian_processes_tpu_torch.parallel import block_cholesky

    return block_cholesky


def test_fit_with_a_skipped_block_step_is_caught(monkeypatch):
    bc = _bc()
    real = bc._staircase

    def skip_one(S, panel, below, k, *args):
        if k != 3:
            real(S, panel, below, k, *args)

    monkeypatch.setattr(bc, "_staircase", skip_one)
    assert not run("config4.fit")["correct"]


@pytest.mark.parametrize("scale", [0.0, 0.5])
def test_fit_with_a_dropped_diagonal_is_caught(monkeypatch, scale):
    bc = _bc()
    real = bc._build_strip

    def no_noise(kernel, x_pad, n, b, m, noise, jitter, rank, world):
        return real(kernel, x_pad, n, b, m, noise * scale, jitter * scale, rank, world)

    monkeypatch.setattr(bc, "_build_strip", no_noise)
    assert not run("config4.fit")["correct"]


def test_fit_with_an_altered_answer_is_caught(monkeypatch):
    bc = _bc()
    real = bc.fit_blockcyclic

    def altered(*args, **kwargs):
        post = real(*args, **kwargs)
        alpha = post.alpha.clone()
        alpha[7] += 1e-2 * alpha.abs().max()
        return dataclasses.replace(post, alpha=alpha)

    monkeypatch.setattr(bc, "fit_blockcyclic", altered)
    assert failed_checks(run("config4.fit"))


def test_predictions_with_a_skipped_substitution_step_are_caught(monkeypatch):
    bc = _bc()
    real = bc._forward_solve

    def skip_block(S, rhs, mesh, m, b):
        if rhs.shape[1] == 1:  # the fit's own solve stays sound
            return real(S, rhs, mesh, m, b)
        keep = S[2 * b:3 * b, :2 * b].clone()
        S[2 * b:3 * b, :2 * b] = 0.0  # row block 2 skips its update from blocks 0, 1
        try:
            return real(S, rhs, mesh, m, b)
        finally:
            S[2 * b:3 * b, :2 * b] = keep

    monkeypatch.setattr(bc, "_forward_solve", skip_block)
    result = run("config4.predict")
    assert not result["correct"] and "var_gap" in failed_checks(result)


def test_predictions_with_an_altered_mean_are_caught(monkeypatch):
    bc = _bc()
    real = bc.predict_diag_blockcyclic

    def altered(post, xo, mesh, *args, **kwargs):
        mean, var = real(post, xo, mesh, *args, **kwargs)
        return mean + 1e-2, var

    monkeypatch.setattr(bc, "predict_diag_blockcyclic", altered)
    assert failed_checks(run("config4.predict")) == ["mean_gap"]


# --- faults in the samplers --------------------------------------------------


def _module(name):
    from gaussian_processes_tpu_torch.inference import chees, nuts

    return {"nuts": nuts, "chees": chees}[name]


STEPS = {"nuts": "sample_step", "chees": "chees_step"}


@pytest.mark.parametrize("sampler", ["nuts", "chees"])
def test_a_step_that_returns_its_state_unchanged_is_caught(monkeypatch, sampler):
    mod = _module(sampler)
    real = getattr(mod, STEPS[sampler])

    def unchanged(density, state, *args, **kwargs):
        if kwargs.get("adapt_traj", False):  # ChEES's warmup stays sound
            return real(density, state, *args, **kwargs)
        _, info = real(density, state, *args, **kwargs)
        return state, info

    monkeypatch.setattr(mod, STEPS[sampler], unchanged)
    result = run(f"config3.{sampler}")
    assert "draw_gap" in failed_checks(result)


@pytest.mark.parametrize("sampler", ["nuts", "chees"])
def test_half_the_chains_left_out_is_caught(monkeypatch, sampler):
    mod = _module(sampler)
    real = getattr(mod, STEPS[sampler])

    def half(density, state, *args, **kwargs):
        new, info = real(density, state, *args, **kwargs)
        if kwargs.get("adapt_traj", False):
            return new, info
        C = state.chains.z.shape[0]
        keep = torch.arange(C) < C // 2
        chains = type(new.chains)(*(torch.where(keep.reshape((C,) + (1,) * (a.ndim - 1)), a, b)
                                    for a, b in zip(new.chains, state.chains)))
        return dataclasses.replace(new, chains=chains), info

    monkeypatch.setattr(mod, STEPS[sampler], half)
    assert "draw_gap" in failed_checks(run(f"config3.{sampler}"))


@pytest.mark.parametrize("sampler", ["nuts", "chees"])
def test_an_altered_draw_is_caught(monkeypatch, sampler):
    mod = _module(sampler)
    real = getattr(mod, STEPS[sampler])

    def altered(density, state, *args, **kwargs):
        new, info = real(density, state, *args, **kwargs)
        if kwargs.get("adapt_traj", False):
            return new, info
        z = new.chains.z.clone()
        z[:, 1] += 0.05  # every chain's new lengthscale, where the step produces it
        return dataclasses.replace(new, chains=new.chains._replace(z=z)), info

    monkeypatch.setattr(mod, STEPS[sampler], altered)
    assert {"logp_gap", "draw_gap"} <= set(failed_checks(run(f"config3.{sampler}")))


@pytest.mark.parametrize("sampler", ["nuts", "chees"])
def test_a_fault_in_one_chain_is_caught_by_the_chain_count(monkeypatch, sampler):
    mod = _module(sampler)
    real = getattr(mod, STEPS[sampler])

    def one_chain(density, state, *args, **kwargs):
        new, info = real(density, state, *args, **kwargs)
        if kwargs.get("adapt_traj", False):
            return new, info
        z = new.chains.z.clone()
        z[0, 1] += 0.05  # one chain's new lengthscale, where the step produces it
        return dataclasses.replace(new, chains=new.chains._replace(z=z)), info

    monkeypatch.setattr(mod, STEPS[sampler], one_chain)
    # 16 chains: the moved one is a sixteenth of the gaps, under every q0.9
    result = harness.run_cell(f"config3.{sampler}", SEED, 2.0, False, device="cpu",
                              overrides={**CHAINS, "n_chains": 16},
                              traffic_overrides=CHAINS_MIX)
    failed = failed_checks(result)
    assert "draw_chains" in failed
    assert not {"logp_gap", "grad_gap", "draw_gap"} & set(failed)


def test_a_doubled_adapted_step_size_is_caught(monkeypatch):
    mod = _module("nuts")
    real = mod.continue_warmup

    def doubled(density, state, *args, **kwargs):
        new = real(density, state, *args, **kwargs)
        if kwargs.get("start") != 1:  # the first warmup transition stays sound
            return new
        return dataclasses.replace(new, step_size=2.0 * new.step_size)

    monkeypatch.setattr(mod, "continue_warmup", doubled)
    assert failed_checks(run("config3.nuts")) == ["accept_gap"]
