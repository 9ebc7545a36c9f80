"""The port's spans and counters (utils/profiling.py).

Spans are off by default: an off span is one shared object and makes no
torch call, so a profiler sees no ``gp.*`` range.  With spans on, each of
the block-cyclic fit, its predictions, a NUTS transition and a ChEES step
shows its spans nested as the layers nest, and gives the same outputs bit
for bit.  ``inference.host_syncs`` agrees with a spy on every host read made
in the samplers' modules, ``core.value_and_grad`` with a wrapper's count of
the log density's calls; ``ops.launch_counts`` is the same counter.
"""

import json
import sys

import numpy as np
import pytest
import torch

from gaussian_processes_tpu_torch import GaussianKernel, ops, parallel
from gaussian_processes_tpu_torch.inference import chees, init_positions, make_log_posterior, nuts
from gaussian_processes_tpu_torch.ops import _build
from gaussian_processes_tpu_torch.utils import profiling
from torch_threads import one_thread  # noqa: F401  (an autouse fixture)

F64 = torch.float64
SYNCS, CORE = "inference.host_syncs", "core.value_and_grad"


def _data(n, seed):
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(-3.0, 3.0, n))
    y = np.sin(2.0 * x) + 0.1 * rng.normal(size=n)
    return torch.as_tensor(x), torch.as_tensor(y)


def _fit_setup():
    x, y = _data(512, 0)
    return {"k": GaussianKernel(1.0, 0.5, dtype=F64),
            "mesh": parallel.make_chain_mesh(axis="shard", device="cpu"), "x": x, "y": y}


def _fit(st):
    post = parallel.fit_blockcyclic(st["k"], st["x"], st["y"], 0.1, st["mesh"], block_size=64,
                                    jitter=1e-6)
    return post.L_blocks, post.alpha, post.log_marginal


def _predict_setup():
    st = _fit_setup()
    st["post"] = parallel.fit_blockcyclic(st["k"], st["x"], st["y"], 0.1, st["mesh"],
                                          block_size=64, jitter=1e-6)
    st["xo"] = torch.linspace(-3.0, 3.0, 7, dtype=F64)
    return st


def _predict(st):
    return parallel.predict_diag_blockcyclic(st["post"], st["xo"], st["mesh"])


def _density():
    x, y = _data(40, 1)
    k = GaussianKernel(1.0, 1.0, dtype=F64)
    gen = torch.Generator().manual_seed(3)
    init = init_positions(k, 0.1, gen, n_chains=4, dtype=F64)
    return make_log_posterior(k, x, y, prior_std=1.5, jitter=1e-6), init, gen


def _nuts_setup():
    density, init, gen = _density()
    return {"density": density, "state": nuts.init_sampler_state(density, init, gen, 0.2)}


def _nuts(st):
    state, info = nuts.sample_step(st["density"], st["state"], max_depth=5)
    return state.chains.z, state.chains.logp, state.chains.grad, info.num_leapfrog


def _chees_setup():
    density, init, gen = _density()
    return {"density": density,
            "state": chees.init_chees_state(density, init, gen, init_step_size=0.2)}


def _chees(st):
    state, info = chees.chees_step(st["density"], st["state"], adapt_traj=False)
    return state.chains.z, state.chains.logp, state.chains.grad, info.accept_prob


WORKLOADS = {
    "fit_blockcyclic": (_fit_setup, _fit),
    "predict_diag_blockcyclic": (_predict_setup, _predict),
    "nuts.sample_step": (_nuts_setup, _nuts),
    "chees.chees_step": (_chees_setup, _chees),
}

#: (outer span, inner spans) that each workload opens, once per outer span
NESTING = {
    "fit_blockcyclic": ("gp.entry.fit_blockcyclic",
                        ["gp.factor.build_strip", "gp.factor.cholesky", "gp.solve.forward",
                         "gp.solve.backward"]),
    "predict_diag_blockcyclic": ("gp.entry.predict_diag_blockcyclic", ["gp.solve.forward"]),
    "nuts.sample_step": ("gp.inference.nuts_transition", ["gp.core.value_and_grad"]),
    "chees.chees_step": ("gp.inference.chees_step", ["gp.core.value_and_grad"]),
}


def _profiled(name, spans: bool):
    """(outputs, [(name, start, end)] of the gp.* ranges, log-density
    evaluations counted) of one call."""
    setup, call = WORKLOADS[name]
    st = setup()
    before = profiling.counts[CORE]
    with profiling.spans_enabled(spans):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            out = call(st)
    ranges = [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
              if e.name.startswith("gp.")]
    return out, ranges, profiling.counts[CORE] - before


def test_an_off_span_is_one_object_and_calls_no_torch(monkeypatch):
    calls = []
    real = torch.profiler.record_function

    def spy(name, *args):
        calls.append(name)
        return real(name, *args)

    monkeypatch.setattr(torch.profiler, "record_function", spy)
    assert profiling.span("gp.a") is profiling.span("gp.b")
    for setup, call in WORKLOADS.values():
        call(setup())
    assert calls == []
    with profiling.spans_enabled():
        with profiling.spans_enabled(False):
            assert profiling.span("gp.c") is profiling.span("gp.a")
        with profiling.span("gp.d"):
            pass
    assert calls == ["gp.d"] and profiling.span("gp.e") is profiling.span("gp.a")


@pytest.mark.parametrize("name", list(WORKLOADS))
def test_spans_off_record_no_gp_event(name):
    _, ranges, _ = _profiled(name, spans=False)
    assert ranges == []


@pytest.mark.parametrize("name", list(WORKLOADS))
def test_spans_on_nest_as_the_layers_do(name):
    _, ranges, evaluations = _profiled(name, spans=True)
    outer, inner = NESTING[name]
    assert {r[0] for r in ranges} == {outer, *inner}
    (top,) = [r for r in ranges if r[0] == outer]
    for n, start, end in ranges:
        assert top[1] <= start and end <= top[2], (n, top)
    if name.startswith(("fit", "predict")):  # one span per call of each function
        assert sorted(r[0] for r in ranges) == sorted([outer, *inner])
    else:  # one span per evaluation of the log density
        assert sum(r[0] == "gp.core.value_and_grad" for r in ranges) == evaluations > 0


@pytest.mark.parametrize("name", list(WORKLOADS))
def test_outputs_are_bitwise_equal_with_spans_on_and_off(name):
    off = _profiled(name, spans=False)[0]
    on = _profiled(name, spans=True)[0]
    assert len(off) == len(on)
    for a, b in zip(off, on):
        assert torch.equal(a, b)


HOST_READS = ("__bool__", "__float__", "__int__", "item", "tolist")


@pytest.mark.parametrize("name", ["nuts.sample_step", "chees.chees_step"])
def test_host_syncs_agree_with_a_spy_on_the_samplers_reads(monkeypatch, name):
    setup, call = WORKLOADS[name]
    st = setup()
    files = (nuts.__file__, chees.__file__)
    reads = []
    for attr in HOST_READS:
        real = getattr(torch.Tensor, attr)

        def spy(self, *args, _real=real, _attr=attr):
            if sys._getframe(1).f_code.co_filename in files:
                reads.append(_attr)
            return _real(self, *args)

        monkeypatch.setattr(torch.Tensor, attr, spy)
    before = profiling.counts[SYNCS]
    call(st)
    delta = profiling.counts[SYNCS] - before
    assert delta == len(reads) > 0
    if name == "chees.chees_step":
        assert reads == ["__float__"]  # the leapfrog count, once a transition
    else:  # whether any chain is active, once a depth; the live count, once a leaf
        assert set(reads) == {"__bool__", "__int__"}


class _Counting:
    def __init__(self, density):
        self.density, self.calls = density, 0

    def value_and_grad(self, u):
        self.calls += 1
        return self.density.value_and_grad(u)


@pytest.mark.parametrize("name", ["nuts.sample_step", "chees.chees_step"])
def test_core_counter_equals_the_log_density_calls(name):
    setup, call = WORKLOADS[name]
    st = setup()
    st["density"] = _Counting(st["density"])
    before = profiling.counts[CORE]
    call(st)
    assert profiling.counts[CORE] - before == st["density"].calls > 0


def test_trace_writes_the_spans_into_a_chrome_trace(tmp_path):
    setup, call = WORKLOADS["fit_blockcyclic"]
    st = setup()
    with profiling.trace(str(tmp_path)):
        assert profiling.span("gp.x") is not profiling.span("gp.y")
        call(st)
    assert profiling.span("gp.x") is profiling.span("gp.y")  # off again after the trace
    names = {e.get("name") for e in json.loads((tmp_path / "trace.json").read_text())
             ["traceEvents"]}
    assert set(NESTING["fit_blockcyclic"][1]) | {NESTING["fit_blockcyclic"][0]} <= names


def test_launch_counts_is_the_one_counter():
    assert ops.launch_counts is profiling.counts and _build.launch_counts is profiling.counts
