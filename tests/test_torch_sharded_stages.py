"""The chain-sharded NUTS stages at one rank: warmup buffers, counters,
spans and the checkpoint round trip (parallel/sharded.py, parallel/mesh.py,
inference/gp_model.py, utils/profiling.py).

* ``init_buffer`` / ``first_window`` / ``term_buffer`` reach the schedule:
  explicit buffers refresh the inverse mass exactly at the ``window_end``
  steps of ``build_warmup_schedule`` and fold positions only in its
  ``in_slow`` steps; a buffered warmup split by ``start``/``stop`` through
  ``checkpoint_nuts_sharded`` equals one pass.  (The buffered schedule and
  warmup against the JAX package are in ``test_torch_adaptation.py``.)
* ``core.rows`` counts a batch's rows and 1 for a point;
  ``parallel.collectives`` counts every collective of a one-rank mesh;
  ``parallel.checkpoints`` each round trip.
* The stages' spans appear in a ``profiling.trace``; an off span is the
  shared do-nothing context.
* Collect k, the checkpoint, collect k equals collect 2k bit for bit.

The two-rank count of collectives is in ``test_torch_parallel.py``.
"""

import json

import torch

from gaussian_processes_tpu_torch import parallel as par
from gaussian_processes_tpu_torch.inference import adaptation as adapt
from gaussian_processes_tpu_torch.utils import profiling

from test_torch_parallel import gauss_init, gauss_logp, gp_problem
from torch_threads import one_thread  # noqa: F401  (an autouse fixture)

BUFFERS = dict(init_buffer=5, first_window=10, term_buffer=5)
OPTS = dict(max_depth=4)


def _mesh():
    return par.make_chain_mesh(device="cpu")


def _equal_states(a, b):
    assert torch.equal(a.chains.z, b.chains.z) and torch.equal(a.chains.logp, b.chains.logp)
    assert torch.equal(a.step_size, b.step_size) and torch.equal(a.inv_mass, b.inv_mass)
    assert torch.equal(a.da.log_step, b.da.log_step) and a.da.count == b.da.count
    for x, y in zip((a.welford.mean, a.welford.m2, a.welford.count),
                    (b.welford.mean, b.welford.m2, b.welford.count)):
        assert torch.equal(x, y)
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


def test_explicit_buffers_follow_the_schedules_flags():
    num = 40
    flags = adapt.build_warmup_schedule(num, **{k: BUFFERS[k] for k in
                                                ("init_buffer", "term_buffer", "first_window")})
    assert flags["window_end"].sum() == 2  # two mass windows, where the defaults have none
    assert not adapt.build_warmup_schedule(num)["window_end"].any()
    mesh = _mesh()
    s = par.init_nuts_sharded(gauss_logp, gauss_init(8), torch.Generator().manual_seed(5),
                              mesh=mesh)
    folded = 0
    for step in range(num):
        before = s.inv_mass
        s = par.warmup_nuts_sharded(gauss_logp, s, num, mesh=mesh, start=step, stop=step + 1,
                                    **OPTS, **BUFFERS)
        folded = 0 if flags["window_end"][step] else folded + int(flags["in_slow"][step])
        assert float(s.welford.count) == 8 * folded, step
        assert (not torch.equal(s.inv_mass, before)) == bool(flags["window_end"][step]), step
        if flags["window_end"][step]:
            assert s.da.count == 0


def test_buffered_warmup_split_through_a_checkpoint_equals_one_pass(tmp_path):
    mesh = _mesh()

    def start():
        return par.init_nuts_sharded(gauss_logp, gauss_init(8),
                                     torch.Generator().manual_seed(6), mesh=mesh)

    whole = par.warmup_nuts_sharded(gauss_logp, start(), 40, mesh=mesh, **OPTS, **BUFFERS)
    half = par.warmup_nuts_sharded(gauss_logp, start(), 40, mesh=mesh, stop=17, **OPTS,
                                   **BUFFERS)
    half = par.checkpoint_nuts_sharded(half, str(tmp_path / "warm.npz"), mesh)
    split = par.warmup_nuts_sharded(gauss_logp, half, 40, mesh=mesh, start=17, **OPTS,
                                    **BUFFERS)
    _equal_states(whole, split)


def test_collect_k_then_the_checkpoint_then_collect_k_equals_collect_2k(tmp_path):
    mesh = _mesh()
    s = par.init_nuts_sharded(gauss_logp, gauss_init(8), torch.Generator().manual_seed(9),
                              mesh=mesh)
    s = par.warmup_nuts_sharded(gauss_logp, s, 20, mesh=mesh, **OPTS, **BUFFERS)
    before, gen = profiling.counts["parallel.checkpoints"], s.generator.get_state()
    whole = par.collect_nuts_sharded(gauss_logp, s, 6, mesh=mesh, **OPTS)
    whole_gen = whole.final.generator.get_state()
    s.generator.set_state(gen)  # the state's generator is drawn from in place
    a = par.collect_nuts_sharded(gauss_logp, s, 3, mesh=mesh, **OPTS)
    resumed = par.checkpoint_nuts_sharded(a.final, str(tmp_path / "draws.npz"), mesh)
    b = par.collect_nuts_sharded(gauss_logp, resumed, 3, mesh=mesh, **OPTS)
    assert profiling.counts["parallel.checkpoints"] - before == 1
    for i, name in enumerate(whole._fields[:5]):
        assert torch.equal(whole[i], torch.cat([a[i], b[i]])), name
    whole.final.generator.set_state(whole_gen)
    _equal_states(whole.final, b.final)


def test_core_rows_counts_a_batchs_rows_and_one_for_a_point():
    log_post, init = gp_problem()
    c = profiling.counts
    calls, rows = c["core.value_and_grad"], c["core.rows"]
    log_post.value_and_grad(init[:5])
    assert (c["core.value_and_grad"] - calls, c["core.rows"] - rows) == (1, 5)
    log_post.value_and_grad(init[0])
    assert (c["core.value_and_grad"] - calls, c["core.rows"] - rows) == (2, 6)


def test_every_collective_of_one_rank_is_counted():
    mesh = _mesh()
    t = torch.arange(3.0)
    before = profiling.counts["parallel.collectives"]
    out = [mesh.psum(t), mesh.pmean(t), mesh.pmax(t), mesh.pmin(t), mesh.all_gather(t)]
    assert profiling.counts["parallel.collectives"] - before == 5
    for o in out:  # the identity at one rank
        assert torch.equal(o, t)


def test_the_stages_spans_appear_in_a_trace_and_an_off_span_is_shared(tmp_path):
    assert profiling.span("gp.parallel.checkpoint") is profiling._OFF
    with profiling.spans_enabled():
        assert profiling.span("gp.parallel.checkpoint") is not profiling._OFF
    before = profiling.counts["parallel.checkpoints"]
    with profiling.trace(str(tmp_path / "trace")):
        par.sample_nuts_sharded(gauss_logp, gauss_init(4), torch.Generator().manual_seed(2),
                                mesh=_mesh(), num_warmup=4, num_samples=2, chunk_size=2,
                                checkpoint=str(tmp_path / "run.npz"), **OPTS)
    # two warmup chunks and one of draws, each written and read back
    assert profiling.counts["parallel.checkpoints"] - before == 3
    events = json.loads((tmp_path / "trace" / "trace.json").read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"gp.parallel.warmup_nuts_sharded", "gp.parallel.collect_nuts_sharded",
            "gp.parallel.checkpoint", "gp.inference.nuts_transition"} <= names
