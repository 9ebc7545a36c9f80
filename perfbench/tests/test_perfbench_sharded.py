"""The chain-sharded cell on the CPU: ``reference/sharded.py`` against the
program's rank generator, chain blocks and pooled reducers (at one rank,
and over 2 and 4 blocks with the ranks as threads of this process), the
replay of a subset of chains against the replay of all, and the cell
``config5.nuts1024`` through ``harness.run_cell`` at a small size: a sound
run is correct, the control is not, nor is a run whose checkpoint round
trip moves one chain or reseeds the rank's generator; a traced run feeds
the sampling cells' readers as well as its own.

    python -m pytest perfbench/tests -q
"""

from __future__ import annotations

import dataclasses
import threading

import numpy as np
import pytest
import torch

from perfbench import harness
from perfbench.reference import arith as ar
from perfbench.reference import samplers
from perfbench.reference import sharded as ref
from perfbench.reference.posterior import LogPosterior

F64 = torch.float64
SEED = 2 ** 31 + 4242
# 64 chains at n = 60, a 30-step buffered warmup.  Limits for this size from
# its own readings on the CPU: sound runs read at most 8.4e-4 nats, 3.6e-3
# and 1e-4 (widest chains 3.5e-3, 0.016, 4.8e-4), the control 0.10-0.16,
# 0.41-0.52 and 2.0-3.2e-3 (widest chains 0.40-0.91, 1.6-4.9, 0.57-0.66)
SMALL = {"n": 60, "n_chains": 64, "num_warmup": 30, "chunk_size": 3,
         "warmup_buffers": {"init_buffer": 5, "first_window": 20, "term_buffer": 5}}
SMALL_MIX = {"check_transitions": 2, "replay_chains": 16, "reference_block": 32,
             "limits": {"logp_gap": 0.02, "grad_gap": 0.08, "draw_gap": 6e-4, "accept_gap": 0.4},
             "chain_limits": {"logp_gap": 0.1, "grad_gap": 0.5, "draw_gap": 0.01},
             "chain_count": 0}


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _sharded():
    from gaussian_processes_tpu_torch.parallel import sharded

    return sharded


@pytest.mark.parametrize("rank", [-1, 0, 1, 3])
def test_rank_generator_is_the_programs(rank):
    a, b = (torch.Generator().manual_seed(2 ** 40 + 17) for _ in range(2))
    torch.randn(5, generator=a), torch.randn(5, generator=b)  # the caller has drawn already
    mine, theirs = ref.rank_generator(a, rank, "cpu"), _sharded().rank_generator(b, rank, "cpu")
    assert torch.equal(mine.get_state(), theirs.get_state())
    assert torch.equal(a.get_state(), b.get_state())


@pytest.mark.parametrize("world", [1, 2, 4])
def test_chain_block_is_the_meshs(world):
    from gaussian_processes_tpu_torch.parallel import RankMesh

    for rank in range(world):
        mesh = RankMesh(group=None, rank=rank, world_size=world, device=torch.device("cpu"),
                        axis="chain")
        assert ref.chain_block(64, rank, world) == mesh.block(64, "chains")


class _ThreadRanks:
    """W ranks as threads of this process: a collective puts each rank's
    tensor in its slot, waits for every rank, and hands each the same sum,
    taken in rank order."""

    def __init__(self, world):
        self.world, self.slots = world, [None] * world
        self.barrier = threading.Barrier(world, timeout=60.0)

    def run(self, fn, blocks):
        out = [None] * self.world

        def rank_main(r):
            out[r] = fn(_ThreadMesh(self, r), blocks[r])

        threads = [threading.Thread(target=rank_main, args=(r,)) for r in range(self.world)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120.0)
        assert not any(t.is_alive() for t in threads) and all(o is not None for o in out)
        return out


class _ThreadMesh:
    def __init__(self, ranks, rank):
        self.ranks, self.rank = ranks, rank

    def psum(self, t):
        r = self.ranks
        r.slots[self.rank] = t.clone()
        r.barrier.wait()
        total = r.slots[0].clone()
        for s in r.slots[1:]:
            total = total + s
        r.barrier.wait()
        return total

    def pmean(self, t):
        return self.psum(t) / self.ranks.world


def _pooled(mesh, block):
    """The program's pooled reducers on this rank's block of positions."""
    from gaussian_processes_tpu_torch.inference import adaptation as adapt

    reduce_mean, reduce_welford, reduce_vec_mean = _sharded()._pooled_reducers(mesh)
    w = reduce_welford(adapt.welford_update_batch(adapt.welford_init(3, F64), block))
    return (w.mean, w.m2, w.count), reduce_vec_mean(block), reduce_mean(block[:, 0])


@pytest.mark.parametrize("world", [1, 2, 4])
def test_pooled_reducers_are_the_references(world):
    x = torch.as_tensor(np.random.default_rng(world).normal(size=(64, 3)) * [1.0, 3.0, 0.1]
                        + [0.5, -2.0, 4.0])
    blocks = [x[ref.chain_block(64, r, world)] for r in range(world)]
    if world == 1:
        from gaussian_processes_tpu_torch.parallel import make_chain_mesh

        outs = [_pooled(make_chain_mesh(device="cpu"), x)]
    else:
        outs = _ThreadRanks(world).run(_pooled, blocks)
    mean, m2, count = ref.welford_merge(blocks)
    assert count == 64
    assert torch.allclose(mean, x.mean(0), rtol=1e-13, atol=1e-13)
    assert torch.allclose(m2, ((x - x.mean(0)) ** 2).sum(0), rtol=1e-12)
    for (w_mean, w_m2, w_count), vec_mean, scalar_mean in outs:
        assert torch.allclose(w_mean, mean, rtol=1e-13, atol=1e-13)
        assert torch.allclose(w_m2, m2, rtol=1e-12)
        assert float(w_count) == count
        assert torch.allclose(vec_mean, ref.pooled_mean(blocks), rtol=1e-13, atol=1e-13)
        assert torch.allclose(scalar_mean, ref.pooled_mean([b[:, 0] for b in blocks]),
                              rtol=1e-13, atol=1e-13)


def test_a_replay_of_some_chains_is_the_replay_of_all_on_those():
    rng = np.random.default_rng(3)
    x = torch.as_tensor(np.sort(rng.uniform(-3, 3, 40)))
    y = torch.sin(2 * x) + 0.1 * torch.as_tensor(rng.standard_normal(40))
    post = LogPosterior(x, y, 0.0, 1.5, 1e-6, ar.FLOAT64, 16)
    z = torch.log(torch.tensor([1.0, 1.0, 0.1], dtype=F64)) + 0.2 * torch.as_tensor(
        rng.standard_normal((12, 3)))
    rows = torch.tensor([1, 4, 5, 10])
    outs = []
    for vg in (post.value_and_grad, ref.on_rows(post.value_and_grad, rows)):
        gen = torch.Generator().manual_seed(5)
        outs.append(samplers.nuts_transition(vg, z, gen, 0.3, 1.0, 6))
    (z_all, acc_all), (z_some, acc_some) = outs
    assert torch.allclose(z_some[rows], z_all[rows], rtol=1e-12, atol=1e-12)
    assert torch.allclose(acc_some[rows], acc_all[rows], rtol=1e-12, atol=1e-12)
    assert not torch.allclose(z_all, z)  # the followed chains moved


def _run(control=None, trace=False):
    return harness.run_cell("config5.nuts1024", SEED, 2.0, trace, device="cpu",
                            overrides=SMALL, traffic_overrides=SMALL_MIX, control=control)


def test_sound_run_is_correct():
    result = _run()
    assert result["correct"], result["checks"]
    assert result["attempted"] > SMALL["chunk_size"] and result["failed"] == 0
    assert result["checks"]["handoff_breaks"]["value"] == 0.0
    assert set(result["metrics"]) == {"setup_s", "ess_per_s", "peak_gb"}


def _moves_one_chain(state):
    z = state.chains.z.clone()
    z[7] += 1e-3
    return dataclasses.replace(state, chains=state.chains._replace(z=z))


def _reseeds_the_generator(state):
    state.generator.manual_seed(12345)
    return state


@pytest.mark.parametrize("fault", [_moves_one_chain, _reseeds_the_generator])
def test_a_faulty_checkpoint_round_trip_is_not_correct(monkeypatch, fault):
    from gaussian_processes_tpu_torch import parallel

    sound = parallel.checkpoint_nuts_sharded
    monkeypatch.setattr(parallel, "checkpoint_nuts_sharded",
                        lambda state, base, mesh=None: fault(sound(state, base, mesh)))
    result = _run()
    assert result["attempted"] > SMALL["chunk_size"]
    assert result["checks"]["handoff_breaks"]["value"] >= 1.0
    assert not result["correct"]


def test_a_traced_run_feeds_the_sampling_readers():
    metrics = _run(trace=True)["metrics"]
    assert {"draws_per_s", "leapfrogs_per_draw", "live_row_share"} <= set(metrics)
    assert 0.0 < metrics["live_row_share"]["value"] <= 100.0
    assert 1.0 <= metrics["leapfrogs_per_draw"]["value"] <= 2 ** 8  # the cell's max_depth


def test_control_is_not_correct():
    assert not _run("tf32")["correct"]


def test_counters_feed_the_readers():
    run = harness.TraceRun(cell=None, window_s=2.0, busy_s=1.8, device_s=1.5, by_layer={},
                           counters={"core_rows": 64 * 40, "live_rows": 128})
    assert harness.metric_reader("live_row_share")(run) == 5.0
    assert harness.metric_reader("core_us_per_row")(run) == pytest.approx(1.5e6 / 2560)
    parent = dict(run.counters, core_rows=None)  # a program without the counter
    run.counters = parent
    assert harness.metric_reader("live_row_share")(run) is None
    assert harness.metric_reader("core_us_per_row")(run) is None
