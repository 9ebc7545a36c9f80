"""The chain-sharded sampler's bookkeeping, written plainly.

C chains split over W ranks: rank r owns the rows [r C / W, (r + 1) C / W).
Each rank draws its variates from a generator of its own, seeded once from
one draw of the caller's generator mixed with the rank.  The warmup adapts
the whole population as one: the mean of the ranks' equal blocks, and the
moments of the ranks' blocks merged exactly (Chan et al.: the between-block
mean shift added to the summed M2).  ``on_rows`` lets a replay
(``samplers.nuts_transition``) follow a subset of the chains while it draws
every variate at the full width, as the sampler drew them.
"""

from __future__ import annotations

import torch

#: the odd 64-bit constant mixed into a rank's seed, (rank + 1) times
MIX = 0x9E3779B97F4A7C15


def rank_generator(generator: torch.Generator, rank: int, device) -> torch.Generator:
    """Rank ``rank``'s generator on ``device``: one draw of ``generator``,
    an integer in [0, 2**62), plus (rank + 1) MIX, modulo 2**64."""
    base = int(torch.randint(0, 2 ** 62, (), generator=generator, device=generator.device))
    gen = torch.Generator(device=device)
    gen.manual_seed((base + (rank + 1) * MIX) % 2 ** 64)
    return gen


def chain_block(n_chains: int, rank: int, world: int) -> slice:
    """Rank ``rank``'s rows of ``n_chains`` split over ``world`` ranks."""
    if n_chains % world:
        raise ValueError(f"{world} ranks do not divide {n_chains} chains")
    size = n_chains // world
    return slice(rank * size, (rank + 1) * size)


def pooled_mean(blocks: list) -> torch.Tensor:
    """The mean over the rows of every block, along the first axis."""
    return sum(b.sum(dim=0) for b in blocks) / sum(b.shape[0] for b in blocks)


def welford_merge(blocks: list) -> tuple:
    """(mean, M2, count) of the rows of every block, merged block by block."""
    mean = m2 = None
    count = 0
    for b in blocks:
        n_b, mean_b = b.shape[0], b.mean(dim=0)
        m2_b = ((b - mean_b) ** 2).sum(dim=0)
        if mean is None:
            mean, m2, count = mean_b, m2_b, n_b
            continue
        n = count + n_b
        delta = mean_b - mean
        mean = mean + delta * n_b / n
        m2 = m2 + m2_b + delta ** 2 * count * n_b / n
        count = n
    return mean, m2, count


def on_rows(value_and_grad, rows: torch.Tensor):
    """``value_and_grad`` of (C, D) positions evaluated on ``rows`` alone;
    every other row reads a log density of -inf and a zero gradient, so a
    replay stops it at its first leaf as divergent.  A row's transition
    depends on the others only through the variates drawn while any chain
    lives, and a chain of ``rows`` that lives past a leaf sees every
    variate the sampler drew up to there."""

    def vg(z):
        rows_z = rows.to(z.device)
        value, grad = value_and_grad(z[rows_z])
        full = torch.full(z.shape[:1], -float("inf"), dtype=value.dtype, device=value.device)
        full_grad = torch.zeros(z.shape, dtype=grad.dtype, device=grad.device)
        full[rows_z], full_grad[rows_z] = value, grad
        return full, full_grad

    return vg
