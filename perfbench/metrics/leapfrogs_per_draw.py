"""leapfrogs_per_draw: mean over transitions of the largest leapfrog count
among the chains, which is what the lockstep loop evaluates (ChEES: the
shared count)."""


def read(run):
    counts = run.counters.get("leapfrog_max")
    if not counts:
        return None
    return sum(counts) / len(counts)
