"""live_row_share: the share of the batched value+grad's rows that belonged
to a chain still building its tree, 100 x (the chains' leapfrogs summed over
the window's transitions) / (the program's ``core.rows`` counted in the
window), in %.  The lockstep tree loop evaluates every chain at every leaf
until the last one stops; what it leaves is the room for compaction."""


def read(run):
    rows, live = run.counters.get("core_rows"), run.counters.get("live_rows")
    if not rows or live is None:
        return None
    return 100.0 * live / rows
