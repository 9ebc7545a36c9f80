"""draws_per_s: chains x transitions completed / seconds of the traced window."""


def read(run):
    n = run.counters.get("transitions")
    if not n or run.window_s <= 0:
        return None
    return run.counters["chains"] * n / run.window_s
