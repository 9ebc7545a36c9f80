"""device_idle.<cell family>: the share of the traced window in which no
device event ran (the union of the events' intervals), in %."""


def read(run):
    if run.window_s <= 0 or run.busy_s <= 0:
        return None
    return 100.0 * (1.0 - run.busy_s / run.window_s)
