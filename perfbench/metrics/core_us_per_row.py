"""core_us_per_row: device time of the traced window / rows of the batched
value+grad counted by the program (``core.rows``), in microseconds."""


def read(run):
    rows = run.counters.get("core_rows")
    if not rows or run.device_s <= 0:
        return None
    return 1e6 * run.device_s / rows
