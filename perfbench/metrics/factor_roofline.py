"""factor_roofline: the Cholesky's own n^3 / 3 flops at the float32 peak,
over the device time per fit of every event the window's fits launch
(device events of the traced window / fits completed), in %."""

from perfbench import peaks


def read(run):
    fits = run.counters.get("fits")
    if not fits or run.device_s <= 0:
        return None
    per_fit = run.device_s / fits
    return 100.0 * peaks.bound_s(peaks.cholesky_flops(run.counters["n"]), 0.0) / per_fit
