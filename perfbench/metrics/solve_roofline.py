"""solve_roofline: the least time of a request's forward substitution,
max(n^2 r flops / float32 peak, the factor's n^2 / 2 floats read once / HBM
rate), over the device time per request (device events of the traced
window / requests completed), in %."""

from perfbench import peaks


def read(run):
    requests = run.counters.get("requests")
    if not requests or run.device_s <= 0:
        return None
    flops, nbytes = peaks.forward_solve_work(run.counters["n"], run.counters["n_test"])
    return 100.0 * peaks.bound_s(flops, nbytes) / (run.device_s / requests)
