"""value_grad_ms: device time of the traced window / batched value+grad
evaluations counted at the call into the log posterior, in ms."""


def read(run):
    evals = run.counters.get("evaluations")
    if not evals or run.device_s <= 0:
        return None
    return 1e3 * run.device_s / evals
