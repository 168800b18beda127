"""cg_iters.train: CG iterations a training step, from the port's
``verbose_linalg`` log ("linear_cg finished in %d iterations"): all the
window's iterations over all its steps."""


def read(trace):
    iters, steps = trace.counters.get("cg_iters"), trace.counters.get("steps")
    return sum(iters) / steps if iters and steps else None
