"""idle_pct.train: per cent of the traced training window in which no
operation ran on the device (1 - the union of device activity / window)."""

from benchmark.harness import idle_share


def read(trace):
    return idle_share(trace.busy_s, trace.window_s) if "steps" in trace.counters else None
