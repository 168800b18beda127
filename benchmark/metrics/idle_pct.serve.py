"""idle_pct.serve: per cent of the traced serving window in which no
operation ran on the device (1 - the union of device activity / window)."""

from benchmark.harness import idle_share


def read(trace):
    return idle_share(trace.busy_s, trace.window_s) if "batches" in trace.counters else None
