"""fwd_ms.train: the mean span of a training step's loss call, in ms (the
benchmark's own span around the call, ending in a synchronise)."""


def read(trace):
    spans = trace.counters.get("fwd_s")
    return 1e3 * sum(spans) / len(spans) if spans else None
