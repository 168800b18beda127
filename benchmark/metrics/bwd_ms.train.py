"""bwd_ms.train: the mean span of a training step's ``.backward()``, in ms
(the benchmark's own span, ending in a synchronise)."""


def read(trace):
    spans = trace.counters.get("bwd_s")
    return 1e3 * sum(spans) / len(spans) if spans else None
