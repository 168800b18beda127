"""Serving batches of query points from one client in a closed loop: each
batch is due when the previous batch's answers are back, as an optimiser
that proposes its next candidates from the last answers sends them.

Traffic keys: ``batch_sizes`` (each block of len(batch_sizes) batches holds
every size once, in an order drawn from the seed, so that every seed sends
the same sizes), ``kept_per_size`` and ``kept_within`` (the batches whose
answers the reference judges: of each size, that many drawn from the seed
among its first ``kept_within``).  Query points are N(0, I) in the
configuration's d, drawn on the device from the seed.

End-to-end: ``query_points_per_s`` (points answered, each batch's answers
synchronised, in the window over its seconds), ``query_ms_p95`` (the 95th
percentile of every batch's latency in the window, from when it was due to
when its answers were synchronised), ``peak_mem_gib`` and ``setup_s``.
Traced: the first ``TRACE_SECONDS`` of the window.
"""

from __future__ import annotations

import contextlib

from ..harness import TRACE_SECONDS, Run, now, percentile, rate


def block(sizes: list[int], generator, torch) -> list[int]:
    """Every size once, in an order drawn from ``generator``."""
    return [sizes[i] for i in torch.randperm(len(sizes), generator=generator).tolist()]


def kept(seq: list[int], sizes: list[int], per_size: int, within: int, generator, torch) -> set[int]:
    """Indices of the batches whose answers are judged: of each size,
    ``per_size`` of its first ``within`` occurrences, drawn from ``generator``."""
    out = set()
    for m in sizes:
        where = [i for i, s in enumerate(seq) if s == m][:within]
        pick = torch.randperm(len(where), generator=generator)[:per_size].tolist()
        out.update(where[i] for i in pick)
    return out


def run(ctx) -> Run:
    torch, tr = ctx.torch, ctx.traffic
    d = ctx.config["d"]
    sizes = tr["batch_sizes"]
    host = torch.Generator().manual_seed(ctx.seed)
    seq = [m for _ in range(tr["kept_within"]) for m in block(sizes, host, torch)]
    keep = kept(seq, sizes, tr["kept_per_size"], tr["kept_within"], host, torch)
    sut = ctx.system.Server(ctx)
    queries = torch.Generator(device=ctx.device).manual_seed(ctx.seed + 1)
    for m in sizes:  # every shape the window sends, once
        sut.query(torch.randn(m, d, device=ctx.device, generator=queries))
    ctx.sync()
    ctx.setup_done()

    traced = contextlib.ExitStack()
    if ctx.trace:
        prof = traced.enter_context(ctx.profiler())
        traced.enter_context(torch.profiler.record_function("window"))
    tracing, traced_upto = ctx.trace, 0

    def span(name):
        return torch.profiler.record_function(name) if tracing else contextlib.nullcontext()

    answers, latencies, points, i = [], [], 0, 0
    with traced:
        t0 = due = now()
        while True:
            if i == len(seq):
                seq.extend(block(sizes, host, torch))
            m = seq[i]
            x_star = torch.randn(m, d, device=ctx.device, generator=queries)
            with span("query"):
                mean, var = sut.query(x_star)
                ctx.sync()
            t = now()
            latencies.append(t - due)
            due = t
            if i in keep:
                answers.append((x_star, mean, var))
            points += m
            i += 1
            if tracing and (t - t0 >= TRACE_SECONDS or t - t0 >= ctx.seconds):
                traced.close()
                tracing, traced_upto = False, i
            if t - t0 >= ctx.seconds:
                break
        elapsed = now() - t0
    out = Run(attempted=i)
    out.peak_bytes = ctx.peak_bytes()
    out.metrics["query_points_per_s"] = rate(points, elapsed)
    out.metrics["query_ms_p95"] = 1e3 * percentile(latencies, 95)
    if ctx.trace:
        out.trace = ctx.reduce(prof)
        out.trace.counters.update(batches=seq[:traced_upto], config=ctx.config,
                                  root_columns=sut.cache.root_inv.shape[-1])
    sut.release()
    ctx.empty_cache()
    out.checks = sut.judge(answers)
    return out
