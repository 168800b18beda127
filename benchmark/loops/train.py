"""Closed-loop training: one trainer steps as fast as the system lets it.

Traffic keys: ``epoch_steps`` (the parameters and the optimizer go back to
their initial state every so many steps, so that every run does the same
work a step whatever its speed) and ``checked_steps`` (the first steps, run
in set-up through the window's own calls and recorded for the reference).

End-to-end: ``train_steps_per_s`` (steps completed in the window over its
seconds; a step is the loss, its backward and the optimizer's update, ending
in a synchronise), ``peak_mem_gib`` and ``setup_s``.  Traced (the first
``TRACE_SECONDS`` of the window): the spans "fwd" and "bwd" (each ending in a
synchronise) and the CG iterations that the port's ``verbose_linalg`` log
reports.
"""

from __future__ import annotations

import contextlib
import logging

from ..harness import TRACE_SECONDS, Run, now, rate


class SolverLog(logging.Handler):
    """linear_cg's iteration counts from the port's ``verbose_linalg`` log."""

    def __init__(self):
        super().__init__(logging.DEBUG)
        self.cg: list[int] = []

    def emit(self, record):
        if record.msg.startswith("linear_cg finished"):
            self.cg.append(int(record.args[0]))


def run(ctx) -> Run:
    torch = ctx.torch
    epoch, checked = ctx.traffic["epoch_steps"], ctx.traffic["checked_steps"]
    sut = ctx.system.Trainer(ctx)
    program = sut.steps_recorded(checked)
    steps = checked
    ctx.sync()
    ctx.setup_done()

    spans = {"fwd": [], "bwd": []}
    log = SolverLog()
    logger = ctx.lo.settings.verbose_linalg.logger()
    traced = contextlib.ExitStack()
    if ctx.trace:
        logger.addHandler(log)
        logger.setLevel(logging.DEBUG)
        traced.enter_context(ctx.lo.settings.verbose_linalg(True))
        prof = traced.enter_context(ctx.profiler())
        traced.enter_context(torch.profiler.record_function("window"))
    tracing, traced_steps = ctx.trace, 0

    def span(name):
        return torch.profiler.record_function(name) if tracing else contextlib.nullcontext()

    done = 0
    with traced:
        t0 = now()
        while True:
            if steps % epoch == 0:
                with span("reset"):
                    sut.reset()
            with span("step"):
                t = now()
                with span("fwd"):
                    loss = sut.loss()
                    if tracing:
                        ctx.sync()
                        spans["fwd"].append(now() - t)
                t = now()
                with span("bwd"):
                    sut.backward(loss)
                    if tracing:
                        ctx.sync()
                        spans["bwd"].append(now() - t)
                with span("opt"):
                    sut.update()
                ctx.sync()
            steps += 1
            done += 1
            t = now()
            if tracing and (t - t0 >= TRACE_SECONDS or t - t0 >= ctx.seconds):
                traced.close()
                logger.removeHandler(log)
                tracing, traced_steps = False, done
            if t - t0 >= ctx.seconds:
                break
        elapsed = now() - t0
    out = Run(attempted=done)
    out.peak_bytes = ctx.peak_bytes()
    out.metrics["train_steps_per_s"] = rate(done, elapsed)
    if ctx.trace:
        out.trace = ctx.reduce(prof)
        out.trace.counters.update(steps=traced_steps, cg_iters=list(log.cg), fwd_s=spans["fwd"],
                                  bwd_s=spans["bwd"], config=ctx.config)
    del loss
    sut.release()
    ctx.empty_cache()
    out.checks = sut.judge(program)
    return out
