"""Run one cell of BENCHMARK.json once, on the card(s) of this machine:

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up builds the cell's system from the seed and warms every shape its
traffic uses (``setup_s``: process start to the window's start); the window
runs the traffic for ``--seconds``; then the device memory's peak is read,
the port's state freed, and the plain reference judges what the window's
path produced.  The last line of standard output is one JSON object
(``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
``--trace 1`` also ``breakdown``, and last ``checks``: each number compared
with its limit, which also close standard error).  With ``--trace 0`` the
metrics are the cell's end-to-end metrics, with ``--trace 1`` its per-layer
metrics, read from a ``torch.profiler`` trace of the window.

Exits non-zero with no result line where no CUDA device (or fewer than the
cell asks for) is present, where the port cannot be imported, or where a JAX
module is loaded once the window has closed.
"""

from __future__ import annotations

import argparse
import importlib
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

PORT = "linear_operator_tpu_torch"


class Context:
    """What a cell's loop and system are handed."""

    def __init__(self, cell, args, torch, lo, harness, devtrace, device):
        self.config = cell.config
        self.traffic = cell.traffic
        self.limits = cell.limits
        self.seed = args.seed
        self.seconds = args.seconds
        self.trace = bool(args.trace)
        self.torch = torch
        self.lo = lo
        self.device = torch.device(device)
        self.system = importlib.import_module(f"benchmark.systems.{cell.config['system']}")
        self.setup_s = None
        self._harness = harness
        self._devtrace = devtrace

    def sync(self) -> None:
        if self.device.type == "cuda":
            self.torch.cuda.synchronize()

    def peak_bytes(self) -> int:
        return self.torch.cuda.max_memory_allocated() if self.device.type == "cuda" else 0

    def empty_cache(self) -> None:
        if self.device.type == "cuda":
            self.torch.cuda.empty_cache()

    def setup_done(self) -> None:
        self.setup_s = self._harness.process_start_seconds()

    def profiler(self):
        return self._devtrace.profiler(self.torch)

    def reduce(self, prof):
        return self._devtrace.reduce(self.torch, prof)


def main(argv=None, device: str | None = None, overrides: dict | None = None, traffic: dict | None = None) -> int:
    """``device``, ``overrides`` and ``traffic`` (keys of the configuration
    and of the traffic mix replaced) are for the tests, which drive a run on
    the CPU at a small size."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    from benchmark import devtrace, harness

    cell = harness.resolve(harness.load_manifest(), args.workload)
    cell.config.update(overrides or {})
    cell.traffic.update(traffic or {})
    import torch

    chips = cell.workload["chips"]
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            found = torch.cuda.device_count() if torch.cuda.is_available() else 0
            print(f"the cell asks for {chips} CUDA device(s); this machine has {found}", file=sys.stderr)
            return 2
        torch.cuda.reset_peak_memory_stats()
        device = "cuda"
    lo = importlib.import_module(PORT)
    ctx = Context(cell, args, torch, lo, harness, devtrace, device)
    loop = importlib.import_module(f"benchmark.loops.{cell.traffic['loop']}")
    out = loop.run(ctx)

    result = {
        "correct": harness.correct(out.checks),
        "attempted": out.attempted,
        "failed": out.failed,
        "metrics": {},
        "device": harness.device_info(torch, chips, out.peak_bytes) if device == "cuda" else {"platform": "cpu"},
    }
    if args.trace:
        trace = out.trace
        result["device"].update(busy_s=trace.busy_s, window_s=trace.window_s)
        for m in cell.per_layer:
            value = harness.load_module("metrics", m["name"]).read(trace)
            if value is not None:
                result["metrics"][m["name"]] = harness.metric(value, m["unit"])
        result["breakdown"] = trace.breakdown()
    else:
        out.metrics["peak_mem_gib"] = out.peak_bytes / 2**30
        out.metrics["setup_s"] = ctx.setup_s
        units = {m["name"]: m["unit"] for m in cell.end_to_end}
        result["metrics"] = {k: harness.metric(v, units[k]) for k, v in out.metrics.items() if k in units}
    return harness.finish(result, out.checks)


if __name__ == "__main__":
    os.environ.setdefault("USE_FLAX", "0")
    sys.exit(main())
