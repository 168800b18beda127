"""What every cell shares: the manifest and the files it names, the window's
arithmetic, the comparison's records, the check that no JAX module is loaded,
and the result line.

Each piece that belongs to one configuration, traffic mix or per-layer metric
is a file of its own, found by the name BENCHMARK.json gives it:
``configs/<config>.json``, ``traffic/<mix>.json`` (read by the loop that its
``"loop"`` key names, ``loops/<loop>.py``), ``systems/<system>.py`` (the
configuration's ``"system"``: how the port is driven), ``metrics/<metric>.py``
(one per-layer reader) and ``limits/<cell>.json`` (the comparison's limits).
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import math
import os
import statistics
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# a traced run profiles the window's first seconds (the trace of a whole
# long window would take minutes to read back)
TRACE_SECONDS = 10.0
# top-level module names that no run may hold once its window has closed
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "linear_operator_tpu")


def load_manifest(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def find(entries: list[dict], name: str, what: str) -> dict:
    for entry in entries:
        if entry["name"] == name:
            return entry
    raise SystemExit(f"no {what} named {name!r} in BENCHMARK.json")


def read_json(kind: str, name: str, here: Path = HERE) -> dict:
    """``<kind>/<name>.json`` under the benchmark's folder."""
    return json.loads((here / kind / f"{name}.json").read_text())


def load_module(kind: str, name: str, here: Path = HERE):
    """``<kind>/<name>.py`` under the benchmark's folder, loaded by its path
    (a metric's name may hold dots)."""
    path = here / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_{kind}_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclass
class Cell:
    """One workload of BENCHMARK.json with what its names point to."""

    workload: dict
    config: dict
    traffic: dict
    end_to_end: list[dict]  # the end-to-end metrics this cell reports
    per_layer: list[dict]  # the per-layer metrics this cell reports
    limits: dict

    @property
    def name(self) -> str:
        return self.workload["name"]


def _reports(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def resolve(manifest: dict, workload: str, here: Path = HERE) -> Cell:
    w = find(manifest["workloads"], workload, "workload")
    find(manifest["configs"], w["config"], "configuration")
    limits_path = here / "limits" / f"{workload}.json"
    return Cell(
        workload=w,
        config=read_json("configs", w["config"], here),
        traffic=read_json("traffic", w["traffic"], here),
        end_to_end=[m for m in manifest["end_to_end"] if _reports(m, workload)],
        per_layer=[m for m in manifest["per_layer"] if _reports(m, workload)],
        limits=json.loads(limits_path.read_text()) if limits_path.exists() else {},
    )


def process_start_seconds() -> float:
    """Seconds since this process started, from the kernel's record of its
    start time (clock ticks since boot) and the boot time."""
    ticks = os.sysconf("SC_CLK_TCK")
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / ticks


# ---------------------------------------------------------------------------
# The window's arithmetic
# ---------------------------------------------------------------------------


def rate(count: float, seconds: float) -> float:
    """Work completed over the window's seconds."""
    if seconds <= 0:
        raise ValueError("a window has a positive length")
    return count / seconds


def spread(values: list[float]) -> float:
    """The distance between the first and third quartiles as a share of the
    median, as statistics.quantiles(values, n=4) gives them."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med


def percentile(values: list[float], q: int) -> float:
    """The q-th percentile, interpolated between the two nearest of the
    sorted values (``statistics.quantiles`` with ``method="inclusive"``)."""
    if len(values) == 1:
        return values[0]
    return statistics.quantiles(values, n=100, method="inclusive")[q - 1]


def idle_share(busy_s: float, window_s: float) -> float:
    """Per cent of the window in which no operation ran on the device."""
    return 100.0 * (1.0 - busy_s / window_s)


# ---------------------------------------------------------------------------
# The comparison that decides ``correct``
# ---------------------------------------------------------------------------


@dataclass
class Check:
    """One number read, with its limit where the cell compares it (``value``
    at or under ``limit`` passes); a number without a limit is a reading
    only."""

    name: str
    value: float
    limit: float | None

    @property
    def compared(self) -> bool:
        return self.limit is not None

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


def correct(checks: list[Check]) -> bool:
    """True where the cell compares some number and every one passes: a cell
    with no limits set is never correct."""
    compared = [c for c in checks if c.compared]
    return bool(compared) and all(c.ok for c in compared)


def checks_against(limits: dict, values: dict[str, float]) -> list[Check]:
    return [Check(name, float(value), limits.get(name)) for name, value in values.items()]


def leaf_gaps(program: dict[str, float], reference: dict[str, float], keep=None) -> float:
    """The worst leaf's gap of norms, each against the larger of the
    reference's norm of that leaf and of the median leaf.  ``keep`` names
    the leaves compared (all by default)."""
    med = statistics.median(reference.values())
    names = [k for k in reference if keep is None or k in keep]
    return max(abs(program[k] - reference[k]) / max(reference[k], med) for k in names)


def moved_leaves(ref_grad: dict[str, float]) -> set[str]:
    """The leaves whose reference gradient is at least a thousandth of the
    median leaf's: the others move under Adam by round-off alone."""
    med = statistics.median(ref_grad.values())
    return {k for k, v in ref_grad.items() if v >= 1e-3 * med}


# ---------------------------------------------------------------------------
# Data from the seed
# ---------------------------------------------------------------------------


def regression_data(torch, n: int, d: int, noise_std: float, generator, device):
    """x (n, d) ~ N(0, I) and y = sin(3 x_0) + noise_std * eps, on the device,
    from ``generator``."""
    x = torch.randn(n, d, device=device, generator=generator)
    y = torch.sin(3.0 * x[:, 0]) + noise_std * torch.randn(n, device=device, generator=generator)
    return x, y


@contextlib.contextmanager
def matmul_tf32(torch, allowed: bool):
    """Float32 products in TF32 (``allowed``) or in full float32."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = allowed
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def no_tf32(torch):
    return matmul_tf32(torch, False)


def apply_settings(lo, settings: dict):
    """The port's settings the configuration states, as one context."""
    stack = contextlib.ExitStack()
    for key, value in settings.items():
        stack.enter_context(getattr(lo.settings, key)(value))
    return stack


# ---------------------------------------------------------------------------
# The result
# ---------------------------------------------------------------------------


def forbidden_modules() -> list[str]:
    return sorted({m.split(".", 1)[0] for m in sys.modules} & set(FORBIDDEN_MODULES))


def device_info(torch, count: int, peak_bytes: int) -> dict:
    return {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": count,
        "memory_peak_bytes": int(peak_bytes),
    }


def metric(value: float, unit: str) -> dict:
    return {"value": value, "unit": unit}


def finish(result: dict, checks: list[Check]) -> int:
    """Prints the compared numbers beside their limits on standard error and
    the result line on standard output; refuses (exit 3, no result) where a
    JAX module is loaded."""
    found = forbidden_modules()
    if found:
        print(f"the run loaded {', '.join(found)}: the benchmark may load neither JAX nor the JAX package",
              file=sys.stderr, flush=True)
        return 3
    for c in checks:
        if not c.compared:
            print(f"reading {c.name}: {c.value!r} (not compared)", file=sys.stderr)
    compared = [c for c in checks if c.compared]
    for c in compared:
        print(f"check {c.name}: {c.value!r} limit {c.limit!r} {'ok' if c.ok else 'FAILED'}", file=sys.stderr)
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in compared}
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


def now() -> float:
    return time.perf_counter()


@dataclass
class Run:
    """What a loop hands the harness: its end-to-end metrics, the compared
    numbers, what the traced window saw, and the counts."""

    metrics: dict = field(default_factory=dict)
    checks: list = field(default_factory=list)
    attempted: int = 0
    failed: int = 0
    peak_bytes: int = 0
    trace: object = None
