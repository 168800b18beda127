"""The port's examples (``examples/torch_*.py``) on the CPU: each one's
``main`` in this process at a tiny size with ``--device cpu`` (the sharded
one as a world of one rank, which ``initialize_distributed`` joins and
leaves), holding that every training loss falls and every output is
finite, whatever torch's default dtype (the examples make f32 data, the
models' dtype).  At their default sizes they run on the card
(``chip_smoke.py`` phase 20)."""

import importlib.util
import math
from pathlib import Path

import pytest
import torch

from test_torch_harness_common import one_torch_thread  # noqa: F401 (an autouse fixture)

EXAMPLES = Path(__file__).resolve().parent.parent / "examples"

# each example's tiny command line
ARGS = {
    "torch_demo": ["--woodbury-n", "1000", "--gp-n", "48", "--kron", "6,4", "--sample-side", "4"],
    "torch_train_gp": ["--n", "48", "--steps", "3", "--grid", "16", "--inducing", "8"],
    "torch_multitask_lmc": ["--n", "12", "--steps", "3"],
    "torch_train_sharded": ["--n", "32", "--steps", "5"],
}


def _load(name: str):
    spec = importlib.util.spec_from_file_location(name, EXAMPLES / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _losses(out: dict) -> dict:
    """{part: [first, last]} of every training loss in a summary."""
    found = {key: v["loss"] for key, v in out.items() if isinstance(v, dict) and "loss" in v}
    if "loss" in out:
        found["main"] = out["loss"]
    return found


@pytest.mark.parametrize("name", list(ARGS))
def test_port_example_runs_on_the_cpu(name):
    default = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)  # as a test before it may leave it
    try:
        out = _load(name).main(["--device", "cpu", *ARGS[name]])
    finally:
        torch.set_default_dtype(default)
    assert out["example"] == name and out["finite"]
    losses = _losses(out)
    assert losses, out
    for part, (first, last) in losses.items():
        assert math.isfinite(first) and math.isfinite(last)
        assert last < first, (part, first, last)
    if name == "torch_train_sharded":
        assert out["world"] == 1 and out["mesh"] == {"data": 1, "model": 1}
