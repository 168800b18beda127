"""The control, the plain reference in the port's place in float32 with TF32
products, comes out not correct at each cell's own size on the card.
Marked ``cuda``: it skips without a card.  Run it on the card with
``python -m pytest -m cuda benchmark/tests``."""

import json

import pytest

from benchmark import control, harness


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in harness.load_manifest()["workloads"]])
def test_the_control_fails_a_compared_number(cell, capsys):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control's TF32 products exist only on the card")
    assert control.main(["--workload", cell, "--variant", "control", "--seeds", "21"]) == 0
    checks = json.loads(capsys.readouterr().out.strip().splitlines()[-1])["checks"]
    limits = harness.resolve(harness.load_manifest(), cell).limits
    assert any(checks[name] > limit for name, limit in limits.items())
