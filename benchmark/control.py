"""Readings of a cell's comparison for its limits, on the card at the cell's
own size, one seed after another in one process:

    python benchmark/control.py --workload <cell> --variant <v> --seeds 1 2 3 [--seconds 2]

Variants: ``program`` (the port as the benchmark runs it), ``control`` (the
plain reference in the port's place, in float32 with TF32 products: the
nearest precision below the configuration's float32 with TF32 off), and the
faults planted in the port: ``unchanged`` (a training step that leaves the
parameters as they were), ``half_batch`` (half of the rows left out, the
mean taken over the rest), ``altered`` (a training step's gradient doubled
where the loss's backward produces it; a served variance from half of the
cache's root columns), ``short_solve`` (serving: the cache's alpha from a
CG stopped after half of the iterations its solve runs) and ``short_root``
(serving: the cache's root from half of the stated Lanczos steps).
Each seed prints one line: {"seed", "variant", "checks": {name: value}}.
The benchmark's own runs never run this.  A training cell runs only its
recorded steps (no window); a serving cell runs ``--seconds`` of its traffic.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

VARIANTS = ("program", "control", "unchanged", "half_batch", "altered", "short_solve", "short_root")
# the LOVE cache's solve runs 10 CG iterations (the port's least; the stated
# tolerance is met by then): the short solve stops after half of them
SHORT_CG_ITERATIONS = 5


def tf32(torch):
    """TF32 products on, for the control."""
    from benchmark.harness import matmul_tf32

    return matmul_tf32(torch, True)


def training_record(trainer, variant: str, steps: int) -> dict:
    torch = trainer.torch
    if variant == "control":
        with tf32(torch):
            return trainer.control(steps)
    if variant == "unchanged":
        trainer.update = lambda: trainer.opt.zero_grad(set_to_none=True)
    elif variant == "half_batch":
        full = trainer.x, trainer.y
        half = trainer.x.shape[0] // 2
        trainer.x, trainer.y = full[0][:half], full[1][:half]
        try:
            return trainer.steps_recorded(steps)
        finally:
            trainer.x, trainer.y = full
    elif variant == "altered":
        real = trainer.backward

        def backward(loss):
            real(loss)
            for p in trainer.model.parameters():
                p.grad.mul_(2.0)

        trainer.backward = backward
    return trainer.steps_recorded(steps)


def plant_short(server, ctx, fault: str) -> None:
    """The server's cache with its alpha from the port's own solve stopped
    after ``SHORT_CG_ITERATIONS`` CG iterations (``short_solve``, the root
    kept) or its root from half of the stated Lanczos steps (``short_root``,
    alpha kept)."""
    torch, settings = ctx.torch, ctx.lo.settings
    if fault == "short_solve":
        setting, field = settings.max_cg_iterations(SHORT_CG_ITERATIONS), "alpha"
    else:
        setting, field = settings.max_root_decomposition_size(
            ctx.config["settings"]["max_root_decomposition_size"] // 2), "root_inv"
    with setting, torch.no_grad():
        short = server.model.posterior_cache(server.x, server.y)
    server.cache = server.cache._replace(**{field: getattr(short, field)})


def serving_system(system, variant: str, torch):
    """The system's Server with the variant's fault planted in its cache or
    its answers."""

    class Server(system.Server):
        def __init__(self, ctx):
            super().__init__(ctx)
            if variant in ("short_solve", "short_root"):
                plant_short(self, ctx, variant)

        def judge(self, answers):
            if variant == "control":
                with tf32(torch):
                    return super().judge(*self.control(answers))
            if variant in ("half_batch", "altered"):
                return super().judge(*self.faulty(answers, variant))
            return super().judge(answers)

    return types.SimpleNamespace(Server=Server)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--variant", choices=VARIANTS, required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--seconds", type=float, default=2.0)
    args = parser.parse_args(argv)

    import torch

    from benchmark import devtrace, harness, run

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    lo = importlib.import_module(run.PORT)
    for seed in args.seeds:
        cell = harness.resolve(harness.load_manifest(), args.workload)
        ns = argparse.Namespace(seed=seed, seconds=args.seconds, trace=0)
        ctx = run.Context(cell, ns, torch, lo, harness, devtrace, "cuda")
        if cell.traffic["loop"] == "train":
            trainer = ctx.system.Trainer(ctx)
            record = training_record(trainer, args.variant, cell.traffic["checked_steps"])
            trainer.release()
            ctx.empty_cache()
            checks = trainer.judge(record)
        else:
            ctx.system = serving_system(ctx.system, args.variant, torch)
            loop = importlib.import_module(f"benchmark.loops.{cell.traffic['loop']}")
            checks = loop.run(ctx).checks
        print(json.dumps({"seed": seed, "variant": args.variant, "workload": args.workload,
                          "checks": {c.name: c.value for c in checks}}), flush=True)
        ctx.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
