"""A run with the timed path broken underneath comes out not correct: the
harness's look for a card skipped, everything else of a run driven on the
CPU at a small size, once sound and once for each fault the cell can have
(a step that leaves the state unchanged; half of the batch left out, the
mean taken over the rest; an answer altered where it is produced; serving's
cache cut short, its solve or its root)."""

import json

import pytest

from benchmark import control, run
from benchmark.systems import exact_gp
from benchmark.training import AdamTrainer

SMALL = {
    "exact-rbf-n100k.train": {"n": 2500, "model_kwargs": {"materialize_threshold": None}},
    "exact-rbf-n100k.love": {"n": 2500},
}


def _correct(cell, capsys) -> bool:
    rc = run.main(["--workload", cell, "--seed", str(2**31 + 11), "--seconds", "2", "--trace", "0"],
                  device="cpu", overrides=json.loads(json.dumps(SMALL[cell])),
                  traffic={"kept_per_size": 1, "kept_within": 1} if cell.endswith(".love") else None)
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])["correct"]


def _half(trainer_loss):
    def loss(self):
        full = self.x, self.y
        half = self.x.shape[0] // 2
        self.x, self.y = full[0][:half], full[1][:half]
        try:
            return trainer_loss(self)
        finally:
            self.x, self.y = full

    return loss


def _doubled(self, loss):
    loss.backward()
    for p in self.model.parameters():
        p.grad.mul_(2.0)


@pytest.mark.parametrize("fault", [None, "unchanged", "half_batch", "altered"])
def test_training_faults_come_out_not_correct(fault, capsys, monkeypatch):
    if fault == "unchanged":
        monkeypatch.setattr(AdamTrainer, "update", lambda self: self.opt.zero_grad(set_to_none=True))
    elif fault == "half_batch":
        monkeypatch.setattr(exact_gp.Trainer, "loss", _half(exact_gp.Trainer.loss))
    elif fault == "altered":
        monkeypatch.setattr(exact_gp.Trainer, "backward", _doubled)
    assert _correct("exact-rbf-n100k.train", capsys) is (fault is None)


@pytest.mark.parametrize("fault", [None, "half_batch", "altered", "short_solve", "short_root"])
def test_serving_faults_come_out_not_correct(fault, capsys, monkeypatch):
    real = exact_gp.Server.query

    def query(self, x_star):
        cache, x = self.cache, self.x
        if fault == "half_batch":
            half = x.shape[0] // 2
            x, cache = x[:half], cache._replace(alpha=cache.alpha[:half], root_inv=cache.root_inv[:half])
        else:
            cache = cache._replace(root_inv=cache.root_inv[:, : cache.root_inv.shape[1] // 2])
        with self.ctx.torch.no_grad():
            return self.model.posterior_from_cache(x, cache, x_star)

    def init(self, ctx):
        real_init(self, ctx)
        control.plant_short(self, ctx, fault)

    real_init = exact_gp.Server.__init__
    if fault in ("short_solve", "short_root"):
        monkeypatch.setattr(exact_gp.Server, "__init__", init)
    elif fault is not None:
        monkeypatch.setattr(exact_gp.Server, "query", query)
    assert real is not None
    assert _correct("exact-rbf-n100k.love", capsys) is (fault is None)
