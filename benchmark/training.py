"""What a training cell's system shares: one model and one Adam optimizer,
built once from the seed, stepped by the window's own calls, reset to the
initial state at each epoch's start, and the record of its first steps that
the reference follows."""

from __future__ import annotations

from .harness import Check, leaf_gaps, moved_leaves


class AdamTrainer:
    """A subclass builds ``self.model`` (an nn.Module) and defines ``loss()``;
    ``lr`` is the configuration's.  ``steps_recorded`` collects what the
    reference needs before each recorded step (``before_step``)."""

    def __init__(self, torch, lr: float):
        self.torch = torch
        self.lr = lr
        self.initial = {k: v.detach().clone() for k, v in self.model.state_dict().items()}
        self.opt = torch.optim.Adam(self.model.parameters(), lr=lr)

    def loss(self):
        raise NotImplementedError

    def backward(self, loss) -> None:
        loss.backward()

    def update(self) -> None:
        self.opt.step()
        self.opt.zero_grad(set_to_none=True)

    def reset(self) -> None:
        """The epoch's start: the initial parameters and a fresh optimizer."""
        self.model.load_state_dict(self.initial)
        self.opt = self.torch.optim.Adam(self.model.parameters(), lr=self.lr)

    def before_step(self) -> dict:
        return {}

    def steps_recorded(self, count: int) -> dict:
        """The first ``count`` steps through the window's own calls, with
        each step's loss, the first gradient as Adam holds it after one step
        (exp_avg / (1 - beta1)), and each leaf's change after the steps."""
        start = {k: p.detach().clone() for k, p in self.model.named_parameters()}
        records = []
        for s in range(count):
            rec = self.before_step()
            loss = self.loss()
            self.backward(loss)
            self.update()
            rec["loss"] = float(loss.detach())
            records.append(rec)
            if s == 0:
                beta1 = self.opt.param_groups[0]["betas"][0]
                state = {k: self.opt.state.get(p, {}).get("exp_avg") for k, p in self.model.named_parameters()}
                grad0 = {k: 0.0 if v is None else float(v.norm()) / (1.0 - beta1) for k, v in state.items()}
        change = {k: float((p.detach() - start[k]).norm()) for k, p in self.model.named_parameters()}
        return {"records": records, "losses": [r["loss"] for r in records], "grad0": grad0, "change": change}

    def release(self) -> None:
        """Frees the program's state before the reference runs."""
        del self.model, self.opt, self.initial


def training_checks(limits: dict, program: dict, reference: dict) -> list[Check]:
    """The numbers a training cell reads; those its limits name are compared.

    ``loss``: the worst step's loss gap, in the loss's own units (nats a
    point: a loss near 0 makes a share of it meaningless); ``loss_first``:
    the first step's.  ``grad``: the worst leaf's gap of first-gradient
    norms, each against the larger of the reference's norm of the leaf and
    of the median leaf; ``grad_norm``: the gap of the whole first gradient's
    norms against the reference's.  ``change``: the worst leaf's gap of
    change norms after the steps, over the leaves the reference moves."""
    keep = moved_leaves(reference["grad0"])
    values = {
        "loss": max(abs(p - r) for p, r in zip(program["losses"], reference["losses"])),
        "loss_first": abs(program["losses"][0] - reference["losses"][0]),
        "grad": leaf_gaps(program["grad0"], reference["grad0"]),
        "grad_norm": abs(_norm(program["grad0"]) - _norm(reference["grad0"])) / _norm(reference["grad0"]),
        "change": leaf_gaps(program["change"], reference["change"], keep),
    }
    return [Check(k, float(v), limits.get(k)) for k, v in values.items()]


def _norm(leaves: dict[str, float]) -> float:
    return sum(v * v for v in leaves.values()) ** 0.5
