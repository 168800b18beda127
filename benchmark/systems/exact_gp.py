"""The port's exact GP (``linear_operator_tpu_torch.models.ExactGPRegression``)
under test: a training step (``neg_mll``, its backward, Adam) and LOVE
serving (``posterior_cache`` once, ``posterior_from_cache`` a batch).

The configuration gives n, d, the data's noise, the initial raw parameters,
the port's settings and Adam's learning rate; the run's seed gives the
probes, the Lanczos start, the queries and, unless the traffic mix fixes it,
the data set."""

from __future__ import annotations

from ..harness import apply_settings, checks_against, no_tf32, regression_data
from ..reference import exact_gp as ref_gp
from ..reference import love as ref_love
from ..reference import rbf
from ..training import AdamTrainer, training_checks


RAW = ("raw_lengthscale", "raw_outputscale", "raw_noise")


def _model(ctx):
    lo, torch, cfg = ctx.lo, ctx.torch, ctx.config
    model = lo.ExactGPRegression(device=ctx.device, **cfg.get("model_kwargs", {}))
    init = cfg["init"]
    with torch.no_grad():
        for name in RAW:
            getattr(model, name).fill_(init[name])
    return model


def _data(ctx):
    """x, y and the generator of the run's own draws (probes, the Lanczos
    start), seeded by the run's seed.  A traffic mix that names a
    ``data_seed`` fixes the data set (training: a step's CG iterations
    follow the data, so every run does the same work); otherwise the data
    set is the seed generator's first draws."""
    torch, cfg = ctx.torch, ctx.config
    gen = torch.Generator(device=ctx.device).manual_seed(ctx.seed)
    fixed = ctx.traffic.get("data_seed")
    data = gen if fixed is None else torch.Generator(device=ctx.device).manual_seed(fixed)
    x, y = regression_data(torch, cfg["n"], cfg["d"], cfg["data_noise"], data, ctx.device)
    return x, y, gen


class Trainer(AdamTrainer):
    def __init__(self, ctx):
        self.ctx = ctx
        self.x, self.y, self.gen = _data(ctx)
        self.first_state = self.gen.get_state()
        self.model = _model(ctx)
        self.settings = apply_settings(ctx.lo, ctx.config["settings"])
        self.settings.__enter__()
        super().__init__(ctx.torch, ctx.config["lr"])

    def loss(self):
        return self.model.neg_mll(self.x, self.y, generator=self.gen)

    def before_step(self) -> dict:
        return {"generator_state": self.gen.get_state()}

    def release(self) -> None:
        super().release()
        self.settings.__exit__(None, None, None)

    def _raw0(self, dtype):
        cfg = self.ctx.config
        return self.torch.tensor([cfg["init"][k] for k in RAW],
                                 dtype=dtype, device=self.x.device)

    def control(self, steps: int) -> dict:
        """The reference in the port's place, in float32 with TF32 products,
        its probes from the generator the port would use."""
        gen = self.torch.Generator(device=self.gen.device)
        gen.set_state(self.first_state)
        return ref_gp.training_steps(self.x, self.y, self._raw0(self.torch.float32), self.ctx.config["settings"],
                                     self.ctx.config["lr"], [gen] * steps)

    def judge(self, program: dict) -> list:
        """The reference follows the recorded steps at the configuration's
        precision (float32, TF32 off) from x, y, the initial parameters and
        each step's generator state."""
        torch, cfg = self.torch, self.ctx.config
        gens = []
        for rec in program["records"]:
            g = torch.Generator(device=self.gen.device)
            g.set_state(rec["generator_state"])
            gens.append(g)
        with no_tf32(torch):
            ref = ref_gp.training_steps(self.x, self.y, self._raw0(torch.float32), cfg["settings"], cfg["lr"], gens)
        return training_checks(self.ctx.limits, program, ref)


class Server:
    """LOVE: the cache built once in set-up (the traffic needs it), then
    ``query`` per batch."""

    def __init__(self, ctx):
        self.ctx = ctx
        torch = ctx.torch
        self.x, self.y, self.gen = _data(ctx)
        self.first_state = self.gen.get_state()
        self.model = _model(ctx)
        self.settings = apply_settings(ctx.lo, ctx.config["settings"])
        self.settings.__enter__()
        with torch.no_grad():
            self.cache = self.model.posterior_cache(self.x, self.y, generator=self.gen)

    def query(self, x_star):
        with self.ctx.torch.no_grad():
            return self.model.posterior_from_cache(self.x, self.cache, x_star)

    def release(self) -> None:
        """Keeps the port's cache (its queries are judged on it) and frees
        the model."""
        self.alpha, self.root = self.cache.alpha[:, 0], self.cache.root_inv
        del self.model, self.cache
        self.settings.__exit__(None, None, None)

    def _hyper(self):
        raw = self.ctx.torch.tensor([self.ctx.config["init"][k] for k in RAW], dtype=self.ctx.torch.float64)
        return [float(v) for v in ref_gp.softplus(raw)]

    def reference_cache(self):
        """The reference's own cache in float32, from x, y and the generator
        state the port's cache build started from; the products' precision
        is the caller's."""
        ls, os, s2 = self._hyper()
        gen = self.ctx.torch.Generator(device=self.gen.device)
        gen.set_state(self.first_state)
        return ref_love.cache(self.x, self.y, ls, os, s2, self.ctx.config["settings"], gen)

    def control(self, answers: list):
        """The reference in the port's place, with TF32 products (the
        caller's): its own cache and its answers."""
        ls, os, _ = self._hyper()
        alpha, root = self.reference_cache()
        return [(xs, *ref_love.predict(self.x, alpha, root, xs, ls, os)) for xs, _, _ in answers], alpha, root

    def faulty(self, answers: list, fault: str):
        """Answers with a fault planted in the reference put in the port's
        place (float32, on the port's cache): ``half_batch`` from half of the
        training rows, ``altered`` variances from half of the root's
        columns."""
        ls, os, _ = self._hyper()
        x, alpha, root = self.x, self.alpha, self.root
        if fault == "half_batch":
            half = x.shape[0] // 2
            x, alpha, root = x[:half], alpha[:half], root[:half]
        else:
            root = root[:, : root.shape[1] // 2]
        return [(xs, *ref_love.predict(x, alpha, root, xs, ls, os)) for xs, _, _ in answers], self.alpha, self.root

    def judge(self, answers: list, alpha=None, root=None) -> list:
        """``answers``: (x_star, mean, variance) of the batches kept, from the
        cache (alpha, root), the port's where not given.  The query stage:
        the worst mean gap as a share of the largest reference mean and the
        worst variance gap as a share of the prior variance, against the
        float64 reference's answers on the same cache.  The cache stage by
        itself, with K the training covariance (noise added): alpha's
        relative residual |K alpha - y| / |y| in float64 (the configuration
        states its limit, ``cg_tolerance``) and its relative gap from the
        reference's own alpha (float32, TF32 off); the root's residual, the
        root mean square entry of R^T K R - I in float64 (R R^T ~= K^-1 holds
        on R's columns), and the gap of its column count from the stated
        ``max_root_decomposition_size``.  Read, not compared: the worst gap
        of the float64 variances on the two caches (R is not unique, and two
        roots of 100 Lanczos steps from one start differ by LOVE's own
        approximation error)."""
        torch = self.ctx.torch
        alpha = self.alpha if alpha is None else alpha
        root = self.root if root is None else root
        ls, os, s2 = self._hyper()
        with no_tf32(torch):
            ref_alpha, ref_root = self.reference_cache()
        x = self.x.double()
        both = torch.cat([alpha.double()[:, None], root.double()], dim=1)
        k_both = rbf.matmul(x, x, both, ls, os) + s2 * both
        ka, k_root = k_both[:, 0], k_both[:, 1:]
        k = root.shape[1]
        root_gap = root.double().mT @ k_root - torch.eye(k, dtype=torch.float64, device=x.device)
        stated = min(self.ctx.config["settings"]["max_root_decomposition_size"], x.shape[0])
        mean_gap = var_gap = cache_var_gap = top = 0.0
        for xs, mean, var in answers:
            m_ref, v_ref = ref_love.predict(x, alpha.double(), root.double(), xs.double(), ls, os)
            _, v_own = ref_love.predict(x, ref_alpha.double(), ref_root.double(), xs.double(), ls, os)
            top = max(top, float(m_ref.abs().max()))
            mean_gap = max(mean_gap, float((mean.double() - m_ref).abs().max()))
            var_gap = max(var_gap, float((var.double() - v_ref).abs().max()) / os)
            cache_var_gap = max(cache_var_gap, float((v_ref - v_own).abs().max()) / os)
        if not answers:  # the answers due never came: each gap reads a whole miss
            mean_gap = var_gap = cache_var_gap = top = 1.0
        values = {
            "mean": mean_gap / top,
            "variance": var_gap,
            "alpha": float(torch.linalg.norm(alpha.double() - ref_alpha.double()) / torch.linalg.norm(ref_alpha.double())),
            "alpha_residual": float(torch.linalg.norm(ka - self.y.double()) / torch.linalg.norm(self.y.double())),
            "root_residual": float(torch.linalg.norm(root_gap)) / k ** 0.5,
            "root_columns": float(abs(k - stated)),
            "cache_variance": cache_var_gap,
        }
        return checks_against(self.ctx.limits, values)
