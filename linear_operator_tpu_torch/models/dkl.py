"""Deep kernel learning: exact GP regression on learned neural features
(Wilson, Hu, Salakhutdinov & Xing, AISTATS 2016; counterpart of
linear_operator_tpu/models/dkl.py).

k(x, x') = k_rbf(phi(x), phi(x')) with phi an MLP.  The training signal
reaches the MLP through the kernel operator's data leaves (x1 = x2 =
phi(x)): on the fused path the backward of ``inv_quad_logdet`` runs
through the kernels' own backward, K3's x-gradient by two K2 launches, into
the MLP's weights.  The GP head is the port's ``ExactGPRegression``,
unchanged.

Under an ambient mesh with a ``model`` axis above 1 (``parallel/``), x and y
are the rank's rows (``shard_gp_batch``) and x_star is whole: the features of
the rank's rows feed the row-sharded kernel operator, whose backward hands
them their whole gradient (the rank's own rows' share and its rows of the
gathered features' summed one), so the MLP's gradient on a rank is its
share, which ``sharded_train_step`` sums over the model group.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Sequence

import torch
from torch import nn

from .gp import ExactGPRegression, PosteriorCache, model_device


class MLPParams(NamedTuple):
    """The JAX package's MLP parameters: weights (in, out) and biases (out,)
    per layer; ``load_jax_params`` takes a ``DKLParams`` holding one."""

    weights: tuple
    biases: tuple


class DKLParams(NamedTuple):
    """The JAX package's parameter tuple: the MLP's and the GP head's
    (``GPParams``)."""

    mlp: MLPParams
    gp: object


def init_mlp(
    sizes: Sequence[int],
    *,
    generator: torch.Generator | None = None,
    dtype: torch.dtype = torch.float32,
    device: str | torch.device = "cuda",
) -> nn.Sequential:
    """A tanh MLP with layer ``sizes`` (in, ..., out): ``nn.Linear`` layers
    with tanh between them and a linear output, the weights drawn He-style,
    N(0, 2 / fan_in), from ``generator`` (on its device, then moved to
    ``device``), the biases zero."""
    device = model_device(device, "init_mlp")
    layers = []
    for i, (fan_in, fan_out) in enumerate(zip(sizes[:-1], sizes[1:])):
        layer = nn.Linear(fan_in, fan_out, dtype=dtype, device=device)
        draw_on = generator.device if generator is not None else device
        w = torch.randn((fan_out, fan_in), generator=generator, dtype=dtype, device=draw_on)
        with torch.no_grad():
            layer.weight.copy_(math.sqrt(2.0 / fan_in) * w)
            layer.bias.zero_()
        layers.append(layer)
        if i < len(sizes) - 2:
            layers.append(nn.Tanh())
    return nn.Sequential(*layers)


def mlp_features(mlp: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """phi(x): (n, d_in) -> (n, d_out)."""
    return mlp(x)


class DeepKernelGPRegression(nn.Module):
    """An exact-GP head on MLP features, trained end to end through the MLL.

    ``d_in`` is the inputs' dimension and ``hidden`` the MLP's layer widths
    after it; the last is the GP's feature dimension, the kernel's d (keep
    it small).  ``generator`` draws the MLP's weights (``init_mlp``); the
    other keywords go to ``ExactGPRegression``, whose ``use_fused_kernels``
    is on by default."""

    def __init__(
        self,
        d_in: int,
        hidden: Sequence[int] = (64, 32, 4),
        *,
        generator: torch.Generator | None = None,
        dtype: torch.dtype = torch.float32,
        device: str | torch.device = "cuda",
        **gp_kwargs,
    ):
        super().__init__()
        self.hidden = tuple(int(h) for h in hidden)
        self.mlp = init_mlp((d_in, *self.hidden), generator=generator, dtype=dtype, device=device)
        self.gp = ExactGPRegression(**gp_kwargs, dtype=dtype, device=device)

    @property
    def feature_dim(self) -> int:
        return self.hidden[-1]

    def features(self, x: torch.Tensor) -> torch.Tensor:
        return mlp_features(self.mlp, x)

    def row_share_parameters(self):
        """The MLP's parameters: under a model mesh they act on the rank's
        rows only, so their gradient on a rank is its share, which
        ``sharded_train_step`` sums over the model group (the GP head's
        leave the backward whole)."""
        return self.mlp.parameters()

    def train_operator(self, x: torch.Tensor):
        return self.gp.train_operator(self.features(x))

    def neg_mll(self, x: torch.Tensor, y: torch.Tensor, *, generator: torch.Generator | None = None) -> torch.Tensor:
        """The end-to-end negative MLL; its gradient reaches the MLP through
        the kernel operator's data leaves.  ``generator`` draws the probes."""
        return self.gp.neg_mll(self.features(x), y, generator=generator)

    def posterior(self, x: torch.Tensor, y: torch.Tensor, x_star: torch.Tensor, *, generator=None):
        """The predictive mean and variance at ``x_star`` by one batched solve
        (``ExactGPRegression.posterior``).  ``generator`` stands where the
        JAX package takes a key; that solve draws nothing."""
        return self.gp.posterior(self.features(x), y, self.features(x_star))

    def posterior_cache(self, x: torch.Tensor, y: torch.Tensor, *, generator=None) -> PosteriorCache:
        """The LOVE cache on the features; ``generator`` draws the Lanczos
        start."""
        return self.gp.posterior_cache(self.features(x), y, generator=generator)

    def posterior_from_cache(self, x: torch.Tensor, cache: PosteriorCache, x_star: torch.Tensor):
        return self.gp.posterior_from_cache(self.features(x), cache, self.features(x_star))


__all__ = ["DKLParams", "DeepKernelGPRegression", "MLPParams", "init_mlp", "mlp_features"]
