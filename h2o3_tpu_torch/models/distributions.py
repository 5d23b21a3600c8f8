"""Loss distributions for gradient boosting — the bernoulli, gaussian and
multinomial part of ``h2o3_tpu/models/distributions.py``
(hex/Distribution.java).

Each distribution gives the per-row gradient and hessian of the loss in
the raw score F, the initial score and the inverse link, as one
elementwise torch pass on the rows' device; multinomial's gradients are
the softmax over K class-major scores, on which GBM grows K class trees
a round (``shared.make_multinomial_scan_fn``).  The other families of
the JAX package wait for a later slice.
"""

from __future__ import annotations

import torch

_LATER = ("poisson", "gamma", "tweedie", "laplace", "quantile", "huber",
          "custom")


class Distribution:
    name = "gaussian"

    def init_score(self, y, w):
        """Initial raw score F0 (the reference's initial prediction)."""
        return (w * y).sum() / (w.sum()).clamp_min(1e-12)

    def grad_hess(self, y, f):
        return f - y, torch.ones_like(f)

    def linkinv(self, f):
        return f

    def deviance(self, y, f, w):
        return (w * (y - f) ** 2).sum()


class Gaussian(Distribution):
    pass


class Bernoulli(Distribution):
    name = "bernoulli"

    def init_score(self, y, w):
        p = ((w * y).sum() / w.sum().clamp_min(1e-12)) \
            .clamp(1e-6, 1 - 1e-6)
        return torch.log(p / (1 - p))

    def grad_hess(self, y, f):
        p = torch.sigmoid(f)
        return p - y, (p * (1 - p)).clamp_min(1e-10)

    def linkinv(self, f):
        return torch.sigmoid(f)

    def deviance(self, y, f, w):
        p = torch.sigmoid(f).clamp(1e-15, 1 - 1e-15)
        return -2 * (w * (y * torch.log(p)
                          + (1 - y) * torch.log1p(-p))).sum()


class Multinomial(Distribution):
    """K class trees a round (GBM's multinomial scan) on the softmax
    gradients of class-major [K, N] scores against the one-hot response
    Y1 [K, N]: g = P - Y1, h = max(P (1 - P), 1e-10)."""
    name = "multinomial"

    def grad_hess(self, Y1, f):
        p = torch.softmax(f, dim=0)
        return p - Y1, (p * (1 - p)).clamp_min(1e-10)


def make_distribution(name: str, nclasses: int = 1, **kw) -> Distribution:
    if kw.get("custom_distribution_func") is not None:
        name = "custom"
    name = (name or "auto").lower()
    if name == "auto":
        if nclasses == 2:
            return Bernoulli()
        if nclasses > 2:
            name = "multinomial"
        else:
            return Gaussian()
    if name in ("bernoulli", "binomial"):
        return Bernoulli()
    if name == "gaussian":
        return Gaussian()
    if name == "multinomial":
        return Multinomial()
    if name in _LATER:
        raise NotImplementedError(
            f"distribution {name!r} is not ported yet: h2o3_tpu_torch has "
            "bernoulli, gaussian and multinomial so far (ROADMAP Queue 1, "
            "'Rest of the tree family')")
    raise ValueError(f"unknown distribution {name!r}")
