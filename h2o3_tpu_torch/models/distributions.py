"""Loss distributions for gradient boosting — the port of
``h2o3_tpu/models/distributions.py`` (hex/Distribution.java,
hex/LinkFunction.java).

Each distribution gives the per-row gradient and hessian of the loss in
the raw score F, the initial score, the inverse link and the deviance,
as one elementwise torch pass on the rows' device; multinomial's
gradients are the softmax over K class-major scores, on which GBM grows K
class trees a round (``shared.make_multinomial_scan_fn``).  A custom
distribution (``CustomDistribution``) wraps a user object written in
torch with the JAX package's protocol.

Three behaviours of the JAX package are copied as they are: Tweedie has
no deviance of its own and inherits the squared error, Huber's delta is
``huber_alpha`` itself (not the alpha-quantile of |residual| that H2O-3
uses), and Gamma's hessian y/mu is 0 where y = 0.
"""

from __future__ import annotations

import torch


def _mean(y, w):
    return (w * y).sum() / (w.sum()).clamp_min(1e-12)


def _log_mean(y, w):
    return torch.log(_mean(y, w).clamp_min(1e-6))


def _mu(f):
    return torch.exp(f.clamp(-30, 30))


def weighted_nanquantile(y, w, q: float, midpoint: bool = False):
    """The q-quantile of the rows of positive weight (f32 scalar tensor,
    NaN for none): the JAX package's ``jnp.nanquantile(where(w > 0, y,
    nan), q)`` (linear) or, with ``midpoint``, ``jnp.nanmedian``, which
    averages the two middle values of an even count.  One sort of the
    counted rows and the JAX package's arithmetic: position q (n - 1) in
    f32, then low (1 - t) + high t, or (low + high) / 2.  Not
    ``torch.quantile``, which refuses inputs past 2^24 elements, nor
    ``torch.nanmedian``, which takes the lower middle value."""
    s = torch.sort(y[w > 0].to(torch.float32)).values
    n = s.shape[0]
    if n == 0:
        return torch.tensor(float("nan"), dtype=torch.float32,
                            device=y.device)
    pos = torch.tensor(q, dtype=torch.float32) \
        * torch.tensor(float(n - 1), dtype=torch.float32)
    lo_f, hi_f = torch.floor(pos), torch.ceil(pos)
    lo = s[int(min(max(lo_f.item(), 0), n - 1))]
    hi = s[int(min(max(hi_f.item(), 0), n - 1))]
    if midpoint:
        return (lo + hi) * 0.5
    t = (pos - lo_f).to(s.device)
    return lo * (1.0 - t) + hi * t


class Distribution:
    name = "gaussian"

    def init_score(self, y, w):
        """Initial raw score F0 (the reference's initial prediction)."""
        return _mean(y, w)

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
        p = _mean(y, w).clamp(1e-6, 1 - 1e-6)
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


class Poisson(Distribution):
    name = "poisson"

    def init_score(self, y, w):
        return _log_mean(y, w)

    def grad_hess(self, y, f):
        mu = _mu(f)
        return mu - y, mu

    def linkinv(self, f):
        return _mu(f)

    def deviance(self, y, f, w):
        mu = self.linkinv(f)
        t = torch.where(y > 0, y * torch.log(y / mu.clamp_min(1e-15)), 0.0)
        return 2 * (w * (t - (y - mu))).sum()


class Gamma(Distribution):
    name = "gamma"

    def init_score(self, y, w):
        return _log_mean(y, w)

    def grad_hess(self, y, f):
        mu = _mu(f).clamp_min(1e-15)
        return 1.0 - y / mu, y / mu

    def linkinv(self, f):
        return _mu(f)

    def deviance(self, y, f, w):
        mu = self.linkinv(f).clamp_min(1e-15)
        ys = y.clamp_min(1e-15)
        return 2 * (w * (-torch.log(ys / mu) + (ys - mu) / mu)).sum()


class Tweedie(Distribution):
    """Tweedie with variance power p; its deviance is the inherited
    squared error, as in the JAX package."""
    name = "tweedie"

    def __init__(self, p: float = 1.5):
        self.p = float(p)

    def init_score(self, y, w):
        return _log_mean(y, w)

    def grad_hess(self, y, f):
        p = self.p
        f = f.clamp(-30, 30)
        e2, e1 = torch.exp(f * (2 - p)), torch.exp(f * (1 - p))
        grad = e2 - y * e1
        hess = (2 - p) * e2 - (1 - p) * y * e1
        return grad, hess.clamp_min(1e-10)

    def linkinv(self, f):
        return _mu(f)


class Laplace(Distribution):
    name = "laplace"

    def init_score(self, y, w):
        return weighted_nanquantile(y, w, 0.5, midpoint=True)

    def grad_hess(self, y, f):
        return torch.sign(f - y), torch.ones_like(f)

    def deviance(self, y, f, w):
        return (w * (y - f).abs()).sum()


class Quantile(Distribution):
    name = "quantile"

    def __init__(self, alpha: float = 0.5):
        self.alpha = float(alpha)

    def init_score(self, y, w):
        return weighted_nanquantile(y, w, self.alpha)

    def grad_hess(self, y, f):
        g = torch.where(y >= f, -self.alpha, 1 - self.alpha)
        return g.to(f.dtype), torch.ones_like(f)

    def deviance(self, y, f, w):
        e = y - f
        return (w * torch.where(e >= 0, self.alpha * e,
                                (self.alpha - 1) * e)).sum()


class Huber(Distribution):
    """Huber loss whose delta is ``huber_alpha`` itself, as in the JAX
    package (H2O-3 takes the alpha-quantile of |residual|)."""
    name = "huber"

    def __init__(self, delta: float = 0.9):
        self.delta = float(delta)

    def grad_hess(self, y, f):
        e = f - y
        d = self.delta
        g = torch.where(e.abs() <= d, e, d * torch.sign(e))
        return g, torch.ones_like(f)

    def deviance(self, y, f, w):
        e = (y - f).abs()
        d = self.delta
        return (w * torch.where(e <= d, 0.5 * e * e,
                                d * (e - 0.5 * d))).sum()


class Multinomial(Distribution):
    """K class trees a round (GBM's multinomial scan) on the softmax
    gradients of class-major [K, N] scores against the one-hot response
    Y1 [K, N]: g = P - Y1, h = max(P (1 - P), 1e-10)."""
    name = "multinomial"

    def grad_hess(self, Y1, f):
        p = torch.softmax(f, dim=0)
        return p - Y1, (p * (1 - p)).clamp_min(1e-10)


class CustomDistribution(Distribution):
    """A user-supplied loss (the water/udf/CDistributionFunc analog): an
    object with ``grad_hess(y, f) -> (g, h)``, or ``gradient(y, f)`` with
    a unit hessian, and optionally ``linkinv(f)``, ``init_score(y, w)``
    and ``deviance(y, f, w)``, all elementwise torch on the rows'
    device (the JAX package's protocol, in torch)."""

    name = "custom"

    def __init__(self, fn):
        if not (hasattr(fn, "grad_hess") or hasattr(fn, "gradient")):
            raise ValueError(
                "custom_distribution_func needs grad_hess(y, f) or "
                "gradient(y, f)")
        self.fn = fn

    def init_score(self, y, w):
        if hasattr(self.fn, "init_score"):
            return self.fn.init_score(y, w)
        return super().init_score(y, w)

    def grad_hess(self, y, f):
        if hasattr(self.fn, "grad_hess"):
            return self.fn.grad_hess(y, f)
        return self.fn.gradient(y, f), torch.ones_like(f)

    def linkinv(self, f):
        if hasattr(self.fn, "linkinv"):
            return self.fn.linkinv(f)
        return f

    def deviance(self, y, f, w):
        if hasattr(self.fn, "deviance"):
            return self.fn.deviance(y, f, w)
        return super().deviance(y, f, w)


def make_distribution(name: str, nclasses: int = 1, **kw) -> Distribution:
    """The distribution of ``name`` ("auto": bernoulli for 2 classes,
    multinomial for more, gaussian for a number), with ``tweedie_power``,
    ``quantile_alpha`` and ``huber_alpha``; a ``custom_distribution_func``
    wins over the name."""
    custom = kw.get("custom_distribution_func")
    if custom is not None:
        return CustomDistribution(custom)
    name = (name or "auto").lower()
    if name == "custom":
        raise ValueError(
            "distribution='custom' requires custom_distribution_func")
    if name == "auto":
        if nclasses == 2:
            return Bernoulli()
        if nclasses > 2:
            return Multinomial()
        return Gaussian()
    if name == "tweedie":
        return Tweedie(kw.get("tweedie_power", 1.5))
    if name == "quantile":
        return Quantile(kw.get("quantile_alpha", 0.5))
    if name == "huber":
        return Huber(kw.get("huber_alpha", 0.9))
    families = {"gaussian": Gaussian, "bernoulli": Bernoulli,
                "binomial": Bernoulli, "poisson": Poisson, "gamma": Gamma,
                "laplace": Laplace, "multinomial": Multinomial}
    if name not in families:
        raise ValueError(f"unknown distribution {name!r}")
    return families[name]()
