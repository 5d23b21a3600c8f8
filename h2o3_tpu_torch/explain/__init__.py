"""Model explanation — so far only the variable-importance lookup that
Infogram reads (the JAX package's ``explain._varimp_of``,
``h2o3_tpu/explain/__init__.py:203``); the rest of the explain surface
comes with the REST and plotting layers (ROADMAP Queue 1)."""

from __future__ import annotations

from typing import Optional


def _varimp_of(model) -> Optional[dict]:
    """``model.varimp()``, else the absolute standardized coefficients
    (or the coefficients) scaled to a maximum of 1, largest first; None
    for a model with neither."""
    try:
        return model.varimp()
    except Exception:                       # noqa: BLE001 — not all models
        coefs = getattr(model, "coef_norm", None) or \
            getattr(model, "coef", None)
        if callable(coefs):
            coefs = coefs()
        if isinstance(coefs, dict):
            c = {k: abs(v) for k, v in coefs.items() if k != "Intercept"}
            if c:
                mx = max(c.values()) or 1.0
                return {k: v / mx for k, v in
                        sorted(c.items(), key=lambda kv: -kv[1])}
    return None
