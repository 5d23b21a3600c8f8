"""Portable model archive writer and reader, and the carrier from the
JAX package.

The archive is the JAX package's format (``h2o3_tpu/export/mojo.py``
``export_mojo``): a zip holding ``model.json`` (algo, featurization
layout, link/metadata) and ``arrays.npz`` (the learned tensors).
``export_mojo`` writes a model's ``to_archive()`` pair into one;
``import_mojo`` loads it into the port's numpy ``ScoringModel``, and a
real H2O MOJO (``model.ini``) through ``h2o_mojo.load_h2o_mojo``;
``from_reference`` takes the same ``(meta, arrays)`` pair in memory.
"""

from __future__ import annotations

import io
import json
import zipfile
from typing import Dict

import numpy as np

from .scoring import ScoringModel


def datainfo_meta(di) -> dict:
    """The archive's featurization layout of a ``DataInfo`` (the JAX
    package's ``_datainfo_meta``)."""
    return {
        "specs": [{"name": s.name, "type": s.type, "domain": s.domain,
                   "mean": float(s.mean), "sigma": float(s.sigma),
                   "offset": s.offset, "width": s.width} for s in di.specs],
        "response_column": di.response_column,
        "response_domain": di.response_domain,
        "use_all_factor_levels": di.use_all_factor_levels,
        "standardize": di.standardize,
        "add_intercept": di.add_intercept,
        "nfeatures": di.nfeatures,
    }


def archive_meta(model, family: str) -> dict:
    """The metadata every archive of ``model`` carries (the JAX
    package's ``_extract`` head) with its scorer's ``family``."""
    di = model.datainfo
    return {"algo": model.algo, "format_version": 1,
            "datainfo": datainfo_meta(di),
            "default_threshold": float(model.default_threshold())
            if di.is_classifier else 0.5,
            "family": family}


def no_portable_export(model):
    """Raise the JAX package's error for a model whose family has no
    archive form (``_extract``'s last branch)."""
    raise ValueError(f"no portable export for algo {model.algo!r}")


def export_mojo(model, path: str) -> str:
    """Write the portable archive of ``model`` to ``path`` — the JAX
    package's ``export_mojo`` (Model.download_mojo analog): its
    ``to_archive()`` metadata as ``model.json`` and its arrays as a
    compressed ``arrays.npz``, in one zip.  A family without an archive
    form raises ``no portable export``."""
    to_archive = getattr(model, "to_archive", None)
    if to_archive is None:
        no_portable_export(model)
    meta, arrays = to_archive()
    buf = io.BytesIO()
    np.savez_compressed(buf, **arrays)
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as z:
        z.writestr("model.json", json.dumps(meta, indent=1))
        z.writestr("arrays.npz", buf.getvalue())
    return path


def from_reference(meta: dict, arrays: Dict[str, np.ndarray]) \
        -> ScoringModel:
    """Carry a model across from the JAX package.

    ``(meta, arrays)`` is what ``h2o3_tpu.export.mojo._extract(model)``
    returns for a trained model: plain JSON-able metadata and numpy
    arrays, the same content ``export_mojo`` writes to an archive.
    """
    return ScoringModel(dict(meta),
                        {k: np.asarray(v) for k, v in arrays.items()})


def import_mojo(path: str):
    """Load a portable archive for offline scoring — MojoModel.load.

    Accepts both the portable archives written by ``export_mojo``
    (model.json + arrays.npz: a ``ScoringModel``) and real H2O MOJO zips
    or extracted MOJO directories (model.ini + blobs: an
    ``h2o_mojo.H2OMojoModel``, scored on the host in numpy), as the JAX
    package's ``import_mojo`` does (hex/genmodel/ModelMojoReader.java:25).
    """
    from .h2o_mojo import is_h2o_mojo, load_h2o_mojo
    if is_h2o_mojo(path):
        return load_h2o_mojo(path)
    with zipfile.ZipFile(path) as z:
        if "model.json" not in z.namelist():
            raise ValueError(
                f"{path!r} is not a portable model archive (model.json + "
                "arrays.npz) nor an H2O MOJO (model.ini)")
        meta = json.loads(z.read("model.json"))
        npz = np.load(io.BytesIO(z.read("arrays.npz")))
        arrays = {k: npz[k] for k in npz.files}
    return ScoringModel(meta, arrays)
