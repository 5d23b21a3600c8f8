"""Portable model archive reader, and the carrier from the JAX package.

The archive is the JAX package's format (``h2o3_tpu/export/mojo.py``
``export_mojo``): a zip holding ``model.json`` (algo, featurization
layout, link/metadata) and ``arrays.npz`` (the learned tensors).
``import_mojo`` loads it into the port's numpy ``ScoringModel``;
``from_reference`` takes the same ``(meta, arrays)`` pair in memory.
"""

from __future__ import annotations

import io
import json
import zipfile
from typing import Dict

import numpy as np

from .scoring import ScoringModel


def from_reference(meta: dict, arrays: Dict[str, np.ndarray]) \
        -> ScoringModel:
    """Carry a model across from the JAX package.

    ``(meta, arrays)`` is what ``h2o3_tpu.export.mojo._extract(model)``
    returns for a trained model: plain JSON-able metadata and numpy
    arrays, the same content ``export_mojo`` writes to an archive.
    """
    return ScoringModel(dict(meta),
                        {k: np.asarray(v) for k, v in arrays.items()})


def import_mojo(path: str) -> ScoringModel:
    """Load a portable archive written by ``export_mojo``.

    Real H2O MOJO zips (``model.ini`` + blobs) are not read yet: their
    importer (``h2o3_tpu/export/h2o_mojo.py``) is still to be ported.
    """
    with zipfile.ZipFile(path) as z:
        names = set(z.namelist())
        if "model.json" not in names:
            kind = ("an H2O MOJO (model.ini)" if "model.ini" in names
                    else "not a portable model archive")
            raise ValueError(
                f"{path!r} is {kind}; h2o3_tpu_torch reads only archives "
                "with model.json + arrays.npz (export_mojo's format)")
        meta = json.loads(z.read("model.json"))
        npz = np.load(io.BytesIO(z.read("arrays.npz")))
        arrays = {k: npz[k] for k in npz.files}
    return ScoringModel(meta, arrays)
