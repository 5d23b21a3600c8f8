"""Reader for REAL H2O-3 MOJO archives — the migration path.

Reference format: ``hex/genmodel/ModelMojoReader.java:25`` — a zip holding
``model.ini`` ([info] key=value, [columns], [domains] with per-domain text
files) plus binary blobs.  Tree models store one bytecode blob per
(class, tree) at ``trees/t{class:02d}_{group:03d}.bin``
(SharedTreeMojoReader.java:52); the node stream is walked by
``SharedTreeMojoModel.scoreTree`` (SharedTreeMojoModel.java:134): nodeType
byte, colId u16 (0xFFFF = leaf), NA direction byte, then a float split or
an inline/offset bitset, with left-subtree skip sizes encoded in the
nodeType masks.  GLM stores coefficients inline in the ini
(GlmMojoModel.score0, GlmMojoModel.java:26).

This reader re-implements the *format* so a MOJO produced by the Java
reference scores identically here — it does not share any code with it.
The port's copy of ``h2o3_tpu/export/h2o_mojo.py`` (numpy and zipfile
only), for every family it reads: GBM, DRF, GLM, KMeans, SVM,
IsolationForest, StackedEnsemble, Word2Vec, DeepLearning, PCA and CoxPH.
Scoring is vectorized numpy on the host: these artifacts serve migration
and serving parity checks, and have no device path.  Mojo versions 1.10+ are
supported (1.00 used a different bitset layout and predates every modern
export).
"""

from __future__ import annotations

import io
import os
import struct
import zipfile
from typing import Dict, List, Optional, Sequence

import numpy as np

_LEAF_COL = 0xFFFF
_NA_VS_REST, _NA_LEFT, _NA_RIGHT, _LEFT, _RIGHT = 1, 2, 3, 4, 5


def _parse_scalar(s: str):
    s = s.strip()
    if s in ("null", "None", ""):
        return None
    if s in ("true", "false"):
        return s == "true"
    if s.startswith("[") and s.endswith("]"):
        inner = s[1:-1].strip()
        return [_parse_scalar(x) for x in inner.split(",")] if inner else []
    try:
        return int(s)
    except ValueError:
        pass
    try:
        return float(s)
    except ValueError:
        return s


class _DirBackend:
    """Extracted-MOJO directory as a zip-like backend (the reference's
    MojoReaderBackend has folder/classpath forms too)."""

    def __init__(self, base: str):
        self.base = base

    def read(self, name: str) -> bytes:
        with open(os.path.join(self.base, name), "rb") as fh:
            return fh.read()

    def getinfo(self, name: str):
        if not os.path.exists(os.path.join(self.base, name)):
            raise KeyError(name)
        return name


class _PrefixBackend:
    """View into a sub-MOJO nested inside an archive (StackedEnsemble
    stores base models under ``models/<algo>/<key>/`` prefixes)."""

    def __init__(self, parent, prefix: str):
        self.parent = parent
        self.prefix = prefix

    def read(self, name: str) -> bytes:
        return self.parent.read(self.prefix + name)

    def getinfo(self, name: str):
        return self.parent.getinfo(self.prefix + name)


class MojoArchive:
    """Parsed model.ini + blob access for one MOJO zip (or extracted
    directory, or a nested-backend view)."""

    def __init__(self, path_or_bytes, backend=None):
        if backend is not None:
            self.zf = backend
        elif isinstance(path_or_bytes, (str, os.PathLike)) \
                and os.path.isdir(path_or_bytes):
            self.zf = _DirBackend(os.fspath(path_or_bytes))
        else:
            if isinstance(path_or_bytes, (bytes, bytearray)):
                path_or_bytes = io.BytesIO(path_or_bytes)
            self.zf = zipfile.ZipFile(path_or_bytes)
        self.info: Dict[str, object] = {}
        self.columns: List[str] = []
        self.domains: Dict[int, List[str]] = {}
        section = None
        for line in self.zf.read("model.ini").decode().splitlines():
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            if line.startswith("["):
                section = line.strip("[]").lower()
                continue
            if section == "info" and "=" in line:
                k, _, v = line.partition("=")
                self.info[k.strip()] = _parse_scalar(v)
            elif section == "columns":
                self.columns.append(line)
            elif section == "domains":
                # "0: 7 d000.txt" -> column_index: cardinality file
                idx, _, rest = line.partition(":")
                fname = rest.split()[-1]
                levels = self.zf.read(
                    f"domains/{fname}").decode().splitlines()
                self.domains[int(idx)] = levels

    def blob(self, name: str) -> bytes:
        return self.zf.read(name)

    def has(self, name: str) -> bool:
        try:
            self.zf.getinfo(name)
            return True
        except KeyError:
            return False


# ----------------------------------------------------------- tree bytecode

def _score_tree(tree: bytes, row: np.ndarray,
                domain_len: Sequence[int], v11: bool) -> float:
    """One tree walk — SharedTreeMojoModel.scoreTree (Java :134 / :1040).

    ``domain_len[col]`` is the domain cardinality (0 for numeric); the
    current (v1.2+) walker treats an out-of-domain integer like NA.
    ``v11`` selects the 1.10 bitset layout (fill3_1: u16 nbytes) over the
    current one (fill3: u32 nbits).
    """
    pos = 0
    while True:
        node_type = tree[pos]
        col = tree[pos + 1] | (tree[pos + 2] << 8)
        pos += 3
        if col == _LEAF_COL:
            return struct.unpack_from("<f", tree, pos)[0]
        na_dir = tree[pos]
        pos += 1
        na_vs_rest = na_dir == _NA_VS_REST
        leftward = na_dir in (_NA_LEFT, _LEFT)
        lmask = node_type & 51
        equal = node_type & 12
        split_val = None
        bs_off = bs_nbits = bs_bitoff = 0
        if not na_vs_rest:
            if equal == 0:
                split_val = struct.unpack_from("<f", tree, pos)[0]
                pos += 4
            elif equal == 8:                   # 32-bit inline bitset
                bs_off, bs_nbits, bs_bitoff = pos, 32, 0
                pos += 4
            else:                              # offset bitset (equal == 12)
                bs_bitoff = tree[pos] | (tree[pos + 1] << 8)
                if v11:
                    nbytes = tree[pos + 2] | (tree[pos + 3] << 8)
                    bs_nbits = nbytes << 3
                    pos += 4
                else:
                    bs_nbits = struct.unpack_from("<i", tree, pos + 2)[0]
                    nbytes = ((bs_nbits - 1) >> 3) + 1
                    pos += 6
                bs_off = pos
                pos += nbytes

        d = row[col]
        if np.isnan(d):
            missing = True
        elif equal != 0:
            i = int(d) - bs_bitoff
            missing = not (0 <= i < bs_nbits)
        elif not v11 and domain_len[col] and int(d) >= domain_len[col]:
            missing = True
        else:
            missing = False
        if missing:
            go_right = not leftward
        elif na_vs_rest:
            go_right = False
        elif equal == 0:
            go_right = d >= split_val
        else:
            i = int(d) - bs_bitoff
            go_right = bool(tree[bs_off + (i >> 3)] & (1 << (i & 7)))

        if go_right:
            if lmask == 0:
                pos += 1 + tree[pos]
            elif lmask == 1:
                pos += 2 + (tree[pos] | (tree[pos + 1] << 8))
            elif lmask == 2:
                pos += 3 + (tree[pos] | (tree[pos + 1] << 8)
                            | (tree[pos + 2] << 16))
            elif lmask == 3:
                pos += 4 + struct.unpack_from("<i", tree, pos)[0]
            elif lmask == 48:
                pos += 4                       # skip the left prediction
            else:
                raise ValueError(f"illegal lmask {lmask}")
            lmask = (node_type & 0xC0) >> 2    # switch to the right mask
        else:
            if lmask <= 3:
                pos += lmask + 1
        if lmask & 16:
            return struct.unpack_from("<f", tree, pos)[0]


class H2OMojoModel:
    """Common surface: predict(dict of named columns) -> dict."""

    def __init__(self, ar: MojoArchive):
        self.archive = ar
        self.algo = str(ar.info["algo"])
        self.columns = ar.columns
        self.n_features = int(ar.info["n_features"])
        self.nclasses = int(ar.info["n_classes"])
        self.domains = ar.domains
        resp_idx = self.n_features
        self.response_domain = ar.domains.get(resp_idx)
        self.feature_names = ar.columns[: self.n_features]

    # -- row assembly: names -> model column order, cats -> domain codes
    def _matrix(self, data: Dict[str, Sequence]) -> np.ndarray:
        n = len(next(iter(data.values())))
        X = np.full((n, self.n_features), np.nan)
        for j, name in enumerate(self.feature_names):
            if name not in data:
                continue
            col = np.asarray(data[name], dtype=object)
            dom = self.domains.get(j)
            if dom is not None:
                lookup = {s: i for i, s in enumerate(dom)}
                X[:, j] = [lookup.get(str(v), np.nan)
                           if v is not None else np.nan for v in col]
            else:
                X[:, j] = [np.nan if v is None else float(v) for v in col]
        return X

    def _finish(self, raw: np.ndarray) -> dict:
        if self.nclasses >= 2:
            labels = np.argmax(raw, axis=1)
            if self.nclasses == 2:
                thr = float(self.archive.info.get("default_threshold", 0.5))
                labels = (raw[:, 1] >= thr).astype(int)
            dom = self.response_domain or [str(i) for i in
                                           range(self.nclasses)]
            return {"predict": np.asarray(dom, dtype=object)[labels],
                    "classes": dom,
                    "probabilities": raw}
        return {"predict": raw[:, 0]}

    def predict(self, data: Dict[str, Sequence]) -> dict:
        return self._finish(self._score_raw(self._matrix(data)))


class H2OMojoTreeModel(H2OMojoModel):
    """GBM / DRF / IsolationForest-style shared-tree MOJO."""

    def __init__(self, ar: MojoArchive):
        super().__init__(ar)
        self.ntree_groups = int(ar.info["n_trees"])
        self.ntrees_per_group = int(ar.info["n_trees_per_class"])
        self.mojo_version = float(ar.info["mojo_version"])
        if self.mojo_version < 1.1:
            raise NotImplementedError(
                "MOJO 1.00 tree archives predate the supported format")
        self.trees: List[Optional[bytes]] = []
        for group in range(self.ntree_groups):
            for cls in range(self.ntrees_per_group):
                name = f"trees/t{cls:02d}_{group:03d}.bin"
                self.trees.append(ar.blob(name) if ar.has(name) else None)
        self.domain_len = [len(self.domains.get(j, ()))
                          for j in range(self.n_features)]

    def _tree_sums(self, X: np.ndarray) -> np.ndarray:
        n = X.shape[0]
        k = self.ntrees_per_group
        out = np.zeros((n, k))
        v11 = self.mojo_version < 1.2
        for t, tree in enumerate(self.trees):
            if tree is None:
                continue
            cls = t % k
            for r in range(n):
                out[r, cls] += _score_tree(tree, X[r], self.domain_len,
                                           v11)
        return out

    def _score_raw(self, X: np.ndarray) -> np.ndarray:
        sums = self._tree_sums(X)
        info = self.archive.info
        if self.algo == "gbm":
            init_f = float(info.get("init_f") or 0.0)
            family = str(info.get("distribution"))
            link = str(info.get("link_function", "") or "")
            if family in ("bernoulli", "quasibinomial", "modified_huber"):
                f = sums[:, 0] + init_f
                p1 = _link_inv(link or "logit", f)
                return np.stack([1.0 - p1, p1], axis=1)
            if family == "multinomial":
                if self.nclasses == 2:
                    f = sums[:, 0] + init_f
                    e = np.stack([f, -f], axis=1)
                else:
                    e = sums
                e = np.exp(e - e.max(axis=1, keepdims=True))
                return e / e.sum(axis=1, keepdims=True)
            return _link_inv(link or "identity",
                             sums[:, [0]] + init_f)
        if self.algo == "drf":
            if self.nclasses == 1:
                return sums / self.ntree_groups
            if self.nclasses == 2 and not bool(
                    info.get("binomial_double_trees")):
                # DrfMojoModel.unifyPreds: binomial DRF trees vote for
                # CLASS 0 — preds[1] = sum/T, preds[2] = 1 - preds[1]
                p0 = sums[:, 0] / self.ntree_groups
                return np.stack([p0, 1.0 - p0], axis=1)
            s = sums.sum(axis=1, keepdims=True)
            with np.errstate(invalid="ignore", divide="ignore"):
                return np.where(s > 0, sums / s, sums)
        raise NotImplementedError(
            f"tree MOJO algo {self.algo!r} not supported yet "
            "(gbm/drf are)")


def _link_inv(link: str, f: np.ndarray) -> np.ndarray:
    link = link.lower()
    if link in ("logit", ""):
        return 1.0 / (1.0 + np.exp(-f))
    if link == "log":
        return np.exp(f)
    if link == "inverse":
        xx = np.where(np.abs(f) < 1e-5, np.sign(f) * 1e-5 + (f == 0) * 1e-5,
                      f)
        return 1.0 / xx
    if link == "ologit":
        return 1.0 / (1.0 + np.exp(-f))
    return f                                   # identity


class H2OMojoGlmModel(H2OMojoModel):
    """GLM MOJO — GlmMojoModel.score0 (GlmMojoModel.java:26)."""

    def __init__(self, ar: MojoArchive):
        super().__init__(ar)
        info = ar.info
        self.beta = np.asarray(info["beta"], dtype=float)
        self.cats = int(info.get("cats", 0))
        self.cat_offsets = list(info.get("cat_offsets") or [0])
        self.nums = int(info.get("nums", 0))
        self.use_all_levels = bool(info.get("use_all_factor_levels", False))
        self.mean_imputation = bool(info.get("mean_imputation", False))
        self.num_means = list(info.get("num_means") or [])
        self.cat_modes = list(info.get("cat_modes") or [])
        self.family = str(info.get("family", "gaussian"))
        self.link = str(info.get("link", "identity"))

    def _score_raw(self, X: np.ndarray) -> np.ndarray:
        X = X.copy()
        if self.mean_imputation:
            for i in range(self.cats):
                bad = ~np.isfinite(X[:, i])
                X[bad, i] = self.cat_modes[i]
            for j in range(self.nums):
                col = self.cats + j
                bad = ~np.isfinite(X[:, col])
                X[bad, col] = self.num_means[j]
        eta = np.zeros(X.shape[0])
        for i in range(self.cats):
            ival = X[:, i].astype(int)
            if not self.use_all_levels:
                ival = ival - 1
            ok = np.isfinite(X[:, i]) & (ival >= 0)
            idx = ival + self.cat_offsets[i]
            ok &= idx < self.cat_offsets[i + 1]
            eta[ok] += self.beta[idx[ok]]
        noff = self.cat_offsets[self.cats] - self.cats
        for i in range(self.cats, len(self.beta) - 1 - noff):
            eta += self.beta[noff + i] * np.nan_to_num(X[:, i])
        eta += self.beta[-1]
        mu = _link_inv(self.link, eta)
        if self.family in ("binomial", "quasibinomial", "fractionalbinomial"):
            return np.stack([1.0 - mu, mu], axis=1)
        return mu[:, None]


class H2OMojoKMeansModel(H2OMojoModel):
    """KMeans MOJO — KMeansMojoModel.score0 + GenModel KMeans utilities
    (GenModel.java:523-675: standardize/impute preprocess, categorical
    Manhattan + numeric Euclidean distance with missing-dimension
    rescaling)."""

    def __init__(self, ar: MojoArchive):
        super().__init__(ar)
        info = ar.info
        k = int(info["center_num"])
        self.centers = np.asarray(
            [info[f"center_{i}"] for i in range(k)], dtype=float)
        self.standardize = bool(info.get("standardize", False))
        self.means = np.asarray(info.get("standardize_means")
                                or [0.0] * self.n_features, dtype=float)
        self.mults = np.asarray(info.get("standardize_mults")
                                or [1.0] * self.n_features, dtype=float)
        self.modes = np.asarray(info.get("standardize_modes")
                                or [-1] * self.n_features, dtype=float)
        self.is_cat = np.array([j in self.domains
                                for j in range(self.n_features)])

    def _preprocess(self, X: np.ndarray) -> np.ndarray:
        """KMeansMojoModel.score0 preprocesses ONLY when standardize=true
        (impute + scale); otherwise rows pass through raw and missing
        dimensions are handled by the distance's NA-skip/rescale."""
        if not self.standardize:
            return X
        X = X.copy()
        for j in range(self.n_features):
            col = X[:, j]
            nan = np.isnan(col)
            if self.modes[j] == -1:               # numeric
                col = np.where(nan, self.means[j], col)
                col = (col - self.means[j]) * self.mults[j]
            else:                                  # categorical: mode
                col = np.where(nan, self.modes[j], col)
            X[:, j] = col
        return X

    def distances(self, data) -> np.ndarray:
        X = self._preprocess(self._matrix(data))
        n, k = X.shape[0], self.centers.shape[0]
        valid = ~np.isnan(X)
        pts = valid.sum(axis=1)
        scale = np.where((pts > 0) & (pts < self.n_features),
                         self.n_features / np.maximum(pts, 1), 1.0)
        out = np.zeros((n, k))
        for c in range(k):
            center = self.centers[c]
            sq = np.zeros(n)
            for j in range(self.n_features):
                d = X[:, j]
                ok = valid[:, j]
                if self.is_cat[j]:
                    sq += ok * (d != center[j])    # Manhattan
                else:
                    delta = np.where(ok, d - center[j], 0.0)
                    sq += delta * delta
            out[:, c] = sq * scale
        return out

    def predict(self, data) -> dict:
        d = self.distances(data)
        return {"predict": np.argmin(d, axis=1), "distances": d}


class H2OMojoSvmModel(H2OMojoModel):
    """SparkSVM MOJO — SvmMojoModel.score0 (linear margin + threshold)."""

    def __init__(self, ar: MojoArchive):
        super().__init__(ar)
        info = ar.info
        self.weights = np.asarray(info["weights"], dtype=float)
        self.interceptor = float(info["interceptor"])
        self.threshold = float(info.get("threshold", 0.0))
        self.mean_imputation = bool(info.get("meanImputation", False))
        self.means = np.asarray(info.get("means")
                                or [0.0] * self.n_features, dtype=float)

    def predict(self, data) -> dict:
        X = self._matrix(data)
        pred = np.full(X.shape[0], self.interceptor)
        for j in range(self.n_features):
            col = X[:, j]
            if self.mean_imputation:
                col = np.where(np.isnan(col), self.means[j], col)
            # no imputation: NaN propagates, exactly like score0 —
            # `NaN > threshold` is false, forcing label index 0
            pred += col * self.weights[j]
        if self.nclasses == 1:
            return {"predict": pred}
        with np.errstate(invalid="ignore"):
            label = np.where(np.isnan(pred), 0,
                             pred > self.threshold).astype(int)
        dom = self.response_domain or ["0", "1"]
        return {"predict": np.asarray(dom, dtype=object)[label],
                "label_index": label, "margin": pred}


class H2OMojoIsoforModel(H2OMojoTreeModel):
    """IsolationForest MOJO — IsolationForestMojoModel.unifyPreds:
    summed per-tree path lengths -> normalized anomaly score."""

    def __init__(self, ar: MojoArchive):
        super().__init__(ar)
        self.min_path = float(ar.info["min_path_length"])
        self.max_path = float(ar.info["max_path_length"])
        self.output_anomaly_flag = bool(
            ar.info.get("output_anomaly_flag", False))
        self.anomaly_threshold = float(
            ar.info.get("default_threshold", 0.5))

    def predict(self, data) -> dict:
        X = self._matrix(data)
        lengths = self._tree_sums(X)[:, 0]
        mean_len = lengths / max(self.ntree_groups, 1)
        if self.max_path > self.min_path:
            score = (self.max_path - lengths) / (self.max_path
                                                 - self.min_path)
        else:
            score = np.ones_like(lengths)
        out = {"predict": score, "score": score, "mean_length": mean_len,
               "path_length": lengths}
        if self.output_anomaly_flag:
            # unifyPreds emits [flag, score, mean_length] in this mode
            out["predict"] = (score > self.anomaly_threshold).astype(int)
        return out


class H2OMojoEnsembleModel(H2OMojoModel):
    """StackedEnsemble MOJO — StackedEnsembleMojoModel.score0: base
    models score the row (each remaps columns by its own layout — free
    here, since scoring is name-keyed), their predictions form the
    metalearner's positional input, with the optional logit transform."""

    def __init__(self, ar: MojoArchive):
        super().__init__(ar)
        info = ar.info
        if self.nclasses > 2:
            raise NotImplementedError(
                "multinomial StackedEnsemble MOJOs need a multinomial "
                "GLM metalearner reader (binomial/regression supported)")
        transform = str(info.get("metalearner_transform")
                        or "NONE").upper()
        if transform not in ("NONE", "LOGIT"):
            raise NotImplementedError(
                f"metalearner_transform {transform!r} (NONE/Logit are "
                "supported, matching StackedEnsembleMojoReader)")
        self.logit_transform = transform == "LOGIT"
        dirs = {}
        for i in range(int(info["submodel_count"])):
            dirs[str(info[f"submodel_key_{i}"])] = \
                str(info[f"submodel_dir_{i}"])

        def sub(key: str) -> H2OMojoModel:
            return load_h2o_mojo(None, backend=_PrefixBackend(
                ar.zf, dirs[key]))

        self.metalearner = sub(str(info["metalearner"]))
        # absent base_model{i} slots are pruned/unused models — the
        # reference skips them but keeps their basePreds position as 0.0
        self.base_models = [
            sub(str(info[f"base_model{i}"]))
            if info.get(f"base_model{i}") is not None else None
            for i in range(int(info["base_models_num"]))]

    @staticmethod
    def _logit(p: np.ndarray) -> np.ndarray:
        p = np.clip(p, 1e-9, 1 - 1e-9)
        x = p / (1 - p)
        return np.where(x == 0, -19.0, np.maximum(-19.0, np.log(x)))

    def predict(self, data) -> dict:
        n = len(next(iter(data.values())))
        base = np.zeros((n, len(self.base_models)))
        is_prob = np.zeros(len(self.base_models), dtype=bool)
        for i, bm in enumerate(self.base_models):
            if bm is None:                    # pruned slot: 0.0 column
                continue
            out = bm.predict(data)
            # level-one column per base, mirroring training's
            # _base_columns: classifiers contribute p(positive); other
            # algos their single raw output (cluster id, CoxPH lp, PC1)
            if self.nclasses == 2 and "probabilities" in out:
                base[:, i] = out["probabilities"][:, 1]
                is_prob[i] = True
            elif "predict" in out:
                base[:, i] = np.asarray(out["predict"], dtype=float)
            elif "projection" in out:         # PCA base (k=1 level-one col)
                base[:, i] = np.asarray(out["projection"])[:, 0]
            else:
                raise NotImplementedError(
                    f"ensemble base model produced no usable level-one "
                    f"column (outputs: {sorted(out)})")
        if self.logit_transform and self.nclasses == 2:
            # score0 logit-transforms only the classification branches;
            # regression/unsupervised base predictions feed the
            # metalearner raw
            base[:, is_prob] = self._logit(base[:, is_prob])
        meta_data = {name: base[:, j].tolist() for j, name in
                     enumerate(self.metalearner.feature_names)}
        out = self.metalearner.predict(meta_data)
        if self.nclasses == 2:
            # label decisions use the ENSEMBLE's threshold + domain
            p1 = out["probabilities"][:, 1]
            thr = float(self.archive.info.get("default_threshold", 0.5))
            dom = self.response_domain or ["0", "1"]
            out["predict"] = np.asarray(dom, dtype=object)[
                (p1 >= thr).astype(int)]
            out["classes"] = dom
        return out


class H2OMojoWord2VecModel(H2OMojoModel):
    """Word2Vec MOJO — Word2VecMojoModel.transform0: vocabulary text
    lines + BIG-endian float32 vectors (Java ByteBuffer default order,
    despite the ini's LITTLE_ENDIAN marker — Word2VecMojoReader wraps
    the blob without setting an order)."""

    def __init__(self, ar: MojoArchive):
        super().__init__(ar)
        self.vec_size = int(ar.info["vec_size"])
        vocab_size = int(ar.info["vocab_size"])
        # readtext semantics: every line kept (even blank tokens, which
        # consume a vector row), newline escapes undone, then trimmed
        vocab = [w.replace("\\n", "\n").strip()
                 for w in ar.blob("vocabulary").decode().splitlines()]
        raw = ar.blob("vectors")
        if len(raw) != vocab_size * self.vec_size * 4 \
                or len(vocab) != vocab_size:
            raise ValueError(
                f"corrupted word2vec vectors: {len(raw)} bytes / "
                f"{len(vocab)} words for vocab_size={vocab_size}, "
                f"vec_size={self.vec_size}")
        vecs = np.frombuffer(raw, dtype=">f4").astype(np.float32)
        vecs = vecs.reshape(vocab_size, self.vec_size)
        self.embeddings = {w: vecs[i] for i, w in enumerate(vocab)}
        if len(self.embeddings) != vocab_size:
            # duplicate vocabulary words collapse in the map; the reference
            # reader rejects this as corruption (Word2VecMojoReader:
            # "Corrupted model, unexpected number of words")
            raise ValueError(
                f"corrupted word2vec vocabulary: {len(self.embeddings)} "
                f"distinct words for vocab_size={vocab_size}")

    def transform(self, words) -> np.ndarray:
        """[n, vec_size]; out-of-dictionary words become NaN rows
        (transform0 returns null there)."""
        out = np.full((len(words), self.vec_size), np.nan, np.float32)
        for i, w in enumerate(words):
            vec = self.embeddings.get(str(w))
            if vec is not None:
                out[i] = vec
        return out

    def predict(self, data) -> dict:
        col = next(iter(data.values()))
        return {"embeddings": self.transform(list(col))}


class H2OMojoDeepLearningModel(H2OMojoModel):
    """DeepLearning MOJO — DeeplearningMojoModel.score0: one-hot cats
    (cat_offsets / use_all_factor_levels / NA->extra level or mode),
    normalized nums, MLP forward with per-layer [out, in]-major weights
    read from model.ini (DeeplearningMojoReader.readModelData)."""

    def __init__(self, ar: MojoArchive):
        super().__init__(ar)
        info = ar.info
        self.cats = int(info.get("cats", 0))
        self.nums = int(info.get("nums", 0))
        self.catoffsets = [int(x) for x in
                           (info.get("cat_offsets") or [0])]
        self.normsub = np.asarray(info.get("norm_sub") or [], float)
        self.normmul = np.asarray(info.get("norm_mul") or [], float)
        self.normrespsub = info.get("norm_resp_sub")
        self.normrespmul = info.get("norm_resp_mul")
        self.use_all = bool(info.get("use_all_factor_levels", False))
        self.units = [int(u) for u in info["neural_network_sizes"]]
        self.activation = str(info["activation"])
        self.impute_means = bool(info.get("mean_imputation", False))
        self.cat_modes = [int(x) for x in (info.get("cat_modes") or [])]
        self.family = str(info.get("distribution", "gaussian"))
        self.layers = []
        for k in range(len(self.units) - 1):
            W = np.asarray(info[f"weight_layer{k}"], float) \
                .reshape(self.units[k + 1], self.units[k])
            b = np.asarray(info[f"bias_layer{k}"], float)
            self.layers.append((W, b))

    def _assemble(self, X: np.ndarray) -> np.ndarray:
        """[n, cats+nums] codes/values -> [n, units[0]] network input."""
        n = X.shape[0]
        A = np.zeros((n, self.units[0]))
        ncat_inputs = self.catoffsets[-1] if self.cats else 0
        for c in range(self.cats):
            val = X[:, c].copy()
            if self.impute_means and self.cat_modes:
                val = np.where(np.isnan(val), self.cat_modes[c], val)
            base = self.catoffsets[c]
            width = self.catoffsets[c + 1] - base
            idx = val - (0 if self.use_all else 1)
            ok = (~np.isnan(val)) & (idx >= 0) & (idx < width)
            rows = np.flatnonzero(ok)
            A[rows, base + idx[ok].astype(int)] = 1.0
        for j in range(self.nums):
            x = X[:, self.cats + j]
            if len(self.normsub):
                x = np.where(np.isnan(x), self.normsub[j], x)
                x = (x - self.normsub[j]) * self.normmul[j]
            else:
                x = np.nan_to_num(x)
            A[:, ncat_inputs + j] = x
        return A

    @staticmethod
    def _act(name: str, z: np.ndarray) -> np.ndarray:
        base = name.replace("WithDropout", "")
        if base == "Rectifier":
            return np.maximum(z, 0.0)
        if base == "Tanh":
            return np.tanh(z)
        if base == "Maxout":
            return z.reshape(z.shape[0], -1, 2).max(axis=2)
        raise NotImplementedError(f"activation {name!r}")

    def _score_raw(self, X: np.ndarray) -> np.ndarray:
        h = self._assemble(X)
        for W, b in self.layers[:-1]:
            h = self._act(self.activation, h @ W.T + b)
        W, b = self.layers[-1]
        out = h @ W.T + b
        if self.nclasses >= 2:
            e = np.exp(out - out.max(axis=1, keepdims=True))
            return e / e.sum(axis=1, keepdims=True)
        mu = out[:, :1]
        if self.normrespmul is not None:
            mu = mu / float(self.normrespmul) + float(self.normrespsub)
        return mu


class H2OMojoPcaModel(H2OMojoModel):
    """PCA MOJO — PCAMojoModel.score0: normalize, project onto the
    eigenvector blob ([eigenvector_size, k] big-endian doubles)."""

    def __init__(self, ar: MojoArchive):
        super().__init__(ar)
        info = ar.info
        self.k = int(info["k"])
        self.ncats = int(info.get("ncats", 0))
        self.nnums = int(info.get("nnums", 0))
        self.normsub = np.asarray(info.get("normSub") or [], float)
        self.normmul = np.asarray(info.get("normMul") or [], float)
        size = int(info["eigenvector_size"])
        self.V = np.frombuffer(ar.blob("eigenvectors_raw"),
                               dtype=">f8").astype(float) \
            .reshape(size, self.k)

    def predict(self, data) -> dict:
        X = self._matrix(data)
        Z = np.empty((X.shape[0], self.nnums))
        for j in range(self.nnums):
            x = X[:, self.ncats + j]
            x = np.where(np.isnan(x), self.normsub[j], x)
            Z[:, j] = (x - self.normsub[j]) * self.normmul[j]
        proj = Z @ self.V[-self.nnums:]
        return {"projection": proj,
                **{f"PC{i + 1}": proj[:, i] for i in range(self.k)}}


class H2OMojoCoxPHModel(H2OMojoModel):
    """CoxPH MOJO — CoxPHMojoModel.score0 (no strata / interactions):
    lp = coef . features - lpBase, cats one-hot then nums."""

    def __init__(self, ar: MojoArchive):
        super().__init__(ar)
        info = ar.info
        self.coef = np.asarray(info["coef"], float)
        self.cats = int(info.get("cats", 0))
        self.cat_offsets = [int(x) for x in
                            (info.get("cat_offsets") or [0])]
        self.nums = int(info.get("num_numerical_columns", 0))
        self.num_offsets = [int(x) for x in
                            (info.get("num_offsets") or [])]
        self.use_all = bool(info.get("use_all_factor_levels", False))
        s1 = int(info.get("x_mean_cat_size1", 0))
        s2 = int(info.get("x_mean_cat_size2", 0))
        mc = np.frombuffer(ar.blob("x_mean_cat"), dtype=">f8") \
            .reshape(s1, s2) if s1 else np.zeros((1, 0))
        s1n = int(info.get("x_mean_num_size1", 0))
        s2n = int(info.get("x_mean_num_size2", 0))
        mn = np.frombuffer(ar.blob("x_mean_num"), dtype=">f8") \
            .reshape(s1n, s2n) if s1n else np.zeros((1, 0))
        num_start = mc.shape[1]
        self.lp_base = float(
            np.dot(mc[0], self.coef[: num_start])
            + np.dot(mn[0], self.coef[num_start: num_start + mn.shape[1]]))

    def predict(self, data) -> dict:
        X = self._matrix(data)
        n = X.shape[0]
        lp = np.zeros(n)
        for c in range(self.cats):
            val = X[:, c]
            idx = val - (0 if self.use_all else 1)
            base = self.cat_offsets[c]
            width = self.cat_offsets[c + 1] - base
            ok = (~np.isnan(val)) & (idx >= 0) & (idx < width)
            rows = np.flatnonzero(ok)
            lp[rows] += self.coef[base + idx[ok].astype(int)]
            lp[np.isnan(val)] = np.nan
        for j in range(self.nums):
            x = X[:, self.cats + j]
            lp += self.coef[self.num_offsets[j]] * x
        lp -= self.lp_base
        return {"predict": lp, "lp": lp}


def load_h2o_mojo(path_or_bytes, backend=None) -> H2OMojoModel:
    """Open a reference-produced MOJO (zip or extracted directory) —
    ModelMojoReader.load analog."""
    ar = MojoArchive(path_or_bytes, backend=backend)
    algo = str(ar.info.get("algo"))
    if algo in ("gbm", "drf"):
        return H2OMojoTreeModel(ar)
    if algo == "glm":
        return H2OMojoGlmModel(ar)
    if algo == "kmeans":
        return H2OMojoKMeansModel(ar)
    if algo == "svm":
        return H2OMojoSvmModel(ar)
    if algo == "isolationforest":
        return H2OMojoIsoforModel(ar)
    if algo == "stackedensemble":
        return H2OMojoEnsembleModel(ar)
    if algo == "word2vec":
        return H2OMojoWord2VecModel(ar)
    if algo == "deeplearning":
        return H2OMojoDeepLearningModel(ar)
    if algo == "pca":
        return H2OMojoPcaModel(ar)
    if algo == "coxph":
        return H2OMojoCoxPHModel(ar)
    raise NotImplementedError(
        f"H2O MOJO algo {algo!r} not supported (gbm, drf, glm, kmeans, "
        "svm, isolationforest, stackedensemble, word2vec, deeplearning, "
        "pca, coxph are)")


def is_h2o_mojo(path) -> bool:
    if isinstance(path, (str, os.PathLike)) and os.path.isdir(path):
        return os.path.isfile(os.path.join(path, "model.ini"))
    try:
        with zipfile.ZipFile(path) as z:
            z.getinfo("model.ini")
        return True
    except Exception:               # noqa: BLE001 — not a reference MOJO
        return False
