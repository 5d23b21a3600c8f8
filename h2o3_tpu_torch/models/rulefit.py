"""RuleFit: tree-ensemble rules and linear terms under an L1 GLM — the
port of ``h2o3_tpu/models/rulefit.py`` (hex/rulefit/RuleFit.java).

A small GBM or DRF (the rule generator, grown through the level loop:
``hist`` and ``split_records`` on a card) supplies the rules: every node
at depths [min_rule_length, max_rule_length] of every tree is the
conjunction of its root path.  A row's leaf in a depth-D tree encodes
every ancestor on its path (the node at depth d is leaf >> (D - d)), so
each rule column is one shift and compare of the tree's leaf codes, on
the device: the [N, R] rule matrix never exists on the host.  The rule
columns and, unless ``model_type="rules"``, the linear terms go to this
package's GLM with alpha = 1 (a lambda search unless ``lambda_`` is
given), which scores the model.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from ..frame.frame import Frame
from ..frame.vec import T_NUM, Vec
from ..runtime import dkv
from ..runtime.job import Job
from .base import Model, ModelBuilder, Parameters
from .datainfo import DataInfo


@dataclasses.dataclass
class RuleFitParameters(Parameters):
    algorithm: str = "gbm"               # rule generator
    min_rule_length: int = 1
    max_rule_length: int = 3
    max_num_rules: int = -1              # -1: auto
    model_type: str = "rules_and_linear"  # rules | linear | rules_and_linear
    rule_generation_ntrees: int = 30
    lambda_: Optional[float] = None


def tree_leaves(levels, t: int, X: torch.Tensor) -> torch.Tensor:
    """The final node [N] (int64) of every row of the raw design ``X`` in
    tree ``t`` of the stacked ``levels``: NaN takes the NA direction, an
    invalid node sends rows left (the JAX package's walk in
    ``_rule_matrix``)."""
    node = torch.zeros(X.shape[0], dtype=torch.int64, device=X.device)
    for feat, thr, na_left, valid in levels:
        f = feat[t].long()[node]
        x = X.gather(1, f[:, None])[:, 0]
        right = torch.where(torch.isnan(x), ~na_left[t][node],
                            x >= thr[t][node])
        node = 2 * node + (right & valid[t][node]).long()
    return node


class RuleFitModel(Model):
    algo = "rulefit"

    def rule_columns(self, frame: Frame) -> torch.Tensor:
        """The [R, padded] f32 0/1 rule columns of ``frame`` on its device
        (``rules`` order), from each tree's leaf codes; NaN past its
        rows, as ``Vec.from_numpy`` pads a column."""
        gen = dkv.get(self.output["rule_model_key"])
        X = gen._design(frame)
        st = gen.output["stacked"]
        D = st.depth
        cols = []
        for t_i in range(st.ntrees):
            mine = [(d, nid) for (ti, d, nid) in self.output["rules"]
                    if ti == t_i]
            if not mine:
                continue
            leaf = tree_leaves(st.levels, t_i, X)
            cols += [(leaf >> (D - d)) == nid for d, nid in mine]
        if not cols:
            return torch.zeros((0, X.shape[0]), dtype=torch.float32,
                               device=X.device)
        R = torch.stack(cols).to(torch.float32)
        R[:, frame.nrows:] = float("nan")
        return R

    def _glm_frame(self, frame: Frame, with_response: bool) -> Frame:
        p: RuleFitParameters = self.params
        names, vecs = [], []
        if p.model_type in ("rules", "rules_and_linear"):
            for i, col in enumerate(self.rule_columns(frame)):
                names.append(f"rule_{i}")
                vecs.append(Vec(col, T_NUM, frame.nrows))
        if p.model_type in ("linear", "rules_and_linear"):
            for s in self.datainfo.specs:
                names.append(f"linear_{s.name}")
                vecs.append(frame.vec(s.name))
        if with_response:
            names.append(p.response_column)
            vecs.append(frame.vec(p.response_column))
        return Frame(names, vecs)

    def _predict_raw(self, X):
        raise NotImplementedError("rulefit scores via its GLM")

    def predict(self, frame: Frame) -> Frame:
        glm = dkv.get(self.output["glm_key"])
        return glm.predict(self._glm_frame(frame, with_response=False))

    def model_performance(self, frame: Optional[Frame] = None):
        if frame is None:
            return self.training_metrics
        glm = dkv.get(self.output["glm_key"])
        return glm.model_performance(self._glm_frame(frame, True))

    def rule_importance(self) -> List[dict]:
        glm = dkv.get(self.output["glm_key"])
        out = []
        for name, coef in glm.coef.items():
            if abs(coef) > 1e-10 and name != "Intercept":
                entry = {"variable": name, "coefficient": coef}
                if name.startswith("rule_"):
                    entry["rule"] = self.output["rule_descriptions"][
                        int(name.split("_")[1])]
                out.append(entry)
        return sorted(out, key=lambda r: -abs(r["coefficient"]))


class RuleFit(ModelBuilder):
    """RuleFit builder — H2ORuleFitEstimator analog."""

    algo = "rulefit"
    model_class = RuleFitModel

    def __init__(self, params: Optional[RuleFitParameters] = None, **kw):
        super().__init__(params or RuleFitParameters(**kw))

    def _grow_generator(self, frame: Frame) -> Model:
        """The rule generator: the JAX package's GBM or DRF at its fixed
        sample rate 0.7 and learn rate 0.1, on this fit's features and
        weights and device."""
        from .tree.drf import DRF
        from .tree.gbm import GBM
        p: RuleFitParameters = self.params
        gen_cls = GBM if p.algorithm == "gbm" else DRF
        return gen_cls(response_column=p.response_column,
                       ignored_columns=p.ignored_columns,
                       weights_column=p.weights_column,
                       ntrees=p.rule_generation_ntrees,
                       max_depth=max(p.max_rule_length, 1),
                       seed=p.effective_seed(), sample_rate=0.7,
                       learn_rate=0.1, device=p.device).train(frame)

    def _fit(self, job: Job, frame: Frame, di: DataInfo,
             valid: Optional[Frame]) -> RuleFitModel:
        from .glm import GLM
        p: RuleFitParameters = self.params
        if di.is_classifier and di.nclasses > 2:
            raise ValueError("rulefit supports regression and binary "
                             "classification only (multinomial rule "
                             "generation not yet implemented)")
        job.update(0.1, "growing rule trees")
        gen = self._grow_generator(frame)

        # enumerate rules: every node at depths [min_len, max_len]
        rules, descr = [], []
        for t_i, tree in enumerate(gen._host_trees()):
            D = len(tree.feat)
            for d in range(p.min_rule_length, min(p.max_rule_length, D) + 1):
                for nid in range(2 ** d):
                    rules.append((t_i, d, nid))
                    descr.append(self._describe(tree, d, nid, di))
        if p.max_num_rules > 0 and len(rules) > p.max_num_rules:
            keep = np.random.default_rng(p.effective_seed()).choice(
                len(rules), p.max_num_rules, replace=False)
            rules = [rules[i] for i in sorted(keep)]
            descr = [descr[i] for i in sorted(keep)]

        model = RuleFitModel(job.dest_key or dkv.make_key(self.algo), p, di)
        model.output.update({
            "rule_model_key": gen.key,
            "rules": rules,
            "rule_descriptions": descr,
        })

        job.update(0.5, f"fitting sparse GLM over {len(rules)} rules")
        glm_train = model._glm_frame(frame, with_response=True)
        lam = p.lambda_
        glm = GLM(response_column=p.response_column, alpha=1.0,
                  lambda_=lam, lambda_search=lam is None,
                  seed=p.effective_seed(), device=p.device).train(glm_train)
        model.output["glm_key"] = glm.key
        model.training_metrics = glm.training_metrics
        if valid is not None:
            model.validation_metrics = model.model_performance(valid)
        return model

    @staticmethod
    def _describe(tree, depth: int, nid: int, di: DataInfo) -> str:
        """Root-path conjunction for a node (rule text), from a tree of
        host arrays."""
        conds = []
        node = nid
        for d in range(depth - 1, -1, -1):
            parent = node >> 1
            right = node & 1
            feat = int(np.asarray(tree.feat[d][parent])) \
                if np.ndim(tree.feat[d]) else int(tree.feat[d])
            thr = float(np.asarray(tree.thr[d][parent]))
            name = di.specs[feat].name if feat < len(di.specs) else f"f{feat}"
            op = ">=" if right else "<"
            conds.append(f"{name} {op} {thr:.6g}")
            node = parent
        return " & ".join(reversed(conds))
