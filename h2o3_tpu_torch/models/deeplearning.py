"""DeepLearning: the multi-layer perceptron and autoencoder — the port of
``h2o3_tpu/models/deeplearning.py``.

Reference: ``hex/deeplearning/`` — DeepLearning.java (the training loop),
DeepLearningTask.java:17 (Hogwild! per-node SGD), Neurons.java:184/189
(per-row fprop/bprop), Dropout.java, DeepLearningModelInfo.java.

As in the JAX package, training is synchronous minibatch SGD on the
standardized one-hot design (``datainfo.make_matrix``): the rows are
permuted once (``shuffle_training_data``) and given a wrap-around copy of
the first ``batch`` rows, and each step takes the contiguous block at an
offset drawn uniformly in [0, n) (a view, no gather).  A step is the
forward pass (``forward_pass``, shared with scoring: tanh, rectifier, or
maxout as a pairwise max over doubled hidden units, each with its
``_with_dropout`` form), the weighted mean of the per-row loss plus
``l2·ΣW² + l1·Σ|W|``, autograd's backward and a ``torch.optim`` step:
ADADELTA (``Adadelta(lr=1.0)``, optax's ``adadelta``), SGD with momentum
or plain SGD.  The products are cuBLAS's: ``precision="bf16"`` (the
default) multiplies bf16-rounded operands into an f32 product (f32
master weights and optimiser state), ``"f32"`` multiplies in full f32
and refuses to run with TF32 matmuls allowed.

The draws (initial weights, the permutation, each iteration's offsets)
come from CPU generators, one per stream, seeded by a splitmix64 mix of
(seed, stream, index): the offsets are Python ints, so no step waits on
the device, and a seed gives the same model's draws on either device.
Dropout masks come from a generator on the training device.
``reference_draws`` hands a train another set of draws (a test gives the
JAX package's).

Not ported here: checkpoints, and the runtime planes' fault injection,
device-lease turns and progress snapshots (ROADMAP Queue 1 item 9).
``distribution``, ``score_interval`` and ``max_iterations`` are accepted
and never read, as in the JAX package (``epochs`` governs the length).
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..frame.frame import Frame
from ..frame.vec import T_CAT, T_NUM, Vec
from ..metrics.core import make_metrics
from ..runtime import dkv
from ..runtime.job import Job
from .base import Model, ModelBuilder, Parameters
from .datainfo import DataInfo
from .scorekeeper import stop_early
from .tree.shared import _M64, _splitmix64

LOSSES = ("automatic", "cross_entropy", "quadratic", "absolute", "huber")
# the draw streams
INIT, PERMUTATION, OFFSETS, DROPOUT = range(4)


@dataclasses.dataclass
class DeepLearningParameters(Parameters):
    hidden: Sequence[int] = (200, 200)
    # tanh|rectifier|maxout, each also with "_with_dropout"
    activation: str = "rectifier"
    epochs: float = 10.0
    mini_batch_size: int = 128
    adaptive_rate: bool = True           # ADADELTA (rho, epsilon)
    rho: float = 0.99
    epsilon: float = 1e-8
    rate: float = 0.005                  # when adaptive_rate=False
    momentum_start: float = 0.0
    momentum_stable: float = 0.0
    input_dropout_ratio: float = 0.0
    hidden_dropout_ratios: Optional[Sequence[float]] = None
    l1: float = 0.0
    l2: float = 0.0
    # a per-row loss: a torch callable (pred, y) -> [B]; pred is the
    # logits [B, K] of a classifier or autoencoder (y the design rows
    # there), the [B] prediction otherwise (a regression's y standardized
    # when ``standardize``)
    custom_loss_func: Optional[Callable] = None
    loss: str = "automatic"              # automatic|cross_entropy|quadratic|
    # absolute|huber
    distribution: str = "auto"           # accepted, never read
    train_samples_per_iteration: int = -2   # -2 auto, -1 all, 0 one epoch
    score_interval: float = 5.0          # accepted, never read
    initial_weight_distribution: str = "uniform_adaptive"
    initial_weight_scale: float = 1.0
    autoencoder: bool = False
    standardize: bool = True
    stopping_rounds: int = 5
    stopping_metric: str = "auto"
    stopping_tolerance: float = 0.0
    max_iterations: int = 10 ** 9        # accepted, never read
    precision: str = "bf16"              # bf16|f32
    shuffle_training_data: bool = True


# ------------------------------------------------------------ the products
class _BF16Product(torch.autograd.Function):
    """``a @ w`` of bf16-rounded operands into an f32 product (f32
    accumulation), and the same products in the backward pass."""

    @staticmethod
    def forward(ctx, a, w):
        ab, wb = a.to(torch.bfloat16), w.to(torch.bfloat16)
        ctx.save_for_backward(ab, wb)
        return _f32_product(ab, wb)

    @staticmethod
    def backward(ctx, g):
        ab, wb = ctx.saved_tensors
        gb = g.to(torch.bfloat16)
        ga = _f32_product(gb, wb.t()) if ctx.needs_input_grad[0] else None
        return ga, _f32_product(ab.t(), gb)


def _f32_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The f32 product of two bf16 matrices: cuBLAS's bf16 tensor-core
    GEMM with an f32 output on the card; on the CPU the f32 product of
    the upcast operands (exact: a product of two bf16 values fits f32)."""
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def product(h: torch.Tensor, W: torch.Tensor, bf16: bool) -> torch.Tensor:
    """One layer's product ``h @ W``, f32 out either way."""
    return _BF16Product.apply(h, W) if bf16 else h @ W


def check_full_f32(device: torch.device) -> None:
    """The f32 path's matmuls are full f32: TF32 would round the operands
    to 10 mantissa bits."""
    if device.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "DeepLearning precision='f32' runs full f32 matmuls: turn TF32 "
            "off (torch.backends.cuda.matmul.allow_tf32 = False)")


# ---------------------------------------------------------- forward pass
def _activation(name: str):
    base = name.replace("_with_dropout", "")
    if base == "tanh":
        return torch.tanh
    if base == "rectifier":
        return torch.relu
    if base == "maxout":
        return None                      # the pairwise max below
    raise ValueError(f"unknown activation {name!r}")


def _dropped(x: torch.Tensor, ratio: float, gen) -> torch.Tensor:
    """``x`` with each unit kept with probability 1 - ratio and scaled by
    1 / (1 - ratio)."""
    keep = 1.0 - ratio
    mask = torch.rand(x.shape, generator=gen, device=x.device) < keep
    return x * mask / keep


def forward_pass(activation: str, params, X: torch.Tensor, gen=None,
                 dropout_in: float = 0.0, dropout_hidden=(),
                 bf16: bool = False) -> torch.Tensor:
    """THE forward pass, shared by training and scoring: the logits
    [B, out].  Dropout applies only given a generator ``gen`` (training);
    maxout takes the max of each adjacent pair of a hidden layer's
    doubled units."""
    act = _activation(activation)
    h = X
    if gen is not None and dropout_in > 0:
        h = _dropped(h, dropout_in, gen)
    for i, (W, b) in enumerate(params[:-1]):
        z = product(h, W, bf16) + b
        z = z.view(z.shape[0], -1, 2).amax(dim=2) if act is None else act(z)
        dr = dropout_hidden[i] if i < len(dropout_hidden) else 0.0
        if gen is not None and dr > 0:
            z = _dropped(z, dr, gen)
        h = z
    W, b = params[-1]
    return product(h, W, bf16) + b


def row_loss(logits, xb, yb, loss_kind: str, is_cls: bool, autoenc: bool,
             out_dim: int, custom=None) -> torch.Tensor:
    """The per-row loss [B]: cross entropy on the class codes (clipped to
    [0, K-1]), the autoencoder's mean squared reconstruction error, or
    the quadratic, absolute or huber (delta 1) loss of the prediction."""
    if custom is not None:
        pred = logits if (is_cls or autoenc) else logits[:, 0]
        return custom(pred, xb if autoenc else yb)
    if autoenc:
        return ((logits - xb) ** 2).mean(dim=1)
    if is_cls:
        return F.cross_entropy(logits, yb.long().clamp(0, out_dim - 1),
                               reduction="none")
    if loss_kind == "absolute":
        return (logits[:, 0] - yb).abs()
    if loss_kind == "huber":
        return F.huber_loss(logits[:, 0], yb, reduction="none", delta=1.0)
    return (logits[:, 0] - yb) ** 2


def objective(params, per: torch.Tensor, wb: torch.Tensor, l1: float,
              l2: float) -> torch.Tensor:
    """The weighted mean of the per-row loss plus l2·ΣW² + l1·Σ|W| over
    the weight matrices (not the biases)."""
    loss = (per * wb).sum() / wb.sum().clamp_min(1e-12)
    if l2 > 0 or l1 > 0:
        for W, _ in params:
            loss = loss + l2 * (W * W).sum() + l1 * W.abs().sum()
    return loss


# ----------------------------------------------------------------- draws
def _generator(seed: int, stream: int, index: int,
               device="cpu") -> torch.Generator:
    """The generator of draw ``stream`` (``index``: a layer, an
    iteration), seeded by a splitmix64 mix of (seed, stream, index)."""
    h = _splitmix64(int(seed) & _M64)
    for v in (stream, index):
        h = _splitmix64(h ^ (int(v) & _M64))
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed(h >> 1)
    return gen


class SeededDraws:
    """A train's draws from its seed, each from its own CPU generator."""

    def __init__(self, seed: int):
        self.seed = seed

    def init_weights(self, sizes: List[int], maxout: bool, dist: str,
                     scale: float):
        """[(W [fan_in, units], b [units])]: ``uniform_adaptive`` is
        U(±√(6 / (fan_in + units))), units doubled on a maxout hidden
        layer; ``normal`` N(0, scale²), ``uniform`` U(±scale); b zeros."""
        out = []
        for i, (fan_in, fan_out) in enumerate(zip(sizes[:-1], sizes[1:])):
            units = fan_out * (2 if maxout and i < len(sizes) - 2 else 1)
            gen = _generator(self.seed, INIT, i)
            if dist == "normal":
                W = scale * torch.randn((fan_in, units), generator=gen)
            else:
                s = math.sqrt(6.0 / (fan_in + units)) \
                    if dist == "uniform_adaptive" else scale
                W = (torch.rand((fan_in, units), generator=gen) * 2 - 1) * s
            out.append((W, torch.zeros(units)))
        return out

    def permutation(self, n: int) -> torch.Tensor:
        return torch.randperm(n, generator=_generator(self.seed,
                                                      PERMUTATION, 0))

    def offsets(self, it: int, steps: int, n: int) -> List[int]:
        """Iteration ``it``'s block offsets, uniform in [0, n)."""
        return torch.randint(0, max(n, 1), (steps,), generator=_generator(
            self.seed, OFFSETS, it)).tolist()


class _GivenDraws:
    def __init__(self, weights, perm, offsets):
        self.weights, self.perm, self.offs = weights, perm, offsets

    def init_weights(self, sizes, maxout, dist, scale):
        return self.weights

    def permutation(self, n: int) -> torch.Tensor:
        return self.perm

    def offsets(self, it: int, steps: int, n: int) -> List[int]:
        offs = [int(v) for v in self.offs[it]]
        if len(offs) != steps:
            raise ValueError(f"iteration {it}: {len(offs)} offsets given, "
                             f"{steps} steps")
        return offs


def reference_draws(init_weights, perm, offsets, device="cpu"):
    """Draws given from outside, as numpy arrays: ``init_weights`` [(W,
    b)], ``perm`` [n] and ``offsets`` [iterations, steps].  Set a
    builder's ``draws`` to the result to train on them (the tests hand
    over the JAX package's ``jax.random`` draws)."""
    dev = torch.device(device)
    weights = [(torch.tensor(np.asarray(W, np.float32), device=dev),
                torch.tensor(np.asarray(b, np.float32), device=dev))
               for W, b in init_weights]
    return _GivenDraws(weights, None if perm is None else torch.as_tensor(
        np.asarray(perm), dtype=torch.int64, device=dev),
        np.asarray(offsets, np.int64))


# ----------------------------------------------------------------- model
class DeepLearningModel(Model):
    algo = "deeplearning"

    def _params(self, device) -> list:
        return [(torch.as_tensor(W, device=device),
                 torch.as_tensor(b, device=device))
                for W, b in self.output["weights"]]

    def _logits(self, X: torch.Tensor) -> torch.Tensor:
        return forward_pass(self.params.activation, self._params(X.device),
                            X)

    def _predict_raw(self, X: torch.Tensor) -> torch.Tensor:
        """Class probabilities (softmax), the autoencoder's standardized
        reconstruction, or the regression's de-standardized prediction."""
        logits = self._logits(X)
        di = self.datainfo
        if self.params.autoencoder:
            return logits
        if di.is_classifier:
            return torch.softmax(logits, dim=1)
        mu = logits[:, 0]
        if di.standardize:
            mu = mu * di.response_sigma + di.response_mean
        return mu

    def predict(self, frame: Frame) -> Frame:
        """The reference's predictions; an autoencoder's are its
        reconstruction of each design column, ``reconstr_<coef>``, with
        the numeric columns un-standardized
        (DeepLearningModel.scoreAutoEncoder)."""
        if not self.params.autoencoder:
            return super().predict(frame)
        di = self.datainfo
        R = self._predict_raw(di.make_matrix(frame))[: frame.nrows] \
            .double().cpu().numpy()
        if di.standardize:
            for s in di.specs:
                if s.type != T_CAT:
                    R[:, s.offset] = R[:, s.offset] * s.sigma + s.mean
        cnames = di.coef_names
        names = [f"reconstr_{cnames[j] if j < len(cnames) else j}"
                 for j in range(R.shape[1])]
        return Frame(names, [Vec.from_numpy(R[:, j], T_NUM,
                                            device=frame.device)
                             for j in range(R.shape[1])])

    def anomaly(self, frame: Frame) -> Frame:
        """The autoencoder's per-row reconstruction MSE on the
        standardized design (DL anomaly detection)."""
        X = self.datainfo.make_matrix(frame)
        err = ((self._predict_raw(X) - X) ** 2).mean(dim=1)[: frame.nrows]
        return Frame(["Reconstruction.MSE"], [Vec.from_numpy(
            err.cpu().numpy(), T_NUM, device=frame.device)])

    def to_archive(self):
        """``(meta, arrays)`` in the portable archive layout that
        ``export.mojo.from_reference`` reads (the JAX package's
        ``export/mojo.py::_extract``): the activation, the response's
        mean and sigma, and each layer's ``W_i``, ``b_i``.  The archive's
        scorer has no maxout and no reconstruction form, so a maxout
        model and an autoencoder raise."""
        from ..export.mojo import datainfo_meta
        act = self.params.activation
        if act.startswith("maxout"):
            raise ValueError("portable export does not support maxout")
        if self.params.autoencoder:
            raise ValueError("an autoencoder has no archive form: the numpy "
                             "scorer makes no reconstruction")
        di = self.datainfo
        meta = {
            "algo": self.algo, "format_version": 1,
            "datainfo": datainfo_meta(di),
            "default_threshold": float(self.default_threshold())
            if di.is_classifier else 0.5,
            "family": "deeplearning",
            "activation": "tanh" if act.startswith("tanh") else "rectifier",
            "response_mean": float(di.response_mean),
            "response_sigma": float(di.response_sigma),
        }
        arrays = {}
        for i, (W, b) in enumerate(self.output["weights"]):
            arrays[f"W_{i}"] = np.asarray(W, np.float32)
            arrays[f"b_{i}"] = np.asarray(b, np.float32)
        return meta, arrays


# --------------------------------------------------------------- builder
class DeepLearning(ModelBuilder):
    """DeepLearning builder — h2o.deeplearning analog."""

    algo = "deeplearning"
    model_class = DeepLearningModel

    def __init__(self, params: Optional[DeepLearningParameters] = None,
                 **kw):
        super().__init__(params or DeepLearningParameters(**kw))
        self.supervised = not self.params.autoencoder
        # the train's draws: its seed's unless set (``reference_draws``)
        self.draws = None

    def _validate(self, frame: Frame) -> None:
        super()._validate(frame)
        p = self.params
        _activation(p.activation)
        if p.loss not in LOSSES:
            raise ValueError(f"unknown loss {p.loss!r} (one of {LOSSES})")
        if p.precision not in ("bf16", "f32"):
            raise ValueError(f"precision must be 'bf16' or 'f32', got "
                             f"{p.precision!r}")
        if p.initial_weight_distribution not in ("uniform_adaptive",
                                                 "uniform", "normal"):
            raise ValueError("unknown initial_weight_distribution "
                             f"{p.initial_weight_distribution!r}")

    def _sizing(self, n: int, batch: int):
        """(steps a iteration, iterations): ``train_samples_per_iteration``
        -1 or 0 is an epoch, -2 max(n / 10, 16 batches), else that many
        samples (at least a batch); ``epochs`` x n samples in all."""
        p = self.params
        tspi = p.train_samples_per_iteration
        if tspi in (-1, 0):
            per_iter = n
        elif tspi == -2:
            per_iter = max(n // 10, batch * 16)
        else:
            per_iter = max(int(tspi), batch)
        steps = max(per_iter // batch, 1)
        return steps, max(int(p.epochs * n) // (steps * batch), 1)

    def _fit(self, job: Job, frame: Frame, di: DataInfo,
             valid: Optional[Frame]) -> DeepLearningModel:
        p: DeepLearningParameters = self.params
        dev = frame.device
        bf16 = p.precision == "bf16"
        if not bf16:
            check_full_f32(dev)
        X = di.make_matrix(frame)
        n = frame.nrows
        is_cls = di.is_classifier and not p.autoencoder
        if p.autoencoder:
            y = torch.zeros(X.shape[0], device=dev)
            out_dim = X.shape[1]
        elif is_cls:
            y = di.response(frame)
            out_dim = di.nclasses
        else:
            y = di.response(frame)
            if di.standardize:
                y = (y - di.response_mean) / di.response_sigma
            y = torch.nan_to_num(y)
            out_dim = 1
        w = di.weights(frame)

        seed = p.effective_seed()
        draws = self.draws or SeededDraws(seed)
        maxout = p.activation.startswith("maxout")
        sizes = [X.shape[1], *p.hidden, out_dim]
        params = [(W.to(dev, torch.float32).clone().requires_grad_(),
                   b.to(dev, torch.float32).clone().requires_grad_())
                  for W, b in draws.init_weights(
                      sizes, maxout, p.initial_weight_distribution,
                      p.initial_weight_scale)]
        flat = [t for pair in params for t in pair]
        if p.adaptive_rate:
            opt = torch.optim.Adadelta(flat, lr=1.0, rho=p.rho,
                                       eps=p.epsilon, foreach=True)
        elif p.momentum_stable > 0 or p.momentum_start > 0:
            opt = torch.optim.SGD(flat, lr=p.rate, foreach=True,
                                  momentum=p.momentum_stable
                                  or p.momentum_start)
        else:
            opt = torch.optim.SGD(flat, lr=p.rate, foreach=True)

        loss_kind = p.loss
        if loss_kind == "automatic":
            loss_kind = "cross_entropy" if is_cls else "quadratic"
        dropout_h = tuple(p.hidden_dropout_ratios or ())
        if p.activation.endswith("_with_dropout") and not dropout_h:
            dropout_h = tuple(0.5 for _ in p.hidden)
        dgen = _generator(seed, DROPOUT, 0, dev)

        # the permuted rows and a wrap-around copy of the first batch, in
        # one gather: any block [off, off + batch) with off < n is a view
        batch = min(p.mini_batch_size, n)
        rows = draws.permutation(n).to(dev) if p.shuffle_training_data \
            else torch.arange(n, device=dev)
        idx = torch.cat([rows, rows[:batch]])
        Xe, ye, we = X[idx], y[idx], w[idx]
        steps, n_iters = self._sizing(n, batch)

        def step(off: int) -> torch.Tensor:
            xb, yb, wb = (t[off:off + batch] for t in (Xe, ye, we))
            logits = forward_pass(p.activation, params, xb, gen=dgen,
                                  dropout_in=p.input_dropout_ratio,
                                  dropout_hidden=dropout_h, bf16=bf16)
            per = row_loss(logits, xb, yb, loss_kind, is_cls,
                           p.autoencoder, out_dim, p.custom_loss_func)
            loss = objective(params, per, wb, p.l1, p.l2)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            return loss.detach()

        model = DeepLearningModel(job.dest_key or dkv.make_key(self.algo),
                                  p, di)
        history, device_losses = [], []
        seen = 0
        t0 = time.time()
        for it in range(n_iters):
            losses = [step(off) for off in draws.offsets(it, steps, n)]
            mean_loss = torch.stack(losses).mean()
            seen += steps * batch
            if p.stopping_rounds:
                # early stopping reads the loss on the host every iteration
                loss_v = float(mean_loss)
                history.append({
                    "iteration": it, "epochs": seen / n, "samples": seen,
                    "training_loss": loss_v,
                    "samples_per_sec": seen / max(time.time() - t0, 1e-9)})
                job.update((it + 1) / n_iters,
                           f"epoch {seen / n:.2f} loss {loss_v:.5f}")
                if stop_early([h["training_loss"] for h in history],
                              p.stopping_rounds, p.stopping_tolerance,
                              maximize=False):
                    break
            else:
                device_losses.append(mean_loss)      # fetched once below
                job.update((it + 1) / n_iters, f"epoch {seen / n:.2f}")
        if device_losses:
            iter_losses = torch.stack(device_losses).cpu().numpy()
            dt = max(time.time() - t0, 1e-9)
            done = 0
            for it, v in enumerate(iter_losses):
                done += steps * batch
                history.append({
                    "iteration": it, "epochs": done / n, "samples": done,
                    "training_loss": float(v),
                    "samples_per_sec": done / (dt * (it + 1)
                                               / len(iter_losses))})
        del Xe, ye, we

        model.output["weights"] = [(W.detach().cpu().numpy(),
                                    b.detach().cpu().numpy())
                                   for W, b in params]
        model.output["epochs_trained"] = seen / n
        model.output["samples_trained"] = seen
        model.scoring_history = history
        if not p.autoencoder:
            raw = model._predict_raw(X)
            model.training_metrics = make_metrics(di, raw, di.response(frame),
                                                  w)
            if valid is not None:
                model.validation_metrics = model.model_performance(valid)
        return model
