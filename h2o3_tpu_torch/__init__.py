"""h2o3_tpu_torch — the PyTorch/CUDA port of h2o3_tpu.

It runs beside the JAX package, which stays the reference it is tested
against, and imports nothing of it (nor jax).  So far it holds the
online scoring plane and the tree-training main path:

* ``frame``   — ``Frame`` / ``Vec``: numeric, categorical and time
  columns as padded device tensors, string columns on the host, and the
  file import (``frame.parse``: ``import_file``, ``upload_string``,
  ``H2OFrame``, ``export_file``) through the native CSV tokenizer
  (``fastcsv``, host C++ built with g++ at first use).
* ``models``  — the training contract (``base``, ``datainfo``,
  ``distributions``, ``scorekeeper``) with the shared options: class
  balancing, a custom metric and cross-validation (``cv``), the tree
  family
  (``models.tree``: binning, the level kernels' wrappers in ``hist``,
  the growth loop in ``shared``, ``gbm``, ``xgboost``, and the batched
  grid cohorts of ``grid_batch``, ``drf``, ``dt``, ``isofor``:
  IsolationForest and ExtendedIsolationForest, ``uplift``: UpliftDRF,
  ``efb``: exclusive feature bundling), with the CUDA histogram and
  split-record kernels (XGBoost's DART booster, GBM's ten
  distributions, monotone constraints and probability calibration
  included), GLM (``glm``: IRLSM with COD, the lambda path,
  L-BFGS, multinomial and ordinal, on the one-hot design of
  ``datainfo.make_matrix``), DeepLearning (``deeplearning``: the MLP
  and autoencoder, cuBLAS products in bf16 with f32 output or in full
  f32, ``torch.optim``'s ADADELTA or SGD), the grid search
  (``grid``: ``GridSearch``), and the unsupervised, survival and
  feature-engineering families: ``kmeans``, ``aggregator``, ``pca``
  (PCA and SVD), ``glrm``, ``naivebayes``, ``quantile`` (with the
  ``quantile`` function), ``isotonic``, ``coxph``, ``psvm``,
  ``targetencoder`` and ``word2vec`` (cuBLAS f32 products reduced over
  row blocks, host f64 solves, the JAX package's numpy draws), and the
  composite builders that fit through GLM and the trees: ``adaboost``,
  ``rulefit``, ``ensemble`` (StackedEnsemble), ``gam``, ``anovaglm``
  and ``modelselection``.
* ``metrics`` — binomial (with gains/lift), multinomial, regression and
  uplift metrics, and a custom metric.
* ``export``  — the numpy ``ScoringModel``, the archive writer
  (``export_mojo``) and reader (``import_mojo``), and ``from_reference``
  for models trained by the JAX package or by the port
  (``model.to_archive()``).
* ``serving`` — the bitpacked ensemble (``pack``), the device scorer
  with its CUDA traversal kernel (``kernel``), and the micro-batcher
  with the published-model registry (``batcher``).
* ``runtime`` — the device (``device``), the ``H2O3_TPU_*`` config, the
  metric registry, the local key store and blocking jobs.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

from .export.mojo import export_mojo, import_mojo
from .frame.parse import H2OFrame, import_file, upload_string
from .models import (ANOVAGLM, GAM, PSVM, SVD, AdaBoost, AdaBoostModel,
                     AdaBoostParameters, Aggregator, ANOVAGLMModel,
                     ANOVAGLMParameters, CoxPH, GAMModel, GAMParameters,
                     GLRM, IsotonicRegression, KMeans, ModelSelection,
                     ModelSelectionModel, ModelSelectionParameters,
                     NaiveBayes, PCA, Quantile, RuleFit, RuleFitModel,
                     RuleFitParameters, StackedEnsemble,
                     StackedEnsembleModel, StackedEnsembleParameters,
                     TargetEncoder, Word2Vec, quantile)
from .models import COMPOSITES
from .models.deeplearning import DeepLearning, DeepLearningParameters
from .models.glm import GLM, GLMParameters
from .models.tree.gbm import GBM
from .models.tree.xgboost import XGBoost

__all__ = ["Aggregator", "CoxPH", "DeepLearning", "DeepLearningParameters",
           "GBM", "GLM", "GLMParameters", "GLRM", "H2OFrame",
           "IsotonicRegression", "KMeans", "NaiveBayes", "PCA", "PSVM",
           "Quantile", "SVD", "TargetEncoder", "Word2Vec", "XGBoost",
           "export_mojo", "import_file", "import_mojo", "quantile",
           "upload_string"] + list(COMPOSITES)
