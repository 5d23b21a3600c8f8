"""h2o3_tpu_torch — the PyTorch/CUDA port of h2o3_tpu.

It runs beside the JAX package, which stays the reference it is tested
against, and imports nothing of it (nor jax).  So far it holds the
online scoring plane and the tree-training main path:

* ``frame``   — ``Frame`` / ``Vec``: numeric, categorical and time
  columns as padded device tensors, string columns on the host, the
  file import (``frame.parse``: ``import_file``, ``upload_string``,
  ``H2OFrame``, ``export_file``) through the native CSV tokenizer
  (``fastcsv``, host C++ built with g++ at first use), and the frame
  synthesis of ``frame.create`` (``create_frame`` and its kin).
* ``rapids``  — the data plane: sort, group-by, merge, filters and the
  other munging verbs on the device (``ops``, ``device``; also
  ``Frame.sort``/``group_by``/``merge``/...), the string verbs, and the
  Rapids expression language (``rapids("(GB ...)")``, ``lazy``).
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
  row blocks, host f64 solves, the JAX package's numpy draws), the
  composite builders that fit through GLM and the trees: ``adaboost``,
  ``rulefit``, ``ensemble`` (StackedEnsemble), ``gam``, ``anovaglm``
  and ``modelselection``, one model per data segment (``segments``:
  ``train_segments``), ``infogram``, ``grep``, and concurrent builds
  (``parallel``: the grid's ``parallelism=n`` waves).
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
from .frame.create import (create_frame, dct_transform, insert_missing_values,
                           interaction, tabulate)
from .frame.frame import Frame
from .frame.parse import H2OFrame, import_file, upload_string
from .frame.vec import Vec
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
from .models import (Grep, Infogram, InfogramModel, InfogramParameters,
                     SegmentModels, train_segments)
from .models.deeplearning import DeepLearning, DeepLearningParameters
from .models.glm import GLM, GLMParameters
from .models.tree.gbm import GBM
from .models.tree.xgboost import XGBoost

__all__ = ["Aggregator", "CoxPH", "DeepLearning", "DeepLearningParameters",
           "Frame", "GBM", "GLM", "GLMParameters", "GLRM", "Grep",
           "H2OFrame", "Infogram", "InfogramModel", "InfogramParameters",
           "IsotonicRegression", "KMeans", "NaiveBayes", "PCA", "PSVM",
           "Quantile", "SVD", "SegmentModels", "TargetEncoder", "Vec",
           "Word2Vec", "XGBoost", "create_frame", "dct_transform",
           "export_mojo", "import_file", "import_mojo",
           "insert_missing_values", "interaction", "quantile", "tabulate",
           "train_segments", "upload_string"] + list(COMPOSITES)
