"""Models: the training contract with its shared options
(cross-validation in ``cv``), the GBM distributions (``distributions``:
the JAX package's ten families and a custom one), the tree family, GLM,
DeepLearning, the grid search, and the unsupervised, survival and
feature-engineering families (KMeans, Aggregator, PCA/SVD, GLRM,
NaiveBayes, Quantile, IsotonicRegression, CoxPH, PSVM, TargetEncoder,
Word2Vec)."""

from .aggregator import Aggregator
from .coxph import CoxPH
from .deeplearning import DeepLearning, DeepLearningParameters
from .distributions import CustomDistribution, make_distribution
from .glm import GLM, GLMParameters
from .glrm import GLRM
from .grid import Grid, GridSearch
from .isotonic import IsotonicRegression
from .kmeans import KMeans
from .naivebayes import NaiveBayes
from .pca import PCA, SVD
from .psvm import PSVM
from .quantile import Quantile, quantile
from .targetencoder import TargetEncoder
from .tree.drf import DRF
from .tree.dt import DecisionTree
from .tree.gbm import GBM, GBMParameters
from .tree.isofor import ExtendedIsolationForest, IsolationForest
from .tree.uplift import UpliftDRF
from .tree.xgboost import XGBoost, XGBoostParameters
from .word2vec import Word2Vec

__all__ = ["Aggregator", "CoxPH", "CustomDistribution", "DRF",
           "DecisionTree", "DeepLearning", "DeepLearningParameters",
           "ExtendedIsolationForest", "GBM", "GBMParameters", "GLM",
           "GLMParameters", "GLRM", "Grid", "GridSearch", "IsolationForest",
           "IsotonicRegression", "KMeans", "NaiveBayes", "PCA", "PSVM",
           "Quantile", "SVD", "TargetEncoder", "UpliftDRF", "Word2Vec",
           "XGBoost", "XGBoostParameters", "make_distribution", "quantile"]
