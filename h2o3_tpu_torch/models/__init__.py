"""Models: the training contract with its shared options
(cross-validation in ``cv``), the GBM distributions (``distributions``:
the JAX package's ten families and a custom one), the tree family, GLM,
DeepLearning, the grid search (with concurrent waves through
``parallel.map_builds``), the unsupervised, survival and
feature-engineering families (KMeans, Aggregator, PCA/SVD, GLRM,
NaiveBayes, Quantile, IsotonicRegression, CoxPH, PSVM, TargetEncoder,
Word2Vec), the composite builders that fit through GLM and the trees
(AdaBoost, RuleFit, StackedEnsemble, GAM, ANOVAGLM, ModelSelection), one
model per data segment (``train_segments``), Infogram and Grep."""

from .adaboost import AdaBoost, AdaBoostModel, AdaBoostParameters
from .aggregator import Aggregator
from .anovaglm import ANOVAGLM, ANOVAGLMModel, ANOVAGLMParameters
from .coxph import CoxPH
from .deeplearning import DeepLearning, DeepLearningParameters
from .distributions import CustomDistribution, make_distribution
from .ensemble import (StackedEnsemble, StackedEnsembleModel,
                       StackedEnsembleParameters)
from .gam import GAM, GAMModel, GAMParameters
from .glm import GLM, GLMParameters
from .glrm import GLRM
from .grep import Grep, GrepModel, GrepParameters, grep
from .grid import Grid, GridSearch
from .infogram import Infogram, InfogramModel, InfogramParameters
from .isotonic import IsotonicRegression
from .kmeans import KMeans
from .modelselection import (ModelSelection, ModelSelectionModel,
                             ModelSelectionParameters)
from .naivebayes import NaiveBayes
from .pca import PCA, SVD
from .psvm import PSVM
from .quantile import Quantile, quantile
from .rulefit import RuleFit, RuleFitModel, RuleFitParameters
from .segments import SegmentModels, train_segments
from .targetencoder import TargetEncoder
from .tree.drf import DRF
from .tree.dt import DecisionTree
from .tree.gbm import GBM, GBMParameters
from .tree.isofor import ExtendedIsolationForest, IsolationForest
from .tree.uplift import UpliftDRF
from .tree.xgboost import XGBoost, XGBoostParameters
from .word2vec import Word2Vec

# the composite builders with their model and parameter classes
COMPOSITES = ("AdaBoost", "AdaBoostModel", "AdaBoostParameters", "ANOVAGLM",
              "ANOVAGLMModel", "ANOVAGLMParameters", "GAM", "GAMModel",
              "GAMParameters", "ModelSelection", "ModelSelectionModel",
              "ModelSelectionParameters", "RuleFit", "RuleFitModel",
              "RuleFitParameters", "StackedEnsemble", "StackedEnsembleModel",
              "StackedEnsembleParameters")

__all__ = ["Aggregator", "CoxPH", "CustomDistribution", "DRF",
           "DecisionTree", "DeepLearning", "DeepLearningParameters",
           "ExtendedIsolationForest", "GBM", "GBMParameters", "GLM",
           "GLMParameters", "GLRM", "Grep", "GrepModel", "GrepParameters",
           "Grid", "GridSearch", "Infogram", "InfogramModel",
           "InfogramParameters", "IsolationForest", "IsotonicRegression",
           "KMeans", "NaiveBayes", "PCA", "PSVM", "Quantile", "SVD",
           "SegmentModels", "TargetEncoder", "UpliftDRF", "Word2Vec",
           "XGBoost", "XGBoostParameters", "grep", "make_distribution",
           "quantile", "train_segments"] + list(COMPOSITES)
