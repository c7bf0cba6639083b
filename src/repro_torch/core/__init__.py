"""BACO core in PyTorch: graph, weights, sketch, the LP solvers, the
ClusterEngine that builds a sketch, and the ETC baseline zoo."""
from .graph import BipartiteGraph, node_aligned_bounds, pad_rung
from .sketch import Sketch, compact_labels
from .weights import WEIGHT_SCHEMES, make_weights
from .engine import (ClusterEngine, ClusterSolver, available_solvers,
                     get_solver, normalize_solver, register_solver)
from .baco import baco_build, fit_gamma, secondary_user_labels
from .baselines import BASELINES, build_sketch

__all__ = ["BipartiteGraph", "node_aligned_bounds", "pad_rung", "Sketch",
           "compact_labels", "make_weights", "WEIGHT_SCHEMES",
           "ClusterEngine", "ClusterSolver", "available_solvers",
           "get_solver", "normalize_solver", "register_solver",
           "baco_build", "fit_gamma", "secondary_user_labels",
           "build_sketch", "BASELINES"]
