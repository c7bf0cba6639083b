"""BACO core in PyTorch: graph, weights, sketch, the LP solver and the
ClusterEngine that builds a sketch."""
from .graph import BipartiteGraph, pad_rung
from .sketch import Sketch, compact_labels
from .weights import WEIGHT_SCHEMES, make_weights
from .engine import ClusterEngine, ClusterSolver, get_solver, register_solver

__all__ = ["BipartiteGraph", "pad_rung", "Sketch", "compact_labels",
           "make_weights", "WEIGHT_SCHEMES", "ClusterEngine",
           "ClusterSolver", "get_solver", "register_solver"]
