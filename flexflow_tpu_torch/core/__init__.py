"""The serve graph IR: nodes over tensor ids (``graph``) and the node
runner (``interpreter``)."""

from .graph import TOKENS, Graph, Node, TensorSpec, live_cuts
from .interpreter import StepContext, run_nodes

__all__ = ["TOKENS", "Graph", "Node", "StepContext", "TensorSpec",
           "live_cuts", "run_nodes"]
