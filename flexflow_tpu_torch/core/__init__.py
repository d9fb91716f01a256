"""The serve graph IR and the placement IR: nodes over tensor ids
(``graph``), the node runner (``interpreter``), per-tensor shardings
(``sharding``), the op IR (``op``) and the parallel computation graph
with its plans (``pcg``)."""

from .graph import TOKENS, Graph, Node, ParamSpec, TensorSpec, live_cuts
from .interpreter import StepContext, run_nodes
from .op import Op, ShardingSolution
from .pcg import PCG, Plan, Step, serve_graph
from .sharding import DimSharding, TensorSharding

__all__ = ["PCG", "TOKENS", "DimSharding", "Graph", "Node", "Op",
           "ParamSpec", "Plan", "ShardingSolution", "StepContext", "Step",
           "TensorSharding", "TensorSpec", "live_cuts", "run_nodes",
           "serve_graph"]
