"""torch.fx import frontend: trace an ``nn.Module`` into an FFModel graph.

Port of ``flexflow_tpu/frontends/torch_fx.py`` (the reference's fx-based
PyTorch frontend, ``python/flexflow/torch/model.py``):
``torch.fx.symbolic_trace`` the module, walk the fx graph node by node,
emit the matching ``FFModel`` builder call, and take the module's tensors
as the weights.  The emitted graph is the builder's own, so planning,
the strategies and the training loop apply to imported models unchanged.

Vocabulary (reference :52-260): the modules Linear, Embedding, LayerNorm,
``MultiheadAttention`` (``batch_first``), Dropout, ReLU, GELU, SiLU,
Sigmoid, Tanh, Softmax, Conv2d (zero padding, no dilation), MaxPool2d and
AvgPool2d, BatchNorm2d (affine), Flatten and Identity; the functions
``add``, ``mul``, the activations, ``softmax``, ``flatten``, ``reshape``
and ``getitem``; the methods ``view``/``reshape``, ``flatten`` and
``relu``.  Any other node raises ``NotImplementedError`` naming its fx
target: gaps are explicit, never silent.  The weights come back as numpy
arrays keyed like ``model.params``, in the reference's layouts (a Linear's
kernel ``[in, out]``, the attention's per-head ``[e, h, hd]``).
"""

from __future__ import annotations

import operator
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..config import FFConfig
from ..model import FFModel


def _to_np(t: torch.Tensor) -> np.ndarray:
    """A copy: a later step on the module leaves the import's weights."""
    return t.detach().cpu().numpy().copy()


class _Importer:
    def __init__(self, gm, model: FFModel, input_shapes, dtype):
        self.gm = gm
        self.model = model
        self.input_shapes = list(input_shapes)
        self.dtype = dtype
        self.env: Dict = {}
        self.weights: Dict[str, Dict[str, np.ndarray]] = {}
        self._n_inputs = 0

    # -- node handlers ---------------------------------------------------
    def placeholder(self, node):
        shape = self.input_shapes[self._n_inputs]
        self._n_inputs += 1
        if (isinstance(shape, tuple) and len(shape) == 2
                and isinstance(shape[1], str)):   # (shape, dtype)
            self.env[node.name] = self.model.create_tensor(shape[0],
                                                           shape[1])
        else:
            self.env[node.name] = self.model.create_tensor(shape, self.dtype)

    def call_module(self, node):
        mod = self.gm.get_submodule(node.target)
        x = [self.env[a.name] for a in node.args]
        name = node.target.replace(".", "_")
        m = self.model
        if isinstance(mod, nn.Linear):
            out = m.dense(x[0], mod.out_features,
                          use_bias=mod.bias is not None, name=name)
            w = {"kernel": _to_np(mod.weight).T}   # [out, in] -> [in, out]
            if mod.bias is not None:
                w["bias"] = _to_np(mod.bias)
            self.weights[name] = w
        elif isinstance(mod, nn.Embedding):
            out = m.embedding(x[0], mod.num_embeddings, mod.embedding_dim,
                              name=name)
            self.weights[name] = {"weight": _to_np(mod.weight)}
        elif isinstance(mod, nn.LayerNorm):
            out = m.layer_norm(
                x[0], elementwise_affine=mod.elementwise_affine,
                eps=mod.eps, use_bias=mod.bias is not None, name=name)
            if mod.elementwise_affine:
                w = {"gamma": _to_np(mod.weight)}
                if mod.bias is not None:
                    w["beta"] = _to_np(mod.bias)
                self.weights[name] = w
        elif isinstance(mod, nn.MultiheadAttention):
            out = self._mha(node, mod, name)
        elif isinstance(mod, nn.Dropout):
            out = m.dropout(x[0], mod.p, name=name)
        elif isinstance(mod, nn.ReLU):
            out = m.relu(x[0], name=name)
        elif isinstance(mod, nn.GELU):
            out = m.gelu(x[0], name=name)
        elif isinstance(mod, nn.SiLU):
            out = m.silu(x[0], name=name)
        elif isinstance(mod, nn.Sigmoid):
            out = m.sigmoid(x[0], name=name)
        elif isinstance(mod, nn.Tanh):
            out = m.tanh(x[0], name=name)
        elif isinstance(mod, nn.Softmax):
            out = m.softmax(x[0], axis=mod.dim if mod.dim is not None else -1,
                            name=name)
        elif isinstance(mod, nn.Conv2d):
            out = self._conv(x[0], mod, name)
        elif isinstance(mod, (nn.MaxPool2d, nn.AvgPool2d)):
            out = self._pool(x[0], mod, name)
        elif isinstance(mod, nn.BatchNorm2d):
            if not mod.affine:
                raise NotImplementedError("BatchNorm2d requires affine=True")
            out = m.batch_norm(x[0], eps=mod.eps,
                               momentum=1.0 - mod.momentum, name=name)
            self.weights[name] = {
                "gamma": _to_np(mod.weight), "beta": _to_np(mod.bias),
                "running_mean": _to_np(mod.running_mean),
                "running_var": _to_np(mod.running_var)}
        elif isinstance(mod, nn.Flatten):
            out = m.flat(x[0], name=name)
        elif isinstance(mod, nn.Identity):
            out = x[0]
        else:
            raise NotImplementedError(
                f"torch.fx import: unsupported module {type(mod).__name__} "
                f"at node {node.target!r}")
        self.env[node.name] = out

    def _conv(self, x, mod, name):
        if mod.padding_mode != "zeros":
            raise NotImplementedError(
                f"Conv2d padding_mode {mod.padding_mode!r}")
        if tuple(mod.dilation) not in ((1,), (1, 1)):
            raise NotImplementedError(
                f"Conv2d dilation {mod.dilation} (the conv op has no "
                "dilation; importing would be silently wrong)")
        pad = mod.padding
        if isinstance(pad, str):
            pad = pad.upper()   # "same"/"valid"
        else:
            ph, pw = (pad, pad) if isinstance(pad, int) else pad
            pad = ((ph, ph), (pw, pw))
        out = self.model.conv2d(
            x, mod.out_channels, kernel=tuple(mod.kernel_size),
            stride=tuple(mod.stride), padding=pad,
            use_bias=mod.bias is not None, groups=mod.groups, name=name)
        w = {"kernel": _to_np(mod.weight)}   # both [O, I/g, kh, kw]
        if mod.bias is not None:
            w["bias"] = _to_np(mod.bias)
        self.weights[name] = w
        return out

    def _pool(self, x, mod, name):
        kind = "max" if isinstance(mod, nn.MaxPool2d) else "avg"
        if mod.ceil_mode:
            raise NotImplementedError("pool ceil_mode=True")
        if kind == "max" and tuple(np.atleast_1d(mod.dilation)) not in (
                (1,), (1, 1)):
            raise NotImplementedError(f"MaxPool2d dilation {mod.dilation}")
        if kind == "avg" and not mod.count_include_pad:
            raise NotImplementedError("AvgPool2d count_include_pad=False")
        k = mod.kernel_size
        k = (k, k) if isinstance(k, int) else tuple(k)
        s = mod.stride if mod.stride is not None else k
        s = (s, s) if isinstance(s, int) else tuple(s)
        ph, pw = ((mod.padding, mod.padding) if isinstance(mod.padding, int)
                  else mod.padding)
        padding = "VALID" if (ph, pw) == (0, 0) else ((ph, ph), (pw, pw))
        return self.model.pool2d(x, kernel=k, stride=s, padding=padding,
                                 pool_type=kind, name=name)

    def _mha(self, node, mod, name):
        if not mod.batch_first:
            raise NotImplementedError(
                "nn.MultiheadAttention import requires batch_first=True")
        q, k, v = (self.env[a.name] for a in node.args[:3])
        e, h = mod.embed_dim, mod.num_heads
        hd = e // h
        out = self.model.multihead_attention(
            q, k, v, e, h, use_bias=mod.in_proj_bias is not None, name=name)
        if mod.in_proj_weight is not None:
            wq, wk, wv = np.split(_to_np(mod.in_proj_weight), 3, axis=0)
        else:
            wq, wk, wv = (_to_np(mod.q_proj_weight),
                          _to_np(mod.k_proj_weight),
                          _to_np(mod.v_proj_weight))
        w = {   # torch [e_out, e_in] -> [e_in, h, hd]
            "wq": wq.T.reshape(e, h, hd), "wk": wk.T.reshape(e, h, hd),
            "wv": wv.T.reshape(e, h, hd),
            "wo": _to_np(mod.out_proj.weight).T.reshape(h, hd, e)}
        if mod.in_proj_bias is not None:
            bq, bk, bv = np.split(_to_np(mod.in_proj_bias), 3, axis=0)
            w.update(bq=bq.reshape(h, hd), bk=bk.reshape(h, hd),
                     bv=bv.reshape(h, hd), bo=_to_np(mod.out_proj.bias))
        self.weights[name] = w
        return (out, None)   # torch's MHA returns (output, attn_weights)

    def call_function(self, node):
        m = self.model
        args = [self.env[a.name] if hasattr(a, "name") and a.name in self.env
                else a for a in node.args]
        fn = node.target
        name = node.name
        if fn is operator.getitem:
            # a tuple-returning module (MultiheadAttention -> (out, attn))
            self.env[node.name] = args[0][args[1]]
            return
        if fn in (operator.add, torch.add):
            out = m.add(args[0], args[1], name=name)
        elif fn in (operator.mul, torch.mul):
            out = m.multiply(args[0], args[1], name=name)
        elif fn in (torch.relu, F.relu):
            out = m.relu(args[0], name=name)
        elif fn is F.gelu:
            out = m.gelu(args[0], name=name)
        elif fn is F.silu:
            out = m.silu(args[0], name=name)
        elif fn is torch.sigmoid:
            out = m.sigmoid(args[0], name=name)
        elif fn is torch.tanh:
            out = m.tanh(args[0], name=name)
        elif fn in (torch.softmax, F.softmax):
            axis = node.kwargs.get("dim", args[1] if len(args) > 1 else -1)
            out = m.softmax(args[0], axis=axis, name=name)
        elif fn is torch.flatten:
            out = m.flat(args[0], name=name)
        elif fn is torch.reshape:
            out = m.reshape(args[0], args[1], name=name)
        else:
            raise NotImplementedError(
                f"torch.fx import: unsupported function {fn} at {node.name}")
        self.env[node.name] = out

    def call_method(self, node):
        m = self.model
        args = [self.env[a.name] if hasattr(a, "name") and a.name in self.env
                else a for a in node.args]
        meth = node.target
        if meth in ("view", "reshape"):
            out = m.reshape(args[0], tuple(args[1:]), name=node.name)
        elif meth == "flatten":
            out = m.flat(args[0], name=node.name)
        elif meth == "relu":
            out = m.relu(args[0], name=node.name)
        else:
            raise NotImplementedError(
                f"torch.fx import: unsupported method .{meth}() at "
                f"{node.name}")
        self.env[node.name] = out

    def output(self, node):
        arg = node.args[0]
        if isinstance(arg, (tuple, list)):
            self.env["__out__"] = [self.env[a.name] for a in arg]
        else:
            self.env["__out__"] = [self.env[arg.name]]


def from_torch(module: nn.Module, input_shapes: Sequence, mesh=None,
               config: Optional[FFConfig] = None, dtype="float32",
               device=None
               ) -> Tuple[FFModel, list, Dict[str, Dict[str, np.ndarray]]]:
    """Trace ``module`` with torch.fx and rebuild it as an FFModel
    (reference :264-286).

    ``input_shapes``: one shape tuple per forward argument, or ``(shape,
    dtype)`` pairs for other inputs than float (``((B,), "int32")`` for
    token ids).  ``mesh`` or ``device`` place the model as ``FFModel``
    does (both None: the CUDA card; the tests pass ``device="cpu"``).

    Returns ``(model, outputs, weights)``: the uncompiled FFModel, its
    output Tensors, and the module's weights keyed like ``model.params``
    (numpy arrays): call ``model.compile(...)`` then
    ``model.load_params(weights)``.
    """
    import torch.fx

    gm = torch.fx.symbolic_trace(module)
    model = FFModel(config or FFConfig(), mesh=mesh, device=device)
    imp = _Importer(gm, model, input_shapes, dtype)
    for node in gm.graph.nodes:
        getattr(imp, node.op)(node)
    return model, imp.env["__out__"], imp.weights
