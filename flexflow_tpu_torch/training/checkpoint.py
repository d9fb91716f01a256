"""Training checkpoint and resume: parameters, optimizer state, generator.

Port of ``flexflow_tpu/training/checkpoint.py``.  Arrays are saved whole
(``model.params`` and ``model.opt_state`` assemble them from the shards'
blocks), named by the reference's key strings (``['fc1']['kernel']``,
``['m']['fc1']['kernel']``, ``['t']``), in ``.npz`` files (no pickle);
restore slices each into the live model's shards (``load_params``,
``load_opt_state``), so a checkpoint written from one mesh layout
restores onto any layout of the same model, and a resumed run trains
bit for bit as the uninterrupted one.

Layout on disk (a directory), each file written to ``<name>.tmp`` then
moved into place (``os.replace``):
  params.npz     {key: array} of the global parameters
  opt_state.npz  {key: array} of the optimizer state (momentum, Adam)
  rng.npy        the model generator's state (``Generator.get_state()``)
  meta.json      the step and the format version
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import numpy as np
import torch

_FORMAT = 1


def _key(path) -> str:
    """The reference's key string of a path of dict keys
    (``jax.tree_util.keystr``)."""
    return "".join(f"[{k!r}]" for k in path)


def _flatten(tree, path=()) -> Dict[str, np.ndarray]:
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flatten(tree[k], path + (k,)))
        return out
    if isinstance(tree, (tuple, list)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flatten(v, path + (i,)))
        return out
    if tree is None:
        return {}
    if isinstance(tree, torch.Tensor):
        return {_key(path): tree.detach().cpu().numpy()}
    return {_key(path): np.asarray(tree)}


def _restore_into(tree, arrays: Dict[str, np.ndarray], path=()):
    """``tree`` with each leaf taken from ``arrays``, checked against the
    live leaf's shape, in its dtype (a tensor for a tensor, a scalar for
    a scalar)."""
    if isinstance(tree, dict):
        return {k: _restore_into(v, arrays, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_restore_into(v, arrays, path + (i,))
                          for i, v in enumerate(tree))
    if tree is None:
        return None
    key = _key(path)
    if key not in arrays:
        raise KeyError(f"checkpoint missing leaf {key}")
    arr = arrays[key]
    shape = tuple(tree.shape) if isinstance(tree, torch.Tensor) else ()
    if tuple(arr.shape) != shape:
        raise ValueError(f"{key}: checkpoint shape {tuple(arr.shape)} != "
                         f"model {shape}")
    if isinstance(tree, torch.Tensor):
        return torch.from_numpy(np.ascontiguousarray(arr)).to(tree.dtype)
    return type(tree)(arr)


def save_checkpoint(path: str, model, step: Optional[int] = None) -> None:
    """Write ``model``'s parameters, optimizer state and generator under
    ``path``."""
    if model.params is None:
        raise RuntimeError("compile() the model before checkpointing")
    os.makedirs(path, exist_ok=True)

    def dump(fname, arrays):
        tmp = os.path.join(path, fname + ".tmp")
        with open(tmp, "wb") as f:
            if fname.endswith(".npz"):
                np.savez(f, **arrays)
            else:
                np.save(f, arrays)
        os.replace(tmp, os.path.join(path, fname))

    dump("params.npz", _flatten(model.params))
    dump("opt_state.npz", _flatten(model.opt_state))
    dump("rng.npy", model._generator.get_state().numpy())
    tmp = os.path.join(path, "meta.json.tmp")
    with open(tmp, "w") as f:
        json.dump({"format": _FORMAT, "step": step}, f)
    os.replace(tmp, os.path.join(path, "meta.json"))


def restore_checkpoint(path: str, model) -> Optional[int]:
    """Restore a checkpoint written by :func:`save_checkpoint` into a
    compiled model of the same architecture, on any mesh; returns the
    saved step."""
    if model.params is None:
        raise RuntimeError("compile() the model before restoring")
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    if meta.get("format") != _FORMAT:
        raise ValueError(f"unknown checkpoint format {meta.get('format')}")

    def load(fname):
        with np.load(os.path.join(path, fname)) as z:
            return {k: z[k] for k in z.files}

    params = _restore_into(model.params, load("params.npz"))
    opt_state = _restore_into(model.opt_state, load("opt_state.npz"))
    model.load_params(params)
    model.load_opt_state(opt_state)
    model._generator.set_state(torch.from_numpy(
        np.load(os.path.join(path, "rng.npy"))))
    return meta.get("step")
