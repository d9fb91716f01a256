"""Keras-style frontend: Sequential, the functional Model and layer
objects over FFModel.

Port of ``flexflow_tpu/frontends/keras.py`` (the reference's
``python/flexflow/keras``, which re-implements the Keras ``Sequential`` and
``Model`` surface on top of ``FFModel`` so that Keras scripts port by
changing an import).  Layers record their config, ``compile`` emits the
corresponding ``FFModel`` graph and compiles it, and ``fit``,
``evaluate`` and ``predict`` go to ``FFModel``'s own loop; the optimizer
strings ``"sgd"`` and ``"adam"`` map to the port's ``SGDOptimizer`` and
``AdamOptimizer``.  The callbacks (``History``, ``EarlyStopping``,
``ModelCheckpoint`` through ``training/checkpoint.py``) run per epoch.
``Sequential(..., device=...)`` and ``Model(..., device=...)`` place the
model as ``FFModel`` does (None: the CUDA card; the tests pass
``"cpu"``).  Data is channels-first (NCHW) for the conv layers, as the
reference's.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from ..config import FFConfig
from ..model import FFModel
from ..training.checkpoint import save_checkpoint
from ..training.optimizer import AdamOptimizer, SGDOptimizer


class KTensor:
    """Symbolic tensor for the functional API: records (layer, inputs)."""

    def __init__(self, layer, inputs):
        self.layer = layer
        self.inputs = tuple(inputs)


class Layer:
    def __call__(self, *args):
        # two calling conventions share one class hierarchy:
        #   layer(model, x)     -> concrete build (Sequential internals)
        #   layer(sym_tensor)   -> symbolic application (functional Model)
        if len(args) == 2 and isinstance(args[0], FFModel):
            return self.apply(*args)
        if len(args) == 1:
            a = args[0]
            ins = tuple(a) if isinstance(a, (list, tuple)) else (a,)
            return KTensor(self, ins)
        raise TypeError(
            f"{type(self).__name__} expects (model, x) or (symbolic_tensor)"
        )

    def apply(self, model: FFModel, *xs):
        raise NotImplementedError


class Input(Layer):
    def __init__(self, shape: Sequence[int], dtype="float32"):
        self.shape = tuple(shape)
        self.dtype = dtype


class Dense(Layer):
    def __init__(self, units: int, activation: Optional[str] = None,
                 use_bias: bool = True, input_shape=None, name=None):
        self.units = int(units)
        self.activation = activation
        self.use_bias = use_bias
        self.input_shape = tuple(input_shape) if input_shape else None
        self.name = name

    def apply(self, model, x):
        act = None if self.activation in (None, "softmax") else self.activation
        out = model.dense(x, self.units, activation=act,
                          use_bias=self.use_bias, name=self.name)
        if self.activation == "softmax":
            out = model.softmax(out)
        return out


class Activation(Layer):
    def __init__(self, fn: str):
        self.fn = fn

    def apply(self, model, x):
        if self.fn == "softmax":
            return model.softmax(x)
        return getattr(model, self.fn)(x)


class Dropout(Layer):
    def __init__(self, rate: float):
        self.rate = float(rate)

    def apply(self, model, x):
        return model.dropout(x, self.rate)


class Flatten(Layer):
    def apply(self, model, x):
        return model.flat(x)


class Embedding(Layer):
    def __init__(self, input_dim: int, output_dim: int, input_shape=None):
        self.input_dim = int(input_dim)
        self.output_dim = int(output_dim)
        self.input_shape = tuple(input_shape) if input_shape else None
        self.dtype = "int32"

    def apply(self, model, x):
        return model.embedding(x, self.input_dim, self.output_dim)


class LayerNormalization(Layer):
    def __init__(self, epsilon: float = 1e-5):
        self.epsilon = float(epsilon)

    def apply(self, model, x):
        return model.layer_norm(x, eps=self.epsilon)


class Conv2D(Layer):
    """2-D convolution (reference keras frontend's Conv2D).

    Deviation: data is channels_first (NCHW) — the repo's conv ops use the
    TPU-preferred layout; pass inputs accordingly.
    """

    def __init__(self, filters: int, kernel_size, strides=(1, 1),
                 padding: str = "valid", activation: Optional[str] = None,
                 use_bias: bool = True, input_shape=None, name=None):
        self.filters = int(filters)
        k = kernel_size
        self.kernel = (k, k) if isinstance(k, int) else tuple(k)
        s = strides
        self.strides = (s, s) if isinstance(s, int) else tuple(s)
        self.padding = padding.upper()
        self.activation = activation
        self.use_bias = use_bias
        self.input_shape = tuple(input_shape) if input_shape else None
        self.name = name

    def apply(self, model, x):
        act = None if self.activation in (None, "softmax") else self.activation
        out = model.conv2d(x, self.filters, kernel=self.kernel,
                           stride=self.strides, padding=self.padding,
                           activation=act, use_bias=self.use_bias,
                           name=self.name)
        if self.activation == "softmax":
            out = model.softmax(out)
        return out


class MaxPooling2D(Layer):
    def __init__(self, pool_size=(2, 2), strides=None, padding="valid"):
        p = pool_size
        self.pool = (p, p) if isinstance(p, int) else tuple(p)
        s = strides if strides is not None else self.pool
        self.strides = (s, s) if isinstance(s, int) else tuple(s)
        self.padding = padding.upper()

    def apply(self, model, x):
        return model.pool2d(x, kernel=self.pool, stride=self.strides,
                            padding=self.padding, pool_type="max")


class AveragePooling2D(MaxPooling2D):
    def apply(self, model, x):
        return model.pool2d(x, kernel=self.pool, stride=self.strides,
                            padding=self.padding, pool_type="avg")


_OPTIMIZERS = {
    "sgd": lambda: SGDOptimizer(lr=0.01),
    "adam": lambda: AdamOptimizer(),
}

_LOSSES = {
    "sparse_categorical_crossentropy": "sparse_categorical_crossentropy",
    "categorical_crossentropy": "categorical_crossentropy",
    "mean_squared_error": "mean_squared_error",
    "mse": "mean_squared_error",
}


class Sequential:
    """``keras.Sequential`` work-alike over FFModel."""

    def __init__(self, layers: Optional[List[Layer]] = None,
                 config: Optional[FFConfig] = None, mesh=None, device=None):
        self.layers: List[Layer] = []
        self.config = config
        self.mesh = mesh
        self.device = device
        self.model: Optional[FFModel] = None
        for l in layers or []:
            self.add(l)

    def add(self, layer: Layer):
        if self.model is not None:
            raise RuntimeError("cannot add layers after compile()")
        self.layers.append(layer)

    def _build(self, batch_size: int):
        layers = list(self.layers)
        if layers and isinstance(layers[0], Input):
            inp = layers.pop(0)
            shape, dtype = inp.shape, inp.dtype
        else:
            first = layers[0]
            shape = getattr(first, "input_shape", None)
            if shape is None:
                raise ValueError(
                    "give the first layer an input_shape= (or start with "
                    "Input(shape))"
                )
            dtype = getattr(first, "dtype", "float32")
        model = FFModel(self.config or FFConfig(batch_size=batch_size),
                        mesh=self.mesh, device=self.device)
        x = model.create_tensor((batch_size,) + tuple(shape), dtype)
        for l in layers:
            x = l(model, x)
        return model, x

    def compile(self, optimizer="sgd", loss="sparse_categorical_crossentropy",
                metrics: Sequence[str] = (), batch_size: int = 32):
        if isinstance(optimizer, str):
            try:
                optimizer = _OPTIMIZERS[optimizer.lower()]()
            except KeyError:
                raise ValueError(f"unknown optimizer {optimizer!r}")
        if loss not in _LOSSES:
            raise ValueError(f"unknown loss {loss!r}")
        self.model, out = self._build(batch_size)
        self.model.compile(optimizer=optimizer, loss_type=_LOSSES[loss],
                           metrics=list(metrics), outputs=[out])
        return self

    # -- training API ----------------------------------------------------
    def fit(self, x, y, epochs: int = 1, batch_size: Optional[int] = None,
            verbose: bool = True, shuffle: bool = True, callbacks=None):
        _require_compiled(self.model)
        if callbacks:
            return _fit_with_callbacks(self.model, x, y, epochs, batch_size,
                                       verbose, shuffle, callbacks)
        return self.model.fit(x, y, epochs=epochs, batch_size=batch_size,
                              verbose=verbose, shuffle=shuffle)

    def evaluate(self, x, y, batch_size: Optional[int] = None):
        _require_compiled(self.model)
        return self.model.evaluate(x, y, batch_size=batch_size)

    def predict(self, x):
        _require_compiled(self.model)
        return _predict(self.model, x)


class Add(Layer):
    """Elementwise sum (functional-API merge layer): ``Add()([a, b])``."""

    def apply(self, model, a, b):
        return model.add(a, b)


class Multiply(Layer):
    def apply(self, model, a, b):
        return model.multiply(a, b)


class Concatenate(Layer):
    def __init__(self, axis: int = -1):
        self.axis = axis

    def apply(self, model, *xs):
        return model.concat(list(xs), axis=self.axis)


def _require_compiled(model) -> None:
    if model is None:
        raise RuntimeError("call compile() first")


def _predict(model: FFModel, x) -> np.ndarray:
    """The forward's first output on host arrays ``x``, as numpy."""
    out = model.forward(x)
    out = out[0] if isinstance(out, list) else out
    return out.detach().cpu().numpy()


# ---------------------------------------------------------------------------
# callbacks (reference: python/flexflow/keras/callbacks.py)
# ---------------------------------------------------------------------------
class Callback:
    def on_train_begin(self, logs=None):
        pass

    def on_epoch_end(self, epoch: int, logs=None):
        pass

    def on_train_end(self, logs=None):
        pass


class History(Callback):
    """Collects per-epoch logs; always appended automatically by fit()."""

    def __init__(self):
        self.history: List[dict] = []

    def on_epoch_end(self, epoch, logs=None):
        self.history.append(dict(logs or {}))


class EarlyStopping(Callback):
    def __init__(self, monitor: str = "loss", min_delta: float = 0.0,
                 patience: int = 0):
        self.monitor = monitor
        self.min_delta = float(min_delta)
        self.patience = int(patience)
        self.best = float("inf")
        self.wait = 0
        self.stop_training = False

    def on_train_begin(self, logs=None):
        self.best, self.wait, self.stop_training = float("inf"), 0, False

    def on_epoch_end(self, epoch, logs=None):
        cur = float((logs or {}).get(self.monitor, float("inf")))
        if cur < self.best - self.min_delta:
            self.best, self.wait = cur, 0
        else:
            self.wait += 1
            if self.wait > self.patience:
                self.stop_training = True


class ModelCheckpoint(Callback):
    """Saves FFModel checkpoints per epoch (``training/checkpoint.py``'s
    format: a directory at ``filepath.format(epoch=...)``, which
    ``restore_checkpoint`` reads back)."""

    def __init__(self, filepath: str, monitor: str = "loss",
                 save_best_only: bool = False):
        self.filepath = filepath
        self.monitor = monitor
        self.save_best_only = save_best_only
        self.best = float("inf")
        self._model = None  # bound by fit()

    def on_epoch_end(self, epoch, logs=None):
        cur = float((logs or {}).get(self.monitor, float("inf")))
        if self.save_best_only and cur >= self.best:
            return
        self.best = min(self.best, cur)
        save_checkpoint(self.filepath.format(epoch=epoch), self._model)


def _fit_with_callbacks(model: FFModel, x, y, epochs, batch_size, verbose,
                        shuffle, callbacks):
    """Per-epoch fit loop invoking Keras-style callbacks."""
    history = History()
    cbs = list(callbacks or []) + [history]
    for cb in cbs:
        if isinstance(cb, ModelCheckpoint):
            cb._model = model
        cb.on_train_begin()
    for epoch in range(epochs):
        logs = model.fit(x, y, epochs=1, batch_size=batch_size,
                         verbose=verbose, shuffle=shuffle)[-1]
        for cb in cbs:
            cb.on_epoch_end(epoch, logs)
        if any(getattr(cb, "stop_training", False) for cb in cbs):
            break
    for cb in cbs:
        cb.on_train_end()
    return history.history


# ---------------------------------------------------------------------------
# functional Model (reference: python/flexflow/keras functional API)
# ---------------------------------------------------------------------------
class Model:
    """``keras.Model(inputs, outputs)`` work-alike: layers applied to
    symbolic tensors (``Dense(4)(x)``, ``Add()([a, b])``) record a DAG that
    compile() replays onto an FFModel — skip connections and multi-input
    topologies included."""

    def __init__(self, inputs, outputs, config: Optional[FFConfig] = None,
                 mesh=None, device=None):
        self.inputs = list(inputs) if isinstance(inputs, (list, tuple)) \
            else [inputs]
        self.outputs = list(outputs) if isinstance(outputs, (list, tuple)) \
            else [outputs]
        if not all(isinstance(i, Input) for i in self.inputs):
            raise TypeError("Model inputs must be Input(...) instances")
        self.config = config
        self.mesh = mesh
        self.device = device
        self.model: Optional[FFModel] = None

    def _build(self, batch_size: int):
        model = FFModel(self.config or FFConfig(batch_size=batch_size),
                        mesh=self.mesh, device=self.device)
        resolved = {}
        for inp in self.inputs:
            resolved[id(inp)] = model.create_tensor(
                (batch_size,) + tuple(inp.shape), inp.dtype)

        def resolve(t):
            if id(t) in resolved:
                return resolved[id(t)]
            if isinstance(t, Input):
                raise ValueError("Input used but not listed in Model inputs")
            if not isinstance(t, KTensor):
                raise TypeError(f"not a symbolic tensor: {t!r}")
            out = t.layer.apply(model, *[resolve(i) for i in t.inputs])
            resolved[id(t)] = out
            return out

        outs = [resolve(o) for o in self.outputs]
        return model, outs

    def compile(self, optimizer="sgd", loss="sparse_categorical_crossentropy",
                metrics: Sequence[str] = (), batch_size: int = 32,
                loss_weights=None):
        """``loss`` may be a single name (applied to the sole output) or a
        list of names, one per Model output — fit()/evaluate() then take
        ``y`` as a matching list of label arrays and the training loss is
        the ``loss_weights``-ed sum (reference Keras frontend's multi-output
        losses)."""
        if isinstance(optimizer, str):
            try:
                optimizer = _OPTIMIZERS[optimizer.lower()]()
            except KeyError:
                raise ValueError(f"unknown optimizer {optimizer!r}")
        multi = isinstance(loss, (list, tuple))
        losses = list(loss) if multi else [loss]
        for l in losses:
            if l not in _LOSSES:
                raise ValueError(f"unknown loss {l!r}")
        if len(losses) != len(self.outputs):
            raise ValueError(
                f"{len(losses)} losses for {len(self.outputs)} outputs — "
                "pass one loss per Model output (a single loss name is only "
                "valid for a single-output Model)"
            )
        self.model, outs = self._build(batch_size)
        self.model.compile(
            optimizer=optimizer,
            loss_type=[_LOSSES[l] for l in losses] if multi
            else _LOSSES[losses[0]],
            metrics=list(metrics), outputs=outs,
            loss_weights=loss_weights,
        )
        return self

    def fit(self, x, y, epochs: int = 1, batch_size: Optional[int] = None,
            verbose: bool = True, shuffle: bool = True, callbacks=None):
        _require_compiled(self.model)
        return _fit_with_callbacks(self.model, x, y, epochs, batch_size,
                                   verbose, shuffle, callbacks)

    def evaluate(self, x, y, batch_size: Optional[int] = None):
        _require_compiled(self.model)
        return self.model.evaluate(x, y, batch_size=batch_size)

    def predict(self, x):
        _require_compiled(self.model)
        return _predict(self.model, x)
