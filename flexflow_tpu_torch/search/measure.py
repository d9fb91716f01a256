"""The planner's measurements on the CUDA card: machine constants and op costs.

Port of ``flexflow_tpu/search/measure.py``.  Everything is timed with
CUDA events on the card (never on the CPU: every probe raises without
CUDA).  The machine constants (``calibrate_machine_constants``,
reference :242), written to ``artifacts/h100_calib.json`` and read by
``MachineModel.with_calibration``:

* ``mxu_efficiency`` — the achieved share of the bf16 tensor-core peak
  of a large GEMM, ``[256, 4096] @ [4096, 4096]`` (the reference's probe
  shape), against the spec's ``peak_flops_bf16``;
* ``step_overhead`` — the floor of one trivial step: the time a launch
  of a trivial kernel costs when the host issues them back to back (the
  eager counterpart of the reference's trivial scan body);
* ``train_step_factor`` — a whole training step over its forward alone,
  the reference's MLP (784-512-512-10, batch 64, float32): forward and
  loss against forward, backward and an SGD update (reference :287-310),
  each as device time (:func:`time_fn`);
* ``host_bandwidth`` and ``host_latency`` — the rate of large pinned
  device-to-host copies and what a small one takes beyond its bytes at
  that rate (the link a KV page spill rides,
  ``serve/kv_paged.py:HostPageTier``).

Not measured here: ``spec_break_even_acceptance`` (it needs a draft
whose acceptance is known), ``overlap`` and the NVLink constants (two
cards); the JSON says so and the ``h100`` entry keeps its data sheet or
placeholder values.

The measured op-cost cache (reference :26-185): :class:`CostCache` maps
an op's ``attr_signature`` and its local input shapes (the key
``search/simulator.py:_measure_key`` looks up) to seconds, kept as JSON;
:func:`measure_operator_cost` times one op's ``forward`` on the card
from numpy-seeded inputs and weights, and
:func:`calibrate_standard_probes` measures the reference's probe list.
A cache's default file is the port's own, ``artifacts/h100_costs.json``,
never the JAX package's: a TPU measurement must not price the card.

    python scripts/calibrate_h100.py [artifacts/h100_calib.json]
"""

from __future__ import annotations

import json
import os
import subprocess
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

GEMM_SHAPE = (256, 4096, 4096)          # rows, in, out (reference :282)
COPY_MIB = (1, 16, 64, 256)             # pinned D2H copy sizes
TRAIN_PROBE = (784, 512, 10, 64)        # in, hidden, classes, batch (:288)
# the port's op-cost file: the card's standard probes
DEFAULT_CACHE = os.path.normpath(os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "..", "..", "artifacts",
    "h100_costs.json"))


def _card(device) -> torch.device:
    dev = torch.device(device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError("the machine constants are measured on a CUDA "
                           "device; this machine has none")
    return dev


def event_ms(fn, iters: int, warmup: int = 3) -> float:
    """Milliseconds per ``fn()`` call run back to back: CUDA events around
    ``iters`` calls, after ``warmup`` more and an idle device.  Where the
    host takes longer to issue a call than the device to run it, this is
    the host's time (:func:`time_fn` is the device's alone)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _key_str(key) -> str:
    return repr(key)


class CostCache:
    """``{(op signature, local input shapes): seconds}`` kept as JSON
    (reference :33): the ``measured`` mapping ``simulate`` and the search
    read, keyed by ``repr`` of the key, so a file serves both packages.
    ``path`` defaults to ``artifacts/h100_costs.json``."""

    def __init__(self, path: Optional[str] = None):
        self.path = path or DEFAULT_CACHE
        self.data: Dict[str, float] = {}
        if os.path.exists(self.path):
            try:
                with open(self.path) as f:
                    self.data = dict(json.load(f))
            except (json.JSONDecodeError, OSError):
                self.data = {}

    def get(self, key, default=None):
        return self.data.get(_key_str(key), default)

    def __contains__(self, key) -> bool:
        return _key_str(key) in self.data

    def __getitem__(self, key):
        return self.data[_key_str(key)]

    def put(self, key, seconds: float):
        self.data[_key_str(key)] = seconds

    def save(self):
        os.makedirs(os.path.dirname(os.path.abspath(self.path)),
                    exist_ok=True)
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.data, f, indent=1)
        os.replace(tmp, self.path)


_SLEEP_CYCLES_PER_MS: List[float] = []


def time_fn(fn, args=(), iters: int = 10, repeats: int = 3) -> float:
    """Device seconds per call of ``fn(*args)`` (reference :65): ``iters``
    calls between CUDA events, queued behind a sleep kernel that holds the
    stream until the host has issued them all, so the events see the
    device run them back to back whatever the host's issue time (the
    reference chains its calls on the device for the same reason); the
    fastest of ``repeats`` timings, after a warm-up call.  A timing counts
    only if the sleep, as the device measured it, outlasted the host's
    issue of every call; otherwise the sleep's length is corrected from
    that measurement and fewer calls are queued (a call of many kernels
    can fill the launch queue behind the sleep).  The arguments must be
    CUDA tensors."""
    def call():
        return fn(*args)

    call()
    torch.cuda.synchronize()
    if not _SLEEP_CYCLES_PER_MS:
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda._sleep(1000)
        s.record()
        torch.cuda._sleep(10 ** 7)
        e.record()
        torch.cuda.synchronize()
        _SLEEP_CYCLES_PER_MS.append(1e7 / s.elapsed_time(e))
    hold = 2 * event_ms(call, iters, warmup=0) * iters + 2   # ms
    best = float("inf")
    pre, start, end = (torch.cuda.Event(enable_timing=True)
                       for _ in range(3))
    done, misses = 0, 0
    while done < repeats:
        cycles = int(hold * _SLEEP_CYCLES_PER_MS[0])
        t0 = time.perf_counter()
        pre.record()
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(iters):
            call()
        end.record()
        issued = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        slept = pre.elapsed_time(start)
        if slept <= issued:
            # the device ran calls before the host had issued them all
            misses += 1
            if misses > 8:
                raise RuntimeError(f"time_fn: the host took {issued:.1f} ms "
                                   f"to issue {iters} calls behind a "
                                   f"{slept:.1f} ms sleep")
            _SLEEP_CYCLES_PER_MS[0] = cycles / max(slept, 1e-3)
            iters = max(1, iters // 2)
            hold = 2 * event_ms(call, iters, warmup=0) * iters + 2
            continue
        best = min(best, start.elapsed_time(end) / iters)
        done += 1
    return best / 1e3


def _seeded(rng: np.random.RandomState, shape, dtype, dev) -> torch.Tensor:
    """A numpy draw on ``dev``: ids in {0, 1} for an integer dtype (the
    reference's), standard normal values otherwise."""
    if dtype.is_floating_point:
        arr = rng.randn(*shape).astype(np.float32)
    else:
        arr = rng.randint(0, 2, size=shape)
    return torch.as_tensor(arr).to(device=dev, dtype=dtype)


def _probe(op, local_in_specs, dev) -> Tuple[object, list]:
    """``(fn, args)``: ``fn(*args)`` runs ``op``'s ``forward`` on ``dev``
    with inputs and weights drawn from ``numpy.random.RandomState(0)``
    (inputs first, then ``op.params()`` in order).  The weights go in
    through ``torch.func.functional_call``, so ``op`` keeps its own (a
    graph's node is priced without touching its trained weights)."""
    from ..core.op import OpContext

    rng = np.random.RandomState(0)
    args = [_seeded(rng, s.shape, s.dtype, dev) for s in local_in_specs]
    weights = {p.name: _seeded(rng, p.spec.shape, p.spec.dtype, dev)
               for p in op.params()}
    kwargs = {"ctx": OpContext(training=False)} if op.uses_context else {}

    def fn(*xs):
        return torch.func.functional_call(op, weights, xs, kwargs)
    return fn, args


def measure_operator_cost(op, local_in_specs, cache: Optional[CostCache] =
                          None, iters: int = 10, device="cuda") -> float:
    """Seconds of one op's ``forward`` on its local shapes, on the card
    (reference :148): seeded inputs and weights (:func:`_probe`; ``op``
    itself is not changed), timed by :func:`time_fn`.  A cache hit
    returns the cached time; a measurement is put in ``cache``."""
    key = (op.attr_signature(), tuple(tuple(s.shape) for s in local_in_specs))
    if cache is not None:
        hit = cache.get(key)
        if hit is not None:
            return hit
    fn, args = _probe(op, local_in_specs, _card(device))
    with torch.no_grad():
        t = time_fn(fn, args, iters=iters)
    if cache is not None:
        cache.put(key, t)
    return t


def standard_probes() -> List[Tuple[str, object, list]]:
    """The reference's probe list (reference :186-239): ``(label, op,
    local input specs)`` for Linear (f32 and bf16), LayerNorm, RMSNorm,
    the training attention, softmax and embedding, each op built on
    ``meta``."""
    from ..core.graph import TensorSpec
    from ..ops.attention import MultiHeadAttention
    from ..ops.embedding import Embedding
    from ..ops.linear import Linear
    from ..ops.norm import LayerNorm, RMSNorm
    from ..ops.reduction import Softmax

    out = []
    for b, i, o in [(64, 512, 512), (64, 512, 2048), (256, 1024, 1024),
                    (512, 4096, 4096), (1024, 4096, 11008)]:
        for dt in (torch.float32, torch.bfloat16):
            op = Linear(i, o, dt, device="meta", use_bias=True)
            out.append((f"linear[{str(dt)[6:]}] b={b} in={i} out={o}", op,
                        [TensorSpec((b, i), dt)]))
    for b, d in [(64, 512), (256, 4096), (1024, 4096)]:
        for op in (LayerNorm(d, device="meta"), RMSNorm(d, device="meta")):
            out.append((f"{op.type_name} b={b} d={d}", op,
                        [TensorSpec((b, d))]))
    for b, s, d, h in [(8, 64, 256, 8), (8, 256, 1024, 16),
                       (1, 1024, 4096, 32)]:
        spec = TensorSpec((b, s, d))
        out.append((f"attention b={b} s={s} d={d} h={h}",
                    MultiHeadAttention(d, h, device="meta"), [spec] * 3))
    for b, v in [(64, 512), (256, 16), (64, 32000)]:
        out.append((f"softmax b={b} v={v}", Softmax(),
                    [TensorSpec((b, v))]))
    for b, v, d in [(64, 1024, 512), (512, 32000, 4096)]:
        out.append((f"embedding b={b} v={v} d={d}",
                    Embedding(v, d, device="meta"),
                    [TensorSpec((b,), torch.int32)]))
    return out


def calibrate_standard_probes(cache_path: Optional[str] = None,
                              device="cuda") -> CostCache:
    """Measure :func:`standard_probes` on the card into the cache at
    ``cache_path`` (default ``artifacts/h100_costs.json``) and save it; the
    reference's :186.  Prints each probe's microseconds (and a linear's
    TFLOP/s)."""
    cache = CostCache(cache_path)
    for label, op, specs in standard_probes():
        t = measure_operator_cost(op, specs, cache, device=device)
        line = f"{label}: {t * 1e6:.1f}us"
        if op.type_name == "linear":
            (b, i), o = specs[0].shape, op.out_dim
            line += f" ({2 * b * i * o / t / 1e12:.2f} TFLOP/s)"
        print(line, flush=True)
    cache.save()
    print(f"saved {len(cache.data)} measurements to {cache.path}")
    return cache


def probe_train_step_factor(device="cuda") -> Tuple[float, Dict]:
    """(whole training step / forward, the two times) of the reference's
    MLP probe (reference :287-310): 784-512-512-10 in float32 at batch 64,
    relu, log-softmax cross-entropy; the forward and loss against forward,
    backward and an SGD update (``p -= 0.01 * grad``), each device time
    (:func:`time_fn`)."""
    dev = _card(device)
    d0, d1, classes, b = TRAIN_PROBE
    rng = np.random.RandomState(0)
    params = [torch.tensor(rng.randn(d0, d1) * 0.05, dtype=torch.float32,
                           device=dev, requires_grad=True),
              torch.tensor(rng.randn(d1, d1) * 0.05, dtype=torch.float32,
                           device=dev, requires_grad=True),
              torch.tensor(rng.randn(d1, classes) * 0.05,
                           dtype=torch.float32, device=dev,
                           requires_grad=True)]
    x = torch.tensor(rng.randn(b, d0), dtype=torch.float32, device=dev)
    y = torch.tensor(rng.randint(0, classes, size=b), device=dev)

    def loss():
        h = torch.relu(x @ params[0])
        h = torch.relu(h @ params[1])
        lg = torch.log_softmax(h @ params[2], dim=-1)
        return -lg.gather(1, y[:, None]).mean()

    def fwd():
        with torch.no_grad():
            return loss()

    def train():
        grads = torch.autograd.grad(loss(), params)
        with torch.no_grad():
            for p, g in zip(params, grads):
                p.sub_(0.01 * g)

    t_f = time_fn(fwd, iters=50)
    t_t = time_fn(train, iters=50)
    return max(1.0, t_t / t_f), {"forward_s": t_f, "train_step_s": t_t}


def probe_mxu_efficiency(device="cuda", peak: float = 989e12,
                         iters: int = 50, repeats: int = 3
                         ) -> Tuple[float, float]:
    """(achieved share of ``peak``, GEMM ms) of the bf16 probe GEMM: the
    fastest of ``repeats`` timings of ``iters`` back-to-back calls."""
    dev = _card(device)
    m, k, n = GEMM_SHAPE
    g = torch.Generator(device=dev).manual_seed(0)
    a = torch.randn(m, k, device=dev, dtype=torch.bfloat16, generator=g)
    w = torch.randn(k, n, device=dev, dtype=torch.bfloat16, generator=g)
    out = torch.empty(m, n, device=dev, dtype=torch.bfloat16)
    ms = min(event_ms(lambda: torch.matmul(a, w, out=out), iters)
             for _ in range(repeats))
    return min(1.0, 2 * m * k * n / (ms / 1e3) / peak), ms


def probe_step_overhead(device="cuda", iters: int = 2000,
                        repeats: int = 3) -> float:
    """Seconds a trivial step costs at least: back-to-back launches of one
    in-place scale of a ``[8, 128]`` float32 tensor, host-issued (the
    fastest of ``repeats`` timings: the host's issue rate varies)."""
    dev = _card(device)
    x = torch.ones(8, 128, device=dev)
    return min(event_ms(lambda: x.mul_(1.0000001), iters, warmup=50)
               for _ in range(repeats)) / 1e3


def probe_host_link(device="cuda", sizes_mib: Sequence[int] = COPY_MIB,
                    iters: int = 4, repeats: int = 5
                    ) -> Tuple[float, float, List[Dict]]:
    """(bytes/s, seconds, points) of pinned device-to-host copies: each
    size's copy time is the fastest of ``repeats`` timings of ``iters``
    back-to-back copies; the rate is the slope between the two largest
    sizes, the latency what the smallest copy takes beyond its bytes at
    that rate (at least 0)."""
    dev = _card(device)
    points = []
    for mib in sizes_mib:
        n = mib << 20
        src = torch.empty(n, dtype=torch.uint8, device=dev).fill_(1)
        dst = torch.empty(n, dtype=torch.uint8, pin_memory=True)
        ms = min(event_ms(lambda: dst.copy_(src, non_blocking=True), iters,
                          warmup=1) for _ in range(repeats))
        points.append({"bytes": n, "ms": ms})
        del src, dst
    (b0, t0), (b1, t1) = [(p["bytes"], p["ms"] / 1e3) for p in points[-2:]]
    bandwidth = (b1 - b0) / (t1 - t0)
    small = points[0]
    latency = max(small["ms"] / 1e3 - small["bytes"] / bandwidth, 0.0)
    return bandwidth, latency, points


def card_name() -> str:
    """``nvidia-smi``'s name and power limit of the card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def calibrate_machine_constants(path: Optional[str] = None,
                                spec_name: str = "h100",
                                device="cuda") -> Dict:
    """Measure the planner's constants on the card and write them to
    ``path`` (read by ``MachineModel.with_calibration``); returns the
    document, which names the card and its power limit."""
    from .machine_model import TPU_SPECS

    spec = TPU_SPECS[spec_name]
    dev = _card(device)
    eff, gemm_ms = probe_mxu_efficiency(dev, spec.peak_flops_bf16)
    bw, lat, points = probe_host_link(dev)
    factor, train_times = probe_train_step_factor(dev)
    out: Dict = {
        "device": spec_name,
        "card": card_name(),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "mxu_efficiency": eff,
        "step_overhead": probe_step_overhead(dev),
        "train_step_factor": factor,
        "host_bandwidth": bw,
        "host_latency": lat,
        "probes": {
            "gemm": {"shape": list(GEMM_SHAPE), "dtype": "bfloat16",
                     "ms": gemm_ms},
            "step": "in-place scale of a [8, 128] float32 tensor, the "
                    "fastest of 3 timings of 2000 launches back to back",
            "host_copies": points,
            "train_step": {"mlp": list(TRAIN_PROBE[:3]), "batch":
                           TRAIN_PROBE[3], "dtype": "float32",
                           "update": "sgd 0.01", **train_times},
        },
        "not_measured": {
            "spec_break_even_acceptance": "needs a draft of known "
                                          "acceptance; the spec keeps its "
                                          "placeholder",
            "overlap": "needs two cards; the spec keeps its placeholder",
            "ici_bandwidth": "needs two cards; the spec keeps the data "
                             "sheet",
            "ici_latency": "needs two cards; the spec keeps its "
                           "placeholder",
        },
    }
    if path:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(out, f, indent=1)
            f.write("\n")
        os.replace(tmp, path)
    return out
