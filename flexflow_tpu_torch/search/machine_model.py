"""Machine model: compute roofline + link costs, for the serve planner.

A copy of ``flexflow_tpu/search/machine_model.py`` (``TPUSpec`` :18,
``TPU_SPECS`` :56, ``MachineModel`` :96), which imports no JAX, with one
entry added: ``"h100"``, one NVIDIA H100 SXM.  The class and field names
are the reference's, so a calibration JSON (``with_calibration``) and a
:class:`~flexflow_tpu_torch.obs.calibration.CalibrationStore`'s component
names (``with_store``) mean the same constant in both packages; the
TPU-flavoured names map onto the card as :data:`H100_SOURCES` says
(``mxu_efficiency`` is the tensor cores' achieved share of peak, ``ici_*``
NVLink, ``dcn_*`` InfiniBand, ``host_*`` the PCIe link).

``MachineModel.for_mesh`` reads the port's :class:`~flexflow_tpu_torch.
parallel.mesh.Mesh`: CUDA devices price as ``h100``, the CPU as the
reference's ``cpu`` test spec; any other device type raises.  The card's
measured constants live in ``artifacts/h100_calib.json``
(``search/measure.py``), loaded with :meth:`MachineModel.with_calibration`.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional


@dataclasses.dataclass
class TPUSpec:
    name: str
    peak_flops_bf16: float      # FLOP/s per chip
    peak_flops_f32: float
    hbm_bandwidth: float        # bytes/s
    ici_bandwidth: float        # bytes/s per link direction
    ici_latency: float          # seconds per hop
    dcn_bandwidth: float        # bytes/s per host
    dcn_latency: float
    kernel_overhead: float = 2e-6   # per-op overhead (legacy per-op roofline)
    hbm_capacity: float = 16e9      # bytes per chip (memory-aware search)
    # fused-program constants — spec-sheet defaults, overridden by measured
    # values via ``MachineModel.with_calibration``:
    mxu_efficiency: float = 0.5     # achievable fraction of peak on real GEMMs
    vmem_resident_bytes: float = 6.4e7  # weights below this stay VMEM-resident
    step_overhead: float = 3e-6     # per compiled-step dispatch/loop overhead
    train_step_factor: float = 3.0  # whole train step time / forward time
    overlap: float = 0.3            # comm fraction hidden behind compute
    # host-tier KV swap (serve/kv_paged.py): device<->host-DRAM link the
    # spill/restore transfers ride; calibratable like every constant.
    host_bandwidth: float = 12.5e9  # bytes/s, device<->host
    host_latency: float = 20e-6     # per-transfer setup
    # speculative serving: the draft-token acceptance rate at which one
    # speculative macro-step (depth draft levels + one tree-verify pass)
    # costs the same PER TOKEN as incremental decoding — macro_cost =
    # tpot * (1 + break_even * depth) by definition, so the serve search
    # prices a spec plan as tpot * (1 + be*d) / (1 + a*d) for live
    # acceptance a (search/serve_search.py).  The default is the JAX
    # package's TPU measurement; the h100 entry sets its own.
    spec_break_even_acceptance: float = 0.439


TPU_SPECS: Dict[str, TPUSpec] = {
    # public spec-sheet numbers (approximate; calibrate on real hardware)
    "v5e": TPUSpec(
        name="v5e",
        peak_flops_bf16=197e12,
        peak_flops_f32=98.5e12,
        hbm_bandwidth=819e9,
        ici_bandwidth=0.2e12,      # 1.6 Tbps total / 8 ≈ per-direction-link bytes
        ici_latency=1e-6,
        dcn_bandwidth=25e9,
        dcn_latency=10e-6,
        hbm_capacity=16e9,
    ),
    "v5p": TPUSpec(
        name="v5p",
        peak_flops_bf16=459e12,
        peak_flops_f32=229.5e12,
        hbm_bandwidth=2765e9,
        ici_bandwidth=0.6e12,
        ici_latency=1e-6,
        dcn_bandwidth=25e9,
        dcn_latency=10e-6,
        hbm_capacity=95e9,
    ),
    # virtual CPU mesh for hermetic tests: only relative costs matter
    "cpu": TPUSpec(
        name="cpu",
        peak_flops_bf16=200e9,
        peak_flops_f32=100e9,
        hbm_bandwidth=20e9,
        ici_bandwidth=5e9,
        ici_latency=5e-6,
        dcn_bandwidth=1e9,
        dcn_latency=50e-6,
        hbm_capacity=8e9,   # virtual-device test budget
    ),
    # one NVIDIA H100 SXM 80GB (NVIDIA's data sheet; dense rates at the
    # 700 W limit).  Every field is set here, none left at a TPU default;
    # H100_SOURCES says where each comes from.  The placeholders are
    # replaced by artifacts/h100_calib.json (with_calibration) where the
    # card measured them.
    "h100": TPUSpec(
        name="h100",
        peak_flops_bf16=989e12,
        peak_flops_f32=67e12,      # CUDA cores: the f32 paths run TF32 off
        hbm_bandwidth=3.35e12,
        ici_bandwidth=450e9,       # NVLink 4: 900 GB/s both ways
        ici_latency=2e-6,          # placeholder, awaiting a two-card run
        dcn_bandwidth=50e9,        # InfiniBand NDR: 400 Gb/s a port
        dcn_latency=5e-6,          # placeholder, awaiting a two-host run
        kernel_overhead=5e-6,      # placeholder (the legacy per-op mode)
        hbm_capacity=80e9,
        mxu_efficiency=0.7,        # placeholder; measured: h100_calib.json
        vmem_resident_bytes=50e6,  # the 50 MB L2 in the VMEM's place
        step_overhead=20e-6,       # placeholder; measured: h100_calib.json
        train_step_factor=3.0,     # placeholder; measured: h100_calib.json
        overlap=0.0,               # placeholder (none), awaiting two cards
        host_bandwidth=64e9,       # PCIe Gen5 x16, one direction;
                                   # measured: h100_calib.json
        host_latency=10e-6,        # placeholder; measured: h100_calib.json
        spec_break_even_acceptance=0.5,  # placeholder, not yet measured
    ),
}

# where each ``h100`` constant comes from: the data sheet, or a
# placeholder that artifacts/h100_calib.json (scripts/calibrate_h100.py)
# replaces when the card measured it, or that awaits a run this card
# cannot make (two cards, two hosts)
H100_SOURCES: Dict[str, str] = {
    "peak_flops_bf16": "data sheet",
    "peak_flops_f32": "data sheet (CUDA cores)",
    "hbm_bandwidth": "data sheet",
    "hbm_capacity": "data sheet",
    "ici_bandwidth": "data sheet (NVLink 4)",
    "ici_latency": "placeholder (two cards)",
    "dcn_bandwidth": "data sheet (InfiniBand NDR)",
    "dcn_latency": "placeholder (two hosts)",
    "kernel_overhead": "placeholder (legacy per-op mode)",
    "mxu_efficiency": "measured (scripts/calibrate_h100.py)",
    "vmem_resident_bytes": "data sheet (L2)",
    "step_overhead": "measured (scripts/calibrate_h100.py)",
    "train_step_factor": "measured (scripts/calibrate_h100.py)",
    "overlap": "placeholder (two cards)",
    "host_bandwidth": "measured (scripts/calibrate_h100.py)",
    "host_latency": "measured (scripts/calibrate_h100.py)",
    "spec_break_even_acceptance": "placeholder (not measured)",
}

# the mesh's device type -> spec (MachineModel.for_mesh)
DEVICE_SPECS = {"cuda": "h100", "cpu": "cpu"}


@dataclasses.dataclass
class MachineModel:
    """Cost oracle for one mesh: compute roofline + collective time."""

    spec: TPUSpec
    # mesh axes laid out over NVLink by default; axes listed here ride
    # the slower inter-host link
    dcn_axes: frozenset = frozenset()

    @staticmethod
    def for_mesh(mesh, spec_name: Optional[str] = None,
                 dcn_axes=()) -> "MachineModel":
        """The machine of ``mesh`` (a ``parallel.Mesh``): ``h100`` for
        CUDA devices, ``cpu`` for the CPU, unless ``spec_name`` names
        one; another device type raises, so a mesh is never priced with
        another machine's constants by accident."""
        if spec_name is None:
            kind = mesh.devices[0].type
            if kind not in DEVICE_SPECS:
                raise ValueError(f"no machine spec for {kind!r} devices "
                                 f"(known: {sorted(DEVICE_SPECS)}); pass "
                                 "spec_name=")
            spec_name = DEVICE_SPECS[kind]
        return MachineModel(TPU_SPECS[spec_name], frozenset(dcn_axes))

    def with_calibration(self, path: str) -> "MachineModel":
        """Return a copy whose fused-program constants come from a measured
        calibration JSON (``search/measure.py`` writes it).
        Missing file or keys leave the spec-sheet defaults in place."""
        import json
        import os

        if not os.path.exists(path):
            return self
        try:
            with open(path) as f:
                doc = json.load(f)
        except (OSError, ValueError):
            return self
        fields = ("mxu_efficiency", "vmem_resident_bytes", "step_overhead",
                  "train_step_factor", "overlap",
                  "spec_break_even_acceptance",
                  "host_bandwidth", "host_latency")
        spec = dataclasses.replace(
            self.spec,
            **{k: float(doc[k]) for k in fields if k in doc},
        )
        return MachineModel(spec, self.dcn_axes)

    # spec constants a CalibrationStore may scale, by dimensional sense:
    # a measured/predicted TIME ratio > 1 means the machine is slower than
    # modeled -> time-like constants multiply by the scale, rate-like
    # constants divide by it
    _TIME_CONSTANTS = frozenset({
        "step_overhead", "kernel_overhead", "ici_latency", "dcn_latency",
        "host_latency", "train_step_factor",
        # relatively slower verify/draft steps raise the acceptance needed
        # to break even — time-like
        "spec_break_even_acceptance",
    })
    _RATE_CONSTANTS = frozenset({
        "hbm_bandwidth", "ici_bandwidth", "dcn_bandwidth",
        "host_bandwidth", "peak_flops_bf16", "peak_flops_f32",
        "mxu_efficiency",
    })

    def with_store(self, store) -> "MachineModel":
        """Return a copy whose spec constants are corrected by a persisted
        :class:`~flexflow_tpu_torch.obs.calibration.CalibrationStore`.

        Only store components NAMED after a spec constant apply here
        (``step_overhead``, ``mxu_efficiency``, ...); field-level
        components (``tpot_ms``, ``transfer_ms``, ...) are consumed by
        ``search_serve_plan`` at the prediction layer instead.  Scales
        below the store's min-sample gate are ignored (``scale_for``
        returns 1.0), and an empty/None store returns ``self`` unchanged —
        so this COMPOSES with :meth:`with_calibration`: measured constants
        load first, the store's drift corrections stack multiplicatively
        on top, and neither clobbers the other.
        """
        if store is None:
            return self
        updates = {}
        for name in self._TIME_CONSTANTS | self._RATE_CONSTANTS:
            s = store.scale_for(name)
            if s == 1.0:
                continue
            v = getattr(self.spec, name)
            updates[name] = v * s if name in self._TIME_CONSTANTS else v / s
        if not updates:
            return self
        return MachineModel(dataclasses.replace(self.spec, **updates),
                            self.dcn_axes)

    # ---- compute ------------------------------------------------------
    def compute_time(self, flops: float, bytes_accessed: float,
                     dtype_bits: int = 32) -> float:
        peak = (
            self.spec.peak_flops_bf16
            if dtype_bits <= 16
            else self.spec.peak_flops_f32
        )
        return max(flops / peak, bytes_accessed / self.spec.hbm_bandwidth) + (
            self.spec.kernel_overhead
        )

    # ---- communication ------------------------------------------------
    def transfer_time(self, nbytes: float, axes=()) -> float:
        """Point-to-point device-to-device transfer time (the inter-stage
        activation hop of pipeline-parallel serving).  ``axes``: mesh axes
        the hop crosses — listed in ``dcn_axes`` means the slower
        inter-host path."""
        if nbytes <= 0:
            return 0.0
        on_dcn = any(a in self.dcn_axes for a in axes)
        bw = self.spec.dcn_bandwidth if on_dcn else self.spec.ici_bandwidth
        lat = self.spec.dcn_latency if on_dcn else self.spec.ici_latency
        return nbytes / bw + lat

    def swap_time(self, nbytes: float) -> float:
        """Device<->host-DRAM transfer time for one KV spill or restore
        (serve/kv_paged.py HostPageTier).  The planner compares this
        against recompute-prefill cost (``serve_search.price_kv_swap``)
        to decide, per workload, whether a host tier pays off."""
        if nbytes <= 0:
            return 0.0
        return nbytes / self.spec.host_bandwidth + self.spec.host_latency

    def collective_time(self, comm_bytes_per_device: float, axes,
                        mesh) -> float:
        """Ring-model time for a collective moving ``comm_bytes_per_device``
        over the given mesh axes (the (deg-1)/deg factors are already in
        the bytes, ``parallel/parallel_ops.py``'s ``comm_bytes``)."""
        if comm_bytes_per_device <= 0:
            return 0.0
        deg = 1
        for a in axes:
            deg *= mesh.shape[a]
        if deg <= 1:
            return 0.0
        on_dcn = any(a in self.dcn_axes for a in axes)
        bw = self.spec.dcn_bandwidth if on_dcn else self.spec.ici_bandwidth
        lat = self.spec.dcn_latency if on_dcn else self.spec.ici_latency
        return comm_bytes_per_device / bw + (deg - 1) * lat
