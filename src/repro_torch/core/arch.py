"""Architecture classes (the port's copy of ``repro.core.arch``;
:func:`detect_arch` reads the CUDA device through torch).

An :class:`ArchProfile` is a frozen, hashable description of the machine
class a tuning record was measured on (lane count, per-lane fast-memory
capacity, the compute/bandwidth roofline ratio, backend tag); its canonical
string form (:attr:`ArchProfile.cls`) is stamped onto every
:class:`~repro_torch.core.tuner.TuningRecord`. Records of the *same* class
are direct database hits; records of a *different* class never are — the
selector re-ranks their policies under the local machine instead (the
``"xarch"`` dispatch source). Arch-less records belong to
:data:`DEFAULT_ARCH`.

Profiles are *coarse* on purpose: two hosts of the same device generation
must land in the same class even when their calibrated constants differ by a
few percent, so the ratio term is quantized (:data:`_RATIO_STEP`).
"""

from __future__ import annotations

import json
from dataclasses import asdict, dataclass

from repro_torch.core.costmodel import V5E, Machine

#: arch class of every record written without arch awareness; its sieve
#: key bytes carry no class prefix, so they equal the JAX package's.
DEFAULT_ARCH = "default"

#: quantization step of the compute/bandwidth ratio term: hosts of one
#: device generation must classify together despite calibration-level
#: drift in their fitted constants, so the ratio rounds to this granularity.
_RATIO_STEP = 25


@dataclass(frozen=True)
class ArchProfile:
    """One machine class: the coordinates tuning records federate within.

    Frozen and hashable — profiles key dictionaries (per-class record
    partitions) and participate in journal entries.
    """

    #: execution backend tag ("tpu", "gpu", "cpu", ...)
    backend: str = "tpu"
    #: parallel lanes the scheduler fills (cores / SMs / forced host devices)
    lanes: int = 8
    #: per-lane VMEM / shared-memory capacity in bytes (tile feasibility)
    vmem_bytes: int = V5E.vmem_bytes
    #: quantized peak-FLOP/s : HBM-byte/s roofline ratio — the "clock/byte"
    #: coordinate that separates device generations with the same lane count
    flops_per_byte: int = 250

    @property
    def cls(self) -> str:
        """Canonical class string records are stamped with (stable,
        human-readable: ``"tpu:l8:v16m:r250"``)."""
        return (
            f"{self.backend}:l{self.lanes}"
            f":v{self.vmem_bytes >> 20}m:r{self.flops_per_byte}"
        )

    def to_json(self) -> dict:
        """JSON payload (the ``{"arch": ...}`` journal entry body)."""
        d = asdict(self)
        d["cls"] = self.cls
        return d

    @classmethod
    def from_json(cls, d: dict) -> "ArchProfile":
        """Inverse of :meth:`to_json` (the redundant ``cls`` field is
        ignored — the class string is always re-derived, so a hand-edited
        payload cannot desynchronize the two)."""
        return cls(
            backend=str(d.get("backend", "tpu")),
            lanes=int(d.get("lanes", 8)),
            vmem_bytes=int(d.get("vmem_bytes", V5E.vmem_bytes)),
            flops_per_byte=int(d.get("flops_per_byte", 250)),
        )

    @classmethod
    def from_machine(cls, mach: Machine, backend: str = "tpu") -> "ArchProfile":
        """Classify a cost-model machine (nominal or calibrated base).

        The roofline ratio quantizes to :data:`_RATIO_STEP` so two hosts of
        one generation with slightly different calibrated constants land in
        the same class."""
        ratio = mach.peak_flops / max(mach.hbm_bw, 1.0)
        return cls(
            backend=backend,
            lanes=mach.lanes,
            vmem_bytes=mach.vmem_bytes,
            flops_per_byte=int(round(ratio / _RATIO_STEP)) * _RATIO_STEP,
        )


def detect_arch(mach: Machine = V5E) -> ArchProfile:
    """Profile of the live torch device: tagged ``"cuda"`` with the lane
    count and per-block shared memory that ``torch.cuda.get_device_properties``
    reports when a CUDA device is present (an H100 gives 132 SMs and 232,448
    bytes, the nominal :data:`~repro_torch.core.costmodel.H100` coordinates),
    else ``"cpu"`` with ``mach``'s coordinates. The roofline ratio always
    comes from ``mach``, the machine the caller scores under."""
    import torch

    if not torch.cuda.is_available():
        return ArchProfile.from_machine(mach, backend="cpu")
    props = torch.cuda.get_device_properties(torch.cuda.current_device())
    smem = getattr(props, "shared_memory_per_block_optin", mach.vmem_bytes)
    prof = ArchProfile.from_machine(mach, backend="cuda")
    return ArchProfile(
        backend="cuda",
        lanes=int(props.multi_processor_count),
        vmem_bytes=int(smem),
        flops_per_byte=prof.flops_per_byte,
    )


def arch_entry(profile: ArchProfile) -> str:
    """One journal line declaring the producer's arch profile — the third
    tagged entry type the tuning journal understands (see the registry in
    :mod:`repro_torch.core.tuner`). Consumers store it in
    ``TuningDatabase.arch_profiles`` keyed by class string, so a merged
    fleet knows the coordinates behind every class it carries."""
    return json.dumps({"arch": profile.to_json()})


def append_arch(path: str, profile: ArchProfile) -> None:
    """Append an arch-profile entry to the JSONL journal."""
    with open(path, "a") as f:
        f.write(arch_entry(profile) + "\n")
