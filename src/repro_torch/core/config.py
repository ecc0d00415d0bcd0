"""``DGPConfig`` — counterpart of ``repro/core/config.py``.

The same frozen dataclass with the same fields, defaults and validation, so
a config (and the ``config`` block of a checkpoint's ``meta.json``) means
the same in both packages.  ``gram_backend="pallas"`` selects the port's
hand-written Hopper kernels (``gram``, ``qgram_packed``); ``"xla"`` the
plain PyTorch path (matmuls).  ``impl="mesh"`` runs one process per
machine (:mod:`repro_torch.core.protocols.mesh`) and, as in the reference,
takes neither ``"pallas"`` nor ``scheme="vq"``.  ``faults`` takes
the port's :class:`~repro_torch.faults.FaultPlan`, which ``meta.json``
records as the reference does.
"""
from __future__ import annotations

import dataclasses

from ..faults import FaultPlan
from . import quantizers as Q
from .registry import FUSIONS, KERNELS, PROTOCOLS, SCHEMES

__all__ = ["DGPConfig", "ARTIFACT_FORMAT_VERSION", "IMPLS", "GRAM_BACKENDS",
           "GRAM_MODES", "TRAIN_IMPLS", "SERVE_EPILOGUES"]

IMPLS = ("host", "batched", "mesh")
GRAM_BACKENDS = ("xla", "pallas")
GRAM_MODES = ("nystrom", "nystrom_fitc", "direct", "dense")
TRAIN_IMPLS = ("scan", "loop")
SERVE_EPILOGUES = ("fused", "unfused")

# the reference's checkpoint format: packed uint32 wire words (v3),
# per-array CRC32s (v4), stream/* leaves (v5), serve-cache keys (v6)
ARTIFACT_FORMAT_VERSION = 6

def _ensure_registered() -> None:
    from . import protocols  # noqa: F401  (registers schemes + protocols)


def _check_choice(kind: str, value: str, choices: tuple) -> None:
    if value not in choices:
        raise ValueError(
            f"unknown {kind} {value!r}: known {kind}s are {', '.join(choices)}"
        )


@dataclasses.dataclass(frozen=True)
class DGPConfig:
    """Validated, hashable description of one distributed-GP configuration.
    The fields are the reference's; see ``repro.core.config.DGPConfig``."""

    protocol: str = "center"
    scheme: str = "per_symbol"
    kernel: str = "se"
    fusion: str = "kl"
    impl: str = "batched"
    gram_backend: str = "xla"
    gram_mode: str = "nystrom"
    bits_per_sample: int = 24
    max_bits: int = Q.DEFAULT_MAX_BITS
    steps: int = 150
    lr: float = 0.05
    train_impl: str = "scan"
    center: int = 0
    serve_epilogue: str = "fused"
    faults: object = None

    def __post_init__(self):
        _ensure_registered()
        for registry, value in (
            (PROTOCOLS, self.protocol), (SCHEMES, self.scheme),
            (KERNELS, self.kernel), (FUSIONS, self.fusion),
        ):
            registry.get(value)
        _check_choice("impl", self.impl, IMPLS)
        _check_choice("gram_backend", self.gram_backend, GRAM_BACKENDS)
        _check_choice("gram_mode", self.gram_mode, GRAM_MODES)
        _check_choice("train_impl", self.train_impl, TRAIN_IMPLS)
        _check_choice("serve_epilogue", self.serve_epilogue, SERVE_EPILOGUES)
        if self.bits_per_sample < 0:
            raise ValueError(f"bits_per_sample must be >= 0, got {self.bits_per_sample}")
        if self.max_bits < 0:
            raise ValueError(f"max_bits must be >= 0, got {self.max_bits}")
        if self.steps < 0:
            raise ValueError(f"steps must be >= 0, got {self.steps}")
        if self.center < 0:
            raise ValueError(f"center must be >= 0, got {self.center}")
        if self.gram_backend == "pallas" and self.impl != "batched":
            raise ValueError(
                f'gram_backend="pallas" requires impl="batched", got '
                f"{self.impl!r}"
            )
        if self.scheme == "vq":
            if self.protocol == "poe":
                raise ValueError(
                    'scheme="vq" does not apply to protocol="poe" '
                    "(zero-rate: nothing crosses the wire)"
                )
            if self.impl != "batched":
                raise ValueError(
                    f'scheme="vq" supports impl="batched" only, got {self.impl!r}'
                )
            if self.gram_backend != "xla":
                raise ValueError(
                    'scheme="vq" has no int wire codes for the pallas qgram '
                    'path: use gram_backend="xla"'
                )
        if self.faults is not None:
            if not isinstance(self.faults, FaultPlan):
                raise TypeError(
                    f"faults must be a repro_torch.faults.FaultPlan or None, got "
                    f"{type(self.faults).__name__}"
                )

    def asdict(self) -> dict:
        """JSON-ready dict (checkpoint ``meta.json`` records this)."""
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "DGPConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        d = {k: v for k, v in d.items() if k in known}
        if isinstance(d.get("faults"), dict):
            d["faults"] = FaultPlan.from_dict(d["faults"])
        return cls(**d)

    @classmethod
    def from_legacy_meta(cls, meta: dict) -> "DGPConfig":
        """The config of a format-v1 checkpoint (no ``config`` block), rebuilt
        from its metadata as the reference does: what serving needs is
        recorded exactly; steps and lr were not recorded and stay at their
        defaults."""
        return cls(
            protocol=meta["protocol"],
            scheme=meta.get("scheme", "per_symbol"),
            kernel=meta["kernel"],
            fusion=meta["fuse"] or "kl",
            impl="batched",  # checkpoints always restore single-host
            gram_backend=meta["gram_backend"],
            gram_mode=meta["gram_mode"],
            bits_per_sample=meta["bits_per_sample"],
            max_bits=meta["max_bits"],
        )
