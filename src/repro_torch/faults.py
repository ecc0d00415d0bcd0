"""Seedable fault plans for the distributed-GP stack — counterpart of
``repro/faults.py``.

A :class:`FaultPlan` is a frozen, hashable description of what goes wrong:
which machines drop out, which shards are NaN-poisoned, the bit-flip rate
on the packed word plane, and which machines straggle.  It rides on
:class:`~repro_torch.core.config.DGPConfig` and is consumed at two layers
here:

* **dataset faults** (:func:`apply_to_parts`) drop or NaN-poison whole
  shards before the protocol sees them; non-finite rows are filtered (and
  counted) rather than propagated.  numpy's ``default_rng(plan.seed)``
  picks the poisoned rows, so both packages poison the same rows.
* **wire faults** (:func:`flip_words` and the CRC demotion in
  ``core/protocols/wire.py``) XOR random bit masks into the packed words,
  as a noisy channel would.

``straggle`` is carried and round-tripped only: its sleep belongs to the
serve loop.  Constructors compose with ``|``::

    plan = drop_machine(1) | corrupt_words(0.01, seed=7)

The reference draws its flip masks from ``jax.random`` keyed by
``fold_in(PRNGKey(seed), stream)``, which torch cannot reproduce.  The port
draws every mask from one function, :func:`flip_mask`, keyed by the same
two integers on a CPU generator, so a plan flips the same bits on the card
and on the CPU; the parity tests substitute the reference's masks there.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = [
    "FaultPlan",
    "drop_machine",
    "corrupt_words",
    "nan_shard",
    "straggler",
    "stream_generator",
    "flip_mask",
    "flip_words",
    "apply_to_parts",
]


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """What goes wrong, declaratively.  All fields are tuples or scalars so
    the plan is hashable (it rides on the frozen DGPConfig)."""

    drop: tuple = ()          # machine indices that send nothing
    nan: tuple = ()           # machine indices whose shards are NaN-poisoned
    nan_frac: float = 0.5     # fraction of rows poisoned in a nan shard
    flip_rate: float = 0.0    # per-bit flip probability on packed words
    straggle: tuple = ()      # ((machine, delay_seconds), ...)
    seed: int = 0             # seed of the bit-flip channel and the NaN rows

    def __or__(self, other: "FaultPlan") -> "FaultPlan":
        if not isinstance(other, FaultPlan):
            return NotImplemented
        return FaultPlan(
            drop=tuple(sorted(set(self.drop) | set(other.drop))),
            nan=tuple(sorted(set(self.nan) | set(other.nan))),
            nan_frac=max(self.nan_frac, other.nan_frac),
            flip_rate=max(self.flip_rate, other.flip_rate),
            straggle=tuple(sorted(set(self.straggle) | set(other.straggle))),
            seed=self.seed if self.flip_rate >= other.flip_rate else other.seed,
        )

    @property
    def active(self) -> bool:
        return bool(self.drop or self.nan or self.flip_rate or self.straggle)

    def asdict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "FaultPlan":
        return cls(
            drop=tuple(d.get("drop", ())),
            nan=tuple(d.get("nan", ())),
            nan_frac=float(d.get("nan_frac", 0.5)),
            flip_rate=float(d.get("flip_rate", 0.0)),
            straggle=tuple(tuple(s) for s in d.get("straggle", ())),
            seed=int(d.get("seed", 0)),
        )


def drop_machine(*js: int) -> FaultPlan:
    """Machines ``js`` send nothing (empty shards, zeroed masks)."""
    return FaultPlan(drop=tuple(sorted(int(j) for j in js)))


def corrupt_words(rate: float, seed: int = 0) -> FaultPlan:
    """Flip each bit of every transmitted packed word with prob ``rate``."""
    return FaultPlan(flip_rate=float(rate), seed=int(seed))


def nan_shard(*js: int) -> FaultPlan:
    """NaN-poison (half of) the rows of machines ``js``."""
    return FaultPlan(nan=tuple(sorted(int(j) for j in js)))


def straggler(j: int, delay: float) -> FaultPlan:
    """Machine ``j`` answers ``delay`` seconds late (serve loop only)."""
    return FaultPlan(straggle=((int(j), float(delay)),))


def stream_generator(seed: int, stream: int) -> torch.Generator:
    """A CPU generator seeded from ``(seed, stream)`` — the port's stand-in
    for the reference's ``fold_in(PRNGKey(seed), stream)``.  torch's CPU
    generator keeps 32 bits of its seed, so the pair is hashed into them by
    numpy's ``SeedSequence``."""
    mixed = np.random.SeedSequence((int(seed), int(stream))).generate_state(1)[0]
    return torch.Generator().manual_seed(int(mixed))


def flip_mask(shape, rate: float, seed: int, stream: int) -> torch.Tensor:
    """The bit-flip mask of one transmission: each of the 32 bits of each
    word of ``shape`` set with probability ``rate``, drawn on the CPU from
    ``stream_generator(seed, stream)``.  Returns an int32 CPU tensor of
    ``shape`` carrying the uint32 masks."""
    shape = tuple(int(s) for s in shape)
    if rate <= 0.0:
        return torch.zeros(shape, dtype=torch.int32)
    u = torch.rand(shape + (32,), generator=stream_generator(seed, stream))
    bits = (u < rate).to(torch.int64) << torch.arange(32, dtype=torch.int64)
    mask = bits.sum(-1)
    return torch.where(mask >= 2**31, mask - 2**32, mask).to(torch.int32)


def flip_words(words: torch.Tensor, rate: float, seed: int, stream: int) -> torch.Tensor:
    """XOR the :func:`flip_mask` of ``(seed, stream)`` into the int32 word
    plane ``words`` (uint32 bits), on the words' device."""
    if rate <= 0.0:
        return words
    return words ^ flip_mask(words.shape, rate, seed, stream).to(words.device)


def apply_to_parts(parts, plan: FaultPlan | None):
    """Apply dataset-level faults to per-machine ``(X_j, y_j)`` numpy shards.

    * dropped machines become empty shards (0 rows, d preserved);
    * NaN shards have ``nan_frac`` of their rows poisoned — then the generic
      finite-row filter removes every non-finite row and counts it.

    Returns ``(new_parts, rows_removed)``.  Host-side numpy, a copy of the
    reference's, so the same plan removes the same rows in both packages."""
    if plan is None or not (plan.drop or plan.nan):
        return parts, 0
    drop, nan = set(plan.drop), set(plan.nan)
    rng = np.random.default_rng(plan.seed)
    out, removed = [], 0
    for j, (Xj, yj) in enumerate(parts):
        Xj = np.asarray(Xj)
        yj = np.asarray(yj)
        if j in drop:
            removed += Xj.shape[0]
            out.append((Xj[:0], yj[:0]))
            continue
        if j in nan and Xj.shape[0]:
            Xj, yj = Xj.copy(), yj.copy()
            k = max(1, int(round(plan.nan_frac * Xj.shape[0])))
            idx = rng.choice(Xj.shape[0], size=k, replace=False)
            Xj[idx] = np.nan
        finite = np.isfinite(Xj).all(axis=1) & np.isfinite(yj)
        if not finite.all():
            removed += int((~finite).sum())
            Xj, yj = Xj[finite], yj[finite]
        out.append((Xj, yj))
    return out, removed
