"""The wire-bit ledgers of the port — a copy of ``repro/comm/accounting.py``.

Three integers describe what a protocol run cost (docs/wire_format.md):

* ``wire_bits``, the paper's §4 Theorem-1 ledger: ``rates.sum()`` bits per
  valid transmitted row plus :func:`side_info_bits` per transmitting machine;
* ``payload_bits``, the packed uint32 words the wire carries plus the same
  side info — above the ledger only by per-word padding;
* ``integrity_bits``, :data:`CRC_BITS` of CRC framing per transmitted row.

Pure Python (numpy only), so it is copied rather than imported: the port
never imports the JAX package.  tests/test_torch_center.py holds the port's
ledgers integer-equal to the reference's.
"""
from __future__ import annotations

FP_BITS = 32  # fp32 side-info width
WORD_BITS = 32  # the packed code plane's word width (torch_scheme.WORD_BITS)
CRC_BITS = 16  # per-row CRC-16-CCITT framing (torch_scheme.crc_words)

__all__ = [
    "FP_BITS",
    "WORD_BITS",
    "CRC_BITS",
    "side_info_bits",
    "row_bits",
    "payload_row_bits",
    "wire_bits_formula",
    "payload_bits_formula",
    "integrity_bits_formula",
]


def side_info_bits(d: int, fp_bits: int = FP_BITS) -> int:
    """Per-transmitting-machine side info: the paper's O(2 d^2) accounting —
    one d x d covariance each way (Qy to the transmitter, the decode
    transform back).  The simulation's collectives also move the per-dim
    sigma/rates vectors and a redundant forward transform for the serving
    artifact; those O(d) extras are not charged (see docs/wire_format.md)."""
    return 2 * d * d * fp_bits


def row_bits(bits_per_sample: int, d: int, max_bits: int) -> int:
    """Payload bits one packed row can carry: the rate budget, capped by the
    allocator's ceiling of ``max_bits`` bits per dimension."""
    return min(int(bits_per_sample), d * int(max_bits))


def payload_row_bits(bits_per_sample: int, d: int, max_bits: int) -> int:
    """Physical bits per packed row: ``row_bits`` rounded up to whole uint32
    words — the only slack between the ledger and the payload."""
    r = row_bits(bits_per_sample, d, max_bits)
    return ((r + WORD_BITS - 1) // WORD_BITS) * WORD_BITS


def wire_bits_formula(rates, lengths, d: int, skip=None) -> int:
    """The Theorem-1 ledger: ``rates_j.sum() * n_j`` + side info per
    transmitting machine (machine ``skip`` — the §5.1 center — pays
    nothing)."""
    import numpy as np

    rates = np.asarray(rates)
    total = 0
    for j, n_j in enumerate(lengths):
        if j == skip or int(n_j) == 0:
            continue  # a machine with nothing to send sends nothing
        total += int(rates[j].sum()) * int(n_j) + side_info_bits(d)
    return total


def payload_bits_formula(
    lengths, d: int, bits_per_sample: int, max_bits: int, skip=None
) -> int:
    """The physical packed-payload bits: whole uint32 words per valid row plus
    side info per transmitting machine."""
    per_row = payload_row_bits(bits_per_sample, d, max_bits)
    total = 0
    for j, n_j in enumerate(lengths):
        if j == skip or int(n_j) == 0:
            continue
        total += per_row * int(n_j) + side_info_bits(d)
    return total


def integrity_bits_formula(lengths, skip=None, crc_bits: int = CRC_BITS) -> int:
    """The **integrity ledger**: CRC framing bits per valid transmitted row —
    ``crc_bits * n_j`` for every transmitting machine (machine ``skip`` — the
    §5.1 center — transmits nothing, so it carries no CRC either).  Charged
    separately from ``wire_bits``/``payload_bits`` so the detection overhead
    is visible in rate/distortion plots (docs/fault_model.md)."""
    total = 0
    for j, n_j in enumerate(lengths):
        if j == skip or int(n_j) == 0:
            continue
        total += crc_bits * int(n_j)
    return total
