"""Wire schemes — counterpart of ``repro/core/protocols/wire.py``.

The port has ``per_symbol`` (§4.2): the decorrelating transform, greedy
Algorithm-1 bit allocation and integer codes packed into the word plane,
for every machine at once at fit time; and, for streaming ``update``, the
re-encode of new symbols under one machine's frozen fit-time state through
the same plane (encode -> pack -> CRC -> unpack -> decode).  Fault
injection (slice 4), the ``vq`` channel (slice 6) and the mesh substrate
(slice 7) come later.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ...comm.accounting import (
    CRC_BITS, integrity_bits_formula, payload_bits_formula, payload_row_bits, row_bits,
    wire_bits_formula,
)
from .. import torch_scheme
from ..registry import SchemeSpec, register_scheme
from .base import PaddedShards, WireRun, WireState

__all__ = ["_run_wire_protocol", "Reencoded", "PER_SYMBOL"]


def _run_wire_protocol(X, mask, total_bits: int, max_bits: int, mode: str,
                       center: int) -> WireState:
    """Fit + encode + decode for EVERY machine, batched over the leading
    machine axis: one batched eigh pair, one quantize, one dequantize; the
    codes leave PACKED (padded rows are all-zero words).

    mode="center": every machine targets the center's covariance (§5.1);
    mode="broadcast": machine j targets the sum of the others' (§5.2)."""
    m, n_pad, d = X.shape
    n = torch.clamp(mask.sum(dim=1), min=1.0)
    S = torch.einsum("mnd,mne->mde", X, X) / n[:, None, None]  # padded rows are 0
    if mode == "center":
        Qy = S[center].expand(m, d, d)
    elif mode == "broadcast":
        Qy = S.sum(dim=0)[None] - S
    else:
        raise ValueError(f"unknown wire mode {mode!r}")
    cap = torch_scheme.codebook_cap(total_bits, max_bits)
    tables = torch_scheme.scheme_tables(total_bits, max_bits, X.device)
    states = torch_scheme.fit_scheme_batched(S, Qy, total_bits, cap)
    codes = torch_scheme.encode(states, X, tables)
    decoded = torch_scheme.decode(states, codes, tables) * mask[..., None]
    words = torch_scheme.pack_codes(
        codes, states["rates"], total_bits=row_bits(total_bits, d, max_bits),
        mask=mask,
    )
    cents = torch_scheme.scaled_centroids(states, tables)
    return WireState(
        words, decoded, states["T_inv"], states["rates"], states["sigma"],
        cents, states["T"],
    )


def _per_symbol_run(shards: PaddedShards, bits: int, max_bits: int, mode: str,
                    center: int) -> WireRun:
    m, n_pad, d = shards.X.shape
    skip = center if mode == "center" else None
    ws = _run_wire_protocol(shards.X, shards.mask, bits, max_bits, mode, center)
    wire = wire_bits_formula(ws.rates.cpu().numpy(), shards.lengths, d, skip=skip)
    payload = payload_bits_formula(shards.lengths, d, bits, max_bits, skip=skip)
    integrity = integrity_bits_formula(shards.lengths, skip=skip)
    return WireRun(ws, int(wire), int(payload), int(integrity), shards)


class Reencoded(NamedTuple):
    """What one machine sent for a streamed batch: the packed ``words``
    (n_new, W) and their per-row ``crc`` as they crossed the wire, the
    receiver's ``decoded`` rows (n_new, d), and the three ledger increments
    (python ints)."""

    decoded: torch.Tensor
    words: torch.Tensor
    crc: torch.Tensor
    wire_bits: int
    payload_bits: int
    integrity_bits: int


def _per_symbol_reencode(art, machine: int, X_new) -> Reencoded:
    """New symbols under ``machine``'s FROZEN codebooks and transform — no
    refit, no new side info.  They cross the same packed plane as the fit's
    rows (encode -> pack -> CRC -> unpack -> decode), so the payload charge
    is whole words per row, the ledger charge the frozen allocated rate,
    and the CRC framing ``CRC_BITS`` per row.  The reference's
    ``_per_symbol_reencode`` and ``_per_symbol_reencode_traced`` in one."""
    w = art.wire
    state = {k: getattr(w, k)[machine] for k in ("T", "T_inv", "sigma", "rates")}
    n_new, d = X_new.shape
    tables = torch_scheme.scheme_tables(art.bits_per_sample, art.max_bits, X_new.device)
    codes = torch_scheme.encode(state, X_new, tables)
    rbits = row_bits(art.bits_per_sample, d, art.max_bits)
    words = torch_scheme.pack_codes(codes, state["rates"], total_bits=rbits)
    crc = torch_scheme.crc_words(words)
    received = torch_scheme.unpack_codes(words, state["rates"], total_bits=rbits)
    decoded = torch_scheme.decode(state, received, tables)
    return Reencoded(
        decoded, words, crc, int(state["rates"].sum()) * n_new,
        payload_row_bits(art.bits_per_sample, d, art.max_bits) * n_new, CRC_BITS * n_new,
    )


PER_SYMBOL = register_scheme(SchemeSpec(name="per_symbol", run=_per_symbol_run,
                                        reencode=_per_symbol_reencode))
