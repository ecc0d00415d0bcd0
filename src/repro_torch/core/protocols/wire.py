"""Wire schemes — counterpart of ``repro/core/protocols/wire.py``.

* ``per_symbol`` (§4.2): the decorrelating transform, greedy Algorithm-1
  bit allocation and integer codes packed into the word plane, for every
  machine at once at fit time; for streaming ``update``, the re-encode of
  new symbols under one machine's frozen fit-time state through the same
  plane (encode -> pack -> CRC -> unpack -> decode).  Under a fault plan's
  ``flip_rate`` the receiver XORs each transmission's flip mask
  (``faults.flip_mask``) into the words, recomputes each row's CRC-16 and
  demotes the rows whose checksum fails (:func:`_corrupt_and_demote` at
  fit time, :func:`_per_symbol_update_corrupt` for a streamed batch); the
  ledgers charge every transmitted row.
* ``vq`` (§4.1): the Theorem-2 optimal test channel as a wire scheme.
  Each machine builds the achieving conditional x̂ | x ~ N(Ax, W) at the
  distortion its bit budget buys and the receiver sees samples from it
  (simulated on the host: block coding is intractable, as the paper
  notes).  Each machine is charged ``ceil(n_j R_j)`` at the channel's
  achieved rate plus the per-symbol side info; the channel state rides in
  the artifact's ``data`` for streaming.  It has no packed words, so it
  refuses a fault plan with flips.

The mesh substrate runs the per-symbol fit through
``comm.q_all_gather`` instead (:mod:`.mesh`), one process per machine, and
then the same receiver (:func:`_corrupt_and_demote`) on every rank.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from ... import faults as fault_plane
from ...comm.accounting import (
    CRC_BITS, integrity_bits_formula, payload_bits_formula, payload_row_bits, row_bits,
    side_info_bits, wire_bits_formula,
)
from .. import torch_scheme
from ..rate_distortion import (
    OptimalTestChannel, distortion_for_rate, make_test_channel, sample_test_channel,
)
from ..registry import SchemeSpec, register_scheme
from .base import PaddedShards, WireRun, WireState

__all__ = ["_run_wire_protocol", "Reencoded", "PER_SYMBOL", "VQ"]


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


def _scheme_state(ws: WireState, machine=slice(None)) -> dict:
    """The frozen scheme state of ``machine`` (every machine by default) in
    the form ``torch_scheme.encode`` / ``decode`` take."""
    return {k: getattr(ws, k)[machine] for k in ("T", "T_inv", "sigma", "rates")}


def _corrupt_and_demote(ws: WireState, shards: PaddedShards, bits: int, max_bits: int,
                        skip, plan):
    """The noisy-channel receiver: XOR each transmitting machine's flip mask
    (``faults.flip_mask`` keyed by ``(plan.seed, j)``) into its packed
    words, recompute each row's CRC-16 against the sender's, decode what
    arrived, and DEMOTE rows whose checksum fails — each machine's
    survivors compacted to the front, so the protocol's assembly sees a
    plain shorter shard.  A corruption that collides with the CRC (prob
    2^-16) survives with its corrupted decode: the receiver is honest about
    what it can detect.  Runs on the words' device, every machine at once;
    the lengths come back to the host.  Returns ``(ws, shards,
    rows_demoted)`` with words, decoded, X, y, mask and lengths moved
    consistently; the ledgers are not touched (the bits were transmitted
    regardless of what survived)."""
    m, n_pad, d = shards.X.shape
    W = ws.codes.shape[-1]
    lengths = shards.lengths
    sends = [j != skip and lengths[j] > 0 and W > 0 for j in range(m)]
    if not any(sends):
        return ws, shards, 0
    masks = torch.zeros((m, n_pad, W), dtype=torch.int32)
    for j in range(m):
        if sends[j]:
            masks[j, : lengths[j]] = fault_plane.flip_mask((lengths[j], W), plan.flip_rate,
                                                           plan.seed, j)
    masks = masks.to(ws.codes.device)
    rx = ws.codes ^ masks
    ok = torch_scheme.crc_words(rx) == torch_scheme.crc_words(ws.codes)
    keep = ok & (shards.mask > 0)
    tables = torch_scheme.scheme_tables(bits, max_bits, rx.device)
    received = torch_scheme.unpack_codes(rx, ws.rates,
                                         total_bits=row_bits(bits, d, max_bits))
    flipped = (masks != 0).any(-1, keepdim=True)
    decoded = torch.where(flipped, torch_scheme.decode(_scheme_state(ws), received, tables),
                          ws.decoded)
    # compaction: kept row i of machine j moves to slot (#kept rows before it)
    new_lengths = tuple(int(v) for v in keep.sum(1).tolist())
    jj, ii = torch.nonzero(keep, as_tuple=True)
    slot = (torch.cumsum(keep.to(torch.int64), 1) - 1)[jj, ii]

    def compact(buf):
        out = torch.zeros_like(buf)
        out[jj, slot] = buf[jj, ii]
        return out

    new_mask = (torch.arange(n_pad, device=keep.device)[None, :]
                < torch.tensor(new_lengths, device=keep.device)[:, None]).to(shards.mask.dtype)
    shards = PaddedShards(compact(shards.X), compact(shards.y), new_mask, new_lengths)
    ws = dataclasses.replace(ws, codes=compact(rx), decoded=compact(decoded))
    return ws, shards, sum(lengths) - sum(new_lengths)


def _per_symbol_run(shards: PaddedShards, bits: int, max_bits: int, mode: str,
                    center: int, faults=None) -> WireRun:
    m, n_pad, d = shards.X.shape
    skip = center if mode == "center" else None
    ws = _run_wire_protocol(shards.X, shards.mask, bits, max_bits, mode, center)
    wire = wire_bits_formula(ws.rates.cpu().numpy(), shards.lengths, d, skip=skip)
    payload = payload_bits_formula(shards.lengths, d, bits, max_bits, skip=skip)
    integrity = integrity_bits_formula(shards.lengths, skip=skip)
    rows_demoted = 0
    if faults is not None and faults.flip_rate > 0.0:
        ws, shards, rows_demoted = _corrupt_and_demote(ws, shards, bits, max_bits, skip,
                                                       faults)
    return WireRun(ws, int(wire), int(payload), int(integrity), {}, shards, rows_demoted)


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
    state = _scheme_state(art.wire, machine)
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


def _per_symbol_update_corrupt(art, machine: int, X_new, plan):
    """A streamed batch through the noisy channel (the update-time analog of
    :func:`_corrupt_and_demote`): re-encode under ``machine``'s frozen
    codebooks, XOR the flip mask keyed by ``(plan.seed, wire_bits +
    machine)`` (the pre-update ledger, so successive batches draw fresh
    corruption), CRC-check against the clean words and demote the failed
    rows.  Returns ``(keep_idx, decoded, wire_add, payload_add,
    integrity_add, demoted)``: the ledger increments charge the WHOLE batch
    (the bits moved whatever survived), ``decoded`` holds the survivors'
    received reconstructions."""
    sent = _per_symbol_reencode(art, machine, X_new)
    rx = fault_plane.flip_words(sent.words, plan.flip_rate, plan.seed,
                                art.wire_bits + machine)
    keep = torch.nonzero(torch_scheme.crc_words(rx) == sent.crc)[:, 0]
    state = _scheme_state(art.wire, machine)
    rbits = row_bits(art.bits_per_sample, X_new.shape[1], art.max_bits)
    tables = torch_scheme.scheme_tables(art.bits_per_sample, art.max_bits, X_new.device)
    received = torch_scheme.unpack_codes(rx[keep], state["rates"], total_bits=rbits)
    return (keep, torch_scheme.decode(state, received, tables), sent.wire_bits,
            sent.payload_bits, sent.integrity_bits, X_new.shape[0] - keep.numel())


PER_SYMBOL = register_scheme(SchemeSpec(
    name="per_symbol", run=_per_symbol_run, reencode=_per_symbol_reencode,
    update_corrupt=_per_symbol_update_corrupt,
))


# --------------------------------------------------------------------------
# vq — the §4.1 Theorem-2 optimal test channel as a wire scheme
# --------------------------------------------------------------------------


def _vq_run(shards: PaddedShards, bits: int, max_bits: int, mode: str, center: int,
            faults=None) -> WireRun:
    """Every transmitting machine's test channel at the distortion its
    budget buys (float64 numpy on the host), sampled on the shards' device
    with noise keyed by ``(0, j)``.  Returns the :class:`WireRun` with a
    zero-width word plane, identity transforms, the decoded samples, the
    channel state as ``extras`` and the ledger ``sum_j ceil(L_j R_j) +
    side_info_bits(d)``, which is also the payload (the channel is
    simulated: no word padding, no CRC framing)."""
    if faults is not None and faults.flip_rate > 0.0:
        raise NotImplementedError(
            'scheme="vq" simulates a continuous test channel — there are no '
            'packed words to bit-flip; use scheme="per_symbol" for wire '
            "corruption experiments"
        )
    m, n_pad, d = shards.X.shape
    X = shards.X.cpu().numpy().astype(np.float64)
    # max_bits caps each dimension's per-symbol rate, so no scheme spends
    # more than d * max_bits a sample: the budgets stay matched when it binds
    bits = min(bits, d * max_bits)
    L = shards.lengths
    S = [X[j, : L[j]].T @ X[j, : L[j]] / max(L[j], 1) for j in range(m)]
    S_tot = sum(S)
    dev = shards.X.device
    decoded = torch.zeros((m, n_pad, d), dtype=torch.float32, device=dev)
    A = np.zeros((m, d, d), np.float32)
    W_half = np.zeros((m, d, d), np.float32)
    rate_bits = np.zeros((m,), np.float32)
    wire = 0
    for j in range(m):
        if (mode == "center" and j == center) or L[j] == 0:
            continue  # the center never transmits; an empty machine sends nothing
        Qy = S[center] if mode == "center" else S_tot - S[j]
        ch = make_test_channel(S[j], Qy, distortion_for_rate(S[j], Qy, float(bits)))
        decoded[j, : L[j]] = sample_test_channel(ch, shards.X[j, : L[j]], 0, j)
        A[j], W_half[j], rate_bits[j] = ch.A, ch.W_half, ch.rate_bits
        wire += math.ceil(L[j] * float(ch.rate_bits)) + side_info_bits(d)
    eye = torch.eye(d, device=dev).expand(m, d, d).contiguous()
    ws = WireState(
        codes=torch.zeros((m, n_pad, 0), dtype=torch.int32, device=dev),
        decoded=decoded, T_inv=eye, rates=torch.zeros((m, d), dtype=torch.int32, device=dev),
        sigma=torch.ones((m, d), device=dev),
        scaled_cents=torch.zeros((m, d, 1), device=dev), T=eye.clone(),
    )
    extras = {k: torch.from_numpy(v).to(dev) for k, v in
              (("vq_A", A), ("vq_W_half", W_half), ("vq_rate_bits", rate_bits))}
    return WireRun(ws, int(wire), int(wire), 0, extras, shards, 0)


def _vq_reencode(art, machine: int, X_new) -> Reencoded:
    """Sample the FROZEN fit-time channel of ``machine`` for new symbols,
    with noise keyed by ``(1, wire_bits + machine)`` (the pre-update
    ledger, so successive batches draw fresh noise).  The ledger and the
    payload grow by ``ceil(n_new R)``; nothing is framed by a CRC."""
    if "vq_A" not in art.data:
        raise ValueError(
            "artifact has no vq channel state (was it fitted with "
            'scheme="vq"?)'
        )
    rate = float(art.data["vq_rate_bits"][machine])
    channel = OptimalTestChannel(art.data["vq_A"][machine], art.data["vq_W_half"][machine],
                                 rate, 0.0)
    decoded = sample_test_channel(channel, X_new, 1, art.wire_bits + machine)
    words = torch.zeros((X_new.shape[0], 0), dtype=torch.int32, device=X_new.device)
    bits = math.ceil(X_new.shape[0] * rate)
    return Reencoded(decoded, words, torch_scheme.crc_words(words), bits, bits, 0)


VQ = register_scheme(SchemeSpec(name="vq", run=_vq_run, reencode=_vq_reencode))
