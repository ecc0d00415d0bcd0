"""The paper's wire protocol as collectives between machine processes —
counterpart of ``repro/comm/quantized_collectives.py``.

Where the reference runs inside ``shard_map`` over a device axis, the port
runs on every rank of a ``torch.distributed`` process group (one process
per machine, :mod:`.collectives`), each rank calling the same function on
its own block.

``q_all_gather(x, group, bits)``: every rank holds a local dataset block
(n_loc, d) and wants every other rank's block.  Instead of gathering fp32
(32 d bits a sample), each rank

  1. forms its second moment; the moments are gathered (O(d^2) each) and
     every rank takes its target covariance Qy from them —
     ``mode="broadcast"`` (§5.2): the sum of the OTHER ranks' moments,
     ``mode="center"`` (§5.1): the center rank's; every rank sums in
     machine order, as the batched wire does, so the two agree bit for bit;
  2. fits the per-symbol scheme (``torch_scheme.fit_scheme``) on its own
     moment only;
  3. packs its codes into the word plane (R bits a row in whole 32-bit
     words) and gathers THOSE words, with its rates and CRCs, in one int32
     buffer, and its fp32 side info (T_inv, T, sigma, the row mask) in one
     float32 buffer;
  4. unpacks and decodes every rank's block with that rank's tables and
     substitutes its own exact block.

``mask`` marks the valid rows of a padded block: masked rows are left out
of the moment, pack to all-zero words, decode to zero and are not charged.
``return_state=True`` also returns everything the collective moved and the
three ledgers of :mod:`.accounting`, each rank's contribution summed by one
all-reduce: ``wire_bits`` (the Theorem-1 formula: the allocated rate a
valid row plus ``side_info_bits(d)`` a transmitting rank), ``payload_bits``
(measured from the word buffer handed to the collective: its words a row,
times the word's bits, per valid row, plus the same side info) and
``integrity_bits`` (``CRC_BITS`` a valid row).  The center transmits
nothing in center mode.

``q_psum(g, group, bits)``: a quantized all-reduce for gradients — per-rank
Gaussian scalar quantization at ``bits`` bits an element (equiprobable
bins, sigma on the fly), the packed codes and each rank's sigma gathered,
decoded and summed.  ``bits >= 32`` is the exact sum.  Its backward is the
exact all-reduce of the cotangent (straight-through), so the quantizer's
zero-derivative staircase does not stop the gradient.
"""
from __future__ import annotations

import torch

from .. import faults as fault_plane
from ..core import quantizers as Q
from ..core import torch_scheme
from . import collectives as C
from .accounting import CRC_BITS, row_bits, side_info_bits

__all__ = ["wire_bits_all_gather", "q_all_gather", "q_psum"]


def wire_bits_all_gather(n_per_shard: int, d: int, bits: int, n_shards: int, fp_bits=32):
    """Bits each rank puts on the wire: codes plus side info, against the
    fp32 baseline.  Side info charges :func:`.accounting.side_info_bits`,
    the one formula shared with ``q_all_gather``'s ledger."""
    quantized = n_per_shard * bits + side_info_bits(d, fp_bits)
    baseline = n_per_shard * d * fp_bits
    return quantized, baseline


def _fault_mask(x, mask, faults, idx: int):
    """Collective-level data faults: non-finite rows and the dropped ranks'
    rows masked out before the moment (``x`` with those rows zeroed, and
    the mask)."""
    n_loc = x.shape[0]
    fmask = torch.ones(n_loc, device=x.device) if mask is None else mask.float()
    row_ok = torch.isfinite(x).all(dim=-1)
    x = torch.where(row_ok[:, None], x, torch.zeros_like(x))
    fmask = fmask * row_ok.float()
    if idx in faults.drop:
        fmask = torch.zeros_like(fmask)
    return x, fmask


def q_all_gather(x, group=None, bits_per_sample: int = 24, max_bits: int = 8, *, mask=None,
                 mode: str = "broadcast", center: int = 0, return_state: bool = False,
                 faults=None):
    """x: (n_loc, d) on every rank -> (m, n_loc, d) reconstructions of every
    rank's block, this rank's own block exact.  Every rank of ``group``
    (the default process group when None) must call it.

    mask : optional (n_loc,) float validity of the rows; None = all valid.
    mode : "broadcast" (Qy = the sum of the other ranks' moments) or
        "center" (every rank targets the moment of rank ``center``).
    return_state : also return a dict of what the collective moved —
        ``codes`` (m, n_loc, W) int32 packed words (the uint32 bits; masked
        rows are zero words), ``decoded`` (m, n_loc, d) reconstructions
        without the own-block substitution, ``T``/``T_inv``/``sigma``/
        ``rates`` per rank, ``mask`` (m, n_loc) and the three ledgers as
        python ints (``wire_bits``, ``payload_bits``, ``integrity_bits``).
    faults : optional :class:`repro_torch.faults.FaultPlan` injected into
        the collective: dropped ranks transmit nothing, non-finite rows are
        masked out, and ``flip_rate > 0`` XORs each sender's flip mask
        (``faults.flip_mask`` keyed by ``(seed, sender)``) into the gathered
        words; rows whose CRC no longer matches the sender's (gathered
        beside the words) are demoted to masked on the receivers.
    """
    if mode not in ("broadcast", "center"):
        raise ValueError(f"unknown q_all_gather mode {mode!r}")
    n_loc, d = x.shape
    m, idx = C.group_size(group), C.group_rank(group)
    x = x.float()
    if faults is not None and (faults.drop or faults.nan):
        x, mask = _fault_mask(x, mask, faults, idx)
    mask_l = torch.ones(n_loc, device=x.device) if mask is None else mask.float()
    n_valid = torch.clamp(mask_l.sum(), min=1.0)
    xm = (x * mask_l[:, None])[None]
    S_loc = torch.einsum("mnd,mne->mde", xm, xm)[0] / n_valid  # the batched wire's op
    S_all = C.all_gather(S_loc, group)  # O(d^2) a rank
    Qy = S_all[center] if mode == "center" else S_all.sum(dim=0) - S_all[idx]
    # per-dimension rates never exceed bits_per_sample: the tables stop there
    cap = torch_scheme.codebook_cap(bits_per_sample, max_bits)
    state = torch_scheme.fit_scheme(S_loc, Qy, bits_per_sample, cap)
    tables = torch_scheme.scheme_tables(bits_per_sample, max_bits, x.device)
    rbits = row_bits(bits_per_sample, d, max_bits)
    codes = torch_scheme.encode(state, x, tables)
    words = torch_scheme.pack_codes(codes, state["rates"], total_bits=rbits, mask=mask_l)
    W = words.shape[-1]
    flips = faults is not None and faults.flip_rate > 0.0

    # the wire: the packed words (+ the CRCs under a flip plan) and the rates
    # in one int32 buffer, the O(d^2) fp32 side info in one float32 buffer
    ints = [words.reshape(-1), state["rates"].to(torch.int32)]
    if flips:
        ints.append(torch_scheme.crc_words(words, mask_l).to(torch.int32))
    plane = C.all_gather(torch.cat(ints), group)
    side = C.all_gather(torch.cat([state["T_inv"].reshape(-1), state["T"].reshape(-1),
                                   state["sigma"], mask_l]), group)
    all_words = plane[:, : n_loc * W].reshape(m, n_loc, W)
    all_rates = plane[:, n_loc * W: n_loc * W + d]
    o = 0
    all_Tinv = side[:, o: o + d * d].reshape(m, d, d)
    o += d * d
    all_T = side[:, o: o + d * d].reshape(m, d, d)
    o += d * d
    all_sigma, all_mask = side[:, o: o + d], side[:, o + d:]

    if flips:
        # the bit-flip channel: each sender's transmission takes its own
        # flip mask; every receiver sees the same corrupted plane, checks
        # each row's CRC against the sender's and demotes the failures.
        # Own words never cross the wire
        all_crc = plane[:, n_loc * W + d:].to(torch.int64)
        flip = torch.stack([fault_plane.flip_mask((n_loc, W), faults.flip_rate,
                                                  faults.seed, j) for j in range(m)])
        all_words = all_words ^ flip.to(all_words.device)
        surv = (torch_scheme.crc_words(all_words, all_mask) == all_crc).float()
        own = torch.nn.functional.one_hot(torch.tensor(idx), m).float()[:, None].to(x.device)
        all_mask = all_mask * (surv * (1 - own) + own)

    all_state = {"T": all_T, "T_inv": all_Tinv, "sigma": all_sigma, "rates": all_rates}
    received = torch_scheme.unpack_codes(all_words, all_rates, total_bits=rbits)
    xhat = torch_scheme.decode(all_state, received, tables) * all_mask[..., None]
    view = xhat.clone()
    view[idx] = x
    if not return_state:
        return view

    # each rank's ledger contribution; a rank with no valid row sends
    # (and is charged) nothing, and so does the center in center mode
    n_i = int(mask_l.sum()) if mask is not None else n_loc
    sends = n_i > 0 and not (mode == "center" and idx == center)
    row_payload = W * words.element_size() * 8
    contrib = torch.tensor(
        [int(state["rates"].sum()) * n_i + side_info_bits(d), row_payload * n_i
         + side_info_bits(d), CRC_BITS * n_i] if sends else [0, 0, 0],
        dtype=torch.int64, device=x.device)
    wire_bits, payload_bits, integrity_bits = (int(v) for v in C.all_reduce(contrib, group))
    return view, {
        "codes": all_words, "decoded": xhat, "T": all_T, "T_inv": all_Tinv,
        "sigma": all_sigma, "rates": all_rates, "mask": all_mask,
        "wire_bits": wire_bits, "payload_bits": payload_bits,
        "integrity_bits": integrity_bits,
    }


# codes per packed q_psum row: keeps every row's bit offsets far below the
# 32-bit offsets of the packer, at under ROW_CODES * bits bits of padding
_PSUM_ROW_CODES = 1024


def _q_psum_impl(g, group, bits: int, faults=None):
    flat = g.reshape(-1).float()
    n = flat.shape[0]
    sigma = torch.sqrt(torch.mean(flat * flat) + 1e-30)
    edges = torch.as_tensor(Q.gauss_bin_edges(bits), dtype=torch.float32,
                            device=flat.device) * sigma
    cents = torch.as_tensor(Q.gauss_centroids(bits), dtype=torch.float32, device=flat.device)
    codes = torch.searchsorted(edges, flat)
    # the wire: the tensor as packed rows of uniform bits-wide codes
    k = min(_PSUM_ROW_CODES, n)
    codes = torch.nn.functional.pad(codes, (0, (-n) % k))
    words = torch_scheme.pack_codes(codes.reshape(-1, k), bits)
    all_words = C.all_gather(words, group)
    if faults is not None and faults.flip_rate > 0.0:
        # flips only: gradients carry no CRC framing, a flipped code is more
        # channel noise on an already lossy sum
        all_words = torch.stack([fault_plane.flip_words(w, faults.flip_rate, faults.seed, j)
                                 for j, w in enumerate(all_words)])
    all_sigma = C.all_gather(sigma, group)
    all_codes = torch_scheme.unpack_codes(all_words, bits, num=k).reshape(len(all_words), -1)
    vals = cents[all_codes[:, :n]] * all_sigma[:, None]
    return torch.sum(vals, dim=0).reshape(g.shape).to(g.dtype)


class _QPsum(torch.autograd.Function):
    """Forward: the quantized sum.  Backward: the exact all-reduce of the
    cotangent — every rank's use of the (replicated) sum contributes its
    own cotangent, so the adjoint sums them."""

    @staticmethod
    def forward(ctx, g, group, bits, faults):
        ctx.group = group
        return _q_psum_impl(g, group, bits, faults)

    @staticmethod
    def backward(ctx, ct):
        return C.all_reduce(ct, ctx.group), None, None, None


class _Psum(torch.autograd.Function):
    """The exact all-reduce, differentiable (its backward sums the
    cotangents the same way)."""

    @staticmethod
    def forward(ctx, g, group):
        ctx.group = group
        return C.all_reduce(g, group)

    @staticmethod
    def backward(ctx, ct):
        return C.all_reduce(ct, ctx.group), None


def q_psum(g, group=None, bits: int = 8, faults=None):
    """Quantized all-reduce of a tensor ``g`` (any shape) over ``group``:
    per-rank Gaussian scalar quantization at ``bits`` bits an element,
    gathered, decoded and summed; the error falls as ``bits`` grows.
    ``bits >= 32`` is the exact sum (quantizing at the payload's width buys
    nothing).  Differentiable, straight-through: the backward is the exact
    all-reduce's.  ``faults``: an optional
    :class:`repro_torch.faults.FaultPlan` whose ``flip_rate`` flips bits of
    the gathered code rows (keyed by ``(seed, sender)``)."""
    if bits >= 32:
        return _Psum.apply(g, group)
    return _QPsum.apply(g, group, bits, faults)
