"""Streaming ``update()`` of repro_torch against the reference's, on one
shared checkpoint.

For each configuration the REFERENCE fits once (the same numpy-made
``parts``, the same starting hyperparameters), its ``save_artifact`` writes
the checkpoint, and both packages load that checkpoint, so the frozen
transforms, sigmas and rates are the same numbers on both sides (no
eigenvector-sign difference enters).  Both then apply the same stream of
batches (machine, rows): ``STREAM`` crosses a capacity bucket at its first
batch (the fit is exact-size) and again later, with in-bucket batches
between, and sends one batch to the center (exact, free) or, for poe, to
machine 0's expert.

What is held, and within what:
* integers bitwise: per-machine ``counts``, ``cols``, the three ledgers and
  ``rows_demoted`` after every batch; their increments equal the
  ``comm/accounting.py`` formulas; the re-encoded codes, packed words and
  CRCs at R = 24, d = 8 (no symbol of this data lies within an ulp of a
  bin edge, so both packages' ``X T^T`` round to the same codes);
* fp32 within 1e-5 of each tensor's scale (max(1, max |reference|)):
  every factor (``W``, ``L_M``, ``L``, ``alpha``, ``U``, ``walpha``), the
  decoded rows and the predictions after the stream.  The two packages run
  the same arithmetic through different matmul and triangular-solve
  libraries; on this data the largest difference read was 5.8e-6 of scale
  (``walpha``), the sweep's ``L_M`` 3.1e-7, the predictions 1.8e-6;
* inside the port: a batch split in two across a bucket edge equals the
  batch sent whole (ledgers bitwise, factors 1e-5 of scale), the growth
  counter stays flat in a bucket and rises by exactly one at a crossing,
  the input artifact's tensors are unchanged (``torch.equal``), and a
  streamed artifact's v6 checkpoint loads back bitwise in both packages.
"""
import dataclasses
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_thread  # noqa: E402,F401
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import DGPConfig as RefConfig  # noqa: E402
from repro.core import DistributedGP as RefGP  # noqa: E402
from repro.core import jax_scheme  # noqa: E402
from repro.core import nystrom as ref_nystrom  # noqa: E402
from repro.core.gp import GPParams as RefParams  # noqa: E402
from repro.core.protocols import streaming as ref_streaming  # noqa: E402
from repro.core.protocols.base import update as ref_update  # noqa: E402
from repro_torch.comm.accounting import (  # noqa: E402
    CRC_BITS, payload_row_bits, row_bits,
)
from repro_torch.core import DGPConfig, DistributedGP  # noqa: E402
from repro_torch.core import nystrom  # noqa: E402
from repro_torch.core import torch_scheme as TS  # noqa: E402
from repro_torch.core.protocols import streaming  # noqa: E402
from repro_torch.core.protocols.base import (  # noqa: E402
    artifact_arrays, load_artifact, predict, update, update_growth_count,
)
from repro_torch.core.protocols.wire import _per_symbol_reencode  # noqa: E402


M, D, N_PER, BITS = 4, 8, 24, 24  # 96 points over 4 machines; R = 24, d = 8
START = (0.2, -0.3, -1.5)
STREAM = ((1, 6), (0, 4), (2, 7), (3, 20))  # (machine, rows)
TOL = 1e-5
CONFIGS = {
    "center": dict(),
    "center_direct": dict(gram_mode="direct"),
    "center_fitc": dict(gram_mode="nystrom_fitc"),
    "center_pallas": dict(gram_backend="pallas"),
    "broadcast": dict(protocol="broadcast"),
    "broadcast_pallas": dict(protocol="broadcast", gram_backend="pallas"),
    "poe": dict(protocol="poe", fusion="rbcm"),
}
TRANSMITTING = [k for k in CONFIGS if not k.startswith("poe")]


def _problem():
    rng = np.random.default_rng(0)
    A = rng.normal(size=(D, D)) / np.sqrt(D)
    X = (rng.normal(size=(M * N_PER, D)) @ A.T).astype(np.float32)
    y = (np.sin(2.0 * X[:, 0]) + 0.5 * X[:, 1]).astype(np.float32)
    parts = [(X[j::M], y[j::M]) for j in range(M)]
    rs = np.random.default_rng(5)
    batches = []
    for j, n in STREAM:
        Xn = (rs.normal(size=(n, D)) @ A.T).astype(np.float32)
        batches.append((j, Xn, (np.sin(2.0 * Xn[:, 0]) + 0.5 * Xn[:, 1]).astype(np.float32)))
    Xq = (rs.normal(size=(16, D)) @ A.T).astype(np.float32)
    return parts, batches, Xq


PARTS, BATCHES, XQ = _problem()


def _close(got, want, rel=TOL, msg=""):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rel, atol=rel * max(1.0, np.abs(want).max()),
                               err_msg=msg)


def _tensors(art):
    """Every tensor of an artifact, keyed as in its checkpoint."""
    return {k: torch.from_numpy(v) for k, v in artifact_arrays(art).items()}


def _shared_checkpoint(kind, directory):
    """(reference artifact, port artifact): fitted by the reference, written
    by its save_artifact and loaded by both packages."""
    cfg = CONFIGS[kind]
    start = RefParams(*(jnp.float32(v) for v in START))
    ref = RefGP(RefConfig(steps=0, bits_per_sample=BITS, **cfg)).fit(parts=PARTS, params=start)
    RefGP(ref.config).save(ref, directory)
    return RefGP.load(directory), load_artifact(directory, device="cpu")


@pytest.fixture(scope="module")
def streams(tmp_path_factory):
    """{kind: [(reference artifact, port artifact, growths, input unchanged)]}
    after the fit (entry 0) and after each batch of STREAM."""
    out = {}
    for kind in CONFIGS:
        ref, art = _shared_checkpoint(kind, str(tmp_path_factory.mktemp(kind)))
        states = [(ref, art, 0, True)]
        for j, Xn, yn in BATCHES:
            before = _tensors(art)
            g0 = update_growth_count(art.protocol)
            new = update(art, Xn, yn, machine=j)
            growths = update_growth_count(art.protocol) - g0
            after = _tensors(art)
            unchanged = all(torch.equal(before[k], after[k]) for k in before)
            ref = ref_update(ref, Xn, yn, machine=j)
            art = new
            states.append((ref, art, growths, unchanged))
        out[kind] = states
    return out


@pytest.mark.parametrize("kind", list(CONFIGS))
def test_counts_cols_and_ledgers_bitwise(streams, kind):
    for step, (ref, art, _, _) in enumerate(streams[kind]):
        for field in ("counts", "cols", "wire_bits", "payload_bits", "integrity_bits",
                      "rows_demoted"):
            np.testing.assert_array_equal(getattr(art.stream, field).numpy(),
                                          np.asarray(getattr(ref.stream, field)),
                                          err_msg=f"{kind} step {step} {field}")


@pytest.mark.parametrize("kind", list(CONFIGS))
def test_ledger_increments_match_accounting_formulas(streams, kind):
    states = streams[kind]
    art0 = states[0][1]
    fitc = art0.gram_mode == "nystrom_fitc"
    for (j, Xn, _), (_, prev, _, _), (_, art, _, _) in zip(BATCHES, states, states[1:]):
        n = Xn.shape[0]
        sends = art0.protocol != "poe" and not (art0.protocol == "center" and j == 0)
        rate = int(art0.wire.rates[j].sum()) if sends else 0
        side = 32 * n if (sends and fitc) else 0
        want = (rate * n + side,
                (payload_row_bits(BITS, D, art0.max_bits) * n + side) if sends else 0,
                CRC_BITS * n if sends else 0)
        got = (art.wire_bits - prev.wire_bits, art.payload_bits - prev.payload_bits,
               art.integrity_bits - prev.integrity_bits)
        assert got == want, (kind, j)
        assert art.lengths[j] - prev.lengths[j] == n
        assert int(art.stream.cols) - int(prev.stream.cols) == n


@pytest.mark.parametrize("kind", list(CONFIGS))
def test_factors_data_and_predictions(streams, kind):
    for step, (ref, art, _, _) in enumerate(streams[kind]):
        assert sorted(art.factors) == sorted(ref.factors)
        assert tuple(art.y.shape) == tuple(ref.y.shape)
        np.testing.assert_array_equal(art.y.numpy(), np.asarray(ref.y))
        for k in ref.factors:
            _close(art.factors[k].numpy(), ref.factors[k], msg=f"{kind} step {step} {k}")
        for k in ref.data:
            _close(art.data[k].numpy(), ref.data[k], msg=f"{kind} step {step} data {k}")
    ref, art = streams[kind][-1][:2]
    rmu, rvar = RefGP(ref.config).predict(ref, XQ)
    mu, var = predict(art, XQ)
    _close(mu.numpy(), rmu)
    _close(var.numpy(), rvar)


@pytest.mark.parametrize("kind", TRANSMITTING)
def test_reencoded_codes_words_and_crc_bitwise(streams, kind):
    """The port's re-encode against the reference's wire functions on the
    same frozen state (what the reference's update runs inside its
    program): codes, words and CRCs bitwise, the decoded rows within TOL."""
    ref, art = streams[kind][0][:2]
    rw = ref.wire
    rbits = row_bits(BITS, D, art.max_bits)
    tables = jax_scheme.scheme_tables(BITS, art.max_bits)
    for j, Xn, _ in BATCHES:
        if art.protocol == "center" and j == 0:
            continue  # the center's own rows never cross the wire
        state = {"T": rw.T[j], "T_inv": rw.T_inv[j], "sigma": rw.sigma[j],
                 "rates": rw.rates[j]}
        codes = jax_scheme.encode(state, jnp.asarray(Xn), tables)
        words = jax_scheme.pack_codes(codes, state["rates"], total_bits=rbits)
        got = _per_symbol_reencode(art, j, torch.from_numpy(Xn))
        np.testing.assert_array_equal(got.words.numpy(), np.asarray(words).view(np.int32))
        np.testing.assert_array_equal(
            TS.unpack_codes(got.words, art.wire.rates[j], total_bits=rbits).numpy(),
            np.asarray(codes))
        np.testing.assert_array_equal(got.crc.numpy(), np.asarray(jax_scheme.crc_words(words)))
        _close(got.decoded.numpy(), jax_scheme.decode(state, codes, tables))
        assert (got.wire_bits, got.payload_bits, got.integrity_bits) == (
            int(np.asarray(state["rates"]).sum()) * Xn.shape[0],
            payload_row_bits(BITS, D, art.max_bits) * Xn.shape[0], CRC_BITS * Xn.shape[0])


@pytest.mark.parametrize("kind", list(CONFIGS))
def test_growth_counter_flat_in_a_bucket_and_one_at_a_crossing(streams, kind):
    states = streams[kind]
    for (_, prev, _, _), (_, art, growths, _) in zip(states, states[1:]):
        crossed = int(art.y.shape[-1]) != int(prev.y.shape[-1])
        assert growths == int(crossed)
        assert int(art.y.shape[-1]) == (streaming.next_pow2(int(art.stream.cols)) if crossed
                                        else int(prev.y.shape[-1]))
    assert sum(s[2] for s in states) == 2  # STREAM crosses two edges in every layout


@pytest.mark.parametrize("kind", list(CONFIGS))
def test_input_artifact_is_unchanged(streams, kind):
    assert all(s[3] for s in streams[kind][1:])


@pytest.mark.parametrize("kind", ["center", "center_direct", "center_fitc", "broadcast",
                                  "poe"])
def test_chunk_split_across_a_bucket_edge_equals_one_batch(streams, kind):
    """From the last state (cols 133, capacity 256; poe cols 61, capacity
    64) a batch that ends past the edge, whole and split at the edge."""
    ref, art = streams[kind][-1][:2]
    cap, cols = int(art.y.shape[-1]), int(art.stream.cols)
    rng = np.random.default_rng(9)
    n = cap - cols + 3
    Xn = rng.normal(size=(n, D)).astype(np.float32)
    yn = rng.normal(size=n).astype(np.float32)
    whole = update(art, Xn, yn, machine=1)
    k = cap - cols
    g0 = update_growth_count(art.protocol)
    half = update(art, Xn[:k], yn[:k], machine=1)
    assert update_growth_count(art.protocol) == g0  # fills the bucket exactly
    split = update(half, Xn[k:], yn[k:], machine=1)
    assert update_growth_count(art.protocol) == g0 + 1
    for field in ("counts", "cols", "wire_bits", "payload_bits", "integrity_bits"):
        assert torch.equal(getattr(split.stream, field), getattr(whole.stream, field))
    for key in whole.factors:
        _close(split.factors[key].numpy(), whole.factors[key].numpy(), msg=key)
    for a, b in zip(predict(split, XQ), predict(whole, XQ)):
        _close(a.numpy(), b.numpy())
    rwhole = ref_update(ref, Xn, yn, machine=1)
    for a, b in zip(predict(whole, XQ), RefGP(ref.config).predict(rwhole, XQ)):
        _close(a.numpy(), b)


def test_refusals(streams):
    _, art = streams["center"][0][:2]
    with pytest.raises(ValueError, match="transmitted no rows at fit time"):
        update(dataclasses.replace(art, fit_lengths=(24, 24, 0, 24)), XQ[:2], XQ[:2, 0],
               machine=2)
    with pytest.raises(ValueError, match="out of range"):
        update(art, XQ[:2], XQ[:2, 0], machine=M)
    with pytest.raises(ValueError, match="update expects"):
        update(art, XQ[:2], XQ[:3, 0], machine=1)
    parts = PARTS
    for cfg in (DGPConfig(gram_mode="direct", gram_backend="pallas", steps=0),
                DGPConfig(gram_mode="nystrom_fitc", gram_backend="pallas", steps=0)):
        est = DistributedGP(cfg, device="cpu")
        with pytest.raises(NotImplementedError, match='supports gram_mode="nystrom" only'):
            est.update(est.fit(parts=parts), XQ[:2], XQ[:2, 0], machine=1)
    est = DistributedGP(DGPConfig(protocol="broadcast", gram_mode="direct", steps=0),
                        device="cpu")
    with pytest.raises(NotImplementedError, match='gram_mode="nystrom" only'):
        est.update(est.fit(parts=parts), XQ[:2], XQ[:2, 0], machine=1)
    host = DistributedGP(DGPConfig(impl="host", steps=0), device="cpu").fit(parts=parts)
    with pytest.raises(TypeError, match="FittedProtocol"):
        DistributedGP(device="cpu").update(host, XQ[:2], XQ[:2, 0])


@pytest.mark.parametrize("kind", ["center", "broadcast", "poe"])
def test_nonfinite_rows_are_dropped_with_a_warning(streams, kind):
    ref, art = streams[kind][1][:2]
    Xn = np.array(BATCHES[2][1])
    yn = np.array(BATCHES[2][2])
    Xn[1, 3], yn[4] = np.nan, np.inf
    keep = np.isfinite(Xn).all(1) & np.isfinite(yn)
    with pytest.warns(UserWarning, match="dropping 2 non-finite point"):
        got = update(art, Xn, yn, machine=2)
    want = update(art, Xn[keep], yn[keep], machine=2)
    for a, b in zip(_tensors(got).values(), _tensors(want).values()):
        assert torch.equal(a, b)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        rgot = ref_update(ref, Xn, yn, machine=2)
    assert got.lengths == rgot.lengths and got.wire_bits == rgot.wire_bits
    with pytest.warns(UserWarning, match="dropping 2 non-finite"):
        assert update(art, np.full((2, D), np.nan, np.float32), yn[:2], machine=2) is art
    assert update(art, np.zeros((0, D), np.float32), np.zeros(0, np.float32), 2) is art


@pytest.mark.parametrize("kind", list(CONFIGS))
def test_v6_roundtrip_after_streaming_is_bitwise(streams, kind, tmp_path):
    """The streamed artifact's checkpoint loads back bitwise in the port and
    in the reference (the same npz arrays), serves the same answers, and a
    further update continues the stream as it would have before the save."""
    _, art = streams[kind][-1][:2]
    est = DistributedGP(art.config, device="cpu")
    est.save(art, str(tmp_path))
    back = est.load(str(tmp_path))
    want = artifact_arrays(art)
    got = artifact_arrays(back)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for a, b in zip(est.predict(back, XQ), est.predict(art, XQ)):
        assert torch.equal(a, b)
    ref_back = RefGP.load(str(tmp_path))
    assert ref_back.lengths == art.lengths and ref_back.wire_bits == art.wire_bits
    for a, b in zip(est.predict(art, XQ), RefGP(ref_back.config).predict(ref_back, XQ)):
        _close(a.numpy(), b)
    j, Xn, yn = BATCHES[0]
    more, more_back = update(art, Xn, yn, machine=j), update(back, Xn, yn, machine=j)
    assert int(more_back.stream.cols) == int(art.stream.cols) + Xn.shape[0]
    for a, b in zip(_tensors(more_back).values(), _tensors(more).values()):
        assert torch.equal(a, b)


def test_growth_table_is_the_reference_s():
    """Which buffers grow, and how, key by key (the fused serve's
    ``Ainv``/``U``/``walpha`` are K-sized and in neither table)."""
    ref = {p: {g: {k: f.__name__ for k, f in t.items()} for g, t in spec.items()}
           for p, spec in ref_streaming._GROWTH.items()}
    got = {p: {g: {k: f.__name__ for k, f in t.items()} for g, t in spec.items()}
           for p, spec in streaming._GROWTH.items()}
    assert got == ref
    assert not {"Ainv", "U", "walpha"} & {k for spec in got.values() for k in spec["factors"]}


def test_padded_factor_has_the_identity_pattern_and_append_at_is_exact():
    """``_pad_chol``'s new slots are the identity pattern, and
    ``chol_append_at`` on the padded factor writes ``chol_append``'s rows,
    leaving every other padded slot in that pattern."""
    rng = np.random.default_rng(4)
    n, k, cap = 7, 3, 16
    A = rng.normal(size=(n + k, n + k + 4))
    S = torch.from_numpy((A @ A.T / (n + k)).astype(np.float32))
    L = torch.linalg.cholesky(S[:n, :n])
    Lp = streaming._pad_chol(L, cap)
    assert torch.equal(Lp[:n, :n], L)
    assert torch.equal(Lp[n:, n:], torch.eye(cap - n))
    assert not Lp[:n, n:].any() and not Lp[n:, :n].any()
    C_on = torch.zeros(cap, k)
    C_on[:n] = S[:n, n:]
    out = nystrom.chol_append_at(Lp, C_on, S[n:, n:], n)
    want = nystrom.chol_append(L, S[:n, n:], S[n:, n:])
    _close(out[: n + k, : n + k].numpy(), want.numpy(), 1e-6)
    assert torch.equal(out[:n], Lp[:n]) and not out[n:n + k, n + k:].any()
    assert torch.equal(out[n + k:, n + k:], torch.eye(cap - n - k))
    _close((out[: n + k, : n + k] @ out[: n + k, : n + k].T).numpy(), S.numpy(), 1e-5)
    rows = np.asarray(ref_nystrom.chol_append_at(jnp.asarray(Lp.numpy()),
                                                 jnp.asarray(C_on.numpy()),
                                                 jnp.asarray(S[n:, n:].numpy()), n))
    _close(out.numpy(), rows)


def test_rank_k_sweep_against_the_reference_and_a_refactorization():
    """The batched Givens sweep: one call over a leading machine axis
    equals the per-matrix calls bitwise, the reference's sweep within TOL,
    and the Cholesky of L L^T + V V^T (float64) within TOL."""
    rng = np.random.default_rng(6)
    m, K, n_new = 5, 9, 4
    A = rng.normal(size=(m, K, 2 * K))
    L = torch.linalg.cholesky(torch.from_numpy((A @ A.transpose(0, 2, 1) / K)
                                               .astype(np.float32)))
    V = torch.from_numpy(rng.normal(size=(m, K, n_new)).astype(np.float32))
    L_in, V_in = L.clone(), V.clone()
    got = nystrom.chol_update_rank(L, V)
    assert torch.equal(L, L_in) and torch.equal(V, V_in)  # inputs untouched
    for i in range(m):
        assert torch.equal(nystrom.chol_update_rank(L[i], V[i]), got[i])
        want = ref_nystrom.chol_update_rank(jnp.asarray(L[i].numpy()), jnp.asarray(V[i].numpy()))
        _close(got[i].numpy(), want)
    L64, V64 = L.double(), V.double()
    exact = torch.linalg.cholesky(L64 @ L64.mT + V64 @ V64.mT)
    _close(got.double().numpy(), exact.numpy())
    one = nystrom.chol_update(L[0], V[0, :, 0])
    _close(one.numpy(), ref_nystrom.chol_update(jnp.asarray(L[0].numpy()),
                                                jnp.asarray(V[0, :, 0].numpy())))
