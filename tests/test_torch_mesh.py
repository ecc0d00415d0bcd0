"""``impl="mesh"`` of the port on spawned gloo ranks (one per machine),
held against the port's own batched and host impls on identical numpy
parts — the counterparts of the mesh tests of tests/test_conformance.py
(:111, 136, 155, 170, 206, 311, 323, 349, 411, 449) and of
tests/test_mesh_gp.py.  tests/test_torch_mesh_ref.py holds the mesh
against the reference's mesh.

One pool of 8 CPU ranks serves the file; a case at m machines runs on
ranks 0..m-1.

Tolerances and why:
* ledgers, lengths, rates, words: integer-equal to the batched impl and to
  the accounting formulas;
* the wire's reconstructions and a center fit: bit for bit against the
  batched impl (every rank sums the moments in machine order; the center
  runs the batched fit's own tail), asserted as 1e-6 of scale;
* poe answers, and broadcast answers from fixed hypers: 1e-5 of the
  output's scale against the batched impl — the same fp32 algebra, but the
  fusion is one all-reduce of moment rows, not a sum over a stacked axis;
* broadcast answers after training: 2e-4 of scale, as
  tests/test_torch_broadcast.py holds trained fits — machine 0 trains on
  its own matmuls (X_0 X^T, as the reference's mesh does), which round
  apart from the batched impl's batched products, and ten Adam steps carry
  that forward (the linear kernel reads 3.3e-5);
* against the float64 host oracle's wire: 5e-4, as the reference holds
  its mesh;
* a checkpoint reloaded single-process: 1e-5 of scale (the same factors,
  served by the batched path);
* every rank's answer, and a rank whose peers' parts are NaN: the same
  bits (the collectives are the only channel between machines).
"""
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_thread  # noqa: E402,F401
from _torch_mesh import (  # noqa: E402
    batch_slices, batcher_default_device, fit_predict, fit_predict_poisoned, fit_stream, mesh_pool, one_shot, quantize,
    rank_leaks, serve_structure,
)

from repro_torch.analysis.contracts import CollectiveBudget, _CheckContext  # noqa: E402
from repro_torch.comm.accounting import (  # noqa: E402
    integrity_bits_formula, payload_bits_formula, side_info_bits, wire_bits_formula,
)
from repro_torch.core import DGPConfig, DistributedGP, GPParams, train_gp  # noqa: E402
from repro_torch.core.protocols import mesh  # noqa: E402
from repro_torch.core.protocols.center import quantize_to_center  # noqa: E402
from repro_torch.faults import corrupt_words, drop_machine, nan_shard  # noqa: E402

pool = mesh_pool(8)
START = (0.2, -0.3, -1.5)
TRAINED = 2e-4  # trained broadcast answers, mesh against batched (see above)


def _ragged_parts(lengths, d, seed=0, n_test=24):
    rng = np.random.default_rng(seed)
    W = rng.normal(size=(d, 2))
    f = lambda Z: np.sin(Z @ W[:, 0]) + 0.4 * (Z @ W[:, 1])
    parts = []
    for n_j in lengths:
        Xj = rng.normal(size=(n_j, d)).astype(np.float32)
        parts.append((Xj, (f(Xj) + 0.05 * rng.normal(size=n_j)).astype(np.float32)))
    return parts, rng.normal(size=(n_test, d)).astype(np.float32)


def _problem(seed=0, n=180, d=6, m=4, n_test=30):
    rng = np.random.default_rng(seed)
    W = rng.normal(size=(d, 2))
    X = rng.normal(size=(n, d)).astype(np.float32)
    y = (np.sin(X @ W[:, 0]) + 0.4 * (X @ W[:, 1]) + 0.05 * rng.normal(size=n)).astype(np.float32)
    parts = [(X[c], y[c]) for c in np.array_split(rng.permutation(n), m)]
    return parts, rng.normal(size=(n_test, d)).astype(np.float32)


def _close(got, want, rel):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rel, atol=rel * max(1.0, np.abs(want).max()))


def _batched(cfg, parts, X_q, start=START, available=None):
    est = DistributedGP(DGPConfig(**cfg), device="cpu")
    params = GPParams(*(torch.tensor(v, dtype=torch.float32) for v in start))
    art = est.fit(parts=parts, params=params)
    out = [a.numpy() for a in est.predict(art, X_q)]
    if available is not None:
        out += [a.numpy() for a in est.predict(art, X_q, available=available)]
    return art, out


def _ledgers(x):
    get = (lambda k: x[k]) if isinstance(x, dict) else (lambda k: getattr(x, k))
    return tuple(int(get(k)) for k in ("wire_bits", "payload_bits", "integrity_bits"))


# --------------------------------------------------------------------------
# wire level: quantize_to_center
# --------------------------------------------------------------------------

WIRE_CASES = [((37, 41, 29, 43), 6, 16), ((12, 30, 18), 4, 1), ((25, 25, 25, 25, 20), 5, 32)]


@pytest.mark.parametrize("lengths,d,bits", WIRE_CASES)
def test_quantize_to_center_mesh_batched_host(pool, lengths, d, bits):
    parts, _ = _ragged_parts(lengths, d, seed=sum(lengths) + d + bits)
    outs = pool.run(quantize, parts, bits, world=len(parts))
    Xh, yh, wh, nch, _ = quantize_to_center(parts, bits, impl="host", device="cpu")
    Xb, yb, wb, ncb, sqb = quantize_to_center(parts, bits, impl="batched", device="cpu")
    for o in outs:  # the center's assembly reaches every rank
        assert o["wire_bits"] == wb == wh and o["n_center"] == ncb == nch
        np.testing.assert_array_equal(o["y"], yb.numpy())
        _close(o["X"], Xb.numpy(), 1e-6)
        np.testing.assert_array_equal(o["sq"], sqb.numpy())
        np.testing.assert_allclose(o["X"], Xh.numpy(), atol=5e-4)


# fixed cases in place of the reference's hypothesis sweep of m, ragged
# shard sizes, d and bits (tests/test_conformance.py:411)
HYP_CASES = [((8, 16), 2, 1, 11), ((9, 13, 16), 3, 4, 12), ((16, 8, 12, 10), 4, 8, 13),
             ((12, 12), 4, 32, 14), ((10, 15, 9), 2, 32, 15)]


@pytest.mark.parametrize("lengths,d,bits,seed", HYP_CASES)
def test_hyp_wire_ledger_mesh(pool, lengths, d, bits, seed):
    parts, _ = _ragged_parts(lengths, d, seed=seed)
    o = pool.run(quantize, parts, bits, world=len(parts))[0]
    _, _, wh, _, _ = quantize_to_center(parts, bits, impl="host", device="cpu")
    Xb, _, wb, _, _ = quantize_to_center(parts, bits, impl="batched", device="cpu")
    assert o["wire_bits"] == wh == wb
    _close(o["X"], Xb.numpy(), 1e-6)


# --------------------------------------------------------------------------
# protocol level: fit + predict, mesh against batched
# --------------------------------------------------------------------------


@pytest.mark.parametrize("kernel", ["se", "linear"])
def test_center_protocol_mesh(pool, kernel):
    parts, Xt = _ragged_parts((31, 44, 27, 38), 6, seed=1)
    cfg = dict(bits_per_sample=16, kernel=kernel, steps=10)
    o = pool.run(fit_predict, cfg, parts, Xt, START, world=4)[0]
    art, (mu, var) = _batched(cfg, parts, Xt)
    assert _ledgers(o) == _ledgers(art) and o["impl"] == "mesh"
    _close(o["mu"], mu, 1e-6)
    _close(o["var"], var, 1e-6)


BROADCAST_CASES = [("se", "kl"), ("linear", "kl"), ("se", "rbcm")]


@pytest.mark.parametrize("kernel,fuse", BROADCAST_CASES)
def test_broadcast_protocol_mesh(pool, kernel, fuse):
    parts, Xt = _ragged_parts((33, 41, 28, 36), 6, seed=2)
    down = np.array([1, 0, 1, 1], np.float32)
    cfg = dict(protocol="broadcast", bits_per_sample=24, kernel=kernel, fusion=fuse, steps=10)
    o = pool.run(fit_predict, cfg, parts, Xt, START, down, world=4)[0]
    art, (mu, var, mu_d, var_d) = _batched(cfg, parts, Xt, available=down)
    assert _ledgers(o) == _ledgers(art)
    np.testing.assert_array_equal(o["rates"], art.wire.rates.numpy())
    for got, want in ((o["mu"], mu), (o["var"], var), (o["mu_d"], mu_d), (o["var_d"], var_d)):
        _close(got, want, TRAINED)
    assert np.all(o["var"] > 0)


@pytest.mark.parametrize("method", ["rbcm", "poe"])
def test_poe_mesh(pool, method):
    parts, Xt = _ragged_parts((26, 35, 30, 24), 5, seed=3)
    down = np.array([1, 1, 1, 0], np.float32)
    cfg = dict(protocol="poe", fusion=method, bits_per_sample=0, steps=10)
    o = pool.run(fit_predict, cfg, parts, Xt, START, down, world=4)[0]
    art, outs = _batched(cfg, parts, Xt, available=down)
    assert _ledgers(o) == (0, 0, 0)
    for got, want in zip((o["mu"], o["var"], o["mu_d"], o["var_d"]), outs):
        _close(got, want, 1e-5)


# --------------------------------------------------------------------------
# physical equals ledger; the machines' factors; checkpoints
# --------------------------------------------------------------------------


@pytest.mark.parametrize("protocol", ["center", "broadcast", "poe"])
def test_payload_equals_ledger_mesh(pool, protocol):
    """The mesh's three ledgers are the batched impl's and the accounting
    formulas; its word plane is the batched one."""
    parts, Xt = _ragged_parts((29, 37, 23, 31), 6, seed=11)
    bits = 0 if protocol == "poe" else 19
    cfg = dict(protocol=protocol, bits_per_sample=bits, steps=2,
               fusion="rbcm" if protocol == "poe" else "kl")
    o = pool.run(fit_predict, cfg, parts, Xt, START, world=4)[0]
    art, _ = _batched(cfg, parts, Xt)
    assert _ledgers(o) == _ledgers(art)
    if protocol == "poe":
        assert _ledgers(o) == (0, 0, 0)
        return
    skip = 0 if protocol == "center" else None
    lengths = [p[0].shape[0] for p in parts]
    assert o["wire_bits"] == wire_bits_formula(o["rates"], lengths, 6, skip=skip)
    assert o["payload_bits"] == payload_bits_formula(lengths, 6, bits, art.max_bits, skip=skip)
    assert o["integrity_bits"] == integrity_bits_formula(lengths, skip=skip)
    np.testing.assert_array_equal(o["codes"], art.wire.codes.numpy())


def test_mesh_factors_live_one_machine_per_rank(pool):
    """Broadcast and poe: rank i holds machine i's factors and data (a
    leading axis of 1), the batched artifact's row i; the center artifact
    is whole on every rank."""
    parts, Xt = _problem(seed=4, m=4)
    for cfg in (dict(protocol="broadcast", bits_per_sample=24, steps=4),
                dict(protocol="poe", fusion="rbcm", bits_per_sample=0, steps=4)):
        outs = pool.run(fit_predict, cfg, parts, Xt, START, factors=True, world=4)
        art, _ = _batched(cfg, parts, Xt)
        for i, o in enumerate(outs):
            for group in ("factors", "data"):
                for k, v in getattr(art, group).items():
                    assert o[group][k].shape == (1,) + tuple(v.shape[1:])
                    _close(o[group][k][0], v[i].numpy(), 1e-5)
    outs = pool.run(fit_predict, dict(bits_per_sample=20, steps=4), parts, Xt, START,
                    factors=True, world=4)
    for o in outs:
        assert o["factors"]["L_KK"].shape[0] == o["fit_lengths"][0]


@pytest.mark.parametrize("protocol", ["center", "broadcast", "poe"])
def test_mesh_artifact_roundtrips_single_process(pool, protocol):
    """Saved by the ranks (rank 0 writes the gathered factors), a mesh
    checkpoint loads as an ``impl="batched"`` artifact with the mesh's
    integers that serves the mesh's answers."""
    parts, Xt = _problem(seed=5, m=4)
    bits = 0 if protocol == "poe" else 20
    cfg = dict(protocol=protocol, bits_per_sample=bits, steps=6,
               fusion="rbcm" if protocol == "poe" else "kl")
    with tempfile.TemporaryDirectory() as d:
        outs = pool.run(fit_predict, cfg, parts, Xt, START, None, d, world=4)
        assert len({o["path"] for o in outs}) == 1
        art = DistributedGP(device="cpu").load(d)
    o = outs[0]
    assert art.impl == "batched" and art.lengths == tuple(o["lengths"])
    assert _ledgers(art) == _ledgers(o)
    mu, var = art.predict(Xt)
    _close(mu.numpy(), o["mu"], 1e-5)
    _close(var.numpy(), o["var"], 1e-5)


# --------------------------------------------------------------------------
# serving structure, ranks, the only channel
# --------------------------------------------------------------------------


@pytest.mark.parametrize("protocol", ["broadcast", "poe"])
def test_warm_mesh_predict_runs_one_collective_and_no_factorization(pool, protocol):
    parts, Xt = _problem(seed=6, m=4)
    cfg = dict(protocol=protocol, bits_per_sample=0 if protocol == "poe" else 24, steps=4,
               fusion="rbcm" if protocol == "poe" else "kl")
    for o in pool.run(serve_structure, cfg, parts, Xt, START, world=4):
        assert o["ok"], o["findings"]
        assert o["contract"] == "mesh-serve"
        assert o["factorizations"] == {"cholesky": 0, "eigh": 0}
        assert o["op_counts"]["cholesky"] == o["op_counts"]["eigh"] == 0
        assert list(o["collectives"]) == ["c10d.allreduce_"]
        assert o["collectives"]["c10d.allreduce_"]["count"] == 1
        assert o["collectives"]["c10d.allreduce_"]["bytes"] == 3 * Xt.shape[0] * 4


@pytest.mark.parametrize("protocol", ["center", "broadcast", "poe"])
def test_every_rank_answers_the_same_bits(pool, protocol):
    parts, Xt = _problem(seed=7, m=5)
    cfg = dict(protocol=protocol, bits_per_sample=0 if protocol == "poe" else 24, steps=3,
               fusion="rbcm" if protocol == "poe" else "kl")
    outs = pool.run(fit_predict, cfg, parts, Xt, START, np.ones(5, np.float32), world=5)
    for o in outs[1:]:
        for k in ("mu", "var", "mu_d", "var_d", "params"):
            np.testing.assert_array_equal(o[k], outs[0][k])
        assert _ledgers(o) == _ledgers(outs[0])


@pytest.mark.parametrize("protocol,plan", [
    ("center", None), ("broadcast", None), ("poe", None),
    ("broadcast", drop_machine(3) | nan_shard(1) | corrupt_words(0.01, seed=2)),
], ids=["center", "broadcast", "poe", "broadcast-faults"])
def test_peers_reach_a_rank_only_through_the_collectives(pool, protocol, plan):
    """Every rank given NaN in place of every peer's part answers with the
    same bits as with the real parts — under a fault plan too, whose data
    faults each rank applies to its own part."""
    parts, Xt = _problem(seed=8, m=4)
    cfg = dict(protocol=protocol, bits_per_sample=0 if protocol == "poe" else 24, steps=3,
               fusion="rbcm" if protocol == "poe" else "kl", faults=plan)
    clean = pool.run(fit_predict, cfg, parts, Xt, START, world=4)
    blind = pool.run(fit_predict_poisoned, cfg, parts, Xt, START, world=4)
    for c, b in zip(clean, blind):
        np.testing.assert_array_equal(b["mu"], c["mu"])
        np.testing.assert_array_equal(b["var"], c["var"])
        assert _ledgers(b) == _ledgers(c)
    art, _ = _batched(cfg, parts, Xt)
    assert _ledgers(clean[0]) == _ledgers(art) and clean[0]["rows_demoted"] == art.rows_demoted
    assert tuple(clean[0]["fit_lengths"]) == art.fit_lengths


def test_no_sharding_leak_reads_every_rank(pool):
    """Outside factors/ and data/, a leaf that differs between ranks or
    holds one machine's row is a leak, on every rank; the fit has none."""
    parts, Xt = _problem(seed=10, m=4)
    outs = pool.run(rank_leaks, dict(protocol="broadcast", bits_per_sample=24, steps=0),
                    parts, Xt, world=4)
    for o in outs:
        assert o["clean"] == []
        assert o["differs"] == [("y", "differs between ranks")]
        assert sorted(o["sliced"]) == [("wire/sigma", "differs between ranks"),
                                       ("wire/sigma", "holds one machine's slice")]
        assert o["findings"] == [("mesh-serve", "no-sharding-leak")]


def test_collective_budget_counts_ops_and_bytes():
    ops = {"c10d.allreduce_": 2, "c10d.allreduce_/bytes": 1536, "mm": 3}
    ctx = _CheckContext(ops=ops)
    assert CollectiveBudget(max_count=2, max_bytes=1536).check(ctx) == []
    found = CollectiveBudget(max_count=1, max_bytes=1000).check(ctx)
    assert len(found) == 2 and "2 collective ops" in found[0] and "1536 B" in found[1]


# --------------------------------------------------------------------------
# streaming
# --------------------------------------------------------------------------


def _batches(d, plan=((1, 6), (3, 4), (1, 5), (2, 7)), seed=1):
    rng = np.random.default_rng(seed)
    return [(j, rng.normal(size=(n, d)).astype(np.float32),
             rng.normal(size=n).astype(np.float32)) for j, n in plan]


def test_streamed_ledgers_integer_equal_formula_batched_mesh(pool):
    """After one streamed sequence the three ledgers of the mesh equal the
    batched impl's and the formulas (frozen rate a row, whole words, CRC
    framing, no new side info)."""
    parts, Xt = _problem(seed=21, m=4)
    d = parts[0][0].shape[1]
    batches = _batches(d)
    cfg = dict(protocol="broadcast", bits_per_sample=20, steps=3)
    o = pool.run(fit_stream, cfg, parts, Xt, batches, START, world=4)[0]
    art, _ = _batched(cfg, parts, Xt)
    rates = art.wire.rates.numpy()
    exp = list(_ledgers(art))
    for (j, Xn, yn), step in zip(batches, o["steps"]):
        art = art.update(Xn, yn, machine=j)
        L = [Xn.shape[0] if q == j else 0 for q in range(4)]
        exp[0] += wire_bits_formula(rates, L, d) - side_info_bits(d)
        exp[1] += payload_bits_formula(L, d, 20, art.max_bits) - side_info_bits(d)
        exp[2] += integrity_bits_formula(L)
        assert _ledgers(step) == tuple(exp) == _ledgers(art)
        assert tuple(step["lengths"]) == art.lengths
    mu, var = art.predict(Xt)
    _close(o["mu"], mu.numpy(), TRAINED)
    _close(o["var"], var.numpy(), TRAINED)


@pytest.mark.parametrize("cfg", [
    dict(protocol="center", bits_per_sample=24),
    dict(protocol="center", bits_per_sample=24, gram_mode="nystrom_fitc"),
    dict(protocol="center", bits_per_sample=24, gram_mode="direct"),
    dict(protocol="poe", fusion="rbcm", bits_per_sample=0),
], ids=["center", "center-fitc", "center-direct", "poe"])
def test_mesh_stream_matches_batched(pool, cfg):
    """The same stream (a bucket crossing included) into the mesh and the
    batched artifact: the same integers after every batch, the same
    answers."""
    parts, Xt = _problem(seed=22, m=4)
    batches = _batches(parts[0][0].shape[1], plan=((1, 6), (0, 5), (3, 60)))
    cfg = dict(steps=3, **cfg)
    o = pool.run(fit_stream, cfg, parts, Xt, batches, START, world=4)[0]
    art, _ = _batched(cfg, parts, Xt)
    for (j, Xn, yn), step in zip(batches, o["steps"]):
        art = art.update(Xn, yn, machine=j)
        assert _ledgers(step) == _ledgers(art) and tuple(step["lengths"]) == art.lengths
    mu, var = art.predict(Xt)
    _close(o["mu"], mu.numpy(), 1e-5)
    _close(o["var"], var.numpy(), 1e-5)


def test_mesh_fit_and_stream_under_faults_match_batched(pool):
    """A dropped machine and bit flips on the wire: every rank demotes the
    rows the batched receiver demotes; a corrupted streamed batch too."""
    parts, Xt = _problem(seed=23, m=4, n=200)
    plan = drop_machine(2) | corrupt_words(0.01, seed=5)
    cfg = dict(protocol="broadcast", bits_per_sample=40, steps=3, faults=plan)
    batches = _batches(parts[0][0].shape[1], plan=((1, 12), (3, 9)))
    o = pool.run(fit_stream, cfg, parts, Xt, batches, START, world=4)[0]
    art, _ = _batched(cfg, parts, Xt)
    assert art.rows_demoted > 0 and art.fit_lengths[2] == 0
    assert o["fit_lengths"] == art.fit_lengths
    for (j, Xn, yn), step in zip(batches, o["steps"]):
        art = art.update(Xn, yn, machine=j)
        assert _ledgers(step) == _ledgers(art)
        assert step["rows_demoted"] == art.rows_demoted
    mu, var = art.predict(Xt)
    _close(o["mu"], mu.numpy(), TRAINED)
    _close(o["var"], var.numpy(), TRAINED)


# --------------------------------------------------------------------------
# refusals: the reference's own, and no fallback off the mesh
# --------------------------------------------------------------------------


def test_mesh_refusals():
    parts, _ = _problem(seed=9, m=4)
    with pytest.raises(ValueError, match="one process per machine"):
        DistributedGP(DGPConfig(impl="mesh"), device="cpu").fit(parts=parts)
    with pytest.raises(ValueError, match="one process per machine"):
        mesh.machine_group(4)
    with pytest.raises(ValueError, match='requires impl="batched"'):
        DGPConfig(impl="mesh", gram_backend="pallas")
    with pytest.raises(ValueError, match='supports impl="batched" only'):
        DGPConfig(impl="mesh", scheme="vq")


def test_mesh_broadcast_refuses_direct_views(pool):
    parts, Xt = _problem(seed=9, m=4)
    with pytest.raises(NotImplementedError, match='gram_mode="nystrom" only'):
        pool.run(fit_predict, dict(protocol="broadcast", gram_mode="direct", steps=0),
                 parts, Xt, world=4)


# --------------------------------------------------------------------------
# the one-shot broadcast_gp_mesh (tests/test_mesh_gp.py)
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def one_shot_results(pool):
    rng = np.random.default_rng(0)
    d, n, t = 8, 320, 100
    W = rng.normal(size=(d, 2))
    f = lambda Z: np.sin(Z @ W[:, 0]) + 0.4 * (Z @ W[:, 1])
    X = rng.normal(size=(n, d)).astype(np.float32)
    y = (f(X) + 0.05 * rng.normal(size=n)).astype(np.float32)
    Xt = rng.normal(size=(t, d)).astype(np.float32)
    yt = f(Xt)
    sm = lambda mu: float(np.mean((yt - np.asarray(mu)) ** 2) / np.var(yt))
    full = train_gp(torch.from_numpy(X), torch.from_numpy(y), kernel="se", steps=100)
    out = {"full": sm(full.predict(torch.from_numpy(Xt))[0].numpy())}
    start = tuple(float(v) for v in full.params)
    for bits in (4, 32):
        res = pool.run(one_shot, X.reshape(8, 40, d), y.reshape(8, 40), Xt, start, bits)
        mu, s2 = res[0]
        assert all(np.array_equal(r[0], mu) for r in res)
        out[bits] = {"smse": sm(mu), "var_pos": bool(np.all(s2 > 0))}
    return out


def test_high_rate_matches_full_gp(one_shot_results):
    assert one_shot_results[32]["smse"] < 1.15 * one_shot_results["full"] + 0.02


def test_rate_monotone(one_shot_results):
    assert one_shot_results[32]["smse"] <= one_shot_results[4]["smse"] * 1.05


def test_variances_positive(one_shot_results):
    assert one_shot_results[32]["var_pos"] and one_shot_results[4]["var_pos"]


def test_sharded_batcher_gives_each_rank_its_slice(pool):
    batch = {"x": np.arange(24, dtype=np.float32).reshape(12, 2),
             "y": np.arange(12, dtype=np.int64), "step": np.int64(7)}
    outs = pool.run(batch_slices, batch, world=4)
    for r, o in enumerate(outs):
        np.testing.assert_array_equal(o["x"], batch["x"][3 * r: 3 * r + 3])
        np.testing.assert_array_equal(o["y"], batch["y"][3 * r: 3 * r + 3])
        assert int(o["step"]) == 7
    with pytest.raises(ValueError, match="does not split"):
        pool.run(batch_slices, {"x": np.zeros((10, 2))}, world=4)


def test_sharded_batcher_defaults_to_the_card(pool):
    """Without a device the slices go to the card, as every entry point's
    do; where there is no CUDA that raises instead of landing on the CPU."""
    outs = pool.run(batcher_default_device, world=2)
    for o in outs:
        if torch.cuda.is_available():
            assert o == "cuda"
        else:
            assert "no CUDA device is available" in o
