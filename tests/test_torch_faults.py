"""The fault plane of repro_torch against the reference's: fault plans,
dataset faults, the CRC-guarded bit-flip channel, degraded serving and
``health()``, corrupted streaming and the host oracles under faults.

The reference draws its flip masks from ``jax.random``
(``fold_in(PRNGKey(seed), stream)``), which torch cannot reproduce, and the
port draws every mask from ``repro_torch.faults.flip_mask`` keyed by the
same two integers.  So where a comparison needs the same corruption, the
test substitutes the reference's own masks into ``flip_mask``
(``ref_masks``).  CRC-16 is affine over XOR, so which rows fail depends
only on the mask, not on the words: the demotion pattern matches bitwise
although the eigenvector signs make the two packages' words differ.

What is held, and within what:
* integers bitwise: plans and their dicts, ``rows_removed``,
  ``rows_demoted``, ``lengths``/``fit_lengths``, the three ledgers, the
  CRC-flagged rows, an update's keep set and ledger increments, the
  ``health()`` report field for field;
* the surviving rows bitwise (``apply_to_parts``'s numpy copy; the wire's
  compaction moves rows, it computes nothing);
* decoded rows within 1e-4 of the data scale (the two eigh
  implementations, as ``tests/test_torch_center.py`` states);
* predictions at the shared starting hyperparameters (steps=0), healthy
  and degraded, within 1e-4 of scale (``max(1, max |reference|)``);
  cross-loaded checkpoints within 1e-5 (the same factors).

The reference's pallas fits run its XLA fallback (off TPU its default);
the port's run the kernels' plain versions (CPU tensors).
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_thread  # noqa: E402,F401
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import faults as ref_faults  # noqa: E402
from repro.core import DGPConfig as RefConfig  # noqa: E402
from repro.core import DistributedGP as RefGP  # noqa: E402
from repro.core import jax_scheme  # noqa: E402
from repro.core.gp import GPParams as RefParams  # noqa: E402
from repro.core.protocols import wire as ref_wire  # noqa: E402
from repro.core.protocols.base import pad_parts as ref_pad  # noqa: E402
from repro_torch import faults  # noqa: E402
from repro_torch.comm.accounting import (  # noqa: E402
    CRC_BITS, integrity_bits_formula, payload_bits_formula, payload_row_bits,
    wire_bits_formula,
)
from repro_torch.core import DGPConfig, DistributedGP, GPParams  # noqa: E402
from repro_torch.core import torch_scheme as TS  # noqa: E402
from repro_torch.core.protocols import wire  # noqa: E402
from repro_torch.core.protocols.base import load_artifact, pad_parts  # noqa: E402


M, D, N_PER, BITS = 8, 8, 25, 24  # 200 points over 8 machines; R = 24, d = 8
START = (0.2, -0.3, -1.5)
RATE = 1e-2  # ~27 % of the one-word rows take a flip
PLAN_KW = dict(drop=(3,), nan=(5,), flip=RATE, seed=7)
TOL, TOL_CKPT = 1e-4, 1e-5


def _plans(drop=(3,), nan=(5,), flip=RATE, seed=7):
    """(port plan, reference plan) built by the same constructors."""
    out = []
    for mod in (faults, ref_faults):
        plan = mod.FaultPlan()
        if drop:
            plan = plan | mod.drop_machine(*drop)
        if nan:
            plan = plan | mod.nan_shard(*nan)
        if flip:
            plan = plan | mod.corrupt_words(flip, seed=seed)
        out.append(plan)
    return tuple(out)


def _problem():
    rng = np.random.default_rng(0)
    A = rng.normal(size=(D, D)) / np.sqrt(D)
    X = (rng.normal(size=(M * N_PER, D)) @ A.T).astype(np.float32)
    y = (np.sin(2.0 * X[:, 0]) + 0.5 * X[:, 1]
         + 0.05 * rng.normal(size=X.shape[0])).astype(np.float32)
    parts = [(X[j::M], y[j::M]) for j in range(M)]
    Xq = (rng.normal(size=(16, D)) @ A.T).astype(np.float32)
    Xn = (rng.normal(size=(40, D)) @ A.T).astype(np.float32)
    yn = (np.sin(2.0 * Xn[:, 0]) + 0.5 * Xn[:, 1]).astype(np.float32)
    return parts, Xq, Xn, yn


PARTS, XQ, XN, YN = _problem()
PROTOCOLS = {"center": {}, "broadcast": {"protocol": "broadcast"},
             "poe": {"protocol": "poe", "fusion": "rbcm"}}


def _ref_mask(shape, rate, seed, stream):
    """The reference's flip mask of one transmission, as the port's int32
    word plane: ``flip_words`` of zero words is the mask itself."""
    key = jax.random.fold_in(jax.random.PRNGKey(seed), stream)
    mask = ref_faults.flip_words(jnp.zeros(tuple(shape), jnp.uint32), rate, key)
    return torch.from_numpy(np.asarray(mask).view(np.int32).copy())


@pytest.fixture
def ref_masks(monkeypatch):
    monkeypatch.setattr(faults, "flip_mask", _ref_mask)


def _close(got, want, rel=TOL, msg=""):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rel, atol=rel * max(1.0, np.abs(want).max()),
                               err_msg=msg)


def _configs(kind, backend="xla", steps=0, **plan_kw):
    plan, ref_plan = _plans(**{**PLAN_KW, **plan_kw})
    kw = dict(PROTOCOLS[kind], gram_backend=backend, steps=steps, bits_per_sample=BITS)
    return DGPConfig(faults=plan, **kw), RefConfig(faults=ref_plan, **kw)


def _fit_both(kind, backend="xla", **plan_kw):
    cfg, ref_cfg = _configs(kind, backend, **plan_kw)
    start = GPParams(*(torch.tensor(v) for v in START))
    ref_start = RefParams(*(jnp.float32(v) for v in START))
    art = DistributedGP(cfg, device="cpu").fit(parts=PARTS, params=start)
    ref = RefGP(ref_cfg).fit(parts=PARTS, params=ref_start)
    return ref, art


@pytest.fixture(scope="module")
def fits():
    """{(kind, backend): (reference artifact, port artifact)} under the
    drop + NaN + flip plan, the port drawing the reference's masks."""
    mp = pytest.MonkeyPatch()
    mp.setattr(faults, "flip_mask", _ref_mask)
    try:
        return {(kind, backend): _fit_both(kind, backend)
                for kind in PROTOCOLS for backend in ("xla", "pallas")}
    finally:
        mp.undo()


FIT_KEYS = [(k, b) for k in PROTOCOLS for b in ("xla", "pallas")]


# --------------------------------------------------------------------------
# the plan: a frozen, mergeable, serializable value
# --------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(), dict(drop=(1, 3), nan=(), flip=0.0), dict(drop=(), nan=(2, 5), flip=0.0),
    dict(drop=(), nan=(), flip=0.05, seed=11), dict(drop=(0,), nan=(4,), flip=1e-3, seed=3),
])
def test_plan_merge_asdict_and_from_dict_match_reference(kw):
    plan, ref_plan = _plans(**{**PLAN_KW, **kw})
    assert plan.asdict() == ref_plan.asdict()
    assert plan.active == ref_plan.active
    slow = faults.straggler(2, 0.25)
    assert (plan | slow).asdict() == (ref_plan | ref_faults.straggler(2, 0.25)).asdict()
    # through json, as meta.json carries it, into the other package
    d = json.loads(json.dumps((plan | slow).asdict()))
    assert faults.FaultPlan.from_dict(d) == plan | slow
    assert ref_faults.FaultPlan.from_dict(d).asdict() == (plan | slow).asdict()
    cfg, ref_cfg = DGPConfig(faults=plan), RefConfig(faults=ref_plan)
    assert cfg.asdict() == ref_cfg.asdict()
    assert DGPConfig.from_dict(json.loads(json.dumps(ref_cfg.asdict()))) == cfg
    assert hash(cfg) == hash(DGPConfig(faults=plan))


def test_config_refuses_what_is_not_its_own_plan():
    for bad in (object(), {"drop": [1]}, ref_faults.drop_machine(1)):
        with pytest.raises(TypeError, match="FaultPlan"):
            DGPConfig(faults=bad)
    for bad in (object(), faults.drop_machine(1)):
        with pytest.raises(TypeError, match="FaultPlan"):
            RefConfig(faults=bad)


@pytest.mark.parametrize("kw", [
    dict(drop=(3,), nan=(5,)), dict(drop=(0, 7), nan=()), dict(drop=(), nan=(1, 2, 6)),
    dict(drop=(), nan=(4,), nan_frac=0.2, seed=9), dict(drop=(), nan=(), flip=0.1),
])
def test_apply_to_parts_bitwise(kw):
    nan_frac = kw.pop("nan_frac", None)
    plan, ref_plan = _plans(**{**PLAN_KW, **kw})
    if nan_frac is not None:
        plan = dataclasses.replace(plan, nan_frac=nan_frac)
        ref_plan = dataclasses.replace(ref_plan, nan_frac=nan_frac)
    got, removed = faults.apply_to_parts(PARTS, plan)
    want, ref_removed = ref_faults.apply_to_parts(PARTS, ref_plan)
    assert removed == ref_removed
    for (X, y), (Xr, yr) in zip(got, want):
        np.testing.assert_array_equal(X, Xr)
        np.testing.assert_array_equal(y, yr)
        assert np.isfinite(X).all()


def test_flip_mask_deterministic_cpu_drawn_and_at_rate():
    a = faults.flip_mask((400, 3), 0.01, 7, 5)
    torch.manual_seed(123)  # the global generator plays no part
    assert torch.equal(a, faults.flip_mask((400, 3), 0.01, 7, 5))
    assert a.dtype == torch.int32 and a.device.type == "cpu"
    assert not torch.equal(a, faults.flip_mask((400, 3), 0.01, 7, 6))
    assert not torch.equal(a, faults.flip_mask((400, 3), 0.01, 8, 5))
    assert int(faults.flip_mask((4, 2), 0.0, 7, 5).abs().sum()) == 0
    # 400 x 3 x 32 = 38400 bits at 1 %: mean 384, sd 19.5; 5 sd either way
    bits = sum(int(((a.to(torch.int64) & 0xFFFFFFFF) >> b & 1).sum()) for b in range(32))
    assert 384 - 98 <= bits <= 384 + 98
    words = torch.arange(1200, dtype=torch.int32).reshape(400, 3)
    assert torch.equal(faults.flip_words(words, 0.01, 7, 5), words ^ a)
    assert faults.flip_words(words, 0.0, 7, 5) is words


def test_crc_flags_the_same_rows_for_the_same_mask_on_other_words():
    rng = np.random.default_rng(3)
    for W in (1, 3):
        mask = _ref_mask((300, W), 0.02, 7, W)
        w_ref = rng.integers(0, 2**32, size=(300, W), dtype=np.uint64).astype(np.uint32)
        w_port = torch.from_numpy(
            rng.integers(0, 2**32, size=(300, W), dtype=np.uint64).astype(np.uint32)
            .view(np.int32))
        rx_ref = jnp.asarray(w_ref) ^ jnp.asarray(mask.numpy().view(np.uint32))
        flagged_ref = np.asarray(jax_scheme.crc_words(rx_ref) != jax_scheme.crc_words(w_ref))
        flagged = (TS.crc_words(w_port ^ mask) != TS.crc_words(w_port)).numpy()
        np.testing.assert_array_equal(flagged, flagged_ref)
        assert flagged.sum() == int((mask != 0).any(-1).sum())  # every flip detected


@pytest.mark.parametrize("kind,kw,match", [
    ("center", dict(drop=tuple(range(M)), nan=()), "every row"),
    ("center", dict(drop=(0,), nan=()), "center machine"),
    ("broadcast", dict(drop=(0,), nan=()), "machine 0"),
    ("poe", dict(drop=(0, 2), nan=()), "machine 0"),
])
def test_fit_guards_raise_as_the_reference(kind, kw, match):
    cfg, ref_cfg = _configs(kind, **{**kw, "flip": 0.0})
    with pytest.raises(ValueError, match=match) as got:
        DistributedGP(cfg, device="cpu").fit(parts=PARTS)
    with pytest.raises(ValueError, match=match) as want:
        RefGP(ref_cfg).fit(parts=PARTS)
    assert str(got.value) == str(want.value)


# --------------------------------------------------------------------------
# faulted fits, degraded serving, health
# --------------------------------------------------------------------------


@pytest.mark.parametrize("kind,backend", FIT_KEYS)
def test_faulted_fit_matches_the_reference(fits, kind, backend):
    ref, art = fits[kind, backend]
    assert art.rows_demoted == ref.rows_demoted
    if kind != "poe":
        assert art.rows_demoted > 0
    assert art.lengths == ref.lengths and art.fit_lengths == ref.fit_lengths
    assert art.fit_lengths[3] == 0
    assert (art.wire_bits, art.payload_bits, art.integrity_bits) == (
        ref.wire_bits, ref.payload_bits, ref.integrity_bits)
    np.testing.assert_array_equal(art.y.numpy(), np.asarray(ref.y))
    for k in ("Xs", "mask", "Xc"):
        if k in ref.data:
            np.testing.assert_array_equal(art.data[k].numpy(), np.asarray(ref.data[k]))
    for k in ("X_recon", "sq_exact"):
        if k in ref.data:
            _close(art.data[k].numpy(), ref.data[k], msg=k)
    mu, var = DistributedGP(art.config, device="cpu").predict(art, XQ)
    rmu, rvar = RefGP(ref.config).predict(ref, XQ)
    _close(mu.numpy(), rmu, msg="mu")
    _close(var.numpy(), rvar, msg="var")


@pytest.mark.parametrize("kind,backend", FIT_KEYS)
def test_degraded_predictions_and_health_match_the_reference(fits, kind, backend):
    ref, art = fits[kind, backend]
    est, ref_est = DistributedGP(art.config, device="cpu"), RefGP(ref.config)
    down = np.ones(M, np.float32)
    down[[1, 6]] = 0.0
    for available in (None, down, np.ones(M, np.float32)):
        h, rh = est.health(art, available), ref_est.health(ref, available)
        assert dataclasses.asdict(h) == dataclasses.asdict(rh), available
        mu, var = est.predict(art, XQ, available=available)
        rmu, rvar = ref_est.predict(ref, XQ, available=available)
        _close(mu.numpy(), rmu, msg=f"mu {available}")
        _close(var.numpy(), rvar, msg=f"var {available}")
    h = est.health(art, down)
    assert h.status == "degraded" and h.machines_lost == (1, 3, 6)
    if kind == "broadcast":  # KL: m / m_alive, and no variance below the healthy one
        assert h.variance_inflation == M / (M - 3)
        assert bool((est.predict(art, XQ, down)[1] >= est.predict(art, XQ)[1] - 1e-6).all())


def test_health_of_a_healthy_fit_and_of_host_models():
    est = DistributedGP(DGPConfig(protocol="broadcast", steps=0), device="cpu")
    art = est.fit(parts=PARTS)
    h = est.health(art)
    assert (h.status, h.machines, h.machines_lost, h.rows_demoted,
            h.variance_inflation) == ("ok", M, (), 0, 1.0)
    assert art.health() == h
    host = DistributedGP(DGPConfig(protocol="broadcast", impl="host", steps=0), device="cpu")
    with pytest.raises(TypeError, match="FittedProtocol"):
        host.health(host.fit(parts=PARTS))
    with pytest.raises(TypeError, match="FittedProtocol"):
        RefGP(RefConfig(protocol="broadcast", impl="host", steps=0)).health(object())


@pytest.mark.parametrize("kind", list(PROTOCOLS))
def test_checkpoints_with_a_plan_load_in_both_packages(fits, kind, tmp_path):
    ref, art = fits[kind, "xla"]
    est, ref_est = DistributedGP(art.config, device="cpu"), RefGP(ref.config)
    est.save(art, str(tmp_path / "port"))
    ref_est.save(ref, str(tmp_path / "ref"))
    for d in ("port", "ref"):
        meta = json.loads(next((tmp_path / d).glob("meta*.json")).read_text())
        assert meta["config"]["faults"] == json.loads(json.dumps(art.config.faults.asdict()))
        assert meta["rows_demoted"] == art.rows_demoted
    from_ref, from_port = load_artifact(str(tmp_path / "ref"), device="cpu"), \
        RefGP.load(str(tmp_path / "port"))
    assert from_ref.config == art.config and from_port.config == ref.config
    assert from_ref.rows_demoted == ref.rows_demoted and from_ref.fit_lengths == ref.fit_lengths
    for got, want in ((est.predict(from_ref, XQ), ref_est.predict(ref, XQ)),
                      (ref_est.predict(from_port, XQ), est.predict(art, XQ))):
        _close(np.asarray(got[0]), np.asarray(want[0]), TOL_CKPT)
        _close(np.asarray(got[1]), np.asarray(want[1]), TOL_CKPT)
    assert dataclasses.asdict(est.health(from_ref)) == dataclasses.asdict(ref_est.health(ref))


# --------------------------------------------------------------------------
# the channel at the wire: demotion and compaction
# --------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["center", "broadcast"])
def test_wire_run_demotes_and_compacts_as_the_reference(ref_masks, mode):
    plan, ref_plan = _plans()
    parts, _ = faults.apply_to_parts(PARTS, plan)
    run = wire._per_symbol_run(pad_parts(parts), BITS, 12, mode, 0, plan)
    ref = ref_wire._per_symbol_run(ref_pad(parts), BITS, 12, mode, 0, "batched", ref_plan)
    assert run.rows_demoted == ref.rows_demoted > 0
    assert run.shards.lengths == ref.shards.lengths
    assert (run.wire_bits, run.payload_bits, run.integrity_bits) == (
        ref.wire_bits, ref.payload_bits, ref.integrity_bits)
    for k in ("X", "y", "mask"):
        np.testing.assert_array_equal(getattr(run.shards, k).numpy(),
                                      np.asarray(getattr(ref.shards, k)))
    _close(run.state.decoded.numpy(), ref.state.decoded, msg="decoded")
    # the ledgers charge what was transmitted: the formulas on the lengths
    # before demotion
    sent = [p[0].shape[0] for p in parts]
    skip = 0 if mode == "center" else None
    assert run.wire_bits == wire_bits_formula(run.state.rates.numpy(), sent, D, skip=skip)
    assert run.payload_bits == payload_bits_formula(sent, D, BITS, 12, skip=skip)
    assert run.integrity_bits == integrity_bits_formula(sent, skip=skip)
    assert sum(sent) - sum(run.shards.lengths) == run.rows_demoted
    # the survivors keep the words that arrived, which decode to their rows
    st = {k: getattr(run.state, k) for k in ("T", "T_inv", "sigma", "rates")}
    received = TS.unpack_codes(run.state.codes, st["rates"], total_bits=BITS)
    redecoded = TS.decode(st, received, TS.scheme_tables(BITS, 12)) * run.shards.mask[..., None]
    mine = torch.ones(M, dtype=torch.bool)
    if skip is not None:
        mine[skip] = False
    _close(redecoded[mine].numpy(), run.state.decoded[mine].numpy(), 1e-6)


# --------------------------------------------------------------------------
# streaming through the corrupted channel
# --------------------------------------------------------------------------


def _stream_both(ref, art, batches):
    """Both packages' artifacts after each (machine, X, y) of ``batches``."""
    out = [(ref, art)]
    for j, Xb, yb in batches:
        art = DistributedGP(art.config, device="cpu").update(art, Xb, yb, machine=j)
        ref = RefGP(ref.config).update(ref, Xb, yb, machine=j)
        out.append((ref, art))
    return out


@pytest.mark.parametrize("kind", ["center", "broadcast"])
def test_corrupted_updates_match_the_reference(ref_masks, fits, kind, tmp_path):
    """The reference's fit, through its checkpoint into both packages, then
    the same batches through the flipping channel: keep sets (counts),
    ledger increments and demotions bitwise, predictions within TOL; then
    one batch under a plan whose flips demote every row, where both return
    a new artifact with only the ledgers and the demotion count bumped."""
    ref = fits[kind, "xla"][0]
    RefGP(ref.config).save(ref, str(tmp_path))
    ref, art = RefGP.load(str(tmp_path)), load_artifact(str(tmp_path), device="cpu")
    batches = [(1, XN[:16], YN[:16]), (0, XN[24:30], YN[24:30])]
    states = _stream_both(ref, art, batches)
    demoted = 0
    for (j, Xb, _), (r0, a0), (r1, a1) in zip(batches, states, states[1:]):
        for f in ("counts", "cols", "wire_bits", "payload_bits", "integrity_bits",
                  "rows_demoted"):
            np.testing.assert_array_equal(getattr(a1.stream, f).numpy(),
                                          np.asarray(getattr(r1.stream, f)), err_msg=f)
        n = Xb.shape[0]
        sends = not (kind == "center" and j == 0)
        rate = int(a0.wire.rates[j].sum()) if sends else 0
        assert (a1.wire_bits - a0.wire_bits, a1.payload_bits - a0.payload_bits,
                a1.integrity_bits - a0.integrity_bits) == (
            rate * n, payload_row_bits(BITS, D, 12) * n if sends else 0,
            CRC_BITS * n if sends else 0)
        kept = a1.lengths[j] - a0.lengths[j]
        assert kept + a1.rows_demoted - a0.rows_demoted == n
        demoted += a1.rows_demoted - a0.rows_demoted
    assert demoted > 0
    ref, art = states[-1]
    mu, var = DistributedGP(art.config, device="cpu").predict(art, XQ)
    rmu, rvar = RefGP(ref.config).predict(ref, XQ)
    _close(mu.numpy(), rmu, msg="mu")
    _close(var.numpy(), rvar, msg="var")
    # every row demoted: a flip rate of one half leaves no row's CRC intact
    loud, ref_loud = _plans(flip=0.5)
    art = dataclasses.replace(art, config=dataclasses.replace(art.config, faults=loud))
    ref = dataclasses.replace(ref, config=dataclasses.replace(ref.config, faults=ref_loud))
    (_, _), (ref2, art2) = _stream_both(ref, art, [(2, XN[30:36], YN[30:36])])
    assert art2 is not art and art2.lengths == art.lengths
    assert int(art2.stream.cols) == int(art.stream.cols) == int(ref2.stream.cols)
    assert art2.rows_demoted - art.rows_demoted == 6 == ref2.rows_demoted - ref.rows_demoted
    assert (art2.wire_bits, art2.payload_bits, art2.integrity_bits) == (
        ref2.wire_bits, ref2.payload_bits, ref2.integrity_bits)
    assert art2.integrity_bits - art.integrity_bits == CRC_BITS * 6
    assert all(torch.equal(art2.factors[k], art.factors[k]) for k in art.factors)


@pytest.mark.parametrize("kind", list(PROTOCOLS))
def test_update_to_a_dropped_machine_is_refused(fits, kind):
    ref, art = fits[kind, "xla"]
    with pytest.raises(ValueError, match="no rows at fit time"):
        DistributedGP(art.config, device="cpu").update(art, XN[:4], YN[:4], machine=3)
    with pytest.raises(ValueError, match="no rows at fit time"):
        RefGP(ref.config).update(ref, XN[:4], YN[:4], machine=3)
    art2 = DistributedGP(art.config, device="cpu").update(art, XN[:4], YN[:4], machine=2)
    assert art2.lengths[3] == 0 and sum(art2.lengths) >= sum(art.lengths)


# --------------------------------------------------------------------------
# the impl="host" oracles: data faults apply, flips are refused
# --------------------------------------------------------------------------


@pytest.mark.parametrize("kind", list(PROTOCOLS))
def test_host_oracles_apply_data_faults_and_refuse_flips(kind):
    cfg, ref_cfg = _configs(kind)
    host = dataclasses.replace(cfg, impl="host")
    ref_host = dataclasses.replace(ref_cfg, impl="host")
    if kind == "poe":  # zero rate: the flips are a no-op there
        model = DistributedGP(host, device="cpu").fit(parts=PARTS)
        assert [p[0].shape[0] for p in model.parts] == [25, 25, 25, 0, 25, 13, 25, 25]
    else:
        with pytest.raises(NotImplementedError, match="flip"):
            DistributedGP(host, device="cpu").fit(parts=PARTS)
        with pytest.raises(NotImplementedError, match="flip"):
            RefGP(ref_host).fit(parts=PARTS)
    data_only, ref_data_only = _plans(flip=0.0)
    host = dataclasses.replace(host, faults=data_only)
    ref_host = dataclasses.replace(ref_host, faults=ref_data_only)
    start = GPParams(*(torch.tensor(v) for v in START))
    model = DistributedGP(host, device="cpu").fit(parts=PARTS, params=start)
    ref_model = RefGP(ref_host).fit(parts=PARTS, params=RefParams(*(jnp.float32(v)
                                                                    for v in START)))
    if kind != "poe":
        assert (model.wire_bits, model.payload_bits, model.integrity_bits) == (
            ref_model.wire_bits, ref_model.payload_bits, ref_model.integrity_bits)
    mu, var = model.predict(XQ)
    rmu, rvar = ref_model.predict(XQ)
    _close(mu.numpy(), rmu, msg="mu")
    _close(var.numpy(), rvar, msg="var")

