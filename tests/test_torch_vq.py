"""The §4.1 ``vq`` wire scheme of repro_torch against the reference's: the
Theorem-1 curve and the Theorem-2 test channel, center and broadcast fits
through the channel, streaming re-encodes and cross-package checkpoints.

The channel algebra is float64 numpy in both packages (the same code on
the same second moments), so it is held bitwise.  The channel's noise is
the one draw torch cannot reproduce: the reference keys ``jax.random``
by ``fold_in(PRNGKey(seed), stream)``, the port draws from
``repro_torch.core.rate_distortion.channel_noise`` keyed by the same two
integers, and the tests substitute the reference's draws there
(``ref_noise``).

What is held, and within what:
* bitwise: ``reverse_waterfill``, the (R, D) curve, ``rate_for_distortion``,
  ``distortion_for_rate``, ``make_test_channel``'s A, W^½, rate and
  distortion; the three ledgers of a fit and of an update (integers);
* ``vq_A``, ``vq_W_half``, ``vq_rate_bits`` within 1e-7 (the float64
  channel cast to float32 on each side);
* decoded rows within 1e-5 of the data scale (one fp32 matmul each side);
* predictions at the shared starting hyperparameters (steps=0) within
  1e-4 of scale, cross-loaded checkpoints within 1e-5.
"""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_thread  # noqa: E402,F401
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import faults as ref_faults  # noqa: E402
from repro.core import DGPConfig as RefConfig  # noqa: E402
from repro.core import DistributedGP as RefGP  # noqa: E402
from repro.core import rate_distortion as ref_rd  # noqa: E402
from repro.core.gp import GPParams as RefParams  # noqa: E402
from repro_torch import faults  # noqa: E402
from repro_torch.comm.accounting import side_info_bits  # noqa: E402
from repro_torch.core import DGPConfig, DistributedGP, GPParams  # noqa: E402
from repro_torch.core import rate_distortion as rd  # noqa: E402
from repro_torch.core.protocols.base import load_artifact  # noqa: E402


M, D, N_PER, BITS = 8, 8, 25, 24
START = (0.2, -0.3, -1.5)
TOL, TOL_CKPT, TOL_DEC, TOL_CH = 1e-4, 1e-5, 1e-5, 1e-7


def _problem():
    rng = np.random.default_rng(1)
    A = rng.normal(size=(D, D)) / np.sqrt(D)
    X = (rng.normal(size=(M * N_PER, D)) @ A.T).astype(np.float32)
    y = (np.sin(2.0 * X[:, 0]) + 0.5 * X[:, 1]
         + 0.05 * rng.normal(size=X.shape[0])).astype(np.float32)
    parts = [(X[j::M], y[j::M]) for j in range(M)]
    Xq = (rng.normal(size=(16, D)) @ A.T).astype(np.float32)
    Xn = (rng.normal(size=(24, D)) @ A.T).astype(np.float32)
    yn = (np.sin(2.0 * Xn[:, 0]) + 0.5 * Xn[:, 1]).astype(np.float32)
    return parts, Xq, Xn, yn


PARTS, XQ, XN, YN = _problem()


def _ref_noise(shape, seed, stream):
    key = jax.random.fold_in(jax.random.PRNGKey(seed), stream)
    return torch.from_numpy(np.array(jax.random.normal(key, tuple(shape), jnp.float32)))


@pytest.fixture
def ref_noise(monkeypatch):
    monkeypatch.setattr(rd, "channel_noise", _ref_noise)


def _close(got, want, rel=TOL, msg=""):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rel, atol=rel * max(1.0, np.abs(want).max()),
                               err_msg=msg)


def _moments(seed, d, rank=None):
    rng = np.random.default_rng(seed)
    B = rng.normal(size=(d, rank or d))
    Qx = B @ B.T / d
    C = rng.normal(size=(d, d))
    return Qx, C @ C.T / d + 0.1 * np.eye(d)


# --------------------------------------------------------------------------
# the channel algebra
# --------------------------------------------------------------------------


@pytest.mark.parametrize("seed,d,rank", [(0, 4, None), (1, 8, None), (2, 21, None),
                                         (3, 8, 5)])
def test_rate_distortion_functions_are_the_references_bitwise(seed, d, rank):
    Qx, Qy = _moments(seed, d, rank)
    eigs = rd.product_eigs(Qx, Qy)[0]
    for D_ in (0.01 * eigs.sum(), 0.3 * eigs.sum(), 2.0 * eigs.sum()):
        np.testing.assert_array_equal(rd.reverse_waterfill(eigs, D_),
                                      ref_rd.reverse_waterfill(eigs, D_))
        assert rd.rate_for_distortion(Qx, Qy, D_) == ref_rd.rate_for_distortion(Qx, Qy, D_)
    for got, want in zip(rd.rd_lower_bound_curve(Qx, Qy, 50),
                         ref_rd.rd_lower_bound_curve(Qx, Qy, 50)):
        np.testing.assert_array_equal(got, want)
    for R in (0.5, 8.0, 24.0):
        D_ = rd.distortion_for_rate(Qx, Qy, R)
        assert D_ == ref_rd.distortion_for_rate(Qx, Qy, R)
        ch, ref_ch = rd.make_test_channel(Qx, Qy, D_), ref_rd.make_test_channel(Qx, Qy, D_)
        for f in ("A", "W_half", "rate_bits", "distortion"):
            np.testing.assert_array_equal(getattr(ch, f), getattr(ref_ch, f), err_msg=f)


def test_channel_sample_with_the_references_noise(ref_noise):
    Qx, Qy = _moments(4, D)
    ch = rd.make_test_channel(Qx, Qy, rd.distortion_for_rate(Qx, Qy, 12.0))
    X = PARTS[0][0]
    got = rd.sample_test_channel(ch, torch.from_numpy(X), 0, 3)
    want = ref_rd.sample_test_channel(ref_rd.make_test_channel(Qx, Qy, ch.distortion), X,
                                      jax.random.fold_in(jax.random.PRNGKey(0), 3))
    _close(got.numpy(), want, TOL_DEC)


def test_channel_noise_is_deterministic_and_cpu_drawn():
    a = rd.channel_noise((300, 4), 0, 5)
    torch.manual_seed(9)
    assert torch.equal(a, rd.channel_noise((300, 4), 0, 5))
    assert a.dtype == torch.float32 and a.device.type == "cpu"
    assert not torch.equal(a, rd.channel_noise((300, 4), 1, 5))
    assert abs(float(a.mean())) < 0.1 and abs(float(a.std()) - 1.0) < 0.1


# --------------------------------------------------------------------------
# vq fits, updates and checkpoints against the reference
# --------------------------------------------------------------------------

CASES = {"center": {}, "broadcast": {"protocol": "broadcast"},
         "center_dropped": {"drop": 2}}


def _configs(case, **kw):
    kw = dict(CASES[case], **kw)
    drop = kw.pop("drop", None)
    base = dict(scheme="vq", bits_per_sample=BITS, steps=0, **kw)
    return (DGPConfig(faults=faults.drop_machine(drop) if drop is not None else None, **base),
            RefConfig(faults=ref_faults.drop_machine(drop) if drop is not None else None,
                      **base))


@pytest.fixture(scope="module")
def fits():
    mp = pytest.MonkeyPatch()
    mp.setattr(rd, "channel_noise", _ref_noise)
    try:
        out = {}
        for case in CASES:
            cfg, ref_cfg = _configs(case)
            art = DistributedGP(cfg, device="cpu").fit(
                parts=PARTS, params=GPParams(*(torch.tensor(v) for v in START)))
            ref = RefGP(ref_cfg).fit(parts=PARTS,
                                     params=RefParams(*(jnp.float32(v) for v in START)))
            out[case] = (ref, art)
        return out
    finally:
        mp.undo()


@pytest.mark.parametrize("case", list(CASES))
def test_vq_fit_matches_the_reference(fits, case):
    ref, art = fits[case]
    assert art.scheme == "vq" and tuple(art.wire.codes.shape[2:]) == (0,)
    assert (art.wire_bits, art.payload_bits, art.integrity_bits, art.rows_demoted) == (
        ref.wire_bits, ref.payload_bits, ref.integrity_bits, ref.rows_demoted)
    assert art.payload_bits == art.wire_bits and art.integrity_bits == 0
    assert art.lengths == ref.lengths
    for k in ("vq_A", "vq_W_half", "vq_rate_bits"):
        np.testing.assert_allclose(art.data[k].numpy(), np.asarray(ref.data[k]), rtol=0,
                                   atol=TOL_CH, err_msg=k)
    _close(art.wire.decoded.numpy(), ref.wire.decoded, TOL_DEC, "decoded")
    # the ledger: ceil(L_j R_j) + side info per transmitting machine, R_j
    # the achieved rate of machine j's channel (float64)
    parts, _ = faults.apply_to_parts(PARTS, art.config.faults)
    S = [X.astype(np.float64).T @ X.astype(np.float64) / max(len(X), 1) for X, _ in parts]
    want = 0
    for j, (X, _) in enumerate(parts):
        if len(X) and not (art.protocol == "center" and j == 0):
            Qy = S[0] if art.protocol == "center" else sum(S) - S[j]
            ch = rd.make_test_channel(S[j], Qy, rd.distortion_for_rate(S[j], Qy, BITS))
            want += math.ceil(len(X) * ch.rate_bits) + side_info_bits(D)
    assert art.wire_bits == want
    mu, var = DistributedGP(art.config, device="cpu").predict(art, XQ)
    rmu, rvar = RefGP(ref.config).predict(ref, XQ)
    _close(mu.numpy(), rmu, msg="mu")
    _close(var.numpy(), rvar, msg="var")


@pytest.mark.parametrize("case", ["center", "broadcast"])
def test_vq_ledger_is_within_five_percent_of_per_symbol(fits, case):
    _, art = fits[case]
    per_symbol = DistributedGP(dataclasses.replace(art.config, scheme="per_symbol"),
                               device="cpu").fit(parts=PARTS)
    assert abs(art.wire_bits - per_symbol.wire_bits) <= 0.05 * per_symbol.wire_bits


@pytest.mark.parametrize("case", list(CASES))
def test_vq_updates_match_the_reference(ref_noise, fits, case):
    ref, art = fits[case]
    batches = [(1, XN[:10], YN[:10]), (0, XN[10:14], YN[10:14]), (4, XN[14:24], YN[14:24])]
    est, ref_est = DistributedGP(art.config, device="cpu"), RefGP(ref.config)
    for j, Xb, yb in batches:
        new, ref_new = est.update(art, Xb, yb, machine=j), ref_est.update(ref, Xb, yb, machine=j)
        for f in ("counts", "cols", "wire_bits", "payload_bits", "integrity_bits",
                  "rows_demoted"):
            np.testing.assert_array_equal(getattr(new.stream, f).numpy(),
                                          np.asarray(getattr(ref_new.stream, f)), err_msg=f)
        sends = not (art.protocol == "center" and j == 0)
        want = math.ceil(Xb.shape[0] * float(art.data["vq_rate_bits"][j])) if sends else 0
        assert (new.wire_bits - art.wire_bits, new.payload_bits - art.payload_bits,
                new.integrity_bits - art.integrity_bits) == (want, want, 0)
        art, ref = new, ref_new
    for k in ("X_recon",):
        if k in ref.data:
            _close(art.data[k].numpy(), ref.data[k], TOL_DEC, k)
    mu, var = est.predict(art, XQ)
    rmu, rvar = ref_est.predict(ref, XQ)
    _close(mu.numpy(), rmu, msg="mu")
    _close(var.numpy(), rvar, msg="var")


@pytest.mark.parametrize("case", ["center", "broadcast"])
def test_vq_checkpoints_load_in_both_packages(fits, case, tmp_path):
    ref, art = fits[case]
    est, ref_est = DistributedGP(art.config, device="cpu"), RefGP(ref.config)
    est.save(art, str(tmp_path / "port"))
    ref_est.save(ref, str(tmp_path / "ref"))
    from_ref, from_port = load_artifact(str(tmp_path / "ref"), device="cpu"), \
        RefGP.load(str(tmp_path / "port"))
    assert from_ref.scheme == from_port.scheme == "vq"
    assert tuple(from_ref.wire.codes.shape[2:]) == (0,) == tuple(from_port.wire.codes.shape[2:])
    for k in ("vq_A", "vq_W_half", "vq_rate_bits"):
        np.testing.assert_array_equal(from_ref.data[k].numpy(), np.asarray(ref.data[k]))
        np.testing.assert_array_equal(np.asarray(from_port.data[k]), art.data[k].numpy())
    for got, want in ((est.predict(from_ref, XQ), ref_est.predict(ref, XQ)),
                      (ref_est.predict(from_port, XQ), est.predict(art, XQ))):
        _close(np.asarray(got[0]), np.asarray(want[0]), TOL_CKPT)
        _close(np.asarray(got[1]), np.asarray(want[1]), TOL_CKPT)
    back = est.load(str(tmp_path / "port"))
    for a, b in zip(est.predict(back, XQ), est.predict(art, XQ)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kw", [dict(protocol="poe"), dict(impl="host"),
                                dict(gram_backend="pallas"), dict(impl="mesh")])
def test_vq_config_cross_constraints_match_the_reference(kw):
    with pytest.raises(ValueError) as got:
        DGPConfig(scheme="vq", **kw)
    with pytest.raises(ValueError) as want:
        RefConfig(scheme="vq", **kw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("protocol", ["center", "broadcast"])
def test_vq_refuses_bit_flips_as_the_reference(protocol):
    cfg = DGPConfig(protocol=protocol, scheme="vq", steps=0,
                    faults=faults.corrupt_words(0.01, seed=1))
    ref_cfg = RefConfig(protocol=protocol, scheme="vq", steps=0,
                        faults=ref_faults.corrupt_words(0.01, seed=1))
    with pytest.raises(NotImplementedError, match="bit-flip") as got:
        DistributedGP(cfg, device="cpu").fit(parts=PARTS)
    with pytest.raises(NotImplementedError, match="bit-flip") as want:
        RefGP(ref_cfg).fit(parts=PARTS)
    assert str(got.value) == str(want.value)
