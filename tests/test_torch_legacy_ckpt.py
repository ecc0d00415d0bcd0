"""Checkpoints of every older format load in repro_torch and serve as the
reference's own loader serves them, run live (not as
``tests/fixtures/legacy_artifact/expected.npz`` records: those numbers
drift with the JAX version).

The formats: v1 has no ``config`` block (the config is rebuilt from the
metadata), v2 stores the wire codes unpacked (int32, -1 on padded rows),
v3 packs them, v4 adds per-array CRC32s, v5 the ``stream/*`` state and
v6 the Nyström serve-cache keys.  Besides the committed v1 fixture, v1, v2
and v4 artifacts are synthesized here from a v6 checkpoint the reference
writes, for the center (each gram mode, and the vq scheme at v2 and v4),
broadcast (each gram mode) and poe protocols; a v4 poe artifact also
carries streamed extras
(``X_extra``/``extra_mask``/``y_extra``), which both loaders fold into the
experts' columns.

What is held, and within what: the rebuilt config, the packed words, the
stream counts and the three ledgers are equal (integers and words bitwise);
predictions within 1e-5 of the output's scale (the same factors served by
the two packages' matmuls); a loaded legacy artifact re-saved by the port
as v6 loads back bitwise.
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_thread  # noqa: E402,F401
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.comm.accounting import row_bits as ref_row_bits  # noqa: E402
from repro.core import DGPConfig as RefConfig  # noqa: E402
from repro.core import DistributedGP as RefGP  # noqa: E402
from repro.core import jax_scheme  # noqa: E402
from repro.core.gp import GPParams as RefParams  # noqa: E402
from repro_torch.checkpoint import array_checksum  # noqa: E402
from repro_torch.core import DGPConfig, DistributedGP  # noqa: E402


FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "legacy_artifact")
STEP = "00000000"
M, D, N_PER, N_SHARED = 4, 4, 11, 2
START = (0.2, -0.3, -1.5)
CASES = [("center", "nystrom"), ("center", "direct"), ("center", "nystrom_fitc"),
         ("broadcast", "nystrom"), ("broadcast", "direct"), ("poe", "dense")]


def _problem():
    rng = np.random.default_rng(3)
    X = rng.normal(size=(M * N_PER, D)).astype(np.float32)
    y = (np.sin(X[:, 0]) + 0.3 * X[:, 1]).astype(np.float32)
    parts = [(X[j::M], y[j::M]) for j in range(M)]
    parts[3] = (parts[3][0][:-1], parts[3][1][:-1])  # ragged: padded rows on the wire
    Xq = rng.normal(size=(9, D)).astype(np.float32)
    return parts, Xq


PARTS, XQ = _problem()


def _read(directory):
    arrays = dict(np.load(os.path.join(directory, f"ckpt_{STEP}.npz")))
    with open(os.path.join(directory, f"meta_{STEP}.json")) as f:
        return arrays, json.load(f)


def _write(directory, arrays, meta):
    os.makedirs(directory)
    np.savez(os.path.join(directory, f"ckpt_{STEP}.npz"), **arrays)
    with open(os.path.join(directory, f"meta_{STEP}.json"), "w") as f:
        json.dump(meta, f)


def _downgrade(src, dst, version):
    """Rewrite the v6 checkpoint ``src`` as format ``version`` (1, 2 or 4)."""
    arrays, meta = _read(src)
    for k in ("factors/Ainv", "factors/U", "factors/walpha"):  # v6: serve cache
        arrays.pop(k, None)
    arrays = {k: v for k, v in arrays.items() if not k.startswith("stream/")}  # v5
    arrays.pop("data/valid", None)  # v5: the column-validity mask
    meta.pop("fit_lengths")
    meta.pop("array_checksums")
    if version < 4:
        meta.pop("integrity_bits")
    if version < 3:
        meta.pop("payload_bits")
        words, rates = arrays.get("wire/codes"), arrays.get("wire/rates")
        if meta["scheme"] == "vq":  # vq never had codes: all -1 sentinels
            arrays["wire/codes"] = np.full(words.shape[:2] + rates.shape[1:], -1, np.int32)
        elif meta["has_wire"]:  # the unpacked int32 plane, -1 on padded rows
            total = ref_row_bits(meta["bits_per_sample"], rates.shape[1], meta["max_bits"])
            n_pad = words.shape[1]
            mask = jnp.asarray(np.arange(n_pad)[None, :]
                               < np.asarray(meta["lengths"])[:, None], jnp.float32)
            arrays["wire/codes"] = np.asarray(jax.vmap(
                lambda w, r, mk: jax_scheme.unpack_codes(w, r, total_bits=total, mask=mk)
            )(jnp.asarray(words), jnp.asarray(rates), mask)).astype(np.int32)
    if version == 1:
        for k in ("format_version", "scheme", "config"):
            meta.pop(k)
    else:
        meta["format_version"] = version
    if version >= 4:
        meta["array_checksums"] = {k: array_checksum(v) for k, v in arrays.items()}
    _write(dst, arrays, meta)


def _ref_cfg(protocol, mode):
    if protocol == "poe":
        return RefConfig(protocol="poe", fusion="rbcm", steps=5)
    if mode == "vq":  # the §4.1 test channel on the wire (scheme="vq")
        return RefConfig(protocol=protocol, scheme="vq", bits_per_sample=10, steps=5)
    return RefConfig(protocol=protocol, gram_mode=mode, bits_per_sample=10, steps=5)


@pytest.fixture(scope="module")
def sources(tmp_path_factory):
    """{case: v6 checkpoint directory written by the reference}."""
    root = tmp_path_factory.mktemp("v6")
    out = {}
    params = RefParams(*(jnp.float32(v) for v in START))
    for protocol, mode in CASES + [("center", "vq")]:
        est = RefGP(_ref_cfg(protocol, mode))
        d = str(root / f"{protocol}_{mode}")
        est.save(est.fit(parts=PARTS, params=params), d)
        out[protocol, mode] = d
    return out


def _close(got, want, rel=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rel,
                               atol=rel * max(1.0, np.abs(want).max()))


def _hold_against_reference(directory, Xq):
    """Load ``directory`` in both packages and hold the port against the
    reference's loader; returns the port's estimator, artifact and answers."""
    est = DistributedGP(device="cpu")
    art = est.load(directory)
    ref = RefGP.load(directory)
    want = {k: v for k, v in ref.config.asdict().items() if k != "faults"}
    got = {k: v for k, v in art.config.asdict().items() if k != "faults"}
    assert got == want and art.config.faults is None and ref.config.faults is None
    assert (art.protocol, art.gram_mode, art.scheme, art.fuse) == (
        ref.protocol, ref.gram_mode, ref.scheme, ref.fuse)
    assert (art.wire_bits, art.payload_bits, art.integrity_bits, art.rows_demoted) == (
        ref.wire_bits, ref.payload_bits, ref.integrity_bits, ref.rows_demoted)
    assert art.lengths == ref.lengths and art.fit_lengths == ref.fit_lengths
    assert int(art.stream.cols) == int(ref.stream.cols)
    assert sorted(art.factors) == sorted(ref.factors) and sorted(art.data) == sorted(ref.data)
    if ref.wire is None:
        assert art.wire is None
    else:
        assert ref.wire.codes.dtype == jnp.uint32 and art.wire.codes.dtype == torch.int32
        np.testing.assert_array_equal(art.wire.codes.numpy(),
                                      np.asarray(ref.wire.codes).view(np.int32))
    mu, var = est.predict(art, Xq)
    rmu, rvar = RefGP(RefConfig()).predict(ref, Xq)
    _close(mu.numpy(), rmu)
    _close(var.numpy(), rvar)
    return est, art, (mu, var)


def _roundtrip_is_bitwise(est, art, answers, Xq, directory):
    est.save(art, directory)
    back = est.load(directory)
    mu, var = est.predict(back, Xq)
    assert torch.equal(mu, answers[0]) and torch.equal(var, answers[1])
    assert sorted(back.factors) == sorted(art.factors)


def test_committed_v1_fixture_loads_and_serves(tmp_path):
    with open(os.path.join(FIXTURE, f"meta_{STEP}.json")) as f:
        meta = json.load(f)
    assert "config" not in meta and "format_version" not in meta
    Xt = np.load(os.path.join(FIXTURE, "expected.npz"))["Xt"]
    est, art, answers = _hold_against_reference(FIXTURE, Xt)
    assert art.config == DGPConfig.from_legacy_meta(meta)
    assert art.payload_bits == 0 and art.integrity_bits == 0  # never recorded
    assert "valid" in art.data and bool((art.data["valid"] == 1).all())
    _roundtrip_is_bitwise(est, art, answers, Xt, str(tmp_path / "v6"))


@pytest.mark.parametrize("version", [1, 2, 4])
@pytest.mark.parametrize("protocol,mode", CASES)
def test_synthesized_legacy_artifact_loads_and_serves(sources, tmp_path, protocol, mode,
                                                      version):
    legacy = str(tmp_path / f"v{version}")
    _downgrade(sources[protocol, mode], legacy, version)
    est, art, answers = _hold_against_reference(legacy, XQ)
    if version < 3 and art.wire is not None:
        # the packed plane is the one the v6 source stored, bit for bit
        v6 = est.load(sources[protocol, mode])
        assert torch.equal(art.wire.codes, v6.wire.codes)
    _roundtrip_is_bitwise(est, art, answers, XQ, str(tmp_path / "v6"))


@pytest.mark.parametrize("version", [2, 4])  # vq came with v2: no v1 artifact has it
def test_synthesized_vq_artifact_loads_and_serves(sources, tmp_path, version):
    """A vq artifact's plane has no words: a v2 one stored -1 sentinels,
    which both loaders turn into the zero-width word plane."""
    legacy = str(tmp_path / f"v{version}")
    _downgrade(sources["center", "vq"], legacy, version)
    est, art, answers = _hold_against_reference(legacy, XQ)
    assert art.scheme == "vq" and tuple(art.wire.codes.shape[2:]) == (0,)
    assert sorted(k for k in art.data if k.startswith("vq_")) == [
        "vq_A", "vq_W_half", "vq_rate_bits"]
    _roundtrip_is_bitwise(est, art, answers, XQ, str(tmp_path / "v6"))


def test_v4_poe_streamed_extras_are_folded(tmp_path):
    """Every machine's shard ends with the same N_SHARED points: the v6 fit
    of these shards IS the folded layout of a v4 artifact whose experts
    share those points as streamed extras."""
    rng = np.random.default_rng(4)
    Xe = rng.normal(size=(N_SHARED, D)).astype(np.float32)
    ye = rng.normal(size=N_SHARED).astype(np.float32)
    parts = [(np.concatenate([X[:9], Xe]), np.concatenate([y[:9], ye])) for X, y in PARTS]
    est = RefGP(_ref_cfg("poe", "dense"))
    src = str(tmp_path / "v6")
    est.save(est.fit(parts=parts, params=RefParams(*(jnp.float32(v) for v in START))), src)
    arrays, meta = _read(src)
    keep = 9
    arrays = {k: v for k, v in arrays.items() if not k.startswith("stream/")}
    for k in ("data/Xs", "data/mask", "data/sq_exact"):
        arrays[k] = arrays[k][:, :keep]
    arrays["y"] = arrays["y"][:, :keep]
    arrays["data/X_extra"] = Xe
    arrays["data/extra_mask"] = np.ones((M, N_SHARED), np.float32)
    arrays["data/y_extra"] = ye
    meta.pop("fit_lengths")
    meta["lengths"] = [keep] * M
    meta["format_version"] = 4
    meta["array_checksums"] = {k: array_checksum(v) for k, v in arrays.items()}
    _write(str(tmp_path / "v4"), arrays, meta)
    port, art, (mu, var) = _hold_against_reference(str(tmp_path / "v4"), XQ)
    assert "X_extra" not in art.data and art.data["Xs"].shape[1] == keep + N_SHARED
    assert int(art.stream.cols) == keep + N_SHARED
    # the fold rebuilds the v6 source's layout: the same answers
    mu6, var6 = port.predict(port.load(src), XQ)
    _close(mu.numpy(), mu6.numpy())
    _close(var.numpy(), var6.numpy())
