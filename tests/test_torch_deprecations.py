"""The port's legacy entry points (``repro_torch.core.distributed_gp``)
against the reference's (``repro.core.distributed_gp``), on the CPU.

* Each of the seven wrappers (quantize_to_center, single_center_gp,
  broadcast_gp, poe_baseline, fit, predict, update) warns exactly once per
  process, with a message that starts
  ``repro_torch.core.distributed_gp.<name> is deprecated``.
* Delegation is faithful: each wrapper returns, bitwise, what the call it
  wraps returns for the same arguments.
* The kwargs-form ``fit`` matches the reference's legacy ``fit`` on the same
  parts (m = 4, n = 96, d = 4, two Adam steps): the same ledgers, lengths
  and rates (integers, exactly) and predictions within 2e-4 of scale, the
  tolerance tests/test_torch_center.py holds trained fits to.
* The mesh names are the port's (``machine_mesh`` is ``machine_group``),
  and the kwargs-form ``fit`` with ``impl="mesh"`` refuses in one process
  and, on one process per machine, fits with the reference's ledgers.
"""
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_thread  # noqa: E402,F401
from _torch_mesh import call  # noqa: E402
import jax  # noqa: E402,F401

from repro.core import distributed_gp as ref_dgp  # noqa: E402
from repro_torch.core import distributed_gp as dgp  # noqa: E402
from repro_torch.core.config import DGPConfig  # noqa: E402
from repro_torch.core.protocols import base, broadcast, center, mesh, poe  # noqa: E402
from repro_torch.launch.ranks import run_ranks  # noqa: E402

M, N, D = 4, 96, 4
DEPRECATED = ("quantize_to_center", "single_center_gp", "broadcast_gp", "poe_baseline",
              "fit", "predict", "update")
CPU = {"device": "cpu"}


def _problem():
    rng = np.random.default_rng(0)
    W = rng.normal(size=(D, 2))
    X = rng.normal(size=(N, D)).astype(np.float32)
    y = (np.sin(X @ W[:, 0]) + 0.4 * (X @ W[:, 1])
         + 0.05 * rng.normal(size=N)).astype(np.float32)
    parts = [(X[c], y[c]) for c in np.array_split(rng.permutation(N), M)]
    Xt = rng.normal(size=(8, D)).astype(np.float32)
    return parts, Xt


def _close(got, want, rel):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rel, atol=rel * max(1.0, np.abs(want).max()))


def _equal(a, b):
    """Bitwise equality of nested tuples of tensors / ints."""
    if isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor) and torch.equal(a, b)
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    else:
        assert a == b


def test_deprecated_wrappers_warn_exactly_once_each():
    parts, Xt = _problem()
    dgp._WARNED.clear()  # independent of the order the suite runs in
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        for _ in range(2):
            art = dgp.fit(parts, 8, "center", steps=0, **CPU)
            dgp.predict(art, Xt)
        Xn = np.zeros((2, D), np.float32)
        dgp.update(art, Xn, np.zeros(2, np.float32), machine=0)
        dgp.update(art, Xn, np.zeros(2, np.float32), machine=1)
        for _ in range(2):
            dgp.quantize_to_center(parts, 8, **CPU)
            dgp.single_center_gp(parts, 8, steps=0, **CPU)
            dgp.broadcast_gp(parts, 8, Xt, steps=0, **CPU)
            dgp.poe_baseline(parts, Xt, steps=0, **CPU)
    ours = [str(w.message) for w in rec
            if issubclass(w.category, DeprecationWarning)
            and str(w.message).startswith("repro_torch.core.distributed_gp.")]
    for name in DEPRECATED:
        hits = [m for m in ours
                if m.startswith(f"repro_torch.core.distributed_gp.{name} is deprecated")]
        assert len(hits) == 1, f"{name}: expected exactly 1 warning, got {hits}"
    assert len(ours) == len(DEPRECATED)
    assert sorted(DEPRECATED) == sorted(n for n in dgp.__all__ if n in DEPRECATED)
    assert sorted(DEPRECATED) == sorted(n for n in ref_dgp.__all__ if n in DEPRECATED)


@pytest.mark.parametrize("name", DEPRECATED)
def test_wrappers_delegate_bitwise(name):
    parts, Xt = _problem()
    cfg = DGPConfig(protocol="center", bits_per_sample=8, steps=2)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        if name == "fit":
            got = dgp.fit(parts, 8, "center", steps=2, **CPU)
            want = base.fit(parts, cfg, None, "cpu")
            _equal(base.predict(got, Xt), base.predict(want, Xt))
            assert got.config == want.config
            return
        art = base.fit(parts, cfg, None, "cpu")
        Xn = np.ones((3, D), np.float32)
        calls = {
            "predict": (lambda f: f(art, Xt), dgp.predict, base.predict),
            "update": (lambda f: base.predict(f(art, Xn, np.ones(3, np.float32), machine=2),
                                              Xt), dgp.update, base.update),
            "quantize_to_center": (lambda f: f(parts, 8, **CPU), dgp.quantize_to_center,
                                   center.quantize_to_center),
            "single_center_gp": (lambda f: f(parts, 8, steps=2, **CPU).predict(Xt),
                                 dgp.single_center_gp, center.single_center_gp),
            "broadcast_gp": (lambda f: f(parts, 8, Xt, steps=2, **CPU)[:3],
                             dgp.broadcast_gp, broadcast.broadcast_gp),
            "poe_baseline": (lambda f: f(parts, Xt, steps=2, **CPU)[:2],
                             dgp.poe_baseline, poe.poe_baseline),
        }
        run, old, new = calls[name]
        _equal(run(old), run(new))


def test_legacy_kwargs_fit_matches_the_reference_legacy_fit():
    """The same kwargs in both packages: gram mode direct (the reference's
    cheapest center fit to compile) at R = 8, two Adam steps."""
    parts, Xt = _problem()
    kw = dict(steps=2, gram_mode="direct", lr=0.05, max_bits=12)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        ref = ref_dgp.fit(parts, 8, "center", **kw)
        rmu, rvar = ref_dgp.predict(ref, Xt)
        art = dgp.fit(parts, 8, "center", **kw, **CPU)
        mu, var = dgp.predict(art, Xt)
    assert (art.wire_bits, art.payload_bits, art.integrity_bits) == \
        (int(ref.wire_bits), int(ref.payload_bits), int(ref.integrity_bits))
    assert art.lengths == tuple(ref.lengths) and art.gram_mode == ref.gram_mode == "direct"
    np.testing.assert_array_equal(art.wire.rates.numpy(), np.asarray(ref.wire.rates))
    assert art.config.asdict() == ref.config.asdict()
    _close(mu.numpy(), rmu, 2e-4)
    _close(var.numpy(), rvar, 2e-4)


@pytest.mark.parametrize("kw, exc, match", [
    ({"train_impl": "unrolled"}, ValueError, "train_impl 'unrolled'"),
    ({"impl": "host"}, ValueError, 'impl must be "batched" or "mesh"'),
    ({"impl": "mesh"}, ValueError, "one process per machine"),
    ({"gram_mode": "dense"}, ValueError, "dense"),
])
def test_legacy_fit_refuses_what_it_cannot_honour(kw, exc, match):
    parts, _ = _problem()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        with pytest.raises(exc, match=match):
            dgp.fit(parts, 8, "center", steps=0, **kw, **CPU)


@pytest.mark.parametrize("name", ["broadcast_gp_mesh", "machine_mesh", "MESH_AXIS"])
def test_mesh_names_raise_naming_their_slice(name):
    # the mesh is ported: each name the reference exports is the port's own
    assert hasattr(ref_dgp, name) and name in dgp.__all__
    got = getattr(dgp, name)
    if name == "MESH_AXIS":
        assert got == ref_dgp.MESH_AXIS == "machines"
    else:
        assert got is getattr(mesh, "machine_group" if name == "machine_mesh" else name)
    with pytest.raises(AttributeError):
        dgp.no_such_name  # noqa: B018


def test_legacy_mesh_fit_has_the_reference_legacy_ledgers():
    """The kwargs-form fit with impl="mesh" on four processes: the
    reference's legacy fit's ledgers and lengths (the reference's mesh and
    batched ledgers are equal, tests/test_conformance.py)."""
    parts, Xt = _problem()
    kw = dict(steps=2, gram_mode="direct", lr=0.05, max_bits=12)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        ref = ref_dgp.fit(parts, 8, "center", **kw)
    got = run_ranks(M, call, "repro_torch.core.distributed_gp.fit", parts, 8, "center",
                    impl="mesh", **kw, **CPU)
    assert all(a["impl"] == "mesh" for a in got)
    assert {(a["wire_bits"], a["payload_bits"], a["integrity_bits"]) for a in got} == {
        (int(ref.wire_bits), int(ref.payload_bits), int(ref.integrity_bits))}
    assert tuple(got[0]["lengths"]) == tuple(ref.lengths)
