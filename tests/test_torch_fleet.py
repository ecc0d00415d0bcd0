"""Multi-tenant fleet serving (``repro_torch.core.fleet`` +
``repro_torch.launch.fleet``) against the reference's, on the CPU.

Sizes as the reference's own tests/test_fleet.py (M = 4 machines, N = 96
points, D = 4, 2 Adam steps, R = 8 bits/sample, 8 query points a request).
The data is built in numpy and split once; the REFERENCE fits the base
artifacts (broadcast on the fused route, center, poe-rbcm) and writes them
through its ``ArtifactStore.save``; the port loads them through its own
``ArtifactStore.load`` — so both packages serve the same tenants.  The
reference's fused fleet serve runs its Pallas ``epilogue_fleet`` body in
interpret mode (``REPRO_FORCE_PALLAS=1``); the port's runs the kernel's
plain version (CPU tensors).

Tolerances and why:
* port fleet vs reference fleet: 1e-5 relative to the output's scale, as
  the cross-package checkpoint tests hold the same factors served by the
  two packages' matmuls;
* stacked vs serial inside the port: 2e-4, as the reference holds its own
  (the two routes build the projector P in different batches and the
  center path's batched solves round differently);
* isolation, data pointers, swap counts, LRU order, zipf streams, loads
  on miss: exact (bitwise / integer-equal).
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_thread  # noqa: E402,F401
import jax  # noqa: E402

from repro.core import DGPConfig as RefConfig  # noqa: E402
from repro.core import DistributedGP as RefGP  # noqa: E402
from repro.core import fleet as rfleet  # noqa: E402
from repro.core.protocols import predict as ref_predict  # noqa: E402
from repro.launch import fleet as rlaunch  # noqa: E402
from repro_torch.core import DGPConfig as PortConfig  # noqa: E402
from repro_torch.core import DistributedGP as PortGP  # noqa: E402
from repro_torch.core import fleet  # noqa: E402
from repro_torch.core.fleet import (  # noqa: E402
    ArtifactCache, ArtifactStore, FleetStack, artifact_nbytes, bucket_key,
    pad_to_capacity, scale_targets,
)
from repro_torch.core.protocols.base import load_artifact, predict  # noqa: E402
from repro_torch.kernels import runtime  # noqa: E402
from repro_torch.launch.fleet import (  # noqa: E402
    FleetServer, MicroBatcher, build_fleet, main, serve_loop, zipf_tenants,
)


M, N, D, STEPS, BITS = 4, 96, 4, 2, 8
T_Q = 8  # query points per tenant request
CONFIGS = {
    "fused": dict(protocol="broadcast", fusion="kl", gram_backend="pallas",
                  bits_per_sample=BITS),
    "center": dict(bits_per_sample=BITS),
    "poe": dict(protocol="poe", fusion="rbcm", gram_backend="pallas"),
}


def _parts(seed):
    rng = np.random.default_rng(seed)
    W = rng.normal(size=(D, 2))
    X = rng.normal(size=(N, D)).astype(np.float32)
    y = (np.sin(X @ W[:, 0]) + 0.4 * (X @ W[:, 1])
         + 0.05 * rng.normal(size=N)).astype(np.float32)
    return [(X[c], y[c]) for c in np.array_split(rng.permutation(N), M)]


def _queries(S, seed=2):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(S, T_Q, D)).astype(np.float32)


def _close(got, want, rel):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rel, atol=rel * max(1.0, np.abs(want).max()))


class _ForcePallas:
    """REPRO_FORCE_PALLAS=1 with the reference's compiled programs dropped
    on both sides, so its fleet epilogue traces anew in interpret mode."""

    def __enter__(self):
        self.old = os.environ.get("REPRO_FORCE_PALLAS")
        os.environ["REPRO_FORCE_PALLAS"] = "1"
        jax.clear_caches()

    def __exit__(self, *exc):
        jax.clear_caches()
        if self.old is None:
            os.environ.pop("REPRO_FORCE_PALLAS", None)
        else:
            os.environ["REPRO_FORCE_PALLAS"] = self.old


@pytest.fixture(scope="module")
def bases(tmp_path_factory):
    """{kind: (reference artifact, port artifact)}: fitted by the reference,
    handed over through the two packages' stores."""
    root = tmp_path_factory.mktemp("ref_store")
    rstore, pstore = rfleet.ArtifactStore(str(root)), ArtifactStore(str(root), device="cpu")
    out = {}
    for i, (kind, cfg) in enumerate(CONFIGS.items()):
        ref = RefGP(RefConfig(steps=STEPS, **cfg)).fit(parts=_parts(i))
        rstore.save(kind, ref)
        out[kind] = (ref, pstore.load(kind))
    assert "Ainv" in out["fused"][1].factors  # precondition: the fused route
    return out


def _tenants(base, n, start=0.3, step=0.2, scale=scale_targets):
    """n distinct same-bucket tenants via exact y-scaling."""
    return {i: scale(base, start + step * i) for i in range(n)}


# --------------------------------------------------------------------------
# equivalence
# --------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["fused", "center"])
def test_fleet_predict_matches_reference(kind, bases):
    ref, art = bases[kind]
    tids = [3, 0, 4, 1, 3]  # repeats allowed
    Xq = _queries(len(tids))
    mu, var = FleetStack(_tenants(art, 5), slots=8).predict(tids, Xq)
    with _ForcePallas():
        rmu, rvar = rfleet.FleetStack(_tenants(ref, 5, scale=rfleet.scale_targets),
                                      slots=8).predict(tids, Xq)
    _close(mu.numpy(), rmu, 1e-5)
    _close(var.numpy(), rvar, 1e-5)


@pytest.mark.parametrize("kind", ["fused", "center", "poe"])
def test_stacked_predict_matches_serial(kind, bases):
    tenants = _tenants(bases[kind][1], 5)
    tids = [3, 0, 4, 1, 3]
    Xq = _queries(len(tids))
    mu_s, var_s = FleetStack(tenants, slots=8).predict(tids, Xq)
    for s, tid in enumerate(tids):
        mu_1, var_1 = predict(tenants[tid], Xq[s])
        np.testing.assert_allclose(mu_s[s].numpy(), mu_1.numpy(), rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(var_s[s].numpy(), var_1.numpy(), rtol=2e-4, atol=2e-4)


def test_fused_predict_is_one_fleet_epilogue_call(bases, monkeypatch):
    """Each fused-route predict reduces every tenant in ONE
    ``epilogue_moments_fleet`` call and never calls the single-tenant
    epilogue; on CPU tensors no kernel launches at all (the card's launch
    counts are checked in tests/test_torch_gpu.py and chip_smoke.py)."""
    from repro_torch.kernels.epilogue import ops

    calls = {"fleet": 0, "single": 0}
    fleet_fn, single_fn = ops.epilogue_moments_fleet, ops.epilogue_moments

    def counted(key, fn):
        def wrapper(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapper

    monkeypatch.setattr(ops, "epilogue_moments_fleet", counted("fleet", fleet_fn))
    monkeypatch.setattr(ops, "epilogue_moments", counted("single", single_fn))
    stack = FleetStack(_tenants(bases["fused"][1], 4), slots=4)
    runtime.reset_launches()
    for n in range(3):
        stack.predict([0, 1, 2, 3][: n + 2], _queries(n + 2))
    assert calls == {"fleet": 3, "single": 0}
    assert set(runtime.launches().values()) == {0}


def test_scale_targets_is_exact(bases):
    """The center's GP variance never depends on y, so it stays BITWISE;
    the mean scales by c; the broadcast KL variance shifts with the expert
    means, so only its mean is checked."""
    Xq = _queries(1)[0]
    for kind in ("center", "fused"):
        art = bases[kind][1]
        mu0, var0 = predict(art, Xq)
        mu2, var2 = predict(scale_targets(art, -2.0), Xq)
        np.testing.assert_allclose(mu2.numpy(), -2.0 * mu0.numpy(), rtol=1e-5, atol=1e-5)
        if kind == "center":
            assert torch.equal(var2, var0)
        ref = bases[kind][0]
        r = rfleet.scale_targets(ref, -2.0)
        np.testing.assert_array_equal(scale_targets(art, -2.0).y.numpy(), np.asarray(r.y))


# --------------------------------------------------------------------------
# isolation
# --------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["fused", "center"])
def test_nan_query_tenant_is_isolated(kind, bases):
    stack = FleetStack(_tenants(bases[kind][1], 3), slots=4)
    Xq = _queries(3)
    mu_ref, var_ref = stack.predict([0, 1, 2], Xq)
    hostile = Xq.copy()
    hostile[1] = np.nan
    mu_h, var_h = stack.predict([0, 1, 2], hostile)
    for s in (0, 2):
        assert torch.equal(mu_h[s], mu_ref[s]) and torch.equal(var_h[s], var_ref[s])
    assert bool(torch.isfinite(mu_h[1]).all()) and bool(torch.isfinite(var_h[1]).all())
    assert bool((mu_h[1] == 0).all())


def test_degraded_mask_tenant_is_isolated(bases):
    tenants = _tenants(bases["fused"][1], 3)
    stack = FleetStack(tenants, slots=4)
    Xq = _queries(3)
    healthy = np.ones((3, M), np.float32)
    mu_ref, var_ref = stack.predict([0, 1, 2], Xq, healthy)
    degraded = healthy.copy()
    degraded[1, 0] = 0.0
    mu_d, var_d = stack.predict([0, 1, 2], Xq, degraded)
    for s in (0, 2):
        assert torch.equal(mu_d[s], mu_ref[s]) and torch.equal(var_d[s], var_ref[s])
    mu_1, var_1 = predict(tenants[1], Xq[1], available=degraded[1])
    np.testing.assert_allclose(mu_d[1].numpy(), mu_1.numpy(), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(var_d[1].numpy(), var_1.numpy(), rtol=2e-4, atol=2e-4)


# --------------------------------------------------------------------------
# the gram modes no other test stacks: center direct / nystrom_fitc and
# broadcast direct (each served through the per-tenant loop)
# --------------------------------------------------------------------------

MODE_CONFIGS = {
    "center_direct": dict(bits_per_sample=BITS, gram_mode="direct"),
    "center_fitc": dict(bits_per_sample=BITS, gram_mode="nystrom_fitc"),
    "broadcast_direct": dict(protocol="broadcast", fusion="kl", gram_mode="direct",
                             bits_per_sample=BITS),
}


@pytest.fixture(scope="module")
def mode_bases(tmp_path_factory):
    """{kind: (reference artifact, port artifact)}: fitted by the port and
    handed to the reference through the two packages' stores (cross-loaded,
    as ``bases`` is the other way round; a reference fit per mode would cost
    seconds of JAX compilation each)."""
    root = tmp_path_factory.mktemp("port_store")
    rstore, pstore = rfleet.ArtifactStore(str(root)), ArtifactStore(str(root), device="cpu")
    out = {}
    for i, (kind, cfg) in enumerate(MODE_CONFIGS.items()):
        art = PortGP(PortConfig(steps=STEPS, **cfg), device="cpu").fit(parts=_parts(i))
        pstore.save(kind, art)
        out[kind] = (rstore.load(kind), pstore.load(kind))
        assert out[kind][1].gram_mode == cfg["gram_mode"]
    return out


@pytest.mark.parametrize("kind", sorted(MODE_CONFIGS))
def test_gram_mode_stacked_predict_matches_serial(kind, mode_bases):
    tenants = _tenants(mode_bases[kind][1], 5)
    tids = [3, 0, 4, 1, 3]
    Xq = _queries(len(tids))
    stack = FleetStack(tenants, slots=8)
    assert not stack.fused
    mu_s, var_s = stack.predict(tids, Xq)
    for s, tid in enumerate(tids):
        mu_1, var_1 = predict(tenants[tid], Xq[s])
        np.testing.assert_allclose(mu_s[s].numpy(), mu_1.numpy(), rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(var_s[s].numpy(), var_1.numpy(), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("kind", sorted(MODE_CONFIGS))
def test_gram_mode_nan_query_tenant_is_isolated(kind, mode_bases):
    stack = FleetStack(_tenants(mode_bases[kind][1], 3), slots=4)
    Xq = _queries(3)
    mu_ref, var_ref = stack.predict([0, 1, 2], Xq)
    hostile = Xq.copy()
    hostile[1] = np.nan
    mu_h, var_h = stack.predict([0, 1, 2], hostile)
    for s in (0, 2):
        assert torch.equal(mu_h[s], mu_ref[s]) and torch.equal(var_h[s], var_ref[s])
    assert bool(torch.isfinite(mu_h[1]).all()) and bool(torch.isfinite(var_h[1]).all())
    assert bool((mu_h[1] == 0).all())


@pytest.mark.parametrize("kind", sorted(MODE_CONFIGS))
def test_gram_mode_fleet_predict_matches_reference(kind, mode_bases):
    ref, art = mode_bases[kind]
    tids = [3, 0, 4, 1, 3]
    Xq = _queries(len(tids))
    mu, var = FleetStack(_tenants(art, 5), slots=8).predict(tids, Xq)
    rmu, rvar = rfleet.FleetStack(_tenants(ref, 5, scale=rfleet.scale_targets),
                                  slots=8).predict(tids, Xq)
    _close(mu.numpy(), rmu, 1e-5)
    _close(var.numpy(), rvar, 1e-5)


# --------------------------------------------------------------------------
# residency: admits, evictions, rejections
# --------------------------------------------------------------------------


def test_admits_and_evictions_keep_tensors_and_count_swaps(bases):
    """The reference's retrace check becomes: no stacked tensor (nor the
    resident projector) is reallocated, and swaps count as the reference
    counts them for the same sequence."""
    (ref, art) = bases["fused"]
    ops = [("predict", [0, 1, 2]), ("predict", [2, 0, 3]), ("admit", 4), ("admit", 5),
           ("predict", [4, 5, 3]), ("admit", 0), ("predict", [0, 0, 0])]
    stacks = []
    for pkg, tenants in ((fleet, _tenants(art, 6)),
                         (rfleet, _tenants(ref, 6, scale=rfleet.scale_targets))):
        stack = pkg.FleetStack(dict(list(tenants.items())[:4]), slots=4)
        ptrs = stack.data_ptrs() if pkg is fleet else None
        for op, arg in ops:
            if op == "admit":
                stack.admit(arg, tenants[arg])
            else:
                stack.predict(arg, _queries(3))
        if pkg is fleet:
            assert stack.data_ptrs() == ptrs and "proj" in ptrs
        stacks.append(stack)
    assert stacks[0].swaps == stacks[1].swaps == 2
    assert stacks[0].tenants() == stacks[1].tenants()


def test_stack_rejects_nonresident_and_heterogeneous(bases):
    msgs = []
    for pkg, i in ((fleet, 1), (rfleet, 0)):
        fused, center = bases["fused"][i], bases["center"][i]
        stack = pkg.FleetStack(_tenants(fused, 2, scale=pkg.scale_targets), slots=4)
        got = []
        with pytest.raises(KeyError, match="not resident") as e:
            stack.predict([0, 99], _queries(2))
        got.append(str(e.value))
        with pytest.raises(ValueError, match="bucket-compatible") as e:
            stack.admit(7, center)
        got.append(str(e.value))
        with pytest.raises(ValueError, match="bucket-compatible") as e:
            pkg.stack_artifacts([fused, center])
        got.append(str(e.value))
        msgs.append(got)
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("kind", ["center", "fused", "poe"])
def test_pad_to_capacity_predicts_as_unpadded_and_as_the_reference(kind, bases, tmp_path):
    """A fresh fit padded to a larger capacity keeps its answers and pads
    exactly as the reference pads."""
    from repro.core.protocols import save_artifact as ref_save
    from repro_torch.checkpoint import load_artifact_arrays
    from repro_torch.core.protocols.base import artifact_arrays

    ref, art = bases[kind]
    cap = 2 * int(art.y.shape[-1])
    padded = pad_to_capacity(art, cap)
    assert int(padded.y.shape[-1]) == cap and bucket_key(padded) != bucket_key(art)
    assert pad_to_capacity(padded, cap) is padded
    with pytest.raises(ValueError, match="never shrink"):
        pad_to_capacity(padded, cap // 2)
    ref_save(rfleet.pad_to_capacity(ref, cap), str(tmp_path))
    _, want = load_artifact_arrays(str(tmp_path))
    got = artifact_arrays(padded)
    assert sorted(got) == sorted(want)
    for k in got:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    Xq = _queries(1)[0]
    for a, b in zip(predict(padded, Xq), predict(art, Xq)):
        _close(a.numpy(), b.numpy(), 1e-5)
    with _ForcePallas():
        rmu, rvar = ref_predict(rfleet.pad_to_capacity(ref, cap), Xq)
    for a, b in zip(predict(padded, Xq), (rmu, rvar)):
        _close(a.numpy(), b, 1e-5)


def test_pad_to_capacity_cobuckets_streamed_artifacts(bases):
    """The reference's test of the same name: a fresh fit (exact-size
    buffers) and a streamed artifact (grown buffers) land in different
    buckets until padded to a common capacity, and the padded artifact
    predicts as the fresh one; the streamed artifact answers as the
    reference's after the same update (1e-5 of scale)."""
    from repro.core.protocols import update as ref_update
    from repro_torch.core.protocols.base import update

    ref, base_center = bases["center"]
    rng = np.random.default_rng(3)
    Xn = rng.normal(size=(4, D)).astype(np.float32)
    yn = np.zeros(4, np.float32)
    streamed = update(base_center, Xn, yn, machine=0)
    assert bucket_key(streamed) != bucket_key(base_center)
    cap = int(streamed.y.shape[-1])
    fresh_padded = pad_to_capacity(base_center, cap)
    assert bucket_key(fresh_padded) == bucket_key(streamed)
    Xq = _queries(1)[0]
    for a, b in zip(predict(fresh_padded, Xq), predict(base_center, Xq)):
        _close(a.numpy(), b.numpy(), 1e-5)
    for a, b in zip(predict(streamed, Xq), ref_predict(ref_update(ref, Xn, yn, machine=0), Xq)):
        _close(a.numpy(), b, 1e-5)
    stack = FleetStack({0: fresh_padded, 1: streamed})
    mu_s, _ = stack.predict([0, 1], _queries(2))
    assert bool(torch.isfinite(mu_s).all())


# --------------------------------------------------------------------------
# cache plane: LRU, bytes, bitwise load-on-miss, stores across packages
# --------------------------------------------------------------------------


def test_cache_lru_eviction_and_load_on_miss(bases, tmp_path):
    tenants = _tenants(bases["fused"][1], 4)
    store = ArtifactStore(str(tmp_path), device="cpu")
    for tid, art in tenants.items():
        store.save(tid, art)
    assert store.tenants() == sorted(str(t) for t in tenants)
    cache = ArtifactCache(store.load, capacity=2)
    cache.get(0), cache.get(1)
    cache.get(0)  # refresh 0: now 1 is LRU
    cache.get(2)  # evicts 1
    assert 1 not in cache and 0 in cache and 2 in cache
    assert (cache.hits, cache.misses, cache.evictions) == (1, 3, 1)
    art_c = cache.get(1)
    art_d = load_artifact(store.path(1), device="cpu")
    Xq = _queries(1)[0]
    for a, b in zip(predict(art_c, Xq), predict(art_d, Xq)):
        assert torch.equal(a, b)
    for a, b in zip(predict(art_c, Xq), predict(tenants[1], Xq)):
        assert torch.equal(a, b)
    assert store.meta(1)["protocol"] == "broadcast"


def test_cache_byte_capacity(bases):
    ref, art = bases["fused"]
    nb = artifact_nbytes(art)
    assert nb == rfleet.artifact_nbytes(ref)
    tenants = _tenants(art, 3)
    cache = ArtifactCache(lambda t: tenants[t], capacity_bytes=2 * nb)
    cache.get(0), cache.get(1)
    assert cache.total_bytes == 2 * nb
    cache.get(2)  # over budget -> evict LRU tenant 0
    assert 0 not in cache and cache.total_bytes == 2 * nb
    tiny = ArtifactCache(lambda t: tenants[t], capacity_bytes=nb // 2)
    tiny.get(0)  # bigger than the budget: kept, not refused
    assert 0 in tiny and len(tiny) == 1


@pytest.mark.parametrize("direction", ["port_to_reference", "reference_to_port"])
def test_store_loads_across_packages(direction, bases, tmp_path):
    ref, art = bases["fused"]
    pstore = ArtifactStore(str(tmp_path), device="cpu")
    rstore = rfleet.ArtifactStore(str(tmp_path))
    if direction == "port_to_reference":
        pstore.save("a", scale_targets(art, 1.5))
        got, want = pstore.load("a"), rstore.load("a")
    else:
        rstore.save("a", rfleet.scale_targets(ref, 1.5))
        got, want = pstore.load("a"), rstore.load("a")
    assert rstore.tenants() == pstore.tenants() == ["a"]
    assert pstore.meta("a") == rstore.meta("a")
    Xq = _queries(1)[0]
    with _ForcePallas():
        rmu, rvar = ref_predict(want, Xq)
    mu, var = predict(got, Xq)
    _close(mu.numpy(), rmu, 1e-5)
    _close(var.numpy(), rvar, 1e-5)


# --------------------------------------------------------------------------
# request plane: batcher, server, traffic, CLI
# --------------------------------------------------------------------------


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def test_microbatcher_flushes_on_size_and_budget():
    clk = FakeClock()
    mb = MicroBatcher(slots=3, budget_ms=5.0, clock=clk)
    assert mb.add("a", 1) is None and mb.add("b", 2) is None
    batch = mb.add("c", 3)  # third request fills the slots
    assert [r.tenant for r in batch] == ["a", "b", "c"] and len(mb) == 0
    mb.add("d", 4)
    assert not mb.due()
    clk.t += 0.0049
    assert not mb.due()  # 4.9 ms < 5 ms budget
    clk.t += 0.0002
    assert mb.due()  # 5.1 ms >= budget
    assert [r.tenant for r in mb.flush()] == ["d"]
    assert not mb.due()  # an empty queue is never due


def test_fleet_server_end_to_end(bases, tmp_path):
    store, tids = build_fleet([bases["fused"][1]], 10, str(tmp_path), device="cpu")
    clk = FakeClock()
    server = FleetServer(store, cache_artifacts=6, slots=3, budget_ms=5.0, clock=clk,
                         device="cpu")
    rng = np.random.default_rng(4)
    mk = lambda i: rng.normal(size=(T_Q, D)).astype(np.float32)
    stats = serve_loop(server, zipf_tenants(tids, 20, seed=1), mk)
    assert stats["completed"] == 20
    assert stats["cache"]["misses"] >= 6  # cold start + capacity pressure
    assert stats["requests"] == 20 and stats["stacks"] == 1
    assert stats["fused_dispatches"] == stats["flushes"]
    # a ragged tail flush (padded to the fixed width) answers correctly
    assert server.submit(tids[0], mk(0)) == []
    server.batcher._queue[0].enqueued_at -= 1.0  # age it past the budget
    done = server.poll()
    assert len(done) == 1 and done[0][0] == tids[0]


def test_fleet_server_padded_tail_matches_direct(bases, tmp_path):
    store, tids = build_fleet([bases["fused"][1]], 4, str(tmp_path), device="cpu")
    server = FleetServer(store, cache_artifacts=4, slots=4, budget_ms=0.0, device="cpu")
    Xq = np.random.default_rng(5).normal(size=(T_Q, D)).astype(np.float32)
    server.submit(tids[2], Xq)
    (tid, mu, var, lat), = server.poll()  # budget 0 -> due immediately
    assert tid == tids[2] and lat >= 0.0
    mu_d, var_d = predict(store.load(tids[2]), Xq)
    np.testing.assert_allclose(mu.numpy(), mu_d.numpy(), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(var.numpy(), var_d.numpy(), rtol=2e-4, atol=2e-4)


def test_build_fleet_matches_the_reference_store(bases, tmp_path):
    ref, art = bases["center"]
    _, tids = build_fleet([art], 3, str(tmp_path / "port"), device="cpu")
    _, rtids = rlaunch.build_fleet([ref], 3, str(tmp_path / "ref"))
    assert tids == rtids
    pstore = ArtifactStore(str(tmp_path / "port"), device="cpu")
    rstore = ArtifactStore(str(tmp_path / "ref"), device="cpu")
    for tid in tids:
        np.testing.assert_array_equal(pstore.load(tid).y.numpy(), rstore.load(tid).y.numpy())


@pytest.mark.parametrize("a,seed", [(1.1, 0), (0.8, 3)])
def test_zipf_tenants_is_the_reference_stream(a, seed):
    tids = [f"{i:04d}" for i in range(37)]
    got = zipf_tenants(tids, 200, a=a, seed=seed)
    assert got == rlaunch.zipf_tenants(tids, 200, a=a, seed=seed)
    assert len(set(got)) < len(tids)  # a cold tail goes unsampled


def test_fleet_cli_runs_on_cpu(tmp_path, capsys):
    main(["--device", "cpu", "--tenants", "6", "--requests", "24", "--steps", "1",
          "--n", "48", "--d", "3", "--cache", "4", "--slots", "4",
          "--store-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "stacks reallocated: 0" in out and "served 24 requests" in out
