"""repro_torch's CUDA kernels and main path on the card (``gpu`` marker).

These tests import neither JAX nor the JAX package, so they run on a machine
that has only PyTorch for CUDA: ``python -m pytest -q -m gpu
tests/test_torch_gpu.py``.  Without a card every test skips (the decision is
taken inside the ``cuda`` fixture, so every worker collects the same tests).
Each kernel is held against its plain PyTorch version on the same inputs:
fp32 sums in different orders, no TF32, so rtol 1e-5 with atol 1e-5 times
the output's scale (the quantizer encode and decode: bitwise; decode
attention: 1e-5 x max|V|, its output being a convex combination of V's
rows) — except the epilogue, whose variance cancels
(s2 = gss - quad): it is held within ``epilogue_error_bound``, the fp32
rounding of its sums against the sum of their absolute terms, carried
through each fusion's rows (tests/test_torch_epilogue.py checks that bound
against a float64 evaluation); the fleet epilogue within the same bound
applied per tenant.  The broadcast and poe paths serve a
checkpoint on the card and on the CPU: 1e-4 of the output's scale, the
fused serve's cancellation at this small, well-conditioned size.  The
mesh (``impl="mesh"``: 4 spawned ranks on the card) against the batched
fit on the card: ledgers and every rank's bits exact, answers within 2e-3
of scale (each rank fits its scheme alone, where the batched fit solves
the machines' eigenproblems as one batch, and ten Adam steps follow), one
all-reduce and no factorization a warm broadcast or poe request.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_mesh import fit_predict, serve_structure  # noqa: E402
from repro_torch.core import DGPConfig, DistributedGP  # noqa: E402
from repro_torch.core import torch_scheme as TS  # noqa: E402
from repro_torch.kernels import runtime  # noqa: E402
from repro_torch.kernels.gram.ops import gram, gram_cuda, gram_plain  # noqa: E402
from repro_torch.core.fleet import FleetStack, scale_targets  # noqa: E402
from repro_torch.kernels.epilogue.cases import (  # noqa: E402
    epilogue_fleet_operands, epilogue_operands,
)
from repro_torch.kernels.epilogue.ops import epilogue_cuda, epilogue_fleet_cuda  # noqa: E402
from repro_torch.kernels.epilogue.ref import (  # noqa: E402
    EPILOGUE_FUSES, epilogue_error_bound, epilogue_fleet_error_bound,
    epilogue_moments_fleet_plain, epilogue_moments_plain,
)
from repro_torch.kernels.qgram.ops import (  # noqa: E402
    qgram_cuda, qgram_packed_cuda, qgram_packed_plain, qgram_plain,
)
from repro_torch.kernels.quant.cases import qgram_operands, quant_operands  # noqa: E402
from repro_torch.kernels.quant.ops import (  # noqa: E402
    decode_cuda, decode_plain, encode_cuda, encode_plain,
)
from repro_torch.kernels.decode_attn.cases import decode_attn_operands  # noqa: E402
from repro_torch.kernels.decode_attn.ops import (  # noqa: E402
    decode_attn_cuda, decode_attn_plain,
)

pytestmark = pytest.mark.gpu


@pytest.fixture(autouse=True, scope="module")
def _tune_cache(tmp_path_factory):
    """The autotune cache of this file's calls: a file of its own, not
    the user's."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_TUNE_CACHE", str(tmp_path_factory.mktemp("tune") / "autotune.json"))
        runtime.clear_cache_memory()
        yield
    runtime.clear_cache_memory()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA card (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-5, atol=1e-5 * scale)


@pytest.mark.parametrize("n,p,d", [(128, 25, 21), (25, 25, 21), (130, 70, 50),
                                   (1, 1, 1), (4449, 1000, 21)])
def test_gram_kernel_and_backward(cuda, n, p, d):
    g = torch.Generator().manual_seed(n + p + d)
    x, y = torch.randn(n, d, generator=g), torch.randn(p, d, generator=g)
    before = runtime.family("gram").launches
    got = gram_cuda(x.to(cuda), y.to(cuda))
    torch.cuda.synchronize()
    assert runtime.family("gram").launches == before + 1
    _close(got.cpu().numpy(), gram_plain(x, y).numpy())
    xr, yr = x.to(cuda).requires_grad_(True), y.to(cuda).requires_grad_(True)
    gg = torch.randn(n, p, generator=g)
    gram(xr, yr).backward(gg.to(cuda))
    _close(xr.grad.cpu().numpy(), (gg @ y).numpy())
    _close(yr.grad.cpu().numpy(), (gg.T @ x).numpy())


def _packed(seed, m, n, d, p, R, zero_dims=(), mask_frac=0.0, cap=12):
    rng = np.random.default_rng(seed)
    live = [j for j in range(d) if j not in zero_dims]
    rates = np.zeros((m, d), np.int64)
    for i in range(m):
        for _ in range(R):
            j = live[rng.integers(len(live))]
            rates[i, j] = min(rates[i, j] + 1, cap)
    codes = rng.integers(0, 2 ** rates[:, None, :], size=(m, n, d))
    words = TS.pack_codes(torch.from_numpy(codes), torch.from_numpy(rates), total_bits=R)
    return [words, torch.from_numpy(rates).int(),
            torch.from_numpy(rng.normal(size=(m, d, 2**cap)).astype(np.float32)),
            torch.from_numpy(rng.normal(size=(m, p, d)).astype(np.float32)),
            torch.from_numpy((rng.random((m, n)) >= mask_frac).astype(np.float32))]


@pytest.mark.parametrize("m,n,d,p,R,zero_dims,mask_frac", [
    (39, 25, 21, 25, 24, (), 0.0),      # the main path's fit-time call
    (39, 25, 21, 25, 100, (), 0.0),     # W = 4: codes straddle words
    (3, 70, 21, 45, 24, (0, 5, 20), 0.3),  # width-0 dims, masked rows
    (2, 37, 8, 11, 7, (2,), 0.25),      # ragged tiles
    (2, 10, 5, 3, 0, (), 0.0),          # rate 0: no words at all
])
def test_qgram_packed_kernel(cuda, m, n, d, p, R, zero_dims, mask_frac):
    words, rates, cents, proj, mask = _packed(R + n, m, n, d, p, R, zero_dims, mask_frac)
    before = runtime.family("qgram_packed").launches
    got = qgram_packed_cuda(words.to(cuda), rates.to(cuda), cents.to(cuda),
                            proj.to(cuda), total_bits=R, mask=mask.to(cuda))
    torch.cuda.synchronize()
    assert runtime.family("qgram_packed").launches == before + 1
    want = qgram_packed_plain(words, rates, cents, proj, total_bits=R, mask=mask)
    _close(got.cpu().numpy(), want.numpy())


def test_main_path_on_card_launches_both_kernels(cuda, tmp_path):
    rng = np.random.default_rng(0)
    X = rng.normal(size=(320, 21)).astype(np.float32)
    y = (np.sin(X[:, 0]) + 0.1 * rng.normal(size=320)).astype(np.float32)
    parts = [(X[j::8], y[j::8]) for j in range(8)]
    cfg = DGPConfig(gram_backend="pallas", steps=10)
    est = DistributedGP(cfg)
    runtime.reset_launches()
    art = est.fit(parts=parts)
    assert art.device.type == "cuda"
    fit_launches = runtime.launches()
    assert fit_launches["gram"] > 0 and fit_launches["qgram_packed"] > 0
    mu, var = est.predict(art, X[:64])
    assert runtime.launches()["gram"] > fit_launches["gram"]
    est.save(art, str(tmp_path))
    mu2, var2 = est.predict(est.load(str(tmp_path)), X[:64])
    assert torch.equal(mu, mu2) and torch.equal(var, var2)
    cpu = DistributedGP(cfg, device="cpu")
    mu_c, var_c = cpu.predict(cpu.load(str(tmp_path)), X[:64])
    _close(mu.cpu().numpy(), mu_c.numpy())
    _close(var.cpu().numpy(), var_c.numpy())


@pytest.mark.parametrize("fuse", EPILOGUE_FUSES)
@pytest.mark.parametrize("m,t,K,kind,floored,lost", [
    (40, 128, 25, "serve_cache", (), ()),          # one broadcast request at Fig. 6
    (40, 4449, 25, "serve_cache", (), ()),         # the whole test set: expert groups
    (5, 37, 19, "serve_cache", (0, 5, 36), (1,)),  # ragged, floored s2, a lost expert
    (3, 130, 300, "generic", (2,), ()),            # large K: chunked operands
])
def test_epilogue_kernel(cuda, fuse, m, t, K, kind, floored, lost):
    ops = epilogue_operands(m, t, K, seed=m + t + K, kind=kind, floored=floored,
                            lost=lost, device=cuda)
    before = runtime.family("epilogue").launches
    got = epilogue_cuda(*ops, fuse=fuse)
    again = epilogue_cuda(*ops, fuse=fuse)
    torch.cuda.synchronize()
    assert runtime.family("epilogue").launches == before + 2
    assert torch.equal(got, again)  # no atomics: the same bits every run
    want = epilogue_moments_plain(*ops, fuse=fuse)
    bound = epilogue_error_bound(*ops, fuse=fuse)
    assert bool(torch.isfinite(got).all())
    excess = float(((got - want).abs() - bound).max())
    assert excess <= 0, excess


def _fig6_like(seed=0, n=320, m=8):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 21)).astype(np.float32)
    y = (np.sin(X[:, 0]) + 0.1 * rng.normal(size=n)).astype(np.float32)
    return [(X[j::m], y[j::m]) for j in range(m)], X[:64]


@pytest.mark.parametrize("protocol,fusion", [("broadcast", "kl"), ("broadcast", "rbcm"),
                                             ("poe", "rbcm")])
def test_broadcast_and_poe_on_card(cuda, tmp_path, protocol, fusion):
    parts, Xq = _fig6_like()
    cfg = DGPConfig(protocol=protocol, fusion=fusion, gram_backend="pallas", steps=10)
    est = DistributedGP(cfg)
    runtime.reset_launches()
    art = est.fit(parts=parts)
    fit_launches = runtime.launches()
    assert fit_launches["gram"] > 0
    if protocol == "broadcast":
        assert fit_launches["qgram_packed"] > 0
    before = runtime.launches()
    mu, var = est.predict(art, Xq)
    after = runtime.launches()
    assert after["gram"] == before["gram"] + 1
    assert after["epilogue"] == before["epilogue"] + (protocol == "broadcast")
    est.save(art, str(tmp_path))
    mu2, var2 = est.predict(est.load(str(tmp_path)), Xq)
    assert torch.equal(mu, mu2) and torch.equal(var, var2)
    cpu = DistributedGP(cfg, device="cpu")
    mu_c, var_c = cpu.predict(cpu.load(str(tmp_path)), Xq)
    for got, want in ((mu, mu_c), (var, var_c)):
        want = want.numpy()
        np.testing.assert_allclose(got.cpu().numpy(), want, rtol=1e-4,
                                   atol=1e-4 * max(1.0, float(np.abs(want).max())))


# the launches of each gram mode's fit and request under the pallas backend:
# the Nyström modes' inner products (and the direct views' N x N ones) come
# from the kernels once at fit time, so training launches nothing
GRAM_MODE_LAUNCHES = {
    ("center", "direct"): ({"gram": 1, "qgram_packed": 1}, {"gram": 1, "qgram_packed": 1}),
    ("center", "nystrom_fitc"): ({"gram": 1, "qgram_packed": 1}, {"gram": 1}),
    ("broadcast", "direct"): ({"gram": 1, "qgram_packed": 2}, {"gram": 1, "qgram_packed": 1}),
}


@pytest.mark.parametrize("protocol,mode", list(GRAM_MODE_LAUNCHES))
def test_gram_modes_on_card(cuda, tmp_path, protocol, mode):
    parts, Xq = _fig6_like()
    cfg = DGPConfig(protocol=protocol, gram_mode=mode, gram_backend="pallas", steps=10)
    est = DistributedGP(cfg)
    want_fit, want_request = GRAM_MODE_LAUNCHES[protocol, mode]
    runtime.reset_launches()
    art = est.fit(parts=parts)
    assert {k: v for k, v in runtime.launches().items() if v} == want_fit
    runtime.reset_launches()
    mu, var = est.predict(art, Xq)
    assert {k: v for k, v in runtime.launches().items() if v} == want_request
    est.save(art, str(tmp_path))
    mu2, var2 = est.predict(est.load(str(tmp_path)), Xq)
    assert torch.equal(mu, mu2) and torch.equal(var, var2)
    cpu = DistributedGP(cfg, device="cpu")
    mu_c, var_c = cpu.predict(cpu.load(str(tmp_path)), Xq)
    for got, want in ((mu, mu_c), (var, var_c)):
        want = want.numpy()
        np.testing.assert_allclose(got.cpu().numpy(), want, rtol=1e-4,
                                   atol=1e-4 * max(1.0, float(np.abs(want).max())))


# the launches of one streaming update and of one request after it, from
# zero, under the pallas backend: the center's new cross-gram is one gram
# launch; broadcast's and poe's updates run no kernel (as the reference's)
STREAM_LAUNCHES = {
    ("center", "kl"): ({"gram": 1}, {"gram": 1}),
    ("broadcast", "kl"): ({}, {"gram": 1, "epilogue": 1}),
    ("poe", "rbcm"): ({}, {"gram": 1}),
}


@pytest.mark.parametrize("protocol,fusion", list(STREAM_LAUNCHES))
def test_streamed_paths_on_card(cuda, tmp_path, protocol, fusion):
    """A checkpoint streamed on the card and on the CPU (the same batches,
    machines 1, 0, 2, 3; the first crosses a bucket edge): the launch
    counts of each update and request, the same counters and ledgers, the
    answers within 1e-4 of scale as the other card-vs-CPU serves here, and
    a bitwise save -> load of the streamed artifact."""
    from repro_torch.core.protocols.base import update_growth_count

    parts, Xq = _fig6_like()
    cfg = DGPConfig(protocol=protocol, fusion=fusion, gram_backend="pallas", steps=10)
    est, cpu = DistributedGP(cfg), DistributedGP(cfg, device="cpu")
    est.save(est.fit(parts=parts), str(tmp_path / "fit"))
    art, art_c = est.load(str(tmp_path / "fit")), cpu.load(str(tmp_path / "fit"))
    want_update, want_request = STREAM_LAUNCHES[protocol, fusion]
    rng = np.random.default_rng(7)
    for j in (1, 0, 2, 3):
        Xn = rng.normal(size=(16, 21)).astype(np.float32)
        yn = np.sin(Xn[:, 0]).astype(np.float32)
        g0 = update_growth_count(art.protocol)
        crossing = int(art.stream.cols) + 16 > int(art.y.shape[-1])
        runtime.reset_launches()
        art = est.update(art, Xn, yn, machine=j)
        assert {k: v for k, v in runtime.launches().items() if v} == want_update
        assert update_growth_count(art.protocol) - g0 == int(crossing)
        runtime.reset_launches()
        est.predict(art, Xq)
        assert {k: v for k, v in runtime.launches().items() if v} == want_request
        art_c = cpu.update(art_c, Xn, yn, machine=j)
    assert art.device.type == "cuda" and art.lengths == art_c.lengths
    assert (art.wire_bits, art.payload_bits, art.integrity_bits) == (
        art_c.wire_bits, art_c.payload_bits, art_c.integrity_bits)
    mu, var = est.predict(art, Xq)
    mu_c, var_c = cpu.predict(art_c, Xq)
    for got, want in ((mu, mu_c), (var, var_c)):
        want = want.numpy()
        np.testing.assert_allclose(got.cpu().numpy(), want, rtol=1e-4,
                                   atol=1e-4 * max(1.0, float(np.abs(want).max())))
    est.save(art, str(tmp_path / "streamed"))
    mu2, var2 = est.predict(est.load(str(tmp_path / "streamed")), Xq)
    assert torch.equal(mu, mu2) and torch.equal(var, var2)


def _card_vs_cpu(mu, var, mu_c, var_c):
    for got, want in ((mu, mu_c), (var, var_c)):
        want = want.numpy()
        np.testing.assert_allclose(got.cpu().numpy(), want, rtol=1e-4,
                                   atol=1e-4 * max(1.0, float(np.abs(want).max())))


def _fault_plan():
    from repro_torch import faults

    return (faults.drop_machine(3) | faults.nan_shard(5)
            | faults.corrupt_words(0.01, seed=7))


@pytest.mark.parametrize("protocol", ["center", "broadcast"])
def test_faulted_fit_on_card_matches_cpu(cuda, tmp_path, protocol):
    """The same faulted fit on the card and on the CPU: the flip masks are
    drawn on the CPU whatever the device, so the demotions, lengths and
    ledgers are equal; the fit launches ``gram`` and one ``qgram_packed``
    over the survivors' compacted words; the answers agree within 1e-4 of
    scale, and save -> load is bitwise."""
    parts, Xq = _fig6_like()
    cfg = DGPConfig(protocol=protocol, gram_backend="pallas", steps=10, faults=_fault_plan())
    est, cpu = DistributedGP(cfg), DistributedGP(cfg, device="cpu")
    runtime.reset_launches()
    art = est.fit(parts=parts)
    assert {k: v for k, v in runtime.launches().items() if v} == {"gram": 1, "qgram_packed": 1}
    art_c = cpu.fit(parts=parts)
    assert art.rows_demoted == art_c.rows_demoted > 0
    assert art.fit_lengths == art_c.fit_lengths and art.fit_lengths[3] == 0
    assert (art.wire_bits, art.payload_bits, art.integrity_bits) == (
        art_c.wire_bits, art_c.payload_bits, art_c.integrity_bits)
    h = est.health(art)
    assert h.status == "degraded" and h.machines_lost == (3,)
    assert h.rows_demoted == art.rows_demoted
    mu, var = est.predict(art, Xq)
    _card_vs_cpu(mu, var, *cpu.predict(art_c, Xq))
    est.save(art, str(tmp_path))
    mu2, var2 = est.predict(est.load(str(tmp_path)), Xq)
    assert torch.equal(mu, mu2) and torch.equal(var, var2)


def test_degraded_broadcast_request_launches_the_epilogue(cuda, tmp_path):
    """A broadcast request with machines masked out runs the fused
    ``epilogue`` with those experts at weight 0 (one launch beside one
    ``gram``), answers as the CPU serve of the same checkpoint does, and
    never shrinks a KL-fused variance below the healthy request's."""
    parts, Xq = _fig6_like()
    cfg = DGPConfig(protocol="broadcast", gram_backend="pallas", steps=10,
                    faults=_fault_plan())
    est, cpu = DistributedGP(cfg), DistributedGP(cfg, device="cpu")
    est.save(est.fit(parts=parts), str(tmp_path))
    art, art_c = est.load(str(tmp_path)), cpu.load(str(tmp_path))
    avail = np.ones(8, np.float32)
    avail[[1, 3, 6]] = 0.0
    _, var_h = est.predict(art, Xq)
    runtime.reset_launches()
    mu, var = est.predict(art, Xq, available=avail)
    assert {k: v for k, v in runtime.launches().items() if v} == {"gram": 1, "epilogue": 1}
    assert est.health(art, avail).variance_inflation == 8 / 5
    assert bool((var >= var_h - 1e-6).all())
    _card_vs_cpu(mu, var, *cpu.predict(art_c, Xq, available=avail))


@pytest.mark.parametrize("protocol", ["center", "broadcast"])
def test_vq_fit_on_card(cuda, tmp_path, protocol):
    """``scheme="vq"`` on the card: the channel is built on the host and its
    noise drawn on the CPU, so the card's fit has the CPU's ledgers; it runs
    no kernel (the config's ``xla`` rule), answers within 1e-4 of scale of
    the CPU fit, streams an update charged ceil(n R) and reloads bitwise."""
    import math

    parts, Xq = _fig6_like()
    cfg = DGPConfig(protocol=protocol, scheme="vq", steps=10)
    est, cpu = DistributedGP(cfg), DistributedGP(cfg, device="cpu")
    runtime.reset_launches()
    art = est.fit(parts=parts)
    mu, var = est.predict(art, Xq)
    assert set(runtime.launches().values()) == {0}
    art_c = cpu.fit(parts=parts)
    assert art.device.type == "cuda" and art.wire.codes.shape[-1] == 0
    assert (art.wire_bits, art.payload_bits, art.integrity_bits) == (
        art_c.wire_bits, art_c.payload_bits, 0)
    _card_vs_cpu(mu, var, *cpu.predict(art_c, Xq))
    rng = np.random.default_rng(3)
    Xn = rng.normal(size=(16, 21)).astype(np.float32)
    art2 = est.update(art, Xn, np.sin(Xn[:, 0]), machine=2)
    assert art2.wire_bits - art.wire_bits == math.ceil(
        16 * float(art.data["vq_rate_bits"][2]))
    est.save(art2, str(tmp_path))
    mu2, var2 = est.predict(est.load(str(tmp_path)), Xq)
    assert all(torch.equal(a, b) for a, b in zip((mu2, var2), est.predict(art2, Xq)))


def test_legacy_fixture_serves_on_card(cuda):
    """The committed format-v1 checkpoint (no config, unpacked codes) loads
    onto the card and serves as it does on the CPU, within 5e-5 of
    max(1, max |CPU value|).  Its unfused serve solves against a 12 x 12
    L_KK, whose conditioning amplifies the two devices' rounding: an H100
    read 1.7e-6 (mu) and 8.2e-6 (var) of that scale; the limit keeps a
    margin of six."""
    fixture = os.path.join(os.path.dirname(__file__), "fixtures", "legacy_artifact")
    Xt = np.load(os.path.join(fixture, "expected.npz"))["Xt"]
    card, cpu = DistributedGP(), DistributedGP(device="cpu")
    art = card.load(fixture)
    assert art.device.type == "cuda" and art.wire.codes.dtype == torch.int32
    mu, var = card.predict(art, Xt)
    mu_c, var_c = cpu.predict(cpu.load(fixture), Xt)
    for got, want in ((mu, mu_c), (var, var_c)):
        want = want.numpy()
        np.testing.assert_allclose(got.cpu().numpy(), want, rtol=0,
                                   atol=5e-5 * max(1.0, float(np.abs(want).max())))


@pytest.mark.parametrize("fuse", EPILOGUE_FUSES)
@pytest.mark.parametrize("T,m,t,K,kind,floored,lost", [
    (16, 40, 16, 25, "serve_cache", (), ()),         # a fleet flush at Fig. 6
    (5, 5, 37, 19, "serve_cache", (0, 5, 36), (1,)),  # ragged, floored s2, a lost expert
    (8, 40, 128, 25, "serve_cache", (), ()),         # serve-sized requests: expert groups
    (3, 3, 130, 300, "generic", (2,), ()),           # large K: chunked operands
])
def test_epilogue_fleet_kernel(cuda, fuse, T, m, t, K, kind, floored, lost):
    ops = epilogue_fleet_operands(T, m, t, K, seed=T + m + t + K, kind=kind,
                                  floored=floored, lost=lost, device=cuda)
    before = runtime.launches()
    got = epilogue_fleet_cuda(*ops, fuse=fuse)
    again = epilogue_fleet_cuda(*ops, fuse=fuse)
    torch.cuda.synchronize()
    after = runtime.launches()
    assert after["epilogue_fleet"] == before["epilogue_fleet"] + 2
    assert after["epilogue"] == before["epilogue"]
    assert torch.equal(got, again)  # no atomics: the same bits every run
    want = epilogue_moments_fleet_plain(*ops, fuse=fuse)
    bound = epilogue_fleet_error_bound(*ops, fuse=fuse)
    assert got.shape == (T, 3, t) and bool(torch.isfinite(got).all())
    excess = float(((got - want).abs() - bound).max())
    assert excess <= 0, excess
    # tenant 0 poisoned: every other tenant's rows keep their bits
    G = ops[0].clone()
    G[0] = float("nan")
    poisoned = epilogue_fleet_cuda(G, *ops[1:], fuse=fuse)
    assert torch.equal(poisoned[1:], got[1:])


def test_fleet_predict_on_card_is_one_fleet_launch(cuda):
    parts, Xq = _fig6_like()
    est = DistributedGP(DGPConfig(protocol="broadcast", fusion="kl", gram_backend="pallas",
                                  steps=10))
    art = est.fit(parts=parts)
    tenants = {i: scale_targets(art, 0.5 + 0.25 * i) for i in range(6)}
    stack = FleetStack(dict(list(tenants.items())[:4]), slots=4)
    ptrs = stack.data_ptrs()
    tids = [3, 0, 1, 3]
    X4 = np.stack([Xq[:16]] * 4)
    runtime.reset_launches()
    mu, var = stack.predict(tids, X4)
    torch.cuda.synchronize()
    launches = runtime.launches()
    assert launches["epilogue_fleet"] == 1 and launches["epilogue"] == 0
    assert launches["gram"] == len(tids)  # one query product per gathered tenant
    for s, tid in enumerate(tids):
        mu_1, var_1 = est.predict(tenants[tid], Xq[:16])
        for got, want in ((mu[s], mu_1), (var[s], var_1)):
            want = want.cpu().numpy()
            np.testing.assert_allclose(got.cpu().numpy(), want, rtol=2e-4,
                                       atol=2e-4 * max(1.0, float(np.abs(want).max())))
    stack.admit(4, tenants[4])  # evicts tenant 2, the least recently used
    stack.admit(5, tenants[5])  # evicts tenant 0
    stack.predict([4, 5, 1, 3], X4)
    assert stack.data_ptrs() == ptrs and stack.swaps == 2


@pytest.mark.parametrize("n,d,bits,max_bits,zero_dims,dominant,specials", [
    (1024, 128, 512, 8, (), False, False),  # the kernels bench shape: 4 d bits, max 8
    (25, 21, 24, 12, (), False, False),     # one machine of the Fig. 6 wire
    (25, 21, 48, 12, (), True, False),      # a 12-bit dimension: a 4096-edge row
    (37, 13, 30, 12, (2, 7), False, True),  # ragged, rate-0 dims, NaN / +-inf / on-edge
    (9, 5, 0, 8, (), False, True),          # bits = 0: every dim rate 0, E = 128
])
def test_quant_kernels_bitwise(cuda, n, d, bits, max_bits, zero_dims, dominant, specials):
    x, edges, cents, _ = quant_operands(n, d, bits, max_bits=max_bits, seed=n + d,
                                        zero_dims=zero_dims, dominant=dominant,
                                        specials=specials)
    xc, ec, cc = x.to(cuda), edges.to(cuda), cents.to(cuda)
    before = runtime.launches()
    codes = encode_cuda(xc, ec)
    torch.cuda.synchronize()
    assert torch.equal(codes.cpu(), encode_plain(x, edges))
    assert torch.equal(codes, encode_plain(xc, ec))
    # in-range codes, the -1 sentinel and codes >= C all held bitwise
    probe = codes.clone()
    probe[0] = -1
    probe[-1] = cents.shape[1] + 3
    xhat = decode_cuda(probe, cc)
    torch.cuda.synchronize()
    assert torch.equal(xhat, decode_plain(probe, cc))
    assert not bool(xhat[0].any()) and not bool(xhat[-1].any())
    after = runtime.launches()
    assert after["quant_encode"] == before["quant_encode"] + 1
    assert after["quant_decode"] == before["quant_decode"] + 1


@pytest.mark.parametrize("m,n,d,p,bits,pad_rows,shared_y", [
    (1, 1024, 128, 1024, 512, 0, True),  # the kernels bench shape
    (39, 25, 21, 25, 24, 7, False),      # the Fig. 6 wire, -1 padded rows, per-machine y
    (3, 37, 13, 70, 30, 5, True),        # ragged tiles, shared y
])
def test_qgram_kernel(cuda, m, n, d, p, bits, pad_rows, shared_y):
    codes, cents, y = qgram_operands(m, n, d, p, bits, max_bits=12, seed=m + n,
                                     pad_rows=pad_rows, shared_y=shared_y)
    before = runtime.family("qgram").launches
    got = qgram_cuda(codes.to(cuda), cents.to(cuda), y.to(cuda))
    torch.cuda.synchronize()
    assert runtime.family("qgram").launches == before + 1
    assert got.shape == (m, n + pad_rows, p)
    _close(got.cpu().numpy(), qgram_plain(codes, cents, y).numpy())
    assert not bool(got[:, n:].any())  # -1 rows decode to 0


# ---- the shared quantized-gram body: each plan variant, its tile edges ----

from repro_torch.kernels.qgram import ops as qgram_ops  # noqa: E402


@pytest.mark.parametrize("m,n,p,d,R,cap,zero_dims,mask_frac,variant", [
    (39, 25, 25, 21, 24, 12, (), 0.0, "small"),          # the centre's fit call
    (2, 33, 33, 21, 24, 12, (), 0.2, "small"),            # one past the small tile
    (40, 25, 1000, 21, 24, 12, (), 0.0, "flat"),          # broadcast's fit call
    (39, 25, 1000, 21, 16, 12, (), 0.0, "flat"),          # center direct's fit call
    (40, 25, 1000, 21, 40, 12, (), 0.0, "flat"),          # broadcast direct's D, W = 2
    (40, 25, 128, 21, 40, 12, (), 0.0, "small"),          # broadcast direct's request E
    (300, 32, 65, 21, 24, 12, (3,), 0.1, "flat"),          # one column past the flat tile
    (3, 200, 1001, 21, 100, 12, (0, 5, 20), 0.3, "wide"),  # odd p, W = 4, width 0, masked
    (200, 65, 129, 21, 24, 12, (), 0.0, "wide"),          # one past the wide tile
    (2, 1024, 1025, 40, 100, 8, (7,), 0.2, "long"),       # staged tables, ragged d and p
])
def test_qgram_packed_variants(cuda, m, n, p, d, R, cap, zero_dims, mask_frac, variant):
    words, rates, cents, proj, mask = _packed(R + n + p, m, n, d, p, R, zero_dims, mask_frac,
                                              cap=cap)
    pl = qgram_ops.plan(m, n, p, d, words.shape[-1], cents.shape[-1],
                        torch.cuda.get_device_properties(cuda).multi_processor_count)
    assert pl.variant == variant
    args = [t.to(cuda) for t in (words, rates, cents, proj)]
    # the named variant's tile, as plan gives it (the autotune cache's may differ)
    got = qgram_packed_cuda(*args, total_bits=R, mask=mask.to(cuda), plan=pl)
    again = qgram_packed_cuda(*args, total_bits=R, mask=mask.to(cuda), plan=pl)
    torch.cuda.synchronize()
    assert torch.equal(got, again)  # two launches, the same bits
    want = qgram_packed_plain(words, rates, cents, proj, total_bits=R, mask=mask)
    _close(got.cpu().numpy(), want.numpy())
    # no mask is every row kept, bit for bit
    assert torch.equal(qgram_packed_cuda(*args, total_bits=R, plan=pl),
                       qgram_packed_cuda(*args, total_bits=R, plan=pl,
                                         mask=torch.ones_like(mask).to(cuda)))


@pytest.mark.parametrize("m,n,p,d,bits,max_bits,pad_rows,shared_y,variant", [
    (39, 25, 25, 21, 24, 12, 7, False, "small"),    # the wire, -1 rows
    (1, 1024, 1024, 128, 512, 8, 0, True, "long"),  # the kernels bench shape
    (2, 100, 3001, 21, 24, 12, 3, False, "wide"),   # wide p
    (2, 77, 300, 45, 60, 12, 4, False, "small"),    # ragged d past a chunk, gathered
    (2, 1000, 1000, 45, 90, 8, 5, True, "long"),    # ragged d, staged tables
])
def test_qgram_variants(cuda, m, n, p, d, bits, max_bits, pad_rows, shared_y, variant):
    codes, cents, y = qgram_operands(m, n, d, p, bits, max_bits=max_bits, seed=m + n + p,
                                     pad_rows=pad_rows, shared_y=shared_y)
    pl = qgram_ops.plan(m, n + pad_rows, p, d, None, cents.shape[-1],
                        torch.cuda.get_device_properties(cuda).multi_processor_count)
    assert pl.variant == variant
    got = qgram_cuda(codes.to(cuda), cents.to(cuda), y.to(cuda))
    again = qgram_cuda(codes.to(cuda), cents.to(cuda), y.to(cuda))
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    _close(got.cpu().numpy(), qgram_plain(codes, cents, y).numpy())
    assert not bool(got[:, n:].any())  # -1 rows decode to 0


@pytest.mark.parametrize("B,S,KV,G,hd,q_dtype,kv_dtype,window,pos,ring,empty", [
    (2, 1000, 4, 8, 128, torch.float32, torch.bfloat16, None, 999, False, ()),  # bench-like
    (2, 8192, 4, 2, 256, torch.float32, torch.bfloat16, 4096, 10000, True, ()),  # gemma2 local
    (3, 333, 2, 3, 40, torch.float32, torch.float32, None, 300, False, (1,)),  # ragged, no key
    (2, 130, 1, 12, 16, torch.bfloat16, torch.float32, 64, 120, True, ()),  # G > 8, bf16 q
    (1, 64, 2, 2, 8, torch.float32, torch.float32, 0, 63, False, ()),  # window 0: none valid
    (2, 2500, 2, 4, 512, torch.float32, torch.bfloat16, None, 2400, True, (1,)),  # hd > 256
    (2, 2500, 2, 9, 100, torch.float32, torch.bfloat16, 700, 2400, False, ()),  # 200-byte rows
])
def test_decode_attn_kernel(cuda, B, S, KV, G, hd, q_dtype, kv_dtype, window, pos, ring,
                            empty):
    q, K, V, kpos = decode_attn_operands(B, S, KV, G, hd, pos=pos, q_dtype=q_dtype,
                                         kv_dtype=kv_dtype, ring=ring, empty_rows=empty,
                                         seed=S, device=cuda)
    before = runtime.family("decode_attn").launches
    got = decode_attn_cuda(q, K, V, kpos, pos, window=window)
    again = decode_attn_cuda(q, K, V, kpos, torch.tensor(pos, dtype=torch.int32,
                                                         device=cuda), window=window)
    torch.cuda.synchronize()
    assert runtime.family("decode_attn").launches == before + 2
    assert torch.equal(got, again)  # pos by value or on the card; the same bits
    want = decode_attn_plain(q, K, V, kpos, pos, window=window)
    assert got.shape == (B, KV, G, hd) and bool(torch.isfinite(got).all())
    tol = 1e-5 * float(V.float().abs().max())
    assert float((got - want).abs().max()) <= tol
    for b in empty:  # no valid key: the mean of V over the S slots
        mean = V[b].float().mean(0)[:, None, :].expand(KV, G, hd)
        assert float((got[b] - mean).abs().max()) <= tol


def test_new_kernels_refuse_bad_operands(cuda):
    x, edges, cents, _ = quant_operands(8, 4, 8)
    xc, ec, cc = x.to(cuda), edges.to(cuda), cents.to(cuda)
    codes = encode_cuda(xc, ec)
    with pytest.raises(TypeError):
        encode_cuda(xc.double(), ec)
    with pytest.raises(ValueError, match="contiguous"):
        encode_cuda(xc.T.contiguous().T, ec)
    with pytest.raises(TypeError):
        decode_cuda(codes.long(), cc)
    with pytest.raises(ValueError, match="contiguous"):
        decode_cuda(codes, cc.T.contiguous().T)
    qc, qt, qy = (t.to(cuda) for t in qgram_operands(2, 5, 4, 3, 8))
    with pytest.raises(TypeError):
        qgram_cuda(qc.long(), qt, qy)
    with pytest.raises(ValueError, match="contiguous"):
        qgram_cuda(qc, qt, qy.T.contiguous().T)
    q, K, V, kpos = decode_attn_operands(1, 16, 2, 2, 8, pos=15, device=cuda)
    with pytest.raises(TypeError):
        decode_attn_cuda(q.half(), K, V, kpos, 15)
    with pytest.raises(TypeError):
        decode_attn_cuda(q, K, V, kpos.long(), 15)
    with pytest.raises(ValueError, match="contiguous"):
        decode_attn_cuda(q, K.transpose(1, 2).contiguous().transpose(1, 2), V, kpos, 15)
    with pytest.raises(ValueError, match="0-d int32"):
        decode_attn_cuda(q, K, V, kpos, torch.tensor([15], device=cuda))


# ---- the redesigned gram (tile plans, split K) and decode_attn (kpos first) ----

from repro_torch.kernels.gram import ops as gram_ops  # noqa: E402
from repro_torch.kernels.decode_attn.ops import plan as attn_plan  # noqa: E402


def _gram_operands(seed, n, p, d):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=s).astype(np.float32)) for s in ((n, d), (p, d), (n, p))]


@pytest.mark.parametrize("n,p,d", [(130, 21, 20000),   # ragged n, narrow p, split K
                                   (37, 23, 9000),
                                   (300, 33, 5000),    # 33 columns: the small tile, split
                                   (600, 28, 4000),    # 28 columns: the small tile, split
                                   (129, 70, 3001)])   # ragged d
def test_gram_long_k_forward_and_backward(cuda, n, p, d):
    x, y, g = _gram_operands(n + p + d, n, p, d)
    assert gram_ops.plan(n, p, d, torch.cuda.get_device_properties(cuda).multi_processor_count).splits > 1
    got = gram_cuda(x.to(cuda), y.to(cuda))
    _close(got.cpu().numpy(), (x.double() @ y.double().T).numpy())
    xr, yr = x.to(cuda).requires_grad_(True), y.to(cuda).requires_grad_(True)
    gram(xr, yr).backward(g.to(cuda))
    _close(xr.grad.cpu().numpy(), (g.double() @ y.double()).numpy())
    _close(yr.grad.cpu().numpy(), (g.double().T @ x.double()).numpy())


@pytest.mark.parametrize("n,p,d", [(4449, 21, 6000), (130, 21, 20000), (600, 24, 4000)])
def test_gram_split_and_no_split_plans_agree(cuda, monkeypatch, n, p, d):
    x, y, _ = _gram_operands(d, n, p, d)
    xc, yc = x.to(cuda), y.to(cuda)
    split = gram_cuda(xc, yc)
    pl = gram_ops.plan(n, p, d, torch.cuda.get_device_properties(cuda).multi_processor_count)
    assert pl.splits > 1
    bk = gram_ops.TILES[pl.tile][2]
    monkeypatch.setattr(gram_ops, "plan",
                        lambda *a, **k: gram_ops.Plan(pl.tile, 1, -(-d // bk) * bk))
    whole = gram_cuda(xc, yc)
    torch.cuda.synchronize()
    scale = float((x.abs() @ y.abs().T).max())
    assert float((split - whole).abs().max()) <= 1e-5 * scale
    _close(whole.cpu().numpy(), (x.double() @ y.double().T).numpy())


@pytest.mark.parametrize("n,p,d", [(4449, 4000, 21), (130, 21, 20000), (128, 25, 21)])
def test_gram_two_launches_give_the_same_bits(cuda, n, p, d):
    x, y, g = _gram_operands(7, n, p, d)
    xc, yc, gc = x.to(cuda), y.to(cuda), g.to(cuda)
    assert torch.equal(gram_cuda(xc, yc), gram_cuda(xc, yc))
    grads = []
    for _ in range(2):
        xr, yr = xc.clone().requires_grad_(True), yc.clone().requires_grad_(True)
        gram(xr, yr).backward(gc)
        grads.append((xr.grad, yr.grad))
    assert torch.equal(grads[0][0], grads[1][0]) and torch.equal(grads[0][1], grads[1][1])


def test_gram_refuses_bad_operands(cuda):
    x = torch.randn(5, 3, device=cuda)
    with pytest.raises(TypeError):
        gram_cuda(x.double(), x.double())
    with pytest.raises(ValueError):
        gram_cuda(x, torch.randn(4, 2, device=cuda))
    with pytest.raises(ValueError):
        gram_cuda(x, x.cpu())


@pytest.mark.parametrize("window", [0, 1, 100, None])
@pytest.mark.parametrize("ring,slot_order", [(True, False), (True, True), (False, False)])
@pytest.mark.parametrize("kv_dtype,hd", [(torch.bfloat16, 128), (torch.bfloat16, 40),
                                         (torch.float32, 64), (torch.bfloat16, 100),
                                         (torch.float32, 512)])
def test_decode_attn_windows_and_rings(cuda, window, ring, slot_order, kv_dtype, hd):
    B, S, KV, G, pos = 3, 1500, 2, 5, 2000
    q, K, V, kpos = decode_attn_operands(B, S, KV, G, hd, pos=pos, kv_dtype=kv_dtype, ring=ring,
                                         slot_order=slot_order, seed=hd, device=cuda)
    got = decode_attn_cuda(q, K, V, kpos, pos, window=window)
    again = decode_attn_cuda(q, K, V, kpos, torch.tensor(pos, dtype=torch.int32, device=cuda),
                             window=window)
    want = decode_attn_plain(q, K, V, kpos, pos, window=window)
    torch.cuda.synchronize()
    tol = 1e-5 * float(V.float().abs().max())
    assert torch.equal(got, again) and bool(torch.isfinite(got).all())
    assert float((got - want).abs().max()) <= tol
    valid = (kpos >= 0) & (kpos <= pos)
    if window is not None:
        valid &= kpos > pos - window
    for b in range(B):  # a row with no valid key: the mean of V over the S slots
        if not bool(valid[b].any()):
            mean = V[b].float().mean(0)[:, None, :].expand(KV, G, hd)
            assert float((got[b] - mean).abs().max()) <= tol


@pytest.mark.parametrize("kv_dtype,hd", [(torch.bfloat16, 128), (torch.float32, 64)])
def test_decode_attn_empty_row_and_splits_without_a_valid_slot(cuda, kv_dtype, hd):
    B, S, KV, G, pos = 4, 6000, 2, 8, 5999
    q, K, V, kpos = decode_attn_operands(B, S, KV, G, hd, pos=pos, kv_dtype=kv_dtype,
                                         empty_rows=(1,), seed=3, device=cuda)
    kpos[2] = -1  # row 2: its valid slots all in the first split
    kpos[2, :30] = torch.arange(pos - 29, pos + 1, dtype=torch.int32, device=cuda)
    pl = attn_plan(B, S, KV, G, hd, K.element_size(),
                   torch.cuda.get_device_properties(cuda).multi_processor_count)
    assert pl.splits > 1 and pl.slots_per_split >= 30
    got = decode_attn_cuda(q, K, V, kpos, pos)
    want = decode_attn_plain(q, K, V, kpos, pos)
    torch.cuda.synchronize()
    tol = 1e-5 * float(V.float().abs().max())
    assert bool(torch.isfinite(got).all())
    assert float((got - want).abs().max()) <= tol
    mean = V[1].float().mean(0)[:, None, :].expand(KV, G, hd)
    assert float((got[1] - mean).abs().max()) <= tol
    assert torch.equal(got, decode_attn_cuda(q, K, V, kpos, pos))


def test_decode_attn_refuses_bad_operands_on_the_card(cuda):
    q, K, V, kpos = decode_attn_operands(2, 64, 2, 3, 16, pos=63, device=cuda)
    with pytest.raises(ValueError):
        decode_attn_cuda(q, K[:, :32], V, kpos, 63)  # S differs between K and V
    with pytest.raises(ValueError, match="head dim"):
        big = torch.zeros(1, 1, 1, 520, device=cuda)
        decode_attn_cuda(big, torch.zeros(1, 4, 1, 520, device=cuda),
                         torch.zeros(1, 4, 1, 520, device=cuda),
                         torch.zeros(1, 4, dtype=torch.int32, device=cuda), 3)
    with pytest.raises(TypeError):
        decode_attn_cuda(q, K.float(), V, kpos, 63)  # K and V of two types


@pytest.mark.parametrize("misaligned", [False, True])
def test_decode_attn_two_head_chunks_and_misaligned_rows(cuda, misaligned):
    """G = 12: two chunks of heads on the tensor-core path; K and V starting
    off 16 bytes take the block kernel, with the same answer."""
    B, S, KV, G, hd, pos = 2, 900, 2, 12, 64, 850
    q, K, V, kpos = decode_attn_operands(B, S, KV, G, hd, pos=pos, seed=12, device=cuda)
    if misaligned:  # the same values, one bf16 element past a 16-byte boundary
        K = torch.cat([K.new_zeros(1), K.flatten()])[1:].view(B, S, KV, hd)
        V = torch.cat([V.new_zeros(1), V.flatten()])[1:].view(B, S, KV, hd)
        assert K.data_ptr() % 16 != 0 and K.is_contiguous()
    path = attn_plan(B, S, KV, G, hd, 2, torch.cuda.get_device_properties(cuda).multi_processor_count,
                     aligned=not misaligned).path
    assert path == ("simt" if misaligned else "mma")
    got = decode_attn_cuda(q, K, V, kpos, pos, window=300)
    want = decode_attn_plain(q, K, V, kpos, pos, window=300)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= 1e-5 * float(V.float().abs().max())
    assert torch.equal(got, decode_attn_cuda(q, K, V, kpos, pos, window=300))


# ---- quant_encode's search and count, epilogue variants and tile edges ------------

from repro_torch.kernels.epilogue.ops import plan as epi_plan  # noqa: E402
from repro_torch.kernels.epilogue.ops import plan_fleet as epi_plan_fleet  # noqa: E402
from repro_torch.kernels.quant.cases import ENCODE_TABLE_KINDS, encode_operands  # noqa: E402


@pytest.mark.parametrize("kind", ENCODE_TABLE_KINDS)
@pytest.mark.parametrize("n,d,E", [(37, 13, 128), (300, 3, 130), (1024, 8, 4096),
                                   (5, 2, 8192 + 5)])
def test_quant_encode_adversarial_tables_bitwise(cuda, kind, n, d, E):
    # ascending rows take the binary search, the others the full count:
    # the same codes as the plain version either way, and on two launches
    x, edges = encode_operands(n, d, E, kind, seed=n + E, device=cuda)
    got, again = encode_cuda(x, edges), encode_cuda(x, edges)
    torch.cuda.synchronize()
    assert torch.equal(got, encode_plain(x, edges))
    assert torch.equal(got, again)


@pytest.mark.parametrize("m,t,K,kind", [
    (40, 32, 32, "serve_cache"),   # the small variant's largest K
    (40, 32, 33, "serve_cache"),   # one past it: the tensor-core variant
    (40, 33, 25, "serve_cache"),   # one past a small tile of 32 points
    (3, 2048, 25, "serve_cache"),  # the tensor-core tile of 128 at small K, 16 whole tiles
    (3, 2049, 25, "serve_cache"),  # one past it
    (5, 64, 300, "generic"),       # large K, two whole tiles of 32
    (5, 65, 300, "generic"),       # one past
    (2, 20, 1345, "generic"),      # past the 32-point tile's shared memory: 16 points
])
@pytest.mark.parametrize("fuse", ["kl", "rbcm", "none"])
def test_epilogue_variants_and_tile_edges(cuda, m, t, K, kind, fuse):
    ops = epilogue_operands(m, t, K, seed=m + t + K, kind=kind, device=cuda)
    got, again = epilogue_cuda(*ops, fuse=fuse), epilogue_cuda(*ops, fuse=fuse)
    torch.cuda.synchronize()
    assert torch.equal(got, again)  # the group sum in order: the same bits every run
    want = epilogue_moments_plain(*ops, fuse=fuse)
    bound = epilogue_error_bound(*ops, fuse=fuse)
    assert bool(torch.isfinite(got).all())
    excess = float(((got - want).abs() - bound).max())
    assert excess <= 0, (epi_plan(m, t, K), excess)


@pytest.mark.parametrize("T,m,t,K,kind", [
    (2, 5, 33, 19, "serve_cache"),   # small variant, two tiles a tenant
    (3, 3, 65, 300, "generic"),      # tensor-core variant at large K
    (2, 4, 1100, 25, "serve_cache"),  # 2200 points: the fleet takes the 128-point tile,
])                                    # each tenant alone the small variant
def test_epilogue_fleet_tenant_against_single(cuda, T, m, t, K, kind):
    ops = epilogue_fleet_operands(T, m, t, K, seed=T + m + t + K, kind=kind, device=cuda)
    got, again = epilogue_fleet_cuda(*ops, fuse="kl"), epilogue_fleet_cuda(*ops, fuse="kl")
    single = torch.stack([epilogue_cuda(*(a[n] for a in ops), fuse="kl") for n in range(T)])
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    bound = epilogue_fleet_error_bound(*ops, fuse="kl")
    want = epilogue_moments_fleet_plain(*ops, fuse="kl")
    assert float(((got - want).abs() - bound).max()) <= 0
    if epi_plan_fleet(T, m, t, K) == epi_plan(m, t, K):
        assert torch.equal(got, single)  # one design: the same bits where the plans agree
    else:
        assert float(((got - single).abs() - 2 * bound).max()) <= 0


# ---- quant_decode's plan: each variant's tile edges, views and special values ------

from repro_torch.kernels.quant.ops import decode_plan  # noqa: E402

INT32_MAX = 2**31 - 1


def _decode_operands(n, d, C, seed, layout, device):
    """codes (n, d) int32 drawn over [-2, C + 2) with -1, C, INT32_MAX and
    INT32_MIN planted, and a (d, C) table; ``layout`` "codes[1:]" gives a
    codes view one row in, "codes+4B" / "cents+4B" a view 4 bytes past a
    16-byte boundary, "specials" a table with NaN, +-inf and -0.0 entries
    that the codes look up."""
    rng = np.random.default_rng(seed)
    cents = rng.normal(size=(d, C)).astype(np.float32)
    if layout == "specials":
        for j in range(d):
            cents[j, [0, 1, 2, 3, C - 1]] = [np.nan, np.inf, -np.inf, -0.0, np.nan]
            cents[j, 5] = np.float32(np.frombuffer(np.uint32(0x7FC01234).tobytes(), np.float32)[0])
    rows = n + (layout == "codes[1:]")
    codes = rng.integers(-2, C + 2, size=(rows, d)).astype(np.int32)
    if layout == "specials":
        codes[:, :] = rng.choice([0, 1, 2, 3, 5, C - 1], size=codes.shape)
    if codes.size:
        flat = codes.reshape(-1)
        flat[:: 7] = -1
        flat[3:: 11] = C
        flat[5:: 13] = INT32_MAX
        flat[6:: 17] = -2**31
    codes_t = torch.from_numpy(codes).to(device)
    cents_t = torch.from_numpy(cents).to(device)
    if layout == "codes[1:]":
        codes_t = codes_t[1:]
    elif layout == "codes+4B":
        buf = torch.empty(n * d + 1, dtype=torch.int32, device=device)
        buf[1:] = codes_t.reshape(-1)
        codes_t = buf[1:].view(n, d)
    elif layout == "cents+4B":
        buf = torch.empty(d * C + 1, dtype=torch.float32, device=device)
        buf[1:] = cents_t.reshape(-1)
        cents_t = buf[1:].view(d, C)
    return codes_t, cents_t


@pytest.mark.parametrize("n,d,C,layout", [
    (1, 21, 4096, "plain"),       # one row
    (0, 21, 4096, "plain"),       # no row: an empty output, nothing launched
    (1, 129, 256, "plain"),
    (300, 1, 256, "plain"),       # d of 1, 3, 21, 129: not a multiple of the vector width
    (300, 3, 256, "plain"),       # or of the tile
    (300, 21, 4096, "plain"),
    (300, 129, 256, "plain"),
    (33, 128, 256, "plain"),      # one row past a tile of 32
    (65, 36, 4096, "plain"),      # a multiple of 4, not of the tile's 32 dimensions
    (1024, 128, 256, "plain"),    # the kernels bench shape
    (1024, 129, 4096, "plain"),
    (20000, 8, 256, "plain"),
    (64, 128, 256, "plain"),      # 8192 symbols: the flat variant's largest call,
    (65, 128, 256, "plain"),      # one row past it: the tile
    (4000, 31, 256, "plain"),     # d = 31: flat; d = 32: the tile
    (4000, 32, 256, "plain"),
    (1000, 12, 256, "plain"),     # d = 12: flat; d = 16: the tile
    (1000, 16, 256, "plain"),
    (67552, 32, 256, "plain"),    # the last plan of 32-row tiles, the first of 64
    (67584, 32, 256, "plain"),
    (33761, 33, 4096, "plain"),   # 64-row tiles, ragged in n and d
    (301, 129, 256, "codes[1:]"),   # a storage offset of one row
    (1024, 128, 256, "codes+4B"),   # 16-byte vectors refused: the scalar path
    (1024, 128, 256, "cents+4B"),
    (25, 21, 4096, "specials"),     # NaN (two payloads), +-inf, -0.0 copied bit for bit
    (1024, 128, 256, "specials"),
])
def test_quant_decode_plan_edges_bitwise(cuda, n, d, C, layout):
    codes, cents = _decode_operands(n, d, C, seed=n + d + C, layout=layout, device=cuda)
    before = runtime.family("quant_decode").launches
    got, again = decode_cuda(codes, cents), decode_cuda(codes, cents)
    torch.cuda.synchronize()
    assert runtime.family("quant_decode").launches == before + (2 if n else 0)
    want = decode_plain(codes, cents)
    assert got.shape == (n, d) and got.dtype == torch.float32
    # bit patterns, so that NaN payloads and -0.0 count
    assert torch.equal(got.view(torch.int32), want.view(torch.int32)), decode_plan(n, d, C)
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    outside = (codes < 0) | (codes >= C)
    assert not bool(got[outside].view(torch.int32).any())  # +0.0, not -0.0


# ---- the paper's §4 schemes, GPModel and the sparse GP on the card --------
# (card vs CPU: tests/test_torch_paper_schemes.py and
# tests/test_torch_sparse_gp.py hold the CPU against the reference)

def _paper_setting(d=10, n=2000, seed=0):
    rng = np.random.default_rng(seed)
    A, B = rng.normal(size=(d, d)), rng.normal(size=(d, d))
    Qx, Qy = A @ A.T / d, B @ B.T / d
    X = torch.from_numpy(rng.multivariate_normal(np.zeros(d), Qx, size=n).astype(np.float32))
    return Qx, Qy, X


def test_dim_reduction_and_scheme_roundtrips_card_vs_cpu(cuda):
    from repro_torch.core import quantizers as Q
    from repro_torch.core.schemes import (
        DimReductionScheme, OptimalScheme, PCAScheme, PerSymbolScheme,
    )
    from repro_torch.core.transforms import dr_decode, dr_encode, make_dim_reduction, make_pca

    Qx, Qy, X = _paper_setting()
    for dr in (make_dim_reduction(Qx, Qy, 4), make_pca(Qx, 4)):
        Z = dr_encode(dr, X.to(cuda))
        assert Z.device.type == "cuda"
        _close(Z.cpu().numpy(), dr_encode(dr, X).numpy())
        _close(dr_decode(dr, Z).cpu().numpy(), dr_decode(dr, dr_encode(dr, X)).numpy())
    for sch in (DimReductionScheme(3).fit(Qx, Qy), PCAScheme(3).fit(Qx),
                OptimalScheme(24).fit(Qx, Qy)):
        got = sch.roundtrip(X.to(cuda), 7)
        assert got.device.type == "cuda"
        _close(got.cpu().numpy(), sch.roundtrip(X, 7).numpy())
    # per-symbol: the codes equal the CPU's except within 2 ulp of a bin edge
    ps = PerSymbolScheme(24).fit(Qx, Qy)
    codes, want = ps.encode(X.to(cuda)).cpu(), ps.encode(X)
    xp = X @ torch.from_numpy(ps._tr.T.astype(np.float32)).T
    edges = Q.build_codebook_tables(int(ps.rates.max()))[0][ps.rates] \
        * torch.from_numpy(ps.sigma)[:, None]
    fin = torch.isfinite(edges)
    e = torch.where(fin, edges, torch.zeros_like(edges))
    ulp = torch.nextafter(e.abs(), torch.full_like(e, float("inf"))) - e.abs()
    near = (((xp[:, :, None] - e[None]).abs() <= 2 * ulp[None]) & fin[None]).any(-1)
    flips = codes != want
    assert not bool((flips & ~near).any())
    same = ~flips.any(1)
    _close(ps.roundtrip(X.to(cuda)).cpu().numpy()[same.numpy()],
           ps.roundtrip(X).numpy()[same.numpy()])


def test_gp_model_and_sparse_gp_through_the_gram_kernel(cuda):
    from repro_torch.core.gp import GPModel, init_params
    from repro_torch.core.sparse_gp import SGPR, elbo, train_sgpr

    rng = np.random.default_rng(1)
    X = torch.from_numpy(rng.normal(size=(300, 3)).astype(np.float32))
    y = torch.sin(X.sum(1)) + 0.1 * torch.from_numpy(rng.normal(size=300).astype(np.float32))
    Xq = X[:50] + 0.3
    p = init_params(0.8, 1.5, 0.05)
    on = lambda q: type(q)(*(a.to(cuda) for a in q))  # noqa: E731
    model_c = GPModel("se", p, X, y, gram_backend="pallas")
    model_g = GPModel("se", on(p), X.to(cuda), y.to(cuda), gram_backend="pallas")
    before = runtime.family("gram").launches
    model_g.factors()
    mid = runtime.family("gram").launches
    got = model_g.predict(Xq)
    torch.cuda.synchronize()
    assert (mid - before, runtime.family("gram").launches - mid) == (1, 1)
    for a, b in zip(got, model_c.predict(Xq)):
        _close(a.cpu().numpy(), b.numpy())
    _close(float(model_g.nlml()), float(model_c.nlml()))

    Z = X[:15] + 0.1
    sg_c = SGPR("se", p, Z, X, y, gram_backend="pallas")
    sg_g = SGPR("se", on(p), Z.to(cuda), X.to(cuda), y.to(cuda), gram_backend="pallas")
    before = runtime.family("gram").launches
    e_g = elbo(sg_g.params, sg_g.Z, sg_g.X, sg_g.y, "se", "pallas")
    torch.cuda.synchronize()
    assert runtime.family("gram").launches == before + 2  # Kmm and Kmn
    _close(float(e_g), float(elbo(p, Z, X, y, "se", "pallas")))
    for a, b in zip(sg_g.predict(Xq), sg_c.predict(Xq)):
        _close(a.cpu().numpy(), b.numpy())
    for a, b in zip(sg_g.qu(), sg_c.qu()):
        _close(a.cpu().numpy(), b.numpy())
    # a batched fit through the kernel, forward and backward: 2 + 3 launches a step
    Xb, yb = X.reshape(3, 100, 3), y.reshape(3, 100)
    before = runtime.family("gram").launches
    fit_g = train_sgpr(Xb.to(cuda), yb.to(cuda), 10, steps=5, seed=4, gram_backend="pallas")
    torch.cuda.synchronize()
    assert runtime.family("gram").launches == before + 5 * 5
    fit_c = train_sgpr(Xb, yb, 10, steps=5, seed=4, gram_backend="pallas")
    np.testing.assert_allclose(fit_g.Z.cpu().numpy(), fit_c.Z.numpy(), rtol=1e-4, atol=1e-4)


# --------------------------------------------------------------------------
# impl="mesh": one process per machine on the card
# --------------------------------------------------------------------------

MESH_CFGS = {
    "center": dict(protocol="center", bits_per_sample=24),
    "broadcast": dict(protocol="broadcast", fusion="kl", bits_per_sample=24),
    "poe": dict(protocol="poe", fusion="rbcm", bits_per_sample=0),
}
MESH_START = (0.2, -0.3, -1.5)


@pytest.fixture(scope="module")
def card_ranks():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA card (the mesh ranks run on it)")
    from repro_torch.launch.ranks import RankPool

    with RankPool(4, device="cuda", timeout=300) as pool:
        yield pool


def _mesh_problem():
    rng = np.random.default_rng(3)
    W = rng.normal(size=(6, 2))
    X = rng.normal(size=(160, 6)).astype(np.float32)
    y = (np.sin(X @ W[:, 0]) + 0.4 * (X @ W[:, 1])).astype(np.float32)
    parts = [(X[j::4], y[j::4]) for j in range(4)]
    return parts, rng.normal(size=(32, 6)).astype(np.float32)


@pytest.mark.parametrize("protocol", list(MESH_CFGS))
def test_mesh_on_the_card_matches_the_batched_fit(cuda, card_ranks, protocol):
    parts, Xq = _mesh_problem()
    cfg = dict(steps=10, **MESH_CFGS[protocol])
    outs = card_ranks.run(fit_predict, cfg, parts, Xq, MESH_START, device="cuda")
    for o in outs[1:]:
        np.testing.assert_array_equal(o["mu"], outs[0]["mu"])
        np.testing.assert_array_equal(o["var"], outs[0]["var"])
    est = DistributedGP(DGPConfig(**cfg), device=cuda)
    from repro_torch.core import GPParams

    art = est.fit(parts=parts, params=GPParams(*(torch.tensor(v) for v in MESH_START)))
    mu, var = (a.cpu().numpy() for a in est.predict(art, Xq))
    o = outs[0]
    assert (o["wire_bits"], o["payload_bits"], o["integrity_bits"]) == (
        art.wire_bits, art.payload_bits, art.integrity_bits)
    for got, want in ((o["mu"], mu), (o["var"], var)):
        np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3 * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("protocol", ["broadcast", "poe"])
def test_mesh_on_the_card_serves_with_one_allreduce(cuda, card_ranks, protocol):
    parts, Xq = _mesh_problem()
    for o in card_ranks.run(serve_structure, dict(steps=2, **MESH_CFGS[protocol]), parts, Xq,
                            MESH_START, device="cuda"):
        assert o["ok"], o["findings"]
        assert o["collectives"] == {"c10d.allreduce_": {"count": 1, "bytes": 3 * 32 * 4}}
        assert o["factorizations"] == {"cholesky": 0, "eigh": 0}


# ---- LLM decode serving: the softcap, every architecture card vs CPU ---------------

from repro_torch.configs import get_config, list_archs  # noqa: E402
from repro_torch.launch.serve import serve  # noqa: E402
from repro_torch.analysis import lockstep as LS  # noqa: E402
from repro_torch.models import attn_launches_per_step, cast_compute, init_model  # noqa: E402


@pytest.mark.parametrize("q_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("S,window,pos", [(4096, 4096, 9000),   # gemma2 local ring, wrapped
                                          (8192, None, 6000)])  # a global cache, part filled
def test_decode_attn_softcap_at_gemma2_shapes(cuda, q_dtype, S, window, pos):
    B, KV, G, hd = 4, 4, 2, 256
    q, K, V, kpos = decode_attn_operands(B, S, KV, G, hd, pos=pos, q_dtype=q_dtype,
                                         ring=window is not None, seed=S + 7, device=cuda)
    q = (q.float() * 4).to(q_dtype)  # scores of std ~64: the cap at 50 bends most of them
    before = runtime.family("decode_attn").launches
    got = decode_attn_cuda(q, K, V, kpos, pos, window=window, softcap=50.0)
    again = decode_attn_cuda(q, K, V, kpos, torch.tensor(pos, dtype=torch.int32, device=cuda),
                             window=window, softcap=50.0)
    torch.cuda.synchronize()
    assert runtime.family("decode_attn").launches == before + 2
    assert torch.equal(got, again)
    want = decode_attn_plain(q, K, V, kpos, pos, window=window, softcap=50.0)
    tol = 1e-5 * float(V.float().abs().max())
    assert bool(torch.isfinite(got).all()) and float((got - want).abs().max()) <= tol
    uncapped = decode_attn_cuda(q, K, V, kpos, pos, window=window)
    assert torch.equal(uncapped, decode_attn_cuda(q, K, V, kpos, pos, window=window,
                                                  softcap=None))
    assert float((uncapped - got).abs().max()) > 100 * tol


def _dtypes_held(arch):
    """bf16 for every architecture; float32 too for the hybrid family, whose
    bf16 numbers are reported, not held (``repro_torch.analysis.lockstep``)."""
    fp32 = get_config(arch).family == "hybrid"
    return [(arch, torch.bfloat16)] + ([(arch, torch.float32)] if fp32 else [])


@pytest.mark.parametrize("arch,dtype", [c for a in list_archs() for c in _dtypes_held(a)])
def test_reduced_decode_on_card_matches_cpu(cuda, arch, dtype):
    """Each reduced architecture teacher-forced on the card and on the CPU
    from the same weights (``repro_torch.analysis.lockstep``): no
    ``faults`` at the run's ``tolerance`` (logits and state leaves at every
    step, kpos equal, greedy tokens equal at a clear margin), router flips
    only at MoE near-ties, ``decode_attn`` launched once per attention
    layer a step on the card; and ``serve`` on the card the same."""
    cfg = get_config(arch).reduced()
    params = cast_compute(init_model(cfg, seed=0, device=cuda), dtype)
    tokens = np.random.default_rng(3).integers(0, cfg.vocab_size, (40, 2, 1), dtype=np.int32)
    ref = LS.PortSide(cfg, params, "cpu", 2, 40)
    got = LS.PortSide(cfg, params, cuda, 2, 40)
    before = runtime.family("decode_attn").launches
    rep = LS.lockstep(ref, got, tokens, LS.tolerance(cfg, dtype), hold=LS.holds_numbers(cfg, dtype),
                      route_tol=LS.ROUTE_TOL if dtype == torch.bfloat16 else None)
    per_step = attn_launches_per_step(cfg)
    assert runtime.family("decode_attn").launches - before == 40 * per_step
    assert not LS.faults(rep), LS.faults(rep)
    assert not rep["flipped"] or cfg.family == "moe"
    assert not rep["hold"] or rep["greedy_clear"] > 0
    out = serve(cfg, batch=2, prompt_len=8, gen=4, device=cuda, params=params)
    assert out["attn_launches"] == out["steps"] * per_step


import dataclasses  # noqa: E402

from repro_torch.analysis import trainstep as TSTEP  # noqa: E402
from repro_torch.analysis.lockstep import flat  # noqa: E402
from repro_torch.checkpoint import restore_checkpoint, save_checkpoint  # noqa: E402
from repro_torch.data import lm_batch_stream  # noqa: E402
from repro_torch.models import init_train_state, make_train_step, param_count  # noqa: E402
from repro_torch.models.weights import _map  # noqa: E402


@pytest.mark.parametrize("arch", list_archs())
def test_reduced_train_step_on_card_matches_cpu(cuda, arch):
    """One float32 train step of each reduced architecture on the card and
    on the CPU from the same weights and batch (``analysis.trainstep``):
    logits, loss, MoE aux and every gradient leaf within
    ``trainstep.limits`` of scale, each update its own AdamW step (float64
    from its gradients) within ``adamw_err``, the two at most one AdamW step
    apart; no kernel launched."""
    cfg = get_config(arch).reduced()
    p_np = _map(lambda _, t: t.numpy(), init_model(cfg, seed=0, device="cpu"))
    b_np = TSTEP.batch_arrays(cfg, 2, 64, seed=0)
    ref = TSTEP.run_step(cfg, p_np, b_np, "cpu")
    runtime.reset_launches()
    got = TSTEP.run_step(cfg, p_np, b_np, cuda)
    torch.cuda.synchronize()
    assert not any(runtime.launches().values())
    rep = TSTEP.compare(ref, got)
    assert not TSTEP.faults(rep, cfg), (TSTEP.faults(rep, cfg), rep)


def test_train_checkpoint_roundtrip_on_card(cuda, tmp_path):
    cfg = get_config("gemma2-2b").reduced()
    params, opt = init_train_state(cfg, seed=0, device=cuda)
    batch = next(lm_batch_stream(cfg.vocab_size, 2, 32, device=cuda))
    params, opt, _ = make_train_step(cfg, warmup=0)(params, opt, batch)
    tree = {"params": params, "opt": opt}
    save_checkpoint(str(tmp_path), 1, tree)
    back = restore_checkpoint(str(tmp_path), 1, tree)
    assert int(back["opt"].step) == 1
    want = flat({"p": params, "m": opt.m, "v": opt.v})
    got = flat({"p": back["params"], "m": back["opt"].m, "v": back["opt"].v})
    assert set(want) == set(got)
    for k in want:
        assert got[k].device.type == "cuda" and torch.equal(got[k], want[k]), k


def test_full_width_step_stays_within_its_state(cuda):
    """A two-layer full-width step (gemma-7b's width, vocab 256000; the
    layers stacked two deep) holds, above its params, m and v, no more than
    its fp32 gradients, the bf16 cast, two bf16 copies of the stacked
    layers (each layer's gradient and their stack: one ``unbind`` a leaf, no
    ``leaf[i]`` whose backward writes a zero-filled stacked copy a layer),
    AdamW's temporaries of the largest leaf (three) and the activations."""
    cfg = dataclasses.replace(get_config("gemma-7b"), num_layers=2)
    batch = next(lm_batch_stream(cfg.vocab_size, 1, 64, device=cuda))
    step = make_train_step(cfg, warmup=0)

    def peak_above_state():
        torch.cuda.empty_cache()
        params, opt = init_train_state(cfg, seed=0, device=cuda)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        params, opt, m = step(params, opt, batch)
        torch.cuda.synchronize()
        assert bool(torch.isfinite(m["loss"])) and int(opt.step) == 1
        return torch.cuda.max_memory_allocated() - base, params

    above, params = peak_above_state()
    P = 4 * param_count(params)
    stacked = 2 * param_count(params["layers"])
    largest = 4 * max(t.numel() for t in flat(params).values())
    params = None
    acts = 8 * 64 * cfg.vocab_size * 4 + 64 * 1024 ** 2  # a few fp32 logits-sized temporaries
    bound = P + P // 2 + 2 * stacked + 3 * largest + acts
    print(f"\ntwo-layer full-width step: {above / 1e9:.3f} GB above params, m and v; bound "
          f"{bound / 1e9:.3f} GB (params {P / 1e9:.3f} GB, stacked layers bf16 "
          f"{stacked / 1e9:.3f} GB)")
    assert above <= bound, (above / 1e9, bound / 1e9, P / 1e9)


# ---- decode_attn as a custom op, and the dry run's trace of it ----------------

_OP_CASES = [
    (2, 1000, 4, 8, 128, torch.float32, torch.bfloat16, None, 999, False),
    (2, 8192, 4, 2, 256, torch.float32, torch.bfloat16, 4096, 10000, True),
    (3, 333, 2, 3, 40, torch.float32, torch.float32, None, 300, False),
    (2, 130, 1, 12, 16, torch.bfloat16, torch.float32, 64, 120, True),
]


@pytest.mark.parametrize("B,S,KV,G,hd,q_dtype,kv_dtype,window,pos,ring", _OP_CASES)
def test_decode_attn_custom_op(cuda, B, S, KV, G, hd, q_dtype, kv_dtype, window, pos, ring):
    """``torch.ops.repro_torch.decode_attn`` called directly equals the
    wrapper's launch bit for bit and the plain version within 1e-5 max|V|,
    one launch a call; under a fake mode on ``cuda`` tensors the wrapper
    traces the op and launches nothing."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.roofline import CostCounter

    q, K, V, kpos = decode_attn_operands(B, S, KV, G, hd, pos=pos, q_dtype=q_dtype,
                                         kv_dtype=kv_dtype, ring=ring, seed=S, device=cuda)
    fam = runtime.family("decode_attn")
    before = fam.launches
    direct = torch.ops.repro_torch.decode_attn(q, K, V, kpos, None, pos, window, None)
    via = decode_attn_cuda(q, K, V, kpos, pos, window=window)
    torch.cuda.synchronize()
    assert fam.launches == before + 2
    assert torch.equal(direct, via)
    want = decode_attn_plain(q, K, V, kpos, pos, window=window)
    assert float((direct - want).abs().max()) <= 1e-5 * float(V.float().abs().max())
    before = fam.launches
    with FakeTensorMode(allow_non_fake_inputs=True) as mode:
        fq, fK, fV, fk = (mode.from_tensor(t) for t in (q, K, V, kpos))
        fpos = torch.empty((), dtype=torch.int32, device="cuda")
        with CostCounter() as counter:
            out = decode_attn_cuda(fq, fK, fV, fk, fpos, window=window)
    assert fam.launches == before
    assert tuple(out.shape) == (B, KV, G, hd) and out.dtype == torch.float32
    assert counter.calls == {"repro_torch::decode_attn": 1}
    assert counter.cost.flops == 4 * B * KV * G * S * hd


# ---- the autotune cache on the card: every candidate, the winners, processes --------

from repro_torch.kernels.epilogue import ops as epi_ops  # noqa: E402
from repro_torch.kernels.qgram import ops as qgram_ops  # noqa: E402

# qgram_packed at the paths' calls (m, n, p, d, R): Fig. 6 center fit, broadcast
# fit, 40 x 1000 x 4449; epilogue_fleet (T, m, t, K): serve_gp's flush, the
# smoke's flush, serve-sized requests
TUNE_QGRAM = [(39, 25, 25, 21, 24), (40, 25, 1000, 21, 24), (40, 1000, 4449, 21, 24)]
TUNE_FLEET = [(4, 40, 128, 50), (16, 40, 16, 25), (8, 40, 128, 25)]


def _sms(cuda):
    return torch.cuda.get_device_properties(cuda).multi_processor_count


@pytest.mark.parametrize("m,n,p,d,R", TUNE_QGRAM)
def test_qgram_packed_every_candidate_and_the_winner(cuda, m, n, p, d, R):
    words, rates, cents, proj, mask = _packed(R + n + p, m, n, d, p, R)
    args = [t.to(cuda) for t in (words, rates, cents, proj)]
    want = qgram_packed_plain(words, rates, cents, proj, total_bits=R, mask=mask).numpy()
    feasible = []
    for (v,) in runtime.tune_candidates("qgram_packed"):
        try:
            pl = qgram_ops.plan(m, n, p, d, words.shape[-1], cents.shape[-1], _sms(cuda),
                                variant=v)
        except ValueError:
            continue
        feasible.append(pl)
        got = qgram_packed_cuda(*args, total_bits=R, mask=mask.to(cuda), plan=pl)
        _close(got.cpu().numpy(), want)
    win = qgram_ops.tuned_plan(*args, total_bits=R, mask=mask.to(cuda))
    assert win in feasible
    assert torch.equal(qgram_packed_cuda(*args, total_bits=R, mask=mask.to(cuda)),
                       qgram_packed_cuda(*args, total_bits=R, mask=mask.to(cuda), plan=win))


@pytest.mark.parametrize("T,m,t,K", TUNE_FLEET)
def test_epilogue_fleet_every_candidate_and_the_winner(cuda, T, m, t, K):
    ops = epilogue_fleet_operands(T, m, t, K, seed=T + m + t + K, device=cuda)
    want = epilogue_moments_fleet_plain(*ops, fuse="kl")
    bound = epilogue_fleet_error_bound(*ops, fuse="kl")
    feasible = []
    for tile in runtime.tune_candidates("epilogue_fleet"):
        try:
            pl = epi_ops.plan_fleet(T, m, t, K, _sms(cuda), tile=tile)
        except ValueError:
            continue
        feasible.append(pl)
        got = epilogue_fleet_cuda(*ops, fuse="kl", plan=pl)
        assert bool(torch.isfinite(got).all())
        assert float(((got - want).abs() - bound).max()) <= 0, pl
    assert epi_ops.fleet_epilogue_plan(T, m, t, K, fuse="kl", device=cuda) in feasible


def test_a_cold_call_that_sweeps_counts_one_launch(cuda, monkeypatch, tmp_path):
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "autotune.json"))
    runtime.clear_cache_memory()
    m, n, p, d, R = TUNE_QGRAM[1]
    words, rates, cents, proj, mask = [t.to(cuda) for t in _packed(7, m, n, d, p, R)]
    runtime.reset_launches()
    before = runtime.sweep_count()
    qgram_packed_cuda(words, rates, cents, proj, total_bits=R, mask=mask)
    torch.cuda.synchronize()
    assert runtime.sweep_count() == before + 1
    assert runtime.launches()["qgram_packed"] == 1
    ops = epilogue_fleet_operands(*TUNE_FLEET[0], seed=1, device=cuda)
    pl = epi_ops.fleet_epilogue_plan(*TUNE_FLEET[0], fuse="kl", device=cuda)
    epilogue_fleet_cuda(*ops, fuse="kl", plan=pl)
    torch.cuda.synchronize()
    assert runtime.sweep_count() == before + 2
    assert runtime.launches()["epilogue_fleet"] == 1
    blob = json.load(open(tmp_path / "autotune.json"))
    assert len(blob["entries"]) == 2 and all(k.split("|")[1].startswith("cuda:")
                                             for k in blob["entries"])
    runtime.clear_cache_memory()


_TUNE_CHILD = r"""
import json, sys
sys.path.insert(0, {src!r})
sys.path.insert(0, {tests!r})
import torch
from repro_torch.kernels import runtime
from repro_torch.kernels.epilogue.ops import fleet_epilogue_plan
from repro_torch.kernels.qgram.ops import qgram_packed_cuda, tuned_plan
from test_torch_gpu import TUNE_FLEET, TUNE_QGRAM, _packed

cuda = torch.device("cuda")
wins = []
for m, n, p, d, R in TUNE_QGRAM[:2]:
    words, rates, cents, proj, mask = [t.to(cuda) for t in _packed(R + n + p, m, n, d, p, R)]
    qgram_packed_cuda(words, rates, cents, proj, total_bits=R, mask=mask)
    wins.append(list(tuned_plan(words, rates, cents, proj, total_bits=R, mask=mask)))
for shape in TUNE_FLEET[:2]:
    wins.append(list(fleet_epilogue_plan(*shape, fuse="kl", device=cuda)))
torch.cuda.synchronize()
print(json.dumps({{"sweeps": runtime.sweep_count(), "wins": wins,
                  "launches": runtime.launches()}}))
"""


def test_autotune_cold_and_warm_processes_on_the_card(cuda, tmp_path):
    """A cold process sweeps each key once and its launches count only its
    calls; a second process on the same file sweeps none and plans alike."""
    here = os.path.dirname(os.path.abspath(__file__))
    script = _TUNE_CHILD.format(src=os.path.join(here, "..", "src"), tests=here)
    env = dict(os.environ, REPRO_TUNE_CACHE=str(tmp_path / "autotune.json"))

    def run():
        r = subprocess.run([sys.executable, "-c", script], env=env, capture_output=True,
                           text=True, timeout=600)
        assert r.returncode == 0, r.stderr[-3000:]
        return json.loads(r.stdout.strip().splitlines()[-1])

    cold = run()
    assert cold["sweeps"] == 4
    assert cold["launches"]["qgram_packed"] == 2 and cold["launches"]["epilogue_fleet"] == 0
    warm = run()
    assert warm["sweeps"] == 0 and warm["wins"] == cold["wins"]


def test_warm_fleet_predict_makes_no_host_sync(cuda):
    parts, Xq = _fig6_like()
    est = DistributedGP(DGPConfig(protocol="broadcast", fusion="kl", gram_backend="pallas",
                                  steps=10))
    art = est.fit(parts=parts)
    stack = FleetStack({i: scale_targets(art, 0.5 + 0.25 * i) for i in range(4)}, slots=4)
    X4 = torch.as_tensor(np.stack([Xq[:16]] * 4), device=cuda)
    cold = stack.predict([3, 0, 1, 3], X4)  # resolves (and sweeps) the stack's plan
    torch.cuda.synchronize()
    sweeps = runtime.sweep_count()
    runtime.reset_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        warm = stack.predict([3, 0, 1, 3], X4)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert runtime.sweep_count() == sweeps and runtime.launches()["epilogue_fleet"] == 1
    assert all(torch.equal(a, b) for a, b in zip(cold, warm))
