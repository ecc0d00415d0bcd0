"""The port's contract checker (``repro_torch.analysis``) against the
reference's (``repro.analysis``), on the CPU.

The port fits center, broadcast and poe artifacts from numpy parts (m = 4,
n = 96, d = 4, one Adam step) and the reference loads their checkpoints, so
both inspect the same artifacts; their ``check_contracts``
must agree on the contract's name, its verdict, the cholesky / eigh counts
(0) and the collectives (none).  Then each rule fires on a doctored case,
under the reference's rule name where the reference has the rule: a
``torch.linalg.cholesky`` (or a general solve) injected into a predict, an
``.item()`` in a predict, a doctored ``wire_bits`` and a tensor on the
``meta`` device.  The check leaves the artifact, the growth count and the
launch counts as they were; ``retrace_budget`` raises on a growth; each
lint rule fires on a bad source and the port's tree is clean.  Everything
here is integer or bitwise: no tolerance.
"""
import dataclasses
import pathlib
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_thread  # noqa: E402,F401
import jax  # noqa: E402,F401

from repro.analysis import check_contracts as ref_check  # noqa: E402
from repro.analysis import contracts as ref_contracts  # noqa: E402
from repro.analysis import jaxpr_walk as ref_walk  # noqa: E402
from repro.analysis import lint as ref_lint  # noqa: E402
from repro_torch.analysis import (  # noqa: E402
    FACTORIZATION_OPS, FACTORIZATION_PRIMITIVES, Contract, ContractViolation,
    LedgerAccounting, NoHostCallbacks, NoShardingLeak, check_contracts, contract_for,
    find_sharding_leaks, forbid_primitives, hand_written_kernels, predict_ops,
    primitive_counts, record_ops, register_contract, retrace_budget,
)
from repro_torch.analysis.op_walk import KERNEL_SYMBOLS, kernel_trace  # noqa: E402
from repro_torch.analysis import lint  # noqa: E402
from repro_torch.analysis.contracts import _CheckContext, _tensor_leaves  # noqa: E402
from repro_torch.core import DGPConfig, DistributedGP  # noqa: E402
from repro_torch.core.protocols import center  # noqa: E402
from repro_torch.core.protocols.base import predict_op_counts  # noqa: E402
from repro_torch.core.protocols.streaming import update_growth_count  # noqa: E402
from repro_torch.kernels import runtime  # noqa: E402

M, N, D = 4, 96, 4
PKG = pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch"
# the reference's default gram backend: its pallas route adds seconds of
# compilation here, and the port's kernel route is checked by
# tests/test_torch_serve_gp.py (--gram-backend pallas) and on the card
CONFIGS = {
    "center": dict(protocol="center", bits_per_sample=8),
    "broadcast": dict(protocol="broadcast", fusion="kl", bits_per_sample=8),
    "poe": dict(protocol="poe", fusion="rbcm", bits_per_sample=0, gram_mode="dense"),
}


def _parts(seed=0):
    rng = np.random.default_rng(seed)
    W = rng.normal(size=(D, 2))
    X = rng.normal(size=(N, D)).astype(np.float32)
    y = (np.sin(X @ W[:, 0]) + 0.4 * (X @ W[:, 1])
         + 0.05 * rng.normal(size=N)).astype(np.float32)
    return [(X[c], y[c]) for c in np.array_split(rng.permutation(N), M)]


def _queries(t=8, seed=3):
    return np.random.default_rng(seed).normal(size=(t, D)).astype(np.float32)


@pytest.fixture(scope="module")
def arts(tmp_path_factory):
    """{kind: (reference artifact, port artifact)}: the port fits each kind
    from the parts and the reference loads the port's checkpoint, so both
    checkers inspect the same artifact (a fit of the reference's own would
    cost each kind seconds of JAX compilation and add nothing the contract
    reads; tests/test_torch_deprecations.py holds a fit of both packages on
    the same parts)."""
    from repro.core.protocols import load_artifact as ref_load

    parts = _parts()
    out = {}
    for kind, cfg in CONFIGS.items():
        art = DistributedGP(DGPConfig(steps=1, **cfg), device="cpu").fit(parts=parts)
        path = str(tmp_path_factory.mktemp(kind))
        DistributedGP(art.config, device="cpu").save(art, path)
        out[kind] = (ref_load(path), art)
    return out


# --------------------------------------------------------------------------
# the shipped contracts, held against the reference's
# --------------------------------------------------------------------------


@pytest.mark.parametrize("kind", sorted(CONFIGS))
def test_check_contracts_agrees_with_the_reference(kind, arts):
    ref, art = arts[kind]
    Xq = _queries()
    want, got = ref_check(ref, Xq), check_contracts(art, Xq)
    assert (got.contract, got.protocol, got.phase, got.ok) == \
        (want.contract, want.protocol, want.phase, want.ok) == \
        (f"{kind}-serve", kind, "predict", True)
    for prim in ("cholesky", "eigh"):
        assert got.op_counts[prim] == want.op_counts[prim] == 0
    assert sum(got.op_counts.values()) == sum(want.op_counts.values()) == 0
    assert got.collectives == want.collectives == {}
    assert got.leaks == want.leaks == ()
    assert sorted(got.op_counts) == sorted(want.op_counts)
    assert predict_op_counts(art, Xq) == {"cholesky": 0, "eigh": 0}
    upd, rupd = check_contracts(art, phase="update"), ref_check(ref, phase="update")
    assert (upd.contract, upd.ok, upd.op_counts) == (rupd.contract, rupd.ok, rupd.op_counts)


def test_factorization_names_and_rules_match_the_reference():
    assert FACTORIZATION_PRIMITIVES == ref_walk.FACTORIZATION_PRIMITIVES
    assert set(FACTORIZATION_OPS) == set(ref_walk.FACTORIZATION_PRIMITIVES)
    for ours, theirs in ((forbid_primitives(), ref_contracts.forbid_primitives()),
                         (NoHostCallbacks(), ref_contracts.NoHostCallbacks()),
                         (NoShardingLeak(), ref_contracts.NoShardingLeak()),
                         (LedgerAccounting(), ref_contracts.LedgerAccounting())):
        assert ours.name == theirs.name
    assert forbid_primitives().budgets == ref_contracts.forbid_primitives().budgets


@pytest.mark.parametrize("call, prim", [
    (lambda A: torch.linalg.cholesky(A), "cholesky"),
    (lambda A: torch.linalg.eigh(A), "eigh"),
    (lambda A: torch.linalg.eig(A), "eig"),
    (lambda A: torch.linalg.svd(A), "svd"),
    (lambda A: torch.linalg.qr(A), "qr"),
    (lambda A: torch.linalg.solve(A, A), "lu"),
    (lambda A: torch.linalg.inv(A), "lu"),
    (lambda A: torch.linalg.lu_factor(A), "lu"),
    (lambda A: torch.cholesky_solve(A, torch.linalg.cholesky(A)), "cholesky"),
])
def test_record_ops_counts_each_factorization_once(call, prim):
    A = torch.eye(4) * 3.0 + 0.1
    counts = primitive_counts(record_ops(call, A), names=FACTORIZATION_PRIMITIVES)
    assert counts[prim] == 1 and sum(counts.values()) == 1


def test_solves_against_a_cached_factor_are_not_factorizations():
    L = torch.linalg.cholesky(torch.eye(4) * 3.0 + 0.1)
    B = torch.ones(4, 2)
    ops = record_ops(lambda: (torch.cholesky_solve(B, L),
                              torch.linalg.solve_triangular(L, B, upper=False)))
    assert sum(primitive_counts(ops, names=FACTORIZATION_PRIMITIVES).values()) == 0
    assert ops["cholesky_solve"] == 1 and ops["linalg_solve_triangular"] == 1


@pytest.mark.parametrize("name, symbol", [
    ("void (anonymous namespace)::gram_kernel<0>(int, int, int, int, float const*)",
     "gram_kernel"),
    ("_ZN47_GLOBAL__N__725d2bc7_14_gram_cu_4710b37011gram_kernelILi0EEviiii", "gram_kernel"),
    ("void qgram::(anonymous namespace)::qgram_kernel<qgram::PackedRows>(qgram::Args)",
     "qgram_kernel"),
    ("_ZN5qgram12_GLOBAL__N_112qgram_kernelINS_10PackedRowsEEEvNS_4ArgsE", "qgram_kernel"),
    ("void (anonymous namespace)::small_kernel<28>((anonymous namespace)::Args)",
     "small_kernel"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::FillFunctor<float>>", None),
    ("ampere_sgemm_128x64_nn", None),
    ("Memcpy HtoD (Pageable -> Device)", None),
])
def test_hand_written_kernels_are_told_from_library_kernels(name, symbol):
    """The profiler's kernel names, demangled or not, map onto the
    ``__global__`` names of kernels/csrc and nothing else."""
    assert hand_written_kernels([name]) == ({symbol: 1} if symbol else {})
    if symbol:
        assert any(symbol in syms for syms in KERNEL_SYMBOLS.values())


def test_kernel_trace_runs_the_call_once_and_sees_no_kernel_off_the_card():
    calls = []
    assert kernel_trace(lambda x: calls.append(x), 3) == ([], 0)
    assert calls == [3]


# --------------------------------------------------------------------------
# each rule fires on a doctored case
# --------------------------------------------------------------------------


def _injected(monkeypatch, extra):
    """Center's nystrom serve with ``extra()`` run inside it."""
    orig = center.nystrom_apply_cached

    def doctored(*a, **k):
        extra()
        return orig(*a, **k)

    monkeypatch.setattr(center, "nystrom_apply_cached", doctored)


@pytest.mark.parametrize("extra, prim", [
    (lambda: torch.linalg.cholesky(torch.eye(3)), "cholesky"),
    (lambda: torch.linalg.solve(torch.eye(3), torch.ones(3)), "lu"),
])
def test_a_factorization_in_predict_fires_the_primitive_budget(extra, prim, arts,
                                                               monkeypatch):
    art = arts["center"][1]
    _injected(monkeypatch, extra)
    with pytest.raises(ContractViolation) as exc:
        check_contracts(art, _queries())
    rules = {f.rule for f in exc.value.findings}
    assert rules == {ref_contracts.forbid_primitives().name}
    assert any(f.detail.startswith(f"{prim}: 1 ops") for f in exc.value.findings)
    report = check_contracts(art, _queries(), raise_on_violation=False)
    assert not report.ok and report.op_counts[prim] == 1


def test_an_item_in_predict_fires_no_host_callbacks(arts, monkeypatch):
    art = arts["center"][1]
    _injected(monkeypatch, lambda: art.params.log_noise.item())
    with pytest.raises(ContractViolation) as exc:
        check_contracts(art, _queries())
    assert [f.rule for f in exc.value.findings] == [ref_contracts.NoHostCallbacks().name]
    assert "'_local_scalar_dense'" in exc.value.findings[0].detail


def test_ledger_accounting_fires_on_a_doctored_wire_like_the_reference(arts):
    ref, art = arts["center"]
    assert (art.wire_bits, art.payload_bits, art.integrity_bits) == \
        (int(ref.wire_bits), int(ref.payload_bits), int(ref.integrity_bits))
    bad = dataclasses.replace(art, stream=dataclasses.replace(
        art.stream, wire_bits=art.stream.payload_bits + 1))
    rbad = dataclasses.replace(ref, stream=dataclasses.replace(
        ref.stream, wire_bits=ref.stream.payload_bits + 1))
    got = LedgerAccounting().check(_CheckContext(artifact=bad))
    want = ref_contracts.LedgerAccounting().check(ref_contracts._CheckContext(artifact=rbad))
    assert got == want and "payload_bits" in got[0]
    with pytest.raises(ContractViolation) as exc:
        check_contracts(bad, phase="update")
    assert [f.rule for f in exc.value.findings] == ["ledger-accounting"]


def test_a_tensor_on_the_meta_device_fires_no_sharding_leak(arts):
    art = arts["center"][1]
    wire = dataclasses.replace(art.wire, sigma=torch.empty_like(art.wire.sigma,
                                                                device="meta"))
    bad = dataclasses.replace(art, wire=wire)
    assert find_sharding_leaks(bad) == [("wire/sigma", "meta")]
    assert find_sharding_leaks(art) == []
    with pytest.raises(ContractViolation) as exc:
        check_contracts(bad, _queries())
    assert [f.rule for f in exc.value.findings] == [ref_contracts.NoShardingLeak().name]
    report = check_contracts(bad, _queries(), raise_on_violation=False)
    assert report.leaks == (("wire/sigma", "meta"),) and not report.ok


# --------------------------------------------------------------------------
# side effects, growths, the registry
# --------------------------------------------------------------------------


def test_check_contracts_leaves_artifact_and_counters_unchanged(arts):
    runtime.families()  # register every kernel family
    for kind in sorted(CONFIGS):
        art = arts[kind][1]
        before = [(p, t.clone()) for p, t in _tensor_leaves(art)]
        growths = {k: update_growth_count(k) for k in CONFIGS}
        runtime.family("gram").launches += 5  # a nonzero count must survive
        launches = runtime.launches()
        for _ in range(2):
            check_contracts(art, _queries())
            predict_ops(art)
        assert runtime.launches() == launches
        assert {k: update_growth_count(k) for k in CONFIGS} == growths
        after = list(_tensor_leaves(art))
        assert [p for p, _ in after] == [p for p, _ in before]
        for (p, t0), (_, t1) in zip(before, after):
            assert t0.dtype == t1.dtype and torch.equal(t0, t1), p
        runtime.family("gram").launches -= 5


def test_retrace_budget_raises_on_a_growth(arts):
    art = arts["center"][1]
    est = DistributedGP(art.config, device="cpu")
    Xn, yn = _queries(4, seed=5), np.zeros(4, np.float32)
    with retrace_budget("center"):
        est.predict(art, _queries())  # a serve never grows
    with pytest.raises(ContractViolation) as exc:
        with retrace_budget("center"):
            grown = est.update(art, Xn, yn, machine=1)  # a fresh fit is exact-size
    assert [f.rule for f in exc.value.findings] == ["serve-retraces"]
    with retrace_budget("center", serve=1, update=1):
        est.update(art, Xn, yn, machine=2)
    with retrace_budget("center", serve=0, update=0):
        est.update(grown, Xn, yn, machine=2)  # inside the new bucket


def test_contract_lookup_precedence_and_duplicates():
    assert contract_for("broadcast", "batched", "predict").name == "broadcast-serve"
    assert contract_for("poe", "batched", "update").name == "poe-update"
    with pytest.raises(KeyError, match="known: "):
        contract_for("nonesuch", "batched", "predict")
    with pytest.raises(ValueError, match="already registered"):
        register_contract("center", "predict", Contract("dup", rules=()))


# --------------------------------------------------------------------------
# the source plane
# --------------------------------------------------------------------------

BAD_SOURCES = {
    "raw-cholesky": ("src/repro_torch/core/gp.py", "def f(A):\n    return torch.linalg.cholesky(A)\n"),
    "raw-eigh": ("src/repro_torch/core/schemes.py", "w, v = torch.linalg.eigh(S)\n"),
    "local-jitter": ("src/repro_torch/core/nystrom.py", "_JITTER = 1e-6\n"),
    "device-get-hot-path": ("src/repro_torch/core/protocols/center.py",
                            "def _predict_center(art):\n    return art.y.sum().item()\n"),
    "registry-top-level": ("src/repro_torch/core/protocols/poe.py",
                           "def setup():\n    register_protocol(spec)\n"),
    "trace-counter-encapsulation": ("src/repro_torch/launch/serve_gp.py",
                                    "from x import streaming\nstreaming._GROWTHS.clear()\n"),
}


@pytest.mark.parametrize("rule", sorted(BAD_SOURCES))
def test_each_lint_rule_fires_on_a_bad_source(rule):
    path, src = BAD_SOURCES[rule]
    assert [v.rule for v in lint.lint_source(src, path)] == [rule]
    if rule in ref_lint.RULES:  # the same source, placed in the reference's tree
        ref_path = path.replace("repro_torch", "repro")
        ref_src = src.replace("torch.linalg", "jnp.linalg").replace("_GROWTHS", "_SERVE_TRACES")
        if rule == "device-get-hot-path":
            ref_src = "def _predict_center(art):\n    return jax.device_get(art.y)\n"
        assert [v.rule for v in ref_lint.lint_source(ref_src, ref_path)] == [rule]


@pytest.mark.parametrize("path, src", [
    ("src/repro_torch/core/linalg_safe.py", "L = torch.linalg.cholesky(A)\n"),
    ("src/repro_torch/core/rate_distortion.py", "w, v = np.linalg.eigh(Q)\n"),
    ("src/repro_torch/core/protocols/base.py", "def serve_health(a):\n    return a.tolist()\n"),
    ("src/repro_torch/kernels/quant/ops.py", "def _numpy(a):\n    return a.cpu().numpy()\n"),
    ("src/repro_torch/core/fleet.py", "def f(a):\n    return a.item()\n"),
    ("src/repro_torch/core/protocols/streaming.py", "_GROWTHS[p] += 1\n"),
    ("src/repro_torch/kernels/gram/ops.py", "FAMILY = runtime.register('gram', k, p)\n"),
])
def test_lint_exemptions_stay_silent(path, src):
    assert lint.lint_source(src, path) == []


def test_host_syncs_in_kernel_ops_and_registrations_below_top_level_fire():
    v = lint.lint_source("def f(a):\n    return a.numpy()\n", "src/repro_torch/kernels/gram/ops.py")
    assert [x.rule for x in v] == ["device-get-hot-path"]
    v = lint.lint_source("def f():\n    runtime.register('x', k, p)\n",
                         "src/repro_torch/kernels/x/ops.py")
    assert [x.rule for x in v] == ["registry-top-level"]


def test_the_ports_tree_is_lint_clean(capsys):
    assert lint.lint_paths([PKG]) == []
    assert lint.main([str(PKG)]) == 0
    assert "clean (6 active rule(s))" in capsys.readouterr().out
    assert set(lint.RULES) == set(ref_lint.RULES) - {"xla-env-mutation"}
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert lint.main(["--list-rules"]) == 0
