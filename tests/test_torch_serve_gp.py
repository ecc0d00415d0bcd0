"""The port's serving CLI (``repro_torch.launch.serve_gp``) against the
reference's (``repro.launch.serve_gp``), on the CPU.

``_parse_chaos`` must build the reference's FaultPlan field for field (an
unknown clause raising the same error), ``_retry`` its backoff schedule.
``main([... "--device", "cpu"])`` runs each protocol, ``--chaos``,
``--stream-every`` and ``--fleet`` at m = 4, n = 96, d = 4, two Adam steps,
and exits 0 with its contract ok; the printed ledgers of a center fit equal
the reference ``main``'s for the same flags and the reference's accounting
formulas (with n % m == 0 and no flips the ledgers do not depend on how the
machines were split), and after a streamed batch the integer ledgers are
those formulas.  ``--mesh`` spawns one process per machine and serves as
the reference's ``--mesh`` does: the contract holds, the ledgers are the
batched run's, and a checkpoint reloads single-process within the CLI's own
1e-4.  Everything compared here is an integer or a printed string: no
tolerance beyond that check.
"""
import dataclasses
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_thread  # noqa: E402,F401

from repro.comm import accounting as ref_acc  # noqa: E402
from repro.launch import serve_gp as ref_serve  # noqa: E402
from repro_torch.comm import accounting as port_acc  # noqa: E402
from repro_torch.core.quantizers import DEFAULT_MAX_BITS  # noqa: E402
from repro_torch.launch import serve_gp  # noqa: E402

TINY = ["--m", "4", "--n", "96", "--d", "4", "--steps", "2", "--bits", "8",
        "--queries", "8", "--batch", "8"]
CPU = ["--device", "cpu"]


# the reference run the ledgers are held against: its fit costs seconds of
# JAX compilation, so it runs as its own CLI process beside this file's
# other tests (the center's cheapest mode to compile, gram mode direct)
REF_FLAGS = TINY + ["--queries", "2", "--protocol", "center", "--gram-mode", "direct"]
_REF = {}


@pytest.fixture(autouse=True, scope="module")
def _reference_cli():
    """The reference's CLI run, started in a process of its own when this
    file starts and collected by the test that reads it."""
    root = pathlib.Path(__file__).resolve().parents[1]
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(root / "src"), os.environ.get("PYTHONPATH", "")]))
    _REF["proc"] = subprocess.Popen(
        [sys.executable, "-m", "repro.launch.serve_gp", *REF_FLAGS], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    yield
    _REF["proc"].kill()
    _REF["proc"].communicate()


def _reference_stdout() -> str:
    out, err = _REF["proc"].communicate(timeout=300)
    assert _REF["proc"].returncode == 0, err
    return out


@pytest.mark.parametrize("spec", [
    "drop:1,flip:0.01,straggle:3@0.2",
    "nan:2",
    "straggle:4",
    " drop:0 ,, drop:2,nan:1,flip:0.5",
    "",
])
def test_parse_chaos_builds_the_references_plan(spec):
    got, want = serve_gp._parse_chaos(spec), ref_serve._parse_chaos(spec)
    names = [f.name for f in dataclasses.fields(want)]
    assert [f.name for f in dataclasses.fields(got)] == names
    assert [getattr(got, n) for n in names] == [getattr(want, n) for n in names]
    assert got.active == want.active


def test_parse_chaos_refuses_an_unknown_clause_like_the_reference():
    msgs = []
    for fn in (serve_gp._parse_chaos, ref_serve._parse_chaos):
        with pytest.raises(ValueError, match="unknown chaos clause") as e:
            fn("drop:1,melt:3")
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_retry_backs_off_like_the_reference():
    schedules = []
    for retry in (serve_gp._retry, ref_serve._retry):
        waits, calls = [], []

        def flaky():
            calls.append(1)
            if len(calls) < 3:
                raise OSError("transient")
            return "ok"

        assert retry("load", flaky, attempts=3, sleep=waits.append) == "ok"
        schedules.append(waits)
        with pytest.raises(OSError):
            retry("load", lambda: (_ for _ in ()).throw(OSError("down")), attempts=2,
                  sleep=waits.append)
    assert schedules[0] == schedules[1] == [0.5, 1.0, 0.5]


def _ledgers(out: str) -> str:
    """The fit line's ledger clause."""
    return re.search(r"wire [0-9.]+ kbit \(packed payload [^)]*\)", out).group(0)


@pytest.mark.parametrize("protocol, extra", [
    ("center", ["--stream-every", "4"]),
    ("broadcast", ["--chaos", "drop:1,flip:0.01,straggle:3@0.001", "--timeout-ms", "50"]),
    ("poe", ["--chaos", "drop:2,nan:3"]),
])
def test_main_serves_each_protocol_and_exits_cleanly(protocol, extra, capsys):
    res = serve_gp.main(TINY + CPU + ["--protocol", protocol, "--gram-backend", "pallas"]
                        + extra)
    out = capsys.readouterr().out
    assert f"contract={protocol}-serve:ok" in out and "cholesky_ops=0 eigh_ops=0" in out
    assert res["report"].ok and len(res["lat_ms"]) == 7
    assert np.isfinite(res["p50_ms"]) and res["p99_ms"] >= res["p50_ms"]
    if "--chaos" in extra:
        h = res["health"]
        assert h.status == "degraded" and out.count("health (degraded mask)") == 1
        lost = int(extra[1].split(",")[0].split(":")[1])
        assert lost in h.machines_lost
        assert res["art"].fit_lengths[lost] == 0
    if protocol == "broadcast":
        assert "timeout budget:" in out and res["art"].rows_demoted > 0
        assert h.variance_inflation == pytest.approx(4 / 3)
    if protocol == "center":
        assert res["n_updates"] == 2 and out.count("streamed 16 pts") == 2


def test_fleet_mode_serves_tenants_without_reallocating(capsys):
    res = serve_gp.main(TINY + CPU + ["--protocol", "broadcast", "--gram-backend", "pallas",
                                      "--fleet", "--fleet-tenants", "6", "--fleet-cache", "3",
                                      "--fleet-slots", "2"])
    out = capsys.readouterr().out
    assert "fleet: 6 tenants" in out and "stacks reallocated: 0" in out
    stats = res["stats"]
    assert res["reallocated"] == 0 and res["launches"] == {}
    assert stats["completed"] == 8 and stats["fused_dispatches"] == stats["flushes"] > 0
    assert stats["cache"]["misses"] >= 3


def test_mesh_raises_naming_its_slice():
    # --mesh is ported: the same call runs the center protocol on 4 spawned
    # ranks, with the batched run's ledgers and the center's contract
    res = serve_gp.main(TINY + CPU + ["--mesh"])
    art = serve_gp.main(TINY + CPU)["art"]
    assert res["impl"] == "mesh" and res["contract_ok"] and res["contract"] == "center-serve"
    assert res["op_counts"]["cholesky"] == res["op_counts"]["eigh"] == 0
    assert res["collectives"] == {} and len(res["lat_ms"]) == 7
    assert (res["wire_bits"], res["payload_bits"], res["integrity_bits"]) == (
        art.wire_bits, art.payload_bits, art.integrity_bits)


def test_mesh_broadcast_serves_with_one_collective_and_reloads(tmp_path):
    res = serve_gp.main(TINY + CPU + ["--mesh", "--protocol", "broadcast",
                                      "--artifact-dir", str(tmp_path), "--stream-every", "3"])
    assert res["contract_ok"] and res["contract"] == "mesh-serve"
    assert res["collectives"]["c10d.allreduce_"]["count"] == 1
    assert res["reload_dmu"] <= 1e-4 and res["n_updates"] == 2
    with pytest.raises(ValueError, match="--fleet"):
        serve_gp.main(TINY + CPU + ["--mesh", "--fleet"])


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        serve_gp.main(TINY)


def test_center_prints_the_references_ledgers(tmp_path, capsys):
    """The fit's printed ledgers equal the reference main's for the same
    flags, and both equal the reference's accounting formulas on the fit's
    lengths and rates; after a streamed batch the port's integer ledgers
    are those formulas on the grown lengths.  (The printed figures are
    rounded to 0.1 kbit; test_torch_deprecations holds the integer ledgers
    of a fit against the reference's fit.)"""
    res = serve_gp.main(REF_FLAGS + CPU + ["--queries", "4", "--stream-every", "3",
                                           "--stream-size", "4",
                                           "--artifact-dir", str(tmp_path)])
    out = capsys.readouterr().out
    art = res["art"]
    rates, fit_lengths, lengths = art.wire.rates.numpy(), art.fit_lengths, art.lengths
    fit_ledgers = (ref_acc.wire_bits_formula(rates, fit_lengths, 4, skip=0),
                   ref_acc.payload_bits_formula(fit_lengths, 4, 8, DEFAULT_MAX_BITS, skip=0),
                   ref_acc.integrity_bits_formula(fit_lengths, skip=0))
    printed = "wire {:.1f} kbit (packed payload {:.1f} kbit, crc {:.1f} kbit, 0 rows demoted)"
    assert _ledgers(out) == _ledgers(_reference_stdout()) == printed.format(
        *(v / 1e3 for v in fit_ledgers))
    assert "artifact: saved+reloaded" in out and "contract=center-serve:ok" in out
    assert out.count("streamed 4 pts -> machine 1") == 1
    assert sum(fit_lengths) == 96 and sum(lengths) == 96 + 4
    for formulas in (ref_acc, port_acc):
        assert art.wire_bits == formulas.wire_bits_formula(rates, lengths, 4, skip=0)
        assert art.payload_bits == formulas.payload_bits_formula(
            lengths, 4, 8, DEFAULT_MAX_BITS, skip=0)
        assert art.integrity_bits == formulas.integrity_bits_formula(lengths, skip=0)
    assert res["report"].ok and res["n_updates"] == 1 and res["growths"] == 1
    assert res["request_launches"] == [{}] * 3  # the plain versions launch nothing
