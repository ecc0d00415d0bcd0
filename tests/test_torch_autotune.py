"""The port's persistent autotune cache (``repro_torch.kernels.runtime``)
against the reference's contract (``tests/test_kernel_runtime.py``): one
sweep then warm hits, infeasible and failing candidates, a corrupt or stale
file, a stale winner off the menu, zero sweeps in a second process, the
file format shared with the reference's cache; the two menus at the paths'
shapes; and no sweep and no write while a stream is captured or a sync
debug mode is on."""
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_thread  # noqa: E402,F401

from repro.kernels import runtime as ref_runtime  # noqa: E402
from repro_torch.kernels import build, runtime  # noqa: E402
from repro_torch.kernels.epilogue import ops as epi_ops  # noqa: E402
from repro_torch.kernels.qgram import ops as qgram_ops  # noqa: E402


def _with_cache(monkeypatch, tmp_path):
    path = str(tmp_path / "autotune.json")
    monkeypatch.setenv("REPRO_TUNE_CACHE", path)
    runtime.clear_cache_memory()
    return path


# ---- the reference's four cache tests -------------------------------------


def test_autotune_sweeps_once_then_warm_hits(monkeypatch, tmp_path):
    path = _with_cache(monkeypatch, tmp_path)
    key = runtime.cache_key("op", [(8, 8)], "float32", bits=4)
    seen = []
    measure = lambda c: (seen.append(c), float(c[0]))[1]
    before = runtime.sweep_count()
    win = runtime.autotune(key, [(2, 2), (1, 1)], measure, (2, 2))
    assert win == (1, 1) and runtime.sweep_count() == before + 1
    assert seen == [(2, 2), (1, 1)]
    # warm hit: straight from the file, zero sweeps, measure never called
    runtime.clear_cache_memory()
    win2 = runtime.autotune(key, [(2, 2), (1, 1)], lambda c: 1 / 0, (2, 2))
    assert win2 == (1, 1) and runtime.sweep_count() == before + 1
    blob = json.load(open(path))
    assert blob["version"] == runtime.CACHE_VERSION
    assert blob["entries"][key] == [1, 1]


def test_autotune_infeasible_and_failing_candidates(monkeypatch, tmp_path):
    _with_cache(monkeypatch, tmp_path)
    key = runtime.cache_key("op2", [(4,)], "int8")

    def measure(c):
        if c == (1,):
            return None  # infeasible for this shape
        if c == (2,):
            raise RuntimeError("launch refused")
        return 5.0

    assert runtime.autotune(key, [(1,), (2,), (3,)], measure, (1,)) == (3,)
    # every candidate fails: the default, as the caller's plan
    key2 = runtime.cache_key("op2", [(5,)], "int8")
    assert runtime.autotune(key2, [(1,), (2,)], measure, (1,)) == (1,)


def test_corrupt_or_stale_cache_falls_back(monkeypatch, tmp_path):
    path = _with_cache(monkeypatch, tmp_path)
    key = runtime.cache_key("op3", [(2, 2)], "float32")
    for garbage in ("{not json", json.dumps({"version": 99, "entries": {key: [9]}}),
                    json.dumps([1, 2, 3])):
        with open(path, "w") as f:
            f.write(garbage)
        runtime.clear_cache_memory()
        before = runtime.sweep_count()
        win = runtime.autotune(key, [(7,)], lambda c: 1.0, (7,))
        assert win == (7,) and runtime.sweep_count() == before + 1
        runtime.clear_cache_memory()  # the sweep rewrote a valid file
        assert json.load(open(path))["entries"][key] == [7]


def test_stale_winner_not_in_candidates_resweeps(monkeypatch, tmp_path):
    path = _with_cache(monkeypatch, tmp_path)
    key = runtime.cache_key("op4", [(2,)], "float32")
    with open(path, "w") as f:
        json.dump({"version": runtime.CACHE_VERSION, "entries": {key: [999, 999]}}, f)
    runtime.clear_cache_memory()
    before = runtime.sweep_count()
    win = runtime.autotune(key, [(4, 4)], lambda c: 1.0, (4, 4))
    assert win == (4, 4) and runtime.sweep_count() == before + 1


def test_unwritable_cache_stays_in_memory(monkeypatch, tmp_path):
    blocker = tmp_path / "not_a_dir"
    blocker.write_text("")
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(blocker / "autotune.json"))
    runtime.clear_cache_memory()
    key = runtime.cache_key("op5", [(3,)], "float32")
    before = runtime.sweep_count()
    assert runtime.autotune(key, [("a",), ("b",)], lambda c: {"a": 2.0, "b": 1.0}[c[0]],
                            ("a",)) == ("b",)
    assert runtime.autotune(key, [("a",), ("b",)], lambda c: 1 / 0, ("a",)) == ("b",)
    assert runtime.sweep_count() == before + 1


def test_unknown_menu_names_the_known_ones():
    assert runtime.tune_candidates("qgram_packed") == (("small",), ("flat",), ("wide",),
                                                       ("long",))
    assert runtime.tune_candidates("epilogue_fleet") == (
        ("small", 16), ("small", 32), ("mma", 128), ("mma", 32), ("mma", 16))
    with pytest.raises(KeyError, match="epilogue_fleet.*qgram_packed"):
        runtime.tune_candidates("qgram")


# ---- across processes -------------------------------------------------------

_CHILD = r"""
import sys
sys.path.insert(0, {src!r})
from repro_torch.kernels import runtime
key = runtime.cache_key("qgram_packed", [(39, 25, 1), (39, 21, 4096), (39, 25, 21)],
                        "int32", bits=24, extra=("mask",))
times = {{"small": 3.0, "flat": 1.0, "wide": 2.0}}
win = runtime.autotune(key, [("small",), ("flat",), ("wide",)], lambda c: times[c[0]],
                       ("small",))
print("WIN", win[0], "SWEEPS", runtime.sweep_count())
"""


def test_cache_persists_across_processes(tmp_path):
    """A second process serving the same key runs ZERO sweeps."""
    env = dict(os.environ, REPRO_TUNE_CACHE=str(tmp_path / "autotune.json"))
    src = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
    script = _CHILD.format(src=src)

    def run():
        r = subprocess.run([sys.executable, "-c", script], env=env, capture_output=True,
                           text=True, timeout=300)
        assert r.returncode == 0, r.stderr
        _, win, _, sweeps = r.stdout.split()
        return win, int(sweeps)

    assert run() == ("flat", 1)  # cold: one sweep, the winner stored
    assert run() == ("flat", 0)  # warm: the second process sweeps none


# ---- one file format with the reference's ------------------------------------


def test_file_shared_with_the_reference_keeps_both_entries(monkeypatch, tmp_path):
    path = _with_cache(monkeypatch, tmp_path)
    ref_runtime.clear_cache_memory()
    ref_key = ref_runtime.cache_key("qgram_packed", [(40, 1), (10, 256), (22, 10)],
                                    "uint32", bits=30, extra=("echunk=128",))
    ref_runtime._store_cache(ref_key, (256, 128))
    port_key = runtime.cache_key("epilogue_fleet", [(4, 40, 128, 50)], torch.float32,
                                 extra=("fuse=kl",))
    assert port_key != ref_key
    assert runtime.autotune(port_key, [("mma", 32), ("mma", 16)],
                            lambda c: c[1] / 32, ("mma", 32)) == ("mma", 16)
    entries = json.load(open(path))["entries"]
    assert entries == {ref_key: [256, 128], port_key: ["mma", 16]}
    # the reference writes again and keeps the port's entry
    ref_runtime.clear_cache_memory()
    ref_key2 = ref_runtime.cache_key("epilogue_fleet", [(4, 40, 128, 50)], "float32",
                                     extra=("fuse=kl",))
    ref_runtime._store_cache(ref_key2, (128,))
    entries = json.load(open(path))["entries"]
    assert entries[port_key] == ["mma", 16] and entries[ref_key] == [256, 128]
    assert entries[ref_key2] == [128]
    runtime.clear_cache_memory()
    assert runtime.autotune(port_key, [("mma", 32), ("mma", 16)], lambda c: 1 / 0,
                            ("mma", 32)) == ("mma", 16)
    ref_runtime.clear_cache_memory()


def test_cache_key_is_stable_and_names_the_card_and_library(monkeypatch):
    shapes = [(39, 25, 1), (39, 21, 4096), (39, 25, 21)]
    key = runtime.cache_key("qgram_packed", shapes, torch.int32, bits=24, extra=("mask",))
    assert key == runtime.cache_key("qgram_packed", shapes, torch.int32, bits=24,
                                    extra=("mask",))
    assert key == "qgram_packed|cpu:torch|39-25-1x39-21-4096x39-25-21|int32|bits=24|mask"
    monkeypatch.setattr(runtime, "_BACKENDS", {})
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda dev=None: "NVIDIA H100 80GB HBM3")
    cuda = torch.device("cuda", 0)
    keys = {op: runtime.cache_key(op, shapes, torch.int32, bits=24, device=cuda)
            for op in ("qgram_packed", "epilogue_fleet")}
    for op, k in keys.items():
        assert k.split("|")[1] == f"cuda:NVIDIA H100 80GB HBM3:{build.digest(op)}"
        assert build._target(op).name == f"lib{op}-{build.digest(op)}.so"
    assert keys["qgram_packed"].split("|")[1] != keys["epilogue_fleet"].split("|")[1]


# ---- the menus at the paths' shapes ---------------------------------------------

# (m, n, p, d, W, C): Fig. 6 center fit, broadcast fit, 40 x 1000 x 4449 (R = 24,
# max_bits 12), and a d past one chunk with staged tables
QGRAM_SHAPES = {
    (39, 25, 25, 21, 1, 4096): ["small", "flat", "wide"],
    (40, 25, 1000, 21, 1, 4096): ["small", "flat", "wide"],
    (40, 1000, 4449, 21, 1, 4096): ["small", "flat", "wide"],
    (2, 1024, 1025, 40, 4, 256): ["small", "flat", "wide", "long"],
}


def _qgram_feasible(m, n, p, d, W, C):
    out = []
    for (v,) in runtime.tune_candidates("qgram_packed"):
        try:
            qgram_ops.plan(m, n, p, d, W, C, variant=v)
        except ValueError:
            continue
        out.append(v)
    return out


@pytest.mark.parametrize("shape", list(QGRAM_SHAPES))
def test_qgram_packed_menu_at_the_path_shapes(shape):
    feasible = _qgram_feasible(*shape)
    assert feasible == QGRAM_SHAPES[shape]
    pure = qgram_ops.plan(*shape)
    assert pure.variant in feasible
    assert qgram_ops.plan(*shape, variant=pure.variant) == pure
    for v in feasible:  # a forced tile keeps plan's walk rule: every group non-empty
        pl = qgram_ops.plan(*shape, variant=v)
        tiles_c = -(-shape[2] // qgram_ops.TILES[v][1])
        assert pl.groups == -(-tiles_c // pl.walk) and (pl.groups - 1) * pl.walk < tiles_c


def test_qgram_packed_forced_tiles_that_do_not_fit_raise():
    with pytest.raises(ValueError, match="no 'long' tile at d = 21"):
        qgram_ops.plan(39, 25, 25, 21, 1, 4096, variant="long")
    with pytest.raises(ValueError, match="shared memory"):
        qgram_ops.plan(1, 10, 10, 2000, 2000, 4096, variant="small")


# (T, m, t, K): serve_gp's flush, the smoke's flush, serve-sized requests,
# past the 32-point tile's shared memory
EPI_SHAPES = {
    (4, 40, 128, 50): [("mma", 32), ("mma", 16)],
    (16, 40, 16, 25): [("small", 16), ("small", 32), ("mma", 128)],
    (8, 40, 128, 25): [("small", 16), ("small", 32), ("mma", 128)],
    (2, 20, 20, 1345): [("mma", 16)],
}


@pytest.mark.parametrize("shape", list(EPI_SHAPES))
def test_epilogue_fleet_menu_at_the_path_shapes(shape):
    feasible = []
    for tile in runtime.tune_candidates("epilogue_fleet"):
        try:
            pl = epi_ops.plan_fleet(*shape, tile=tile)
        except ValueError:
            continue
        feasible.append(tile)
        # groups follow from the tile by plan_fleet's rule
        T, m, t, K = shape
        tiles = T * -(-t // tile[1])
        groups = min(m, max(1, -(-8 * 132 // tiles)))
        assert pl.groups == -(-m // -(-m // groups))
    assert feasible == EPI_SHAPES[shape]
    pure = epi_ops.plan_fleet(*shape)
    assert (pure.variant, pure.tt) in feasible
    assert epi_ops.plan_fleet(*shape, tile=(pure.variant, pure.tt)) == pure


def test_fleet_epilogue_plan_off_the_card_is_the_pure_plan(monkeypatch, tmp_path):
    path = _with_cache(monkeypatch, tmp_path)
    before = runtime.sweep_count()
    for shape in EPI_SHAPES:
        pure = epi_ops.plan_fleet(*shape)
        assert epi_ops.fleet_epilogue_plan(*shape) == pure
        assert epi_ops.fleet_epilogue_plan(*shape, fuse="rbcm", device="cpu") == pure
        assert epi_ops.fleet_epilogue_block(*shape, device=torch.device("cpu")) == pure.tt
    assert runtime.sweep_count() == before and not os.path.exists(path)


# ---- no sweep while capturing or under a sync debug mode --------------------------


def test_may_sweep_on_the_cpu():
    assert runtime.may_sweep()  # no CUDA context: nothing to guard


@pytest.mark.parametrize("guard", ["_capturing", "_sync_checked"])
def test_a_guarded_miss_neither_sweeps_nor_writes(monkeypatch, tmp_path, guard):
    path = _with_cache(monkeypatch, tmp_path)
    monkeypatch.setattr(runtime, guard, lambda: True)
    assert not runtime.may_sweep()
    key = runtime.cache_key("qgram_packed", [(40, 25, 1)], torch.int32, bits=24)
    called = []
    before = runtime.sweep_count()
    win = runtime.autotune(key, [("small",), ("flat",)], lambda c: called.append(c) or 1.0,
                           ("flat",))
    assert win == ("flat",) and called == []
    assert runtime.sweep_count() == before and not os.path.exists(path)
    # a cached winner is used all the same
    with open(path, "w") as f:
        json.dump({"version": runtime.CACHE_VERSION, "entries": {key: ["small"]}}, f)
    runtime.clear_cache_memory()
    assert runtime.autotune(key, [("small",), ("flat",)], lambda c: 1 / 0, ("flat",)) == (
        "small",)
    assert runtime.sweep_count() == before
    # the guard lifted: the miss of another key sweeps
    monkeypatch.setattr(runtime, guard, lambda: False)
    key2 = runtime.cache_key("qgram_packed", [(40, 26, 1)], torch.int32, bits=24)
    assert runtime.autotune(key2, [("small",), ("flat",)],
                            lambda c: 2.0 if c == ("small",) else 1.0, ("small",)) == ("flat",)
    assert runtime.sweep_count() == before + 1


def test_fleet_stack_plans_only_on_the_card():
    """Off the card a stack resolves no plan: the plain version has no tile."""
    from repro_torch.core import fleet

    class Stack:
        _proj = torch.zeros(1)
        tree = type("T", (), {"device": torch.device("cpu")})()
        _plans: dict = {}

    assert fleet.FleetStack._epilogue_plan(Stack(), 16) is None
    assert Stack._plans == {}
