"""The port's Fig. 5-6 script (``python -m repro_torch.launch.fig56_regression``)
against the reference's models on the same data and the same machines.

Reduced setting: SARCOS-shaped data (the port's generator, handed to both
packages), 200 training points over 5 machines from the script's seeded
numpy split, 20 Adam steps, 200 test points, R in {4, 16}, the linear
(Fig. 5) and SE (Fig. 6) kernels.  The reference's models are the calls its
own script makes (``train_gp(...).predict``, ``poe_baseline``,
``single_center_gp``, ``broadcast_gp``), plus center ``nystrom_fitc`` and
broadcast ``direct``, on the same ``parts``.

Tolerance: each model's SMSE within 1e-4 absolute of the reference's, and
BCM's within 1e-3.  The gaps measured at this setting on the CPU: 6.0e-6
or less for the full GP and every quantized model, 3.6e-5 for rBCM under
SE and 4.7e-4 for BCM under SE (1.2e-7 for both under the linear kernel).
SMSE is a mean of squared residuals over var(y), so a relative prediction
error e moves it by about 2 e.  Where BCM's and rBCM's gaps come from is
measured in ``tests/test_torch_poe_experts.py``: at the same
hyperparameters their experts and fused answers agree with the
reference's to 7.6e-7; the two packages' float32 training of the shared
hyperparameters on machine 0 ends 2.25e-3 apart in log l^2 (a gradient of
-4.1e-4 that rounding moves by 3.6 % in the port and 17 % in the
reference), which moves the experts' means by 2.7e-3; BCM's fused
precision subtracts (m - 1) prior precisions (1.53) from the experts'
(2.10), so its weights on the experts' means sum to 3.7 and its fused mean
moves by 3.9e-3, while rBCM's entropy weights damp it to 3.1e-4.
Both limits keep a margin of two or more over the largest gap they cover
and stay far below the gaps between models the figure reads (0.01 and
more).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_thread  # noqa: E402,F401

from repro.core import broadcast_gp, poe_baseline, single_center_gp  # noqa: E402
from repro.core import train_gp as ref_train_gp  # noqa: E402
from repro_torch.data.synthetic import regression_dataset  # noqa: E402
from repro_torch.launch import fig56_regression as fig56  # noqa: E402

RATES, M, STEPS, N_TRAIN, N_TEST = (4, 16), 5, 20, 200, 200
TOL = 1e-4
TOL_BCM = 1e-3


def _reference(kernel):
    X, y, Xt, yt = regression_dataset("sarcos")
    X, y, Xt, yt = X[:N_TRAIN], y[:N_TRAIN], Xt[:N_TEST], yt[:N_TEST]
    parts = fig56.machine_parts(X, y, M)
    pooled = [np.concatenate([p[i] for p in parts]) for i in (0, 1)]  # the machines' order
    full = ref_train_gp(*pooled, kernel=kernel, steps=STEPS)
    out = {("full", 0): fig56.smse(yt, full.predict(Xt)[0])}
    for method in ("bcm", "rbcm"):
        mu, _, _ = poe_baseline(parts, Xt, kernel=kernel, method=method, steps=STEPS)
        out[method, 0] = fig56.smse(yt, mu)
    for R in RATES:
        for mode in ("nystrom", "direct", "nystrom_fitc"):
            art = single_center_gp(parts, R, kernel=kernel, steps=STEPS, gram_mode=mode)
            out[f"center_{mode}", R] = fig56.smse(yt, art.predict(Xt)[0])
        for mode in ("nystrom", "direct"):
            mu, _, _, _ = broadcast_gp(parts, R, Xt, kernel=kernel, steps=STEPS,
                                       gram_mode=mode)
            out[f"broadcast_{mode}", R] = fig56.smse(yt, mu)
    return out


@pytest.mark.parametrize("kernel", ["linear", "se"])
def test_port_script_smse_matches_the_reference_models(kernel):
    rows = []
    got = fig56.run_dataset("sarcos", kernel, RATES, M, STEPS, N_TEST, N_TRAIN,
                            device="cpu", emit=rows.append)
    want = _reference(kernel)
    assert set(got) == set(want)
    assert len(rows) == len(got) and all(r.startswith(f"fig56_sarcos_{kernel},") for r in rows)
    for key in want:
        assert np.isfinite(got[key]), key
        tol = TOL_BCM if key[0] == "bcm" else TOL
        assert abs(got[key] - want[key]) <= tol, (key, got[key], want[key])


def test_machine_parts_is_a_seeded_partition():
    X, y, _, _ = regression_dataset("abalone")
    parts = fig56.machine_parts(X[:50], y[:50], 4, seed=3)
    again = fig56.machine_parts(X[:50], y[:50], 4, seed=3)
    assert [len(p[0]) for p in parts] == [13, 13, 12, 12]
    for (a, b), (c, e) in zip(parts, again):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, e)
    rows = np.concatenate([p[0] for p in parts])
    assert sorted(map(tuple, rows)) == sorted(map(tuple, X[:50]))


def test_cli_runs_the_quick_models_on_the_cpu(monkeypatch):
    calls = []
    monkeypatch.setattr(fig56, "run_dataset", lambda *a, **k: calls.append((a, k)) or {})
    fig56.main(["--device", "cpu", "--gram-mode", "direct"])
    assert [(a[0], a[1]) for a, _ in calls] == [
        ("sarcos", "linear"), ("abalone", "linear"),
        ("sarcos", "se"), ("kin40k", "se"), ("abalone", "se")]
    a = calls[0][0]
    assert a[2:8] == ([4, 16, 48], 10, 60, 200, 500, (
        "full", "bcm", "rbcm", "center_nystrom", "center_direct", "broadcast_direct"))
    assert a[8:10] == ("pallas", "cpu")
