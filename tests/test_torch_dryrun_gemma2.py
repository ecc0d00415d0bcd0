"""The dry run's per-device matmul FLOPs for reduced gemma2-2b (local /
global pairs, softcaps) against the reference's ``analyze_hlo`` on a 2 x 4
("data", "model") mesh — the tolerance, the readings and the one stated
gap in ``tests/_torch_dryrun.py`` (the other mesh:
``test_torch_dryrun_gemma2_4x2.py``)."""
import pytest

pytest.importorskip("torch")
from _torch_threads import one_thread  # noqa: E402,F401
from _torch_dryrun import check  # noqa: E402


def test_per_device_flops_match_the_reference():
    ref, port, excess = check('gemma2-2b', (2, 4))
    assert excess > 0.0
