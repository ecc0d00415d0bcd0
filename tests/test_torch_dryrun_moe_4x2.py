"""The dry run's per-device matmul FLOPs for reduced qwen2-moe-a2.7b (the
expert-parallel dispatch under ``local_map``, the shared expert) against
the reference's ``analyze_hlo`` on a 4 x 2 ("data", "model") mesh — the
tolerance, the readings and the one stated gap in
``tests/_torch_dryrun.py`` (the other mesh: ``test_torch_dryrun_moe.py``)."""
import pytest

pytest.importorskip("torch")
from _torch_threads import one_thread  # noqa: E402,F401
from _torch_dryrun import check  # noqa: E402


def test_per_device_flops_match_the_reference():
    ref, port, excess = check('qwen2-moe-a2.7b', (4, 2))
    assert excess == 0.0  # 2 KV heads split over a 2-wide model axis
