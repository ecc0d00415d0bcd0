"""repro_torch's decode step against the reference's for the dense
architectures without a sliding window (gemma-7b, stablelm-12b,
mistral-large-123b) at ``.reduced()``: the reference's weights carried
over, the same tokens teacher-forced through both for 44 steps, in float32
and in bf16 — tolerances and their reasons in ``tests/_torch_decode.py``."""
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_thread  # noqa: E402,F401
from _torch_decode import check_arch  # noqa: E402


@pytest.mark.parametrize("arch", ["gemma-7b", "stablelm-12b", "mistral-large-123b"])
def test_decode_matches_reference(arch):
    held, _ = check_arch(arch)
    assert held["float32"] > 0 and held["bfloat16"] > 0
