"""repro_torch's decode step against the reference's for the MoE
architectures (arctic-480b with its dense residual MLP, qwen2-moe-a2.7b
with its shared expert) at ``.reduced()``: the reference's weights carried
over, the same tokens teacher-forced through both for 44 steps, in float32
and in bf16 — tolerances, and the router near-ties that may flip a top-k
choice in bf16, in ``tests/_torch_decode.py``."""
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_thread  # noqa: E402,F401
from _torch_decode import check_arch  # noqa: E402


@pytest.mark.parametrize("arch", ["arctic-480b", "qwen2-moe-a2.7b"])
def test_decode_matches_reference(arch):
    held, _ = check_arch(arch)
    assert held["float32"] > 0 and held["bfloat16"] > 0
