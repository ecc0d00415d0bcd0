"""repro_torch's decode step against the reference's for the recurrent
families: xlstm-125m (mLSTM / sLSTM pairs, no attention) and zamba2-2.7b
(mamba2 super-blocks with one weight-shared attention block) at
``.reduced()``: the reference's weights carried over, the same tokens
teacher-forced through both for 44 steps, in float32 and in bf16 —
tolerances, and why zamba2's bf16 numbers are not held, in
``tests/_torch_decode.py``."""
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_thread  # noqa: E402,F401
from _torch_decode import check_arch  # noqa: E402


def test_xlstm_decode_matches_reference():
    held, _ = check_arch("xlstm-125m")
    assert held["float32"] > 0 and held["bfloat16"] > 0


def test_zamba2_decode_matches_reference():
    held, state = check_arch("zamba2-2.7b")
    assert held["float32"] > 0
    assert all(bool(torch.isfinite(t.float()).all())
               for t in state["blocks"]["mamba_layers"].values())
