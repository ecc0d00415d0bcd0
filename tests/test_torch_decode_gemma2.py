"""repro_torch's decode step against the reference's for gemma2-2b (local
ring caches of window 32 at ``.reduced()``, alternating with global
caches, attention and final logit softcaps) and internvl2-2b (the vlm
family's decoder): the reference's weights carried over, the same tokens
teacher-forced through both for 44 steps — past position 40, so the local
rings wrap — in float32 and in bf16; tolerances and their reasons in
``tests/_torch_decode.py``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_thread  # noqa: E402,F401
from _torch_decode import check_arch  # noqa: E402


def test_gemma2_local_rings_wrap_and_match():
    held, state = check_arch("gemma2-2b", steps=44)
    assert held["float32"] > 0 and held["bfloat16"] > 0
    local, glob = state["pairs"]["local"]["kpos"], state["pairs"]["global"]["kpos"]
    assert local.shape[-1] == 32 and glob.shape[-1] == 44
    # the ring holds the last 32 positions, position p in slot p mod 32
    held_pos = np.sort(local.numpy(), axis=-1)
    np.testing.assert_array_equal(held_pos, np.broadcast_to(np.arange(12, 44), held_pos.shape))
    assert (local.numpy()[..., 43 % 32] == 43).all()
    np.testing.assert_array_equal(glob.numpy(), np.broadcast_to(np.arange(44), glob.shape))


def test_vlm_decode_matches_reference():
    held, _ = check_arch("internvl2-2b")
    assert held["float32"] > 0 and held["bfloat16"] > 0
