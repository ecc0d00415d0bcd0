"""repro_torch's decode step against the reference's for whisper-medium
(decoder self caches, cross attention over the zero-initialised cross K/V,
both through ``decode_attn``) at ``.reduced()``, teacher-forced for 44
steps in float32 and in bf16 (tolerances in ``tests/_torch_decode.py``);
and the port's ``init_model`` on the meta device at full width against
``jax.eval_shape`` of the reference's for all ten architectures: the same
tree, shapes, dtypes and parameter count."""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_thread  # noqa: E402,F401
from _torch_decode import check_arch  # noqa: E402
from repro_torch.analysis.lockstep import flat  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.models import init_model as ref_init_model  # noqa: E402
from repro_torch.configs import get_config, list_archs  # noqa: E402
from repro_torch.models import init_model, param_count  # noqa: E402

# full-width parameter counts (the reference's eval_shape, summed)
PARAMS = {"gemma-7b": 8537680896, "whisper-medium": 758926336, "internvl2-2b": 1703792640,
          "mistral-large-123b": 122610069504, "arctic-480b": 476850275328,
          "stablelm-12b": 12142924800, "gemma2-2b": 2614222080, "xlstm-125m": 77608704,
          "qwen2-moe-a2.7b": 14004422656, "zamba2-2.7b": 2333821824}


def test_whisper_decode_matches_reference():
    held, state = check_arch("whisper-medium")
    assert held["float32"] > 0 and held["bfloat16"] > 0
    assert not bool(state["cross_kpos"].any())


@pytest.mark.parametrize("arch", sorted(PARAMS))
def test_meta_init_matches_reference_shapes(arch):
    ref = flat(jax.eval_shape(lambda: ref_init_model(jax.random.PRNGKey(0),
                                                     ref_get_config(arch))))
    params = init_model(get_config(arch), device="meta")
    port = flat(params)
    assert set(port) == set(ref), set(port) ^ set(ref)
    for k, r in ref.items():
        assert tuple(port[k].shape) == r.shape, (k, port[k].shape, r.shape)
        assert str(port[k].dtype).removeprefix("torch.") == str(r.dtype), k
        assert port[k].device.type == "meta"
    n = param_count(params)
    assert n == sum(int(np.prod(r.shape)) for r in ref.values()) == PARAMS[arch]
    assert arch in list_archs()
