"""Architecture zoo of the port — counterpart of ``repro.models``, its
decode-serving part: configs, parameter trees, the per-family decode step
with every attention layer through the ``decode_attn`` kernel, and the
reference's trees carried across (``weights``)."""
from .config import ModelConfig, ShapeConfig, SHAPES, TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K
from .backbone import COMPUTE_DTYPE, cast_compute, init_model, param_count
from .decode import attn_launches_per_step, decode_step, init_decode_state
from .steps import make_decode_step
from .weights import params_from_numpy, state_from_numpy, state_to_numpy
