"""Architecture zoo of the port — counterpart of ``repro.models``: configs,
parameter trees, the training / prefill ``forward`` and its steps (loss,
AdamW train step, prefill), the per-family decode step with every
attention layer through the ``decode_attn`` kernel, the reference's
trees carried across (``weights``), and the logical-axis sharding
(``sharding``: the rule tables, parameter and decode-state specs as
DTensor placements, the hooks the model calls, no-ops without rules)."""
from .config import ModelConfig, ShapeConfig, SHAPES, TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K
from .backbone import COMPUTE_DTYPE, cast_compute, forward, init_model, param_count
from .decode import attn_launches_per_step, decode_state_specs, decode_step, init_decode_state
from .steps import (init_train_state, loss_fn, make_decode_step, make_prefill_step,
                    make_train_step)
from .weights import params_from_numpy, state_from_numpy, state_to_numpy
