# The decoder-only LM of the serving and training paths, dense, moe and
# hybrid (params, layers, attention through K6, the MoE block, Mamba2,
# CausalLM) and build_model.
from .params import (P, init_params, num_params,  # noqa: F401
                     opt_state_from_reference, params_from_reference)
from .transformer import CausalLM  # noqa: F401
from .zoo import build_model  # noqa: F401
