# The decoder-only LM of the serving path, dense, moe and hybrid (params,
# layers, attention through K6, the MoE block, Mamba2, CausalLM) and
# build_model.
from .params import P, init_params, params_from_reference  # noqa: F401
from .transformer import CausalLM  # noqa: F401
from .zoo import build_model  # noqa: F401
