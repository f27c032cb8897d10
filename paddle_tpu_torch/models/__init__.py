"""Model zoo of the port: Llama serving and training (over a pp mesh:
`llama_pipe`), and the streaming checkpoint loader."""
from .llama import (  # noqa: F401
    LlamaConfig, LlamaForCausalLM, LlamaModel, LlamaPretrainingCriterion,
    PagedKVManager, build_paged_generate, build_quant_generate,
    decode_params, gather_params, hash_prefix_blocks,
    init_quant_serving_params, init_serving_params, init_train_params,
    make_paged_kv_q8_helpers, params_from_jax, plan_megakernel_rung,
    llama_sharding_rules, quantize_kv_pages, resolve_decode_megakernel,
    resolve_kv_cache_dtype, shard_llama, stack_decode_layer_params,
)
from .checkpoint import load_quant_serving_params  # noqa: F401
from . import llama_pipe  # noqa: F401
from .llama_pipe import make_llama_pp_train_step  # noqa: F401
