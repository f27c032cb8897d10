"""Model zoo of the port: the Llama serving path."""
from .llama import (  # noqa: F401
    LlamaConfig, LlamaForCausalLM, LlamaModel, PagedKVManager,
    hash_prefix_blocks, init_serving_params, params_from_jax,
    resolve_decode_megakernel, resolve_kv_cache_dtype,
)
