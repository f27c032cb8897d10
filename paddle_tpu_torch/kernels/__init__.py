"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version (the ``*_reference`` functions, which CPU tensors run). Export
names follow paddle_tpu.kernels for what exists."""
from ._build import launch_counts, reset_launch_counts  # noqa: F401
from .decode_attention import (paged_decode_attention,  # noqa: F401
                               paged_decode_attention_reference)
from .decode_megakernel import (  # noqa: F401
    decode_layer_megakernel, decode_layer_megakernel_full,
    decode_layers_megakernel)
from .flash_attention import (flash_attention,  # noqa: F401
                              flash_attention_fwd,
                              flash_attention_reference)
from .prefix_prefill import (prefix_prefill_attention,  # noqa: F401
                             prefix_prefill_reference)
from .ragged_attention import (ragged_paged_attention,  # noqa: F401
                               ragged_paged_attention_reference)
from .rms_norm import rms_norm, rms_norm_reference  # noqa: F401
from .rms_norm import rms_norm as fused_rms_norm  # noqa: F401
from .rope import apply_rotary_emb, rope_freqs  # noqa: F401
