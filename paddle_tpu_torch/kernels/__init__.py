"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version (the ``*_reference`` functions, which CPU tensors run). Export
names follow paddle_tpu.kernels for what exists."""
from ._build import launch_counts, reset_launch_counts  # noqa: F401
from .decode_attention import (paged_decode_attention,  # noqa: F401
                               paged_decode_attention_reference)
from .flash_attention import (flash_attention,  # noqa: F401
                              flash_attention_fwd,
                              flash_attention_reference)
from .rms_norm import rms_norm, rms_norm_reference  # noqa: F401
from .rms_norm import rms_norm as fused_rms_norm  # noqa: F401
from .rope import apply_rotary_emb, rope_freqs  # noqa: F401
