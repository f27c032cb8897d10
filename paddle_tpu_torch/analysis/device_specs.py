"""The hardware table the static passes price against (counterpart of
paddle_tpu/analysis/device_specs.py): peak FLOP/s per dtype, HBM bytes/s,
interconnect bytes/s and the fixed cost of one kernel launch.

The port has two rows. ``h100-sxm`` is the NVIDIA H100 SXM5 80GB at 700
W, from the published figures: dense bf16 / f16 989e12 FLOP/s, int8
1979e12, f32 67e12 (the CUDA-core rate: the port never enables TF32, so
an f32 product runs there), HBM3 3.35e12 B/s, NVLink 900e9 B/s, 80 GiB.
Its ``launch_overhead_s`` is measured on the card (``chip_smoke.py``
phase 25, ``PERF.md``): a kernel launch replayed from a CUDA graph, the
way the engine and the training step's programs run. Its
``kernel_shares`` are measured there too: the share of its bound each
hand-written kernel reaches at the main path's shape (``chip_smoke.py``
phase 1, bound_ms / ms), which the roofline divides a kernel node's time
by, so a kernel that runs at a third of its bound is priced so. The
``cpu-container`` row prices the CPU host, and is used only when asked
for by name. The TPU rows of the JAX package are not here: its figures
are not the port's.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

__all__ = [
    "DEFAULT_DEVICE", "DEFAULT_HBM_HEADROOM", "DEVICE_SPECS", "DeviceSpec",
    "auto_hbm_budget", "get_spec", "spec_for_device_kind",
]

# the card every bound of the port is taken against
DEFAULT_DEVICE = "h100-sxm"


@dataclasses.dataclass(frozen=True)
class DeviceSpec:
    """One device row. `peak_flops` maps a dtype name to dense FLOP/s;
    dtypes without a row resolve through `peak_for` (f16 takes the bf16
    entry, int4 / fp8 the int8 one, anything else the f32 one).
    Bandwidths are bytes/s. `kernel_shares` maps a kernel's launch
    counter (``kernels._build.LAUNCHES``) to the share of its roofline
    bound it reaches on this device (`share_for`: an int8-pool counter
    without a row takes its bf16 twin's, anything else 1.0)."""

    name: str
    peak_flops: Dict[str, float]
    hbm_gbs: float            # HBM bytes/s
    ici_gbs: float            # interconnect bytes/s (NVLink on the card)
    launch_overhead_s: float  # fixed device cost of one kernel launch
    hbm_bytes: int            # capacity
    kinds: tuple = ()         # torch.cuda.get_device_name() strings
    kernel_shares: Dict[str, float] = dataclasses.field(
        default_factory=dict)

    def share_for(self, counter: Optional[str]) -> float:
        """The share of its bound the kernel behind `counter` reaches
        here; 1.0 for anything that is not a hand-written kernel."""
        if not counter:
            return 1.0
        if counter in self.kernel_shares:
            return self.kernel_shares[counter]
        return self.kernel_shares.get(counter.removesuffix("_int8"), 1.0)

    def peak_for(self, dtype) -> float:
        d = str(dtype).replace("torch.", "")
        if d in self.peak_flops:
            return self.peak_flops[d]
        if d in ("float16", "bfloat16"):
            return self.peak_flops.get("bfloat16",
                                       max(self.peak_flops.values()))
        if d in ("int8", "uint8", "int4", "uint4", "float8_e4m3fn",
                 "float8_e5m2"):
            return self.peak_flops.get("int8", self.peak_flops.get(
                "bfloat16", max(self.peak_flops.values())))
        return self.peak_flops.get("float32",
                                   min(self.peak_flops.values()))

    def ridge_point(self, dtype) -> float:
        """FLOPs per byte where compute time equals HBM time."""
        return self.peak_for(dtype) / self.hbm_gbs

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "peak_flops": dict(self.peak_flops),
            "hbm_gbs": self.hbm_gbs,
            "ici_gbs": self.ici_gbs,
            "launch_overhead_s": self.launch_overhead_s,
            "hbm_bytes": self.hbm_bytes,
        }


DEVICE_SPECS: Dict[str, DeviceSpec] = {
    "h100-sxm": DeviceSpec(
        name="h100-sxm",
        peak_flops={"bfloat16": 989e12, "float16": 989e12,
                    "int8": 1979e12, "float32": 67e12},
        hbm_gbs=3.35e12, ici_gbs=900e9,
        # a launch replayed from a CUDA graph (rms_norm [1, 128] bf16,
        # 2000 launches), chip_smoke.py phase 25 on an H100 80GB HBM3 at
        # 700 W; an eager launch took 30.4 us there (PERF.md)
        launch_overhead_s=1.934e-6,
        hbm_bytes=80 << 30,
        kinds=("NVIDIA H100 80GB HBM3",),
        # bound_ms / ms of each kernel's first phase-1 case (the main
        # path's shape; the megakernels at their main configuration:
        # int8 weights for scan / full, bf16 for attn), chip_smoke.py on
        # an H100 80GB HBM3 at 700 W (PERF.md section 6)
        kernel_shares={
            "rms_norm": 0.7145,
            "flash_attention_fwd": 0.1599,
            "flash_attention_bwd_dq": 0.0714,
            "flash_attention_bwd_dkv": 0.1858,
            "flash_attention_bwd_delta": 0.5217,
            "swiglu_fwd": 0.7425,
            "swiglu_bwd": 0.5734,
            "paged_decode_attention": 0.1247,
            "paged_decode_attention_int8": 0.0872,
            "prefix_prefill_attention": 0.1032,
            "prefix_prefill_attention_int8": 0.0845,
            "ragged_paged_attention": 0.0855,
            "ragged_paged_attention_int8": 0.0641,
            "gqa_decode_attention": 0.1944,
            "decode_attention": 0.3192,
            "int4_matmul": 0.4931,
            "int8_weight_matmul": 0.7015,
            "decode_layer_megakernel": 0.2422,
            "decode_layer_megakernel_int8": 0.1972,
            "decode_layer_megakernel_full": 0.3279,
            "decode_layer_megakernel_full_int8": 0.3082,
            "decode_layers_megakernel": 0.3329,
            "decode_layers_megakernel_int8": 0.3111,
        }),
    # the CPU host: selected only by name
    "cpu-container": DeviceSpec(
        name="cpu-container",
        peak_flops={"bfloat16": 0.2e12, "int8": 0.2e12,
                    "float32": 0.4e12},
        hbm_gbs=20e9, ici_gbs=10e9, launch_overhead_s=5e-6,
        hbm_bytes=16 << 30),
}


def spec_for_device_kind(kind: str) -> DeviceSpec:
    """The row of a ``torch.cuda.get_device_name()`` string ("NVIDIA H100
    80GB HBM3"); KeyError for a card with no row."""
    for row in DEVICE_SPECS.values():
        if kind in row.kinds or ("H100" in (kind or "")
                                 and row.name == "h100-sxm"):
            return row
    raise KeyError(f"no device row for {kind!r}; rows: "
                   f"{sorted(DEVICE_SPECS)}")


# fraction of a row's HBM held back from the auto budget: the CUDA
# context, the caching allocator's slack and what a liveness estimate
# cannot see
DEFAULT_HBM_HEADROOM = 0.10


def auto_hbm_budget(device: Optional[object] = None, *,
                    headroom: float = DEFAULT_HBM_HEADROOM) -> int:
    """The default HBM byte budget of a device: with `device` None on an
    initialized card, the card's total memory
    (``torch.cuda.mem_get_info``) less `headroom`; for a row (or with no
    card), its capacity less `headroom`. TPU702 and the engine's audit
    compare the liveness pass's peak against it."""
    if not 0.0 <= headroom < 1.0:
        raise ValueError(
            f"headroom must be a fraction in [0, 1), got {headroom!r}")
    if device is None:
        import torch

        if torch.cuda.is_available() and torch.cuda.is_initialized():
            _, total = torch.cuda.mem_get_info()
            return int(total * (1.0 - headroom))
    return int(get_spec(device).hbm_bytes * (1.0 - headroom))


def get_spec(device: Optional[object] = None) -> DeviceSpec:
    """A `DeviceSpec` passes through, a string names a row (KeyError
    lists them), a ``torch.device`` of the card or None resolves to the
    card's row when one is attached, else to the H100 row (the static
    passes price the card the port runs on, not the tracing host)."""
    if isinstance(device, DeviceSpec):
        return device
    if device is not None and not hasattr(device, "type"):
        try:
            return DEVICE_SPECS[str(device)]
        except KeyError:
            raise KeyError(
                f"unknown device spec {device!r}; rows: "
                f"{sorted(DEVICE_SPECS)}") from None
    import torch

    if torch.cuda.is_available():
        try:
            return spec_for_device_kind(torch.cuda.get_device_name(0))
        except KeyError:
            pass
    return DEVICE_SPECS[DEFAULT_DEVICE]
