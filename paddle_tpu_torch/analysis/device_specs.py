"""The hardware table the static passes price against (counterpart of
paddle_tpu/analysis/device_specs.py): peak FLOP/s per dtype, HBM bytes/s,
interconnect bytes/s and the fixed cost of one kernel launch.

The port has two rows. ``h100-sxm`` is the NVIDIA H100 SXM5 80GB at 700
W, from the published figures: dense bf16 / f16 989e12 FLOP/s, int8
1979e12, f32 67e12 (the CUDA-core rate: the port never enables TF32, so
an f32 product runs there), HBM3 3.35e12 B/s, NVLink 900e9 B/s, 80 GiB.
Its ``launch_overhead_s`` is measured on the card (``chip_smoke.py``
phase 25, ``PERF.md``): a kernel launch replayed from a CUDA graph, the
way the engine and the training step's programs run. The
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
    Bandwidths are bytes/s."""

    name: str
    peak_flops: Dict[str, float]
    hbm_gbs: float            # HBM bytes/s
    ici_gbs: float            # interconnect bytes/s (NVLink on the card)
    launch_overhead_s: float  # fixed device cost of one kernel launch
    hbm_bytes: int            # capacity
    kinds: tuple = ()         # torch.cuda.get_device_name() strings

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
        kinds=("NVIDIA H100 80GB HBM3",)),
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
