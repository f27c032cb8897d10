"""Model FLOPs counting (counterpart of paddle_tpu/hapi/flops.py;
reference: python/paddle/hapi/dynamic_flops.py paddle.flops).

The forward is traced once on fake tensors (``analysis.trace_graph``:
nothing runs) and the static roofline pass (``analysis/roofline.py``)
counts its FLOPs: products 2·B·M·N·K, each hand-written kernel its own
closed form (``kernels/constraints.py``), reductions their inputs and
arithmetic its outputs. The JAX package asks XLA's cost analysis of the
compiled forward instead; the two agree on the products and differ on
the rest by how each counts elementwise and kernel work.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

__all__ = ["flops"]


def flops(net, input_size: Optional[Sequence[int]] = None, inputs=None,
          custom_ops=None, print_detail: bool = False) -> int:
    """Total FLOPs of one forward pass of `net` over `inputs` (a tensor
    or a list of them), or over one float32 zero tensor of `input_size`
    on the network's device. `custom_ops` is accepted for the
    reference's signature; the trace counts every operator itself."""
    from ..analysis import roofline

    if inputs is None:
        if input_size is None:
            raise ValueError("provide input_size or inputs")
        dev = next((p.device for p in net.parameters()),
                   torch.device("cpu"))
        inputs = [torch.zeros(tuple(input_size), dtype=torch.float32,
                              device="meta")]
        if dev.type != "meta":
            from ..analysis.graph import fakes_on

            inputs = fakes_on(dev, inputs)
    elif not isinstance(inputs, (list, tuple)):
        inputs = [inputs]
    was_training = net.training
    net.eval()
    try:
        rep = roofline.audit_roofline(net, *inputs, name="flops")
    finally:
        net.train(was_training)
    total = int(rep.total_flops)
    if print_detail:
        n_params = sum(p.numel() for p in net.parameters())
        print(f"Total Flops: {total}     Total Params: {n_params}")
        for dt, f in sorted(rep.flops_by_dtype().items()):
            print(f"  flops {dt}: {f}")
        print(f"  bytes accessed: {rep.total_hbm_bytes}")
    return total
