"""Pipeline parallelism's layer API over the ``pp`` mesh axis
(counterpart of paddle_tpu/parallel/pipeline.py; reference: fleet
meta_parallel/pipeline_parallel.py train_batch:697, pp_layers.py:257
PipelineLayer / LayerDesc / SegmentLayers).

- `pipeline_apply(block_fn, stage_params, x, n_microbatches)`: the GPipe
  schedule over the pp ranks, differentiable across them
  (`pipeline_spmd.pipeline_forward`: each rank runs its stage's slots,
  the boundaries hop by the ``ppermute`` operator, the output is the last
  stage's on every rank). With a pp axis of 1, JAX's: `block_fn` of the
  first stage's params.
- `LayerDesc` / `SharedLayerDesc`: deferred layer construction;
  `PipelineLayer` builds every layer (as the JAX package's single
  controller does) and records the uniform stage segmentation
  (`get_stage_layers`).
- `PipelineParallel.train_batch(data, optimizer)`: microbatched
  forward / backward and one optimizer step over the port's `Optimizer`
  (gradient accumulation over ``accumulate_steps`` microbatches, each
  loss scaled by 1 / n); `eval_batch` runs the layers.
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import torch
from torch import nn
from torch.utils import _pytree as pytree

from .pipeline_spmd import _pp, pipeline_forward

__all__ = ["pipeline_apply", "LayerDesc", "SharedLayerDesc", "PipelineLayer",
           "PipelineParallel"]


def pipeline_apply(block_fn: Callable, stage_params: Any, x: torch.Tensor,
                   n_microbatches: int, mesh=None, axis: str = "pp"):
    """Run the stacked stages (leading dim n_stages, whole or the rank's
    block) over microbatches of x (GPipe). block_fn(params of one stage,
    activation) -> activation; returns y shaped like x on every rank."""
    _, ref = _pp(mesh, axis)
    if ref is None:
        return block_fn(pytree.tree_map(lambda p: p[0], stage_params), x)
    if x.shape[0] % n_microbatches:
        raise ValueError(f"batch {x.shape[0]} not divisible by "
                         f"n_microbatches {n_microbatches}")
    return pipeline_forward(block_fn, stage_params, x, mesh=mesh, axis=axis,
                            n_micro=n_microbatches)


class LayerDesc:
    """reference: pp_layers.py LayerDesc — deferred layer construction."""

    def __init__(self, layer_cls, *args, **kwargs):
        self.layer_cls = layer_cls
        self.args = args
        self.kwargs = kwargs

    def build_layer(self):
        return self.layer_cls(*self.args, **self.kwargs)


class SharedLayerDesc(LayerDesc):
    """reference: pp_layers.py SharedLayerDesc (tied embeddings)."""

    def __init__(self, key, layer_cls, forward_func=None,
                 shared_weight_attr="weight", *args, **kwargs):
        super().__init__(layer_cls, *args, **kwargs)
        self.layer_name = key
        self.forward_func = forward_func
        self.shared_weight_attr = shared_weight_attr


class PipelineLayer(nn.Module):
    """reference: pp_layers.py:257 PipelineLayer(layers=[LayerDesc ...],
    num_stages, topology). Builds every layer; the stage segmentation is
    recorded for the scheduler."""

    def __init__(self, layers, num_stages=None, topology=None, loss_fn=None,
                 seg_method="uniform", recompute_interval=0, **kwargs):
        super().__init__()
        self._loss_fn = loss_fn
        built = [d.build_layer() if isinstance(d, LayerDesc) else d
                 for d in layers]
        self.run_function = nn.ModuleList(built)
        self._num_stages = num_stages or 1
        n = len(built)
        per = max(1, n // self._num_stages)
        self.segment_parts = [min(i * per, n)
                              for i in range(self._num_stages)] + [n]

    def forward(self, x):
        for layer in self.run_function:
            x = layer(x)
        return x

    def get_stage_layers(self, stage: int):
        lo, hi = self.segment_parts[stage], self.segment_parts[stage + 1]
        return list(self.run_function)[lo:hi]


def _accumulate_steps(strategy) -> int:
    """A strategy's pipeline accumulate_steps: `pipeline_configs` (the
    reference's DistributedStrategy), or a strategy dict's ``pipeline``
    section."""
    if strategy is None:
        return 1
    cfg = getattr(strategy, "pipeline_configs", None)
    if cfg is None and isinstance(strategy, dict):
        cfg = strategy.get("pipeline_configs", strategy.get("pipeline"))
    return int((cfg or {}).get("accumulate_steps", 1))


class PipelineParallel(nn.Module):
    """reference: pipeline_parallel.py PipelineParallel. `train_batch`
    runs microbatched forward / backward and one optimizer step: with a
    pp degree of 1 (or a model built whole on each rank, as here) it is
    gradient accumulation over the microbatches."""

    def __init__(self, layers, hcg=None, strategy=None):
        super().__init__()
        self._layers = layers
        self._hcg = hcg
        self._strategy = strategy
        self.accumulate_steps = _accumulate_steps(strategy)

    def forward(self, *args, **kwargs):
        return self._layers(*args, **kwargs)

    def train_batch(self, data, optimizer, lr_scheduler=None, scaler=None,
                    loss_fn: Optional[Callable] = None):
        x, y = data
        n_micro = max(1, self.accumulate_steps)
        bsz = x.shape[0]
        if bsz % n_micro:
            raise ValueError(
                f"batch size {bsz} must be divisible by accumulate_steps "
                f"{n_micro} (reference: PipelineParallel micro-batching)")
        mb = bsz // n_micro
        loss_fn = loss_fn or getattr(self._layers, "_loss_fn", None) \
            or nn.functional.cross_entropy
        total = 0.0
        for i in range(n_micro):
            out = self._layers(x[i * mb:(i + 1) * mb])
            loss = loss_fn(out, y[i * mb:(i + 1) * mb])
            scaled = loss / n_micro
            if scaler is not None:
                scaler.scale(scaled).backward()
            else:
                scaled.backward()
            total += float(loss.detach())
        if scaler is not None:
            scaler.step(optimizer)
            scaler.update()
        else:
            optimizer.step()
        optimizer.clear_grad()
        if lr_scheduler is not None:
            lr_scheduler.step()
        return torch.tensor(total / n_micro)

    @torch.no_grad()
    def eval_batch(self, data, compute_loss=True):
        x, _ = data
        return self._layers(x)
