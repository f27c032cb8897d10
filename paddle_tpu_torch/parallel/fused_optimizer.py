"""Drive an eager Optimizer over a params dict (counterpart of
paddle_tpu/parallel/fused_optimizer.py).

    init_state(params)                 -> {"step": int, "acc": {name: state}}
    update(params, grads, state, lr)   -> (params, state), params in place

The JAX class lifts an Optimizer's pure update rule into its jitted
train step; here every step is eager, so ``update`` runs the same rule,
with the optimizer's per-group weight decay, ``apply_decay_param_fun``,
grad clip and LR schedule, and writes each param in place.

Names: JAX calls ``apply_decay_param_fun`` on the auto-generated
parameter names ("linear_3.w_0", "llamarmsnorm_7.w_0"); the port passes
the structural key ("llama.layers.0.input_layernorm.weight"). For
bench.py's predicate (no "norm", no ".b_0") both name sets decide the
same: every weight but the norm scales is decayed.
"""
from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from ..optimizer.lr import LRScheduler
from ..optimizer.optimizer import Optimizer


class FusedOptimizer:
    """Lift `optimizer` (built over `model`'s parameters) into
    init_state / update over a params dict keyed like
    ``model.named_parameters()``."""

    def __init__(self, optimizer: Optimizer, model: nn.Module):
        if type(optimizer)._update_rule_arr is Optimizer._update_rule_arr:
            raise NotImplementedError(
                f"{type(optimizer).__name__} has no update rule and cannot "
                "run inside the train step (use eager loss.backward() + "
                "optimizer.step())")
        self._opt = optimizer
        by_id = {id(p): n for n, p in model.named_parameters()}
        # name -> weight decay of the update (0 where not decayed)
        self._wd: Dict[str, float] = {}
        for group in optimizer._param_groups:
            wd = optimizer._weight_decay_value(group)
            for p in group["params"]:
                name = by_id.get(id(p))
                if name is None or not p.requires_grad:
                    continue
                self._wd[name] = wd if optimizer._apply_decay(name) else 0.0
        # params outside the optimizer (frozen ones) pass through untouched
        self.trainable = frozenset(self._wd)

    def init_state(self, params: Dict[str, torch.Tensor]):
        acc = {name: self._opt._create_accumulators(params[name])
               for name in self.trainable}
        return {"step": self._opt._global_step, "acc": acc}

    @torch.no_grad()
    def update(self, params, grads, state, lr, reduce_sq=None):
        """One optimizer step over every trainable param, in place; the
        global clip sees the grads in sorted-name order, as in JAX.
        `params` may map a name to a view (the rows a ZeRO rank updates);
        `reduce_sq(names, sums)` turns the clip's per-leaf sums of squares
        of blocks into the global leaves'."""
        opt = self._opt
        step = state["step"] + 1
        names = sorted(self.trainable)
        gs = [grads[n] for n in names]
        if opt._grad_clip is not None:
            gs = opt._grad_clip.apply(
                gs, reduce_sq=None if reduce_sq is None
                else (lambda sqs: reduce_sq(names, sqs)))
        acc = state["acc"]
        for n, g in zip(names, gs):
            new_p, acc[n] = opt._update_rule_arr(params[n], g, acc[n], lr,
                                                 self._wd[n], step)
            params[n].copy_(new_p)
        return params, {"step": step, "acc": acc}

    def host_lr(self) -> float:
        return self._opt.get_lr()

    def host_tick(self):
        """After a step: the optimizer's global step and its LR schedule
        advance (reference: the Engine steps the scheduler once per
        iteration)."""
        self._opt._global_step += 1
        sched = self._opt._learning_rate
        if isinstance(sched, LRScheduler):
            sched.step()
