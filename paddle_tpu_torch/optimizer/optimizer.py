"""Optimizer base (counterpart of paddle_tpu/optimizer/optimizer.py;
reference: python/paddle/optimizer/optimizer.py:125).

Each optimizer defines a per-tensor update rule, ``_update_rule_arr(p, g,
state, lr, wd, step) -> (new p, new state)``; ``step()`` applies it
eagerly over every parameter that has a ``.grad`` and writes the result
back in place (the JAX package jits the same rule; ``FusedOptimizer``
drives it over a params dict). Parameters may be given as tensors, as
``(name, tensor)`` pairs (``model.named_parameters()``: the names feed
``apply_decay_param_fun``), or as group dicts with a ``"params"`` list.

``state_dict()`` / ``set_state_dict()`` use the JAX package's keys:
``global_step``, ``LR_Scheduler`` (a scheduler's state) and one
positional ``param_{i}_{k}`` entry per state tensor (the i-th parameter
in group order, k its state name: ``moment1``, ``moment2``, ``master``),
so a checkpoint of either package restores the other's optimizer.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .lr import LRScheduler


def _as_tensor(v) -> torch.Tensor:
    return v if isinstance(v, torch.Tensor) else torch.as_tensor(
        np.asarray(v))


class Optimizer:
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 multi_precision=False):
        if parameters is None:
            raise ValueError("parameters must be provided (eager mode, ref "
                             "optimizer.py:125)")
        self._names: Dict[int, str] = {}
        self._param_groups = []
        self._parameter_list = []
        items = list(parameters)
        groups = items if items and isinstance(items[0], dict) \
            else [{"params": items}]
        for g in groups:
            ps = [self._take(p) for p in g["params"]]
            self._param_groups.append({**g, "params": ps})
            self._parameter_list.extend(ps)
        self._learning_rate = learning_rate
        self._weight_decay = weight_decay
        self._grad_clip = grad_clip
        self._multi_precision = multi_precision
        # param id -> dict of state tensors
        self._accumulators: Dict[int, Dict[str, torch.Tensor]] = {}
        self._global_step = 0

    def _take(self, p):
        if isinstance(p, tuple):
            name, p = p
            self._names[id(p)] = name
        return p

    # ------------------------------------------------------------------
    def get_lr(self) -> float:
        if isinstance(self._learning_rate, LRScheduler):
            return float(self._learning_rate())
        return float(self._learning_rate)

    # ------------------------------------------------------------------
    def _create_accumulators(self, p: torch.Tensor) -> Dict[str,
                                                            torch.Tensor]:
        """Override: the initial state tensors of one param."""
        return {}

    def _weight_decay_value(self, group) -> float:
        wd = group.get("weight_decay", self._weight_decay)
        return 0.0 if wd is None else float(wd)

    def _apply_decay(self, name: str) -> bool:
        """Whether the param called `name` is decayed."""
        return True

    def _update_rule_arr(self, pa, ga, state, lr, wd, step):
        raise NotImplementedError

    @staticmethod
    def _trainable(p) -> bool:
        return p.requires_grad and p.grad is not None

    # ------------------------------------------------------------------
    @torch.no_grad()
    def step(self):
        """Apply one update to every trainable param with a grad, in
        place (reference Optimizer.step / _apply_optimize)."""
        self._global_step += 1
        todo = [(p, self._weight_decay_value(group))
                for group in self._param_groups for p in group["params"]
                if self._trainable(p)]
        if not todo:
            return
        grads = [p.grad for p, _ in todo]
        if self._grad_clip is not None:
            grads = self._grad_clip.apply(grads)
        lr = self.get_lr()
        for (p, wd), g in zip(todo, grads):
            st = self._accumulators.get(id(p))
            if st is None:
                st = self._create_accumulators(p)
            decay = self._apply_decay(self._names.get(id(p), ""))
            new_p, self._accumulators[id(p)] = self._update_rule_arr(
                p, g, st, lr, wd if decay else 0.0, self._global_step)
            p.copy_(new_p)

    def clear_grad(self, set_to_zero=False):
        for p in self._parameter_list:
            if p.grad is None:
                continue
            if set_to_zero:
                p.grad.zero_()
            else:
                p.grad = None

    clear_gradients = clear_grad

    # ------------------------------------------------------------------
    def state_dict(self) -> dict:
        """``global_step``, the LR scheduler's state and every state
        tensor under its positional key. The tensors are the optimizer's
        own (a checkpoint save snapshots them)."""
        out = {"global_step": self._global_step}
        if isinstance(self._learning_rate, LRScheduler):
            out["LR_Scheduler"] = self._learning_rate.state_dict()
        i = 0
        for group in self._param_groups:
            for p in group["params"]:
                for k, v in self._accumulators.get(id(p), {}).items():
                    # positional key: stable for the same architecture,
                    # whatever the parameters are called
                    out[f"param_{i}_{k}"] = v
                i += 1
        return out

    @torch.no_grad()
    def set_state_dict(self, state_dict: dict) -> None:
        """Load a `state_dict()` (tensors or numpy arrays, any device).
        Every parameter gets its state (zeros where the dict has no
        entry); each tensor is copied onto its parameter's device in the
        state's own dtype (f32 moments stay f32 beside bf16 params).
        Entries keyed ``{name}_{k}`` by a parameter's name (the JAX
        package's legacy layout) load too."""
        self._global_step = int(state_dict.get("global_step", 0))
        if "LR_Scheduler" in state_dict \
                and isinstance(self._learning_rate, LRScheduler):
            self._learning_rate.set_state_dict(state_dict["LR_Scheduler"])
        i = 0
        for group in self._param_groups:
            for p in group["params"]:
                st = self._accumulators.get(id(p))
                if not st:
                    st = self._accumulators[id(p)] = \
                        self._create_accumulators(p)
                for k in list(st):
                    for key in (f"param_{i}_{k}", (self._names.get(id(p))
                                                   or f"param_{i}") + "_" + k):
                        if key in state_dict:
                            st[k] = _as_tensor(state_dict[key]).to(
                                device=p.device, dtype=st[k].dtype,
                                copy=True)
                            break
                i += 1

    load_state_dict = set_state_dict
