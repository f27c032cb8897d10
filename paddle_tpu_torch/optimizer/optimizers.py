"""Adam and AdamW (counterpart of paddle_tpu/optimizer/optimizers.py:54-118;
reference: python/paddle/optimizer/{adam,adamw}.py).

The JAX update rule, op for op: f32 moments; the param is updated in f32
from ``p.float()`` and rounded back to its dtype (a bf16 param keeps no
f32 master copy unless ``multi_precision``); the bias correction and eps
placement are ``mhat / (sqrt(vhat) + eps)``, which is not
``torch.optim.AdamW``'s order; AdamW decays as ``upd + wd * p32``.
"""
from __future__ import annotations

import torch

from .optimizer import Optimizer

__all__ = ["Adam", "AdamW"]


class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, parameters=None, weight_decay=None,
                 grad_clip=None, multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _create_accumulators(self, p):
        st = {"moment1": torch.zeros(p.shape, dtype=torch.float32,
                                     device=p.device),
              "moment2": torch.zeros(p.shape, dtype=torch.float32,
                                     device=p.device)}
        if self._multi_precision and p.dtype != torch.float32:
            st["master"] = p.detach().to(torch.float32)
        return st

    def _decoupled(self) -> bool:
        return False  # Adam applies L2 as grad decay; AdamW decouples

    def _update_rule_arr(self, pa, ga, state, lr, wd, step):
        b1, b2 = self._beta1, self._beta2
        g = ga.to(torch.float32)
        master = state.get("master")
        p32 = master if master is not None else pa.to(torch.float32)
        if wd and not self._decoupled():
            g = g + wd * p32
        m = b1 * state["moment1"] + (1 - b1) * g
        v = b2 * state["moment2"] + (1 - b2) * g * g
        mhat = m / (1 - b1 ** step)
        vhat = v / (1 - b2 ** step)
        upd = mhat / (torch.sqrt(vhat) + self._epsilon)
        if wd and self._decoupled():
            upd = upd + wd * p32
        new_p32 = p32 - lr * upd
        new_state = {"moment1": m, "moment2": v}
        if master is not None:
            new_state["master"] = new_p32
        return new_p32.to(pa.dtype), new_state


class AdamW(Adam):
    """Decoupled weight decay (default 0.01); `apply_decay_param_fun`
    filters params by name. The JAX package passes its auto-generated
    names ("linear_3.w_0", "llamarmsnorm_7.w_0"); the port passes the
    structural key ("llama.layers.0.input_layernorm.weight"), from
    ``FusedOptimizer`` or from ``(name, param)`` pairs."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, parameters=None, weight_decay=0.01,
                 apply_decay_param_fun=None, grad_clip=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip, multi_precision, name)
        self._apply_decay_param_fun = apply_decay_param_fun

    def _decoupled(self) -> bool:
        return True

    def _apply_decay(self, name: str) -> bool:
        if self._apply_decay_param_fun is not None:
            return bool(self._apply_decay_param_fun(name))
        return True
