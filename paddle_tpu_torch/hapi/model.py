"""hapi.Model of the port: the fit/evaluate/predict trainer (counterpart of
paddle_tpu/hapi/model.py; reference: python/paddle/hapi/model.py:1081
Model, fit at :1807).

Train and eval steps run eagerly under autograd on the model's device
(``loss.backward()``, then the optimizer's in-place ``step()``): on the
card the network's kernels (flash attention forward and backward,
rms_norm) are launched by its own modules. ``Model(network,
device=None)`` resolves the device like every entry point of the port
(the card unless the caller passes ``"cpu"``); every parameter must
already live there, and batches (numpy arrays or CPU tensors) move to it
in `train_batch` / `eval_batch` / `predict_batch`.

Differences from the JAX package's trainer, by design:

- `predict` returns numpy arrays as JAX does; a bf16 output is widened
  exactly to float32 (numpy has no bf16 without ``ml_dtypes``).
- resume and `load` copy the saved state into the live parameters
  (``network.load_state_dict``), so every parameter keeps its identity
  and the optimizer's state, keyed by parameter, stays attached.
- The static audits (``audit_memory`` / ``audit_comms`` /
  ``audit_roofline``, or ``PADDLE_TPU_LINT=1``) trace the whole training
  step once (forward, backward, the dp gradient sync and the optimizer's
  update) on fake tensors; the JAX package traces the forward for its
  memory audit.
- Data parallelism: under a global mesh whose dp axis exceeds 1
  (`parallel.mesh`), every rank runs `fit` over the same global batches
  and trains on its rows of each; the gradients are summed over dp before
  the optimizer's step (one all-reduce a dtype, or with
  ``quantized_collectives`` the int8 `quantized_psum_tree`). The JAX
  single controller trains the global batch eagerly unless the sync is
  quantized; SPMD ranks always sync.
"""
from __future__ import annotations

import gc
import time
import warnings
from typing import List

import numpy as np
import torch

from ..device import resolve_device
from ..io import DataLoader, Dataset
from ..metric import Metric
from ..observability import metrics as obs_metrics
from ..observability import record_event
from ..observability import trace as obs_trace
from .callbacks import CallbackList, ProgBarLogger

__all__ = ["Model", "summary"]

# fit's rows split over dp only, as JAX's fit
_FIT_BATCH_SPEC = (("dp",),)


def _to_list(x):
    if x is None:
        return []
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _numpy_out(t):
    if not isinstance(t, torch.Tensor):
        return np.asarray(t)
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()   # numpy has no bf16: widen exactly
    return t.cpu().numpy()


class Model:
    """reference: hapi/model.py Model(network, inputs, labels); `device`
    (default: the CUDA card) is where the network already lives."""

    def __init__(self, network, inputs=None, labels=None, device=None):
        self.network = network
        self._inputs = inputs
        self._labels = labels
        self.device = resolve_device(device)
        for name, p in network.named_parameters():
            if p.device != self.device:
                raise ValueError(
                    f"Model(device={self.device}): parameter {name!r} "
                    f"lives on {p.device}; move the network to "
                    f"{self.device} first (Model never moves it)")
        self._optimizer = None
        self._loss = None
        self._metrics: List[Metric] = []
        self.stop_training = False
        self.preempted = False
        # generation fit(resume=True) restored from (gang mode: the
        # AGREED generation — every rank reports the same number), or
        # None when the run started fresh
        self.restored_generation = None
        # static audits of the training step: dicts via
        # fit(audit_memory=True) / fit(audit_roofline=True), else None
        self.memory_audit = None
        self.roofline_audit = None
        self.comms_audit = None
        # the last fit()'s resolved quantized_collectives (None before a
        # fit) and the batches synced through the quantized dp step
        self._quantized_collectives = None
        self.quantized_dp_steps = 0

    # ------------------------------------------------------------------
    def prepare(self, optimizer=None, loss=None, metrics=None,
                amp_configs=None):
        self._optimizer = optimizer
        self._loss = loss
        self._metrics = _to_list(metrics)
        for m in self._metrics:
            if not isinstance(m, Metric):
                raise TypeError(
                    f"metric must be paddle_tpu_torch.metric.Metric, "
                    f"got {m}")

    # ------------------------------------------------------------------
    def _compute_loss(self, outputs, labels):
        loss_fn = self._loss
        if loss_fn is None:
            raise RuntimeError("call prepare(loss=...) before training")
        if callable(loss_fn) and not isinstance(loss_fn, (list, tuple)):
            return loss_fn(*_to_list(outputs), *_to_list(labels))
        raise TypeError("loss must be callable")

    def _on_device(self, xs):
        return [torch.as_tensor(x).to(self.device) for x in _to_list(xs)]

    def _update_metrics(self, outputs, labels):
        metrics = []
        for m in self._metrics:
            m.update(*_to_list(m.compute(*_to_list(outputs), *labels)))
            metrics.append(m.accumulate())
        return metrics

    def train_batch(self, inputs, labels=None, update=True):
        self.network.train()
        inputs = self._on_device(inputs)
        labels = self._on_device(labels)
        outputs = self.network(*inputs)
        loss = self._compute_loss(outputs, labels)
        loss.backward()
        if update and self._optimizer is not None:
            self._optimizer.step()
            self._optimizer.clear_grad()
        metrics = self._update_metrics(outputs, labels)
        out = [float(loss.detach())]
        return (out, metrics) if metrics else out

    def _dp_mesh(self):
        """The global mesh when its dp axis exceeds 1, else None (fit
        trains over dp only, as JAX's fit)."""
        from ..parallel.mesh import get_global_mesh

        mesh = get_global_mesh()
        if mesh is None or mesh.shape.get("dp", 1) <= 1:
            return None
        return mesh

    @staticmethod
    def _dp_rows(batch, mesh):
        """(this rank's rows of every leaf of `batch`, its share of the
        rows, the dp GroupRef), the train step's row split with
        ``batch_spec=(("dp",),)``; None when a leaf is 0-d or dp does not
        divide the rows."""
        from ..parallel.trainer import row_axes, take_rows

        axes = row_axes(mesh, batch, _FIT_BATCH_SPEC)
        if not axes:
            return None
        rows, share = take_rows(mesh, batch, axes)
        return rows, share, mesh.group_ref(axes)

    def _dp_train_batch(self, inputs, labels=None, update=True):
        """`train_batch` over the dp mesh: this rank's rows, its loss
        weighted by its share of the rows, and (at an update) the
        gradients accumulated so far summed over dp before the optimizer's
        step; the loss returned is the global batch's. A batch dp does
        not divide runs whole (`train_batch`)."""
        from ..parallel.collectives import all_reduce, psum_tree

        self.network.train()
        inputs = self._on_device(inputs)
        labels = self._on_device(labels)
        n_in = len(inputs)
        split = self._dp_rows(tuple(inputs) + tuple(labels),
                              self._dp_mesh())
        if split is None:
            return self.train_batch(inputs, labels, update=update)
        rows, share, dp = split
        outputs = self.network(*rows[:n_in])
        loss = self._compute_loss(outputs, list(rows[n_in:]))
        (loss * share).backward()
        if update and self._optimizer is not None:
            params = {n: p for n, p in self.network.named_parameters()
                      if p.grad is not None}
            quantized = bool(self._quantized_collectives)
            red = psum_tree({n: p.grad for n, p in params.items()}, dp,
                            quantized)
            with torch.no_grad():
                for n, p in params.items():
                    p.grad.copy_(red[n])
            self.quantized_dp_steps += int(quantized)
            self._optimizer.step()
            self._optimizer.clear_grad()
        loss = all_reduce(loss.detach() * share, dp)
        metrics = []
        if self._metrics:
            with torch.no_grad():
                metrics = self._update_metrics(self.network(*inputs),
                                               labels)
        out = [float(loss)]
        return (out, metrics) if metrics else out

    @torch.no_grad()
    def eval_batch(self, inputs, labels=None):
        self.network.eval()
        inputs = self._on_device(inputs)
        labels = self._on_device(labels)
        outputs = self.network(*inputs)
        losses = ([float(self._compute_loss(outputs, labels))]
                  if self._loss is not None and labels else [])
        metrics = self._update_metrics(outputs, labels)
        return (losses, metrics) if metrics else losses

    @torch.no_grad()
    def predict_batch(self, inputs):
        self.network.eval()
        outputs = self.network(*self._on_device(inputs))
        return [_numpy_out(o) for o in _to_list(outputs)]

    # ------------------------------------------------------------------
    def _make_loader(self, data, batch_size, shuffle):
        if data is None or isinstance(data, DataLoader):
            return data
        if isinstance(data, Dataset):
            return DataLoader(data, batch_size=batch_size, shuffle=shuffle)
        return data  # iterable of batches

    def fit(self, train_data=None, eval_data=None, batch_size=1, epochs=1,
            eval_freq=1, log_freq=10, save_dir=None, save_freq=1, verbose=2,
            drop_last=False, shuffle=True, num_workers=0, callbacks=None,
            accumulate_grad_batches=1, num_iters=None, checkpoint_dir=None,
            resume=False, checkpoint_freq=None, audit_memory=None,
            audit_comms=None, audit_roofline=None, coordinator=None,
            quantized_collectives=None):
        """reference: hapi/model.py fit (:1807).

        Resilience (paddle_tpu_torch.resilience):
          checkpoint_dir: atomic generation-counted checkpoints (model +
            optimizer + loop position) land here; a preemption signal
            (SIGTERM/SIGINT) observed at a step boundary triggers an
            emergency checkpoint and a clean stop (`self.preempted`).
          resume: restore the newest valid generation from
            checkpoint_dir and continue from the recorded epoch/step
            (deterministic resume needs a deterministic loader —
            shuffle=False or a seeded sampler). An empty directory is a
            fresh run; generations that all fail verification raise.
          checkpoint_freq: save every N steps (async: the step waits for
            the snapshot only); None saves at epoch boundaries only.
          coordinator: a `resilience.Coordinator` puts checkpointing in
            GANG mode: every save is the two-phase coordinated commit
            and resume=True routes through generation AGREEMENT,
            recorded on `self.restored_generation`. A peer that dies
            mid-protocol surfaces as a structured `BarrierTimeout`, and
            the emergency checkpoint on preemption is a best-effort gang
            save abandoned (RuntimeWarning) on barrier timeout.
            Subprocess workers build one with
            `resilience.coordination.from_env()`.

        Observability: with a tracer or a metrics registry armed, every
        step records `fit.data_fetch` (loader wait), `fit.step` (the
        train step through the host's read of its loss, a
        `step_span`) and `fit.checkpoint_save` spans plus the matching
        `fit_*_s` histograms and the `fit_steps` counter. Off (default):
        nothing is recorded.

        Static audits: `audit_memory=True` / `audit_comms=True` /
        `audit_roofline=True` (default: FLAGS_audit_memory /
        FLAGS_audit_comms / FLAGS_audit_roofline, all implied by
        PADDLE_TPU_LINT=1) trace the training step once at the first
        batch's shapes, on fake tensors (forward, backward, the dp
        gradient sync and the optimizer's update; nothing runs, no
        parameter or state moves, nothing is exchanged), and keep the
        liveness report (`analysis/memory.py`, TPU701-703) on
        `self.memory_audit`, the wire report (`analysis/comms.py`,
        TPU801-803: the dp gradient all-reduce, ``fit.step[dp=N]``) on
        `self.comms_audit` and the roofline report
        (`analysis/roofline.py`, TPU901-903) on `self.roofline_audit`,
        each with its observability event. A failed audit warns and
        training goes on.

        Data parallelism and `quantized_collectives` (default:
        FLAGS_quantized_collectives): under a global mesh whose dp axis
        exceeds 1, each batch trains on this rank's rows and the
        gradients are summed over dp before the optimizer's step; with
        quantized collectives the sum is `quantized_psum_tree` (counted
        by `self.quantized_dp_steps`). Without a dp mesh, quantized
        collectives warn and training keeps the one-rank path. A batch
        whose rows dp does not divide runs whole on every rank (no sync).
        """
        from ..analysis.comms import resolve_audit_comms
        from ..analysis.memory import resolve_audit_memory
        from ..analysis.roofline import resolve_audit_roofline
        from ..parallel.collectives import resolve_quantized_collectives

        audits = (resolve_audit_memory(audit_memory),
                  resolve_audit_roofline(audit_roofline),
                  resolve_audit_comms(audit_comms))
        audit_pending = any(audits)
        self._quantized_collectives = resolve_quantized_collectives(
            quantized_collectives)
        self.quantized_dp_steps = 0
        dp = self._dp_mesh()
        if self._quantized_collectives and dp is None:
            warnings.warn(
                "fit(quantized_collectives=True): no global mesh with a dp "
                "axis above 1, so there is no gradient sync to quantize; "
                "training keeps the one-rank path")
        train_batch = self.train_batch if dp is None else \
            self._dp_train_batch
        loader = self._make_loader(train_data, batch_size, shuffle)
        eval_loader = self._make_loader(eval_data, batch_size, False)
        cbks = CallbackList(_to_list(callbacks) or [ProgBarLogger(log_freq,
                                                                  verbose)])
        cbks.set_model(self)
        try:
            steps = len(loader)
        except TypeError:
            steps = None
        cbks.set_params({"epochs": epochs, "steps": steps,
                         "verbose": verbose, "metrics": self._metric_names()})
        self.stop_training = False
        self.preempted = False
        self.restored_generation = None
        from ..resilience import chaos as _chaos

        ckpt_mgr = guard = None
        start_epoch = skip_steps = it_count = 0
        try:
            if checkpoint_dir is not None:
                from ..resilience import preemption as _preemption
                from ..resilience.checkpoint import (
                    CheckpointManager, CheckpointNotFoundError)

                ckpt_mgr = CheckpointManager(checkpoint_dir, max_to_keep=3,
                                             coordinator=coordinator)
                guard = _preemption.install()
                if resume:
                    try:
                        # gang mode: routed through generation
                        # agreement — min over every host's newest
                        # digest-verified group generation
                        ck = ckpt_mgr.restore()
                    except CheckpointNotFoundError:
                        # an EMPTY dir is a legitimate fresh run;
                        # existing-but-unverifiable generations are data
                        # loss and must not silently restart at step 0
                        if ckpt_mgr.generations():
                            raise
                        ck = None
                    if ck is not None:
                        self._restore_state(ck.value)
                        self.restored_generation = ck.generation
                        start_epoch = int(ck.meta.get("epoch", 0))
                        skip_steps = int(ck.meta.get("step_in_epoch", 0))
                        it_count = int(ck.meta.get("global_step", 0))
                        if steps is not None and skip_steps >= steps:
                            start_epoch, skip_steps = start_epoch + 1, 0
            cbks.on_train_begin()
            for epoch in range(start_epoch, epochs):
                for m in self._metrics:
                    m.reset()
                cbks.on_epoch_begin(epoch)
                logs = {}
                hit_num_iters = False
                step = -1
                tr = obs_trace.get_tracer()
                mt = obs_metrics.get_metrics()
                batches = loader if tr is None and mt is None \
                    else self._timed_batches(loader, tr, mt)
                for step, batch in enumerate(batches):
                    if epoch == start_epoch and step < skip_steps:
                        continue  # replayed batches of a resumed epoch
                    cbks.on_train_batch_begin(step)
                    ins, labs = self._split_batch(batch)
                    if audit_pending:
                        audit_pending = False
                        self._audit_step(ins, labs, *audits)
                    update = (step + 1) % accumulate_grad_batches == 0
                    if tr is None and mt is None:
                        res = train_batch(ins, labs, update=update)
                    else:
                        t0 = time.perf_counter()
                        if tr is not None:
                            with tr.step_span("fit.step", it_count):
                                res = train_batch(ins, labs, update=update)
                        else:
                            res = train_batch(ins, labs, update=update)
                        if mt is not None:
                            mt.histogram(
                                "fit_step_s",
                                "train step dispatch+sync").observe(
                                    time.perf_counter() - t0)
                            mt.counter("fit_steps").inc()
                    logs = self._pack_logs(res)
                    cbks.on_train_batch_end(step, logs)
                    it_count += 1
                    _chaos.on_step("fit", it_count)
                    hit_num_iters = num_iters is not None \
                        and it_count >= num_iters
                    if hit_num_iters:
                        self.stop_training = True
                    if guard is not None and guard.requested:
                        # emergency checkpoint: blocking, then a clean
                        # stop — the grace window is for THIS write. In
                        # gang mode the save is the coordinated two-
                        # phase commit and BEST-EFFORT: a peer that was
                        # preempted harder than us (never reaches the
                        # stage barrier) must not wedge our shutdown —
                        # abandon on BarrierTimeout, the periodic gang
                        # generations are the recovery point
                        try:
                            self._save_checkpoint(
                                ckpt_mgr, epoch, step + 1, it_count,
                                blocking=True)
                        except Exception as e:
                            from ..resilience.coordination import (
                                BarrierTimeout)

                            if coordinator is None \
                                    or not isinstance(e, BarrierTimeout):
                                raise
                            warnings.warn(
                                f"emergency gang checkpoint abandoned "
                                f"({e}); the newest committed group "
                                "generation is the recovery point",
                                RuntimeWarning)
                        self.preempted = True
                        self.stop_training = True
                        record_event("preemption.emergency_checkpoint",
                                     step=it_count, epoch=epoch)
                        break
                    if ckpt_mgr is not None and checkpoint_freq \
                            and it_count % checkpoint_freq == 0:
                        self._save_checkpoint(ckpt_mgr, epoch, step + 1,
                                              it_count, blocking=False)
                    if hit_num_iters:
                        break
                cbks.on_epoch_end(epoch, logs)
                if self.preempted:
                    break  # the emergency save already recorded position
                if ckpt_mgr is not None and checkpoint_freq is None:
                    # a num_iters stop mid-epoch must record the TRUE
                    # position, not epoch+1 (which would skip the rest
                    # of this epoch on resume); a completed epoch rolls
                    # the position forward
                    if hit_num_iters:
                        self._save_checkpoint(ckpt_mgr, epoch, step + 1,
                                              it_count, blocking=False)
                    else:
                        self._save_checkpoint(ckpt_mgr, epoch + 1, 0,
                                              it_count, blocking=False)
                if eval_loader is not None and (epoch + 1) % eval_freq == 0:
                    self.evaluate(eval_loader, batch_size=batch_size,
                                  verbose=verbose, callbacks=cbks)
                if self.stop_training:
                    break
            cbks.on_train_end()
        finally:
            try:
                if ckpt_mgr is not None:
                    ckpt_mgr.wait()  # async-save barrier + error surface
            finally:
                if guard is not None:
                    from ..resilience import preemption as _preemption

                    _preemption.uninstall()

    @staticmethod
    def _timed_batches(loader, tr, mt):
        """Loader wrapped with `fit.data_fetch` spans / histogram — only
        on the instrumented path (fit iterates the raw loader when
        observability is off)."""
        it = iter(loader)
        while True:
            t0 = time.perf_counter_ns()
            try:
                batch = next(it)
            except StopIteration:
                return
            t1 = time.perf_counter_ns()
            if tr is not None:
                tr.complete("fit.data_fetch", t0, t1)
            if mt is not None:
                mt.histogram("fit_data_fetch_s",
                             "host wait on the data loader").observe(
                                 (t1 - t0) / 1e9)
            yield batch

    def _restore_state(self, state):
        """Copy a checkpoint's model (and optimizer) state into the live
        objects: parameters keep their identity, so the optimizer's
        per-parameter state stays attached."""
        self.network.load_state_dict(state["model"])
        if self._optimizer is not None and "optimizer" in state:
            self._optimizer.set_state_dict(state["optimizer"])

    def _save_checkpoint(self, mgr, epoch, step_in_epoch, global_step,
                         blocking):
        """Model + optimizer + loop position as one atomic generation.
        meta records the NEXT position to run: epoch/step_in_epoch
        point just past the last completed batch."""
        state = {"model": self.network.state_dict()}
        if self._optimizer is not None:
            state["optimizer"] = self._optimizer.state_dict()
        tr = obs_trace.get_tracer()
        mt = obs_metrics.get_metrics()
        t0 = time.perf_counter_ns()
        mgr.save(state, step=global_step,
                 meta={"epoch": epoch, "step_in_epoch": step_in_epoch,
                       "global_step": global_step}, blocking=blocking)
        t1 = time.perf_counter_ns()
        if tr is not None:
            tr.complete("fit.checkpoint_save", t0, t1, step=global_step,
                        blocking=blocking)
        if mt is not None:
            mt.histogram("fit_checkpoint_save_s",
                         "checkpoint snapshot+enqueue (or full write "
                         "when blocking)").observe((t1 - t0) / 1e9)

    def evaluate(self, eval_data, batch_size=1, log_freq=10, verbose=2,
                 num_workers=0, callbacks=None, num_samples=None):
        loader = self._make_loader(eval_data, batch_size, False)
        cbks = (callbacks if isinstance(callbacks, CallbackList)
                else CallbackList(_to_list(callbacks)
                                  or [ProgBarLogger(log_freq, verbose)]))
        cbks.set_model(self)
        for m in self._metrics:
            m.reset()
        cbks.on_eval_begin()
        logs = {}
        for step, batch in enumerate(loader):
            cbks.on_eval_batch_begin(step)
            ins, labs = self._split_batch(batch)
            res = self.eval_batch(ins, labs)
            logs = self._pack_logs(res)
            cbks.on_eval_batch_end(step, logs)
        cbks.on_eval_end(logs)
        return logs

    def predict(self, test_data, batch_size=1, num_workers=0,
                stack_outputs=False, verbose=1, callbacks=None):
        loader = self._make_loader(test_data, batch_size, False)
        outputs = []
        for batch in loader:
            ins, _ = self._split_batch(batch, labeled=False)
            outputs.append(self.predict_batch(ins))
        if stack_outputs and outputs:
            n_out = len(outputs[0])
            return [np.concatenate([b[i] for b in outputs])
                    for i in range(n_out)]
        return outputs

    # ------------------------------------------------------------------
    def _step_program(self, n_ins, dp=None):
        """step(params, states, *inputs, *labels) -> loss: the training
        step `train_batch` runs (forward, backward, the optimizer's
        per-parameter update), as a function of its tensors for the
        static audits; with `dp` (a mesh, `_dp_mesh`) the
        `_dp_train_batch` step: this rank's rows and the dp gradient sum
        before the update. An
        optimizer without state yet makes its accumulators inside the
        step."""
        from torch.nn.utils.stateless import _reparametrize_module

        from ..parallel.collectives import psum_tree

        net, opt = self.network, self._optimizer
        real = dict(net.named_parameters())
        quantized = bool(self._quantized_collectives)

        def step(params, states, *batch):
            share, ref = 1.0, None
            if dp is not None:
                batch, share, ref = self._dp_rows(batch, dp)
            ins, labs = batch[:n_ins], batch[n_ins:]
            with _reparametrize_module(net, params):
                loss = self._compute_loss(net(*ins), list(labs))
            ps = list(params.values())
            grads = torch.autograd.grad(loss * share, ps, allow_unused=True)
            if dp is not None:
                got = {n: g for n, g in zip(params, grads) if g is not None}
                red = psum_tree(got, ref, quantized)
                grads = [red.get(n) for n in params]
            if opt is None or not hasattr(opt, "_update_rule_arr"):
                return loss
            if opt._grad_clip is not None:
                grads = opt._grad_clip.apply(list(grads))
            lr = opt.get_lr()
            with torch.no_grad():
                for name, p, g, st in zip(params, ps, grads, states):
                    if g is None:
                        continue
                    if st is None:
                        st = opt._create_accumulators(p)
                    wd = opt._weight_decay_value(
                        next(gr for gr in opt._param_groups
                             if any(q is real[name] for q in gr["params"])))
                    decay = opt._apply_decay(
                        opt._names.get(id(real[name]), ""))
                    new_p, _ = opt._update_rule_arr(
                        p, g, st, lr, wd if decay else 0.0,
                        opt._global_step + 1)
                    p.copy_(new_p)
            return loss

        return step

    def _audit_step(self, ins, labs, do_memory, do_roofline,
                    do_comms=False):
        """Trace the training step once at this batch's shapes (fakes on
        the model's device: no device memory, no launch, no exchange) and
        run the asked audits over the one graph. Under a dp mesh the step
        is the dp step (``fit.step[dp=N]``, ``+int8coll`` with quantized
        collectives); a batch dp does not divide audits the one-rank step
        and warns, since its report would hide the gradient sum."""
        try:
            from ..analysis import comms as _comms
            from ..analysis import memory as _mem
            from ..analysis import roofline as _roof
            from ..analysis.graph import fakes_on, trace_graph
            from ..analysis.pipeline import analyze as _analyze

            batch = fakes_on(self.device, [torch.as_tensor(x) for x in
                                           _to_list(ins) + _to_list(labs)])
            params = {n: p for n, p in self.network.named_parameters()
                      if p.requires_grad}
            opt = self._optimizer
            states = [getattr(opt, "_accumulators", {}).get(id(p))
                      for p in params.values()]
            dp, name = self._dp_mesh(), "fit.step"
            if dp is not None and self._dp_rows(tuple(batch), dp) is None:
                warnings.warn(
                    f"fit's static audit: the global mesh has "
                    f"dp={dp.shape['dp']} "
                    "but a batch leaf is 0-d or its leading dim does not "
                    "divide by dp — auditing the single-rank step; the dp "
                    "gradient psum is NOT counted")
                dp = None
            if dp is not None:
                name = f"fit.step[dp={dp.shape['dp']}]" + (
                    "+int8coll" if self._quantized_collectives else "")
            g = trace_graph(self._step_program(len(_to_list(ins)), dp),
                            params, states, *batch, name=name, grad=True)
            if do_comms:
                rep = _comms.audit_graph(g)
                lint = _analyze(None, graph=g,
                                rules=["TPU801", "TPU802", "TPU803"])
                self.comms_audit = {
                    **rep.to_dict(),
                    "diagnostics": lint.to_dict()["diagnostics"]}
                record_event("comms.audit", target=name,
                             bytes_on_wire=rep.total_wire_bytes,
                             n_collectives=rep.n_collectives, mp=rep.mp)
            if do_memory:
                rep = _mem.audit_graph(g)
                lint = _analyze(None, graph=g,
                                rules=["TPU701", "TPU702", "TPU703"])
                self.memory_audit = {
                    **rep.to_dict(),
                    "diagnostics": lint.to_dict()["diagnostics"]}
                record_event("memory.audit", target=name,
                             peak_hbm_bytes=rep.peak_bytes, mp=rep.mp)
            if do_roofline:
                rep = _roof.audit_graph(g)
                lint = _analyze(None, graph=g,
                                rules=["TPU901", "TPU902", "TPU903"],
                                rule_config={
                                    f"{r}.device": rep.spec.name
                                    for r in ("TPU901", "TPU902",
                                              "TPU903")})
                self.roofline_audit = {
                    **rep.to_dict(),
                    "diagnostics": lint.to_dict()["diagnostics"]}
                record_event("roofline.audit", target=name,
                             device=rep.spec.name,
                             predicted_step_ms=rep.predicted_step_ms,
                             predicted_mfu=rep.predicted_mfu,
                             bound=rep.bound, mp=rep.mp)
        except Exception as e:
            warnings.warn(f"fit's static audit failed: "
                          f"{type(e).__name__}: {e}")
        # the trace's graph and fakes are reference cycles: collect them
        # here, not in the collector's passes during the next steps
        gc.collect()

    def _split_batch(self, batch, labeled=True):
        if isinstance(batch, (list, tuple)):
            batch = list(batch)
            if len(batch) > 1:
                # last element is the label (reference: fit assumes
                # (input..., label) batches); predict drops it
                return batch[:-1], (batch[-1:] if labeled else [])
            return batch, []
        return [batch], []

    def _metric_names(self):
        names = ["loss"]
        for m in self._metrics:
            n = m.name()
            names += n if isinstance(n, list) else [n]
        return names

    def _pack_logs(self, res):
        if isinstance(res, tuple):
            losses, metrics = res
        else:
            losses, metrics = res, []
        logs = {"loss": losses}
        for m, v in zip(self._metrics, metrics):
            n = m.name()
            logs[n[0] if isinstance(n, list) else n] = v
        return logs

    # ------------------------------------------------------------------
    def parameters(self, *args, **kwargs):
        return self.network.parameters(*args, **kwargs)

    def save(self, path, training=True):
        """reference: hapi/model.py save — params (+ optimizer state),
        in the JAX package's pickle layout (`framework.io.save`)."""
        import os

        from ..framework.io import save

        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        save(self.network.state_dict(keep_vars=True), path + ".pdparams")
        if training and self._optimizer is not None:
            save(self._optimizer.state_dict(), path + ".pdopt")

    def load(self, path, skip_mismatch=False, reset_optimizer=False):
        """Copy saved params (and optimizer state) into the live ones."""
        from ..framework.io import load

        self.network.load_state_dict(load(path + ".pdparams"),
                                     strict=not skip_mismatch)
        if not reset_optimizer and self._optimizer is not None:
            try:
                self._optimizer.set_state_dict(load(path + ".pdopt"))
            except FileNotFoundError:
                pass

    def summary(self, input_size=None, dtype=None):
        return summary(self.network, input_size, dtypes=dtype)


def summary(net, input_size=None, dtypes=None, input=None):
    """reference: hapi/model_summary.py — layer table + param counts."""
    rows = []
    total = 0
    trainable = 0
    for name, p in net.named_parameters():
        n = int(np.prod(tuple(p.shape)))
        total += n
        if p.requires_grad:
            trainable += n
        rows.append((name, list(p.shape), n))
    width = max((len(r[0]) for r in rows), default=20) + 2
    lines = [f"{'Layer (param)':<{width}}{'Shape':<20}{'Params':>12}",
             "-" * (width + 32)]
    for name, shape, n in rows:
        lines.append(f"{name:<{width}}{str(shape):<20}{n:>12,}")
    lines.append("-" * (width + 32))
    lines.append(f"Total params: {total:,}")
    lines.append(f"Trainable params: {trainable:,}")
    print("\n".join(lines))
    return {"total_params": total, "trainable_params": trainable}
