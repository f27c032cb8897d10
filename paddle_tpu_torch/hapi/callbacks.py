"""High-level API callbacks of the port (counterpart of
paddle_tpu/hapi/callbacks.py; reference: python/paddle/hapi/callbacks.py
— Callback/CallbackList, ProgBarLogger, ModelCheckpoint, LRScheduler,
EarlyStopping). Plain Python over the trainer's hooks."""
from __future__ import annotations

import numbers
import os
import sys
import time


class Callback:
    def __init__(self):
        self.model = None
        self.params = {}

    def set_params(self, params):
        self.params = params or {}

    def set_model(self, model):
        self.model = model

    # train
    def on_train_begin(self, logs=None):
        pass

    def on_train_end(self, logs=None):
        pass

    def on_epoch_begin(self, epoch, logs=None):
        pass

    def on_epoch_end(self, epoch, logs=None):
        pass

    def on_train_batch_begin(self, step, logs=None):
        pass

    def on_train_batch_end(self, step, logs=None):
        pass

    # eval
    def on_eval_begin(self, logs=None):
        pass

    def on_eval_end(self, logs=None):
        pass

    def on_eval_batch_begin(self, step, logs=None):
        pass

    def on_eval_batch_end(self, step, logs=None):
        pass

    # predict
    def on_predict_begin(self, logs=None):
        pass

    def on_predict_end(self, logs=None):
        pass

    def on_predict_batch_begin(self, step, logs=None):
        pass

    def on_predict_batch_end(self, step, logs=None):
        pass


class CallbackList:
    def __init__(self, callbacks):
        self.callbacks = list(callbacks)

    def set_params(self, params):
        for c in self.callbacks:
            c.set_params(params)

    def set_model(self, model):
        for c in self.callbacks:
            c.set_model(model)

    def __getattr__(self, name):
        if name.startswith("on_"):
            def call(*args, **kwargs):
                for c in self.callbacks:
                    getattr(c, name)(*args, **kwargs)

            return call
        raise AttributeError(name)


class ProgBarLogger(Callback):
    """reference: callbacks.py ProgBarLogger — per-epoch progress lines."""

    def __init__(self, log_freq=1, verbose=2):
        super().__init__()
        self.log_freq = log_freq
        self.verbose = verbose

    def on_epoch_begin(self, epoch, logs=None):
        self.epoch = epoch
        self.steps = self.params.get("steps")
        self._start = time.time()
        if self.verbose and self.params.get("epochs"):
            print(f"Epoch {epoch + 1}/{self.params['epochs']}")

    def _fmt(self, logs):
        parts = []
        for k, v in (logs or {}).items():
            if isinstance(v, numbers.Number):
                parts.append(f"{k}: {v:.4f}")
            elif isinstance(v, (list, tuple)) and v \
                    and isinstance(v[0], numbers.Number):
                parts.append(f"{k}: " + "/".join(f"{x:.4f}" for x in v))
        return " - ".join(parts)

    def on_train_batch_end(self, step, logs=None):
        if self.verbose == 2 and step % self.log_freq == 0:
            print(f"step {step + 1}/{self.steps or '?'} - {self._fmt(logs)}")
            sys.stdout.flush()

    def on_epoch_end(self, epoch, logs=None):
        if self.verbose:
            dur = time.time() - self._start
            print(f"Epoch {epoch + 1} done ({dur:.1f}s) - {self._fmt(logs)}")

    def on_eval_end(self, logs=None):
        if self.verbose:
            print(f"Eval - {self._fmt(logs)}")


class ModelCheckpoint(Callback):
    """reference: callbacks.py ModelCheckpoint — save every N epochs."""

    def __init__(self, save_freq=1, save_dir=None):
        super().__init__()
        self.save_freq = save_freq
        self.save_dir = save_dir

    def on_epoch_end(self, epoch, logs=None):
        if self.save_dir and epoch % self.save_freq == 0:
            path = os.path.join(self.save_dir, f"{epoch}")
            self.model.save(path)

    def on_train_end(self, logs=None):
        if self.save_dir:
            self.model.save(os.path.join(self.save_dir, "final"))


class LRScheduler(Callback):
    """reference: callbacks.py LRScheduler — steps the optimizer's
    LRScheduler each batch/epoch."""

    def __init__(self, by_step=True, by_epoch=False):
        super().__init__()
        self.by_step = by_step
        self.by_epoch = by_epoch

    def _sched(self):
        from ..optimizer.lr import LRScheduler as Sched

        opt = getattr(self.model, "_optimizer", None)
        lr = getattr(opt, "_learning_rate", None)
        return lr if isinstance(lr, Sched) else None

    def on_train_batch_end(self, step, logs=None):
        if self.by_step:
            s = self._sched()
            if s is not None:
                s.step()

    def on_epoch_end(self, epoch, logs=None):
        if self.by_epoch:
            s = self._sched()
            if s is not None:
                s.step()


class EarlyStopping(Callback):
    """reference: callbacks.py EarlyStopping."""

    def __init__(self, monitor="loss", mode="auto", patience=0, verbose=1,
                 min_delta=0, baseline=None, save_best_model=True):
        super().__init__()
        self.monitor = monitor
        self.patience = patience
        self.verbose = verbose
        self.min_delta = abs(min_delta)
        self.baseline = baseline
        self.save_best_model = save_best_model
        self.stopped_epoch = 0
        if mode == "min" or (mode == "auto" and "acc" not in monitor):
            self.monitor_op = lambda cur, best: cur < best - self.min_delta
            self.best = float("inf")
        else:
            self.monitor_op = lambda cur, best: cur > best + self.min_delta
            self.best = -float("inf")
        self.wait = 0

    def on_eval_end(self, logs=None):
        logs = logs or {}
        cur = logs.get(self.monitor)
        if cur is None:
            return
        if isinstance(cur, (list, tuple)):
            cur = cur[0]
        if self.monitor_op(cur, self.best):
            self.best = cur
            self.wait = 0
        else:
            self.wait += 1
            if self.wait >= self.patience:
                self.model.stop_training = True
                if self.verbose:
                    print(f"Early stopping: {self.monitor} plateaued "
                          f"at {self.best:.5f}")
