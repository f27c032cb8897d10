"""paddle.metric of the port (counterpart of paddle_tpu/metric;
reference: python/paddle/metric/metrics.py — Metric base, Accuracy,
Precision, Recall, Auc).

Inputs are torch tensors (any device) or numpy arrays. `Accuracy`'s
``compute`` picks the top-k on the tensors' device and returns a small
float32 tensor of hits; the accumulators are host numbers, filled by
the same numpy arithmetic as the JAX package's, so both report the
same values for the same inputs.
"""
from __future__ import annotations

import abc

import numpy as np
import torch

__all__ = ["Metric", "Accuracy", "Precision", "Recall", "Auc", "accuracy"]


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype in (torch.bfloat16, torch.float16):
            x = x.float()  # numpy has no bf16: widen exactly
        return x.cpu().numpy()
    return np.asarray(x)


def _labels_like(label: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
    """(N, 1) index labels or one-hot / soft labels -> (N,) indices."""
    if label.ndim == pred.ndim:
        if label.shape[-1] == 1:   # (N, 1) index labels (paddle default)
            return label[..., 0]
        return torch.argmax(label, dim=-1)   # one-hot / soft label
    return label


class Metric(abc.ABC):
    def __init__(self):
        pass

    @abc.abstractmethod
    def reset(self):
        ...

    @abc.abstractmethod
    def update(self, *args):
        ...

    @abc.abstractmethod
    def accumulate(self):
        ...

    @abc.abstractmethod
    def name(self):
        ...

    def compute(self, *args):
        """Optional pre-processing on tensors (runs on their device);
        default passthrough (reference: metrics.py Metric.compute)."""
        return args


class Accuracy(Metric):
    """reference: metrics.py:Accuracy — top-k correctness."""

    def __init__(self, topk=(1,), name=None):
        super().__init__()
        self.topk = (topk,) if isinstance(topk, int) else tuple(topk)
        self.maxk = max(self.topk)
        self._name = name or "acc"
        self.reset()

    def compute(self, pred, label, *args):
        pred = torch.as_tensor(pred)
        label = torch.as_tensor(label, device=pred.device)
        idx = torch.topk(pred.float(), self.maxk, dim=-1).indices
        label = _labels_like(label, pred)
        return (idx == label[..., None]).to(torch.float32)

    def update(self, correct, *args):
        correct = _np(correct)
        accs = []
        num = int(np.prod(correct.shape[:-1]))
        for k in self.topk:
            c = correct[..., :k].sum()
            accs.append(c / max(num, 1))
            self.total[self.topk.index(k)] += c
            self.count[self.topk.index(k)] += num
        return accs[0] if len(accs) == 1 else accs

    def reset(self):
        self.total = [0.0] * len(self.topk)
        self.count = [0] * len(self.topk)

    def accumulate(self):
        res = [t / max(c, 1) for t, c in zip(self.total, self.count)]
        return res[0] if len(res) == 1 else res

    def name(self):
        if len(self.topk) == 1:
            return [self._name]
        return [f"{self._name}_top{k}" for k in self.topk]


class Precision(Metric):
    """Binary precision (reference: metrics.py:Precision)."""

    def __init__(self, name="precision"):
        super().__init__()
        self._name = name
        self.reset()

    def update(self, preds, labels):
        preds = np.rint(_np(preds)).astype(int).ravel()
        labels = _np(labels).astype(int).ravel()
        self.tp += int(((preds == 1) & (labels == 1)).sum())
        self.fp += int(((preds == 1) & (labels == 0)).sum())

    def reset(self):
        self.tp = 0
        self.fp = 0

    def accumulate(self):
        d = self.tp + self.fp
        return self.tp / d if d else 0.0

    def name(self):
        return self._name


class Recall(Metric):
    """Binary recall (reference: metrics.py:Recall)."""

    def __init__(self, name="recall"):
        super().__init__()
        self._name = name
        self.reset()

    def update(self, preds, labels):
        preds = np.rint(_np(preds)).astype(int).ravel()
        labels = _np(labels).astype(int).ravel()
        self.tp += int(((preds == 1) & (labels == 1)).sum())
        self.fn += int(((preds == 0) & (labels == 1)).sum())

    def reset(self):
        self.tp = 0
        self.fn = 0

    def accumulate(self):
        d = self.tp + self.fn
        return self.tp / d if d else 0.0

    def name(self):
        return self._name


class Auc(Metric):
    """ROC-AUC via thresholded confusion bins (reference: metrics.py:Auc)."""

    def __init__(self, curve="ROC", num_thresholds=4095, name="auc"):
        super().__init__()
        self._name = name
        self.num_thresholds = num_thresholds
        self.reset()

    def update(self, preds, labels):
        preds = _np(preds)
        labels = _np(labels).ravel()
        if preds.ndim == 2:
            preds = preds[:, -1]
        preds = preds.ravel()
        bins = np.clip((preds * self.num_thresholds).astype(int), 0,
                       self.num_thresholds)
        pos = labels.astype(bool)
        n = self.num_thresholds + 1
        self._stat_pos += np.bincount(bins[pos], minlength=n)
        self._stat_neg += np.bincount(bins[~pos], minlength=n)

    def reset(self):
        self._stat_pos = np.zeros(self.num_thresholds + 1)
        self._stat_neg = np.zeros(self.num_thresholds + 1)

    def accumulate(self):
        tot_pos = tot_neg = 0.0
        auc = 0.0
        for i in range(self.num_thresholds, -1, -1):
            p = self._stat_pos[i]
            n = self._stat_neg[i]
            auc += n * tot_pos + p * n / 2
            tot_pos += p
            tot_neg += n
        return auc / (tot_pos * tot_neg) if tot_pos and tot_neg else 0.0

    def name(self):
        return self._name


def accuracy(input, label, k=1, correct=None, total=None, name=None):
    """Functional top-k accuracy (reference: metric/metrics.py accuracy):
    a float32 tensor of shape [1] on `input`'s device."""
    pred = torch.as_tensor(input)
    lab = _labels_like(torch.as_tensor(label, device=pred.device), pred)
    idx = torch.topk(pred.float(), k, dim=-1).indices
    corr = (idx == lab[..., None]).any(-1).to(torch.float32).mean()
    return corr.reshape(1)
