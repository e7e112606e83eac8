"""Training criteria: Poisson (the default), MSSE, correlation.

A PyTorch copy of ``v1t_tpu/losses.py`` with the reference's semantics
(src/v1t/losses.py):
- ``msse``: sum over neurons of the squared error, summed (or averaged)
  over the batch;
- ``poisson_loss``: sum(y_pred - y_true * log(y_pred + eps)); the
  ``PoissonLoss`` criterion adds float32 eps to BOTH targets and predictions
  before the log;
- ``correlation``: both arrays standardised with the biased std + eps, then
  the mean of the product (numpy in, numpy out; torch in, torch out);
- dataset scaling: loss * sqrt(len(dataset) / batch_size) per mouse when
  ``ds_scale``, with batch_size the FULL batch under micro-batching.
Every criterion takes an optional per-sample 0/1 ``mask`` over the batch, so
a padded batch gives the loss of its real rows.
"""

from __future__ import annotations

import typing as t

import numpy as np
import torch

EPS = float(np.finfo(np.float32).eps)

_CRITERION: t.Dict[str, type] = {}


def register(name: str):
    def add_to_dict(cls):
        _CRITERION[name] = cls
        return cls

    return add_to_dict


def msse(y_true: torch.Tensor, y_pred: torch.Tensor, reduction: str = "sum") -> torch.Tensor:
    """Mean sum squared error: sum over neurons, reduce over the batch."""
    loss = torch.sum(torch.square(y_true - y_pred), dim=-1)
    return loss.sum() if reduction == "sum" else loss.mean()


def poisson_loss(y_true: torch.Tensor, y_pred: torch.Tensor, eps: float = 1e-12,
                 reduction: str = "sum") -> torch.Tensor:
    loss = torch.sum(y_pred - y_true * torch.log(y_pred + eps), dim=-1)
    return loss.sum() if reduction == "sum" else loss.mean()


def correlation(y1, y2, dim: int = -1, eps: float = 1e-8):
    """Pearson correlation along ``dim`` (biased std)."""
    if isinstance(y1, np.ndarray):
        y1 = (y1 - y1.mean(axis=dim, keepdims=True)) / (y1.std(axis=dim, keepdims=True) + eps)
        y2 = (y2 - y2.mean(axis=dim, keepdims=True)) / (y2.std(axis=dim, keepdims=True) + eps)
        return (y1 * y2).mean(axis=dim)
    y1 = (y1 - y1.mean(dim, keepdim=True)) / (y1.std(dim, unbiased=False, keepdim=True) + eps)
    y2 = (y2 - y2.mean(dim, keepdim=True)) / (y2.std(dim, unbiased=False, keepdim=True) + eps)
    return (y1 * y2).mean(dim)


class Loss:
    """Base criterion with the per-mouse dataset-size scaling."""

    def __init__(self, config, ds_sizes: t.Dict[str, int]):
        self.ds_scale = bool(config.ds_scale)
        self.ds_sizes = {k: float(v) for k, v in ds_sizes.items()}

    def scale_ds(self, loss: torch.Tensor, mouse_id: str, batch_size) -> torch.Tensor:
        if self.ds_scale:
            loss = loss * (self.ds_sizes[mouse_id] / float(batch_size)) ** 0.5
        return loss

    def __call__(self, y_true, y_pred, mouse_id: str, batch_size=None, mask=None):
        raise NotImplementedError


def _masked_sum(per_sample: torch.Tensor, mask) -> torch.Tensor:
    return per_sample.sum() if mask is None else (per_sample * mask).sum()


def _batch_size(y_true, batch_size, mask):
    if batch_size is not None:
        return batch_size
    if mask is not None:
        return float(mask.sum())
    return y_true.shape[0]


@register("msse")
class MSSE(Loss):
    def __call__(self, y_true, y_pred, mouse_id: str, batch_size=None, mask=None):
        batch_size = _batch_size(y_true, batch_size, mask)
        loss = _masked_sum(torch.sum(torch.square(y_true - y_pred), dim=-1), mask)
        return self.scale_ds(loss, mouse_id=mouse_id, batch_size=batch_size)


@register("poisson")
class PoissonLoss(Loss):
    def __init__(self, config, ds_sizes, eps: float = EPS):
        super().__init__(config, ds_sizes)
        self.eps = eps

    def __call__(self, y_true, y_pred, mouse_id: str, batch_size=None, mask=None):
        batch_size = _batch_size(y_true, batch_size, mask)
        y_true = y_true + self.eps
        y_pred = y_pred + self.eps
        per_sample = torch.sum(y_pred - y_true * torch.log(y_pred), dim=-1)
        return self.scale_ds(_masked_sum(per_sample, mask), mouse_id=mouse_id,
                             batch_size=batch_size)


@register("correlation")
class Correlation(Loss):
    """num_neurons - sum of the per-neuron correlations over the batch."""

    def __init__(self, config, ds_sizes, eps: float = EPS):
        super().__init__(config, ds_sizes)
        self.eps = eps

    def __call__(self, y_true, y_pred, mouse_id: str, batch_size=None, mask=None):
        batch_size = _batch_size(y_true, batch_size, mask)
        num_neurons = y_true.shape[1]
        if mask is None:
            corr = correlation(y_true, y_pred, dim=0, eps=self.eps)
        else:
            w = mask[:, None] / mask.sum()

            def standardize(y):
                mean = torch.sum(y * w, dim=0, keepdim=True)
                var = torch.sum(w * torch.square(y - mean), dim=0, keepdim=True)
                return (y - mean) / (torch.sqrt(var) + self.eps)

            corr = torch.sum(standardize(y_true) * standardize(y_pred) * w, dim=0)
        loss = num_neurons - corr.sum()
        return self.scale_ds(loss, mouse_id=mouse_id, batch_size=batch_size)


def get_criterion(config, ds_sizes: t.Dict[str, int]) -> Loss:
    """The criterion named by ``config.criterion``; ``ds_sizes`` maps each
    mouse to its number of training trials."""
    if config.criterion not in _CRITERION:
        raise ValueError(f"criterion {config.criterion!r} not found; have {sorted(_CRITERION)}")
    return _CRITERION[config.criterion](config, ds_sizes)
