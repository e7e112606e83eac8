"""Training and serving engine of the port: ``Trainer.train_step``,
``validation_step``, ``predict``, ``inference`` and ``compute_metrics``.

Mirrors ``v1t_tpu/training.py`` (reference train.py:42-190): a batch is cut
into micro-batches of ``config.effective_micro_batch_size``, the last one
padded to that size (``pad_batch``) with a 0/1 sample mask so every call
sees one shape. A training step sums the gradients of its micro-batches
(the loss ds-scaled by the FULL batch size, the regularizer weighted by
micro / batch) into the parameters' ``.grad``, accumulates across the mice
of a cycle while ``update`` is false, and takes one AdamW step when it is
true. Every micro-batch is one step of the run's counter: its seed,
``ops.dropout.step_seed(config.seed, step)``, keys every dropout site of the
kernels and seeds the generator of the patch dropout and the readout noise.
The module is put in train or eval mode by each call.

Not ported yet: the whole-cycle dispatch fusion ``train_cycle`` (a CUDA
graph would be its counterpart), the scheduler, the loaders and
``train_epoch`` / ``validate`` / ``evaluate``.
"""

from __future__ import annotations

import typing as t

import numpy as np
import torch

from v1t_tpu_torch import losses
from v1t_tpu_torch.configs import Config
from v1t_tpu_torch.data.cards import DataCard, micro_batching
from v1t_tpu_torch.models.model import Model, model_regularizer
from v1t_tpu_torch.ops.dropout import step_seed
from v1t_tpu_torch.optim import build_optimizer


def pad_batch(batch: t.Dict[str, np.ndarray], batch_size: int):
    """Pad every array in the batch to ``batch_size`` rows and return the
    0/1 sample mask (``v1t_tpu/training.py:53``)."""
    n = len(batch["image"])
    mask = np.zeros(batch_size, np.float32)
    mask[:n] = 1.0
    if n == batch_size:
        return batch, mask
    padded = {}
    for k, v in batch.items():
        if isinstance(v, np.ndarray) and v.ndim >= 1 and len(v) == n:
            pad_width = [(0, batch_size - n)] + [(0, 0)] * (v.ndim - 1)
            padded[k] = np.pad(v, pad_width)
        else:
            padded[k] = v
    return padded, mask


class Trainer:
    """Owns the model on ``device``, its AdamW optimizer and criterion, and
    runs them on host batches (``v1t_tpu/training.py`` ``Trainer``)."""

    def __init__(self, config: Config, model: Model, data_card: DataCard,
                 device: t.Union[str, torch.device] = "cuda", core_frozen: bool = False,
                 trainable_modules: t.Optional[t.List[str]] = None,
                 weight_decay: float = 0.0):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Trainer: device 'cuda' requested but no CUDA device is visible")
        self.config, self.data_card = config, data_card
        self.core_frozen = core_frozen
        self.model = model.to(self.device).eval()
        self.criterion = losses.get_criterion(config, data_card.ds_sizes)
        self.optimizer = build_optimizer(config, self.model, core_frozen=core_frozen,
                                         trainable_modules=trainable_modules,
                                         weight_decay=weight_decay)
        self._step_count = 0

    def _tensor(self, array: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(array, dtype=np.float32)).to(self.device)

    def _loss_terms(self, mouse_id: str, batch: t.Dict[str, np.ndarray], mask: np.ndarray,
                    batch_size: int, reg_weight: float, seed: t.Optional[int] = None,
                    sample: t.Optional[bool] = None):
        """One micro-batch's (loss, weighted regularizer, predictions);
        ``batch_size`` is the FULL batch size for the ds scaling and
        ``reg_weight`` the micro / batch fraction (reference train.py:65-72)."""
        y_pred, _, _ = self.model(
            self._tensor(batch["image"]), mouse_id,
            behaviors=self._tensor(batch["behavior"]),
            pupil_centers=self._tensor(batch["pupil_center"]), seed=seed, sample=sample,
        )
        loss = self.criterion(y_true=self._tensor(batch["response"]), y_pred=y_pred,
                              mouse_id=mouse_id, batch_size=batch_size,
                              mask=self._tensor(mask))
        reg = model_regularizer(self.config, self.model, mouse_id, core_frozen=self.core_frozen)
        return loss, reg_weight * reg, y_pred

    def train_step(self, mouse_id: str, batch: t.Dict[str, np.ndarray], acc_grads,
                   update: bool, *, sample: t.Optional[bool] = None):
        """Gradient step over one mouse's host batch (reference train_step,
        train.py:42-81). The gradients of its micro-batches are added to
        those accumulated so far (``acc_grads`` None: start from zero); with
        ``update`` AdamW steps on the sum and None is returned for the next
        cycle, otherwise the accumulated gradients (the parameters' ``.grad``
        by name). ``sample`` switches the readout's grid noise (default on).
        Returns (acc_grads, metrics summed over the micro-batches, as 0-dim
        tensors on the device)."""
        self.model.train()
        if acc_grads is None:
            self.optimizer.zero_grad(set_to_none=True)
        micro = self.config.effective_micro_batch_size
        true_total = len(batch["image"])
        metrics: t.Dict[str, torch.Tensor] = {}
        for micro_batch in micro_batching(batch, micro):
            n = len(micro_batch["image"])
            padded, mask = pad_batch(micro_batch, micro)
            self._step_count += 1
            loss, reg_loss, _ = self._loss_terms(
                mouse_id, padded, mask, true_total, n / true_total,
                seed=step_seed(self.config.seed, self._step_count), sample=sample,
            )
            total = loss + reg_loss
            total.backward()
            for key, value in (("loss/loss", loss), ("loss/reg_loss", reg_loss),
                               ("loss/total_loss", total)):
                metrics[key] = metrics.get(key, 0.0) + value.detach()
        if not update:
            return {name: p.grad for name, p in self.model.named_parameters()
                    if p.grad is not None}, metrics
        # a parameter this cycle did not reach steps with a zero gradient, as
        # optax's does (its moments decay)
        for group in self.optimizer.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
        return None, metrics

    @torch.no_grad()
    def validation_step(self, mouse_id: str, batch: t.Dict[str, np.ndarray]):
        """Eval-mode losses over one mouse's batch: (metrics as floats,
        targets, predictions)."""
        self.model.eval()
        micro = self.config.effective_micro_batch_size
        true_total = len(batch["image"])
        sums: t.Dict[str, float] = {}
        targets, predictions = [], []
        for micro_batch in micro_batching(batch, micro):
            n = len(micro_batch["image"])
            padded, mask = pad_batch(micro_batch, micro)
            loss, reg_loss, y_pred = self._loss_terms(mouse_id, padded, mask, true_total,
                                                      n / true_total)
            for key, value in (("loss/loss", loss), ("loss/reg_loss", reg_loss),
                               ("loss/total_loss", loss + reg_loss)):
                sums[key] = sums.get(key, 0.0) + float(value)
            targets.append(micro_batch["response"])
            predictions.append(y_pred[:n].cpu().numpy())
        return sums, np.concatenate(targets), np.concatenate(predictions)

    @torch.inference_mode()
    def predict(self, mouse_id: str, batch: t.Dict[str, np.ndarray]) -> np.ndarray:
        """(B, N) float32 responses for a host batch with ``image``,
        ``behavior`` and ``pupil_center``."""
        self.model.eval()
        micro = self.config.effective_micro_batch_size
        outs = []
        for micro_batch in micro_batching(batch, micro):
            n = len(micro_batch["image"])
            padded, _ = pad_batch(micro_batch, micro)
            y_pred, _, _ = self.model(
                self._tensor(padded["image"]), mouse_id,
                behaviors=self._tensor(padded["behavior"]),
                pupil_centers=self._tensor(padded["pupil_center"]),
            )
            outs.append(y_pred[:n].cpu().numpy())
        return np.concatenate(outs)


def compute_metrics(y_true: np.ndarray, y_pred: np.ndarray) -> dict:
    """Per-epoch validation metrics (reference train.py:28-39)."""
    m = float(np.sum(np.square(y_true - y_pred)))
    pl = float(np.sum(y_pred - y_true * np.log(y_pred + 1e-12)))
    corr = losses.correlation(y_pred, y_true, dim=0)
    return {
        "metrics/msse": m,
        "metrics/poisson_loss": pl,
        "metrics/single_trial_correlation": float(np.mean(corr)),
    }


def inference(trainer: Trainer, batches: t.Iterable[dict], mouse_id: str) -> t.Dict[str, np.ndarray]:
    """Forward pass over every batch (reference utils/utils.py:59-100):
    predictions, plus the batches' targets, image and trial ids where the
    batches carry them."""
    results: dict = {"predictions": [], "targets": [], "trial_ids": [], "image_ids": []}
    sources = {"targets": "response", "trial_ids": "trial_id", "image_ids": "image_id"}
    for batch in batches:
        results["predictions"].append(trainer.predict(mouse_id, batch))
        for key, field in sources.items():
            if field in batch:
                results[key].append(batch[field])
    return {k: np.concatenate(v, axis=0) for k, v in results.items() if v}
