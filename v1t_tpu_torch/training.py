"""Serving engine of the port: ``Trainer.predict`` and ``inference``.

Mirrors the eval side of ``v1t_tpu/training.py``: a batch is cut into
micro-batches of ``config.effective_micro_batch_size``, the last one padded
to that size (``pad_batch``) so every call sees one shape, and the padded
rows are dropped from the result. The optimizer, the losses and the training
steps come with the training slice.
"""

from __future__ import annotations

import typing as t

import numpy as np
import torch

from v1t_tpu_torch.configs import Config
from v1t_tpu_torch.data.cards import DataCard, micro_batching
from v1t_tpu_torch.models.model import Model


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
    """Owns the model on ``device`` and runs it on host batches."""

    def __init__(self, config: Config, model: Model, data_card: DataCard,
                 device: t.Union[str, torch.device] = "cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Trainer: device 'cuda' requested but no CUDA device is visible")
        self.config, self.data_card = config, data_card
        self.model = model.to(self.device).eval()

    def _tensor(self, array: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(array, dtype=np.float32)).to(self.device)

    @torch.inference_mode()
    def predict(self, mouse_id: str, batch: t.Dict[str, np.ndarray]) -> np.ndarray:
        """(B, N) float32 responses for a host batch with ``image``,
        ``behavior`` and ``pupil_center``."""
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
