"""Attention rollout (https://arxiv.org/abs/2005.00928) of the V1T core, the
port's copy of ``v1t_tpu/analysis/attention_rollout.py`` (reference
src/v1t/utils/attention_rollout.py).

The core exports its post-softmax probabilities through ``return_probs``,
which sends every block through the composed attention's einsum form (the
kernels never hold the probabilities); the sublayers' other kernels run as
on any forward. Rollout math, in numpy as the JAX package's: max over heads
-> + identity -> row-normalise -> product across blocks -> CLS row ->
reshape by ``find_shape`` -> min-max normalise -> bilinear resize to the
image's shape.
"""

from __future__ import annotations

import typing as t

import numpy as np
import torch

from v1t_tpu_torch.ops.common import find_shape
from v1t_tpu_torch.ops.grid_sample import resize_bilinear
from v1t_tpu_torch.training import as_tensor


def normalize(x: np.ndarray) -> np.ndarray:
    return (x - x.min()) / (x.max() - x.min())


def attention_rollout(attention: np.ndarray, image_shape: t.Sequence[int]) -> np.ndarray:
    """One sample: (blocks, heads, P, P) softmax probabilities -> (H, W)
    heatmap."""
    assert attention.ndim == 4
    attention = attention.max(axis=1)  # max over heads: (blocks, P, P)
    # the residual connections: add identity, re-normalise the rows
    aug = attention + np.eye(attention.shape[1], dtype=attention.dtype)
    aug = aug / aug.sum(axis=-1, keepdims=True)
    joint = aug[0]
    for n in range(1, aug.shape[0]):
        joint = aug[n] @ joint
    heatmap = joint[0, 1:]  # CLS row, without the CLS column
    heatmap = normalize(heatmap.reshape(find_shape(len(heatmap))))
    resized = resize_bilinear(torch.from_numpy(np.asarray(heatmap, np.float32))[None, None],
                              *image_shape)
    return resized[0, 0].numpy()


def attention_rollouts(attentions: np.ndarray, image_shape: t.Sequence[int]) -> np.ndarray:
    """(B, blocks, heads, P, P) -> (B, H, W) heatmaps."""
    assert attentions.ndim == 5
    return np.stack([attention_rollout(a, image_shape=image_shape) for a in attentions])


def extract_attention_maps(loader, model, num_samples: t.Optional[int] = None
                           ) -> t.Dict[str, np.ndarray]:
    """Rollout maps for the samples of a loader (reference
    attention_rollout.py:136-201): the cropper, then the core with its
    probabilities, in eval mode under ``torch.inference_mode`` on the
    model's device, a batch at a time (a flagship batch of 16 holds ~2.8 GB
    of float32 probabilities); images, behaviors and pupil centers come back
    un-standardised."""
    ds = loader.dataset
    mouse_id = ds.mouse_id
    device = next(model.parameters()).device
    model.eval()
    results: dict = {"images": [], "heatmaps": [], "pupil_centers": [], "behaviors": []}
    count = num_samples
    for batch in loader:
        images, behaviors, pupils = (as_tensor(batch[k]).to(device)
                                     for k in ("image", "behavior", "pupil_center"))
        with torch.inference_mode():
            cropped, _ = model.crop(images, mouse_id, behaviors, pupils)
            _, probs = model.core_forward(cropped, mouse_id, behaviors, pupils,
                                          return_probs=True)
            cropped, probs = cropped.float().cpu().numpy(), probs.float().cpu().numpy()
        results["heatmaps"].append(attention_rollouts(probs, image_shape=cropped.shape[2:]))
        del probs
        results["images"].append(ds.i_transform_image(cropped))
        results["behaviors"].append(ds.i_transform_behavior(np.asarray(batch["behavior"])))
        results["pupil_centers"].append(
            ds.i_transform_pupil_center(np.asarray(batch["pupil_center"])))
        if num_samples is not None and (count := count - len(cropped)) <= 0:
            break
    results = {k: np.vstack(v) for k, v in results.items()}
    if num_samples is not None:
        results = {k: v[:num_samples] for k, v in results.items()}
    return results
