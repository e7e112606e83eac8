"""Shared compute primitives: activations, stochastic depth and patch
extraction."""

from __future__ import annotations

import math
import typing as t

import torch
import torch.nn.functional as F


def elu1(x: torch.Tensor) -> torch.Tensor:
    """ELU(x) + 1 — keeps predicted firing rates positive (reference
    src/v1t/models/utils.py:109-118)."""
    return F.elu(x) + 1.0


def drop_path_mask(batch: int, rate: float, generator: t.Optional[torch.Generator],
                   device) -> torch.Tensor:
    """Stochastic depth's keep mask: one Bernoulli(1 - rate) draw per sample,
    (B,) bool, from ``generator`` (the step's; reference
    src/v1t/models/utils.py:121-141)."""
    return torch.rand((batch,), generator=generator, device=device) >= rate


def drop_path(x: torch.Tensor, rate: float, keep: torch.Tensor) -> torch.Tensor:
    """Drop whole residual branches per sample: ``x / (1 - rate)`` where
    ``keep`` (B,) holds, zero elsewhere, in x's dtype (``v1t_tpu/ops/
    common.py`` ``drop_path``)."""
    keep = keep.view((-1,) + (1,) * (x.ndim - 1))
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


def patch_shift(images: torch.Tensor, patch_size: int) -> torch.Tensor:
    """Shifted Patch Tokenization: the image and its four diagonal
    half-patch shifts (zero padded), concatenated along channels
    (reference vit.py:15-38; ``v1t_tpu/models/cores/vit.py`` ``patch_shift``)."""
    shift = patch_size // 2
    padded = F.pad(images, (shift, shift, shift, shift))
    s2 = 2 * shift
    return torch.cat([images, padded[..., :-s2, :-s2], padded[..., :-s2, s2:],
                      padded[..., s2:, :-s2], padded[..., s2:, s2:]], dim=1)


def unfold_patches(images: torch.Tensor, patch_size: int, stride: int) -> torch.Tensor:
    """(B, C, H, W) -> (B, L, C * p * p) patches, feature axis ordered
    channel-major (c, ph, pw) — ``nn.Unfold`` followed by
    ``Rearrange('b c l -> b l c')`` as in the reference tokenizer
    (src/v1t/models/core/vit.py:67-71)."""
    return F.unfold(images, kernel_size=patch_size, stride=stride).transpose(1, 2)


def find_shape(num_patches: int) -> t.Tuple[int, int]:
    """Largest factor pair (h, w) with h <= sqrt(n) — the reference's latent
    feature-map factorization (src/v1t/models/core/vit.py:411-417);
    1653 -> (29, 57)."""
    dim1 = math.ceil(math.sqrt(num_patches))
    while num_patches % dim1 != 0 and dim1 > 0:
        dim1 -= 1
    return dim1, num_patches // dim1


def unfold_output_size(size: int, patch_size: int, stride: int, padding: int = 0) -> int:
    return (size + 2 * padding - patch_size) // stride + 1
