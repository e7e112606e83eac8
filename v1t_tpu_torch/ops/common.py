"""Shared compute primitives: activations and patch extraction."""

from __future__ import annotations

import math
import typing as t

import torch
import torch.nn.functional as F


def elu1(x: torch.Tensor) -> torch.Tensor:
    """ELU(x) + 1 — keeps predicted firing rates positive (reference
    src/v1t/models/utils.py:109-118)."""
    return F.elu(x) + 1.0


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
