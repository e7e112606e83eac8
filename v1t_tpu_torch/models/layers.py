"""Small helpers shared by the port's modules."""

from __future__ import annotations

import typing as t

import torch
import torch.nn.functional as F
from torch import nn


def linear(x: torch.Tensor, layer: nn.Linear, dtype: t.Optional[torch.dtype]) -> torch.Tensor:
    """``layer(x)`` computed in ``dtype`` (inputs, weight and bias cast), as
    a flax ``Dense(dtype=...)`` with float32 parameters computes it."""
    dt = dtype or torch.float32
    bias = None if layer.bias is None else layer.bias.to(dt)
    return F.linear(x.to(dt), layer.weight.to(dt), bias)


def run_mlp(x: torch.Tensor, mlp: nn.Sequential, dtype: t.Optional[torch.dtype]) -> torch.Tensor:
    """Apply a Sequential of Linear layers and activations in ``dtype``."""
    for layer in mlp:
        x = linear(x, layer, dtype) if isinstance(layer, nn.Linear) else layer(x)
    return x


def torch_default_init_(layer: nn.Linear, generator: torch.Generator) -> None:
    """torch's default nn.Linear init, U(+-1/sqrt(fan_in)) for the weight
    (kaiming_uniform with a=sqrt(5)) and the bias, drawn from ``generator``."""
    bound = layer.in_features ** -0.5
    with torch.no_grad():
        layer.weight.uniform_(-bound, bound, generator=generator)
        if layer.bias is not None:
            layer.bias.uniform_(-bound, bound, generator=generator)


def trunc_normal_init_(layer: nn.Linear, generator: torch.Generator, std: float = 0.02) -> None:
    """The reference Transformer init: trunc_normal(std) weights (cut at
    two standard deviations), zero bias (reference vit.py:338-346)."""
    with torch.no_grad():
        nn.init.trunc_normal_(layer.weight, std=std, a=-2 * std, b=2 * std, generator=generator)
        if layer.bias is not None:
            layer.bias.zero_()
