"""Gaussian2d readout — per-neuron Gaussian grid locations over the core
feature map, sampled bilinearly (the flagship readout), forward (eval).

Mirrors ``v1t_tpu/models/readouts/gaussian2d.py`` and the reference
src/v1t/models/readout/gaussian2d.py, with its state_dict keys:
- mu predicted from the neurons' anatomical coordinates through
  Linear(2or3 -> 30) -> ELU -> Linear(30 -> 2) -> Tanh, or a free ``_mu``
  parameter (straight-through clamp to [-1, 1]);
- a full 2x2 sigma per neuron (the only Gaussian type the model builds;
  unused at eval) and a bias initialised from the response statistics;
- at eval the grid is clamp(mu, -1, 1) (no sampling noise), shifted by the
  core shifter's output;
- bilinear align_corners=True sampling of the channel-major core map
  (``ops/interp_matmul.py``), the per-neuron feature product over channels
  and the bias.

Dispatch: with ``readout_impl`` "auto" the sampling launches the CUDA kernel
on a CUDA tensor, which takes a bf16 core map only and raises on another
dtype, and runs the plain version on a CPU tensor. "xla" selects the plain
version on any device: the reference the kernel is held against on the card.
"""

from __future__ import annotations

import typing as t

import numpy as np
import torch
from torch import nn

from v1t_tpu_torch.data.cards import NeuronCard
from v1t_tpu_torch.models.layers import torch_default_init_
from v1t_tpu_torch.models.registry import register_readout
from v1t_tpu_torch.ops.interp_matmul import bilinear_sample_cm, bilinear_sample_cm_plain


def straight_through_clamp(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """Clamp values while letting gradients pass unclamped (reference
    gaussian2d.py:212-215, the in-place no_grad mu.clamp_)."""
    return x + (x.clamp(lo, hi) - x).detach()


INIT_MU_RANGE = 0.3  # the reference's defaults (gaussian2d.py)
INIT_SIGMA = 0.1


@register_readout("gaussian2d")
class Gaussian2DReadout(nn.Module):
    def __init__(self, input_shape: t.Tuple[int, int, int], neuron_card: NeuronCard,
                 use_grid_predictor: bool = True, grid_predictor_dim: int = 2,
                 bias_mode: int = 0, impl: str = "auto"):
        super().__init__()
        n = neuron_card.num_neurons
        c = input_shape[0]
        self.num_neurons, self.impl = n, impl
        self.sigma = nn.Parameter(torch.zeros(1, n, 2, 2))
        self.features = nn.Parameter(torch.full((1, c, 1, n), 1.0 / c))
        if bias_mode == 0:
            value = np.zeros(n, np.float32)
        elif bias_mode == 1:
            value = np.asarray(neuron_card.response_mean, np.float32)
        elif bias_mode == 2:
            value = np.asarray(neuron_card.response_mean / neuron_card.response_std, np.float32)
        else:
            raise NotImplementedError(f"Gaussian2dReadout: bias mode {bias_mode}")
        self.bias = nn.Parameter(torch.from_numpy(value.copy()))
        self.use_grid_predictor = use_grid_predictor
        if use_grid_predictor:
            source = np.asarray(neuron_card.coordinates[:, :grid_predictor_dim], np.float32)
            source = source - source.mean(axis=0, keepdims=True)
            source = source / np.abs(source).max()
            self.register_buffer("source_grid", torch.from_numpy(source), persistent=False)
            self.mu_transform = nn.Sequential(
                nn.Linear(grid_predictor_dim, 30), nn.ELU(), nn.Linear(30, 2), nn.Tanh()
            )
        else:
            self._mu = nn.Parameter(torch.zeros(1, n, 1, 2))

    def mu(self) -> torch.Tensor:
        """(1, N, 1, 2) grid means in [-1, 1]."""
        if self.use_grid_predictor:
            return self.mu_transform(self.source_grid).reshape(1, self.num_neurons, 1, 2)
        return straight_through_clamp(self._mu, -1.0, 1.0)

    def forward(self, inputs: torch.Tensor, shifts: t.Optional[torch.Tensor] = None) -> torch.Tensor:
        """inputs (B, C, h, w) core map -> (B, N) responses (before ELU+1)."""
        b, c, h, w = inputs.shape
        grid = self.mu().clamp(-1.0, 1.0).expand(b, -1, -1, -1)
        if shifts is not None:
            grid = grid + shifts.float()[:, None, None, :]
        grid = grid.reshape(b, self.num_neurons, 2).contiguous()
        flat = inputs.reshape(b, c, h * w).contiguous()
        sample = bilinear_sample_cm_plain if self.impl == "xla" else bilinear_sample_cm
        sampled = sample(flat, grid, h, w)  # (B, C, N)
        out = torch.einsum("bcn,cn->bn", sampled.float(), self.features.reshape(c, -1))
        return out + self.bias

    def init_weights(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.sigma.uniform_(-INIT_SIGMA, INIT_SIGMA, generator=generator)
            self.features.fill_(1.0 / self.features.shape[1])
            if self.use_grid_predictor:
                torch_default_init_(self.mu_transform[0], generator)
                torch_default_init_(self.mu_transform[2], generator)
            else:
                self._mu.uniform_(-INIT_MU_RANGE, INIT_MU_RANGE, generator=generator)
