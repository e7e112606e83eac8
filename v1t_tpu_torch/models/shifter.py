"""Per-mouse core shifters: pupil center -> (dx, dy) readout-grid shift,
applied inside the Gaussian2d readout (reference
src/v1t/models/core_shifter.py: an MLP 2 -> 5 -> 5 -> 2, Tanh after every
layer, one per mouse)."""

from __future__ import annotations

import typing as t

import torch
from torch import nn

from v1t_tpu_torch.models.layers import run_mlp, torch_default_init_


def _mlp(in_features: int, hidden: int, num_layers: int) -> nn.Sequential:
    layers = []
    for _ in range(num_layers - 1):
        layers += [nn.Linear(in_features, hidden), nn.Tanh()]
        in_features = hidden
    layers += [nn.Linear(in_features, 2), nn.Tanh()]
    return nn.Sequential(*layers)


class CoreShifter(nn.Module):
    def __init__(self, hidden_features: int = 5, num_layers: int = 3, dtype=None):
        super().__init__()
        self.dtype = dtype
        self.mlp = _mlp(2, hidden_features, num_layers)

    def forward(self, pupil_centers: torch.Tensor) -> torch.Tensor:
        return run_mlp(pupil_centers, self.mlp, self.dtype)

    def init_weights(self, generator: torch.Generator) -> None:
        for layer in self.mlp:
            if isinstance(layer, nn.Linear):
                torch_default_init_(layer, generator)


class CoreShifters(nn.ModuleDict):
    """One CoreShifter per mouse, keyed by mouse id (the reference's
    ``core_shifter.<mouse>.mlp.*`` state_dict keys)."""

    def __init__(self, mouse_ids: t.Sequence[str], hidden_features: int = 5,
                 num_layers: int = 3, dtype=None):
        super().__init__({
            m: CoreShifter(hidden_features, num_layers, dtype) for m in mouse_ids
        })

    def forward(self, pupil_centers: torch.Tensor, mouse_id: str) -> torch.Tensor:
        return self[mouse_id](pupil_centers)
