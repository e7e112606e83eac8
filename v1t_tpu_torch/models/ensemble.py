"""Ensemble of trained runs with a learnable output head, the port's copy
of ``v1t_tpu/models/ensemble.py`` (reference ensemble.py:31-151).

``EnsembleModel`` holds the runs' ``Model``s in ``ensemble`` (by name; each
restored from its own run directory and frozen) and an ``OutputModule``
(``output_module``): the sub-models run in eval mode without the ELU+1
(``activate=False``) and under ``torch.no_grad``, their outputs stack on a
trailing model axis, and the head combines them: mode 0 the average, 1 one
shared Linear over the model axis, 2 one Linear a mouse, then ELU+1
(reference ensemble.py:68-83). Only the head trains, so no backward kernel
runs (the JAX package differentiates through the sub-models and masks
their update; the result is the same). The state_dict keys are the
reference's: ``ensemble.<name>.<Model key>``, ``output_module.linear.*``
(mode 1) and ``output_module.linear.<mouse>.*`` (mode 2).
"""

from __future__ import annotations

import os
import typing as t

import torch
from torch import nn

from v1t_tpu_torch.configs import Config, load_args
from v1t_tpu_torch.data.cards import DataCard
from v1t_tpu_torch.models.layers import trunc_normal_init_
from v1t_tpu_torch.models.model import Model, compute_dtype
from v1t_tpu_torch.ops.common import elu1
from v1t_tpu_torch.utils.scheduler import CKPT_NAME, load_checkpoint_file


class OutputModule(nn.Module):
    """ensemble_mode 0: average / 1: shared Linear / 2: per-mouse Linear,
    over the model axis, then ELU+1."""

    def __init__(self, ensemble_mode: int, in_features: int, mouse_ids: t.Sequence[str]):
        super().__init__()
        if ensemble_mode not in (0, 1, 2):
            raise ValueError(f"ensemble_mode {ensemble_mode} not in (0, 1, 2)")
        self.ensemble_mode = ensemble_mode
        if ensemble_mode == 1:
            self.linear = nn.Linear(in_features, 1)
        elif ensemble_mode == 2:
            self.linear = nn.ModuleDict({m: nn.Linear(in_features, 1) for m in mouse_ids})

    def forward(self, inputs: torch.Tensor, mouse_id: str) -> torch.Tensor:
        """(B, N, models) -> (B, N)."""
        if self.ensemble_mode == 0:
            outputs = inputs.mean(dim=-1)
        else:
            layer = self.linear if self.ensemble_mode == 1 else self.linear[mouse_id]
            outputs = layer(inputs)[..., 0]
        return elu1(outputs)

    def init_weights(self, generator: torch.Generator) -> None:
        """trunc_normal(0.02) weights and zero biases, as the JAX package's
        head."""
        for layer in self.modules():
            if isinstance(layer, nn.Linear):
                trunc_normal_init_(layer, generator)


class EnsembleModel(nn.Module):
    def __init__(self, model_configs: t.Sequence[t.Tuple[str, Config]], data_card: DataCard,
                 ensemble_mode: int = 0):
        super().__init__()
        self.data_card = data_card
        self.ensemble = nn.ModuleDict({
            name: Model(cfg, data_card, dtype=compute_dtype(cfg)) for name, cfg in model_configs
        })
        self.output_module = OutputModule(ensemble_mode, len(model_configs), data_card.mouse_ids)

    def train(self, mode: bool = True) -> "EnsembleModel":
        """The sub-models stay in eval mode (reference ensemble.py:104)."""
        super().train(mode)
        self.ensemble.eval()
        return self

    def forward(self, inputs: torch.Tensor, mouse_id: str, behaviors: torch.Tensor,
                pupil_centers: torch.Tensor, seed: t.Optional[int] = None,
                sample: t.Optional[bool] = None):
        """(responses (B, N), None, None), the ``Model`` forward's contract;
        ``seed`` and ``sample`` (the trainer's) go unused: the sub-models run
        un-activated, in eval, without a seed."""
        with torch.no_grad():
            outs = [model(inputs, mouse_id, behaviors, pupil_centers, activate=False)[0]
                    for model in self.ensemble.values()]
        return self.output_module(torch.stack(outs, dim=-1), mouse_id), None, None


def ensemble_regularizer(model: nn.Module, mouse_id: str) -> torch.Tensor:
    """The ensemble has no regularizer (reference ensemble.py:128-129)."""
    return torch.zeros((), device=next(model.parameters()).device)


def build_ensemble(config: Config, saved_models: t.Dict[str, str], data_card: DataCard,
                   device: t.Union[str, torch.device] = "cuda") -> EnsembleModel:
    """The ensemble on ``device`` in eval mode: each run's ``args.yaml``
    replayed with the ensemble's ``precision`` and ``attention_impl``, its
    best checkpoint (``ckpt/model_state.pt``) loaded where its keys meet the
    model's (a partial update, reference ensemble.py:116-121), the
    sub-models frozen; the head drawn from ``config.seed``."""
    model_configs = []
    for name, output_dir in saved_models.items():
        sub = load_args(output_dir)
        sub.precision, sub.attention_impl = config.precision, config.attention_impl
        model_configs.append((name, sub))
    model = EnsembleModel(model_configs, data_card, ensemble_mode=config.ensemble_mode)
    model.output_module.init_weights(torch.Generator().manual_seed(config.seed))
    for name, output_dir in saved_models.items():
        filename = os.path.join(output_dir, "ckpt", CKPT_NAME)
        if not os.path.exists(filename):
            raise FileNotFoundError(f"Cannot find {filename}.")
        ckpt = load_checkpoint_file(filename)
        sub = model.ensemble[name]
        own = sub.state_dict()
        sub.load_state_dict({k: v for k, v in ckpt["model"].items() if k in own}, strict=False)
        if getattr(config, "verbose", 1):
            print(f"Loaded checkpoint from {output_dir} (correlation: {float(ckpt['value']):.04f}).")
    model.ensemble.requires_grad_(False)
    return model.to(device).eval()
