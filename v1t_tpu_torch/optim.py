"""Optimizer construction: AdamW with per-module learning-rate groups.

The port's copy of ``v1t_tpu/optim.py`` ``build_optimizer`` and the
learning-rate helpers, on ``torch.optim.AdamW``: one param group per label
of ``models.param_labels`` ({"core": ``core_lr``, "rest": ``lr``}; reference
model.py:112-139, train.py:217-223). A frozen core (``core_frozen``) or
modules outside ``trainable_modules`` get no group and stop taking
gradients, where the JAX package maps them to ``optax.set_to_zero``.

torch's AdamW computes optax's ``adamw``: bias-corrected moments,
m_hat / (sqrt(v_hat) + eps), and the decoupled weight decay applied to the
parameter before the step (p - lr * wd * p), with ``weight_decay`` given
explicitly (the JAX trainer's default is 0; torch's would be 0.01).
"""

from __future__ import annotations

import typing as t

import torch
from torch import nn

from v1t_tpu_torch.models.model import param_labels


def build_optimizer(config, model: nn.Module, core_frozen: bool = False,
                    trainable_modules: t.Optional[t.List[str]] = None,
                    weight_decay: float = 0.0) -> torch.optim.AdamW:
    """AdamW over the {core, rest} groups; with ``trainable_modules`` (the
    ensemble's output-head-only training) only those top-level modules
    train, at ``lr``."""
    core_lr = config.lr if config.core_lr is None else config.core_lr
    labels = param_labels(model)
    groups: t.Dict[str, list] = {"core": [], "rest": []}
    for name, param in model.named_parameters():
        top = name.split(".")[0]
        if trainable_modules is not None:
            label = "rest" if top in trainable_modules else None
        else:
            label = None if (core_frozen and labels[name] == "core") else labels[name]
        if label is None:
            param.requires_grad_(False)
        else:
            groups[label].append(param)
    lrs = {"core": core_lr, "rest": config.lr}
    param_groups = [
        {"name": label, "params": params, "lr": lrs[label]}
        for label, params in groups.items() if params
    ]
    return torch.optim.AdamW(
        param_groups, betas=(config.adam_beta1, config.adam_beta2), eps=config.adam_eps,
        weight_decay=weight_decay,
    )


def get_learning_rates(optimizer: torch.optim.Optimizer) -> t.Dict[str, float]:
    """Current LR per group (for logging and checkpointing)."""
    return {group["name"]: float(group["lr"]) for group in optimizer.param_groups}


def scale_learning_rates(optimizer: torch.optim.Optimizer, factor: float) -> None:
    """Multiply every group's LR by ``factor`` (the scheduler's plateau
    decay, reference scheduler.py:162-171), in place."""
    for group in optimizer.param_groups:
        group["lr"] = group["lr"] * factor


def set_learning_rates(optimizer: torch.optim.Optimizer, lrs: t.Dict[str, float]) -> None:
    """Force specific per-group LRs (after a checkpoint rollback), in place."""
    for group in optimizer.param_groups:
        if group["name"] in lrs:
            group["lr"] = float(lrs[group["name"]])
