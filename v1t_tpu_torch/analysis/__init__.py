"""Interpretability of the port: attention rollout of the ViT core."""

from v1t_tpu_torch.analysis.attention_rollout import (
    attention_rollout,
    attention_rollouts,
    extract_attention_maps,
)

__all__ = ["attention_rollout", "attention_rollouts", "extract_attention_maps"]
