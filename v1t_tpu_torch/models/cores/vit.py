"""V1T core — the flagship Vision Transformer with per-block behavior
modulation, forward (eval) path.

Mirrors ``v1t_tpu/models/cores/vit.py`` and the reference
src/v1t/models/core/vit.py, with the reference's torch ``state_dict`` keys:
- ``Image2Patches`` (patch mode 0: unfold -> Linear), CLS token and a
  learnable positional embedding added to every token;
- per block: ``BehaviorMLP`` latent (behavior modes 2-4), the pre-LN
  attention sublayer (``ops/fused_mha.py``) and the pre-LN MLP sublayer
  (``ops/fused_mlp.py``), each emitting sublayer(x) + x;
- output: drop CLS and reshape the tokens to a (C, h, w) map (the largest
  factor pair of the patch count; 1653 -> 29 x 57).

Dispatch: with ``attention_impl`` "auto" the sublayers launch the CUDA
kernels on a CUDA tensor, which take bf16 only and raise on another dtype,
and run their plain versions on a CPU tensor. "xla" selects the plain
composed path on any device: the reference the kernel path is held against
on the card. The behavior latent enters the attention sublayer as its
``bias_row`` and the residual it emits is x + latent, the JAX package's
fold_residual form.
"""

from __future__ import annotations

import typing as t

import torch
from torch import nn

from v1t_tpu_torch.models.layers import linear, run_mlp, torch_default_init_, trunc_normal_init_
from v1t_tpu_torch.models.registry import register_core
from v1t_tpu_torch.ops.common import find_shape, unfold_output_size, unfold_patches
from v1t_tpu_torch.ops.fused_mha import fused_mha
from v1t_tpu_torch.ops.fused_mlp import fused_mlp


class _Unfold(nn.Module):
    def __init__(self, patch_size: int, stride: int):
        super().__init__()
        self.patch_size, self.stride = patch_size, stride

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        return unfold_patches(images, self.patch_size, self.stride)


class Image2Patches(nn.Module):
    def __init__(self, image_shape, patch_mode: int, patch_size: int, stride: int,
                 emb_dim: int, dtype=None):
        super().__init__()
        if patch_mode != 0:
            raise NotImplementedError(f"patch_mode {patch_mode} is not ported yet")
        c, h, w = image_shape
        self.num_patches = (
            unfold_output_size(h, patch_size, stride) * unfold_output_size(w, patch_size, stride) + 1
        )
        self.dtype = dtype
        # (Unfold, Rearrange, Linear) as the reference's Sequential
        self.projection = nn.Sequential(
            _Unfold(patch_size, stride), nn.Identity(),
            nn.Linear(c * patch_size * patch_size, emb_dim),
        )
        self.cls_token = nn.Parameter(torch.zeros(1, 1, emb_dim))
        self.pos_embedding = nn.Parameter(torch.zeros(self.num_patches, emb_dim))

    def forward(self, inputs: torch.Tensor) -> torch.Tensor:
        patches = linear(self.projection[0](inputs), self.projection[2], self.dtype)
        b = patches.shape[0]
        cls = self.cls_token.to(patches.dtype).expand(b, -1, -1)
        return torch.cat([cls, patches], dim=1) + self.pos_embedding.to(patches.dtype)

    def init_weights(self, generator: torch.Generator) -> None:
        torch_default_init_(self.projection[2], generator)
        with torch.no_grad():
            self.cls_token.normal_(generator=generator)
            self.pos_embedding.normal_(generator=generator)


class BehaviorMLP(nn.Module):
    """behavior state -> per-block latent added to every token; shared
    across mice (modes 2, 3) or one per mouse (mode 4)."""

    def __init__(self, behavior_mode: int, out_dim: int, mouse_ids, use_bias: bool = True,
                 dtype=None):
        super().__init__()
        if behavior_mode not in (2, 3, 4):
            raise ValueError(f"behavior_mode {behavior_mode} has no BehaviorMLP")
        in_dim = 3 if behavior_mode == 2 else 5
        names = list(mouse_ids) if behavior_mode == 4 else ["share"]
        self.behavior_mode, self.dtype = behavior_mode, dtype
        self.models = nn.ModuleDict({
            name: nn.Sequential(
                nn.Linear(in_dim, out_dim // 2, bias=use_bias), nn.Tanh(), nn.Identity(),
                nn.Linear(out_dim // 2, out_dim, bias=use_bias), nn.Tanh(),
            )
            for name in names
        })

    def forward(self, behaviors: torch.Tensor, mouse_id: str) -> torch.Tensor:
        name = mouse_id if self.behavior_mode == 4 else "share"
        return run_mlp(behaviors, self.models[name], self.dtype)

    def init_weights(self, generator: torch.Generator) -> None:
        for mlp in self.models.values():
            trunc_normal_init_(mlp[0], generator)
            trunc_normal_init_(mlp[3], generator)


class Attention(nn.Module):
    """Pre-LN attention sublayer: bias-free QKV with inner dim
    emb_dim * num_heads (each head emb_dim wide), scale emb_dim^-0.5 or a
    learnable per-head temperature under LSA, projection + bias."""

    def __init__(self, emb_dim: int, num_heads: int, use_lsa: bool = False,
                 use_bias: bool = True, impl: str = "auto"):
        super().__init__()
        inner = emb_dim * num_heads
        self.num_heads, self.use_lsa, self.impl = num_heads, use_lsa, impl
        self.layer_norm = nn.LayerNorm(emb_dim)
        self.to_qkv = nn.Linear(emb_dim, 3 * inner, bias=False)
        self.projection = nn.Sequential(nn.Linear(inner, emb_dim, bias=use_bias), nn.Dropout())
        self.base_scale = emb_dim ** -0.5  # the reference's temperature (vit.py:236)
        if use_lsa:
            self.scale = nn.Parameter(torch.full((num_heads,), self.base_scale))

    def forward(self, x: torch.Tensor, bias_row: t.Optional[torch.Tensor]) -> torch.Tensor:
        dt = x.dtype
        proj = self.projection[0]
        bp = proj.bias if proj.bias is not None else torch.zeros_like(self.layer_norm.bias)
        return fused_mha(
            x, self.layer_norm.weight, self.layer_norm.bias,
            self.to_qkv.weight.to(dt), proj.weight.to(dt), bp.to(dt).float(),
            self.scale if self.use_lsa else self.base_scale,
            num_heads=self.num_heads, use_lsa=self.use_lsa, fold_residual=True,
            bias_row=bias_row, plain=self.impl == "xla",
        )

    def init_weights(self, generator: torch.Generator) -> None:
        trunc_normal_init_(self.to_qkv, generator)
        trunc_normal_init_(self.projection[0], generator)
        with torch.no_grad():
            self.layer_norm.weight.fill_(1.0)
            self.layer_norm.bias.zero_()
            if self.use_lsa:
                self.scale.fill_(self.base_scale)


class MLP(nn.Module):
    """Pre-LN MLP sublayer: LayerNorm -> fc1 -> exact GELU -> fc2."""

    def __init__(self, emb_dim: int, hidden_dim: int, use_bias: bool = True,
                 impl: str = "auto"):
        super().__init__()
        self.impl = impl
        self.model = nn.Sequential(
            nn.LayerNorm(emb_dim), nn.Linear(emb_dim, hidden_dim, bias=use_bias), nn.GELU(),
            nn.Dropout(), nn.Linear(hidden_dim, emb_dim, bias=use_bias), nn.Dropout(),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = x.dtype
        ln, fc1, fc2 = self.model[0], self.model[1], self.model[4]
        b1 = fc1.bias if fc1.bias is not None else x.new_zeros(fc1.out_features, dtype=torch.float32)
        b2 = fc2.bias if fc2.bias is not None else x.new_zeros(fc2.out_features, dtype=torch.float32)
        return fused_mlp(
            x, ln.weight, ln.bias, fc1.weight.to(dt), b1, fc2.weight.to(dt), b2,
            fold_residual=True, plain=self.impl == "xla",
        )

    def init_weights(self, generator: torch.Generator) -> None:
        trunc_normal_init_(self.model[1], generator)
        trunc_normal_init_(self.model[4], generator)
        with torch.no_grad():
            self.model[0].weight.fill_(1.0)
            self.model[0].bias.zero_()


class Block(nn.Module):
    def __init__(self, emb_dim, num_heads, mlp_dim, behavior_mode, mouse_ids, use_lsa,
                 use_bias, dtype, impl):
        super().__init__()
        # the sublayers compute in the dtype of the residual stream they get
        self.mha = Attention(emb_dim, num_heads, use_lsa, use_bias, impl)
        self.mlp = MLP(emb_dim, mlp_dim, use_bias, impl)
        if behavior_mode in (2, 3, 4):
            # the reference's attribute name, hence its state_dict keys
            self.add_module(
                "b-mlp", BehaviorMLP(behavior_mode, emb_dim, mouse_ids, use_bias, dtype)
            )

    @property
    def b_mlp(self) -> t.Optional[BehaviorMLP]:
        return self._modules.get("b-mlp")

    def forward(self, x: torch.Tensor, mouse_id: str, behaviors: torch.Tensor) -> torch.Tensor:
        latent = None if self.b_mlp is None else self.b_mlp(behaviors, mouse_id)
        x = self.mha(x, latent)  # (x + latent) + attention sublayer
        return self.mlp(x)  # x + MLP sublayer


class Transformer(nn.Module):
    def __init__(self, emb_dim, num_blocks, num_heads, mlp_dim, behavior_mode, mouse_ids,
                 use_lsa=False, use_bias=True, dtype=None, impl="auto"):
        super().__init__()
        self.blocks = nn.ModuleList([
            Block(emb_dim, num_heads, mlp_dim, behavior_mode, mouse_ids, use_lsa, use_bias,
                  dtype, impl)
            for _ in range(num_blocks)
        ])

    def forward(self, x: torch.Tensor, mouse_id: str, behaviors: torch.Tensor) -> torch.Tensor:
        for block in self.blocks:
            x = block(x, mouse_id, behaviors)
        return x


@register_core("vit")
class ViTCore(nn.Module):
    """(B, C, H, W) images + behavior state -> (B, emb_dim, h, w) map."""

    def __init__(self, image_shape, mouse_ids, behavior_mode=0, patch_mode=0, patch_size=8,
                 patch_stride=1, num_blocks=4, num_heads=4, emb_dim=155, mlp_dim=488,
                 use_lsa=False, use_bias=True, dtype=None, impl="auto"):
        super().__init__()
        self.behavior_mode, self.emb_dim = behavior_mode, emb_dim
        self.patch_embedding = Image2Patches(
            image_shape, patch_mode, patch_size, patch_stride, emb_dim, dtype
        )
        self.num_patches = self.patch_embedding.num_patches - 1
        self.transformer = Transformer(
            emb_dim, num_blocks, num_heads, mlp_dim, behavior_mode, tuple(mouse_ids),
            use_lsa, use_bias, dtype, impl,
        )

    @classmethod
    def from_config(cls, config, image_shape, mouse_ids, dtype=None):
        return cls(
            image_shape=tuple(image_shape), mouse_ids=tuple(mouse_ids),
            behavior_mode=config.behavior_mode, patch_mode=config.patch_mode,
            patch_size=config.patch_size, patch_stride=config.patch_stride,
            num_blocks=config.num_blocks, num_heads=config.num_heads,
            emb_dim=config.emb_dim, mlp_dim=config.mlp_dim, use_lsa=config.use_lsa,
            use_bias=not config.disable_bias, dtype=dtype, impl=config.attention_impl,
        )

    @property
    def output_shape(self) -> t.Tuple[int, int, int]:
        h, w = find_shape(self.num_patches)
        return (self.emb_dim, h, w)

    def forward(self, inputs, mouse_id: str, behaviors, pupil_centers) -> torch.Tensor:
        tokens = self.patch_embedding(inputs)
        if self.behavior_mode in (3, 4):
            behaviors = torch.cat([behaviors, pupil_centers], dim=-1)
        out = self.transformer(tokens, mouse_id, behaviors)[:, 1:, :]  # drop CLS
        c, h, w = self.output_shape
        return out.reshape(out.shape[0], h, w, c).permute(0, 3, 1, 2)

    def init_weights(self, generator: torch.Generator) -> None:
        self.patch_embedding.init_weights(generator)
        for block in self.transformer.blocks:
            block.mha.init_weights(generator)
            block.mlp.init_weights(generator)
            if block.b_mlp is not None:
                block.b_mlp.init_weights(generator)
