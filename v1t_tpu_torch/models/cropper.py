"""Image cropper + per-mouse image shifters (reference
src/v1t/models/image_cropper.py): a fixed sampling mesh of extent
±center_crop, translated per sample by a per-mouse ``ImageShifter`` where
the shift mode has one, nearest-neighbour align_corners=True sampling, an
optional bilinear resize to (36, 64), and, under behavior_mode 1, the 3
behavior variables appended as constant image channels. At
``resize_image=0`` and ``center_crop=1`` (the flagship) it only crops.
"""

from __future__ import annotations

import typing as t

import numpy as np
import torch
from torch import nn

from v1t_tpu_torch.models.layers import run_mlp, torch_default_init_
from v1t_tpu_torch.ops.grid_sample import grid_sample, resize_bilinear


class ImageShifter(nn.Module):
    def __init__(self, max_shift: float, shift_mode: int, hidden_features: int = 10,
                 num_layers: int = 3, dtype=None):
        super().__init__()
        if not 0 <= max_shift <= 1:
            raise ValueError(f"max_shift {max_shift} not in [0, 1]")
        self.max_shift, self.dtype = max_shift, dtype
        self.shift_mode = shift_mode
        in_features = 5 if shift_mode == 4 else 2
        layers = []
        for _ in range(num_layers - 1):
            layers += [nn.Linear(in_features, hidden_features), nn.Tanh()]
            in_features = hidden_features
        layers += [nn.Linear(in_features, 2), nn.Tanh()]
        self.mlp = nn.Sequential(*layers)

    def forward(self, behaviors: torch.Tensor, pupil_centers: torch.Tensor) -> torch.Tensor:
        x = pupil_centers
        if self.shift_mode == 4:
            x = torch.cat([behaviors, pupil_centers], dim=-1)
        return run_mlp(x, self.mlp, self.dtype) * self.max_shift

    def init_weights(self, generator: torch.Generator) -> None:
        for layer in self.mlp:
            if isinstance(layer, nn.Linear):
                torch_default_init_(layer, generator)


class ImageCropper(nn.Module):
    """shift_mode: 0 none / 1 cropper shifter / 2 core-readout shifter only /
    3 both / 4 both + cropper sees behavior (reference model.py:51-58)."""

    def __init__(self, input_shape: t.Tuple[int, int, int], mouse_ids: t.Sequence[str],
                 shift_mode: int = 0, behavior_mode: int = 0, center_crop: float = 1.0,
                 resize_image: int = 1, ds_name: str = "sensorium", dtype=None):
        super().__init__()
        self.input_shape = tuple(input_shape)
        self.behavior_mode = behavior_mode
        self.center_crop = center_crop
        self.do_resize = resize_image == 1 and ds_name != "franke2022"
        if shift_mode in (1, 3, 4):
            self.image_shifter = nn.ModuleDict({
                m: ImageShifter(1.0 - center_crop, shift_mode, dtype=dtype)
                for m in mouse_ids
            })
        else:
            self.image_shifter = None
        self.register_buffer("grid", torch.from_numpy(self._build_grid()), persistent=False)

    @property
    def crop_shape(self) -> t.Tuple[int, int]:
        _, in_h, in_w = self.input_shape
        if self.center_crop < 1:
            return int(in_h * self.center_crop), int(in_w * self.center_crop)
        return in_h, in_w

    @property
    def output_shape(self) -> t.Tuple[int, int, int]:
        c = self.input_shape[0] + (3 if self.behavior_mode == 1 else 0)
        out_h, out_w = (36, 64) if self.do_resize else self.crop_shape
        return (c, out_h, out_w)

    def _build_grid(self) -> np.ndarray:
        """Fixed sampling mesh of extent ±center_crop, (x, y) ordered
        (image_cropper.py:103-111)."""
        crop_h, crop_w = self.crop_shape
        s = self.center_crop
        h_pixels = np.linspace(-s, s, crop_h, dtype=np.float32)
        w_pixels = np.linspace(-s, s, crop_w, dtype=np.float32)
        mesh_y, mesh_x = np.meshgrid(h_pixels, w_pixels, indexing="ij")
        return np.stack([mesh_x, mesh_y], axis=2)[None]  # (1, h, w, 2)

    def forward(self, inputs: torch.Tensor, mouse_id: str, behaviors: torch.Tensor,
                pupil_centers: torch.Tensor) -> t.Tuple[torch.Tensor, torch.Tensor]:
        grid = self.grid.expand(inputs.shape[0], -1, -1, -1)
        if self.image_shifter is not None:
            shifts = self.image_shifter[mouse_id](behaviors, pupil_centers)
            grid = grid + shifts.float()[:, None, None, :]
        outputs = grid_sample(inputs, grid, mode="nearest")
        if self.do_resize:
            outputs = resize_bilinear(outputs, 36, 64)
        if self.behavior_mode == 1:
            h, w = outputs.shape[2], outputs.shape[3]
            channels = behaviors[:, :, None, None].to(outputs.dtype).expand(-1, -1, h, w)
            outputs = torch.cat([outputs, channels], dim=1)
        return outputs, grid

    def init_weights(self, generator: torch.Generator) -> None:
        if self.image_shifter is not None:
            for shifter in self.image_shifter.values():
                shifter.init_weights(generator)
