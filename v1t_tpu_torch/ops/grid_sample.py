"""Grid sampling with ``align_corners=True`` and zero padding, and the
cropper's bilinear resize, in plain PyTorch.

These are the semantics the JAX package implements with XLA gathers
(``v1t_tpu/ops/grid_sample.py``); no Pallas kernel is involved, so the port
keeps them as PyTorch tensor code. The nearest mode rounds half to even
(``torch.round``), as the reference's ``F.grid_sample(mode="nearest")``
does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _unnormalize(coord: torch.Tensor, size: int) -> torch.Tensor:
    """[-1, 1] -> pixel index space with align_corners=True."""
    return (coord + 1.0) * 0.5 * (size - 1)


def grid_sample_tokens(
    flat: torch.Tensor,
    grid: torch.Tensor,
    height: int,
    width: int,
    mode: str = "bilinear",
) -> torch.Tensor:
    """Sample a token-major table ``flat`` (B, H*W, C) at the (x, y) points
    of ``grid`` (B, P, 2) in [-1, 1]; returns (B, P, C) in ``flat.dtype``.
    Weights and accumulation run in float32."""
    if flat.ndim != 3 or grid.ndim != 3 or grid.shape[-1] != 2:
        raise ValueError(f"bad shapes {tuple(flat.shape)}, {tuple(grid.shape)}")
    h, w = height, width
    x = _unnormalize(grid[..., 0].float(), w)
    y = _unnormalize(grid[..., 1].float(), h)
    c = flat.shape[-1]

    def corner(ix: torch.Tensor, iy: torch.Tensor) -> torch.Tensor:
        valid = (ix >= 0) & (ix <= w - 1) & (iy >= 0) & (iy <= h - 1)
        idx = iy.clamp(0, h - 1) * w + ix.clamp(0, w - 1)  # (B, P) int64
        vals = torch.gather(flat, 1, idx[..., None].expand(-1, -1, c)).float()
        return vals * valid[..., None]

    if mode == "nearest":
        out = corner(torch.round(x).long(), torch.round(y).long())
    elif mode == "bilinear":
        x0f, y0f = torch.floor(x), torch.floor(y)
        ix0, iy0 = x0f.long(), y0f.long()
        wx1, wy1 = x - x0f, y - y0f
        wx0, wy0 = 1.0 - wx1, 1.0 - wy1
        out = (
            corner(ix0, iy0) * (wx0 * wy0)[..., None]
            + corner(ix0 + 1, iy0) * (wx1 * wy0)[..., None]
            + corner(ix0, iy0 + 1) * (wx0 * wy1)[..., None]
            + corner(ix0 + 1, iy0 + 1) * (wx1 * wy1)[..., None]
        )
    else:
        raise ValueError(f"grid_sample mode {mode!r} not supported")
    return out.to(flat.dtype)


def grid_sample(inputs: torch.Tensor, grid: torch.Tensor, mode: str = "bilinear") -> torch.Tensor:
    """``inputs`` (B, C, H, W) sampled at ``grid`` (B, Hg, Wg, 2) -> (B, C, Hg, Wg)."""
    if inputs.ndim != 4 or grid.ndim != 4 or grid.shape[-1] != 2:
        raise ValueError(f"bad shapes {tuple(inputs.shape)}, {tuple(grid.shape)}")
    b, c, h, w = inputs.shape
    _, gh, gw, _ = grid.shape
    flat = inputs.reshape(b, c, h * w).transpose(1, 2)
    out = grid_sample_tokens(flat, grid.reshape(b, gh * gw, 2), h, w, mode=mode)
    return out.transpose(1, 2).reshape(b, c, gh, gw)


def resize_bilinear(images: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Bilinear resize with half-pixel centers and no antialiasing, as
    ``torchvision.transforms.Resize(size, antialias=False)`` in the
    reference's ImageCropper (src/v1t/models/image_cropper.py:96-99)."""
    return F.interpolate(
        images, size=(height, width), mode="bilinear", align_corners=False,
        antialias=False,
    )
