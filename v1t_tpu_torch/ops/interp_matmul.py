"""Bilinear sampling of a channel-major table for the Gaussian2d readout:
``bilinear_sample_cm`` (``csrc/bilinear_sample.cu``) and its plain version.

The JAX package's ``interp_matmul_sample_cm`` (``v1t_tpu/ops/
interp_matmul.py``) samples a (B, C, H*W) table at (B, P) grid points with
``align_corners=True`` and zero padding through hat-weight matmuls, because
the TPU has no gather. Hopper gathers, so the kernel here is one thread per
(b, p) that reads the 4 corners of every channel; the matmul form and its
table-size cap are not carried over.
"""

from __future__ import annotations

import torch

from v1t_tpu_torch import _build
from v1t_tpu_torch.ops.grid_sample import grid_sample_tokens

Tensor = torch.Tensor


def _check(table: Tensor, grid: Tensor, height: int, width: int) -> None:
    if table.ndim != 3 or table.shape[-1] != height * width:
        raise ValueError(
            f"bilinear_sample_cm: table {tuple(table.shape)} is not "
            f"(B, C, {height} * {width})"
        )
    if grid.ndim != 3 or grid.shape[0] != table.shape[0] or grid.shape[-1] != 2:
        raise ValueError(f"bilinear_sample_cm: grid {tuple(grid.shape)} is not (B, P, 2)")
    if table.dtype not in (torch.bfloat16, torch.float32) or grid.dtype != torch.float32:
        raise ValueError(
            f"bilinear_sample_cm: table {table.dtype} / grid {grid.dtype}: "
            "expected bf16 or float32 / float32"
        )


def bilinear_sample_cm_plain(table: Tensor, grid: Tensor, height: int, width: int) -> Tensor:
    """Plain PyTorch version (gathers, float32 weights; any device)."""
    out = grid_sample_tokens(table.transpose(1, 2), grid, height, width)
    return out.transpose(1, 2).contiguous()


def bilinear_sample_cm(table: Tensor, grid: Tensor, height: int, width: int) -> Tensor:
    """table (B, C, H*W), grid (B, P, 2) float32 (x, y) in [-1, 1] ->
    (B, C, P) in the table's dtype."""
    _check(table, grid, height, width)
    if table.device.type == "cpu":
        return bilinear_sample_cm_plain(table, grid, height, width)
    _build.require_cuda(
        "bilinear_sample_cm", (torch.bfloat16, torch.float32), table, grid
    )
    b, c, _ = table.shape
    p = grid.shape[1]
    if b > 65535:
        raise ValueError("bilinear_sample_cm: batch exceeds the launch grid")
    out = torch.empty((b, c, p), dtype=table.dtype, device=table.device)
    rc = _build.library().v1t_bilinear_sample_cm(
        table.data_ptr(), grid.data_ptr(), out.data_ptr(),
        b, c, height, width, p, _build.stream_of(table),
    )
    _build.check_launch("bilinear_sample_cm", rc)
    bilinear_sample_cm.launches += 1
    return out


bilinear_sample_cm.launches = 0
