"""Bilinear sampling of a channel-major table for the Gaussian2d readout:
``bilinear_sample_cm`` (``csrc/bilinear_sample.cu``) and its plain version.

The JAX package's ``interp_matmul_sample_cm`` (``v1t_tpu/ops/
interp_matmul.py``) samples a (B, C, H*W) table at (B, P) grid points with
``align_corners=True`` and zero padding through hat-weight matmuls, because
the TPU has no gather; it sends a float32 table, or one of more than
``MAX_TABLE_ROWS`` = 4096 rows (its VMEM), to XLA gathers instead. Hopper
gathers, from shared memory: a block stages G of one image's channels
there, interleaved by channel (one word of up to 16 bytes a cell), and each
corner load of a point returns G channels (``sample_fwd_plan``: 8 bf16 or 4
float32 channels at the flagship's 29 x 57 map, one channel at the
full-resolution 137 x 249 one; a map whose single channel does not fit a
block is gathered from global memory), for a bf16 or a float32 table of
any size: one kernel with no gate.

The backward (``bilinear_sample_cm_bwd``, the JAX ``_interp_bwd`` ->
``_bwd_kernel``) adds d(table) into shared memory, a block a chunk of one
image's channels with their table beside it (a map too large for that
takes a block a channel, and one too large for a block a band of its rows:
``sample_bwd_plan``), writes it once in the table's dtype and
computes torch's piecewise-linear d(grid) in the same pass; ``sample_cm``
puts the pair behind a ``torch.autograd.Function`` with the JAX
``custom_vjp``'s cotangents (d(table) in the table's dtype, d(grid)
float32).
"""

from __future__ import annotations

import typing as t

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
    _build.require_cuda("bilinear_sample_cm", (table.dtype, torch.float32), table, grid)
    b, c, _ = table.shape
    p = grid.shape[1]
    if b > 65535:
        raise ValueError("bilinear_sample_cm: batch exceeds the launch grid")
    out = torch.empty((b, c, p), dtype=table.dtype, device=table.device)
    rc = _build.library().v1t_bilinear_sample_cm(
        table.data_ptr(), grid.data_ptr(), out.data_ptr(),
        b, c, height, width, p, int(table.dtype == torch.float32), _build.stream_of(table),
    )
    _build.check_launch("bilinear_sample_cm", rc)
    bilinear_sample_cm.launches += 1
    return out


bilinear_sample_cm.launches = 0

# an SM's shared memory, the runtime's share of it a block, the forward's
# blocks a SM (64 registers a thread)
SM_SMEM, BLOCK_RESERVE, FWD_BLOCKS_PER_SM = 233472, 1024, 4


class SampleFwdPlan(t.NamedTuple):
    group: int  # channels a block: one cell's shared-memory word (G)
    chunks: int  # chunks of the channels: blocks an image
    smem: int  # dynamic shared memory a block, bytes (0: unstaged)
    staged: bool  # the table staged in shared memory, or gathered from global memory


def sample_fwd_plan(c: int, height: int, width: int, dtype: torch.dtype) -> SampleFwdPlan:
    """The launch ``csrc/bilinear_sample.cu`` ``sample_fwd_plan`` picks for
    the forward over C channels of a height x width map in ``dtype`` (one
    grid of chunks per image): as many blocks a SM as a channel's table
    allows (at most ``FWD_BLOCKS_PER_SM``), and a block the widest group of
    channels that fits that share of the SM (16 bytes a cell, halved until
    it fits). A channel past a block's shared memory is gathered from
    global memory, a block a channel."""
    plane = height * width * (4 if dtype == torch.float32 else 2)
    if plane > SM_SMEM - BLOCK_RESERVE:
        return SampleFwdPlan(1, c, 0, False)
    per_sm = min(FWD_BLOCKS_PER_SM, SM_SMEM // (plane + BLOCK_RESERVE))
    share = SM_SMEM // per_sm - BLOCK_RESERVE
    g = 4 if dtype == torch.float32 else 8
    while g > 1 and plane * g > share:
        g //= 2
    return SampleFwdPlan(g, -(-c // g), g * plane, True)


BWD_MAX_SMEM, BWD_PAIR_SMEM = 232448, 115712  # a block's shared memory: alone, two a SM


class SampleBwdPlan(t.NamedTuple):
    channels: int  # channels a block
    band_rows: int  # map rows a block (the whole map unless it is split in bands)
    chunks: int  # chunks of the channels
    bands: int  # bands of the map's rows
    smem: int  # dynamic shared memory a block, bytes
    staged: bool  # the table's channels in shared memory beside their d(table)


def sample_bwd_plan(c: int, height: int, width: int) -> SampleBwdPlan:
    """The launch ``csrc/bilinear_sample.cu`` ``sample_bwd_plan`` picks for
    the backward of C channels of a height x width map (one grid of chunks x
    bands per image): a channel's float32 d(table) and its table (a 4-byte
    slot a cell) that fit half a SM's shared memory take as many channels a
    block as fit there (two blocks a SM), split evenly over the chunks, or
    a block's; past that the table stays in global memory and a channel's
    d(table) takes a block, in even row bands where it does not fit one.
    Raises where a single row does not fit."""
    staged = height * width * 8
    if staged <= BWD_MAX_SMEM:
        most = min(c, (BWD_PAIR_SMEM if staged <= BWD_PAIR_SMEM else BWD_MAX_SMEM) // staged)
        chunks = -(-c // most)
        channels = -(-c // chunks)
        return SampleBwdPlan(channels, height, chunks, 1, channels * staged, True)
    rows = BWD_MAX_SMEM // (width * 4)
    if rows < 1:
        raise ValueError(f"bilinear_sample_cm_bwd: a map row of {width} does not fit")
    bands = -(-height // rows)
    band_rows = -(-height // bands)
    return SampleBwdPlan(1, band_rows, c, bands, band_rows * width * 4, False)


def bilinear_sample_cm_bwd_plain(table: Tensor, grid: Tensor, dout: Tensor, height: int,
                                 width: int) -> t.Tuple[Tensor, Tensor]:
    """Plain PyTorch version of the backward: float32 scatter-adds into
    d(table) (cast to the table's dtype at the end) and the cell-wise grid
    gradient, zero padding outside the map (any device)."""
    b, c, hw = table.shape
    x = (grid[..., 0].float() + 1.0) * 0.5 * (width - 1)
    y = (grid[..., 1].float() + 1.0) * 0.5 * (height - 1)
    x0f, y0f = torch.floor(x), torch.floor(y)
    ix0, iy0 = x0f.long(), y0f.long()
    wx1, wy1 = x - x0f, y - y0f
    wx0, wy0 = 1.0 - wx1, 1.0 - wy1
    g = dout.float()  # (B, C, P)
    table32 = table.float()
    dtable = torch.zeros((b, c, hw), dtype=torch.float32, device=table.device)
    vals = []
    for dx_, dy_, weight in ((0, 0, wx0 * wy0), (1, 0, wx1 * wy0), (0, 1, wx0 * wy1),
                             (1, 1, wx1 * wy1)):
        ix, iy = ix0 + dx_, iy0 + dy_
        valid = (ix >= 0) & (ix < width) & (iy >= 0) & (iy < height)
        idx = (iy.clamp(0, height - 1) * width + ix.clamp(0, width - 1))[:, None, :]
        idx = idx.expand(-1, c, -1)
        v = torch.gather(table32, 2, idx) * valid[:, None, :]
        vals.append(v)
        dtable.scatter_add_(2, idx, g * (weight * valid)[:, None, :])
    v00, v10, v01, v11 = vals
    dgx = (g * ((v10 - v00) * wy0[:, None] + (v11 - v01) * wy1[:, None])).sum(1)
    dgy = (g * ((v01 - v00) * wx0[:, None] + (v11 - v10) * wx1[:, None])).sum(1)
    dgrid = torch.stack([dgx * 0.5 * (width - 1), dgy * 0.5 * (height - 1)], dim=-1)
    return dtable.to(table.dtype), dgrid


def bilinear_sample_cm_bwd(table: Tensor, grid: Tensor, dout: Tensor, height: int,
                           width: int) -> t.Tuple[Tensor, Tensor]:
    """The backward of ``bilinear_sample_cm``: table (B, C, H*W), grid
    (B, P, 2), dout (B, C, P) in the table's dtype -> (d(table) in the
    table's dtype, d(grid) (B, P, 2) float32). The kernel sums d(table) in
    float32 in shared memory and rounds it once to the table's dtype, as
    the plain version's float32 scatter and cast do."""
    _check(table, grid, height, width)
    if tuple(dout.shape) != (table.shape[0], table.shape[1], grid.shape[1]):
        raise ValueError(f"bilinear_sample_cm_bwd: dout {tuple(dout.shape)} does not match")
    if table.device.type == "cpu":
        return bilinear_sample_cm_bwd_plain(table, grid, dout, height, width)
    f32 = torch.float32
    _build.require_cuda("bilinear_sample_cm_bwd", (table.dtype, f32, table.dtype),
                        table, grid, dout)
    b, c, hw = table.shape
    p = grid.shape[1]
    if b > 65535:
        raise ValueError("bilinear_sample_cm_bwd: batch exceeds the launch grid")
    sample_bwd_plan(c, height, width)  # raises where no launch fits
    dtable = torch.empty_like(table)
    dgrid = torch.empty((b, p, 2), dtype=f32, device=table.device)
    rc = _build.library().v1t_bilinear_sample_cm_bwd(
        table.data_ptr(), grid.data_ptr(), dout.data_ptr(), dtable.data_ptr(),
        dgrid.data_ptr(), b, c, height, width, p, int(table.dtype == f32),
        _build.stream_of(table),
    )
    _build.check_launch("bilinear_sample_cm_bwd", rc)
    bilinear_sample_cm_bwd.launches += 1
    return dtable, dgrid


bilinear_sample_cm_bwd.launches = 0


class _SampleCM(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, grid, height: int, width: int, plain: bool):
        ctx.shape, ctx.plain = (height, width), plain
        ctx.save_for_backward(table, grid)
        fwd = bilinear_sample_cm_plain if plain else bilinear_sample_cm
        return fwd(table, grid, height, width)

    @staticmethod
    def backward(ctx, dout):
        table, grid = ctx.saved_tensors
        bwd = bilinear_sample_cm_bwd_plain if ctx.plain else bilinear_sample_cm_bwd
        dtable, dgrid = bwd(table, grid, dout.to(table.dtype).contiguous(), *ctx.shape)
        return dtable, dgrid, None, None, None


def sample_cm(table: Tensor, grid: Tensor, height: int, width: int,
              plain: bool = False) -> Tensor:
    """``bilinear_sample_cm`` (``plain``: its plain version on any device),
    differentiable in the table and the grid through the backward kernel
    (or its plain version)."""
    if torch.is_grad_enabled() and (table.requires_grad or grid.requires_grad):
        return _SampleCM.apply(table, grid, height, width, plain)
    fwd = bilinear_sample_cm_plain if plain else bilinear_sample_cm
    return fwd(table, grid, height, width)
