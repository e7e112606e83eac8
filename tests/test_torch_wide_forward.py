"""The launch plans of the two forward kernels past the panels' widths, on
the CPU: the projection past K 640 (``csrc/ln_linear.cu``
``wl::linear_wgmma_kernel``, tiles of 128 rows x 256 columns, a
LayerNorm's rows normalised first into aligned scratch) and the bf16 flash forward past
padded head width 256 (``csrc/flash_attention.cu``
``flash_fwd_cluster_kernel``, the column groups of a query tile one
thread-block cluster). The kernels run only on the card; these cases hold
the Python mirrors (``linear_plan``, ``fwd_plan``) to what the sources
compute, and the tile walk of the persistent projection to the output it
must cover."""

from __future__ import annotations

import pytest
import torch

from v1t_tpu_torch.ops import flash_attention as fa
from v1t_tpu_torch.ops.ln_linear import (
    PANEL_MAX_K, PANEL_MAX_K128, SMEM_LIMIT, WIDE_TILE, WL_ROWS, WL_SMEM, WL_STAGES, linear_plan,
    padded_head_dim,
)

M = 64 * 1654  # the emb-768 path's rows: batch 64 x 1654 tokens


def _old_plan(m, n, k, heads, ln, x_aligned, residual):
    """The forward plan up to K 640, written out apart from the mirror:
    streamed x or a resident panel, tiles of at most 160 columns."""
    cdiv = lambda a, b: -(-a // b)  # noqa: E731
    kp = cdiv(k, 32) * 32
    if heads is not None:
        head_pad = padded_head_dim(heads[1])
        parts = cdiv(head_pad, 160)
        nt, tiles = cdiv(cdiv(head_pad, parts), 32) * 32, n // heads[1] * parts
    else:
        tiles = cdiv(n, 160)
        nt = cdiv(cdiv(n, tiles), 32) * 32
    stream = not ln and x_aligned
    direct = heads is not None or (n % 8 == 0 and not residual)
    for rows in ((128,) if stream else (128, 64)):
        if not stream and rows == 128 and kp > PANEL_MAX_K128:
            continue
        out = rows * (nt + 8) * (4 if direct else 6)
        raw = 0 if stream else cdiv(rows * k * 2 + 32, 128) * 128
        region = cdiv(max(out, raw), 1024) * 1024
        panel = 0 if stream else rows * cdiv(kp, 64) * 64 * 2
        stage = (rows * 64 * 2 if stream else 0) + nt * 64 * 2
        for stages in (4, 3, 2):
            smem = 3072 + panel + stages * stage + region
            if smem <= SMEM_LIMIT:
                return (stream, rows, nt, tiles, stages, smem)
    return None


def _uses(emb, heads, mlp):
    """A block's projections: (N, K, heads, LayerNorm, x aligned, residual)."""
    return {"qkv": (3 * heads * emb, emb, (heads, emb), True, emb % 8 == 0, False),
            "out_proj": (emb, heads * emb, None, False, heads * emb % 8 == 0, True),
            "fc1": (mlp, emb, None, True, emb % 8 == 0, False),
            "fc2": (emb, mlp, None, False, mlp % 8 == 0, True)}


@pytest.mark.parametrize("emb,heads,mlp", [(155, 4, 488), (256, 4, 1024), (160, 4, 488),
                                           (64, 2, 128), (200, 3, 640), (320, 2, 600)], ids=str)
def test_projection_up_to_k_640_keeps_its_plan(emb, heads, mlp):
    """Every projection whose K is at most 640 (the flagship, full
    resolution, cct, the sweep) keeps the plan it had: the panel or the
    streamed kernel, tiles of at most 160 columns, the same ring and shared
    memory."""
    for use, (n, k, hd, ln, al, res) in _uses(emb, heads, mlp).items():
        if k > PANEL_MAX_K:
            continue
        plan = linear_plan(M, n, k, hd, ln, al, res)
        old = _old_plan(M, n, k, hd, ln, al, res)
        assert (plan is None) == (old is None), use
        if plan is not None:
            assert tuple(plan[:6]) == old and not plan.wgmma, use


@pytest.mark.parametrize("k", [672, 768, 1024, 3072])
@pytest.mark.parametrize("layout", ["row_major", "head_major"])
def test_projection_past_k_640_takes_256_wide_tiles(k, layout):
    """Past K 640 every projection runs the wgmma kernel: rows of 128, the
    output split evenly into tiles of at most 256 columns (multiples of 32):
    at emb 768 a head's plane of 768 is 3 x 256 and fc1's 3072 is 12 x 256,
    no padded column; a ring of 3 stages, one size of shared memory."""
    heads = (4, 768) if layout == "head_major" else None
    for n in ((3 * 4 * 768,) if heads else (768, 3072, 1000)):
        for ln, res in ((True, False), (False, True), (False, False)):
            plan = linear_plan(M, n, k, heads, ln, True, res)
            assert plan.wgmma and plan.stream and plan.rows == WL_ROWS == 128
            assert (plan.stages, plan.smem) == (WL_STAGES, WL_SMEM) and plan.smem <= SMEM_LIMIT
            width = padded_head_dim(heads[1]) if heads else n
            parts = -(-width // WIDE_TILE)
            assert plan.tile % 32 == 0 and plan.tile <= WIDE_TILE
            assert (parts - 1) * plan.tile < width <= parts * plan.tile
            assert plan.tiles == (n // heads[1] * parts if heads else parts)
            if width % WIDE_TILE == 0:
                assert plan.tile == 256
            # x streams by TMA: rows that are not 16-byte aligned get no
            # launch (the wrapper pads them), but for a LayerNorm's, which
            # are normalised into aligned scratch first
            unaligned = linear_plan(M, n, k, heads, ln, False, res)
            assert unaligned == plan if ln else unaligned is None


def _walk(m_rows, batches, n, heads, k):
    """The persistent kernel's tiles in the order a block walks them (tile
    T: output tile T % tiles of row tile T // tiles, row tiles of 128 within
    a batch), as (batch, first row, rows, plane, first column, columns),
    with its columns' logical outputs."""
    plan = linear_plan(m_rows * batches, n, k, heads, True, True, False)
    tpb = -(-m_rows // 128)
    head_pad = padded_head_dim(heads[1]) if heads else 0
    parts = -(-head_pad // WIDE_TILE) if heads else 1
    out = []
    for t in range(batches * tpb * plan.tiles):
        r_, ti = divmod(t, plan.tiles)
        b, i = divmod(r_, tpb)
        n0 = i * 128
        plane = ti // parts if heads else 0
        col0 = (ti - plane * parts if heads else ti) * plan.tile
        width = min(plan.tile, (head_pad if heads else n) - col0)
        out.append((b, n0, min(128, m_rows - n0), plane, col0, width))
    return plan, out


@pytest.mark.parametrize("m_rows,batches,n,heads", [
    (1654, 3, 3 * 4 * 768, (4, 768)), (1654, 2, 3072, None), (300, 2, 1000, None),
    (65, 2, 3 * 2 * 700, (2, 700)), (129, 1, 770, None)], ids=str)
def test_projection_tile_walk_covers_the_output_once(m_rows, batches, n, heads):
    """Every output element (row, logical column) is written by exactly one
    tile, no tile crosses a batch, and a head-major plane's pad columns
    (head_dim .. head_pad) are the only columns past the logical ones."""
    _, tiles = _walk(m_rows, batches, n, heads, 768)
    hits = torch.zeros(batches * m_rows, n, dtype=torch.int32)
    for b, n0, rows, plane, col0, width in tiles:
        assert rows >= 1 and n0 + rows <= m_rows
        r0 = b * m_rows + n0
        if heads:
            d = heads[1]
            cols = [plane * d + c for c in range(col0, col0 + width) if c < d]
        else:
            cols = list(range(col0, col0 + width))
        hits[r0:r0 + rows, cols] += 1
    assert bool((hits == 1).all())


@pytest.mark.parametrize("dp", [288, 320, 384, 512, 640, 768, 1024, 1536, 2048, 2080, 2560])
def test_flash_forward_cluster_is_the_groups(dp):
    """bf16 past padded head width 256: up to 8 groups (DP 2048) the groups
    of a 128-query tile are one cluster (its size the groups'), the group's
    q columns resident and 64-key K and V tiles of its columns; past 8 the
    groups recompute S, one block a cluster."""
    plan = fa.fwd_plan(torch.bfloat16, dp)
    groups, cols = fa.column_groups(dp)
    assert (plan.groups, plan.group_cols) == (groups, cols)
    assert plan.cluster == (groups if groups <= fa.CLUSTER_GROUPS else 1)
    assert (plan.queries, plan.keys) == (128, 64)
    assert plan.q_panels == (1 if groups <= fa.CLUSTER_GROUPS else 0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
def test_every_plan_fits_a_block(dtype):
    """Every forward and backward flash plan, at every padded head width to
    2560, and every projection plan past K 640 fits a block's 232,448 bytes
    of shared memory."""
    for dp in range(32, 2561, 32):
        assert fa.fwd_plan(dtype, dp).smem <= SMEM_LIMIT, dp
        assert fa.bwd_plan(dtype, 64, 1654, dp).smem <= SMEM_LIMIT, dp
    for k in (672, 768, 1024, 1030, 2048, 3072, 4096):
        for n, heads in ((768, None), (3072, None), (155, None), (9216, (4, 768))):
            plan = linear_plan(M, n, k, heads, heads is not None, True, heads is None)
            assert plan.smem <= SMEM_LIMIT
