"""``ln_linear_bwd``'s dX past K 640 (``csrc/ln_linear_bwd.cu``
``wx::dx_wgmma_kernel``): the launch plan that ``ops/ln_linear.py``
``dx_plan`` mirrors, the column-sum layout of its LayerNorm epilogue, and the
kernel source's fixed-order sums. The kernel itself runs only on a GPU
(``tests/test_torch_port_cuda.py``, ``python3 chip_smoke.py`` phase 3d);
its plain versions past K 640 are held against the JAX package in
``tests/test_torch_wide.py``.
"""

import re
from pathlib import Path

import pytest

from v1t_tpu_torch.ops.ln_linear import (
    MAX_LN_K, SMEM_LIMIT, WX_CHUNK, WX_LN_MAX_K, WX_MAX_CLUSTER, WX_ROWS, WX_SMEM, WX_STAGES,
    WX_TILE, dx_col_parts, dx_plan, padded_head_dim,
)

SRC = Path(__file__).resolve().parents[1] / "v1t_tpu_torch" / "csrc" / "ln_linear_bwd.cu"


def _source() -> str:
    return SRC.read_text()


def _body(src: str, name: str) -> str:
    """The text of kernel ``name`` from its parameter list to its closing brace."""
    body = src[src.index(name + "("):]
    return body[:body.index("\n}\n")]


@pytest.mark.parametrize("ln", [True, False], ids=["layernorm", "plain"])
@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "unaligned"])
@pytest.mark.parametrize("k", [641, 672, 768, 1024, 1030, 1536, 2048])
def test_every_k_past_640_takes_the_wgmma_kernel(k, aligned, ln):
    """Past K 640 (up to 2048) the plan is the wgmma kernel's at every
    reduction width and alignment: tiles of 128 rows x 256 output columns,
    a ring of 4 stages within a block's shared memory (one block a SM); a
    LayerNorm's row in one cluster of ceil(K / 256) blocks (3 to 8), the
    plain form without a cluster; dY' copied by each block of its row
    tile, one a tile."""
    for ns in (160, 768, 3072, 9216):
        plan = dx_plan(k, ns, aligned, ln)
        assert plan.wgmma and not plan.dln_global and not plan.resident
        assert (plan.rows, plan.stages, plan.k_tiles) == (128, 4, -(-k // 256))
        assert plan.cluster == (plan.k_tiles if ln else 1)
        assert 3 <= plan.k_tiles <= 8 and plan.cluster <= WX_MAX_CLUSTER
        assert plan.smem == WX_SMEM <= SMEM_LIMIT and 2 * plan.smem > SMEM_LIMIT
        assert plan.dy_reads == plan.k_tiles


@pytest.mark.parametrize("k", [1, 155, 160, 488, 620, 640])
def test_up_to_640_the_plan_is_as_before(k):
    """At K <= 640 (the flagship's rows 2 and 4) nothing routes to the new
    kernel: the mma.sync kernel's plan, 160-column tiles, no cluster."""
    for ln in (True, False):
        plan = dx_plan(k, 1920, True, ln)
        assert not plan.wgmma and plan.cluster == 1 and not plan.dln_global
        assert plan.k_tiles == -(-k // 160)


@pytest.mark.parametrize("k", [2049, 2304, 3072, 4096])
def test_layernorm_past_eight_blocks_keeps_its_rows_in_device_memory(k):
    """A LayerNorm wider than a cluster of 8 x 256 columns (no configuration
    reaches it) keeps the mma.sync kernel's d(ln) rows in (M, K) float32
    scratch; the plain form at the same K takes the wgmma kernel."""
    ln = dx_plan(k, 3072, True, True)
    assert ln.dln_global and not ln.wgmma and ln.smem <= SMEM_LIMIT
    plain = dx_plan(k, 768, True, False)
    assert plain.wgmma and plain.cluster == 1 and plain.k_tiles == -(-k // 256)
    assert k > WX_LN_MAX_K == 2048


# (K, stored reduction columns, LayerNorm) -> (tiles a row, blocks a cluster)
USES = {
    "emb 768 qkv": ((768, 3 * 4 * 768, True), (3, 3)),
    "emb 768 fc1": ((768, 3072, True), (3, 3)),
    "emb 768 out-projection": ((3072, 768, False), (12, 1)),
    "emb 768 fc2": ((3072, 768, False), (12, 1)),
    "emb 672 qkv": ((672, 3 * 4 * 672, True), (3, 3)),
    "emb 1024 fc1": ((1024, 4096, True), (4, 4)),
    "sweep emb 256 x 4 heads out-projection": ((1024, 256, False), (4, 1)),
    "sweep emb 256 x 8 heads out-projection": ((2048, 256, False), (8, 1)),
    "sweep MLP 768 fc2 at emb 155": ((768, 160, False), (3, 1)),
}


@pytest.mark.parametrize("use", sorted(USES))
def test_the_paths_uses_past_640(use):
    """The uses that phase 5l (emb 768), phase 3d (K 672, 1024) and the
    sweep (configs/sweep_v1t.yaml: heads as wide as the embedding up to 256
    and 8 heads, MLPs up to 768) route past K 640."""
    (k, ns, ln), (tiles, cluster) = USES[use]
    plan = dx_plan(k, ns, True, ln)
    assert plan.wgmma and (plan.k_tiles, plan.cluster) == (tiles, cluster)
    assert k > MAX_LN_K


@pytest.mark.parametrize("m,batches,brow,parts", [
    (64 * 1654, 64, True, 3 * 64 * 13),  # qkv at emb 768: 13 tiles a batch of 1654 rows
    (64 * 1654, 64, False, 2 * 64 * 13),  # fc1
    (8 * 1654, 8, True, 3 * 8 * 13),
    (2 * 300, 2, True, 3 * 2 * 3),
    (37, 1, False, 2),
])
def test_col_parts_are_one_row_a_tile(m, batches, brow, parts):
    """The LayerNorm epilogue's row tiles lie within a batch (ceil(rows /
    128) a batch): one partial of d(gamma), d(beta) and d(bias_row) a tile."""
    plan = dx_plan(768, 3072, True, True)
    assert dx_col_parts(plan, m, 768, batches, brow) == (parts, 768)


@pytest.mark.parametrize("rows_per_batch,batches", [(1654, 64), (300, 2), (128, 3), (1, 5)])
def test_column_sums_read_each_tile_once(rows_per_batch, batches):
    """``ln_dx_column_sums_kernel`` with tiles_pb > 0 sums batch b's
    d(bias_row) over tiles b tiles_pb .. (b + 1) tiles_pb - 1 and d(gamma),
    d(beta) over every tile: each partial the kernel writes read exactly
    once (its index arithmetic, replayed)."""
    tpb = -(-rows_per_batch // WX_ROWS)
    tiles = batches * tpb
    written = {(2 * tiles + t) for t in range(tiles)}
    read = [2 * tiles + b * tpb + i for b in range(batches) for i in range(tpb)]
    assert sorted(read) == sorted(written) and len(set(read)) == len(read)
    src = _body(_source(), "ln_dx_column_sums_kernel")
    assert "} else if (tiles_pb) {" in src
    assert "part = col_part + (2 * (size_t)blocks + b * tiles_pb) * K;" in src
    assert "n = tiles_pb;" in src


def test_wgmma_constants_match_the_kernel_source():
    src = _source()
    m = re.search(r"constexpr int ROWS = (\d+), TILE = (\d+), CHUNK = (\d+), STAGES = (\d+);", src)
    assert tuple(map(int, m.groups())) == (WX_ROWS, WX_TILE, WX_CHUNK, WX_STAGES)
    assert int(re.search(r"constexpr int MAX_CLUSTER = (\d+), LN_MAX_K", src).group(1)) \
        == WX_MAX_CLUSTER
    head = int(re.search(r"constexpr int HEAD = (\d+);", src).group(1))
    assert "constexpr int SMEM = 1024 + HEAD + STAGES * STAGE_BYTES;" in src
    assert "constexpr int A_BYTES = ROWS * CHUNK * 2, STAGE_BYTES = A_BYTES + TILE * CHUNK * 2;" \
        in src
    assert WX_SMEM == 1024 + head + WX_STAGES * (WX_ROWS + WX_TILE) * WX_CHUNK * 2
    # the routing: every K past 640 but a LayerNorm past a cluster's width
    assert "if (K > MAX_LN_K && !(ln && K > wx::LN_MAX_K)) {" in src
    assert "p.cluster = ln ? p.k_tiles : 1;" in src
    assert "constexpr int MAX_LN_K = 640;" in src and MAX_LN_K == 640


def test_wgmma_kernel_sums_in_a_fixed_order_without_atomics():
    """No atomic in the kernel: the row sums over the cluster's blocks run
    in rank order (q = 0 .. C - 1 over distributed shared memory, one
    exchange of each block's sum, squared deviations and d(ln) sums), the
    column sums over the tile's row groups in order, then one partial a
    tile that ln_dx_column_sums_kernel adds in a fixed order; no (M, K)
    float32 scratch reaches the kernel."""
    body = _body(_source(), "dx_wgmma_kernel")
    assert "atomic" not in body
    assert "cluster.map_shared_rank(part, q)" in body
    assert body.count("for (int q = 0; q < MAX_CLUSTER; ++q)\n        if (q < C)") == 3
    assert "if (q < C) mu += v[0][q];" in body
    assert "m2 += v[1][q] + n * shift * shift;" in body
    assert "s2 += v[3][q] + shift * v[2][q];" in body
    assert body.count("cluster.sync();") == 2  # the one exchange, and before leaving
    assert "for (int i = 0; i < 8; ++i) sum[q] += cs[(q * 8 + i) * TILE + tid];" in body
    assert "dln" not in body
    # the products: wgmma on 128-byte swizzled stages that TMA fills
    assert "wgmma::Mma<TILE>::template ss<0, 0>(acc, desc_k128(a_s, 64 * wgi, kk)," in body
    assert "tma_box(st, &dymap, col, n0, plane, &full[s]);" in body
    assert "tma_box(st + A_BYTES, &wmap, wcol, k0, 0, &full[s]);" in body


def test_head_major_chunks_stay_within_a_plane():
    """A head-major dY is read in chunks of 64 columns within each (s, h)
    plane of head_pad (zeros past it), so that a plane whose head_pad is
    not a multiple of 64 (672 = 10.5 chunks) never reads its neighbour."""
    body = _body(_source(), "dx_wgmma_kernel")
    assert "const int cpp = g.heads ? cdiv(g.head_pad, CHUNK) : 0;" in body
    assert "const int NC = g.heads ? g.NS / g.head_pad * cpp : cdiv(g.NS, CHUNK);" in body
    assert padded_head_dim(641) == 672 and 672 % WX_CHUNK == 32
