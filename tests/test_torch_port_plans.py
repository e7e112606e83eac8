"""Host-side logic of the port's redesigned kernels, on the CPU: the W^T
layouts ``ln_linear_bwd`` hands its dX kernel and the padded w of the
forward, the launch plans the projection kernels and the float32 flash
forward pick (``linear_plan``, ``dx_plan``, ``wgrad_plan``, ``fwd_plan``,
mirrors of the plans compiled into ``csrc/ln_linear.cu``,
``csrc/ln_linear_bwd.cu`` and ``csrc/flash_attention.cu``; a card test holds
each mirror against the library), and source checks of what each kernel
reads.

Tolerance of the layout checks: 1e-5 of the largest value, float32
products summed in other orders.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from v1t_tpu_torch import _build
from v1t_tpu_torch.ops import flash_attention as fa
from v1t_tpu_torch.ops.ln_linear import (
    DX_MAX_SMEM, PANEL_MAX_K, PANEL_MAX_K128, WGRAD_KT, WGRAD_MAX_CLUSTER, WGRAD_PARTIAL_SHARE,
    WGRAD_TARGET, dx_plan, dx_weight, forward_weight, linear_plan, ln_linear_bwd_plain,
    ln_linear_plain, merge_heads, padded_head_dim, wgrad_plan,
)

TOL = 1e-5
SMEM = 232448  # a block's shared memory on an H100
SMS = 132  # streaming multiprocessors of an H100
# the sweep space (configs/sweep_v1t.yaml): emb, heads, MLP width
SWEEP = [(e, h, f) for e in (64, 155, 256) for h in (2, 8) for f in (128, 487, 768)]
FLAGSHIP = (155, 4, 488)
M_FLAGSHIP, M_FULLRES = 64 * 1654, 2 * 34114  # rows: batch x tokens


def _forward_uses(emb, heads, mlp):
    """Each projection of a block: (N, K, heads, LayerNorm, x rows 16-byte
    aligned, residual)."""
    return {
        "qkv": (3 * heads * emb, emb, (heads, emb), True, False, False),
        "out_proj": (emb, heads * emb, None, False, heads * emb % 8 == 0, True),
        "fc1": (mlp, emb, None, True, False, False),
        "fc2": (emb, mlp, None, False, mlp % 8 == 0, True),
    }


def _wgrad_uses(emb, heads, mlp):
    """Each weight gradient of a block: (N, K, heads, dY rows 16-byte
    aligned, A rows 16-byte aligned)."""
    return {
        "out_proj": (emb, heads * emb, None, emb % 8 == 0, heads * emb % 8 == 0),
        "qkv": (3 * heads * emb, emb, (heads, emb), True, emb % 8 == 0),
        "fc2": (emb, mlp, None, emb % 8 == 0, mlp % 8 == 0),
        "fc1": (mlp, emb, None, mlp % 8 == 0, emb % 8 == 0),
    }


def _source(name):
    return open(f"{_build.CSRC_DIR}/{name}").read()


def _kernel_body(src, name):
    """The text of a kernel's definition: from its name to the next
    top-level closing brace."""
    start = src.index(f"{name}(")
    return src[start:src.index("\n}\n", start)]


@pytest.mark.parametrize("s,heads", [(3, (4, 155)), (3, (2, 17)), (3, (8, 32)), (1, (1, 256))],
                         ids=str)
def test_dx_weight_walks_head_major_planes_as_they_lie(s, heads):
    """dY head-major (S, B, H, N, DP), zero past D, read as its stored
    (B, N, S*H*DP) rows against dx_weight's W^T (padded per head) gives the
    plain version's dX, and the JAX package's product on the merged layout."""
    h, d = heads
    dp = padded_head_dim(d)
    b, n, k = 2, 5, 24
    rng = np.random.default_rng(0)
    dy = np.zeros((s, b, h, n, dp), np.float32)
    dy[..., :d] = rng.normal(size=(s, b, h, n, d))
    w = rng.normal(size=(s * h * d, k)).astype(np.float32)
    dy_t, w_t = torch.from_numpy(dy), torch.from_numpy(w)
    wt = dx_weight(w_t, heads)
    assert tuple(wt.shape) == (k, s * h * dp) and wt.is_contiguous()
    assert torch.all(wt.view(k, s * h, dp)[..., d:] == 0)
    stored = dy_t.permute(1, 3, 0, 2, 4).reshape(b, n, s * h * dp)
    got = (stored @ wt.t()).numpy()
    ref = ln_linear_bwd_plain(dy_t, w_t, heads=heads).numpy()
    jax_ref = np.asarray(jnp.asarray(merge_heads(dy_t, d).numpy()) @ jnp.asarray(w))
    for r_ in (ref, jax_ref):
        assert np.abs(got - r_).max() <= TOL * np.abs(r_).max()


@pytest.mark.parametrize("nout", [7, 155, 488, 640])
def test_dx_weight_row_major_pads_to_a_multiple_of_32(nout):
    w = torch.randn(nout, 9, generator=torch.Generator().manual_seed(nout))
    wt = dx_weight(w)
    assert tuple(wt.shape) == (9, -(-nout // 32) * 32) and wt.is_contiguous()
    assert torch.equal(wt[:, :nout], w.t()) and torch.all(wt[:, nout:] == 0)


# the flagship block's four uses: (K, stored reduction columns, rows
# 16-byte aligned, LayerNorm) -> (rows a block, resident, ring depth)
FLAGSHIP_USES = {
    "out_proj": ((620, 160, False, False), (128, True, 4)),
    "qkv": ((155, 1920, True, True), (128, False, 4)),
    "fc2": ((488, 160, False, False), (128, True, 4)),
    "fc1": ((155, 512, True, True), (128, False, 4)),
}


@pytest.mark.parametrize("use", list(FLAGSHIP_USES))
def test_dx_launch_plan_reads_the_flagship_cotangents_once(use):
    """Each flagship use reads every dY' element once: qkv and fc1 have
    one output tile (K 155) and stream dY (their LayerNorm rows reuse the
    ring, so that two blocks fit a SM); out-projection and fc2 keep their
    155-wide dY' rows in shared memory across 4 output tiles."""
    (k, ns, aligned, ln), (rows, resident, stages) = FLAGSHIP_USES[use]
    plan = dx_plan(k, ns, aligned, ln)
    assert (plan.rows, plan.resident, plan.stages, plan.dy_reads) == (rows, resident, stages, 1)
    assert plan.k_tiles == -(-k // 160)
    assert plan.smem <= (SMEM // 2 - 1024 if ln else SMEM)


@pytest.mark.parametrize("emb", [64, 155, 256])
@pytest.mark.parametrize("num_heads", [2, 8])
@pytest.mark.parametrize("mlp", [128, 487, 768])
def test_dx_launch_plan_covers_the_sweep(emb, num_heads, mlp):
    """Every width of the sweep space (configs/sweep_v1t.yaml) has a launch:
    the out-projection and fc2 keep dY' resident (read once); qkv and fc1
    read it at most once per 160-column output tile (once up to emb 160, or
    when their dY' rows fit in shared memory)."""
    dp = padded_head_dim(emb)
    pad = lambda n: -(-n // 32) * 32  # noqa: E731
    uses = {
        "out_proj": (num_heads * emb, pad(emb), emb % 8 == 0, False),
        "qkv": (emb, 3 * num_heads * dp, True, True),
        "fc2": (mlp, pad(emb), emb % 8 == 0, False),
        "fc1": (emb, pad(mlp), mlp % 8 == 0, True),
    }
    for use, (k, ns, aligned, ln) in uses.items():
        plan = dx_plan(k, ns, aligned, ln)
        assert plan is not None and plan.smem <= SMEM, use
        if use in ("out_proj", "fc2") or emb <= 160:
            assert plan.dy_reads == 1, (use, plan)
        else:
            assert plan.dy_reads <= 2, (use, plan)


@pytest.mark.parametrize("k", [160, 320, 480, 640])
@pytest.mark.parametrize("ns", [32, 640, 6144])
@pytest.mark.parametrize("aligned", [False, True])
def test_dx_launch_plan_fits_every_layernorm(k, ns, aligned):
    """A LayerNorm up to K 640 keeps its fp32 rows in shared memory: from
    K 480 on they leave room only for blocks of 64 rows (128 x 484 fp32
    alone exceed a block's shared memory)."""
    plan = dx_plan(k, ns, aligned, True)
    assert plan is not None and plan.smem <= SMEM
    assert plan.rows == (64 if k >= 480 else plan.rows) and plan.rows in (64, 128)


def test_dx_plan_constants_match_the_kernel_source():
    src = _source("ln_linear_bwd.cu")
    assert re.search(r"constexpr int DX_KT = (\d+), DX_BC = (\d+)", src).groups() == ("160", "32")
    assert int(re.search(r"constexpr int DX_MAX_SMEM = (\d+);", src).group(1)) == DX_MAX_SMEM


def test_dx_kernel_gathers_nothing_and_wgrad_copies_whole_chunks():
    """The dX kernel copies dY in 16-byte granules, once per chunk it needs
    (no gather in its loop over output tiles); ln_linear_wgrad no longer
    gathers dY element by element (gather_dy4 / finish_dy4 are gone): one
    thread copies each 64-row chunk whole, by TMA boxes or the span of its
    rows (copy_rows), the keep mask is applied to the chunk in shared
    memory, and no float atomic touches dW or db."""
    src = _source("ln_linear_bwd.cu")
    dx = _kernel_body(src, "ln_linear_dx_kernel")
    wgrad = _kernel_body(src, "wgrad_kernel")
    assert "gather" not in dx and "cp_async16(" in dx
    assert "if (!P.resident || s < NC) load_dy(s % NC, s);" in dx
    assert "gather_dy4" not in src and "finish_dy4" not in src
    assert "tma_box(st + P.d_off" in wgrad and "copy_rows(P.dy_copy, dy," in wgrad
    assert "keep_words(drop, 0u, row, grp)" in wgrad
    assert "atomic" not in wgrad


@pytest.mark.parametrize("emb,heads,mlp", SWEEP, ids=str)
def test_forward_launch_plan_covers_the_sweep(emb, heads, mlp):
    """Every width of the sweep space has a forward launch within a block's
    shared memory; qkv's output tile is one head's plane of head_pad (two
    halves above 160), so that its pad columns come out of w's zero rows;
    other outputs split N evenly into tiles of at most 160 columns."""
    for use, (n, k, hd, ln, aligned, res) in _forward_uses(emb, heads, mlp).items():
        plan = linear_plan(M_FLAGSHIP, n, k, hd, ln, aligned, res)
        if plan is None:  # only an x without LayerNorm, unaligned, wider than a panel
            assert not ln and not aligned and k > PANEL_MAX_K, use
            plan = linear_plan(M_FLAGSHIP, n, -(-k // 8) * 8, hd, ln, True, res)
        assert plan is not None and plan.smem <= SMEM, use
        assert plan.tile % 32 == 0 and plan.tile <= 160
        if use == "qkv":
            dp = padded_head_dim(emb)
            parts = 1 if dp <= 160 else 2
            assert plan.tiles == 3 * heads * parts and plan.tile * parts >= dp
            if dp <= 160:
                assert plan.tile == dp
        else:
            assert plan.tile * plan.tiles >= n and plan.tile * (plan.tiles - 1) < n
        if not plan.stream:
            assert k <= (PANEL_MAX_K128 if plan.rows == 128 else PANEL_MAX_K)


def test_forward_launch_plan_of_the_flagship_uses():
    """qkv and fc1 build their LayerNorm panel in blocks of 128 rows; the
    out-projection's o has 1240-byte rows (not 16-byte aligned) and builds
    a 640-column panel in blocks of 64; fc2 streams its aligned hidden
    layer by TMA."""
    uses = _forward_uses(*FLAGSHIP)
    got = {use: linear_plan(M_FLAGSHIP, n, k, hd, ln, al, res)
           for use, (n, k, hd, ln, al, res) in uses.items()}
    assert (got["qkv"].stream, got["qkv"].rows, got["qkv"].tile, got["qkv"].tiles) == (
        False, 128, 160, 12)
    assert (got["out_proj"].stream, got["out_proj"].rows, got["out_proj"].tiles) == (False, 64, 1)
    assert (got["fc1"].stream, got["fc1"].rows, got["fc1"].tile, got["fc1"].tiles) == (
        False, 128, 128, 4)
    assert (got["fc2"].stream, got["fc2"].rows, got["fc2"].tiles) == (True, 128, 1)


@pytest.mark.parametrize("s,heads,k", [(3, (4, 155), 155), (3, (2, 17), 40), (3, (1, 256), 64)],
                         ids=str)
def test_forward_weight_pads_each_head_to_its_plane(s, heads, k):
    """x @ forward_weight(w, heads)^T (K and each head padded with zeros) laid
    out per head gives the plain version's head-major output, pad columns
    zero: the plane a qkv tile writes."""
    h, d = heads
    dp = padded_head_dim(d)
    b, n = 2, 5
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(b, n, k)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(s * h * d, k)).astype(np.float32))
    wp = forward_weight(w, heads)
    kp = -(-k // 32) * 32
    assert tuple(wp.shape) == (s * h * dp, kp) and wp.is_contiguous()
    assert torch.all(wp.view(s * h, dp, kp)[:, d:] == 0) and torch.all(wp[:, k:] == 0)
    y = (F.pad(x, (0, kp - k)) @ wp.t()).view(b, n, s, h, dp).permute(2, 0, 3, 1, 4)
    ref = ln_linear_plain(x, w, heads=heads)
    assert np.abs((y - ref).numpy()).max() <= TOL * np.abs(ref.numpy()).max()


def test_forward_launch_plan_needs_padding_only_past_a_panel():
    """An x without LayerNorm whose rows are not 16-byte aligned builds a
    panel up to K 640; wider, no launch fits and the wrapper pads x to
    aligned rows, which stream."""
    assert linear_plan(1000, 155, 620).rows == 64
    assert linear_plan(1000, 155, 1001) is None
    assert linear_plan(1000, 155, 1008, x_aligned=True).stream


@pytest.mark.parametrize("emb,heads,mlp", SWEEP, ids=str)
def test_wgrad_launch_plan_covers_the_sweep(emb, heads, mlp):
    """Every width of the sweep space has a weight-gradient launch within a
    block's shared memory, whatever the operands' alignment; each dY element
    is copied by one block per 192-column tile of A, so exactly once wherever
    K <= 192 (qkv and fc1 up to emb 192); the slices do not depend on the
    alignment (nor on the device)."""
    for use, (n, k, hd, dy_al, a_al) in _wgrad_uses(emb, heads, mlp).items():
        rows = 1654
        plans = [wgrad_plan(M_FLAGSHIP, n, k, rows, hd, dy, a)
                 for dy in (dy_al, False) for a in (a_al, False)]
        for plan in plans:
            assert 0 < plan.smem <= SMEM and plan.stages >= 2, (use, plan)
            assert plan.dy_reads == plan.k_tiles == -(-k // WGRAD_KT)
            assert plan.tile <= 160 and plan.tile % 32 == 0
        assert len({(p.slices, p.cluster, p.n_tiles, p.k_tiles) for p in plans}) == 1
        if k <= WGRAD_KT:
            assert plans[0].dy_reads == 1


@pytest.mark.parametrize("m", [M_FLAGSHIP, M_FULLRES], ids=["batch64x1654", "batch2x34114"])
def test_wgrad_launch_plan_fills_the_card_with_few_partials(m):
    """At the flagship's widths, batch 64 x 1654 rows and the full-resolution
    batch 2 x 34,114 (its fc1 and fc2), the launch has at least a block a
    SM, and the fp32 partials (one (N, K) tile per slice) stay within 10% of
    dY's bytes; dY is copied once by qkv and fc1, whose K (155) is one tile
    of A."""
    uses = _wgrad_uses(*FLAGSHIP)
    if m == M_FULLRES:
        uses = {u: uses[u] for u in ("fc2", "fc1")}
    for use, (n, k, hd, dy_al, a_al) in uses.items():
        plan = wgrad_plan(m, n, k, 1654 if m == M_FLAGSHIP else 34114, hd, dy_al, a_al)
        assert plan.blocks >= SMS, (use, plan)
        assert plan.slices * n * k * 4 <= 0.1 * m * n * 2, (use, plan)
        assert plan.slices <= max(1, m // (WGRAD_PARTIAL_SHARE * k))
        assert plan.cluster <= WGRAD_MAX_CLUSTER
        if use in ("qkv", "fc1"):
            assert plan.dy_reads == 1


def test_projection_plan_constants_match_the_kernel_sources():
    bwd, fwd = _source("ln_linear_bwd.cu"), _source("ln_linear.cu")
    consts = {n: int(v) for n, v in re.findall(r"constexpr int (\w+) = (\d+);", bwd)}
    assert 64 * consts["CONSUMERS"] == WGRAD_KT and consts["MAX_NT"] == 160
    assert (consts["TARGET_BLOCKS"], consts["MAX_CLUSTER"], consts["PARTIAL_SHARE"]) == (
        WGRAD_TARGET, WGRAD_MAX_CLUSTER, WGRAD_PARTIAL_SHARE)
    consts = {n: int(v) for n, v in re.findall(r"constexpr int (\w+) = (\d+);", fwd)}
    assert (consts["MAX_NT"], consts["MAX_PANEL_K"], consts["MAX_PANEL_K128"], consts["CK"]) == (
        160, PANEL_MAX_K, PANEL_MAX_K128, 64)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
@pytest.mark.parametrize("dp", [32, 64, 96, 128, 160, 192, 224, 256])
def test_forward_launch_plan(dtype, dp):
    """float32: 128 queries a block (8 rows a thread) up to DP 160 and 64
    above, key tiles of 64; bf16: 128 queries, key tiles of 64 up to DP 160
    and 32 above. Both fit a block's shared memory."""
    plan = fa.fwd_plan(dtype, dp)
    if dtype == torch.float32:
        assert (plan.queries, plan.keys) == ((128 if dp <= 160 else 64), 64)
    else:
        assert (plan.queries, plan.keys) == (128, 64 if dp <= 160 else 32)
    assert plan.smem <= SMEM


@pytest.mark.parametrize("dp", [0, 16, 100, 288])
def test_forward_launch_plan_rejects_unbuilt_widths(dp):
    with pytest.raises(ValueError):
        fa.fwd_plan(torch.float32, dp)


def test_forward_plan_tiles_match_the_kernel_source():
    src = _source("flash_attention.cu")
    assert "constexpr int F32_KB = 64, F32_THREADS = 256;" in src
    assert "constexpr int f32_rows() { return DP <= 160 ? 8 : 4; }" in src
    assert "constexpr int f32_queries() { return 16 * f32_rows<DP>(); }" in src
    body = _kernel_body(src, "flash_fwd_f32_kernel")
    # K and V take turns in a two-stage ring of 16-byte copies, each copied
    # while the other's product runs; P v from float4s of P and float2s of v
    assert "load(Vs, vg, kt);" in body and "load(Ks, kg, kt + 1);" in body
    assert "cp_async16(" in body
    assert "const float2 b = *reinterpret_cast<const float2*>(vr + 32 * j);" in body


@pytest.mark.parametrize("dp,smem", [(32, 42064), (64, 83024), (96, 123984), (128, 164944),
                                     (160, 205904)])
@pytest.mark.parametrize("b,h,n,items,blocks", [(64, 4, 1654, 13 * 256, 132), (2, 3, 1, 6, 6),
                                                (1, 1, 128, 1, 1), (1, 2, 129, 4, 4)], ids=str)
def test_attention_launch_plan(dp, smem, b, h, n, items, blocks):
    """The row-1 core runs the bf16 flash forward's wgmma kernel,
    persistent: min(items, 132 SMs) blocks walk items of 128 query rows of
    one (batch, head) plane, key tiles of 64 in a TMA ring 3 deep; shared
    memory 1024 bytes of alignment slack, two q panels, the ring's K and V
    panels, 10 mbarriers (hand-computed, e.g. 205,904 bytes at DP 160:
    1024 + (2 x 128 + 2 x 3 x 64) x 160 x 2 + 80)."""
    from v1t_tpu_torch.ops.fused_mha import attention_plan

    plan = attention_plan(b, h, n, dp)
    assert (plan.items, plan.blocks, plan.stages) == (items, blocks, 3)
    assert (plan.tiles.queries, plan.tiles.keys, plan.tiles.smem) == (128, 64, smem)
    assert smem == 1024 + (2 * 128 + 2 * 3 * 64) * dp * 2 + 10 * 8 and smem <= SMEM


def test_attention_launch_plan_rejects_flash_widths_and_large_grids():
    from v1t_tpu_torch.ops.fused_mha import attention_plan

    for dp in (192, 224, 256, 100):
        with pytest.raises(ValueError):
            attention_plan(2, 2, 100, dp)
    attention_plan(16383, 4, 100, 160)
    with pytest.raises(ValueError):
        attention_plan(16384, 4, 100, 160)


def test_attention_core_is_the_flash_forward_in_log2_units():
    """attention.cu defines no kernel of its own (the mma.sync tile loop and
    attention_tile.cuh are gone): it launches flash_attention.cu's wgmma
    forward through wgmma_fwd::launch with the per-head scale, which the
    kernel applies to the q panel in shared memory before its first
    product; the forward's tiles are the ones fwd_plan mirrors."""
    attn, flash = _source("attention.cu"), _source("flash_attention.cu")
    assert "__global__" not in attn and "mma_16816" not in attn
    assert "wgmma_fwd::launch(q, q + plane, q + 2 * plane" in attn
    assert "(const float*)scale, o_row - H * D" in attn
    assert "int wgmma_fwd::launch(" in flash
    assert not any(p.endswith("attention_tile.cuh") for p in _build.sources())
    body = _kernel_body(flash, "flash_fwd_wgmma_kernel")
    assert "scale_q_rows<DP>(Qs + qb * Q_BYTES, 64 * c, q_scale[bh % ol.H] * LOG2E, D" in body
    assert body.index("scale_q_rows<DP>") < body.index("issue_s(0);")
    helper = _kernel_body(flash, "scale_q_rows")
    assert "fence_async_smem();" in helper and "named_sync(1 + c, WG);" in helper
    assert "constexpr int BQ = 128, WG = 128, FWD_THREADS = 3 * WG;" in flash
    # persistent: min(items, SMs) blocks, items (query tile, plane), two q panels
    assert "<<<items < sms ? items : sms, FWD_THREADS, bytes, stream>>>" in flash
    assert "const int qt = w % q_tiles, bh = w / q_tiles, qb = it & 1;" in body
    assert "(2 * BQ + 2 * fwd_stages<DP>() * fwd_bkv<DP>())" in flash
    assert "constexpr int fwd_bkv() { return DP <= 160 ? 64 : 32; }" in flash
    assert "constexpr int fwd_stages() { return DP <= 192 ? 3 : 2; }" in flash


# (C, height, width) -> (channels a block, rows a band, chunks, bands, smem, staged)
SAMPLE_BWD_CASES = {
    "flagship 29x57": ((155, 29, 57), (8, 29, 20, 1, 8 * 29 * 57 * 8, True)),
    "full-res 137x249": ((155, 137, 249), (1, 137, 155, 1, 137 * 249 * 4, False)),
    "300x300, two bands": ((3, 300, 300), (1, 150, 3, 2, 150 * 300 * 4, False)),
    "1x2, every channel": ((7, 1, 2), (7, 1, 1, 1, 7 * 2 * 8, True)),
    "2000x100, 4 bands": ((2, 2000, 100), (1, 500, 2, 4, 500 * 100 * 4, False)),
    "37 channels, 5 chunks": ((37, 29, 57), (8, 29, 5, 1, 8 * 29 * 57 * 8, True)),
}


@pytest.mark.parametrize("case", sorted(SAMPLE_BWD_CASES))
def test_sample_bwd_launch_plan(case):
    """d(table) of a block's channels stays in shared memory, their table
    beside it where the map fits: the flagship's 29 x 57 map (13,224 bytes
    a channel with its table slot) takes 8 channels a block within half a
    SM (two blocks a SM), 155 split evenly over 20 chunks of 8; the
    full-resolution 137 x 249 map (136,452 bytes of d(table) alone) one
    channel a block, its table in global memory; a 300 x 300 map (360,000
    bytes) two bands of 150 rows. The fp32 model's map is the flagship's:
    d(table) is float32 and the table's slot 4 bytes in either dtype."""
    from v1t_tpu_torch.ops.interp_matmul import BWD_MAX_SMEM, BWD_PAIR_SMEM, sample_bwd_plan

    shape, want = SAMPLE_BWD_CASES[case]
    plan = sample_bwd_plan(*shape)
    assert tuple(plan) == want
    c, height, width = shape
    assert plan.channels * plan.chunks >= c > plan.channels * (plan.chunks - 1)
    assert plan.band_rows * plan.bands >= height > plan.band_rows * (plan.bands - 1)
    staged = height * width * 8
    assert plan.staged == (staged <= BWD_MAX_SMEM)
    assert plan.smem <= (BWD_PAIR_SMEM if staged <= BWD_PAIR_SMEM else BWD_MAX_SMEM)
    assert 2 * (BWD_PAIR_SMEM + 1024) <= 233472 and BWD_MAX_SMEM == SMEM


def test_sample_bwd_launch_plan_rejects_a_row_past_shared_memory():
    from v1t_tpu_torch.ops.interp_matmul import sample_bwd_plan

    assert sample_bwd_plan(1, 3, 58112).bands == 3
    with pytest.raises(ValueError):
        sample_bwd_plan(1, 3, 58113)


def test_sample_bwd_plan_constants_match_the_kernel_source():
    from v1t_tpu_torch.ops.interp_matmul import BWD_MAX_SMEM, BWD_PAIR_SMEM

    src = _source("bilinear_sample.cu")
    consts = {n: int(v) for n, v in re.findall(r"constexpr int (\w+) = (\d+);", src)}
    assert (consts["BWD_MAX_SMEM"], consts["BWD_PAIR_SMEM"]) == (BWD_MAX_SMEM, BWD_PAIR_SMEM)


def test_sample_bwd_kernel_adds_nothing_to_global_dtable():
    """The backward adds d(table) only into shared memory and writes it once
    in the table's dtype; its one global atomic is d(grid)'s, a float2 per
    (b, p, chunk); the float32 scratch and cast are gone from the wrapper."""
    src = _source("bilinear_sample.cu")
    body = _kernel_body(src, "bilinear_sample_cm_bwd_kernel")
    assert re.findall(r"atomicAdd\((\w+)", body) == ["a", "dgrid"]
    assert "extern __shared__ float acc[];" in body and "T* __restrict__ dtable" in body
    assert "store_f(db + (size_t)c * HW + (i - c * cells), acc[i]);" in body
    assert "for (int i = threadIdx.x; i < nc * HW; i += BWD_THREADS) tab[i] = tb[i];" in body
    wrapper = open(f"{_build.CSRC_DIR}/../ops/interp_matmul.py").read()
    body = wrapper[wrapper.index("def bilinear_sample_cm_bwd("):]
    body = body[:body.index("\nbilinear_sample_cm_bwd.launches")]
    assert "torch.zeros" not in body and ".to(table.dtype)" not in body
