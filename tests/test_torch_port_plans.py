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

import ctypes
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
    WGRAD_TARGET, WIDE_TILE, WL_CHUNK, WL_ROWS, WL_STAGES, WL_W_STAGES, dx_plan, dx_weight,
    forward_weight, linear_plan, ln_linear_bwd_plain, ln_linear_plain, merge_heads,
    padded_head_dim, wgrad_plan,
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
    up to K 640 the out-projection and fc2 keep dY' resident (read once);
    qkv and fc1 read it at most once per 160-column output tile (once up to
    emb 160, or when their dY' rows fit in shared memory). Past K 640 (the
    out-projection at 8 heads of 155 or 256, fc2 at MLP 768) the wgmma
    kernel's blocks copy it once per 256-column output tile."""
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
        if k > 640:
            assert plan.wgmma and plan.dy_reads == plan.k_tiles == -(-k // 256), (use, plan)
        elif use in ("out_proj", "fc2") or emb <= 160:
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
    other outputs split N evenly into tiles of at most 160 columns, or of
    at most 256 past K 640 (the wgmma kernel: the sweep's widest
    out-projections and fc2)."""
    for use, (n, k, hd, ln, aligned, res) in _forward_uses(emb, heads, mlp).items():
        plan = linear_plan(M_FLAGSHIP, n, k, hd, ln, aligned, res)
        if plan is None:  # only an x without LayerNorm, unaligned, wider than a panel
            assert not ln and not aligned and k > PANEL_MAX_K, use
            plan = linear_plan(M_FLAGSHIP, n, -(-k // 8) * 8, hd, ln, True, res)
        assert plan is not None and plan.smem <= SMEM, use
        assert plan.wgmma == (k > PANEL_MAX_K), use
        assert plan.tile % 32 == 0 and plan.tile <= (256 if plan.wgmma else 160)
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
    # past a panel: the wgmma kernel's tiles, ring and staged rows
    wl = fwd[fwd.index("namespace wl {"):]
    consts = {n: int(v) for n, v in re.findall(r"(\w+) = (\d+)[,;]", wl[:wl.index("}")])}
    assert (consts["ROWS"], consts["TILE"], consts["CHUNK"], consts["X_STAGES"],
            consts["W_STAGES"]) == (WL_ROWS, WIDE_TILE, WL_CHUNK, WL_STAGES, WL_W_STAGES)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
@pytest.mark.parametrize("dp", [32, 64, 96, 128, 160, 192, 224, 256])
def test_forward_launch_plan(dtype, dp):
    """float32: 128 queries a block (8 rows a thread) up to DP 160 and 64
    above, key tiles of 64; bf16: 128 queries, key tiles of 64, two q panels
    and a ring 3 deep up to DP 160, one q panel above with the ring as deep
    as fits, 3 to DP 224 and 2 at 256, and barriers for K and V apart
    (hand-computed shared memory: 1024 + (128 + 2 x stages x 64) x DP x 2 +
    (4 + 4 x stages) x 8 bytes, 197,760 / 230,528 / 197,728 at DP 192 / 224
    / 256). All fit a block's shared memory."""
    plan = fa.fwd_plan(dtype, dp)
    if dtype == torch.float32:
        assert (plan.queries, plan.keys) == ((128 if dp <= 160 else 64), 64)
    else:
        wide = {192: (3, 197760), 224: (3, 230528), 256: (2, 197728)}
        assert (plan.queries, plan.keys) == (128, 64)
        assert (plan.q_panels, plan.stages) == ((2, 3) if dp <= 160 else (1, wide[dp][0]))
        if dp > 160:
            assert plan.smem == wide[dp][1] == 1024 + (128 + 2 * plan.stages * 64) * dp * 2 + (
                4 + 4 * plan.stages) * 8
    assert plan.smem <= SMEM


@pytest.mark.parametrize("dp", [0, 16, 100, 300])
def test_forward_launch_plan_rejects_unbuilt_widths(dp):
    with pytest.raises(ValueError):
        fa.fwd_plan(torch.float32, dp)


def test_forward_plan_tiles_match_the_kernel_source():
    src = _source("flash_attention.cu")
    # bf16: key tiles of 64 at every width; one q panel above WIDE_DP, the
    # ring as deep as fits
    assert "constexpr int BKV = 64;" in src
    assert f"constexpr bool fwd_wide() {{ return DP > {fa.WIDE_DP}; }}" in src
    assert "constexpr int fwd_q_panels() { return fwd_wide<DP>() ? 1 : 2; }" in src
    assert "constexpr int fwd_stages() { return DP <= 224 ? 3 : 2; }" in src
    assert "(fwd_q_panels<DP>() * BQ + 2 * fwd_stages<DP>() * BKV)" in src
    assert "(4 + 2 * fwd_stages<DP>() * (fwd_wide<DP>() ? 2 : 1)) * 8" in src
    # above WIDE_DP the consumers take 240 registers a thread (the producer 24)
    assert "producer_regs() { return fwd_wide<DP>() ? 24 : 40; }" in src
    assert "consumer_regs() { return fwd_wide<DP>() ? 240 : 232; }" in src
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
    # persistent: min(items, SMs) blocks, items (query tile, plane), q panels
    assert "<<<items < sms ? items : sms, FWD_THREADS, bytes, stream>>>" in flash
    assert "const int qt = w % q_tiles, bh = w / q_tiles, qb = QP == 2 ? it & 1 : 0;" in body
    assert "(fwd_q_panels<DP>() * BQ + 2 * fwd_stages<DP>() * BKV)" in flash
    assert "constexpr int fwd_q_panels() { return fwd_wide<DP>() ? 1 : 2; }" in flash
    assert "constexpr int fwd_stages() { return DP <= 224 ? 3 : 2; }" in flash


# (C, height, width) -> (channels a block, rows a band, chunks, bands, smem, staged)
SAMPLE_BWD_CASES = {
    "flagship 29x57": ((155, 29, 57), (5, 29, 31, 1, 5 * 29 * 57 * 12, True)),
    "full-res 137x249": ((155, 137, 249), (1, 46, 155, 3, 46 * 249 * 8, False)),
    "300x300, two bands": ((3, 300, 300), (1, 43, 3, 7, 43 * 300 * 8, False)),
    "1x2, every channel": ((7, 1, 2), (7, 1, 1, 1, 7 * 2 * 12, True)),
    "2000x100, 4 bands": ((2, 2000, 100), (1, 143, 2, 14, 143 * 100 * 8, False)),
    "37 channels, 5 chunks": ((37, 29, 57), (5, 29, 8, 1, 5 * 29 * 57 * 12, True)),
}


@pytest.mark.parametrize("case", sorted(SAMPLE_BWD_CASES))
def test_sample_bwd_launch_plan(case):
    """d(table) of a block's channels stays in shared memory in 64-bit fixed
    point, their table beside it where the map fits: the flagship's 29 x 57
    map (19,836 bytes a channel: 8 of d(table) and a 4-byte table slot a
    cell) takes 5 channels a block within half a SM (two blocks a SM), 155
    split evenly over 31 chunks of 5; the full-resolution 137 x 249 map
    (272,904 bytes of d(table) alone) one channel a block in three bands of
    46 rows (58 rows of 249 cells fit half a SM), its table in global
    memory; a 300 x 300 map seven bands of 43 rows (48 fit). The fp32 model's map is
    the flagship's: the table's slot is 4 bytes in either dtype. More than
    one chunk takes (chunks, B, P, 2) float32 d(grid) partials."""
    from v1t_tpu_torch.ops.interp_matmul import (
        BWD_MAX_SMEM, BWD_PAIR_SMEM, dgrid_part, sample_bwd_plan,
    )

    shape, want = SAMPLE_BWD_CASES[case]
    plan = sample_bwd_plan(*shape)
    assert tuple(plan) == want
    c, height, width = shape
    assert plan.channels * plan.chunks >= c > plan.channels * (plan.chunks - 1)
    assert plan.band_rows * plan.bands >= height > plan.band_rows * (plan.bands - 1)
    staged = height * width * 12
    assert plan.staged == (staged <= BWD_MAX_SMEM)
    assert plan.smem <= (BWD_PAIR_SMEM if staged <= BWD_PAIR_SMEM or width * 8 <= BWD_PAIR_SMEM
                         else BWD_MAX_SMEM)
    assert 2 * (BWD_PAIR_SMEM + 1024) <= 233472 and BWD_MAX_SMEM == SMEM
    assert dgrid_part(plan, 64, 7000) == (None if plan.chunks == 1 else (plan.chunks, 64, 7000, 2))


def test_sample_bwd_launch_plan_rejects_a_row_past_shared_memory():
    from v1t_tpu_torch.ops.interp_matmul import sample_bwd_plan

    assert sample_bwd_plan(1, 3, 29056).bands == 3  # 8 bytes a cell: 29,056 x 8 = 232,448
    with pytest.raises(ValueError):
        sample_bwd_plan(1, 3, 29057)


def test_sample_bwd_plan_constants_match_the_kernel_source():
    from v1t_tpu_torch.ops.interp_matmul import BWD_MAX_SMEM, BWD_PAIR_SMEM

    src = _source("bilinear_sample.cu")
    consts = {n: int(v) for n, v in re.findall(r"constexpr int (\w+) = (\d+);", src)}
    assert (consts["BWD_MAX_SMEM"], consts["BWD_PAIR_SMEM"]) == (BWD_MAX_SMEM, BWD_PAIR_SMEM)


def test_sample_bwd_kernel_adds_nothing_to_global_dtable():
    """The backward adds d(table) only into shared memory, as 64-bit
    integers (fixed point: integer adds commute, so reruns agree bit for
    bit), and writes it once in the table's dtype; it has no global atomic:
    d(grid) is written once per (b, p, chunk) by the band that owns the
    point and the chunks' partials are summed in chunk order by a kernel of
    its own; the float32 scratch and cast are gone from the wrapper."""
    src = _source("bilinear_sample.cu")
    body = _kernel_body(src, "bilinear_sample_cm_bwd_kernel")
    assert re.findall(r"atomicAdd\((\w+)", body) == [] and "add_fixed(a + local[i]" in body
    assert "unsigned long long* a = acc + c * cells;" in body
    add = _kernel_body(src, "add_fixed")
    assert re.findall(r"atomicAdd\((\w+)", add) == ["word", "word"]
    assert "unsigned int* word" in add
    assert "extern __shared__ unsigned long long acc[];" in body and "T* __restrict__ dtable" in body
    assert "__ll2float_rn((long long)acc[i]) * from_fixed" in body
    assert "for (int i = threadIdx.x; i < nc * HW; i += BWD_THREADS) tab[i] = tb[i];" in body
    total = _kernel_body(src, "bilinear_dgrid_sum_kernel")
    assert "for (int c = 1; c < chunks; ++c)" in total and "atomic" not in total
    wrapper = open(f"{_build.CSRC_DIR}/../ops/interp_matmul.py").read()
    body = wrapper[wrapper.index("def bilinear_sample_cm_bwd("):]
    body = body[:body.index("\nbilinear_sample_cm_bwd.launches")]
    assert "torch.zeros" not in body and ".to(table.dtype)" not in body


BF16, F32 = torch.bfloat16, torch.float32
# (C, height, width, dtype) -> (channels a block, chunks, smem, staged)
SAMPLE_FWD_CASES = {
    "flagship bf16 29x57": ((155, 29, 57, BF16), (8, 20, 8 * 1653 * 2, True)),
    "sweep-widest C 256": ((256, 29, 57, BF16), (8, 32, 8 * 1653 * 2, True)),
    "fp32 29x57": ((155, 29, 57, F32), (4, 39, 4 * 1653 * 4, True)),
    "full-res bf16 137x249": ((155, 137, 249, BF16), (1, 155, 34113 * 2, True)),
    "full-res fp32 137x249": ((155, 137, 249, F32), (1, 155, 34113 * 4, True)),
    "1x2, one block": ((7, 1, 2, BF16), (8, 1, 8 * 2 * 2, True)),
    "C 11, a partial block": ((11, 29, 57, BF16), (8, 2, 8 * 1653 * 2, True)),
    "C 3, one partial block": ((3, 29, 57, BF16), (8, 1, 8 * 1653 * 2, True)),
    "4 bf16 channels a word": ((5, 60, 100, BF16), (4, 2, 4 * 6000 * 2, True)),
    "2 channels a word": ((5, 100, 100, BF16), (2, 3, 2 * 10000 * 2, True)),
    "two blocks a SM": ((5, 200, 250, BF16), (1, 5, 50000 * 2, True)),
    "a channel fills a block": ((2, 2, 58112, BF16), (1, 2, 232448, True)),
    "bf16 past a block": ((3, 400, 300, BF16), (1, 3, 0, False)),
    "fp32 past a block": ((2, 250, 250, F32), (1, 2, 0, False)),
}


@pytest.mark.parametrize("case", sorted(SAMPLE_FWD_CASES))
def test_sample_fwd_launch_plan(case):
    """The forward stages G channels of one image in shared memory, one
    cell's word of G channels: at the flagship's 29 x 57 bf16 map (3,306
    bytes a channel) 8 channels a 16-byte word (26,448 bytes a block; the
    registers hold a SM to 4 blocks), 155 channels in 20 blocks an image,
    C 256 in 32; the fp32 map 4 channels a word, 39 blocks; the
    full-resolution 137 x 249 map (68,226 bytes a bf16 channel) one channel
    a block, 3 blocks a SM, and in float32 (136,452) one block a SM; a
    channel past a block's 232,448 bytes is gathered from global memory, a
    block a channel."""
    from v1t_tpu_torch.ops.interp_matmul import (
        BLOCK_RESERVE, FWD_BLOCKS_PER_SM, SM_SMEM, sample_fwd_plan,
    )

    shape, want = SAMPLE_FWD_CASES[case]
    plan = sample_fwd_plan(*shape)
    assert tuple(plan) == want
    c, height, width, dtype = shape
    elem = 4 if dtype == F32 else 2
    plane = height * width * elem
    assert plan.staged == (plane <= SM_SMEM - BLOCK_RESERVE == SMEM)
    assert plan.group * plan.chunks >= c > plan.group * (plan.chunks - 1)
    if not plan.staged:
        assert (plan.group, plan.smem) == (1, 0)
        return
    assert plan.group * elem <= 16 and plan.smem == plan.group * plane <= SMEM
    # the widest word that fits the SM's share at as many blocks as a
    # channel allows, up to FWD_BLOCKS_PER_SM
    per_sm = min(FWD_BLOCKS_PER_SM, SM_SMEM // (plane + BLOCK_RESERVE))
    share = SM_SMEM // per_sm - BLOCK_RESERVE
    assert plan.smem <= share
    assert plan.group == 16 // elem or 2 * plan.smem > share


def test_sample_fwd_plan_fills_the_flagship_sms():
    """4 blocks share a SM at the flagship's map (the 64-register bound of
    its launch), and its 64 images' 1280 blocks make 2.4 waves over the
    card's 132 SMs."""
    from v1t_tpu_torch.ops.interp_matmul import (
        BLOCK_RESERVE, FWD_BLOCKS_PER_SM, SM_SMEM, sample_fwd_plan,
    )

    plan = sample_fwd_plan(155, 29, 57, BF16)
    per_sm = min(FWD_BLOCKS_PER_SM, SM_SMEM // (plan.smem + BLOCK_RESERVE))
    assert per_sm == 4 and 65536 // (256 * 64) == 4
    assert 2.4 < 64 * plan.chunks / (SMS * per_sm) < 2.5


def test_sample_fwd_plan_constants_match_the_kernel_source():
    """The plan's constants and group widths are the kernel source's: 16
    bytes a cell (8 bf16 or 4 float32 channels), halved to 1; every width
    the plan can pick has a kernel instantiation behind the launch, and
    the library's plan has the mirror's fields."""
    from v1t_tpu_torch.ops import interp_matmul as im

    src = _source("bilinear_sample.cu")
    consts = {n: int(v) for n, v in re.findall(r"constexpr int (\w+) = (\d+);", src)}
    assert (consts["SM_SMEM"], consts["BLOCK_RESERVE"], consts["FWD_BLOCKS_PER_SM"]) == (
        im.SM_SMEM, im.BLOCK_RESERVE, im.FWD_BLOCKS_PER_SM)
    assert consts["THREADS"] == 256 and consts["STAGE_LOADS"] % 8 == 0
    assert "__launch_bounds__(THREADS, FWD_BLOCKS_PER_SM)" in src
    plan = _kernel_body(src, "SampleFwdPlan sample_fwd_plan")
    assert "int g = f32 ? 4 : 8;" in plan and "g >>= 1;" in plan
    assert "struct SampleFwdPlan {\n  int group, chunks, smem, staged;\n};" in src
    assert "const int fields[4] = {p.group, p.chunks, p.smem, p.staged};" in src
    assert list(im.SampleFwdPlan._fields) == ["group", "chunks", "smem", "staged"]
    launch = _kernel_body(src, "int launch_fwd")
    for g in (1, 2, 4, 8):
        assert f"return launch_fwd_group<T, {g}>(plan" in launch
    widths = {p.group for dtype in (BF16, F32) for c in (1, 3, 155, 256)
              for hw in ((1, 2), (29, 57), (100, 100), (137, 249), (200, 250), (2, 58112),
                         (400, 300))
              for p in [im.sample_fwd_plan(c, *hw, dtype)]}
    assert widths == {1, 2, 4, 8}
    assert _build.SIGNATURES["v1t_bilinear_sample_cm_plan"] == [ctypes.c_int] * 5


def test_sample_fwd_kernel_gathers_only_from_shared_memory():
    """The staged branch reads the block's table once into shared memory
    (each cell once, G channels a word) and gathers only from there: a
    shared-memory load a corner that returns G channels; the one global
    gather of the table is the unstaged branch's (G = 1). No atomics;
    outputs leave as pairs of adjacent points a thread."""
    src = _source("bilinear_sample.cu")
    kernel = _kernel_body(src, "bilinear_sample_cm_kernel")
    assert ("if (staged) {\n    stage<T, G>(tb, words, cells, nc);\n    __syncthreads();"
            "\n    walk<T, G, true>(") in kernel
    assert "} else if constexpr (G == 1) {" in kernel and kernel.count("walk<") == 2
    stage = _kernel_body(src, "void stage")
    assert "for (int base = threadIdx.x; base < cells; base += THREADS * U) {" in stage
    assert stage.count("__ldg(") == 1 and "sts<BYTES>(words + (uint32_t)(cell * BYTES), r);" \
        in stage
    walk = _kernel_body(src, "void walk")
    # the table's one global gather (the unstaged branch); the rest read the grid
    assert walk.count("__ldg(src") == 1 and walk.count("lds<BYTES>(") == 1
    assert walk.count("__ldg(") == walk.count("__ldg(g") + 1
    assert ("if constexpr (STAGED)\n          lds<BYTES>(words + (uint32_t)(cell[k][i] * BYTES), "
            "r);\n        else\n          r[0] = __ldg(src + cell[k][i]);") in walk
    assert "atomic" not in kernel + stage + walk
    assert "store_pair(o, acc[0][j], acc[1][j]);" in walk
    assert "for (int q = threadIdx.x; 2 * q < P; q += THREADS) {" in walk
