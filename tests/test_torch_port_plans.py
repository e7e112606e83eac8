"""Host-side logic of the port's redesigned kernels, on the CPU: the W^T
layouts ``ln_linear_bwd`` hands its dX kernel, the launch plans the dX
kernel and the float32 flash forward pick (``dx_plan``, ``fwd_plan``, mirrors
of the plans compiled into ``csrc/ln_linear_bwd.cu`` and
``csrc/flash_attention.cu``; a card test holds each mirror against the
library), and source checks of what each kernel reads.

Tolerance of the layout checks: 1e-5 of the largest value, float32
products summed in other orders.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from v1t_tpu_torch import _build
from v1t_tpu_torch.ops import flash_attention as fa
from v1t_tpu_torch.ops.ln_linear import (
    DX_MAX_SMEM, dx_plan, dx_weight, ln_linear_bwd_plain, merge_heads, padded_head_dim,
)

TOL = 1e-5
SMEM = 232448  # a block's shared memory on an H100


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


def test_dx_kernel_gathers_nothing_and_wgrad_keeps_its_gather():
    """The dX kernel copies dY in 16-byte granules, once per chunk it needs
    (no gather in its loop over output tiles); ln_linear_wgrad still reads dY
    through gather_dy4 and masks it through finish_dy4."""
    src = _source("ln_linear_bwd.cu")
    dx = _kernel_body(src, "ln_linear_dx_kernel")
    wgrad = _kernel_body(src, "ln_linear_wgrad_kernel")
    assert "gather" not in dx and "cp_async16(" in dx
    assert "if (!P.resident || s < NC) load_dy(s % NC, s);" in dx
    assert "gather_dy4(dy, L," in wgrad and "finish_dy4(raw_t[i], drop," in wgrad


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
