"""The port's flash attention (``v1t_tpu_torch.ops.flash_attention``) against
the JAX package's (``v1t_tpu.ops.flash_attention``, Pallas under the Mosaic
interpreter, ``V1T_PALLAS_INTERPRET=1``), on the CPU, where the port runs
the kernels' plain versions. Inputs come from numpy seeds at small sizes
(B*H <= 4, N 256-400, D 16-40); dropout is off in every comparison with JAX
(the two draw different masks) and checked against the port's own mask.

Tolerances: max|port - jax| <= tol * max|jax| with
- float32: 1e-5 (summation order, and exp2 of log2-scaled scores against
  exp: a few float32 ulps);
- bf16: 2e-2 (the probabilities round to bf16 before P.V on both sides, at
  values that differ by float32 ulps, so a rounding flips now and then: one
  bf16 step is 2^-8 = 3.9e-3 relative; gradients also round dS). The bf16
  scale's cotangent, a sum of B*N*D products, is held against the JAX
  package run in float32 on the same bf16-valued inputs, at the same 2e-2:
  JAX's own bf16 sum lands ~9 bf16 steps from it (reading: -92 against
  -96.5, the port -97.5), too far to be the reference.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from v1t_tpu.ops.flash_attention import flash_attention as jax_flash
from v1t_tpu.ops.flash_attention import flash_attention_with_lse as jax_flash_lse

from v1t_tpu_torch.ops import flash_attention as fa
from v1t_tpu_torch.ops.dropout import Dropout, keep_mask

torch.set_num_threads(2)

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("V1T_PALLAS_INTERPRET", "1")


def _close(port, ref, tol):
    port = np.asarray(port.detach().float().numpy(), np.float64)
    ref = np.asarray(jnp.asarray(ref, jnp.float32), np.float64)
    assert port.shape == ref.shape
    assert np.isfinite(port).all()
    err = np.abs(port - ref).max()
    assert err <= tol * np.abs(ref).max(), (err, np.abs(ref).max())


def _inputs(seed, b, h, nq, nk, d, dtype):
    """q, k, v, the output cotangent and a per-head scale, rounded once to
    the dtype so that both frameworks get identical values."""
    rng = np.random.default_rng(seed)
    arr = lambda *s: np.asarray(  # noqa: E731
        jnp.asarray(rng.normal(size=s), JNP[dtype]).astype(jnp.float32))
    scale = (d ** -0.5 * (1.0 + 0.2 * rng.normal(size=h))).astype(np.float32)
    return arr(b, h, nq, d), arr(b, h, nk, d), arr(b, h, nk, d), arr(b, h, nq, d), scale


def _leaf(a, dtype):
    return torch.from_numpy(np.array(a)).to(TORCH[dtype]).requires_grad_()


@pytest.mark.parametrize("dtype,use_lsa,shape", [
    ("float32", False, (1, 2, 300, 40)),
    ("float32", True, (2, 2, 256, 16)),
    ("bfloat16", False, (2, 2, 300, 24)),
    ("bfloat16", True, (1, 3, 400, 40)),
    # the wide tiles' head widths (padded 224 and 256), N no multiple of 64
    ("bfloat16", False, (1, 2, 100, 200)),
    ("bfloat16", True, (1, 1, 130, 256)),
    ("float32", True, (1, 2, 100, 200)),
    ("float32", False, (1, 1, 130, 256)),
], ids=str)
def test_flash_attention_forward_and_vjp_match_jax(interpret, dtype, use_lsa, shape):
    b, h, n, d = shape
    q, k, v, do, scale = _inputs(0, b, h, n, n, d, dtype)
    jq, jk, jv, jdo = (jnp.asarray(x, JNP[dtype]) for x in (q, k, v, do))
    fn = lambda q_, k_, v_, s_: jax_flash(q_, k_, v_, s_, use_lsa=use_lsa)  # noqa: E731
    ref, vjp = jax.vjp(fn, jq, jk, jv, jnp.asarray(scale))
    ref_grads = vjp(jdo)
    if dtype == "bfloat16":
        f32_args = [jnp.asarray(x) for x in (q, k, v, scale)]
        ref_grads = ref_grads[:3] + jax.vjp(fn, *f32_args)[1](jnp.asarray(do))[3:]
    tq, tk, tv = (_leaf(x, dtype) for x in (q, k, v))
    ts = torch.from_numpy(scale).requires_grad_()
    out = fa.flash_attention(tq, tk, tv, ts, use_lsa=use_lsa)
    assert out.shape == (b, h, n, d) and out.dtype == TORCH[dtype]
    _close(out, ref, TOL[dtype])
    out.backward(torch.from_numpy(do.copy()).to(TORCH[dtype]))
    for got, want in zip((tq.grad, tk.grad, tv.grad, ts.grad), ref_grads):
        _close(got, want, TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_with_lse_rectangular_matches_jax(interpret, dtype):
    """Nq != Nk, keys past n_real_k masked, a nonzero LSE cotangent."""
    b, h, nq, nk, d, n_real = 1, 2, 256, 384, 32, 300
    q, k, v, do, _ = _inputs(1, b, h, nq, nk, d, dtype)
    dlse = np.random.default_rng(2).normal(size=(b, h, nq)).astype(np.float32)
    jq, jk, jv, jdo = (jnp.asarray(x, JNP[dtype]) for x in (q, k, v, do))
    (ref_o, ref_lse), vjp = jax.vjp(
        lambda q_, k_, v_: jax_flash_lse(q_, k_, v_, n_real_k=n_real), jq, jk, jv)
    ref_grads = vjp((jdo, jnp.asarray(dlse)))
    tq, tk, tv = (_leaf(x, dtype) for x in (q, k, v))
    out, lse = fa.flash_attention_with_lse(tq, tk, tv, n_real_k=n_real)
    assert lse.dtype == torch.float32 and lse.shape == (b, h, nq)
    _close(out, ref_o, TOL[dtype])
    _close(lse, ref_lse, 1e-5)  # float32 on both sides
    torch.autograd.backward((out, lse), (torch.from_numpy(do.copy()).to(TORCH[dtype]),
                                         torch.from_numpy(dlse)))
    for got, want in zip((tq.grad, tk.grad, tv.grad), ref_grads):
        _close(got, want, TOL[dtype])
    assert float(tk.grad[:, :, n_real:].abs().max()) == 0.0  # masked keys get nothing


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("use_lsa", [False, True])
def test_chunked_plain_equals_unchunked(monkeypatch, dtype, use_lsa):
    """The plain versions in chunks of 16 query rows, dropout on (each chunk
    draws its own rows of the keep mask), against one chunk of all rows."""
    bh, n, d = 3, 70, 20
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.normal(size=(bh, n, 32)).astype(np.float32))
               .to(TORCH[dtype]) for _ in range(3))
    for x in (q, k, v):
        x[..., d:] = 0.0
    drop = Dropout(0.3, 77, 5)
    args = dict(use_lsa=use_lsa, drop=drop, n_real_k=None if use_lsa else 61)
    do = torch.from_numpy(rng.normal(size=(bh, n, 1, d)).astype(np.float32)).to(TORCH[dtype])
    dlse = torch.from_numpy(rng.normal(size=(bh, n)).astype(np.float32))

    def run():
        o, lse = fa.flash_fwd_plain(q, k, v, d, 1, with_lse=True, **args)
        return (o, lse) + tuple(fa.flash_bwd_plain(q, k, v, o, do, lse, d, 1, dlse=dlse, **args))

    monkeypatch.setattr(fa, "PLAIN_CHUNK_ELEMENTS", 1 << 30)
    whole = run()
    monkeypatch.setattr(fa, "PLAIN_CHUNK_ELEMENTS", 16 * bh * n)  # 16-row chunks
    assert fa._chunk_rows(bh, n) == 16
    for got, want in zip(run(), whole):
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def test_keep_mask_row_offset_is_a_slice_of_the_whole_mask():
    drop = Dropout(0.25, 123456, 7)
    whole = keep_mask(drop, 3, 50, 37)
    for r0, rows in ((0, 50), (13, 20), (49, 1)):
        assert torch.equal(keep_mask(drop, 3, rows, 37, row0=r0), whole[:, r0:r0 + rows])


def test_flash_dropout_keeps_the_rate_and_scales_kept_probabilities():
    """With q = 0 every probability is 1/N: o counts the kept keys of each
    residue class (v[k] = e_(k mod D)) times 1 / (N (1 - rate)), exactly as
    the keep mask says; the mean keep fraction is 1 - rate."""
    bh, n, d, rate = 2, 64, 32, 0.25
    q = torch.zeros(bh, n, d)
    k = torch.zeros(bh, n, d)
    v = torch.zeros(bh, n, d)
    v[:, torch.arange(n), torch.arange(n) % d] = 1.0
    drop = Dropout(rate, 99, 2)
    o = fa.flash_fwd_plain(q, k, v, d, 1, drop=drop)[:, :, 0]  # (BH, N, D)
    keep = keep_mask(drop, bh, n, n).float()
    counts = keep.view(bh, n, n // d, d).sum(2)
    torch.testing.assert_close(o, counts / (n * (1.0 - rate)), rtol=1e-6, atol=0.0)
    assert abs(float(keep.mean()) - (1.0 - rate)) < 0.02


@pytest.mark.parametrize("dp", [32, 64, 96, 128, 160, 192, 224, 256])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("nq", [1, 63, 257, 34114])
def test_backward_launch_plan(dtype, dp, nq):
    """bf16 takes the one-pass kernel and a float32 (BH, Nq, DP) dq
    accumulator at every width, whatever the ragged length: blocks of 128
    keys up to DP 160 and 64 above (hand-computed shared memory, e.g.
    231,448 bytes at DP 256: 1024 + K and V 2 x 64 x 256 x 2 + a 2-stage q
    / dO ring 2 x (2 x 64 x 256 x 2 + 512) + P and dS 2 x 64 x 64 x 2 + a
    float32 dq box of 16 x 32 for each of 8 warps + 24);
    float32 takes the one FFMA pass at every width, which adds dq into the
    output itself and allocates no accumulator (blocks of 64 keys, 32 above
    DP 160). Every block fits an H100's 232,448 bytes. The fixed-order
    form's int32 counters: a ticket and a turn a (plane, query tile), tiles
    of 64 queries in bf16 and 32 in float32."""
    plan = fa.bwd_plan(TORCH[dtype], 8, nq, dp)
    if dtype == "float32":
        assert plan.kernels == ("prep", "one_pass_f32") and plan.dq_acc is None
        assert plan.keys == (64 if dp <= 160 else 32)
        assert plan.order == 1 + 8 * -(-nq // 32)
    else:
        assert plan.kernels == ("prep", "one_pass", "dq_convert")
        assert plan.dq_acc == (8, nq, dp)
        assert plan.order == 1 + 8 * -(-nq // 64)
        assert plan.keys == (128 if dp <= fa.WIDE_DP else 64)
        if dp == 256:
            assert plan.smem == 1024 + 2 * 64 * 256 * 2 + 2 * (2 * 64 * 256 * 2 + 512) \
                + 2 * 64 * 64 * 2 + 8 * 16 * 32 * 4 + 24 == 231448
    assert plan.smem <= 232448


@pytest.mark.parametrize("dp", [0, 16, 100, 300])
def test_backward_launch_plan_rejects_unbuilt_widths(dp):
    """Widths that are no multiple of 32 (bf16 runs every multiple of 32:
    above 256 on column groups)."""
    with pytest.raises(ValueError):
        fa.bwd_plan(torch.bfloat16, 1, 64, dp)


@pytest.mark.parametrize("dp", [32, 64, 96, 128, 160, 192, 224, 256])
@pytest.mark.parametrize("n", [1, 63, 1654])
def test_attention_backward_launch_plan(dp, n):
    """The fused sublayer's attention backward at attention.cu's widths runs
    its prep, the one-pass kernel that flash_bwd also runs, its convert and
    the sum of the convert's dscale partials, with a float32 (B*H, N, DP) dq
    accumulator, a float32 (B*H, blocks) dscale scratch (a convert block
    takes 1024 float4s of a plane: 65 blocks at the flagship's N 1654, DP
    160) and the fixed-order form's counters; wider heads are not its
    kernels' (attention_bwd hands them to flash_bwd)."""
    from v1t_tpu_torch.ops.fused_mha import KERNEL_HEAD_PADS, attention_bwd_plan

    if dp not in KERNEL_HEAD_PADS:
        with pytest.raises(ValueError):
            attention_bwd_plan(64, 4, n, dp)
        return
    plan = attention_bwd_plan(64, 4, n, dp)
    assert plan.kernels == ("prep", "one_pass", "convert", "dscale_sum")
    assert plan.dq_acc == (256, n, dp)
    assert plan.dscale_part == (256, -(-(n * dp // 4) // 1024))
    assert plan.order == 1 + 256 * -(-n // 64)
    if (n, dp) == (1654, 160):
        assert plan.dscale_part == (256, 65) and plan.order == 1 + 256 * 26


def test_attention_backward_plan_rejects_grids_past_the_launch_limit():
    from v1t_tpu_torch.ops.fused_mha import attention_bwd_plan

    attention_bwd_plan(16383, 4, 100, 160)
    with pytest.raises(ValueError):
        attention_bwd_plan(16384, 4, 100, 160)


def test_attention_backward_runs_the_flash_one_pass():
    """attention_bwd.cu launches only its prep, convert and dscale-sum
    kernels of its own and reaches the one pass through one_pass::launch, which
    flash_attention_bwd.cu defines beside the one-pass kernel; the two-pass
    mma.sync kernels it replaced are gone."""
    import re

    from v1t_tpu_torch import _build

    def kernels(name):
        return set(re.findall(r"__global__ void (?:__launch_bounds__\([^)]*\) )?(\w+)\(",
                              open(f"{_build.CSRC_DIR}/{name}").read()))

    attn = open(f"{_build.CSRC_DIR}/attention_bwd.cu").read()
    flash = open(f"{_build.CSRC_DIR}/flash_attention_bwd.cu").read()
    assert kernels("attention_bwd.cu") == {"attention_bwd_prep_kernel",
                                           "attention_bwd_convert_kernel",
                                           "attention_bwd_dscale_kernel"}
    assert "one_pass::launch(" in attn and "int one_pass::launch(" in flash
    assert {"flash_bwd_one_pass_kernel", "flash_bwd_f32_kernel"} <= kernels(
        "flash_attention_bwd.cu")
    assert not {"flash_bwd_dq_f32_kernel", "flash_bwd_dkdv_f32_kernel"} & kernels(
        "flash_attention_bwd.cu")
    # the one pass is compiled from one source only
    for path in _build.sources():
        if not path.endswith("flash_attention_bwd.cu"):
            assert "flash_bwd_one_pass_kernel" not in open(path).read(), path


def test_backward_dispatch_width_matches_the_kernel_source():
    """The wrapper's plan and the tiles compiled into the backward kernel
    agree: where the wide tiling starts, the keys a block on either side,
    the query tiles and the ring; bf16 launches the one pass at every width
    and the two mma.sync passes it replaced are gone."""
    import re

    from v1t_tpu_torch import _build

    src = open(f"{_build.CSRC_DIR}/flash_attention_bwd.cu").read()
    assert int(re.search(r"constexpr int WIDE_DP = (\d+);", src).group(1)) == fa.WIDE_DP
    assert "constexpr int bwd_keys() { return wide<DP>() ? 64 : 128; }" in src
    # above WIDE_DP dq leaves through a float32 box a warp
    assert "dq_stage_bytes() { return wide<DP>() ? 8 * DQ_BOX_BYTES : 0; }" in src
    assert "constexpr int QB = 64, BWG = 128, BWD_THREADS = 2 * BWG, BWD_STAGES = 2;" in src
    assert "constexpr int f32_keys() { return DP <= 160 ? 64 : 32; }" in src
    assert "ONE_PASS_MAX_DP" not in src
    assert "flash_bwd_dq_kernel" not in src and "flash_bwd_dkdv_kernel" not in src
    for dp in (192, 224, 256):
        assert f"case {dp}: return launch_one_pass<{dp}>(" in src


def test_generated_wgmma_header_is_current():
    """csrc/wgmma.cuh is exactly what csrc/gen_wgmma.py writes, and names
    every width the flash kernels issue."""
    import importlib.util

    from v1t_tpu_torch import _build

    spec = importlib.util.spec_from_file_location("gen_wgmma",
                                                  f"{_build.CSRC_DIR}/gen_wgmma.py")
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    assert open(f"{_build.CSRC_DIR}/wgmma.cuh").read() == gen.render()
    assert set(range(32, 161, 32)) <= set(gen.SS_WIDTHS)
    assert set(range(32, 257, 32)) <= set(gen.RS_WIDTHS)
