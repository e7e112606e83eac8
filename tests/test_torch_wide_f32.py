"""The port's float32 flash attention past padded head width 256 (the
column groups of ``csrc/flash_attention.cu`` and
``csrc/flash_attention_bwd.cu`` on the card), against the JAX package on
the CPU.

Here a CPU tensor takes the kernels' plain versions; the JAX package's
Pallas kernels run under the Mosaic interpreter
(``V1T_PALLAS_INTERPRET=1``), as ``tests/test_torch_port_flash.py`` runs
them, in both of the forms it picks between by the size of K and V: the
whole-K kernels (``V1T_FLASH_DT_BLOCKED=0``; what small N takes) and the
blocked transposed ones (``=1``: ``_fwd_kernel_dt``, ``_dq_kernel_dt``,
``_dkv_kernel_dt``, what the emb-768 path's N 1654 takes, since its K and V
pass the whole-K kernels' 10 MB). Inputs come from numpy seeds: heads of
288 and 768 (and 700, padded to 704: a narrower last group), N <= 130,
``flash_attention`` with LSA and a per-head scale, forward and vjp, and
``flash_attention_with_lse`` rectangular (70 queries against 130 keys,
keys past n_real_k 100 masked, an LSE cotangent). The float32 plans past
256 are pinned against the kernel sources. The CUDA kernels themselves run
only on a GPU (``python3 chip_smoke.py``, phases 3d and 5m).

Tolerance: max|port - jax| <= 1e-5 * max|jax| (float32 on both sides:
summation order, exp2 of log2-scaled scores against exp), the float32 TOL
of ``tests/test_torch_port_flash.py``.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import v1t_tpu.ops.flash_attention as jax_fa
from v1t_tpu.ops.flash_attention import flash_attention as jax_flash
from v1t_tpu.ops.flash_attention import flash_attention_with_lse as jax_flash_lse

from v1t_tpu_torch import _build
from v1t_tpu_torch.ops import flash_attention as fa
from v1t_tpu_torch.ops.ln_linear import SMEM_LIMIT

torch.set_num_threads(2)

TOL = 1e-5
FORMS = {"whole_k": "0", "dt_blocked": "1"}


@pytest.fixture(params=sorted(FORMS))
def jax_form(request, monkeypatch):
    """The JAX package's Pallas kernels under the interpreter, in one of its
    two forms; counts the blocked transposed form's calls, to show which
    one ran."""
    monkeypatch.setenv("V1T_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("V1T_FLASH_DT_BLOCKED", FORMS[request.param])
    calls = {"fwd": 0, "bwd": 0}
    for name, key in (("_flash_forward_dt", "fwd"), ("_flash_backward_dt", "bwd")):
        fn = getattr(jax_fa, name)

        def spy(*args, _fn=fn, _key=key, **kwargs):
            calls[_key] += 1
            return _fn(*args, **kwargs)

        monkeypatch.setattr(jax_fa, name, spy)
    yield request.param, calls
    want = 1 if request.param == "dt_blocked" else 0
    assert calls == {"fwd": want, "bwd": want}, calls


def _close(port, ref):
    port = np.asarray(torch.as_tensor(port).detach().double().numpy())
    ref = np.asarray(jnp.asarray(ref, jnp.float32), np.float64)
    assert port.shape == ref.shape and np.isfinite(port).all()
    err = np.abs(port - ref).max()
    assert err <= TOL * np.abs(ref).max(), (err, np.abs(ref).max())


def _inputs(seed, h, nq, nk, d):
    rng = np.random.default_rng(seed)
    arr = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    scale = (d ** -0.5 * (1.0 + 0.2 * rng.normal(size=h))).astype(np.float32)
    return arr(1, h, nq, d), arr(1, h, nk, d), arr(1, h, nk, d), arr(1, h, nq, d), scale


def _leaf(a):
    return torch.from_numpy(a.copy()).requires_grad_()


@pytest.mark.parametrize("d,n,use_lsa", [(288, 100, True), (768, 100, True),
                                         (700, 130, False)], ids=str)
def test_float32_flash_past_256_matches_jax(jax_form, d, n, use_lsa):
    """softmax(scale q k^T) v and its vjp (q, k, v and the per-head scale)."""
    q, k, v, do, scale = _inputs(40 + d, 2, n, n, d)
    fn = lambda q_, k_, v_, s_: jax_flash(q_, k_, v_, s_, use_lsa=use_lsa)  # noqa: E731
    ref, vjp = jax.vjp(fn, *(jnp.asarray(x) for x in (q, k, v, scale)))
    ref_grads = vjp(jnp.asarray(do))
    tq, tk, tv, ts = (_leaf(x) for x in (q, k, v, scale))
    out = fa.flash_attention(tq, tk, tv, ts, use_lsa=use_lsa)
    assert out.dtype == torch.float32 and out.shape == (1, 2, n, d)
    _close(out, ref)
    out.backward(torch.from_numpy(do.copy()))
    for got, want in zip((tq.grad, tk.grad, tv.grad, ts.grad), ref_grads):
        _close(got, want)


@pytest.mark.parametrize("d", [288, 768])
def test_float32_flash_with_lse_past_256_rectangular_matches_jax(jax_form, d):
    """Nq != Nk, keys past n_real_k masked, a nonzero LSE cotangent; q
    carries the softmax scale d^-0.5, as the sequence-parallel callers'
    does (unscaled, the scores of unit normals at D 768 reach ~100 and a
    float32 ulp of them moves P by ~1e-5)."""
    nq, nk, n_real = 70, 130, 100
    q, k, v, do, _ = _inputs(50 + d, 2, nq, nk, d)
    q = (q * d ** -0.5).astype(np.float32)
    dlse = np.random.default_rng(51).normal(size=(1, 2, nq)).astype(np.float32)
    (ref_o, ref_lse), vjp = jax.vjp(lambda q_, k_, v_: jax_flash_lse(q_, k_, v_, n_real_k=n_real),
                                    *(jnp.asarray(x) for x in (q, k, v)))
    ref_grads = vjp((jnp.asarray(do), jnp.asarray(dlse)))
    tq, tk, tv = (_leaf(x) for x in (q, k, v))
    out, lse = fa.flash_attention_with_lse(tq, tk, tv, n_real_k=n_real)
    _close(out, ref_o)
    _close(lse, ref_lse)
    torch.autograd.backward((out, lse), (torch.from_numpy(do.copy()), torch.from_numpy(dlse)))
    for got, want in zip((tq.grad, tk.grad, tv.grad), ref_grads):
        _close(got, want)
    assert float(tk.grad[:, :, n_real:].abs().max()) == 0.0


# --- the float32 plans past 256 ------------------------------------------------------

def _source(name):
    with open(f"{_build.CSRC_DIR}/{name}") as f:
        return f.read()


@pytest.mark.parametrize("dp,groups,cols", [(288, 2, 160), (384, 2, 192), (704, 3, 256),
                                            (768, 3, 256), (1024, 4, 256), (2048, 8, 256),
                                            (2080, 9, 256), (4096, 16, 256)])
def test_float32_column_group_plans(dp, groups, cols):
    """float32 past DP 256: the bf16 kernels' groups; one shared-memory size
    at every width of a form, within a block's 232,448 bytes; the
    fixed-order counters a turn a (plane, group, query tile of 32). Up to 8
    groups (DP 2048) the 3xTF32 cluster kernels, the groups of a tile one
    cluster (hand-computed, tiles unpadded: forward q [64][256], K and V
    [2][32][256], two partial score buffers and P's two parts [64][32], 64
    rescales: (16,384 + 32,768 + 8192 + 64) x 4 = 229,632; backward K and V
    [32][256], q and dO [2][32][256], the S and dP partials [2][2][32][32],
    the parts of Z P and dS [4][32][32], lse and delta [2][32] each:
    (49,152 + 4096 + 4096 + 128) x 4 = 229,888). Past 8 groups the FFMA
    kernels, no cluster (forward two stages of a q and a K chunk [64][68] +
    4 floats every 8 rows, V's group [64][260] + 32, P [64][68]: (4 x 4384 +
    16,672 + 4352) x 4 = 154,240; backward two stages of four [32][68]
    chunks, the K, q and dO group columns [32][260], P and dS [32][36], lse
    and delta: (17,408 + 3 x 8320 + 2304 + 64) x 4 = 178,944)."""
    f = fa.fwd_plan(torch.float32, dp)
    b = fa.bwd_plan(torch.float32, 8, 1000, dp)
    assert (f.groups, f.group_cols, b.groups, b.group_cols, b.keys) == (
        groups, cols, groups, cols, 32)
    assert b.dq_acc is None and b.order == 1 + 8 * groups * 32
    if groups <= fa.F32_CLUSTER_GROUPS:
        assert (f.queries, f.keys, f.q_panels, f.stages, f.cluster) == (64, 32, 1, 2, groups)
        assert f.smem == 229632 <= SMEM_LIMIT
        assert b.kernels == ("prep", "one_pass_f32_cluster") and b.cluster == groups
        assert b.smem == 229888 <= SMEM_LIMIT
    else:
        assert (f.queries, f.keys, f.q_panels, f.stages, f.cluster) == (64, 64, 0, 2, 1)
        assert f.smem == 154240 <= SMEM_LIMIT
        assert b.kernels == ("prep", "one_pass_f32_wide") and b.cluster == 1
        assert b.smem == 178944 <= SMEM_LIMIT


def test_float32_column_groups_match_the_kernel_sources():
    fwd, bwd = _source("flash_attention.cu"), _source("flash_attention_bwd.cu")
    consts = lambda src: {n: int(v) for n, v in re.findall(r"(\w+) = (\d+)[,;]", src)}  # noqa: E731
    f, b = consts(fwd), consts(bwd)
    # the bf16 groups' split and chunk width, 64 query rows / 32 keys a block
    assert (f["WIDE_OG"], f["WIDE_CW"], f["F32_KB"], f["F32_THREADS"]) == (
        fa.WIDE_GROUP, fa.WIDE_CHUNK, 64, 256)
    assert (b["WB_OG"], b["WB_CW"], b["F32_QT"], b["THREADS"]) == (
        fa.WIDE_GROUP, fa.WIDE_CHUNK, 32, 256)
    assert "constexpr int RQ = 4, QB = 16 * RQ, KB = F32_KB, CW = WIDE_CW;" in fwd
    assert "constexpr int KB = 32, QT = F32_QT, CW = WB_CW, OG = WB_OG;" in bwd
    # the shared memory each source computes is the plans'
    assert ("return (2 * 2 * f32_tile_floats(F32_KB, WIDE_CW) + f32_tile_floats(F32_KB, "
            "WIDE_OG) +\n          F32_KB * (F32_KB + 4)) * (int)sizeof(float);") in fwd
    assert ("return (2 * 4 * F32_QT * (WB_CW + 4) + 32 * (WB_OG + 4) + 2 * F32_QT * (WB_OG + 4) "
            "+\n          2 * F32_QT * (32 + 4) + 2 * F32_QT) * (int)sizeof(float);") in bwd
    # past 8 groups the FFMA kernels' shared memory, up to 8 the clusters'
    assert ("wide_groups(dp) <= C_MAX_GROUPS ? f32_cluster_smem_bytes() : "
            "f32_wide_smem_bytes();") in fwd
    assert ("wb_groups(dp) <= CB_MAX_GROUPS ? f32_cluster_bwd_smem_bytes() : "
            "f32_wide_bwd_smem_bytes();") in bwd
    # one instance a training flag forward, one backward, whatever the width
    assert "template <bool TRAIN>\n__global__ void __launch_bounds__(F32_THREADS, 1) " \
           "flash_fwd_f32_wide_kernel(" in fwd
    assert "__global__ void __launch_bounds__(THREADS, 1) flash_bwd_f32_wide_kernel(" in bwd
    # every group draws the element-keyed keep mask; group 0 writes the LSE;
    # dq in key order under `order`, a turn a (plane, group, query tile)
    assert fwd.count("keep_words(drop, (uint32_t)bh, (uint32_t)row, (uint32_t)key0 >> 2)") == 2
    assert "if (gi == 0 && lse != nullptr && cl == 0)" in fwd
    assert "order + 1 + ((size_t)bh * groups + gi) * ntiles" in bwd
    assert "(size_t)BH * groups * ((Nq + F32_QT - 1) / F32_QT)" in bwd
    # the wrappers no longer refuse float32 past 256
    assert "queue 3 item 1" not in open(fa.__file__).read()


CLUSTER_SOURCES = {
    "forward": ("flash_attention.cu", "C_", "flash_fwd_f32_cluster_kernel",
                "template <bool TRAIN>\n__global__ void __launch_bounds__(C_THREADS, 1) "
                "flash_fwd_f32_cluster_kernel(",
                "return (C_QB * C_OG + 4 * C_TILE + 2 * C_QB * C_KB + 2 * C_QB * C_KB + C_QB) *"),
    "backward": ("flash_attention_bwd.cu", "CB_", "flash_bwd_f32_cluster_kernel",
                 "__global__ void __launch_bounds__(CB_THREADS, 1) flash_bwd_f32_cluster_kernel(",
                 "return (2 * CB_TILE + 4 * CB_TILE + 2 * 2 * CB_SQ + 4 * CB_SQ + "
                 "2 * 2 * CB_QT) *"),
}


@pytest.mark.parametrize("direction", sorted(CLUSTER_SOURCES))
def test_float32_cluster_groups_match_the_kernel_sources(direction):
    """The 3xTF32 cluster kernels' constants are the plans' (64 queries / 32
    keys a block, key or query tiles of 32, groups of 256, at most 8 a
    cluster, 256 threads), their shared memory is summed as the plans sum it,
    one instance a training flag (forward) or one (backward) at every width;
    the products are 3xTF32 m16n8k8 (tf32.cuh), the partials summed through
    distributed shared memory in group order, no group recomputing them."""
    name, pre, kernel, decl, smem = CLUSTER_SOURCES[direction]
    src = _source(name)
    consts = {n: int(v) for n, v in re.findall(r"(\w+) = (\d+)[,;]", src)}
    if direction == "forward":
        assert (consts["C_QB"], consts["C_KB"], consts["C_OG"], consts["C_THREADS"],
                consts["C_MAX_GROUPS"]) == (64, 32, fa.WIDE_GROUP, 256, fa.F32_CLUSTER_GROUPS)
    else:
        assert (consts["CB_KB"], consts["CB_QT"], consts["CB_OG"], consts["CB_THREADS"],
                consts["CB_MAX_GROUPS"]) == (32, 32, fa.WIDE_GROUP, 256, fa.F32_CLUSTER_GROUPS)
    assert decl in src and smem in src
    assert src.count(kernel) >= 3  # defined, its attribute set, launched
    assert '#include "tf32.cuh"' in src and "cudaLaunchAttributeClusterDimension" in src
    body = src[src.index(decl):]
    body = body[:body.index("\n}\n")]
    # the partials of every group summed in group order 0 .. G - 1, from
    # group 0's, in every block alike
    assert "for (int r = 0; r < G; ++r) {\n        const float* rp = " \
           "cluster.map_shared_rank(sp, r);" in body
    assert body.count("r == 0 ? ") in (1, 2)
    assert "hopper::cluster_arrive();" in body and "hopper::cluster_wait();" in body
    # the products on the tensor cores in 3xTF32 only: no FFMA dot products
    assert "tf32::mma3(" in body and "dot4(" not in body and "fma4(" not in body
    helpers = _source("tf32.cuh")
    # cvt.rna.tf32.f32's rounding of a finite value, in two integer instructions
    assert "return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;" in helpers
    assert "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32" in helpers
    assert "mma(c, as, bb);\n  mma(c, ab, bs);\n  mma(c, ab, bb);" in helpers
