"""The arithmetic of the float32 flash kernels past padded head width 256
(``csrc/flash_attention.cu`` ``flash_fwd_f32_cluster_kernel``,
``csrc/flash_attention_bwd.cu`` ``flash_bwd_f32_cluster_kernel``), emulated
in plain PyTorch on the CPU and held against the JAX package's float32 flash
attention forward and backward.

The kernels take every product on the tensor cores in three TF32 terms
(``csrc/tf32.cuh``): each float32 operand x splits into big = tf32(x) and
small = tf32(x - big), rounded to nearest (ties away from zero) on the 13
low bits of its bit pattern, and a b is small_a big_b + big_a small_b +
big_a big_b in float32. The emulation applies that split to each of the
forward's two products (S = q k^T, o = P v) and the backward's five (S, dP
= dO v^T, dq = dS k, dk = dS^T q, dv = P^T dO), sums the scores (and dP)
of the column groups in group order, as a cluster's blocks do, and
otherwise follows the kernels: scores in base 2, masked keys at
``MASKED``, the LSE's cotangent folded into delta.

The JAX side runs as ``tests/test_torch_wide_f32.py`` runs it: its Pallas
kernels under the Mosaic interpreter, in both of its forms (whole-K and
blocked transposed). Inputs from numpy seeds: heads of 288 (two groups of
160 and 128 columns) and 768 (three of 256), N <= 130, LSA, and a
rectangular case with keys past n_real_k masked and an LSE cotangent.

Tolerance: ``F32_KERNEL_TOL`` = 2e-5 of the largest reference element, the
float32 kernels' bound on the card (``chip_smoke.py``). One TF32 product
alone (big_a big_b) keeps 11 bits: ``test_one_tf32_term_misses_the_tolerance``
shows it past that bound on the same inputs, which is why three terms.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from v1t_tpu.ops.flash_attention import flash_attention as jax_flash
from v1t_tpu.ops.flash_attention import flash_attention_with_lse as jax_flash_lse

from v1t_tpu_torch.ops import flash_attention as fa

torch.set_num_threads(2)

F32_KERNEL_TOL = 2e-5
LOG2E, LN2 = 1.4426950408889634, 0.6931471805599453
FORMS = {"whole_k": "0", "dt_blocked": "1"}


@pytest.fixture(params=sorted(FORMS))
def jax_form(request, monkeypatch):
    """The JAX package's Pallas kernels under the interpreter, in one of its
    two forms."""
    monkeypatch.setenv("V1T_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("V1T_FLASH_DT_BLOCKED", FORMS[request.param])
    return request.param


# --- the split ------------------------------------------------------------------------

def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 as cvt.rna.tf32.f32 rounds it: to nearest,
    ties away from zero, on the 13 low bits of the bit pattern (adding half
    of the dropped unit to the magnitude, then clearing them); inf and nan
    kept as they are."""
    bits = x.contiguous().view(torch.int32)
    finite = (bits & 0x7FFFFFFF) < 0x7F800000
    rounded = (bits + 0x1000) & -0x2000  # -0x2000: the mask 0xffffe000
    return torch.where(finite, rounded, bits).view(torch.float32)


def split(x: torch.Tensor):
    big = tf32(x)
    return big, tf32(x - big)


def mm3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in 3xTF32, the small terms first."""
    (ab, as_), (bb, bs) = split(a), split(b)
    return as_ @ bb + ab @ bs + ab @ bb


def mm1(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in one TF32 product."""
    return tf32(a) @ tf32(b)


def test_tf32_rounding():
    """Ties away from zero, the 13 low bits cleared, a carry into the
    exponent, overflow to inf, and inf / nan kept."""
    def f(*bits):
        return torch.from_numpy(np.array(bits, dtype=np.uint32).view(np.float32))

    got = tf32(f(0x3F800FFF, 0x3F801000, 0x3F801001, 0xBF801000, 0x3FFFF000, 0x7F7FF000,
                 0x7F800000, 0xFF800000, 0x7FC00001, 0x00000FFF))
    want = f(0x3F800000, 0x3F802000, 0x3F802000, 0xBF802000, 0x40000000, 0x7F800000,
             0x7F800000, 0xFF800000, 0x7FC00001, 0x00000000)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    x = torch.from_numpy(np.random.default_rng(3).normal(size=4096).astype(np.float32))
    big, small = split(x)
    # big keeps 11 bits; big + small 22, small's own rounding the residual
    assert bool(((big - x).abs() <= 2.0 ** -11 * x.abs()).all())
    assert bool(((big + small - x).abs() <= 2.0 ** -21 * x.abs()).all())


# --- the kernels' arithmetic ----------------------------------------------------------------

def _groups(d: int):
    """The column groups of head width d's padded width (the kernels' split)."""
    n, cols = fa.column_groups(-(-d // 32) * 32)
    return [(c0, min(c0 + cols, d)) for c0 in range(0, n * cols, cols) if c0 < d]


def _grouped(mm, a, b, d):
    """a @ b^T over the head width, summed over the column groups in group order."""
    out = None
    for c0, c1 in _groups(d):
        part = mm(a[..., c0:c1], b[..., c0:c1].transpose(-1, -2))
        out = part if out is None else out + part
    return out


def _scores(mm, q, k, d, n_real, lsa):
    """Masked scores in log2 units, as the kernels mask them."""
    s = _grouped(mm, q, k, d) * LOG2E
    nq, nk = s.shape[-2:]
    keys = torch.arange(nk)
    mask = (keys >= n_real).view(1, nk)
    if lsa:
        mask = mask | (keys.view(1, nk) == torch.arange(nq).view(nq, 1))
    return s.masked_fill(mask, fa.MASKED)


def emulated_forward(mm, q, k, v, n_real, lsa):
    """o and the natural-log LSE of (H, Nq, D) float32 q (scaled), k, v."""
    s = _scores(mm, q, k, q.shape[-1], n_real, lsa)
    m = s.amax(-1, keepdim=True)
    p = torch.exp2(s - m)
    l = p.sum(-1, keepdim=True)
    return mm(p, v) / l, ((m + torch.log2(l)) * LN2)[..., 0]


def emulated_backward(mm, q, k, v, o, lse, do, dlse, n_real, lsa):
    d = q.shape[-1]
    delta = (do * o).sum(-1, keepdim=True) - dlse[..., None]
    p = torch.exp2(_scores(mm, q, k, d, n_real, lsa) - lse[..., None] * LOG2E)
    ds = p * (_grouped(mm, do, v, d) - delta)
    return mm(ds, k), mm(ds.transpose(-1, -2), q), mm(p.transpose(-1, -2), do)


def _rel(got, ref) -> float:
    got = np.asarray(got.detach().numpy() if isinstance(got, torch.Tensor) else got, np.float64)
    ref = np.asarray(jnp.asarray(ref, jnp.float32), np.float64)
    assert got.shape == ref.shape and np.isfinite(got).all()
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _case(seed, d, nq, nk, rectangular):
    """(1, H, N, D) inputs, q carrying the scale d^-0.5, the reference's
    forward and vjp from the JAX package."""
    rng = np.random.default_rng(seed)
    arr = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    q = (arr(1, 2, nq, d) * d ** -0.5).astype(np.float32)
    k, v, do = arr(1, 2, nk, d), arr(1, 2, nk, d), arr(1, 2, nq, d)
    if rectangular:
        n_real, lsa = 100, False
        dlse = (0.5 * arr(1, 2, nq)).astype(np.float32)
        (o, lse), vjp = jax.vjp(lambda q_, k_, v_: jax_flash_lse(q_, k_, v_, n_real_k=n_real),
                                *(jnp.asarray(x) for x in (q, k, v)))
        grads = vjp((jnp.asarray(do), jnp.asarray(dlse)))
    else:
        n_real, lsa = nk, True
        dlse = np.zeros((1, 2, nq), np.float32)
        fn = lambda q_, k_, v_: jax_flash(q_, k_, v_, jnp.float32(1.0), use_lsa=True)  # noqa: E731
        o, vjp = jax.vjp(fn, *(jnp.asarray(x) for x in (q, k, v)))
        grads = vjp(jnp.asarray(do))
        lse = None
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a[0]))  # noqa: E731
    return dict(q=t(q), k=t(k), v=t(v), do=t(do), dlse=t(dlse), n_real=n_real, lsa=lsa,
                ref=dict(o=o[0], lse=None if lse is None else lse[0],
                         dq=grads[0][0], dk=grads[1][0], dv=grads[2][0]))


def _errors(mm, c) -> dict:
    o, lse = emulated_forward(mm, c["q"], c["k"], c["v"], c["n_real"], c["lsa"])
    dq, dk, dv = emulated_backward(mm, c["q"], c["k"], c["v"], o, lse, c["do"], c["dlse"],
                                   c["n_real"], c["lsa"])
    got = dict(o=o, lse=lse, dq=dq, dk=dk, dv=dv)
    return {name: _rel(got[name], ref) for name, ref in c["ref"].items() if ref is not None}


CASES = {"288_lsa": (60, 288, 100, 100, False), "768_lsa": (61, 768, 100, 100, False),
         "288_rect_dlse": (62, 288, 70, 130, True), "768_rect_dlse": (63, 768, 70, 130, True)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_three_tf32_terms_match_jax(jax_form, case):
    """The forward's o and LSE and the backward's dq, dk, dv of the emulated
    3xTF32 column groups within F32_KERNEL_TOL of the JAX package's."""
    errors = _errors(mm3, _case(*CASES[case]))
    assert max(errors.values()) <= F32_KERNEL_TOL, errors


@pytest.mark.parametrize("case", ["768_lsa", "768_rect_dlse"])
def test_one_tf32_term_misses_the_tolerance(case, monkeypatch):
    """On the same inputs, big_a big_b alone lands past F32_KERNEL_TOL (and
    the three terms within it)."""
    monkeypatch.setenv("V1T_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("V1T_FLASH_DT_BLOCKED", "1")
    c = _case(*CASES[case])
    one, three = _errors(mm1, c), _errors(mm3, c)
    assert max(three.values()) <= F32_KERNEL_TOL, three
    assert max(one.values()) > 5 * F32_KERNEL_TOL, one


def test_the_emulation_sums_the_kernels_groups():
    """The groups the emulation sums are the kernels' cluster: 288 -> 160 +
    128 columns, 768 -> 3 x 256, 2048 -> 8 x 256 (one cluster at most 8)."""
    assert _groups(288) == [(0, 160), (160, 288)]
    assert _groups(768) == [(0, 256), (256, 512), (512, 768)]
    assert len(_groups(2048)) == fa.F32_CLUSTER_GROUPS == fa.fwd_plan(torch.float32, 2048).cluster
