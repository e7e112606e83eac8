"""The port past the kernels' panels, against the JAX package on the CPU:
attention heads padded wider than 256 (the bf16 flash kernels' column
groups on the card) and projections wider than 640 (the LayerNorm rows
normalised first; the dX on the wgmma kernel, a LayerNorm's row sums across
a cluster of blocks).

The JAX package has no such limit. Here the port's plain versions (a CPU
tensor takes them) are held against
- the JAX package's Pallas kernels under the Mosaic interpreter
  (``V1T_PALLAS_INTERPRET=1``) in bf16, dropout off, and
- its composed path (XLA) in float32,
on the same inputs and cotangents, made with numpy from a seed:
``fused_mha`` forward and backward at E 288 and 672 (2 heads as wide as the
embedding, 24 tokens, batch 2), ``fused_mlp`` at E 672 and with a 768-wide
hidden layer (fc2's dX past K 640), ``flash_attention``
and ``flash_attention_with_lse`` at D 288 (LSA; Nq != Nk with keys past
n_real_k masked and an LSE cotangent), and one V1T block at emb 672 (a
1-block model, 121 tokens): its responses and the gradients of a weighted
sum of them (and the same at emb 160). The launch plans of the forms past
the panels are pinned against the kernel sources. The CUDA kernels
themselves run only on a GPU (``python3 chip_smoke.py``, phase 3d and
5l).

Tolerances, max|port - jax| <= tol * max|jax| (+ atol):
- bf16: 2e-2 (both sides round where the TPU kernels round; float32
  summation order flips a bf16 rounding, 2^-8 = 3.9e-3 relative, now and
  then); dscale with bias_row 8e-2 (XLA's CPU backend skips the bf16
  rounding of x + bias_row that the port and the TPU kernel's source make,
  and dscale sums N^2 terms that cancel: tests/test_torch_port_backward.py).
  The model's bf16 responses 1e-2; its gradients 5e-2: a bf16 rounding
  flipped through the patch embedding, the block and the readout (the
  largest readings of this test's gradients against JAX's interpreted
  kernels: 3.1e-2 at emb 672, the positional embedding; 3.4e-2 at emb 160,
  within the panels, which no new code serves: the core shifter's bias).
- float32: 1e-5 + 1e-6 (operations), 2e-5 for the model's responses and
  1e-4 + 1e-9 for its gradients (summation order over 121 tokens and the
  readout; tests/test_torch_port_composed.py's bounds).
"""

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from v1t_tpu.configs import Config as JaxConfig
from v1t_tpu.data.cards import synthetic_data_card as jax_card
from v1t_tpu.models import build_model as jax_build_model
from v1t_tpu.models.cores.vit import MLP as JaxMLP
from v1t_tpu.models.model import init_model
from v1t_tpu.ops.attention import multi_head_attention
from v1t_tpu.ops.flash_attention import flash_attention as jax_flash
from v1t_tpu.ops.flash_attention import flash_attention_with_lse as jax_flash_lse
from v1t_tpu.ops.fused_mha import fused_mha as jax_fused_mha
from v1t_tpu.ops.fused_mlp import fused_mlp as jax_fused_mlp

from v1t_tpu_torch import _build
from v1t_tpu_torch.configs import Config
from v1t_tpu_torch.data.cards import synthetic_data_card
from v1t_tpu_torch.models import build_model
from v1t_tpu_torch.ops import flash_attention as fa
from v1t_tpu_torch.ops.fused_mha import fused_mha
from v1t_tpu_torch.ops.fused_mlp import fused_mlp
from v1t_tpu_torch.ops.ln_linear import MAX_LN_K, SMEM_LIMIT, dx_plan, linear_plan
from v1t_tpu_torch.utils.torch_export import export_state_dict

torch.set_num_threads(2)

BF16_TOL, DSCALE_ROW_TOL, F32_TOL, F32_ATOL = 2e-2, 8e-2, 1e-5, 1e-6
B, N, H = 2, 24, 2


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("V1T_PALLAS_INTERPRET", "1")


def _close(port, ref, tol, atol=0.0, name=""):
    port = np.asarray(torch.as_tensor(port).detach().double().numpy())
    ref = np.asarray(jnp.asarray(ref, jnp.float32), np.float64)
    assert port.shape == ref.shape, name
    assert np.isfinite(port).all(), name
    err = np.abs(port - ref).max()
    assert err <= tol * np.abs(ref).max() + atol, (name, err, np.abs(ref).max())


def _bf16(a):
    """Round through bf16 once, so both frameworks get identical inputs."""
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _leaf(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype).requires_grad_()


# --- fused_mha at heads padded past 256 -----------------------------------------

MHA_NAMES = ("x", "gamma", "beta", "wqkv", "wp", "bp", "scale", "bias_row")


def _mha_inputs(seed, e):
    rng = np.random.default_rng(seed)
    return dict(
        x=_bf16(rng.normal(size=(B, N, e))),
        gamma=(1.0 + 0.1 * rng.normal(size=e)).astype(np.float32),
        beta=(0.1 * rng.normal(size=e)).astype(np.float32),
        wqkv=_bf16(e ** -0.5 * rng.normal(size=(3, H, e, e))),  # JAX layout (3, H, E, D)
        wp=_bf16(0.5 * e ** -0.5 * rng.normal(size=(H, e, e))),  # (H, D, E)
        bp=_bf16(0.1 * rng.normal(size=e)),
        scale=(e ** -0.5 * (1.0 + 0.2 * rng.random(H))).astype(np.float32),
        bias_row=_bf16(0.5 * rng.normal(size=(B, e))),
        dout=_bf16(rng.normal(size=(B, N, e))),
    )


def _port_mha(inp, e, dtype):
    """The port's output and its cotangents in the JAX layouts (LSA, bias_row,
    the folded residual)."""
    leaves = {
        "x": _leaf(inp["x"], dtype), "gamma": _leaf(inp["gamma"]), "beta": _leaf(inp["beta"]),
        "wqkv": _leaf(inp["wqkv"].transpose(0, 1, 3, 2).reshape(3 * H * e, e), dtype),
        "wp": _leaf(inp["wp"].reshape(H * e, e).T, dtype),
        "bp": _leaf(inp["bp"]), "scale": _leaf(inp["scale"]),
        "bias_row": _leaf(inp["bias_row"], dtype),
    }
    out = fused_mha(leaves["x"], leaves["gamma"], leaves["beta"], leaves["wqkv"], leaves["wp"],
                    leaves["bp"], leaves["scale"], num_heads=H, use_lsa=True,
                    fold_residual=True, bias_row=leaves["bias_row"])
    out.backward(torch.tensor(inp["dout"]).to(dtype))
    grads = {k: v.grad for k, v in leaves.items()}
    grads["wqkv"] = grads["wqkv"].float().reshape(3, H, e, e).permute(0, 1, 3, 2)
    grads["wp"] = grads["wp"].float().t().reshape(H, e, e)
    return out, grads


def _jax_composed_mha(x, gamma, beta, wqkv, wp, bp, scale, bias_row):
    z = x + bias_row[:, None, :]
    mean = jnp.mean(z, -1, keepdims=True)
    ln = (z - mean) * jax.lax.rsqrt(jnp.var(z, -1, keepdims=True) + 1e-5) * gamma + beta
    q, k, v = (jnp.einsum("bne,hed->bhnd", ln, wqkv[s]) for s in range(3))
    o = multi_head_attention(q, k, v, scale, use_lsa=True, impl="xla")
    return jnp.einsum("bhnd,hde->bne", o, wp) + bp + z


@pytest.mark.parametrize("e", [288, 672])
def test_fused_mha_past_256_bf16_matches_pallas_interpret(interpret, e):
    inp = _mha_inputs(31, e)
    args = [jnp.asarray(inp[k], jnp.bfloat16 if k in ("x", "wqkv", "wp", "bp", "bias_row")
                        else jnp.float32) for k in MHA_NAMES]

    def f(x, gamma, beta, wqkv, wp, bp, scale, bias_row):
        return jax_fused_mha(x, gamma, beta, wqkv, wp, bp, scale, use_lsa=True,
                             fold_residual=True, bias_row=bias_row)

    ref_out, vjp = jax.vjp(f, *args)
    refs = vjp(jnp.asarray(inp["dout"], jnp.bfloat16))
    out, grads = _port_mha(inp, e, torch.bfloat16)
    _close(out, ref_out, BF16_TOL, name="out")
    for name, ref in zip(MHA_NAMES, refs):
        _close(grads[name], ref, DSCALE_ROW_TOL if name == "scale" else BF16_TOL, name=name)


@pytest.mark.parametrize("e", [288, 672])
def test_fused_mha_past_256_fp32_matches_composed(e):
    inp = _mha_inputs(32, e)
    ref_out, vjp = jax.vjp(_jax_composed_mha, *[jnp.asarray(inp[k]) for k in MHA_NAMES])
    refs = vjp(jnp.asarray(inp["dout"]))
    out, grads = _port_mha(inp, e, torch.float32)
    _close(out, ref_out, F32_TOL, F32_ATOL, "out")
    for name, ref in zip(MHA_NAMES, refs):
        _close(grads[name], ref, F32_TOL, F32_ATOL, name)


# --- fused_mlp past K 640 ---------------------------------------------------------

MLP_NAMES = ("x", "gamma", "beta", "w1", "b1", "w2", "b2")
E_MLP, FH = 672, 256


def _mlp_inputs(seed, e=E_MLP, fh=FH):
    rng = np.random.default_rng(seed)
    return dict(
        x=_bf16(rng.normal(size=(B, N, e))),
        gamma=(1.0 + 0.1 * rng.normal(size=e)).astype(np.float32),
        beta=(0.1 * rng.normal(size=e)).astype(np.float32),
        w1=_bf16(e ** -0.5 * rng.normal(size=(e, fh))),  # JAX layout (in, out)
        b1=(0.1 * rng.normal(size=fh)).astype(np.float32),
        w2=_bf16(fh ** -0.5 * rng.normal(size=(fh, e))),
        b2=(0.1 * rng.normal(size=e)).astype(np.float32),
        dout=_bf16(rng.normal(size=(B, N, e))),
    )


def _port_mlp(inp, dtype):
    leaves = [_leaf(inp["x"], dtype), _leaf(inp["gamma"]), _leaf(inp["beta"]),
              _leaf(inp["w1"].T, dtype), _leaf(inp["b1"]), _leaf(inp["w2"].T, dtype),
              _leaf(inp["b2"])]
    out = fused_mlp(*leaves, fold_residual=True)
    out.backward(torch.tensor(inp["dout"]).to(dtype))
    grads = [v.grad for v in leaves]
    grads[3], grads[5] = grads[3].float().t(), grads[5].float().t()
    return out, grads


def test_fused_mlp_past_640_bf16_matches_pallas_interpret(interpret):
    inp = _mlp_inputs(33)
    args = [jnp.asarray(inp[k], jnp.bfloat16 if k in ("x", "w1", "w2") else jnp.float32)
            for k in MLP_NAMES]
    ref_out, vjp = jax.vjp(lambda *a: jax_fused_mlp(*a, fold_residual=True), *args)
    refs = vjp(jnp.asarray(inp["dout"], jnp.bfloat16))
    out, grads = _port_mlp(inp, torch.bfloat16)
    _close(out, ref_out, BF16_TOL, name="out")
    for name, got, ref in zip(MLP_NAMES, grads, refs):
        _close(got, ref, BF16_TOL, name=name)


def _jax_composed_mlp(e, fh):
    def f(x, gamma, beta, w1, b1, w2, b2):
        params = {"ln_scale": gamma, "ln_bias": beta, "fc1_kernel": w1, "fc1_bias": b1,
                  "fc2_kernel": w2, "fc2_bias": b2}
        return JaxMLP(hidden_dim=fh, out_dim=e).apply({"params": params}, x) + x

    return f


def test_fused_mlp_past_640_fp32_matches_composed():
    inp = _mlp_inputs(34)
    ref_out, vjp = jax.vjp(_jax_composed_mlp(E_MLP, FH), *[jnp.asarray(inp[k]) for k in MLP_NAMES])
    refs = vjp(jnp.asarray(inp["dout"]))
    out, grads = _port_mlp(inp, torch.float32)
    _close(out, ref_out, F32_TOL, F32_ATOL, "out")
    for name, got, ref in zip(MLP_NAMES, grads, refs):
        _close(got, ref, F32_TOL, F32_ATOL, name)


# --- fused_mlp with a hidden layer past 640: fc2's dX in the plain form -----------
# (the out-projection's is held above at E 672: K = 2 heads x 672)

E_NARROW, FH_WIDE = 64, 768


def test_fused_mlp_hidden_past_640_bf16_matches_pallas_interpret(interpret):
    """fc2's dX at K 768 (a 768-wide hidden layer, the sweep's widest MLP):
    the plain form with GELU'(pre) on the way, which the card runs on the
    wgmma dX kernel, against the TPU kernel under the interpreter."""
    inp = _mlp_inputs(36, E_NARROW, FH_WIDE)
    args = [jnp.asarray(inp[k], jnp.bfloat16 if k in ("x", "w1", "w2") else jnp.float32)
            for k in MLP_NAMES]
    ref_out, vjp = jax.vjp(lambda *a: jax_fused_mlp(*a, fold_residual=True), *args)
    refs = vjp(jnp.asarray(inp["dout"], jnp.bfloat16))
    out, grads = _port_mlp(inp, torch.bfloat16)
    _close(out, ref_out, BF16_TOL, name="out")
    for name, got, ref in zip(MLP_NAMES, grads, refs):
        _close(got, ref, BF16_TOL, name=name)


def test_fused_mlp_hidden_past_640_fp32_matches_composed():
    inp = _mlp_inputs(37, E_NARROW, FH_WIDE)
    ref_out, vjp = jax.vjp(_jax_composed_mlp(E_NARROW, FH_WIDE),
                           *[jnp.asarray(inp[k]) for k in MLP_NAMES])
    refs = vjp(jnp.asarray(inp["dout"]))
    out, grads = _port_mlp(inp, torch.float32)
    _close(out, ref_out, F32_TOL, F32_ATOL, "out")
    for name, got, ref in zip(MLP_NAMES, grads, refs):
        _close(got, ref, F32_TOL, F32_ATOL, name)


# --- flash attention at D 288 ---------------------------------------------------

JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
TOL = {"float32": F32_TOL, "bfloat16": BF16_TOL}


def _flash_inputs(seed, h, nq, nk, d, dtype):
    rng = np.random.default_rng(seed)
    arr = lambda *s: np.asarray(  # noqa: E731
        jnp.asarray(rng.normal(size=s), JNP[dtype]).astype(jnp.float32))
    scale = (d ** -0.5 * (1.0 + 0.2 * rng.normal(size=h))).astype(np.float32)
    return arr(1, h, nq, d), arr(1, h, nk, d), arr(1, h, nk, d), arr(1, h, nq, d), scale


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_flash_attention_at_288_with_lsa_matches_jax(interpret, dtype):
    q, k, v, do, scale = _flash_inputs(35, 2, 100, 100, 288, dtype)
    fn = lambda q_, k_, v_, s_: jax_flash(q_, k_, v_, s_, use_lsa=True)  # noqa: E731
    ref, vjp = jax.vjp(fn, *(jnp.asarray(x, JNP[dtype]) for x in (q, k, v)), jnp.asarray(scale))
    ref_grads = vjp(jnp.asarray(do, JNP[dtype]))
    if dtype == "bfloat16":  # the scale's cotangent against float32 JAX (test_torch_port_flash)
        ref_grads = ref_grads[:3] + jax.vjp(fn, *(jnp.asarray(x) for x in (q, k, v, scale)))[1](
            jnp.asarray(do))[3:]
    tq, tk, tv = (_leaf(x, TORCH[dtype]) for x in (q, k, v))
    ts = torch.from_numpy(scale).requires_grad_()
    out = fa.flash_attention(tq, tk, tv, ts, use_lsa=True)
    _close(out, ref, TOL[dtype])
    out.backward(torch.from_numpy(do.copy()).to(TORCH[dtype]))
    for got, want in zip((tq.grad, tk.grad, tv.grad, ts.grad), ref_grads):
        _close(got, want, TOL[dtype])


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_flash_attention_with_lse_at_288_rectangular_matches_jax(interpret, dtype):
    """Nq != Nk, keys past n_real_k masked, a nonzero LSE cotangent."""
    nq, nk, n_real = 70, 130, 100
    q, k, v, do, _ = _flash_inputs(36, 2, nq, nk, 288, dtype)
    dlse = np.random.default_rng(37).normal(size=(1, 2, nq)).astype(np.float32)
    (ref_o, ref_lse), vjp = jax.vjp(lambda q_, k_, v_: jax_flash_lse(q_, k_, v_, n_real_k=n_real),
                                    *(jnp.asarray(x, JNP[dtype]) for x in (q, k, v)))
    ref_grads = vjp((jnp.asarray(do, JNP[dtype]), jnp.asarray(dlse)))
    tq, tk, tv = (_leaf(x, TORCH[dtype]) for x in (q, k, v))
    out, lse = fa.flash_attention_with_lse(tq, tk, tv, n_real_k=n_real)
    _close(out, ref_o, TOL[dtype])
    _close(lse, ref_lse, F32_TOL)  # float32 on both sides
    torch.autograd.backward((out, lse), (torch.from_numpy(do.copy()).to(TORCH[dtype]),
                                         torch.from_numpy(dlse)))
    for got, want in zip((tq.grad, tk.grad, tv.grad), ref_grads):
        _close(got, want, TOL[dtype])
    assert float(tk.grad[:, :, n_real:].abs().max()) == 0.0


# --- one V1T block at emb 672 -----------------------------------------------------

BLOCK = dict(core="vit", readout="gaussian2d", behavior_mode=3, shift_mode=2, resize_image=0,
             num_blocks=1, emb_dim=672, num_heads=2, mlp_dim=256, patch_stride=4, batch_size=2,
             t_dropout=0.0, p_dropout=0.0)
CARD = dict(mouse_ids=("A",), num_neurons=16, input_shape=(1, 36, 64))


def _block_models(precision, emb, params=None):
    """Both packages' 1-block models at ``precision`` on the same weights:
    ``params`` (JAX's tree), or the seeded perturbation of JAX's init."""
    jax_config = JaxConfig(**{**BLOCK, "precision": precision, "emb_dim": emb})
    jax_model = jax_build_model(jax_config, jax_card(**CARD))
    if params is None:
        params = init_model(jax_model, seed=0)
        rng = np.random.default_rng(38)
        params = jax.tree.map(lambda p: np.asarray(p) + rng.normal(
            size=p.shape, scale=p.shape[0] ** -0.5 if p.ndim >= 2 else 0.1).astype(np.float32),
            params)
    fields = {f.name for f in dataclasses.fields(Config)}
    config = Config(**{k: v for k, v in dataclasses.asdict(jax_config).items() if k in fields})
    config = config.replace(mouse_ids=["A"])
    model = build_model(config, synthetic_data_card(**CARD), seed=None, device="cpu")
    model.load_state_dict(export_state_dict(params, config), strict=True)
    return config, jax_model, params, model


def _block_inputs():
    rng = np.random.default_rng(39)
    images = rng.normal(size=(2, *CARD["input_shape"])).astype(np.float32)
    behaviors = rng.normal(size=(2, 3)).astype(np.float32)
    pupils = rng.normal(size=(2, 2)).astype(np.float32)
    w = rng.normal(size=(2, CARD["num_neurons"])).astype(np.float32)
    return images, behaviors, pupils, w


def _block_run(config, jax_model, params, model):
    """Both packages' responses to ``_block_inputs`` and their gradients of
    sum(w * responses) by the port's parameter names (None: outside the
    eval forward)."""
    images, behaviors, pupils, w = _block_inputs()

    def jax_forward(p):
        return jax_model.apply({"params": p}, jnp.asarray(images), mouse_id="A",
                               behaviors=jnp.asarray(behaviors),
                               pupil_centers=jnp.asarray(pupils), train=False)[0]

    ref = jax_forward(params)
    ref_grads = export_state_dict(
        jax.grad(lambda p: jnp.sum(jax_forward(p).astype(jnp.float32) * w))(params), config)
    out = model(torch.from_numpy(images), "A", torch.from_numpy(behaviors),
                torch.from_numpy(pupils))[0]
    (out.float() * torch.from_numpy(w)).sum().backward()
    grads = {name: p.grad for name, p in model.named_parameters()}
    return out, ref, grads, ref_grads


# The port's bf16 gradients against a float32 witness (the same block in
# float32 in both packages), in the form of chip_smoke.py's phase 5l: a
# gradient that parts from the JAX package's by more than the kernels'
# BF16_TOL passes only where its distance from the port's float32 run,
# relative to that run's largest element, is at most WITNESS_RATIO times
# the JAX package's from its own. Readings (this test): per-gradient
# ratios median 0.64 at emb 160 and 0.95 at 672; past BF16_TOL two
# gradients at 160 (the core shifter's first bias, 3.4e-2 from JAX, ratio
# 1.01; the patch projection's bias 0.43) and ten at 672 (up to 3.1e-2,
# ratios up to 1.31); the tails, up to 2.6, only on gradients within
# BF16_TOL of JAX: the shifter's first weight at 672, a sum over two
# samples of pupil x delta that cancels.
WITNESS_RATIO = 1.5


def _witness_distance(got, witness) -> float:
    got = np.asarray(torch.as_tensor(got).detach().double().numpy())
    witness = np.asarray(jnp.asarray(witness, jnp.float32), np.float64)
    return float(np.abs(got - witness).max() / np.abs(witness).max())


@pytest.mark.parametrize("precision,emb,tols", [
    ("bf16", 672, (1e-2, 5e-2, 0.0)),
    ("fp32", 672, (2e-5, 1e-4, 1e-9)),
    ("bf16", 160, (1e-2, 5e-2, 0.0)),
], ids=["bf16_pallas_interpret_672", "fp32_composed_672", "bf16_pallas_interpret_160"])
def test_v1t_block_forward_and_gradients_match_jax(interpret, precision, emb, tols):
    """One block at emb 672 (2 heads of 672, MLP 256, 121 tokens): bf16 takes
    the fused sublayers in both packages (JAX's interpreted Pallas kernels,
    the port's plain versions), fp32 the composed path; the responses and
    the gradients of sum(w * responses), a train step's backward. At emb
    160, within the panels, the same bf16 comparison gives the gradients'
    tolerance its reference reading. In bf16 the same block also runs in
    float32 in both packages, the witness: a bf16 gradient of the port
    past BF16_TOL from JAX's lies no further from its float32 run than
    WITNESS_RATIO times the JAX package's does from its own."""
    out_tol, grad_tol, grad_atol = tols
    config, jax_model, params, model = _block_models(precision, emb)
    out, ref, grads, ref_grads = _block_run(config, jax_model, params, model)
    assert model.core.patch_embedding.num_patches == 121
    _close(out, ref, out_tol)
    for name, grad in grads.items():
        if grad is None:  # outside the eval forward (the readout's sigma)
            assert not np.asarray(ref_grads[name]).any(), name
            continue
        _close(grad, ref_grads[name], grad_tol, grad_atol, name)
    if precision == "fp32":
        return
    _, _, f32_grads, f32_ref_grads = _block_run(*_block_models("fp32", emb, params))
    past = [name for name, grad in grads.items()
            if grad is not None and _witness_distance(grad, ref_grads[name]) > BF16_TOL]
    for name in past:
        port_d = _witness_distance(grads[name], f32_grads[name])
        jax_d = _witness_distance(ref_grads[name], f32_ref_grads[name])
        assert port_d <= WITNESS_RATIO * jax_d, (name, port_d, jax_d)


# --- the plans past the panels ----------------------------------------------------

def _source(name):
    with open(f"{_build.CSRC_DIR}/{name}") as f:
        return f.read()


@pytest.mark.parametrize("dp,groups,cols", [(288, 2, 160), (384, 2, 192), (512, 2, 256),
                                            (768, 3, 256), (1024, 4, 256), (2080, 9, 256)])
def test_column_group_plans(dp, groups, cols):
    """bf16 past DP 256: ceil(DP / 256) groups of one width (a multiple of
    32, the last narrower where it must). The forward up to 8 groups is one
    cluster of them (hand-computed: 1024 + q [128][256] + K and V [2][64][256]
    in bf16 + a float32 partial [128][64] + 64 bytes of barriers = 230,464
    bytes); past 8 groups (2080) the groups recompute S, no cluster (1024 +
    4 x (128 + 64) x 64 x 2 + 2 x 64 x 256 x 2 + 96 = 164,960); the backward
    the same at every width (1024 + 3 x 64 x 256 x 2 + 2 x 4 x 64 x 64 x 2 +
    2 x 64 x 64 x 2 + 8 x 16 x 32 x 4 + 48 = 197,680); all within a block's
    232,448; the fixed-order counters a turn a (plane, group, query tile of
    64)."""
    f = fa.fwd_plan(torch.bfloat16, dp)
    b = fa.bwd_plan(torch.bfloat16, 8, 1000, dp)
    assert fa.column_groups(dp) == (groups, cols)
    assert (groups - 1) * cols < dp <= groups * cols
    if groups <= fa.CLUSTER_GROUPS:
        assert (f.groups, f.group_cols, f.queries, f.keys, f.q_panels, f.stages, f.cluster) == (
            groups, cols, 128, 64, 1, 2, groups)
        assert f.smem == 230464 <= SMEM_LIMIT
    else:
        assert (f.groups, f.group_cols, f.queries, f.keys, f.q_panels, f.stages, f.cluster) == (
            groups, cols, 128, 64, 0, 4, 1)
        assert f.smem == 164960 <= SMEM_LIMIT
    assert (b.groups, b.group_cols, b.keys) == (groups, cols, 64)
    assert b.kernels == ("prep", "one_pass_wide", "dq_convert") and b.dq_acc == (8, 1000, dp)
    assert b.smem == 197680 <= SMEM_LIMIT
    assert b.order == 1 + 8 * groups * 16


@pytest.mark.parametrize("dp", [288, 320])
def test_float32_keeps_its_width_guard_past_256(dp):
    """Past DP 256 both types plan every multiple of 32 on the column groups
    and keep the one width guard left: a padded width that is no multiple
    of 32 is refused."""
    for plan in (fa.fwd_plan, lambda dt, d: fa.bwd_plan(dt, 1, 64, d)):
        for dtype in (torch.float32, torch.bfloat16):
            assert plan(dtype, dp).groups == 2
            with pytest.raises(ValueError, match="not a multiple of 32"):
                plan(dtype, dp + 16)


def test_column_group_constants_match_the_kernel_sources():
    fwd, bwd = _source("flash_attention.cu"), _source("flash_attention_bwd.cu")
    consts = lambda src: {n: int(v) for n, v in re.findall(r"(\w+) = (\d+)[,;]", src)}  # noqa: E731
    f, b = consts(fwd), consts(bwd)
    assert (f["WIDE_OG"], f["WIDE_CW"], f["WIDE_A_STAGES"], f["WIDE_V_STAGES"]) == (
        fa.WIDE_GROUP, fa.WIDE_CHUNK, 4, 2)
    assert (b["WB_OG"], b["WB_CW"], b["WB_STAGES"]) == (fa.WIDE_GROUP, fa.WIDE_CHUNK, 2)
    assert f["CL_MAX_GROUPS"] == fa.CLUSTER_GROUPS and "CL_THREADS = 2 * WG;" in fwd
    assert ("wide_groups(dp) <= CL_MAX_GROUPS ? cluster_fwd_smem_bytes()\n"
            "                                               : wide_fwd_smem_bytes();") in fwd
    assert "return launch_wide_bwd(" in bwd and "launch_wide<true>(" in fwd
    # up to 8 groups the forward's groups are one cluster along grid y
    assert "if (wide_groups(DP) <= CL_MAX_GROUPS)\n      return train ? launch_cluster<true>(" \
        in fwd
    assert "attr[0].val.clusterDim.y = (unsigned)groups;" in fwd
    assert "template <bool TRAIN>\n__global__ void __launch_bounds__(CL_THREADS, 1) " \
           "flash_fwd_cluster_kernel(" in fwd
    # one template instance a direction (and training flag), whatever the width
    assert "template <bool TRAIN>\n__global__ void __launch_bounds__(WIDE_THREADS, 1) " \
           "flash_fwd_wide_kernel(" in fwd
    assert "__global__ void __launch_bounds__(BWD_THREADS, 1) flash_bwd_wide_kernel(" in bwd
    # every group draws the same keep mask, by element; group 0 writes the LSE
    # (in both kernels); the cluster sums the partials in group order
    at = fwd.index("flash_fwd_cluster_kernel(")
    cl = fwd[at:fwd.index("// ---", at)]
    wide = fwd[fwd.index("flash_fwd_wide_kernel("):fwd.index("flash_fwd_cluster_kernel(")]
    for body in (wide, cl):
        assert "keep_frag_rows(drop, (uint32_t)bh, row0, j * BKV + ni * 8, lane, keep);" in body
        assert "if (gi == 0 && lse != nullptr && t == 0)" in body
    assert "for (int r = 0; r < G; ++r) {\n      const float4* pr = cluster.map_shared_rank(Sp, r);" \
        in cl
    assert cl.count("cluster_arrive();") == 2 and cl.count("cluster_wait();") == 3
    # the copies are never waited for by their issuer: no empty barrier
    assert "empty" not in cl


@pytest.mark.parametrize("k", [672, 768, 1024, 1030])
@pytest.mark.parametrize("heads", [None, (4, 768)], ids=["row_major", "head_major"])
def test_layernorm_past_640_plans(k, heads):
    """A LayerNorm wider than a panel: the forward takes the persistent
    wgmma kernel (tiles of 128 rows x 256 columns), its rows first
    normalised into aligned scratch that streams by TMA, so rows that are
    not 16-byte aligned get a launch too; without the LayerNorm they do
    not (the wrapper pads them). The dX takes the wgmma kernel, its row in one
    cluster of ceil(K / 256) blocks of 128 rows x 256 columns that add the
    row sums in distributed shared memory, no d(ln) rows in device memory;
    both within a block's shared memory. Up to K 640 neither, as before."""
    n = 3 * 4 * 768 if heads else 3072
    plan = linear_plan(64 * 1654, n, k, heads, True, True, False)
    assert plan.wgmma and plan.stream and plan.rows == 128 and plan.smem <= SMEM_LIMIT
    assert plan.tile == 256 and plan.tiles == (36 if heads else 12)
    assert linear_plan(64 * 1654, n, k, heads, True, False, False) == plan
    assert linear_plan(64 * 1654, n, k, heads, False, False, False) is None
    assert not linear_plan(64 * 1654, n, 640, heads, True, False, False).wgmma
    ns = n if heads else -(-n // 32) * 32
    dx = dx_plan(k, ns, True, True)
    assert dx.wgmma and not dx.dln_global and dx.rows == 128 and dx.smem <= SMEM_LIMIT
    assert dx.cluster == dx.k_tiles == -(-k // 256)
    assert not dx_plan(640, ns, True, True).wgmma
    assert k > MAX_LN_K == 640


def test_layernorm_past_640_matches_the_kernel_sources():
    fwd, bwd = _source("ln_linear.cu"), _source("ln_linear_bwd.cu")
    # past a panel the wgmma kernel, one instance; a LayerNorm's rows first
    # normalised into aligned scratch (ln_rows_kernel), which streams as x
    assert "p.wgmma = KP > MAX_PANEL_K;" in fwd
    assert "__global__ void __launch_bounds__(LN_ROWS_THREADS) ln_rows_kernel(" in fwd
    assert "namespace wl {\n\nconstexpr int THREADS" in fwd
    assert "__global__ void __launch_bounds__(THREADS, 1) linear_wgmma_kernel(" in fwd
    assert "template <bool LN>" not in fwd and "ln_stats" not in fwd
    assert "x = ln_x;\n      ldx = KS;" in fwd
    lw = fwd[fwd.index("linear_wgmma_kernel("):fwd.index("int launch(const Plan& P")]
    # the consumers' products wait for x and w to land, nothing else
    assert "bar_wait_or_trap(&xfull[xs], (uint32_t)((c / X_STAGES) & 1));" in lw
    assert "gamma" not in lw
    assert "wgmma::Mma<TILE>::template ss<0, 0>(" in lw
    # the keep mask of element (0, row, col), one Philox for two lanes
    assert "keep_frag_rows(drop, 0u, row0, col0 + 8 * j, lane, keep);" in lw
    # past K 640 the wgmma kernel; its LayerNorm form with the cluster's row
    # sums, its statistics in shared memory, no (M, K) float32 scratch
    assert "if (K > MAX_LN_K && !(ln && K > wx::LN_MAX_K)) {" in bwd
    assert "template <bool LN>\n__global__ void __launch_bounds__(THREADS, 1) dx_wgmma_kernel(" \
        in bwd
    assert "return wx::launch<true>(plan, dymap, wmap, g, s, (bf16*)dx, nullptr, dout," in bwd
    wx = bwd[bwd.index("dx_wgmma_kernel("):bwd.index("dx_prep_kernel(")]
    assert "float4* stats" in wx and "dln" not in wx
    # the column sums stay tile partials added in a fixed order: no atomics
    assert "atomicAdd" not in wx
    assert "atomicAdd" not in bwd[bwd.index("ln_linear_dx_kernel("):bwd.index(
        "ln_dx_column_sums_kernel(")]
