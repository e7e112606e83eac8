"""The port's kernel modules against the JAX package, on the CPU.

For each module that holds a CUDA kernel (``fused_mha``, ``fused_mlp``,
``interp_matmul``), the port's plain version — what a CPU tensor runs — is
held against
- the JAX package's Pallas kernel run under the Mosaic interpreter
  (``V1T_PALLAS_INTERPRET=1``) in bf16, and
- the JAX package's composed XLA path in float32,
on the same inputs, made with numpy from a seed. The CUDA kernels themselves
run only on a GPU (``python3 chip_smoke.py``).

Tolerances:
- bf16: max|port - jax| <= 1e-2 * max|jax|. Both sides round at the same
  points (the TPU kernels' rounding is mirrored by the plain versions); they
  differ by float32 summation order, which flips a bf16 rounding now and
  then: one bf16 step is 2^-8 = 3.9e-3 relative, so this allows ~2.5 steps
  at the largest output. The readout kernel also rounds its hat weights to
  bf16 (interp_matmul.py), within the same bound.
- float32: max|port - jax| <= 1e-5 * max|jax| + 1e-6, summation order only.
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from v1t_tpu.ops.attention import multi_head_attention
from v1t_tpu.ops.fused_mha import fused_mha as jax_fused_mha
from v1t_tpu.ops.fused_mlp import fused_mlp as jax_fused_mlp
from v1t_tpu.ops.grid_sample import grid_sample_tokens as jax_grid_sample_tokens
from v1t_tpu.ops.interp_matmul import interp_matmul_sample_cm as jax_interp_sample_cm
from v1t_tpu.models.cores.vit import MLP as JaxMLP

from v1t_tpu_torch import _build
from v1t_tpu_torch.ops.dropout import Dropout
from v1t_tpu_torch.ops.fused_mha import attention, attention_bwd, fused_mha
from v1t_tpu_torch.ops.fused_mlp import fused_mlp
from v1t_tpu_torch.ops.interp_matmul import bilinear_sample_cm, bilinear_sample_cm_bwd
from v1t_tpu_torch.ops.ln_linear import ln_linear, ln_linear_bwd, ln_linear_wgrad

torch.set_num_threads(1)

BF16_TOL = 1e-2
F32_TOL = 1e-5
B, N, E, H, F = 2, 50, 32, 2, 64


def _close(port, ref, tol, atol=0.0):
    port = np.asarray(torch.as_tensor(port).float().numpy(), np.float64)
    ref = np.asarray(jnp.asarray(ref, jnp.float32), np.float64)
    assert port.shape == ref.shape
    assert np.isfinite(port).all()
    err = np.abs(port - ref).max()
    assert err <= tol * np.abs(ref).max() + atol, (err, np.abs(ref).max())


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def _bf16(a):
    """Round through bf16 once, so both frameworks get identical inputs."""
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("V1T_PALLAS_INTERPRET", "1")


def _mha_inputs(seed, use_lsa):
    rng = np.random.default_rng(seed)
    return dict(
        x=_bf16(rng.normal(size=(B, N, E))),
        gamma=(1.0 + 0.1 * rng.normal(size=E)).astype(np.float32),
        beta=(0.1 * rng.normal(size=E)).astype(np.float32),
        wqkv=_bf16(0.15 * rng.normal(size=(3, H, E, E))),  # JAX layout (3, H, E, D)
        wp=_bf16(0.1 * rng.normal(size=(H, E, E))),  # (H, D, E)
        bp=_bf16(0.1 * rng.normal(size=E)),
        scale=(E ** -0.5 * (1.0 + 0.2 * rng.random(H)) if use_lsa
               else np.full(H, E ** -0.5)).astype(np.float32),
        bias_row=_bf16(0.5 * rng.normal(size=(B, E))),
    )


def _port_mha(inp, dtype, use_lsa, with_row, fold):
    w = inp["wqkv"].transpose(0, 1, 3, 2).reshape(3 * H * E, E)  # nn.Linear (out, in)
    wp = inp["wp"].reshape(H * E, E).T
    return fused_mha(
        _t(inp["x"], dtype), _t(inp["gamma"]), _t(inp["beta"]), _t(w, dtype), _t(wp, dtype),
        _t(inp["bp"]), _t(inp["scale"]), num_heads=H, use_lsa=use_lsa, fold_residual=fold,
        bias_row=_t(inp["bias_row"], dtype) if with_row else None,
    )


def _jax_composed_mha(inp, use_lsa, with_row, fold):
    x = jnp.asarray(inp["x"])
    z = x + jnp.asarray(inp["bias_row"])[:, None, :] if with_row else x
    mean = jnp.mean(z, -1, keepdims=True)
    ln = (z - mean) * jax.lax.rsqrt(jnp.var(z, -1, keepdims=True) + 1e-5)
    ln = ln * inp["gamma"] + inp["beta"]
    q, k, v = (jnp.einsum("bne,hed->bhnd", ln, inp["wqkv"][s]) for s in range(3))
    o = multi_head_attention(q, k, v, jnp.asarray(inp["scale"]), use_lsa=use_lsa, impl="xla")
    out = jnp.einsum("bhnd,hde->bne", o, inp["wp"]) + inp["bp"]
    return out + z if fold else out


MHA_CASES = [
    pytest.param(False, False, False, id="plain"),
    pytest.param(False, True, False, id="bias_row"),
    pytest.param(False, True, True, id="bias_row+fold_residual"),
    pytest.param(False, False, True, id="fold_residual"),
    pytest.param(True, True, True, id="lsa+bias_row+fold_residual"),
]


@pytest.mark.parametrize("use_lsa,with_row,fold", MHA_CASES)
def test_fused_mha_bf16_matches_pallas_interpret(interpret, use_lsa, with_row, fold):
    inp = _mha_inputs(1, use_lsa)
    ref = jax_fused_mha(
        jnp.asarray(inp["x"], jnp.bfloat16), jnp.asarray(inp["gamma"]), jnp.asarray(inp["beta"]),
        jnp.asarray(inp["wqkv"], jnp.bfloat16), jnp.asarray(inp["wp"], jnp.bfloat16),
        jnp.asarray(inp["bp"], jnp.bfloat16), jnp.asarray(inp["scale"]), use_lsa=use_lsa,
        fold_residual=fold,
        bias_row=jnp.asarray(inp["bias_row"], jnp.bfloat16) if with_row else None,
    )
    port = _port_mha(inp, torch.bfloat16, use_lsa, with_row, fold)
    assert port.dtype == torch.bfloat16
    _close(port, ref, BF16_TOL)


@pytest.mark.parametrize("use_lsa,with_row,fold", MHA_CASES)
def test_fused_mha_fp32_matches_composed(use_lsa, with_row, fold):
    inp = _mha_inputs(2, use_lsa)
    ref = _jax_composed_mha(inp, use_lsa, with_row, fold)
    _close(_port_mha(inp, torch.float32, use_lsa, with_row, fold), ref, F32_TOL, 1e-6)


# heads whose concat is no multiple of 8 columns: 3 x 18 = 54, o's rows 56
PAD_E, PAD_H = 18, 3
# gradients against the interpreted kernel's vjp: the tolerance of
# tests/test_torch_port_backward.py (bf16 roundings of dS and the
# projections flip in other summation orders)
GRAD_TOL = 2e-2


@pytest.mark.parametrize("use_lsa", [False, True], ids=["no_lsa", "lsa"])
def test_fused_mha_padded_o_rows_match_pallas_interpret(interpret, use_lsa):
    """Where H*D (54) is no multiple of 8, attention writes o in rows of 56
    with exact zeros past 54; the out-projection reads them against wp
    zero-padded at the call, its weight gradient against the padded o, the
    attention backward at o's stride: the sublayer's output and every
    gradient match the JAX package's fused kernel (interpreted), and dWp
    comes back in wp's shape, JAX's."""
    from v1t_tpu_torch.ops.fused_mha import attention_plain, o_width

    e, h = PAD_E, PAD_H
    rng = np.random.default_rng(21)
    inp = dict(
        x=_bf16(rng.normal(size=(B, N, e))),
        gamma=(1.0 + 0.1 * rng.normal(size=e)).astype(np.float32),
        beta=(0.1 * rng.normal(size=e)).astype(np.float32),
        wqkv=_bf16(0.2 * rng.normal(size=(3, h, e, e))),  # JAX layout (3, H, E, D)
        wp=_bf16(0.15 * rng.normal(size=(h, e, e))),  # (H, D, E)
        bp=_bf16(0.1 * rng.normal(size=e)),
        scale=(e ** -0.5 * (1.0 + 0.2 * rng.random(h))).astype(np.float32),
    )
    dout = _bf16(rng.normal(size=(B, N, e)))
    names = ("x", "gamma", "beta", "wqkv", "wp", "bp", "scale")
    bf = ("x", "wqkv", "wp", "bp")
    ref_out, vjp = jax.vjp(
        lambda *a: jax_fused_mha(*a, use_lsa=use_lsa, fold_residual=True),
        *[jnp.asarray(inp[k], jnp.bfloat16 if k in bf else jnp.float32) for k in names])
    refs = dict(zip(names, vjp(jnp.asarray(dout, jnp.bfloat16))))

    leaves = dict(
        x=_t(inp["x"], torch.bfloat16), gamma=_t(inp["gamma"]), beta=_t(inp["beta"]),
        wqkv=_t(inp["wqkv"].transpose(0, 1, 3, 2).reshape(3 * h * e, e), torch.bfloat16),
        wp=_t(inp["wp"].reshape(h * e, e).T, torch.bfloat16), bp=_t(inp["bp"]),
        scale=_t(inp["scale"]))
    for leaf in leaves.values():
        leaf.requires_grad_()
    out = fused_mha(*leaves.values(), num_heads=h, use_lsa=use_lsa, fold_residual=True)
    out.backward(_t(dout, torch.bfloat16))
    _close(out.detach(), ref_out, BF16_TOL)
    grads = {k: v.grad for k, v in leaves.items()}
    assert tuple(grads["wp"].shape) == (e, h * e)
    grads["wqkv"] = grads["wqkv"].float().reshape(3, h, e, e).permute(0, 1, 3, 2)
    grads["wp"] = grads["wp"].float().t().reshape(h, e, e)
    for name in names:
        if name != "scale" or use_lsa:  # a fixed scale: no gradient in JAX's use
            _close(grads[name], refs[name], GRAD_TOL)

    qkv = ln_linear(leaves["x"].detach(), leaves["wqkv"].detach(), gamma=leaves["gamma"].detach(),
                    beta=leaves["beta"].detach(), heads=(h, e))
    for fn in (attention, attention_plain):
        o = fn(qkv, leaves["scale"].detach(), e, use_lsa, with_lse=True)[0]
        assert tuple(o.shape) == (B, N, o_width(h, e)) == (B, N, 56)
        assert torch.all(o[..., h * e:] == 0)


def _mlp_inputs(seed):
    rng = np.random.default_rng(seed)
    return dict(
        x=_bf16(rng.normal(size=(B, N, E))),
        gamma=(1.0 + 0.1 * rng.normal(size=E)).astype(np.float32),
        beta=(0.1 * rng.normal(size=E)).astype(np.float32),
        w1=_bf16(0.2 * rng.normal(size=(E, F))),  # JAX layout (in, out)
        b1=(0.1 * rng.normal(size=F)).astype(np.float32),
        w2=_bf16(0.2 * rng.normal(size=(F, E))),
        b2=(0.1 * rng.normal(size=E)).astype(np.float32),
    )


def _port_mlp(inp, dtype, fold):
    return fused_mlp(
        _t(inp["x"], dtype), _t(inp["gamma"]), _t(inp["beta"]), _t(inp["w1"].T, dtype),
        _t(inp["b1"]), _t(inp["w2"].T, dtype), _t(inp["b2"]), fold_residual=fold,
    )


@pytest.mark.parametrize("fold", [False, True], ids=["no_residual", "fold_residual"])
def test_fused_mlp_bf16_matches_pallas_interpret(interpret, fold):
    inp = _mlp_inputs(3)
    ref = jax_fused_mlp(
        jnp.asarray(inp["x"], jnp.bfloat16), jnp.asarray(inp["gamma"]), jnp.asarray(inp["beta"]),
        jnp.asarray(inp["w1"]), jnp.asarray(inp["b1"]), jnp.asarray(inp["w2"]),
        jnp.asarray(inp["b2"]), fold_residual=fold,
    )
    port = _port_mlp(inp, torch.bfloat16, fold)
    assert port.dtype == torch.bfloat16
    _close(port, ref, BF16_TOL)


@pytest.mark.parametrize("fold", [False, True], ids=["no_residual", "fold_residual"])
def test_fused_mlp_fp32_matches_composed(fold):
    inp = _mlp_inputs(4)
    params = {
        "ln_scale": inp["gamma"], "ln_bias": inp["beta"], "fc1_kernel": inp["w1"],
        "fc1_bias": inp["b1"], "fc2_kernel": inp["w2"], "fc2_bias": inp["b2"],
    }
    x = jnp.asarray(inp["x"])
    ref = JaxMLP(hidden_dim=F, out_dim=E).apply({"params": params}, x)
    if fold:
        ref = ref + x
    _close(_port_mlp(inp, torch.float32, fold), ref, F32_TOL, 1e-6)


def _interp_inputs(seed, c=8, h=5, w=7, p=40):
    rng = np.random.default_rng(seed)
    table = _bf16(rng.normal(size=(B, c, h * w)))
    grid = rng.uniform(-1.0, 1.0, size=(B, p, 2)).astype(np.float32)
    # more than one pixel outside on each side (all corners padding), partly
    # outside, and exactly on the corners of the map
    grid[:, :8] = np.array(
        [[-1.5, 0.2], [1.45, -0.4], [0.1, -1.6], [0.3, 1.6],
         [-1.2, 0.3], [0.4, 1.3], [1.0, 1.0], [-1.0, -1.0]],
        np.float32,
    )
    grid[:, 8] = [1.0 + 1.0 / (w - 1), 0.0]  # half a pixel past the right edge
    return table, grid, h, w


def test_interp_sample_cm_bf16_matches_pallas_interpret(interpret):
    table, grid, h, w = _interp_inputs(5)
    ref = jax_interp_sample_cm(jnp.asarray(table, jnp.bfloat16), jnp.asarray(grid), h, w)
    port = bilinear_sample_cm(_t(table, torch.bfloat16), _t(grid), h, w)
    assert port.dtype == torch.bfloat16
    _close(port, ref, BF16_TOL)
    # all corners outside the map: exactly zero; half a pixel outside: half
    # the edge pixel (y = 0 is row 2 of 5 exactly)
    port = port.float().numpy()
    assert np.all(port[:, :, :4] == 0.0)
    np.testing.assert_allclose(port[:, :, 8], 0.5 * table[:, :, 2 * w + w - 1], rtol=1e-2)


def test_interp_sample_cm_fp32_matches_gather_path():
    table, grid, h, w = _interp_inputs(6)
    ref = jax_grid_sample_tokens(jnp.asarray(table).swapaxes(1, 2), jnp.asarray(grid), h, w)
    port = bilinear_sample_cm(_t(table), _t(grid), h, w)
    _close(port.transpose(1, 2), ref, F32_TOL, 1e-6)


def _no_build(monkeypatch):
    def refuse(*_args, **_kwargs):
        raise AssertionError("the kernel library must not be built")

    monkeypatch.setattr(_build, "build", refuse)
    monkeypatch.setattr(_build, "library", refuse)


def _bad_calls():
    bf = torch.bfloat16
    x = torch.zeros(2, 5, 8, dtype=bf)
    w = torch.zeros(12, 8, dtype=bf)
    g = torch.ones(8)
    qkv = torch.zeros(3, 2, 2, 5, 16, dtype=bf)
    table = torch.zeros(2, 3, 20, dtype=bf)
    grid = torch.zeros(2, 7, 2)
    return {
        "ln_linear:int_x": lambda: ln_linear(x.int(), w),
        "ln_linear:fp16_x": lambda: ln_linear(x.half(), w.half()),
        "ln_linear:mixed_w": lambda: ln_linear(x, w.float()),
        "ln_linear:k_mismatch": lambda: ln_linear(x, w[:, :7]),
        "ln_linear:bf16_gamma": lambda: ln_linear(x, w, gamma=g.to(bf), beta=g.to(bf)),
        "ln_linear:gamma_shape": lambda: ln_linear(x, w, gamma=g[:7], beta=g[:7]),
        "ln_linear:residual_shape": lambda: ln_linear(x, w, residual=x),
        "ln_linear:row_without_ln": lambda: ln_linear(x, w, pro_row=x[:, 0]),
        "attention:scale_shape": lambda: attention(qkv, torch.ones(5), 4),
        "attention:fp16": lambda: attention(qkv.half(), torch.ones(2), 4),
        "attention:scale_dtype": lambda: attention(qkv, torch.ones(2, dtype=bf), 4),
        "attention:layout": lambda: attention(qkv[0], torch.ones(2), 4),
        "attention:head_dim": lambda: attention(qkv, torch.ones(2), 17),
        "ln_linear:heads_split": lambda: ln_linear(x, w, heads=(5, 2)),
        "bilinear:table_size": lambda: bilinear_sample_cm(table, grid, 4, 6),
        "bilinear:grid_dtype": lambda: bilinear_sample_cm(table, grid.to(bf), 4, 5),
        "bilinear:grid_batch": lambda: bilinear_sample_cm(table, grid[:1], 4, 5),
        "bilinear:meta_device": lambda: bilinear_sample_cm(
            table.to("meta"), grid.to("meta"), 4, 5),
        "ln_linear:heads_with_dropout": lambda: ln_linear(
            x, w, heads=(2, 6), drop=Dropout(0.1, 1, 0)),
        "dropout:rate_one": lambda: ln_linear(x, w, drop=Dropout(1.0, 1, 0)),
        "ln_linear_bwd:w_mismatch": lambda: ln_linear_bwd(x, w),
        "ln_linear_bwd:pre_with_x": lambda: ln_linear_bwd(
            x, w[:8], pre=x, x=x, gamma=g, beta=g),
        "ln_linear_bwd:x_without_gamma": lambda: ln_linear_bwd(x, w[:8], x=x),
        "ln_linear_bwd:heads_layout": lambda: ln_linear_bwd(qkv, w, heads=(2, 4)),
        "ln_linear_wgrad:a_rows": lambda: ln_linear_wgrad(x, x[:, :4]),
        "attention_bwd:lse_dtype": lambda: attention_bwd(
            qkv, x[..., :8], x[..., :8], torch.zeros(2, 2, 5, dtype=bf), torch.ones(2), 4),
        "attention_bwd:o_shape": lambda: attention_bwd(
            qkv, x[..., :7], x[..., :7], torch.zeros(2, 2, 5), torch.ones(2), 4),
        "bilinear_bwd:dout_shape": lambda: bilinear_sample_cm_bwd(
            table, grid, torch.zeros(2, 3, 8, dtype=bf), 4, 5),
    }


@pytest.mark.parametrize("case", sorted(_bad_calls()))
def test_wrappers_reject_bad_inputs_without_building(monkeypatch, case):
    _no_build(monkeypatch)
    with pytest.raises(ValueError):
        _bad_calls()[case]()


def test_cpu_tensors_take_the_plain_version_without_counting(monkeypatch):
    _no_build(monkeypatch)
    counters = (ln_linear, attention, bilinear_sample_cm, ln_linear_bwd, ln_linear_wgrad,
                attention_bwd, bilinear_sample_cm_bwd)
    before = [fn.launches for fn in counters]
    inp = _mha_inputs(7, False)
    _port_mha(inp, torch.bfloat16, False, True, True)
    table, grid, h, w = _interp_inputs(8)
    bilinear_sample_cm(_t(table, torch.bfloat16), _t(grid), h, w)
    # and the backwards, through autograd
    x = _t(inp["x"], torch.bfloat16).requires_grad_()
    wqkv = _t(inp["wqkv"].transpose(0, 1, 3, 2).reshape(3 * H * E, E), torch.bfloat16)
    out = fused_mha(x, _t(inp["gamma"]), _t(inp["beta"]), wqkv,
                    _t(inp["wp"].reshape(H * E, E).T, torch.bfloat16), _t(inp["bp"]),
                    _t(inp["scale"]), num_heads=H, fold_residual=True,
                    drop_p=Dropout(0.2, 3, 0), drop_o=Dropout(0.2, 3, 1))
    out.float().sum().backward()
    assert x.grad is not None and torch.isfinite(x.grad.float()).all()
    tb = _t(table, torch.bfloat16).requires_grad_()
    from v1t_tpu_torch.ops.interp_matmul import sample_cm

    sample_cm(tb, _t(grid).requires_grad_(), h, w).float().sum().backward()
    assert tb.grad is not None
    assert [fn.launches for fn in counters] == before


def _c_signatures():
    """extern "C" entry points of the CUDA sources: name -> parameter types."""
    found = {}
    for path in _build.sources():
        text = open(path).read()
        for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', text):
            found[name] = [p.strip().rsplit(" ", 1)[0].replace("const ", "")
                           for p in params.split(",")]
    return found


def test_ctypes_argtypes_match_the_c_entry_points():
    import ctypes

    c_sigs = _c_signatures()
    assert set(c_sigs) == set(_build.SIGNATURES)
    as_ctypes = {"void*": ctypes.c_void_p, "int": ctypes.c_int, "unsigned": ctypes.c_uint,
                 "float": ctypes.c_float}
    for name, params in c_sigs.items():
        assert [as_ctypes[p] for p in params] == _build.SIGNATURES[name], name


def test_build_flags_and_library_name():
    flags, link = " ".join(_build.NVCC_FLAGS), " ".join(_build.LINK_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags and "-fPIC" in flags
    assert "arch=compute_90a,code=sm_90a" in link and "-shared" in link
    names = sorted(os.path.basename(p) for p in _build.sources())
    assert {"ln_linear.cu", "ln_linear_bwd.cu", "attention.cu", "attention_bwd.cu",
            "bilinear_sample.cu"} <= set(names)
    path = _build.library_path()
    assert path == _build.library_path()
    assert os.path.dirname(path) == _build.BUILD_DIR
    for source in _build.sources():
        assert "torch/extension.h" not in open(source).read()
