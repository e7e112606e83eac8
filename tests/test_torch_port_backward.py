"""The port's backward passes and dropout against the JAX package, on the CPU.

For each module that holds a backward kernel (``fused_mha``, ``fused_mlp``,
``interp_matmul``), the port's ``torch.autograd.Function`` on CPU tensors
(which run the kernels' plain versions) is held against ``jax.vjp`` of
- the JAX package's Pallas kernels under the Mosaic interpreter
  (``V1T_PALLAS_INTERPRET=1``) in bf16, dropout 0, and
- the JAX package's composed XLA path in float32,
on the same inputs and cotangents, made with numpy from a seed. Dropout is
checked on its own: the keep rate, the Philox4x32-10 function against the
published known-answer vectors, masks that differ between seeds and sites,
and a forward and backward that draw the same mask (the gradient with
dropout on equals autograd's gradient of the same function with that mask
applied explicitly). The CUDA kernels run only on a GPU
(``tests/test_torch_port_cuda.py``, ``python3 chip_smoke.py``).

Tolerances:
- bf16: max|port - jax| <= 2e-2 * max|jax| per cotangent. Both sides round
  where the TPU kernels round; float32 summation order flips a bf16 rounding
  of an intermediate (z + bias_row, dS, the projections) now and then, and
  the gradients sum many such terms: the largest reading was 6.9e-3 (dwqkv,
  dscale), one to two bf16 steps (2^-8 = 3.9e-3); 2e-2 is ~3x that. The
  readout kernel's hat weights are bf16 on the TPU (d(table) 3.0e-3).
  dscale with bias_row: 8e-2. XLA's CPU backend, which runs the interpreted
  kernel, skips the bf16 rounding of z = x + bias_row ahead of the
  LayerNorm's float32 cast (checked: a jitted bf16 add then cast returns the
  unrounded sum), where the port, like the TPU kernel's source, rounds it.
  That moves q, k and dS by a bf16 step here and there, and dscale, a sum
  of N^2 terms q.k dS that cancel to a few percent of their magnitude,
  carries it at 2.6e-2 of its largest value (reading); the other cotangents
  stay under 7e-3, and dscale without bias_row under 2e-2.
- float32: max|port - jax| <= 1e-5 * max|jax| + 1e-6, summation order only.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from v1t_tpu.models.cores.vit import MLP as JaxMLP
from v1t_tpu.ops.attention import multi_head_attention
from v1t_tpu.ops.fused_mha import fused_mha as jax_fused_mha
from v1t_tpu.ops.fused_mlp import fused_mlp as jax_fused_mlp
from v1t_tpu.ops.grid_sample import grid_sample_tokens as jax_grid_sample_tokens
from v1t_tpu.ops.interp_matmul import interp_matmul_sample_cm as jax_interp_sample_cm

from v1t_tpu_torch.ops.dropout import Dropout, keep_mask, keep_threshold, philox4x32, step_seed
from v1t_tpu_torch.ops.fused_mha import fused_mha
from v1t_tpu_torch.ops.fused_mlp import fused_mlp
from v1t_tpu_torch.ops.interp_matmul import sample_cm

torch.set_num_threads(1)

BF16_TOL = 2e-2
DSCALE_ROW_TOL = 8e-2
F32_TOL = 1e-5
B, N, E, H, FH = 2, 40, 32, 2, 64


def _close(port, ref, tol, atol=0.0, name=""):
    port = np.asarray(torch.as_tensor(port).detach().float().numpy(), np.float64)
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


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("V1T_PALLAS_INTERPRET", "1")


# --- fused_mha -----------------------------------------------------------------

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
        dout=_bf16(rng.normal(size=(B, N, E))),
    )


MHA_NAMES = ("x", "gamma", "beta", "wqkv", "wp", "bp", "scale", "bias_row")


def _port_mha_grads(inp, dtype, use_lsa, with_row, fold, drop_p=None, drop_o=None):
    """Port cotangents in the JAX layouts, keyed like MHA_NAMES."""
    leaves = {
        "x": _leaf(inp["x"], dtype), "gamma": _leaf(inp["gamma"]), "beta": _leaf(inp["beta"]),
        # nn.Linear layouts (out, in)
        "wqkv": _leaf(inp["wqkv"].transpose(0, 1, 3, 2).reshape(3 * H * E, E), dtype),
        "wp": _leaf(inp["wp"].reshape(H * E, E).T, dtype),
        "bp": _leaf(inp["bp"]), "scale": _leaf(inp["scale"]),
        "bias_row": _leaf(inp["bias_row"], dtype),
    }
    out = fused_mha(
        leaves["x"], leaves["gamma"], leaves["beta"], leaves["wqkv"], leaves["wp"],
        leaves["bp"], leaves["scale"], num_heads=H, use_lsa=use_lsa, fold_residual=fold,
        bias_row=leaves["bias_row"] if with_row else None, drop_p=drop_p, drop_o=drop_o,
    )
    out.backward(torch.tensor(inp["dout"]).to(dtype))
    grads = {k: v.grad for k, v in leaves.items() if v.grad is not None}
    grads["wqkv"] = grads["wqkv"].float().reshape(3, H, E, E).permute(0, 1, 3, 2)
    grads["wp"] = grads["wp"].float().t().reshape(H, E, E)
    if not use_lsa:
        grads.pop("scale")  # a constant: no gradient in either framework's use
    return out, grads


def _jax_composed_mha(x, gamma, beta, wqkv, wp, bp, scale, bias_row, *, use_lsa, with_row,
                      fold):
    z = x + bias_row[:, None, :] if with_row else x
    mean = jnp.mean(z, -1, keepdims=True)
    ln = (z - mean) * jax.lax.rsqrt(jnp.var(z, -1, keepdims=True) + 1e-5)
    ln = ln * gamma + beta
    q, k, v = (jnp.einsum("bne,hed->bhnd", ln, wqkv[s]) for s in range(3))
    o = multi_head_attention(q, k, v, scale, use_lsa=use_lsa, impl="xla")
    out = jnp.einsum("bhnd,hde->bne", o, wp) + bp
    return out + z if fold else out


MHA_CASES = [
    pytest.param(False, False, False, id="plain"),
    pytest.param(False, True, False, id="bias_row"),
    pytest.param(False, True, True, id="bias_row+fold_residual"),
    pytest.param(False, False, True, id="fold_residual"),
    pytest.param(True, False, False, id="lsa"),
    pytest.param(True, True, True, id="lsa+bias_row+fold_residual"),
]


def _checked(grads, refs, with_row, use_lsa, tol, atol=0.0, dscale_tol=None):
    for i, name in enumerate(MHA_NAMES):
        if (name == "bias_row" and not with_row) or (name == "scale" and not use_lsa):
            continue
        _close(grads[name], refs[i], dscale_tol if name == "scale" and dscale_tol else tol,
               atol, name)


@pytest.mark.parametrize("use_lsa,with_row,fold", MHA_CASES)
def test_fused_mha_backward_bf16_matches_pallas_interpret(interpret, use_lsa, with_row, fold):
    inp = _mha_inputs(11, use_lsa)
    args = [jnp.asarray(inp[k], jnp.bfloat16 if k in ("x", "wqkv", "wp", "bp", "bias_row")
                        else jnp.float32) for k in MHA_NAMES]

    def f(x, gamma, beta, wqkv, wp, bp, scale, bias_row):
        return jax_fused_mha(x, gamma, beta, wqkv, wp, bp, scale, use_lsa=use_lsa,
                             fold_residual=fold, bias_row=bias_row if with_row else None)

    ref_out, vjp = jax.vjp(f, *args)
    refs = vjp(jnp.asarray(inp["dout"], jnp.bfloat16))
    out, grads = _port_mha_grads(inp, torch.bfloat16, use_lsa, with_row, fold)
    assert out.dtype == torch.bfloat16 and grads["x"].dtype == torch.bfloat16
    assert grads["gamma"].dtype == torch.float32 and grads["bp"].dtype == torch.float32
    _close(out, ref_out, BF16_TOL, name="out")
    _checked(grads, refs, with_row, use_lsa, BF16_TOL,
             dscale_tol=DSCALE_ROW_TOL if with_row else None)


@pytest.mark.parametrize("use_lsa,with_row,fold", MHA_CASES)
def test_fused_mha_backward_fp32_matches_composed(use_lsa, with_row, fold):
    inp = _mha_inputs(12, use_lsa)
    args = [jnp.asarray(inp[k]) for k in MHA_NAMES]
    ref_out, vjp = jax.vjp(
        lambda *a: _jax_composed_mha(*a, use_lsa=use_lsa, with_row=with_row, fold=fold), *args)
    refs = vjp(jnp.asarray(inp["dout"]))
    out, grads = _port_mha_grads(inp, torch.float32, use_lsa, with_row, fold)
    _close(out, ref_out, F32_TOL, 1e-6, "out")
    _checked(grads, refs, with_row, use_lsa, F32_TOL, 1e-6)


# --- fused_mlp -----------------------------------------------------------------

def _mlp_inputs(seed):
    rng = np.random.default_rng(seed)
    return dict(
        x=_bf16(rng.normal(size=(B, N, E))),
        gamma=(1.0 + 0.1 * rng.normal(size=E)).astype(np.float32),
        beta=(0.1 * rng.normal(size=E)).astype(np.float32),
        w1=_bf16(0.2 * rng.normal(size=(E, FH))),  # JAX layout (in, out)
        b1=(0.1 * rng.normal(size=FH)).astype(np.float32),
        w2=_bf16(0.2 * rng.normal(size=(FH, E))),
        b2=(0.1 * rng.normal(size=E)).astype(np.float32),
        dout=_bf16(rng.normal(size=(B, N, E))),
    )


MLP_NAMES = ("x", "gamma", "beta", "w1", "b1", "w2", "b2")


def _port_mlp_grads(inp, dtype, fold, drop1=None, drop2=None):
    leaves = [_leaf(inp["x"], dtype), _leaf(inp["gamma"]), _leaf(inp["beta"]),
              _leaf(inp["w1"].T, dtype), _leaf(inp["b1"]), _leaf(inp["w2"].T, dtype),
              _leaf(inp["b2"])]
    out = fused_mlp(*leaves, fold_residual=fold, drop1=drop1, drop2=drop2)
    out.backward(torch.tensor(inp["dout"]).to(dtype))
    grads = [v.grad for v in leaves]
    grads[3], grads[5] = grads[3].float().t(), grads[5].float().t()
    return out, grads


@pytest.mark.parametrize("fold", [False, True], ids=["no_residual", "fold_residual"])
def test_fused_mlp_backward_bf16_matches_pallas_interpret(interpret, fold):
    inp = _mlp_inputs(13)
    args = [jnp.asarray(inp[k], jnp.bfloat16 if k in ("x", "w1", "w2") else jnp.float32)
            for k in MLP_NAMES]
    ref_out, vjp = jax.vjp(lambda *a: jax_fused_mlp(*a, fold_residual=fold), *args)
    refs = vjp(jnp.asarray(inp["dout"], jnp.bfloat16))
    out, grads = _port_mlp_grads(inp, torch.bfloat16, fold)
    assert grads[0].dtype == torch.bfloat16 and grads[3].dtype == torch.float32
    _close(out, ref_out, BF16_TOL, name="out")
    for name, got, ref in zip(MLP_NAMES, grads, refs):
        _close(got, ref, BF16_TOL, name=name)


@pytest.mark.parametrize("fold", [False, True], ids=["no_residual", "fold_residual"])
def test_fused_mlp_backward_fp32_matches_composed(fold):
    inp = _mlp_inputs(14)

    def f(x, gamma, beta, w1, b1, w2, b2):
        params = {"ln_scale": gamma, "ln_bias": beta, "fc1_kernel": w1, "fc1_bias": b1,
                  "fc2_kernel": w2, "fc2_bias": b2}
        y = JaxMLP(hidden_dim=FH, out_dim=E).apply({"params": params}, x)
        return y + x if fold else y

    ref_out, vjp = jax.vjp(f, *[jnp.asarray(inp[k]) for k in MLP_NAMES])
    refs = vjp(jnp.asarray(inp["dout"]))
    out, grads = _port_mlp_grads(inp, torch.float32, fold)
    _close(out, ref_out, F32_TOL, 1e-6, "out")
    for name, got, ref in zip(MLP_NAMES, grads, refs):
        _close(got, ref, F32_TOL, 1e-6, name)


# --- interp_matmul -------------------------------------------------------------

def _interp_inputs(seed, c=8, h=5, w=7, p=40):
    rng = np.random.default_rng(seed)
    table = _bf16(rng.normal(size=(B, c, h * w)))
    grid = rng.uniform(-1.2, 1.2, size=(B, p, 2)).astype(np.float32)
    grid[:, :4] = np.array([[-1.5, 0.2], [1.45, -0.4], [0.1, -1.1], [0.3, 1.05]], np.float32)
    dout = _bf16(rng.normal(size=(B, c, p)))
    return table, grid, dout, h, w


def test_interp_sample_backward_bf16_matches_pallas_interpret(interpret):
    table, grid, dout, h, w = _interp_inputs(15)
    _, vjp = jax.vjp(lambda tb, g: jax_interp_sample_cm(tb, g, h, w),
                     jnp.asarray(table, jnp.bfloat16), jnp.asarray(grid))
    ref_table, ref_grid = vjp(jnp.asarray(dout, jnp.bfloat16))
    t_port, g_port = _leaf(table, torch.bfloat16), _leaf(grid)
    sample_cm(t_port, g_port, h, w).backward(torch.tensor(dout).bfloat16())
    assert t_port.grad.dtype == torch.bfloat16 and g_port.grad.dtype == torch.float32
    _close(t_port.grad, ref_table, BF16_TOL, name="d(table)")
    _close(g_port.grad, ref_grid, BF16_TOL, name="d(grid)")


def test_interp_sample_backward_fp32_matches_gather_path():
    table, grid, dout, h, w = _interp_inputs(16)
    _, vjp = jax.vjp(lambda tb, g: jax_grid_sample_tokens(tb.swapaxes(1, 2), g, h, w),
                     jnp.asarray(table), jnp.asarray(grid))
    ref_table, ref_grid = vjp(jnp.asarray(dout).swapaxes(1, 2))
    t_port, g_port = _leaf(table), _leaf(grid)
    sample_cm(t_port, g_port, h, w).backward(torch.tensor(dout))
    _close(t_port.grad, ref_table, F32_TOL, 1e-6, "d(table)")
    _close(g_port.grad, ref_grid, F32_TOL, 1e-6, "d(grid)")


# --- dropout -------------------------------------------------------------------

def test_philox_matches_the_known_answer_vectors():
    """Random123's kat_vectors for philox4x32-10."""
    cases = [
        ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
        ((0xFFFFFFFF,) * 4, (0xFFFFFFFF, 0xFFFFFFFF),
         (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
        ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
         (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
    ]
    for counter, key, want in cases:
        assert tuple(int(w) for w in philox4x32(counter, key)) == want


@pytest.mark.parametrize("rate", [0.2544, 0.0229, 0.5])
def test_keep_rate_is_within_five_sigma(rate):
    keep = keep_mask(Dropout(rate, 2024, 7), 3, 129, 131)
    n = keep.numel()
    p = 1.0 - rate
    assert abs(keep.float().mean().item() - p) <= 5.0 * (p * (1.0 - p) / n) ** 0.5
    # full 32-bit resolution: the threshold is floor((1 - rate) * 2^32)
    assert keep_threshold(rate) == int((1.0 - rate) * 2 ** 32)


def test_other_seeds_and_sites_draw_other_masks():
    rate = 0.2544
    base = keep_mask(Dropout(rate, 1, 0), 2, 64, 80)
    p = 1.0 - rate
    agree = p * p + (1.0 - p) ** 2  # two independent masks agree this often
    sigma = (agree * (1.0 - agree) / base.numel()) ** 0.5
    for other in (Dropout(rate, 2, 0), Dropout(rate, 1, 1),
                  Dropout(rate, step_seed(1234, 1), 0), Dropout(rate, step_seed(1234, 2), 0)):
        same = (keep_mask(other, 2, 64, 80) == base).float().mean().item()
        assert abs(same - agree) <= 5.0 * sigma
    assert torch.equal(keep_mask(Dropout(rate, 1, 0), 2, 64, 80), base)  # regenerable
    assert step_seed(1234, 1) != step_seed(1234, 2) != step_seed(1235, 1)


def _dropped(y, drop, planes):
    """where(keep, y / keep_prob, 0) with the site's mask on (planes, rows, cols)."""
    keep = keep_mask(drop, planes, y.shape[-2], y.shape[-1]).reshape(y.shape)
    return torch.where(keep, y / (1.0 - drop.rate), torch.zeros_like(y))


def test_fused_mha_forward_and_backward_draw_the_same_masks():
    inp = _mha_inputs(17, True)
    drop_p, drop_o = Dropout(0.3, 99, 0), Dropout(0.3, 99, 1)
    out, grads = _port_mha_grads(inp, torch.float32, True, True, True, drop_p, drop_o)
    leaves = {k: _leaf(inp[k]) for k in MHA_NAMES}
    z = leaves["x"] + leaves["bias_row"][:, None, :]
    ln = F.layer_norm(z, (E,), leaves["gamma"], leaves["beta"], 1e-5)
    wqkv = leaves["wqkv"]  # (3, H, E, D)
    q, k, v = (torch.einsum("bne,hed->bhnd", ln, wqkv[s]) for s in range(3))
    s = torch.einsum("bhqd,bhkd->bhqk", q * leaves["scale"].view(1, -1, 1, 1), k)
    s = s.masked_fill(torch.eye(N, dtype=torch.bool), float("-inf"))
    p = _dropped(s.softmax(-1), drop_p, B * H)
    o = torch.einsum("bhqk,bhkd->bhqd", p, v)
    proj = torch.einsum("bhnd,hde->bne", o, leaves["wp"]) + leaves["bp"]
    ref = _dropped(proj.reshape(B * N, E), drop_o, 1).reshape(B, N, E) + z
    ref.backward(torch.tensor(inp["dout"]))
    _close(out, ref.detach().numpy(), F32_TOL, 1e-6, "out")
    for name in MHA_NAMES:
        _close(grads[name], leaves[name].grad.numpy(), F32_TOL, 1e-6, name)


def test_fused_mlp_forward_and_backward_draw_the_same_masks():
    inp = _mlp_inputs(18)
    drop1, drop2 = Dropout(0.3, 5, 2), Dropout(0.3, 5, 3)
    out, grads = _port_mlp_grads(inp, torch.float32, True, drop1, drop2)
    leaves = [_leaf(inp[k]) for k in MLP_NAMES]
    x, gamma, beta, w1, b1, w2, b2 = leaves
    h = F.gelu(F.layer_norm(x, (E,), gamma, beta, 1e-5) @ w1 + b1)
    h = _dropped(h.reshape(B * N, FH), drop1, 1).reshape(B, N, FH)
    y = _dropped((h @ w2 + b2).reshape(B * N, E), drop2, 1).reshape(B, N, E) + x
    y.backward(torch.tensor(inp["dout"]))
    _close(out, y.detach().numpy(), F32_TOL, 1e-6, "out")
    for name, got, ref in zip(MLP_NAMES, grads, leaves):
        _close(got, ref.grad.numpy(), F32_TOL, 1e-6, name)
