"""The composed attention path of the port's ViT against the JAX package's,
on the CPU: the dispatch gate, the float32 model (which always takes the
composed path) and the bf16 composed path (forced below 4096 tokens by
lowering ``FUSED_MAX_N`` in both packages, a test-time attribute swap), and
the full-resolution model's weights.

Models are small (2 blocks, emb 32, 2 heads, MLP 64, 24 neurons) on 1x20x24
images with patch 4: 17 x 21 patches + CLS = 358 tokens, past the 256 at
which both packages take flash attention. In float32 every weight of the
JAX init gets noise from a second seed (N(0, fan_in^-0.5) on matrices,
N(0, 0.1) on the rest): the reference's trunc_normal(0.02) keeps the MLP's
inputs so small that a wrong GELU would hide behind float32 summation
order. In bf16 the init stays: with the noise, bf16 roundings carried
through 2 blocks put JAX 2.2% and the port 1.6% from the float32 result in
different directions (3.7% apart), a reading of rounding, not of a fault. The JAX package runs its Pallas
kernels under the Mosaic interpreter (``V1T_PALLAS_INTERPRET=1``); the port
runs their plain versions. Dropout and readout noise are off (the two
packages draw different bits).

Tolerances (max|port - jax| <= tol * max|jax|):
- float32 responses 2e-5 (as ``test_torch_port_model.py``: summation order
  over 2 blocks; reading 1.4e-6); float32 gradients 1e-4 per parameter (the
  same through the backward's longer sums; readings up to 4.0e-6);
- bf16 responses 2e-2 (reading 1.0e-2): both round at the same points,
  but float32 summation order flips bf16 roundings (2^-8 relative) that
  carry through 2 blocks of a bf16 residual stream.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import v1t_tpu.models.cores.vit as jax_vit
from v1t_tpu.configs import Config as JaxConfig
from v1t_tpu.data.cards import synthetic_data_card as jax_card
from v1t_tpu.models import build_model as jax_build_model
from v1t_tpu.models.model import init_model

import v1t_tpu_torch.models.cores.vit as port_vit
from v1t_tpu_torch.configs import Config
from v1t_tpu_torch.data.cards import synthetic_data_card
from v1t_tpu_torch.models import build_model
from v1t_tpu_torch.utils.torch_export import export_state_dict

torch.set_num_threads(2)

SMALL = dict(
    core="vit", readout="gaussian2d", behavior_mode=3, shift_mode=2, resize_image=0,
    num_blocks=2, emb_dim=32, num_heads=2, mlp_dim=64, batch_size=2, patch_size=4,
    t_dropout=0.0, p_dropout=0.0,
)
CARD = dict(mouse_ids=("A",), num_neurons=24, input_shape=(1, 20, 24))
TOKENS = 17 * 21 + 1


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("V1T_PALLAS_INTERPRET", "1")


@pytest.mark.parametrize("impl", ["auto", "pallas", "xla"])
@pytest.mark.parametrize("port_device,jax_backend,interpreted", [
    ("cuda", "tpu", False), ("cpu", "cpu", True),
], ids=["cuda-tpu", "cpu-interpreter"])
def test_fused_attention_eligible_decides_as_jax(monkeypatch, impl, port_device, jax_backend,
                                                 interpreted):
    """A CUDA device plays the TPU; a CPU tensor (the kernels' plain
    versions) the Pallas interpreter."""
    monkeypatch.setenv("V1T_PALLAS_INTERPRET", "1" if interpreted else "0")
    for port_dtype, jax_dtype in ((torch.bfloat16, jnp.bfloat16), (torch.float32, jnp.float32)):
        for n in (255, 256, 4096, 4097, 34114):
            want = jax_vit._fused_attention_eligible(jax_dtype, impl, n, backend=jax_backend)
            got = port_vit._fused_attention_eligible(port_dtype, impl, n, port_device)
            assert got == want, (port_dtype, n)


def _models(precision, noise=True):
    jax_config = JaxConfig(**{**SMALL, "precision": precision})
    jax_model = jax_build_model(jax_config, jax_card(**CARD))
    params = init_model(jax_model, seed=0)
    if noise:
        rng = np.random.default_rng(7)
        params = jax.tree.map(lambda p: np.asarray(p) + rng.normal(
            size=p.shape, scale=p.shape[0] ** -0.5 if p.ndim >= 2 else 0.1).astype(np.float32),
            params)
    fields = {f.name for f in dataclasses.fields(Config)}
    config = Config(**{k: v for k, v in dataclasses.asdict(jax_config).items() if k in fields})
    config = config.replace(mouse_ids=["A"])
    model = build_model(config, synthetic_data_card(**CARD), seed=None, device="cpu")
    model.load_state_dict(export_state_dict(params, config), strict=True)
    assert model.core.patch_embedding.num_patches == TOKENS
    return config, jax_model, params, model


def _inputs(seed=0, n=2):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, *CARD["input_shape"])).astype(np.float32),
            rng.normal(size=(n, 3)).astype(np.float32),
            rng.normal(size=(n, 2)).astype(np.float32),
            rng.normal(size=(n, CARD["num_neurons"])).astype(np.float32))


def _jax_forward(jax_model, params, images, behaviors, pupils):
    return jax_model.apply({"params": params}, jnp.asarray(images), mouse_id="A",
                           behaviors=jnp.asarray(behaviors), pupil_centers=jnp.asarray(pupils),
                           train=False)[0]


def _port_forward(model, images, behaviors, pupils):
    return model(torch.from_numpy(images), "A", torch.from_numpy(behaviors),
                 torch.from_numpy(pupils))[0]


def _close(port, ref, tol, atol=0.0):
    port = np.asarray(torch.as_tensor(port).detach().double().numpy())
    ref = np.asarray(ref, np.float64)
    assert port.shape == ref.shape and np.isfinite(port).all()
    err = np.abs(port - ref).max()
    assert err <= tol * np.abs(ref).max() + atol, (err, np.abs(ref).max())


def test_float32_model_forward_and_gradients_match_jax(interpret):
    """The fp32 model takes the composed path in both packages (flash
    attention: JAX's interpreted Pallas kernels, the port's plain
    versions); responses and the gradients of sum(w * responses) agree."""
    config, jax_model, params, model = _models("fp32")
    images, behaviors, pupils, w = _inputs()

    def jax_loss(p):
        return jnp.sum(_jax_forward(jax_model, p, images, behaviors, pupils) * w)

    ref = _jax_forward(jax_model, params, images, behaviors, pupils)
    ref_grads = export_state_dict(jax.grad(jax_loss)(params), config)
    out = _port_forward(model, images, behaviors, pupils)
    _close(out, ref, 2e-5)
    (out * torch.from_numpy(w)).sum().backward()
    grads = {name: p.grad for name, p in model.named_parameters()}
    assert set(grads) <= set(ref_grads)
    for name, g in grads.items():
        if g is None:  # outside the eval forward (the readout's sigma)
            assert not np.asarray(ref_grads[name]).any(), name
            continue
        _close(g, ref_grads[name], 1e-4, atol=1e-9)


def test_bf16_composed_path_matches_jax(interpret, monkeypatch):
    """bf16 below 4096 tokens takes the fused sublayers; with FUSED_MAX_N
    lowered under the 358 tokens in both packages, the composed attention
    path (flash attention, QKV and projections as plain products) and the
    fused MLP without its folded residual."""
    for module in (jax_vit, port_vit):
        monkeypatch.setattr(module, "FUSED_MAX_N", 300)
    _, jax_model, params, model = _models("bf16", noise=False)
    images, behaviors, pupils, _ = _inputs(seed=1)
    assert not model.core.transformer.blocks[0].mha.fused(torch.zeros(1, TOKENS, 32,
                                                                      dtype=torch.bfloat16))
    ref = _jax_forward(jax_model, params, images, behaviors, pupils)
    with torch.inference_mode():
        out = _port_forward(model, images, behaviors, pupils)
    _close(out, ref, 2e-2)


def test_full_resolution_model_loads_jax_weights():
    """The 144x256 card of the full-resolution run (34,114 tokens): the
    port's model loads the JAX package's exported weights with no key
    missing or left over; only the positional embedding's length differs
    from the flagship's. Shapes only: nothing runs at 34,114 tokens here."""
    card = dict(CARD, input_shape=(1, 144, 256))
    for precision in ("bf16", "fp32"):
        jax_config = JaxConfig(**{**SMALL, "patch_size": 8, "precision": precision})
        jax_model = jax_build_model(jax_config, jax_card(**card))
        shapes = jax.eval_shape(lambda: init_model(jax_model, seed=0))
        params = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
        fields = {f.name for f in dataclasses.fields(Config)}
        config = Config(**{k: v for k, v in dataclasses.asdict(jax_config).items()
                           if k in fields}).replace(mouse_ids=["A"])
        model = build_model(config, synthetic_data_card(**card), seed=None, device="cpu")
        state = export_state_dict(params, config)
        model.load_state_dict(state, strict=True)
        assert tuple(state["core.patch_embedding.pos_embedding"].shape) == (34114, 32)
        assert model.core.output_shape == (32, 137, 249)
