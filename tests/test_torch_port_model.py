"""The port's serving slice against the JAX package, on the CPU.

JAX ``init_model`` weights go through the port's ``torch_export`` into the
port's ``Model``; both models then predict the same images, behaviors and
pupil centers (numpy, from a seed) at a small width: 2 blocks, emb 32,
2 heads, MLP 64, 24 neurons, 1x36x64 images (1654 tokens), batch 2.

Tolerances:
- float32 against the JAX composed path: max|d| <= 2e-5 * max|ref|
  (summation order over 2 blocks and the 1654-token softmax; float32
  carries ~6e-8 relative per operation).
- bf16 against the JAX fused Pallas kernels under the Mosaic interpreter:
  max|d| <= 1e-2 * max|ref|. The port's plain path rounds where the TPU
  kernels round; float32 summation order flips a bf16 rounding (2^-8 =
  3.9e-3 relative) now and then, and such flips carry through 2 blocks of a
  bf16 residual stream into the readout's sums.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from v1t_tpu.configs import Config as JaxConfig
from v1t_tpu.data.cards import synthetic_data_card as jax_card
from v1t_tpu.models import build_model as jax_build_model
from v1t_tpu.models.model import init_model
from v1t_tpu.training import pad_batch as jax_pad_batch

from v1t_tpu_torch.configs import Config
from v1t_tpu_torch.data.cards import synthetic_data_card
from v1t_tpu_torch.models import build_model
from v1t_tpu_torch.training import Trainer, inference, pad_batch
from v1t_tpu_torch.utils.torch_export import export_state_dict

torch.set_num_threads(1)

SMALL = dict(
    core="vit", readout="gaussian2d", behavior_mode=3, shift_mode=2, resize_image=0,
    num_blocks=2, emb_dim=32, num_heads=2, mlp_dim=64, batch_size=2,
    t_dropout=0.0, p_dropout=0.0,
)
CARD = dict(mouse_ids=("A",), num_neurons=24, input_shape=(1, 36, 64))


def _batch(n=2, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "image": rng.normal(size=(n, 1, 36, 64)).astype(np.float32),
        "behavior": rng.normal(size=(n, 3)).astype(np.float32),
        "pupil_center": rng.normal(size=(n, 2)).astype(np.float32),
        "response": rng.poisson(2.0, size=(n, 24)).astype(np.float32),
        "image_id": np.arange(n),
        "trial_id": np.arange(100, 100 + n),
    }


def _jax_model(precision, **overrides):
    config = JaxConfig(**{**SMALL, "precision": precision, **overrides})
    model = jax_build_model(config, jax_card(**CARD))
    return config, model, init_model(model, seed=0)


def _port_model(jax_config, params):
    fields = {f.name for f in dataclasses.fields(Config)}
    config = Config(**{k: v for k, v in dataclasses.asdict(jax_config).items() if k in fields})
    config = config.replace(mouse_ids=["A"])
    model = build_model(config, synthetic_data_card(**CARD), seed=None, device="cpu")
    model.load_state_dict(export_state_dict(params, config), strict=True)
    return config, model


def _jax_predict(model, params, batch):
    out, _, _ = model.apply(
        {"params": params}, jnp.asarray(batch["image"]), mouse_id="A",
        behaviors=jnp.asarray(batch["behavior"]),
        pupil_centers=jnp.asarray(batch["pupil_center"]), train=False,
    )
    return np.asarray(out, np.float64)


def _port_predict(model, batch):
    with torch.inference_mode():
        out, _, _ = model(
            torch.from_numpy(batch["image"]), "A", torch.from_numpy(batch["behavior"]),
            torch.from_numpy(batch["pupil_center"]),
        )
    return out.double().numpy()


def _assert_close(port, ref, tol):
    assert port.shape == ref.shape and np.isfinite(port).all() and (port > 0).all()
    err = np.abs(port - ref).max()
    assert err <= tol * np.abs(ref).max(), (err, np.abs(ref).max())


@pytest.mark.parametrize("overrides", [
    pytest.param({}, id="flagship"),
    pytest.param({"use_lsa": True}, id="lsa"),
    pytest.param({"disable_grid_predictor": True, "bias_mode": 1}, id="free_mu"),
    pytest.param({"shift_mode": 3, "center_crop": 0.8, "resize_image": 1}, id="image_shifter"),
    pytest.param({"disable_bias": True, "behavior_mode": 2}, id="no_bias"),
])
def test_serving_slice_fp32_matches_jax(overrides):
    jax_config, jax_model, params = _jax_model("fp32", **overrides)
    _, model = _port_model(jax_config, params)
    batch = _batch()
    _assert_close(_port_predict(model, batch), _jax_predict(jax_model, params, batch), 2e-5)


def test_serving_slice_bf16_matches_pallas_interpret(monkeypatch):
    jax_config, jax_model, params = _jax_model("bf16")
    _, model = _port_model(jax_config, params)
    batch = _batch(seed=1)
    monkeypatch.setenv("V1T_PALLAS_INTERPRET", "1")
    ref = _jax_predict(jax_model, params, batch)
    _assert_close(_port_predict(model, batch), ref, 1e-2)


def test_export_covers_every_port_parameter():
    jax_config, _, params = _jax_model("fp32")
    config, model = _port_model(jax_config, params)
    exported = export_state_dict(params, config)
    assert set(exported) == set(model.state_dict())
    assert all(v.dtype == torch.float32 for v in exported.values())


def test_trainer_predict_micro_batches_and_pads():
    jax_config, _, params = _jax_model("fp32")
    config, model = _port_model(jax_config, params)
    trainer = Trainer(config.replace(micro_batch_size=2), model, synthetic_data_card(**CARD),
                      device="cpu")
    batch = _batch(n=3, seed=2)
    preds = trainer.predict("A", batch)
    assert preds.shape == (3, 24) and preds.dtype == np.float32
    # each row equals the model's prediction for that image alone
    for i in range(3):
        single = {k: v[i:i + 1] for k, v in batch.items()}
        np.testing.assert_allclose(preds[i:i + 1], _port_predict(model, single), rtol=1e-5,
                                   atol=1e-6)
    result = inference(trainer, [batch, _batch(n=2, seed=3)], "A")
    assert result["predictions"].shape == (5, 24)
    np.testing.assert_array_equal(result["trial_ids"], np.r_[100:103, 100:102])
    np.testing.assert_array_equal(result["targets"][:3], batch["response"])


def test_pad_batch_matches_jax():
    batch = _batch(n=3, seed=4)
    padded, mask = pad_batch(batch, 5)
    ref, ref_mask = jax_pad_batch(batch, 5)
    np.testing.assert_array_equal(mask, ref_mask)
    for key in batch:
        np.testing.assert_array_equal(padded[key], ref[key])


def test_trainer_refuses_cuda_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    jax_config, _, params = _jax_model("fp32")
    config, model = _port_model(jax_config, params)
    with pytest.raises(RuntimeError):
        Trainer(config, model, synthetic_data_card(**CARD), device="cuda")


def test_training_mode_forward_is_refused():
    """A training forward is refused without the step's seed (its dropout
    and noise need one); with drop_path > 0 and a seed it runs, finite."""
    config = Config(**{**SMALL, "precision": "fp32"})
    model = build_model(config, synthetic_data_card(**CARD), seed=0, device="cpu").train()
    batch = _batch()
    with pytest.raises(ValueError, match="seed"):
        _port_predict(model, batch)
    model = build_model(config.replace(drop_path=0.1), synthetic_data_card(**CARD), seed=0,
                        device="cpu").train()
    out, _, _ = model(torch.from_numpy(batch["image"]), "A", torch.from_numpy(batch["behavior"]),
                      torch.from_numpy(batch["pupil_center"]), seed=1)
    assert out.shape == (2, 24) and torch.isfinite(out).all()
