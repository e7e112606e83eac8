"""The port's training slice against the JAX package, on the CPU.

The losses, the regularizers, the learning-rate labels and AdamW are held
against the JAX package's own functions on the same values; the readout's
training noise against its distribution; and ``Trainer.train_step`` over a
6-step float32 trajectory (two mice, micro-batching, one update per cycle,
dropout 0, readout sampling off) against an oracle composed from the JAX
package's ``build_optimizer``, ``get_criterion``, ``model_regularizer`` and
``model.apply`` in training mode with ``sample=False``, parameter for
parameter after ``export_state_dict``. Small model: 2 blocks, emb 32, 2
heads, MLP 64, 1x36x64 images (1654 tokens), mice of 20 and 30 neurons.

Tolerances (float32 throughout):
- losses, regularizers and their gradients, one AdamW step:
  max|d| <= 1e-5 * max|ref| + 1e-6 (summation order only);
- the trajectory: max|d| <= 1e-6 absolute per parameter tensor after 3
  updates of lr 1.647e-3, which move parameters by up to ~5e-3. Adam
  normalises every gradient element, so summation-order differences in a
  gradient show in the update at up to eps-bounded fractions of lr; the
  largest reading was 2.4e-7 (pos_embedding, one float32 step at |p| ~ 4.5);
- the readout noise: mean and standard deviation within 5 sigma of their
  sampling error over 20000 draws.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from v1t_tpu import losses as jax_losses
from v1t_tpu import optim as jax_optim
from v1t_tpu.configs import Config as JaxConfig
from v1t_tpu.data.cards import synthetic_data_card as jax_card
from v1t_tpu.data.loaders import micro_batching as jax_micro_batching
from v1t_tpu.models import build_model as jax_build_model
from v1t_tpu.models import model_regularizer as jax_model_regularizer
from v1t_tpu.models.model import init_model
from v1t_tpu.models.model import param_labels as jax_param_labels
from v1t_tpu.ops.common import elu1 as jax_elu1
from v1t_tpu.training import Trainer as JaxTrainer
from v1t_tpu.training import compute_metrics as jax_compute_metrics
from v1t_tpu.training import pad_batch as jax_pad_batch

from v1t_tpu_torch import losses, optim
from v1t_tpu_torch.configs import Config
from v1t_tpu_torch.data.cards import synthetic_data_card
from v1t_tpu_torch.models import build_model, model_regularizer, param_labels
from v1t_tpu_torch.training import Trainer, compute_metrics
from v1t_tpu_torch.utils.torch_export import export_state_dict

torch.set_num_threads(1)

TOL = 1e-5
TRAJECTORY_ATOL = 1e-6
SMALL = dict(
    core="vit", readout="gaussian2d", behavior_mode=3, shift_mode=2, resize_image=0,
    num_blocks=2, emb_dim=32, num_heads=2, mlp_dim=64, t_dropout=0.0, p_dropout=0.0,
    precision="fp32",
)
CARD = dict(mouse_ids=("A", "B"), num_neurons=(20, 30), input_shape=(1, 36, 64))


def _close(port, ref, tol=TOL, atol=1e-6, name=""):
    port = np.asarray(torch.as_tensor(port).detach().double().numpy())
    ref = np.asarray(ref, np.float64)
    assert port.shape == ref.shape, name
    err = np.abs(port - ref).max() if port.size else 0.0
    assert err <= tol * np.abs(ref).max() + atol, (name, err)


def _models(**overrides):
    """The JAX model with init weights and the port's model loaded with them."""
    jax_config = JaxConfig(**{**SMALL, **overrides})
    model = jax_build_model(jax_config, jax_card(**CARD))
    params = init_model(model, seed=0)
    fields = {f.name for f in dataclasses.fields(Config)}
    config = Config(**{k: v for k, v in dataclasses.asdict(jax_config).items() if k in fields})
    config = config.replace(mouse_ids=list(CARD["mouse_ids"]))
    port = build_model(config, synthetic_data_card(**CARD), seed=None, device="cpu")
    port.load_state_dict(export_state_dict(params, config), strict=True)
    return jax_config, model, params, config, port


def _batch(n, neurons, seed):
    rng = np.random.default_rng(seed)
    return {
        "image": rng.normal(size=(n, 1, 36, 64)).astype(np.float32),
        "behavior": rng.normal(size=(n, 3)).astype(np.float32),
        "pupil_center": rng.normal(size=(n, 2)).astype(np.float32),
        "response": rng.poisson(2.0, size=(n, neurons)).astype(np.float32),
    }


# --- losses --------------------------------------------------------------------

@pytest.mark.parametrize("criterion", ["poisson", "msse", "correlation"])
@pytest.mark.parametrize("ds_scale", [0, 1])
def test_criterion_matches_jax(criterion, ds_scale):
    rng = np.random.default_rng(1)
    y_true = rng.poisson(2.0, size=(5, 12)).astype(np.float32)
    y_pred = rng.gamma(2.0, 1.0, size=(5, 12)).astype(np.float32)
    mask = np.array([1, 1, 1, 0, 1], np.float32)  # a padded row
    config = Config(criterion=criterion, ds_scale=ds_scale)
    ds_sizes = {"A": 300}
    port = losses.get_criterion(config, ds_sizes)
    ref = jax_losses.get_criterion(JaxConfig(criterion=criterion, ds_scale=ds_scale), ds_sizes)
    for kw in ({}, {"mask": mask, "batch_size": 9}):
        yp = torch.tensor(y_pred, requires_grad=True)
        got = port(torch.tensor(y_true), yp, "A", batch_size=kw.get("batch_size"),
                   mask=None if "mask" not in kw else torch.tensor(mask))
        got.backward()
        want, grad = jax.value_and_grad(
            lambda p: ref(jnp.asarray(y_true), p, "A", batch_size=kw.get("batch_size"),
                          mask=None if "mask" not in kw else jnp.asarray(mask))
        )(jnp.asarray(y_pred))
        _close(got, want, name="loss")
        _close(yp.grad, grad, name="d(y_pred)")
    with pytest.raises(ValueError):
        losses.get_criterion(Config(criterion="nope"), ds_sizes)


def test_compute_metrics_matches_jax():
    rng = np.random.default_rng(2)
    y_true = rng.poisson(2.0, size=(40, 9)).astype(np.float32)
    y_pred = rng.gamma(2.0, 1.0, size=(40, 9)).astype(np.float32)
    got, want = compute_metrics(y_true, y_pred), jax_compute_metrics(y_true, y_pred)
    assert got.keys() == want.keys()
    for key in got:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-6, err_msg=key)


def test_validation_step_matches_jax():
    """Eval-mode losses over a batch that micro-batching splits and pads."""
    jax_config, model, params, config, port = _models(batch_size=3, micro_batch_size=2)
    jax_trainer = JaxTrainer(jax_config, model, params, jax_card(**CARD))
    trainer = Trainer(config, port, synthetic_data_card(**CARD), device="cpu")
    batch = _batch(3, CARD["num_neurons"][1], seed=7)
    got, got_targets, got_preds = trainer.validation_step("B", batch)
    want, want_targets, want_preds = jax_trainer.validation_step("B", batch)
    assert got.keys() == want.keys()
    for key in got:
        _close(got[key], want[key], name=key)
    np.testing.assert_array_equal(got_targets, want_targets)
    _close(got_preds, want_preds, name="predictions")
    assert not port.training  # eval mode, set by the call


# --- regularizers, labels, optimizer --------------------------------------------

REG = dict(shift_mode=3, center_crop=0.8, resize_image=1, shifter_reg_scale=0.3,
           cropper_reg_scale=0.2)


@pytest.mark.parametrize("core_frozen", [False, True])
def test_model_regularizer_and_its_gradient_match_jax(core_frozen):
    jax_config, _, params, config, port = _models(**REG)
    for mouse in CARD["mouse_ids"]:
        want, grads = jax.value_and_grad(
            lambda p: jax_model_regularizer(jax_config, p, mouse, core_frozen=core_frozen)
        )(params)
        port.zero_grad(set_to_none=True)
        got = model_regularizer(config, port, mouse, core_frozen=core_frozen)
        got.backward()
        _close(got, want, name="value")
        want_grads = export_state_dict(grads, config)
        for name, p in port.named_parameters():
            got_grad = torch.zeros_like(p) if p.grad is None else p.grad
            _close(got_grad, want_grads[name].numpy(), name=name)


def test_param_labels_match_jax():
    _, _, params, _, port = _models(**REG)
    want = {}
    for path, label in jax.tree_util.tree_flatten_with_path(jax_param_labels(params))[0]:
        want.setdefault(path[0].key, set()).add(label)
    got = {}
    for name, label in param_labels(port).items():
        got.setdefault(name.split(".")[0], set()).add(label)
    assert got == want == {"image_cropper": {"rest"}, "core": {"core"},
                           "core_shifter": {"rest"}, "readouts": {"rest"}}


@pytest.mark.parametrize("core_frozen,weight_decay", [(False, 0.0), (False, 0.05), (True, 0.0)])
def test_adamw_steps_match_jax(core_frozen, weight_decay):
    jax_config, _, params, config, port = _models(lr=2e-3, core_lr=5e-4)
    tx, opt_state = jax_optim.build_optimizer(jax_config, params, core_frozen=core_frozen,
                                              weight_decay=weight_decay)
    opt = optim.build_optimizer(config, port, core_frozen=core_frozen,
                                weight_decay=weight_decay)
    want_lrs = jax_optim.get_learning_rates(opt_state)
    assert optim.get_learning_rates(opt) == pytest.approx(want_lrs)
    rng = np.random.default_rng(3)
    for step in range(2):
        grads = jax.tree_util.tree_map(
            lambda p: jnp.asarray(rng.normal(size=p.shape), jnp.float32), params)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        port_grads = export_state_dict(grads, config)
        for name, p in port.named_parameters():
            if p.requires_grad:
                p.grad = port_grads[name].clone()
        opt.step()
    want = export_state_dict(params, config)
    for name, p in port.named_parameters():
        _close(p, want[name].numpy(), name=name)
    # the plateau scheduler's helpers
    opt_state = jax_optim.scale_learning_rates(opt_state, 0.3)
    optim.scale_learning_rates(opt, 0.3)
    assert optim.get_learning_rates(opt) == pytest.approx(jax_optim.get_learning_rates(opt_state))
    optim.set_learning_rates(opt, {"rest": 1e-4})
    assert optim.get_learning_rates(opt)["rest"] == pytest.approx(1e-4)


# --- the readout's training noise ------------------------------------------------

def test_readout_noise_has_mean_mu_and_std_sigma_and_is_clamped():
    config = Config(**{**SMALL, "disable_grid_predictor": True})
    card = synthetic_data_card(mouse_ids=("A",), num_neurons=4, input_shape=(1, 36, 64))
    readout = build_model(config, card, seed=0, device="cpu").train().readouts["A"]
    mu = torch.tensor([[0.1, -0.2], [0.3, 0.4], [-0.5, 0.0], [0.97, -0.97]])
    sigma = torch.tensor([[[0.1, 0.0], [0.0, 0.05]], [[0.08, 0.0], [0.0, 0.08]],
                          [[0.06, 0.03], [0.0, 0.04]], [[0.1, 0.0], [0.0, 0.1]]])
    with torch.no_grad():
        readout._mu.copy_(mu.view(1, 4, 1, 2))
        readout.sigma.copy_(sigma.view(1, 4, 2, 2))
    draws = 20000
    grid = readout.sample_grid(draws, True, torch.Generator().manual_seed(0))[:, :, 0]
    assert grid.shape == (draws, 4, 2)
    assert grid.abs().max() <= 1.0
    assert (grid[:, 3, 0] == 1.0).any() and (grid[:, 3, 1] == -1.0).any()  # clamped
    for n in range(3):  # away from the edges: N(mu, sigma sigma^T)
        cov = sigma[n] @ sigma[n].t()
        std = cov.diagonal().sqrt()
        mean_err = (grid[:, n].mean(0) - mu[n]).abs()
        assert (mean_err <= 5 * std / draws ** 0.5).all(), n
        std_err = (grid[:, n].std(0) - std).abs()
        assert (std_err <= 5 * std / (2 * draws) ** 0.5).all(), n
        emp_cov = torch.cov(grid[:, n].t())
        assert (emp_cov[0, 1] - cov[0, 1]).abs() <= 5 * std.prod() / draws ** 0.5, n
    again = readout.sample_grid(draws, True, torch.Generator().manual_seed(0))[:, :, 0]
    assert torch.equal(again, grid)  # the step's generator makes the noise
    assert torch.equal(readout.sample_grid(2, False)[:, :, 0], mu.clamp(-1, 1).expand(2, 4, 2))


# --- the trajectory -------------------------------------------------------------

def _jax_train_forward(module, images, mouse_id, behaviors, pupils):
    """Model.__call__ in training mode with the readout's sampling off."""
    images, _ = module.image_cropper(images, mouse_id=mouse_id, behaviors=behaviors,
                                     pupil_centers=pupils)
    out = module.core(images, mouse_id=mouse_id, behaviors=behaviors, pupil_centers=pupils,
                      train=True)
    shifts = module.core_shifter(pupils, mouse_id=mouse_id)
    out = module.readouts(out, mouse_id=mouse_id, shifts=shifts, train=True, sample=False)
    return jax_elu1(out.astype(jnp.float32))


def test_six_step_trajectory_matches_jax():
    overrides = dict(batch_size=3, micro_batch_size=2)
    jax_config, model, params, config, port = _models(**overrides)
    card = jax_card(**CARD)
    tx, opt_state = jax_optim.build_optimizer(jax_config, params)
    criterion = jax_losses.get_criterion(jax_config, card.ds_sizes)

    def loss_fn(p, arrays, mask, mouse_id, total, reg_weight):
        y_pred = model.apply({"params": p}, arrays["image"], mouse_id, arrays["behavior"],
                             arrays["pupil_center"], method=_jax_train_forward)
        loss = criterion(arrays["response"], y_pred, mouse_id, batch_size=total, mask=mask)
        return loss + reg_weight * jax_model_regularizer(jax_config, p, mouse_id)

    grad_fn = jax.jit(jax.value_and_grad(loss_fn), static_argnums=(3,))
    trainer = Trainer(config, port, synthetic_data_card(**CARD), device="cpu")
    mice = CARD["mouse_ids"]
    for cycle in range(3):
        batches = {m: _batch(3, n, seed=10 * cycle + i)
                   for i, (m, n) in enumerate(zip(mice, CARD["num_neurons"]))}
        acc = None
        for m in mice:
            for micro in jax_micro_batching(batches[m], 2):
                padded, mask = jax_pad_batch(micro, 2)
                arrays = {k: jnp.asarray(v) for k, v in padded.items()}
                n = len(micro["image"])
                _, grads = grad_fn(params, arrays, jnp.asarray(mask), m, np.float32(3),
                                   np.float32(n / 3))
                acc = grads if acc is None else jax.tree_util.tree_map(jnp.add, acc, grads)
        updates, opt_state = tx.update(acc, opt_state, params)
        params = optax.apply_updates(params, updates)

        port_acc = None
        for i, m in enumerate(mice):
            port_acc, metrics = trainer.train_step(m, batches[m], port_acc,
                                                   update=i == len(mice) - 1, sample=False)
            assert set(metrics) == {"loss/loss", "loss/reg_loss", "loss/total_loss"}
            assert (port_acc is None) == (i == len(mice) - 1)
    assert trainer._step_count == 3 * 2 * 2  # one per micro-batch
    want = export_state_dict(params, config)
    start = export_state_dict(init_model(model, seed=0), config)
    moved = 0.0
    for name, p in port.named_parameters():
        _close(p, want[name].numpy(), 0.0, TRAJECTORY_ATOL, name)
        moved = max(moved, float((p.detach() - start[name]).abs().max()))
    assert moved > 1e-3  # the parameters did move
