"""The rest of the port's ViT core against the JAX package's, on the CPU:
patch modes 1-3, stochastic depth (``drop_path``), gradient checkpointing,
the attention probabilities (``return_probs``) and a pairwise cover of the
model's options (behavior modes 0-4, shift modes 0 / 2 / 4, LSA, patch
modes 0-3).

Models are small: 2 blocks, emb 32, 2 heads, MLP 64, 24 neurons, 1x20x24
images, patch 4 stride 2 (9 x 11 patches + CLS = 100 tokens), batch 2 or 4.
In float32 every JAX weight gets noise from a second seed, as in
``test_torch_port_composed.py`` (N(0, fan_in^-0.5) on matrices, N(0, 0.1)
on the rest), so that no fault hides behind the reference's small init; in
bf16 the init stays. JAX runs its Pallas kernels under the Mosaic
interpreter (``V1T_PALLAS_INTERPRET=1``), the port their plain versions.
The transformer's and patch embedding's dropout are off (the packages
draw different bits); stochastic depth takes the masks JAX drew
(recorded by wrapping ``v1t_tpu.models.cores.vit.drop_path`` in the test)
through the port's ``drop_path_mask``.

Tolerances (max|port - jax| <= tol * max|jax|):
- float32 outputs, core maps and probabilities 2e-5 (summation order over
  2 blocks; as ``test_torch_port_composed.py``); float32 gradients 1e-4 a
  parameter (the same through the backward's longer sums);
- bf16 outputs and core maps 2e-2: both round at the same points, but
  float32 summation order flips bf16 roundings (2^-8) that carry through
  2 blocks of a bf16 residual stream (``test_torch_port_composed.py``).
- The port's own gradients with and without checkpointing: bit for bit
  (the backward reruns the same CPU ops on the same inputs).
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
from v1t_tpu_torch.ops.common import drop_path_mask
from v1t_tpu_torch.utils.torch_export import export_state_dict

torch.set_num_threads(2)

SMALL = dict(
    core="vit", readout="gaussian2d", behavior_mode=3, shift_mode=2, resize_image=0,
    num_blocks=2, emb_dim=32, num_heads=2, mlp_dim=64, batch_size=2, patch_size=4,
    patch_stride=2, t_dropout=0.0, p_dropout=0.0,
)
CARD = dict(mouse_ids=("A",), num_neurons=24, input_shape=(1, 20, 24))
TOKENS = 9 * 11 + 1
F32_TOL, GRAD_TOL, BF16_TOL = 2e-5, 1e-4, 2e-2


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("V1T_PALLAS_INTERPRET", "1")


def _models(precision, noise=True, **overrides):
    jax_config = JaxConfig(**{**SMALL, "precision": precision, **overrides})
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


def _inputs(seed=0, n=2, channels=1):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, channels, *CARD["input_shape"][1:])).astype(np.float32),
            rng.normal(size=(n, 3)).astype(np.float32),
            rng.normal(size=(n, 2)).astype(np.float32))


def _t(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


def _jax_forward(jax_model, params, images, behaviors, pupils):
    return jax_model.apply({"params": params}, jnp.asarray(images), mouse_id="A",
                           behaviors=jnp.asarray(behaviors), pupil_centers=jnp.asarray(pupils),
                           train=False)[0]


def _jax_core(jax_model, params, images, behaviors, pupils, train=False, rngs=None,
              return_probs=False):
    return jax_model.apply({"params": params}, jnp.asarray(images), "A", jnp.asarray(behaviors),
                           jnp.asarray(pupils), train=train, return_probs=return_probs,
                           rngs=rngs, method="core_forward")


def _close(port, ref, tol):
    port = np.asarray(torch.as_tensor(port).detach().double().numpy())
    ref = np.asarray(ref, np.float64)
    assert port.shape == ref.shape and np.isfinite(port).all()
    err = np.abs(port - ref).max()
    assert err <= tol * np.abs(ref).max(), (err, np.abs(ref).max())


def _close_grads(model, jax_grads, config, prefix=""):
    ref = export_state_dict(jax_grads, config)
    checked = 0
    for name, p in model.named_parameters():
        if not name.startswith(prefix):
            continue
        if p.grad is None:  # unused in this forward (the readout's sigma in eval)
            assert not ref[name].any(), name
            continue
        _close(p.grad, ref[name].numpy(), GRAD_TOL)
        checked += 1
    assert checked


# --- patch modes 1-3 -----------------------------------------------------------


@pytest.mark.parametrize("patch_mode", [1, 2, 3])
def test_patch_modes_forward_and_gradients_match_jax_float32(patch_mode):
    config, jax_model, params, model = _models("fp32", patch_mode=patch_mode)
    images, behaviors, pupils = _inputs()
    w = np.random.default_rng(1).normal(size=(2, 24)).astype(np.float32)

    def jax_loss(p):
        return jnp.sum(_jax_forward(jax_model, p, images, behaviors, pupils) * w)

    out = model(*_t(images), "A", *_t(behaviors, pupils))[0]
    _close(out, _jax_forward(jax_model, params, images, behaviors, pupils), F32_TOL)
    (out * torch.from_numpy(w)).sum().backward()
    _close_grads(model, jax.jit(jax.grad(jax_loss))(params), config)


@pytest.mark.parametrize("patch_mode", [1, 2, 3])
def test_patch_modes_bf16_forward_matches_jax_kernels(interpret, patch_mode):
    """bf16: the fused sublayers (JAX's interpreted Pallas kernels, the
    port's plain versions); mode 3's float32 tokens enter the first block
    cast, as JAX casts them."""
    _, jax_model, params, model = _models("bf16", noise=False, patch_mode=patch_mode)
    images, behaviors, pupils = _inputs()
    with torch.no_grad():
        out = model(*_t(images), "A", *_t(behaviors, pupils))[0]
        core = model.core(*_t(images), "A", *_t(behaviors, pupils))
    _close(out, _jax_forward(jax_model, params, images, behaviors, pupils), BF16_TOL)
    _close(core.float(), np.asarray(_jax_core(jax_model, params, images, behaviors, pupils),
                                    np.float32), BF16_TOL)


def test_patch_mode_state_dict_keys_are_the_references():
    keys = {}
    for mode in (0, 1, 2, 3):
        config = Config(**{**SMALL, "patch_mode": mode, "precision": "fp32"})
        model = build_model(config, synthetic_data_card(**CARD), seed=0, device="cpu")
        keys[mode] = sorted(k[len("core.patch_embedding.projection."):]
                            for k in model.state_dict()
                            if k.startswith("core.patch_embedding.projection."))
    assert keys == {0: ["2.bias", "2.weight"], 1: ["0.bias", "0.weight"],
                    2: ["3.bias", "3.weight", "4.bias", "4.weight"],
                    3: ["2.bias", "2.weight", "3.bias", "3.weight", "4.bias", "4.weight"]}
    # mode 1's init: Kaiming normal over fan_in = c * p * p (std sqrt(2 / 16))
    config = Config(**{**SMALL, "patch_mode": 1, "emb_dim": 256, "precision": "fp32"})
    conv = build_model(config, synthetic_data_card(**CARD), seed=0,
                       device="cpu").core.patch_embedding.projection[0]
    assert abs(conv.weight.std().item() - (2 / 16) ** 0.5) < 0.03
    assert conv.bias.abs().max().item() <= 0.25


# --- stochastic depth ------------------------------------------------------------


@pytest.fixture
def jax_masks(monkeypatch):
    """The per-sample keep masks JAX's drop_path draws, in call order."""
    recorded = []
    original = jax_vit.drop_path

    def recording(x, rate, deterministic, rng):
        if not deterministic and rate > 0.0:
            shape = (x.shape[0],) + (1,) * (x.ndim - 1)  # as drop_path draws it
            mask = jax.random.bernoulli(rng, p=1.0 - rate, shape=shape)
            if not isinstance(mask, jax.core.Tracer):
                recorded.append(np.asarray(mask).reshape(-1))
        return original(x, rate, deterministic, rng)

    monkeypatch.setattr(jax_vit, "drop_path", recording)
    return recorded


def _hand_over(monkeypatch, masks):
    queue = [torch.from_numpy(m.copy()) for m in masks]
    monkeypatch.setattr(port_vit, "drop_path_mask", lambda b, rate, generator, device: queue.pop(0))
    return queue


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_drop_path_matches_jax_with_its_masks(interpret, monkeypatch, jax_masks, precision):
    """A training forward at drop_path 0.5 (batch 4): JAX's core with its
    drop-path stream, the port's core with the masks JAX drew; float32
    also the gradients. bf16 runs the fused sublayers without the folded
    residual (the out-projection without residual, forward and backward)."""
    config, jax_model, params, model = _models(precision, noise=precision == "fp32",
                                               drop_path=0.5)
    images, behaviors, pupils = _inputs(n=4)
    rngs = {"droppath": jax.random.key(3)}
    ref = _jax_core(jax_model, params, images, behaviors, pupils, train=True, rngs=rngs)
    assert len(jax_masks) == 2 * SMALL["num_blocks"]
    drawn = np.stack(jax_masks)
    assert drawn.any() and not drawn.all()  # some samples kept, some dropped
    queue = _hand_over(monkeypatch, jax_masks)
    model.core.train()
    core = model.core(*_t(images), "A", *_t(behaviors, pupils), seed=5)
    assert not queue
    tol = F32_TOL if precision == "fp32" else BF16_TOL
    _close(core.float(), np.asarray(ref, np.float32), tol)
    # a dropped branch leaves exactly the residual: without drop_path the
    # output differs where a mask dropped
    if precision == "fp32":
        w = np.random.default_rng(2).normal(size=core.shape).astype(np.float32)

        def jax_loss(p):
            return jnp.sum(_jax_core(jax_model, p, images, behaviors, pupils, train=True,
                                     rngs=rngs) * w)

        (core * torch.from_numpy(w)).sum().backward()
        _close_grads(model, jax.jit(jax.grad(jax_loss))(params), config, prefix="core.")


def test_drop_path_mask_keep_rate_and_generator():
    """One Bernoulli(1 - rate) per sample, from the generator it is given
    (reproducible by its seed), never from the global generator."""
    state = torch.get_rng_state()
    masks = [drop_path_mask(200_000, 0.1, torch.Generator().manual_seed(s), "cpu")
             for s in (1, 1, 2)]
    assert torch.equal(torch.get_rng_state(), state)
    keep = masks[0].float().mean().item()
    assert abs(keep - 0.9) < 5 * (0.09 / 200_000) ** 0.5
    assert masks[0].dtype == torch.bool and masks[0].shape == (200_000,)
    assert torch.equal(masks[0], masks[1]) and not torch.equal(masks[0], masks[2])


# --- gradient checkpointing ---------------------------------------------------------


def test_grad_checkpointing_gradients_match_jax_remat():
    config, jax_model, params, model = _models("fp32", grad_checkpointing=1)
    assert all(block.grad_checkpointing for block in model.core.transformer.blocks)
    images, behaviors, pupils = _inputs()
    w = np.random.default_rng(1).normal(size=(2, 24)).astype(np.float32)

    def jax_loss(p):
        return jnp.sum(_jax_forward(jax_model, p, images, behaviors, pupils) * w)

    out = model(*_t(images), "A", *_t(behaviors, pupils))[0]
    (out * torch.from_numpy(w)).sum().backward()
    _close_grads(model, jax.jit(jax.grad(jax_loss))(params), config)


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_grad_checkpointing_recomputes_and_is_bit_equal(monkeypatch, precision):
    """Training forwards with the transformer's dropout and drop_path on:
    with checkpointing the backward reruns each sublayer (twice the
    attention sublayer's calls) and every gradient equals the one without,
    bit for bit: the kernels' masks come back from (seed, site), the
    drop-path masks are drawn outside the checkpointed calls."""
    calls = []
    for name in ("fused_mha", "fused_mlp", "multi_head_attention"):
        original = getattr(port_vit, name)
        monkeypatch.setattr(port_vit, name, lambda *a, _f=original, _n=name, **k: (
            calls.append(_n), _f(*a, **k))[1])
    config = Config(**{**SMALL, "precision": precision, "t_dropout": 0.2, "p_dropout": 0.1,
                       "drop_path": 0.3})
    images, behaviors, pupils = _inputs(n=4)
    w = torch.from_numpy(np.random.default_rng(1).normal(size=(4, 24)).astype(np.float32))
    grads, counts = [], []
    for checkpointing in (0, 1):
        model = build_model(config.replace(grad_checkpointing=checkpointing),
                            synthetic_data_card(**CARD), seed=0, device="cpu").train()
        calls.clear()
        out = model(*_t(images), "A", *_t(behaviors, pupils), seed=11, sample=True)[0]
        (out * w).sum().backward()
        counts.append(len(calls))
        grads.append({n: p.grad.clone() for n, p in model.named_parameters()})
    assert counts[0] >= SMALL["num_blocks"] and counts[1] == 2 * counts[0]
    assert grads[0].keys() == grads[1].keys()
    for name, g in grads[0].items():
        assert torch.equal(g, grads[1][name]), name


# --- attention probabilities -------------------------------------------------------


@pytest.mark.parametrize("precision,use_lsa", [("fp32", False), ("fp32", True), ("bf16", False)])
def test_core_probabilities_match_jax(interpret, precision, use_lsa):
    """``return_probs``: every block on the composed attention's einsum
    form; (B, blocks, heads, N, N) float32 probabilities and the map."""
    _, jax_model, params, model = _models(precision, noise=precision == "fp32",
                                          use_lsa=use_lsa)
    images, behaviors, pupils = _inputs()
    ref_map, ref_probs = _jax_core(jax_model, params, images, behaviors, pupils,
                                   return_probs=True)
    with torch.inference_mode():
        cropped, _ = model.crop(*_t(images), "A", *_t(behaviors, pupils))
        core, probs = model.core_forward(cropped, "A", *_t(behaviors, pupils),
                                         return_probs=True)
    assert probs.dtype == torch.float32
    assert probs.shape == (2, SMALL["num_blocks"], SMALL["num_heads"], TOKENS, TOKENS)
    tol = F32_TOL if precision == "fp32" else BF16_TOL
    _close(probs, np.asarray(ref_probs), tol)
    _close(core.float(), np.asarray(ref_map, np.float32), tol)
    torch.testing.assert_close(probs.sum(-1), torch.ones(probs.shape[:-1]), rtol=0, atol=1e-5)


# --- the forward-parity matrix -------------------------------------------------------


def _pairwise_cover():
    """Every pair of values of (behavior mode, patch mode, shift mode, LSA)
    in 20 cases: a row per (behavior, patch) pair, shift mode and LSA by
    their sum (s mod 3, s mod 2 meet every pair of each other over s
    0..7)."""
    return [(b, p, (0, 2, 4)[(b + p) % 3], bool((b + p) % 2))
            for b in range(5) for p in range(4)]


def test_pairwise_cover_covers_every_pair():
    cases = _pairwise_cover()
    values = [range(5), range(4), (0, 2, 4), (False, True)]
    for i in range(4):
        for j in range(i + 1, 4):
            seen = {(c[i], c[j]) for c in cases}
            assert seen == {(a, b) for a in values[i] for b in values[j]}, (i, j)


@pytest.mark.parametrize("behavior_mode,patch_mode,shift_mode,use_lsa", _pairwise_cover())
def test_forward_parity_matrix_float32(behavior_mode, patch_mode, shift_mode, use_lsa):
    _, jax_model, params, model = _models(
        "fp32", behavior_mode=behavior_mode, patch_mode=patch_mode, shift_mode=shift_mode,
        use_lsa=use_lsa)
    images, behaviors, pupils = _inputs(seed=behavior_mode * 4 + patch_mode)
    with torch.no_grad():
        out = model(*_t(images), "A", *_t(behaviors, pupils))[0]
    _close(out, _jax_forward(jax_model, params, images, behaviors, pupils), F32_TOL)
