"""The port's framework-free pieces against the JAX package, on the CPU:
configuration, data cards, micro-batching, patch extraction, grid sampling,
resizing and the image cropper. Inputs come from numpy seeds; float32
results agree to summation order (atol 1e-6 on unit-scale values) and the
integer and shape facts exactly.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from v1t_tpu import configs as jax_configs
from v1t_tpu.data.cards import synthetic_data_card as jax_card
from v1t_tpu.data.loaders import micro_batching as jax_micro_batching
from v1t_tpu.models.cropper import ImageCropper as JaxCropper
from v1t_tpu.ops import common as jax_common
from v1t_tpu.ops.grid_sample import grid_sample as jax_grid_sample
from v1t_tpu.ops.grid_sample import resize_bilinear as jax_resize_bilinear

from v1t_tpu_torch import configs
from v1t_tpu_torch.data.cards import micro_batching, synthetic_data_card
from v1t_tpu_torch.models.cropper import ImageCropper
from v1t_tpu_torch.ops import common
from v1t_tpu_torch.ops import grid_sample as gs

torch.set_num_threads(1)


def test_config_fields_match_jax():
    port = {f.name: f.default for f in dataclasses.fields(configs.Config)}
    ref = {f.name: f.default for f in dataclasses.fields(jax_configs.Config)}
    assert port.keys() == ref.keys()
    assert {k: v for k, v in port.items() if k != "device"} == {
        k: v for k, v in ref.items() if k != "device"
    }


def test_args_yaml_round_trip(tmp_path):
    config = configs.Config(output_dir=str(tmp_path), emb_dim=48, input_shape=(1, 36, 64),
                            output_shapes={"A": (24,)})
    configs.save_args(config)
    replayed = configs.load_args(str(tmp_path))
    assert replayed == config
    # and the JAX package replays the port's args.yaml
    assert jax_configs.load_args(str(tmp_path)).emb_dim == 48


@pytest.mark.parametrize("neurons", [24, (10, 30)])
def test_synthetic_card_matches_jax(neurons):
    ids = ("A",) if isinstance(neurons, int) else ("A", "B")
    port, ref = synthetic_data_card(ids, neurons), jax_card(ids, neurons)
    assert port.output_shapes == ref.output_shapes and port.input_shape == ref.input_shape
    for m in ids:
        for field in ("coordinates", "response_mean", "response_std", "neuron_ids"):
            np.testing.assert_array_equal(
                getattr(port.neuron_cards[m], field), getattr(ref.neuron_cards[m], field)
            )


def test_micro_batching_matches_jax():
    batch = {"image": np.arange(7 * 2).reshape(7, 2), "tag": "x"}
    port, ref = list(micro_batching(batch, 3)), list(jax_micro_batching(batch, 3))
    assert len(port) == len(ref) == 3
    for a, b in zip(port, ref):
        np.testing.assert_array_equal(a["image"], b["image"])
        assert a["tag"] == b["tag"]


@pytest.mark.parametrize("n", [1653, 1, 7, 120, 391])
def test_find_shape_matches_jax(n):
    assert common.find_shape(n) == jax_common.find_shape(n)


@pytest.mark.parametrize("patch,stride", [(8, 1), (8, 4), (3, 2)])
def test_unfold_patches_matches_jax(patch, stride):
    images = np.random.default_rng(0).normal(size=(2, 2, 12, 17)).astype(np.float32)
    port = common.unfold_patches(torch.from_numpy(images), patch, stride).numpy()
    ref = np.asarray(jax_common.unfold_patches(jnp.asarray(images), patch, stride))
    np.testing.assert_allclose(port, ref, atol=1e-6)
    assert port.shape[1] == (common.unfold_output_size(12, patch, stride)
                             * common.unfold_output_size(17, patch, stride))


def test_elu1_matches_jax():
    x = np.linspace(-5, 5, 101, dtype=np.float32)
    np.testing.assert_allclose(common.elu1(torch.from_numpy(x)).numpy(),
                               np.asarray(jax_common.elu1(jnp.asarray(x))), atol=1e-6)


@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
def test_grid_sample_matches_jax(mode):
    rng = np.random.default_rng(1)
    inputs = rng.normal(size=(2, 3, 6, 9)).astype(np.float32)
    grid = rng.uniform(-1.3, 1.3, size=(2, 4, 5, 2)).astype(np.float32)
    port = gs.grid_sample(torch.from_numpy(inputs), torch.from_numpy(grid), mode=mode).numpy()
    ref = np.asarray(jax_grid_sample(jnp.asarray(inputs), jnp.asarray(grid), mode=mode))
    np.testing.assert_allclose(port, ref, atol=1e-6)


@pytest.mark.parametrize("shape", [(36, 64), (18, 32), (50, 90)])
def test_resize_bilinear_matches_jax(shape):
    images = np.random.default_rng(2).normal(size=(2, 1, 36, 64)).astype(np.float32)
    port = gs.resize_bilinear(torch.from_numpy(images), *shape).numpy()
    ref = np.asarray(jax_resize_bilinear(jnp.asarray(images), *shape))
    np.testing.assert_allclose(port, ref, atol=1e-5)


@pytest.mark.parametrize("center_crop,resize,behavior_mode", [
    (1.0, 0, 0), (0.8, 1, 0), (1.0, 0, 1),
])
def test_cropper_without_shifter_matches_jax(center_crop, resize, behavior_mode):
    rng = np.random.default_rng(3)
    images = rng.normal(size=(2, 1, 36, 64)).astype(np.float32)
    behaviors = rng.normal(size=(2, 3)).astype(np.float32)
    pupils = rng.normal(size=(2, 2)).astype(np.float32)
    kw = dict(input_shape=(1, 36, 64), mouse_ids=("A",), shift_mode=2,
              behavior_mode=behavior_mode, center_crop=center_crop, resize_image=resize)
    jax_cropper = JaxCropper(**kw)
    (ref, ref_grid), _ = jax_cropper.init_with_output(
        {"params": __import__("jax").random.key(0)}, jnp.asarray(images), mouse_id="A",
        behaviors=jnp.asarray(behaviors), pupil_centers=jnp.asarray(pupils),
    )
    cropper = ImageCropper(**kw)
    assert cropper.output_shape == jax_cropper.output_shape
    out, grid = cropper(torch.from_numpy(images), "A", torch.from_numpy(behaviors),
                        torch.from_numpy(pupils))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)
    np.testing.assert_allclose(grid.numpy(), np.asarray(ref_grid), atol=1e-7)
    if center_crop == 1.0 and not resize and behavior_mode == 0:
        np.testing.assert_array_equal(out.numpy(), images)  # the flagship only crops
