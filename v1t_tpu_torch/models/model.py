"""Full model assembly: ImageCropper -> core -> CoreShifters -> per-mouse
readouts -> ELU+1, forward (eval and training), the regularizers and the
learning-rate labels.

Mirrors ``v1t_tpu/models/model.py`` and the reference
src/v1t/models/model.py: the forward contract ``(outputs, images,
image_grids)``, ``activate=False`` skipping the ELU+1, shift_mode 0-4
deciding which shifters exist, ``model_regularizer`` and ``param_labels``.
Parameters are float32; ``dtype`` (bf16 under ``precision="bf16"``) is the
compute type of the activations, as in the JAX package. A training forward
(``model.train()``) takes the step's ``seed``: the kernels key their
dropout masks with it, and a ``torch.Generator`` on the device seeded with
it draws the patch embedding's dropout and the readout's grid noise.
"""

from __future__ import annotations

import typing as t

import torch
from torch import nn

from v1t_tpu_torch.configs import Config
from v1t_tpu_torch.data.cards import DataCard
from v1t_tpu_torch.models.cropper import ImageCropper
from v1t_tpu_torch.models.registry import get_core, get_readout
from v1t_tpu_torch.models.shifter import CoreShifters
from v1t_tpu_torch.ops.common import elu1


class Readouts(nn.ModuleDict):
    """One readout per mouse, keyed by mouse id (reference
    src/v1t/models/readout/readout.py:52-85)."""

    def __init__(self, model: str, input_shape, data_card: DataCard,
                 use_grid_predictor: bool = True, grid_predictor_dim: int = 2,
                 bias_mode: int = 0, impl: str = "auto"):
        cls = get_readout(model)
        super().__init__({
            m: cls(
                input_shape=input_shape, neuron_card=data_card.neuron_cards[m],
                use_grid_predictor=use_grid_predictor,
                grid_predictor_dim=grid_predictor_dim, bias_mode=bias_mode,
                impl=impl,
            )
            for m in data_card.mouse_ids
        })

    def forward(self, inputs, mouse_id: str, shifts=None, sample=None, generator=None):
        return self[mouse_id](inputs, shifts=shifts, sample=sample, generator=generator)


class Model(nn.Module):
    def __init__(self, config: Config, data_card: DataCard, dtype: t.Optional[torch.dtype] = None):
        super().__init__()
        self.config, self.data_card, self.dtype = config, data_card, dtype
        self.image_cropper = ImageCropper(
            input_shape=data_card.input_shape, mouse_ids=data_card.mouse_ids,
            shift_mode=config.shift_mode, behavior_mode=config.behavior_mode,
            center_crop=config.center_crop, resize_image=config.resize_image,
            ds_name=data_card.ds_name, dtype=dtype,
        )
        self.core = get_core(config.core).from_config(
            config, image_shape=self.image_cropper.output_shape,
            mouse_ids=data_card.mouse_ids, dtype=dtype,
        )
        self.core_shifter = (
            CoreShifters(data_card.mouse_ids, dtype=dtype)
            if config.shift_mode in (2, 3, 4) else None
        )
        self.readouts = Readouts(
            config.readout, self.core.output_shape, data_card,
            use_grid_predictor=not config.disable_grid_predictor,
            grid_predictor_dim=config.grid_predictor_dim, bias_mode=config.bias_mode,
            impl=config.readout_impl,
        )

    def forward(self, inputs: torch.Tensor, mouse_id: str, behaviors: torch.Tensor,
                pupil_centers: torch.Tensor, activate: bool = True,
                seed: t.Optional[int] = None, sample: t.Optional[bool] = None):
        """Returns (responses (B, N) float32, cropped images, image grids).
        In training ``seed`` (uint32) is required; ``sample`` switches the
        readout's grid noise (default: on in training)."""
        generator = None
        if self.training:
            if seed is None:
                raise ValueError("a training forward needs the step's seed")
            generator = torch.Generator(device=inputs.device).manual_seed(seed)
        images, image_grids = self.image_cropper(inputs, mouse_id, behaviors, pupil_centers)
        outputs = self.core(images, mouse_id, behaviors, pupil_centers, seed, generator)
        shifts = None
        if self.core_shifter is not None:
            shifts = self.core_shifter(pupil_centers, mouse_id)
        outputs = self.readouts(outputs, mouse_id, shifts=shifts, sample=sample,
                                generator=generator).float()
        if activate:
            outputs = elu1(outputs)
        return outputs, images, image_grids

    def crop(self, inputs: torch.Tensor, mouse_id: str, behaviors: torch.Tensor,
             pupil_centers: torch.Tensor):
        """Only the image cropper: (cropped images, image grids) (the
        attention rollout's first step, reference attention_rollout.py:168-173)."""
        return self.image_cropper(inputs, mouse_id, behaviors, pupil_centers)

    def core_forward(self, images: torch.Tensor, mouse_id: str, behaviors: torch.Tensor,
                     pupil_centers: torch.Tensor, return_probs: bool = False):
        """The core alone on cropped images, in the module's mode (eval for
        the rollout); ``return_probs`` also returns the (B, blocks, heads,
        N, N) attention probabilities (``v1t_tpu/models/model.py``
        ``core_forward``, the reference's Recorder)."""
        return self.core(images, mouse_id, behaviors, pupil_centers, return_probs=return_probs)

    def init_weights(self, generator: torch.Generator) -> None:
        """The reference's init, drawn from ``generator``: trunc_normal(0.02)
        inside the transformer, torch's defaults outside it."""
        self.image_cropper.init_weights(generator)
        self.core.init_weights(generator)
        if self.core_shifter is not None:
            for shifter in self.core_shifter.values():
                shifter.init_weights(generator)
        for readout in self.readouts.values():
            readout.init_weights(generator)


def model_regularizer(config: Config, model: Model, mouse_id: str,
                      core_frozen: bool = False) -> torch.Tensor:
    """Sum of the module regularizers for one mouse (reference
    model.py:141-149): L1 over the core (unless frozen), the readout's
    features, the mouse's image shifter and core shifter."""
    reg = model.readouts[mouse_id].regularizer(config.readout_reg_scale)
    if not core_frozen:
        reg = reg + model.core.regularizer(config.core_reg_scale)
    reg = reg + model.image_cropper.regularizer(mouse_id, config.cropper_reg_scale)
    if model.core_shifter is not None:
        reg = reg + model.core_shifter.regularizer(mouse_id, config.shifter_reg_scale)
    return reg


def param_labels(model: nn.Module) -> t.Dict[str, str]:
    """Each parameter's learning-rate group: the core trains at ``core_lr``,
    everything else at ``lr`` (reference model.py:112-139)."""
    return {
        name: "core" if name.split(".")[0] == "core" else "rest"
        for name, _ in model.named_parameters()
    }


def compute_dtype(config: Config) -> t.Optional[torch.dtype]:
    return torch.bfloat16 if config.precision == "bf16" else None


def build_model(config: Config, data_card: DataCard, seed: t.Optional[int] = 0,
                device: t.Union[str, torch.device] = "cuda") -> Model:
    """The model in eval mode on ``device`` (the card unless the caller
    asks for the CPU), its weights drawn from a
    ``torch.Generator`` seeded with ``seed`` (None leaves torch's module
    defaults, for weights loaded afterwards)."""
    model = Model(config, data_card, dtype=compute_dtype(config))
    if seed is not None:
        model.init_weights(torch.Generator().manual_seed(seed))
    return model.to(device).eval()
