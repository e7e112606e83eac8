"""Typed run configuration of the PyTorch port.

A copy of the JAX package's ``Config`` dataclass (same field names as the
reference CLI flags, so an ``args.yaml`` written by either package replays in
the other). The port reads these fields:

- ``attention_impl``: "auto" runs the core's attention and MLP sublayers
  through the hand-written CUDA kernels on a CUDA device and through their
  plain PyTorch versions on a CPU tensor: the fused sublayers in bf16 up to
  4096 tokens, the composed path with the flash kernels in float32
  (``precision="fp32"``) or above 4096 tokens (``models/cores/vit.py``);
  "xla" selects the plain PyTorch versions of the same path on any device,
  the reference the kernel path is held against on the card.
- ``readout_impl``: the same switch for the Gaussian2d readout's bilinear
  sampling (bf16 or float32 maps).

PyYAML is imported only inside ``save_args`` / ``load_args``: the serving
path never touches ``args.yaml`` and runs where PyYAML is not installed.
"""

from __future__ import annotations

import dataclasses
import os
import typing as t
from dataclasses import dataclass


@dataclass
class Config:
    """Flat run configuration. Field names match the reference CLI flags."""

    # dataset settings (reference train.py:330-386)
    dataset: str = ""
    output_dir: str = ""
    mouse_ids: t.Optional[t.List[str]] = None
    behavior_mode: int = 0  # 0 none / 1 concat channel / 2 latent / 3 +pupil / 4 per-mouse
    center_crop: float = 1.0
    resize_image: int = 1  # 0: full image, 1: resize to (36, 64)
    gray_scale: bool = False
    limit_data: t.Optional[int] = None
    num_workers: int = 2

    # training settings (reference train.py:388-437)
    epochs: int = 400
    batch_size: int = 8
    micro_batch_size: int = 0  # 0 -> use batch_size (no micro-batching)
    device: str = ""  # "", "cuda", "cpu"
    seed: int = 1234
    amp: bool = False
    precision: str = "bf16"  # compute dtype for matmuls: "bf16" | "fp32"
    # host->device image dtype: "auto" sends bf16 when precision is bf16
    # (halves the dominant transfer; ~0.4% relative quantization ahead of
    # the cropper), "fp32" keeps the reference's exact fp32 wire for strict
    # parity runs
    image_wire_dtype: str = "auto"
    grad_checkpointing: t.Optional[int] = None
    deterministic: bool = False

    # optimizer settings (reference train.py:439-455)
    adam_beta1: float = 0.9
    adam_beta2: float = 0.9999
    adam_eps: float = 1e-8
    criterion: str = "poisson"
    ds_scale: int = 1
    lr: float = 0.001647
    core_lr: t.Optional[float] = None

    # pretrained core (reference train.py:457-463)
    pretrain_core: str = ""

    # model settings (reference train.py:495-519)
    core: str = "vit"
    readout: str = "gaussian2d"
    shift_mode: int = 2  # 0 none / 1 cropper / 2 readout / 3 both / 4 both+behavior

    # ViT core hyper-parameters, tuned defaults (reference train.py:542-590)
    patch_size: int = 8
    patch_mode: int = 0  # 0 unfold / 1 conv / 2 shifted-patch-tok / 3 dual patchnorm
    patch_stride: int = 1
    num_blocks: int = 4
    num_heads: int = 4
    emb_dim: int = 155
    mlp_dim: int = 488
    p_dropout: float = 0.0229  # patch-embedding dropout
    t_dropout: float = 0.2544  # transformer block dropout
    drop_path: float = 0.0
    use_lsa: bool = False
    disable_bias: bool = False
    core_reg_scale: float = 0.5379

    # CCT-specific (reference train.py:591-623)
    pos_emb: str = "sine"  # "sine" | "learn" | "none"

    # stacked2d / stn / conv-specific (reference train.py:526-541, 624-630)
    num_layers: int = 4
    num_filters: int = 8
    dropout: float = 0.0
    core_reg_input: float = 6.3831
    core_reg_hidden: float = 0.0
    linear: bool = False
    # stacked2d architecture variants (reference stacked2d.py:315-601
    # __init__ kwargs; reference defaults)
    stacked2d_conv_type: str = "ds"  # "ds" | "attention" | "conv"
    stacked2d_skip: int = 0
    stacked2d_stack: int = -1
    stacked2d_pad_input: int = 0
    stacked2d_batch_norm: int = 1
    stacked2d_independent_bn_bias: int = 1
    stacked2d_batch_norm_scale: int = 1
    stacked2d_final_batchnorm_scale: int = 1
    stacked2d_final_nonlinearity: int = 1

    # readout hyper-parameters (reference train.py:634-650)
    disable_grid_predictor: bool = False
    grid_predictor_dim: int = 2
    bias_mode: int = 0
    readout_reg_scale: float = 0.0076

    # shifter / cropper regularizer scales (reference train.py:652-657)
    shifter_reg_scale: float = 0.0
    cropper_reg_scale: float = 0.0

    # core sublayers: "auto" = CUDA kernels for bf16 CUDA tensors (plain
    # version on a CPU tensor); "xla" = the plain composed path everywhere
    attention_impl: str = "auto"  # "auto" | "xla"
    # readout bilinear sampling, the same switch
    readout_impl: str = "auto"  # "auto" | "xla"

    # ensemble settings (reference ensemble.py:441-543)
    ensemble_mode: int = 0  # 0 average / 1 shared Linear / 2 per-mouse Linear
    weight_decay: float = 0.01
    train: bool = False  # ensemble: train the output head

    # parallelism (not ported yet; kept so args.yaml replays)
    data_parallel: int = 0  # 0 -> use all local devices
    # context parallelism (SURVEY.md §5.7): shard attention tokens over a
    # "seq" mesh axis of this size (0/1 = off); enables full-resolution
    # (144x256 -> 34k-token) training across chips
    sequence_parallel: int = 0
    sequence_parallel_impl: str = "allgather"  # "allgather" | "ring"
    # multi-host bootstrap
    coordinator_address: t.Optional[str] = None
    num_processes: int = 0  # 0/1 = single process
    process_id: int = 0

    # misc (reference train.py:465-493)
    save_plots: bool = False
    dpi: int = 120
    format: str = "svg"
    use_wandb: bool = False
    wandb_group: str = ""
    clear_output_dir: bool = False
    verbose: int = 1

    # derived fields, filled by the data layer (kept for args.yaml parity with
    # reference data.py:487-489 / utils.py:471)
    ds_name: str = ""
    input_shape: t.Optional[t.Tuple[int, ...]] = None
    output_shapes: t.Optional[t.Dict[str, t.Tuple[int, ...]]] = None
    trainable_params: t.Optional[int] = None

    def replace(self, **kwargs) -> "Config":
        return dataclasses.replace(self, **kwargs)

    # --- compatibility helpers -------------------------------------------------

    @property
    def effective_micro_batch_size(self) -> int:
        return self.micro_batch_size if self.micro_batch_size else self.batch_size

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def save_args(config: Config) -> str:
    """Write ``<output_dir>/args.yaml`` (reference utils/utils.py:280-289)."""
    import yaml

    os.makedirs(config.output_dir, exist_ok=True)
    filename = os.path.join(config.output_dir, "args.yaml")
    with open(filename, "w") as file:
        yaml.safe_dump(_yamlify(config.to_dict()), file, sort_keys=False)
    return filename


def load_args(output_dir: str, overrides: t.Optional[dict] = None) -> Config:
    """Replay a run's ``args.yaml``; unknown keys are dropped and
    ``overrides`` wins over the stored values."""
    import yaml

    with open(os.path.join(output_dir, "args.yaml"), "r") as file:
        payload = yaml.safe_load(file)
    known = {f.name for f in dataclasses.fields(Config)}
    kwargs = {k: v for k, v in payload.items() if k in known}
    if overrides:
        kwargs.update(overrides)
    kwargs["output_dir"] = output_dir
    config = Config(**kwargs)
    if config.output_shapes is not None:
        config.output_shapes = {
            str(k): tuple(v) for k, v in config.output_shapes.items()
        }
    if config.input_shape is not None:
        config.input_shape = tuple(config.input_shape)
    return config


def _yamlify(obj):
    """Convert tuples/numpy scalars to plain YAML-safe python objects."""
    import numpy as np

    if isinstance(obj, dict):
        return {k: _yamlify(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_yamlify(v) for v in obj]
    if isinstance(obj, np.generic):
        return obj.item()
    return obj
