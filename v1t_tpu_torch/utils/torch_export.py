"""Carry weights from the JAX package to the port.

``export_state_dict`` takes the JAX package's flax parameter tree (nested
dicts of numpy-convertible arrays) and returns the port's ``state_dict``:
the reference torch key layout that ``v1t_tpu/utils/torch_export.py``
emits, with torch tensors as values. This is the port's own copy of the
mappings the serving slice needs (vit core, gaussian2d readout, image and
core shifters); it imports nothing from the JAX package.
"""

from __future__ import annotations

import typing as t

import numpy as np
import torch


def _np(x) -> np.ndarray:
    return np.array(x, dtype=np.float32, copy=True)


def _linear(params: dict, prefix: str, out: dict) -> None:
    out[f"{prefix}.weight"] = _np(params["kernel"]).T
    if "bias" in params:
        out[f"{prefix}.bias"] = _np(params["bias"])


def _layernorm(params: dict, prefix: str, out: dict) -> None:
    out[f"{prefix}.weight"] = _np(params["scale"])
    out[f"{prefix}.bias"] = _np(params["bias"])


def _conv(params: dict, prefix: str, out: dict) -> None:
    # flax (kh, kw, in, out) -> torch (out, in, kh, kw)
    out[f"{prefix}.weight"] = _np(params["kernel"]).transpose(3, 2, 0, 1)
    if "bias" in params:
        out[f"{prefix}.bias"] = _np(params["bias"])


def _mlp3(params: dict, prefix: str, out: dict) -> None:
    _linear(params["fc0"], f"{prefix}.0", out)
    _linear(params["fc1"], f"{prefix}.2", out)
    _linear(params["fc2"], f"{prefix}.4", out)


def _export_vit_core(core: dict, cfg, out: dict) -> None:
    pe = core["patch_embedding"]
    p = "core.patch_embedding"
    out[f"{p}.cls_token"] = _np(pe["cls_token"])
    out[f"{p}.pos_embedding"] = _np(pe["pos_embedding"])
    if cfg.patch_mode == 0:
        _linear(pe["projection"], f"{p}.projection.2", out)
    elif cfg.patch_mode == 1:
        _conv(pe["projection"], f"{p}.projection.0", out)
    elif cfg.patch_mode == 2:
        _layernorm(pe["patch_norm"], f"{p}.projection.3", out)
        _linear(pe["projection"], f"{p}.projection.4", out)
    elif cfg.patch_mode == 3:
        _layernorm(pe["pre_norm"], f"{p}.projection.2", out)
        _linear(pe["projection"], f"{p}.projection.3", out)
        _layernorm(pe["post_norm"], f"{p}.projection.4", out)
    else:
        raise NotImplementedError(f"patch_mode {cfg.patch_mode}")

    tr = core["transformer"]
    for i in range(cfg.num_blocks):
        bp = f"core.transformer.blocks.{i}"
        mha = tr[f"block{i}_mha"]
        out[f"{bp}.mha.layer_norm.weight"] = _np(mha["ln_scale"])
        out[f"{bp}.mha.layer_norm.bias"] = _np(mha["ln_bias"])
        out[f"{bp}.mha.to_qkv.weight"] = _np(mha["to_qkv_kernel"]).T
        out[f"{bp}.mha.projection.0.weight"] = _np(mha["projection_kernel"]).T
        if "projection_bias" in mha:
            out[f"{bp}.mha.projection.0.bias"] = _np(mha["projection_bias"])
        if cfg.use_lsa:
            out[f"{bp}.mha.scale"] = _np(mha["scale"])

        mlp = tr[f"block{i}_mlp"]
        out[f"{bp}.mlp.model.0.weight"] = _np(mlp["ln_scale"])
        out[f"{bp}.mlp.model.0.bias"] = _np(mlp["ln_bias"])
        out[f"{bp}.mlp.model.1.weight"] = _np(mlp["fc1_kernel"]).T
        out[f"{bp}.mlp.model.4.weight"] = _np(mlp["fc2_kernel"]).T
        if "fc1_bias" in mlp:
            out[f"{bp}.mlp.model.1.bias"] = _np(mlp["fc1_bias"])
            out[f"{bp}.mlp.model.4.bias"] = _np(mlp["fc2_bias"])

        if cfg.behavior_mode in (2, 3, 4):
            bmlp = tr[f"block{i}_bmlp"]
            names = list(cfg.mouse_ids) if cfg.behavior_mode == 4 else ["share"]
            for name in names:
                mp = f"{bp}.b-mlp.models.{name}"
                _linear(bmlp[f"{name}_fc1"], f"{mp}.0", out)
                _linear(bmlp[f"{name}_fc2"], f"{mp}.3", out)


def _export_gaussian2d(ro: dict, mouse_id: str, out: dict) -> None:
    p = f"readouts.{mouse_id}"
    out[f"{p}.sigma"] = _np(ro["sigma"])
    out[f"{p}.features"] = _np(ro["features"])
    if "bias" in ro:
        out[f"{p}.bias"] = _np(ro["bias"])
    if "_mu" in ro:
        out[f"{p}._mu"] = _np(ro["_mu"])
    else:
        _linear(ro["mu_fc1"], f"{p}.mu_transform.0", out)
        _linear(ro["mu_fc2"], f"{p}.mu_transform.2", out)


def export_state_dict(params: dict, cfg) -> t.Dict[str, torch.Tensor]:
    """flax params -> the port's ``Model.state_dict()`` (float32 tensors).
    ``cfg`` needs ``core``, ``readout``, ``shift_mode``, ``mouse_ids``,
    ``patch_mode``, ``num_blocks``, ``use_lsa`` and ``behavior_mode``."""
    if cfg.core != "vit" or cfg.readout != "gaussian2d":
        raise NotImplementedError(
            f"core {cfg.core!r} / readout {cfg.readout!r} are not ported yet"
        )
    out: t.Dict[str, np.ndarray] = {}
    if cfg.shift_mode in (1, 3, 4):
        for m in cfg.mouse_ids:
            _mlp3(
                params["image_cropper"][f"image_shifter_{m}"],
                f"image_cropper.image_shifter.{m}.mlp", out,
            )
    _export_vit_core(params["core"], cfg, out)
    if cfg.shift_mode in (2, 3, 4):
        for m in cfg.mouse_ids:
            _mlp3(params["core_shifter"][f"shifter_{m}"], f"core_shifter.{m}.mlp", out)
    for m in cfg.mouse_ids:
        _export_gaussian2d(params["readouts"][f"readout_{m}"], m, out)
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in out.items()}
