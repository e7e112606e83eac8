"""Import a reference (PyTorch) V1T run into a run directory of the port:
the counterpart of the repository's ``import_checkpoint.py``.

    python -m v1t_tpu_torch.import_checkpoint --torch_dir <reference run dir> \\
        --output_dir <new run dir> [--precision fp32]

A reference run (``args.yaml`` + ``ckpt/model_state.pt`` as the reference
trainer writes them, reference src/v1t/utils/scheduler.py:84-102, including
the published bryanlimy/V1T checkpoints, or a JAX run exported by the
repository's ``export_checkpoint.py``) becomes

    <output_dir>/args.yaml                 the translated ``Config``
    <output_dir>/ckpt/model_state.pt       {epoch, value, model, scheduler}

The port's ``Model`` has the reference's ``state_dict`` layout, so the
weights are copied as they are; the work is the translation of the args
(``reference_args_to_config``), the mice recovered from the readout keys
where ``args.yaml`` lacks them, and a structure check: ``load_state_dict(
strict=True)`` into the port's model built from the translated config.
Afterwards ``python -m v1t_tpu_torch.{submission,ensemble,demo}
--output_dir <dir>`` restore it. Runs on the CPU: nothing here computes.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import re
import typing as t

import torch

from v1t_tpu_torch.configs import Config, save_args
from v1t_tpu_torch.data.cards import synthetic_data_card
from v1t_tpu_torch.utils import yamlfile
from v1t_tpu_torch.utils.scheduler import CKPT_NAME, save_checkpoint_file


def load_torch_checkpoint(filename: str) -> dict:
    """The reference's ``model_state.pt``: the restricted ``weights_only``
    loader first; a reference scheduler dict may hold objects its allowlist
    refuses, and then the full unpickler, the trust model of the
    reference's own ``torch.load`` (reference scheduler.py:122)."""
    try:
        return torch.load(filename, map_location="cpu", weights_only=True)
    except Exception:
        return torch.load(filename, map_location="cpu", weights_only=False)


def _infer_mouse_ids(state_dict: dict) -> t.List[str]:
    """The mice of the per-mouse readout keys (reference
    readout/readout.py:63-68 keys the ModuleDict by mouse id)."""
    ids = []
    for key in state_dict:
        m = re.match(r"readouts\.([^.]+)\.", key)
        if m and m.group(1) not in ids:
            ids.append(m.group(1))
    return ids


def reference_args_to_config(payload: dict, output_dir: str,
                             state_dict: t.Optional[dict] = None,
                             overrides: t.Optional[dict] = None) -> Config:
    """A reference ``args.yaml`` dict as a ``Config``: the known fields
    copied, the torch-only runtime fields dropped, mouse ids and
    ``output_shapes`` keys as strings (reference utils/utils.py:297-305)."""
    known = {f.name for f in dataclasses.fields(Config)}
    kwargs = {k: v for k, v in payload.items() if k in known}
    kwargs["device"] = ""
    kwargs.pop("trainable_params", None)
    if overrides:
        kwargs.update(overrides)
    kwargs["output_dir"] = output_dir
    config = Config(**kwargs)
    if config.mouse_ids:
        config.mouse_ids = [str(m) for m in config.mouse_ids]
    elif state_dict is not None:
        config.mouse_ids = _infer_mouse_ids(state_dict)
    if config.output_shapes:
        config.output_shapes = {str(k): tuple(v) for k, v in config.output_shapes.items()}
    if config.input_shape is not None:
        config.input_shape = tuple(config.input_shape)
    return config


def _num_neurons(config: Config, state_dict: dict) -> t.Dict[str, int]:
    if config.output_shapes:
        return {m: int(v[0]) for m, v in config.output_shapes.items()}
    # the Gaussian2d readout's features: (1, C, 1, N)
    return {m: int(state_dict[f"readouts.{m}.features"].shape[-1]) for m in config.mouse_ids}


def validate_structure(config: Config, state_dict: dict) -> bool:
    """Load the weights with ``strict=True`` into the port's model of the
    same ``Config`` (on the CPU, no weights drawn); False where the config
    has no ``input_shape`` to build it from."""
    if config.input_shape is None:
        return False
    from v1t_tpu_torch.models import build_model

    neurons = _num_neurons(config, state_dict)
    card = synthetic_data_card(
        mouse_ids=tuple(config.mouse_ids), num_neurons=[neurons[m] for m in config.mouse_ids],
        input_shape=tuple(config.input_shape), ds_name=config.ds_name or "sensorium")
    build_model(config, card, seed=None, device="cpu").load_state_dict(state_dict, strict=True)
    return True


def convert_run(torch_dir: str, output_dir: str, overrides: t.Optional[dict] = None,
                validate: bool = True) -> dict:
    """``torch_dir`` (a reference run) into ``output_dir`` (a port run);
    returns a summary."""
    args_file = os.path.join(torch_dir, "args.yaml")
    ckpt_file = os.path.join(torch_dir, "ckpt", "model_state.pt")
    if not os.path.isfile(ckpt_file):
        raise FileNotFoundError(f"no reference checkpoint at {ckpt_file}")
    payload = (yamlfile.load(args_file) or {}) if os.path.isfile(args_file) else {}
    ckpt = load_torch_checkpoint(ckpt_file)
    state_dict = ckpt["model"]
    config = reference_args_to_config(payload, output_dir, state_dict=state_dict,
                                      overrides=overrides)
    if not config.mouse_ids:
        raise ValueError("could not determine mouse_ids from args.yaml or checkpoint keys")
    validated = validate_structure(config, state_dict) if validate else False

    epoch, value = int(ckpt.get("epoch", 0)), float(ckpt.get("value", 0.0))
    # the reference scheduler's counters (reference scheduler.py:146-151),
    # so a resumed run keeps its plateau / early-stop position
    sched = ckpt.get("scheduler") or {}
    out = {"epoch": epoch, "value": value, "model": state_dict, "scheduler": {
        "num_reduce": int(sched.get("num_reduce", 0)), "lr_wait": int(sched.get("lr_wait", 0)),
        "best_value": float(sched.get("best_value", value)), "best_epoch": epoch}}
    os.makedirs(output_dir, exist_ok=True)
    save_args(config)
    ckpt_path = os.path.join(output_dir, "ckpt", CKPT_NAME)
    save_checkpoint_file(ckpt_path, out)
    return {
        "checkpoint": ckpt_path, "epoch": epoch, "value": value,
        "num_parameters": int(sum(v.numel() for v in state_dict.values())),
        "mouse_ids": list(config.mouse_ids), "core": config.core, "readout": config.readout,
        "structurally_validated": validated,
    }


def main(args) -> dict:
    overrides = {"precision": args.precision} if args.precision else {}
    summary = convert_run(args.torch_dir, args.output_dir, overrides=overrides,
                          validate=not args.no_validate)
    print("Imported reference checkpoint:")
    for k, v in summary.items():
        print(f"  {k}: {v}")
    if not summary["structurally_validated"] and not args.no_validate:
        print("  note: structural validation skipped (no input_shape in the source args.yaml)")
    print(f"\nRun e.g.: python -m v1t_tpu_torch.submission --output_dir {args.output_dir} "
          f"--dataset <data dir>")
    return summary


def parse_args(argv: t.Optional[t.List[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(prog="python -m v1t_tpu_torch.import_checkpoint",
                                     description="Import a reference torch V1T run directory")
    parser.add_argument("--torch_dir", type=str, required=True,
                        help="reference run directory holding args.yaml + ckpt/model_state.pt")
    parser.add_argument("--output_dir", type=str, required=True,
                        help="destination run directory of the port")
    parser.add_argument("--precision", type=str, default="",
                        help="override the compute precision of the imported run")
    parser.add_argument("--no_validate", action="store_true",
                        help="skip the structure check against the port's model")
    return parser.parse_args(argv)


if __name__ == "__main__":
    main(parse_args())
