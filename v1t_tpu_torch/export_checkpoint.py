"""Export a run of the port into the reference (PyTorch) format: the
counterpart of the repository's ``export_checkpoint.py``.

    python -m v1t_tpu_torch.export_checkpoint --output_dir <run dir> --torch_out <dir>

A run written by ``python -m v1t_tpu_torch.train`` (``args.yaml`` +
``ckpt/model_state.pt``) becomes the reference's layout

    <torch_out>/args.yaml               the run's, copied
    <torch_out>/ckpt/model_state.pt     {epoch, value, model}

The port's ``state_dict`` already has the reference's keys, so "model" is
the checkpoint's, without the optimizer's and scheduler's state. The
repository's ``export_checkpoint.py`` writes the same payload from a JAX
run; ``python -m v1t_tpu_torch.import_checkpoint`` is the inverse.
"""

from __future__ import annotations

import argparse
import os
import shutil
import typing as t

import torch

from v1t_tpu_torch.configs import load_args
from v1t_tpu_torch.utils.scheduler import CKPT_NAME, load_checkpoint_file


def export_run(output_dir: str, torch_out: str) -> str:
    """Returns the written checkpoint's path."""
    config = load_args(output_dir)
    if not config.mouse_ids:
        raise ValueError(f"{output_dir}/args.yaml has no mouse_ids")
    ckpt = load_checkpoint_file(os.path.join(output_dir, "ckpt", CKPT_NAME))
    payload = {"epoch": int(ckpt.get("epoch", 0)), "value": float(ckpt.get("value", 0.0)),
               "model": ckpt["model"]}
    os.makedirs(os.path.join(torch_out, "ckpt"), exist_ok=True)
    out_path = os.path.join(torch_out, "ckpt", "model_state.pt")
    torch.save(payload, out_path)
    shutil.copy(os.path.join(output_dir, "args.yaml"), os.path.join(torch_out, "args.yaml"))
    print(f"exported {len(payload['model'])} tensors (epoch {payload['epoch']}, best value "
          f"{payload['value']:.4f}) -> {out_path}")
    return out_path


def main(argv: t.Optional[t.List[str]] = None) -> str:
    parser = argparse.ArgumentParser(prog="python -m v1t_tpu_torch.export_checkpoint",
                                     description=__doc__)
    parser.add_argument("--output_dir", type=str, required=True,
                        help="run directory written by python -m v1t_tpu_torch.train")
    parser.add_argument("--torch_out", type=str, required=True,
                        help="destination directory for the reference-format run")
    args = parser.parse_args(argv)
    return export_run(args.output_dir, args.torch_out)


if __name__ == "__main__":
    main()
