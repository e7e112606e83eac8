"""Sensorium / Sensorium+ submission CSVs from a trained run, with the
port: the counterpart of the repository's ``submission.py`` (reference
submission.py).

    python -m v1t_tpu_torch.submission --output_dir runs/v1t [--dataset data/sensorium]

Restores the run (``args.yaml`` and ``ckpt/model_state.pt``), evaluates the
live test set (``<output_dir>/submissions/<stamp>/evaluation.yaml``), then
writes ``live_test.csv`` and ``final_test.csv`` for S0 (``sensorium/``)
and S1 (``sensorium+/``) with the columns trial_indices, image_ids,
prediction, neuron_ids. The predictions are standardised responses, as the
challenge's ground truth (reference submission.py:44-46). The CSVs are
written with the standard ``csv`` module in pandas' ``to_csv(index=False)``
form: a list is written as ``str(list)``, quoted.

It runs on the CUDA device and raises if there is none; ``V1T_PLATFORM=cpu``
runs it on the CPU.
"""

from __future__ import annotations

import argparse
import csv
import os
import typing as t
from datetime import datetime

import numpy as np

from v1t_tpu_torch import training
from v1t_tpu_torch.configs import load_args
from v1t_tpu_torch.data import get_submission_ds
from v1t_tpu_torch.data.loaders import BatchLoader, build_data_card
from v1t_tpu_torch.models import build_model
from v1t_tpu_torch.train import run_device
from v1t_tpu_torch.utils.scheduler import Scheduler

COLUMNS = ("trial_indices", "image_ids", "prediction", "neuron_ids")


def save_csv(filename: str, results: t.Dict[str, list]) -> None:
    os.makedirs(os.path.dirname(filename), exist_ok=True)
    with open(filename, "w", newline="") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow(COLUMNS)
        writer.writerows(zip(results["trial_ids"], results["image_ids"],
                             results["predictions"], results["neuron_ids"]))
    print(f"Saved submission file {filename}.")


def submission_inference(trainer: training.Trainer, loader: BatchLoader,
                         mouse_id: str) -> t.Dict[str, list]:
    """Per-trial predictions as python lists for the CSV (reference
    submission.py:33-77)."""
    results: t.Dict[str, list] = {"predictions": [], "image_ids": [], "trial_ids": []}
    for batch in loader:
        results["predictions"].extend(trainer.predict(mouse_id, batch).tolist())
        results["image_ids"].extend(np.asarray(batch["image_id"]).tolist())
        results["trial_ids"].extend(np.asarray(batch["trial_id"]).tolist())
    neuron_ids = np.asarray(loader.dataset.neuron_ids).tolist()
    results["neuron_ids"] = [neuron_ids] * len(results["predictions"])
    return results


def generate_submission(trainer: training.Trainer, mouse_id: str, test_ds: dict,
                        final_test_ds: dict, csv_dir: str) -> None:
    print(f"\nGenerate results for Mouse {mouse_id}")
    save_csv(os.path.join(csv_dir, "live_test.csv"),
             submission_inference(trainer, test_ds[mouse_id], mouse_id))
    save_csv(os.path.join(csv_dir, "final_test.csv"),
             submission_inference(trainer, final_test_ds[mouse_id], mouse_id))


def write_submissions(trainer: training.Trainer, test_ds: dict, final_test_ds: dict,
                      csv_dir: str) -> None:
    """The CSVs of S0 (``sensorium``) and S1 (``sensorium+``), for the mice
    the test loaders hold."""
    for mouse_id, challenge in (("S0", "sensorium"), ("S1", "sensorium+")):
        if mouse_id in test_ds:
            generate_submission(trainer, mouse_id, test_ds, final_test_ds,
                                os.path.join(csv_dir, challenge))


def main(args) -> str:
    """Returns the directory of this submission."""
    if not os.path.isdir(args.output_dir):
        raise FileNotFoundError(f"Cannot find {args.output_dir}.")
    device = run_device()
    overrides = {"batch_size": args.batch_size, "verbose": args.verbose}
    if args.dataset:
        overrides["dataset"] = args.dataset
    config = load_args(args.output_dir, overrides=overrides)
    if not config.ds_name:
        config.ds_name = os.path.basename(os.path.normpath(config.dataset))
    assert config.ds_name == "sensorium"
    for mouse_id in ("S0", "S1"):
        if mouse_id not in config.output_shapes:
            print(f"Warning: the saved model was not trained on Mouse {mouse_id}")

    test_ds, final_test_ds = get_submission_ds(config, data_dir=config.dataset,
                                               batch_size=config.batch_size)
    # the card's ds_sizes are the test loaders'; inference does not read them
    card = build_data_card(config, test_ds)
    model = build_model(config, card, seed=None, device=device)
    Scheduler(config, save_optimizer=False).restore(model, force=True)
    trainer = training.Trainer(config, model, card, device=device)

    csv_dir = os.path.join(config.output_dir, "submissions", f"{datetime.now():%Y-%m-%d-%Hh%Mm}")
    os.makedirs(csv_dir, exist_ok=True)
    training.evaluate(config, trainer, ds=test_ds, print_result=True, save_result=csv_dir)
    write_submissions(trainer, test_ds, final_test_ds, csv_dir)
    print(f"\nSubmission results saved to {csv_dir}.")
    return csv_dir


def parse_args(argv: t.Optional[t.List[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(prog="python -m v1t_tpu_torch.submission")
    parser.add_argument("--dataset", type=str, required=False, default=None)
    parser.add_argument("--output_dir", type=str, required=True)
    parser.add_argument("--batch_size", default=16, type=int)
    parser.add_argument("--verbose", type=int, default=2, choices=[0, 1, 2, 3])
    return parser.parse_args(argv)


if __name__ == "__main__":
    main(parse_args())
