"""Ensemble trained runs and write their submissions, with the port: the
counterpart of the repository's ``ensemble.py`` (reference
ensemble.py:241-543).

    python -m v1t_tpu_torch.ensemble --dataset data/sensorium --output_dir runs/ens \\
        --behavior_mode 3 --saved_models runs/v1t_a runs/v1t_b --ensemble_mode 2 --train

Modes (reference ensemble.py:31-83): 0 average the sub-models' outputs, 1 a
shared Linear over the model axis, 2 a Linear a mouse. With ``--train``
(modes 1 and 2) only the output head trains; its checkpoints hold only
``output_module`` (the scheduler's ``module_names``, reference
ensemble.py:333). Then the live test set is evaluated and, on Sensorium,
the S0 / S1 submission CSVs are written under
``<output_dir>/submissions/<stamp>/``.

It runs on the CUDA device and raises if there is none; ``V1T_PLATFORM=cpu``
runs it on the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import shutil
import sys
import time
import typing as t
from datetime import datetime

import numpy as np

from v1t_tpu_torch import submission as submission_lib
from v1t_tpu_torch import training
from v1t_tpu_torch.configs import Config, save_args
from v1t_tpu_torch.data import get_mouse_ids, get_submission_ds, get_training_ds
from v1t_tpu_torch.models.ensemble import build_ensemble, ensemble_regularizer
from v1t_tpu_torch.train import run_device
from v1t_tpu_torch.utils.logger import Logger
from v1t_tpu_torch.utils.scheduler import Scheduler
from v1t_tpu_torch.utils.tensorboard import Summary


def fit_ensemble(config: Config, trainer: training.Trainer, scheduler: Scheduler, train_ds,
                 val_ds, test_ds) -> dict:
    """The output head's training loop (reference ensemble.py:154-239);
    returns the test evaluation's averages."""
    summary = Summary(config)
    try:
        epoch = scheduler.restore(trainer.model, trainer.optimizer, load_optimizer=True)
        while (epoch := epoch + 1) < config.epochs + 1:
            if config.verbose:
                print(f"\nEpoch {epoch:03d}/{config.epochs:03d}")
            start = time.time()
            train_result = training.train_epoch(trainer, ds=train_ds, epoch=epoch,
                                                summary=summary)
            val_result = training.validate(trainer, ds=val_ds, epoch=epoch, summary=summary)
            elapse = time.time() - start
            summary.scalar("model/elapse", value=elapse, step=epoch, mode=0)
            if config.verbose:
                print(f'Train\t\tloss: {train_result["loss"]:.04f}\n'
                      f'Validation\tloss: {val_result["loss"]:.04f}\t'
                      f'correlation: {val_result["single_trial_correlation"]:.04f}\n'
                      f"Elapse: {elapse:.02f}s")
            early_stop = scheduler.step(val_result["single_trial_correlation"], epoch=epoch,
                                        model=trainer.model, optimizer=trainer.optimizer)
            if np.isnan(train_result["loss"]) or np.isnan(val_result["loss"]):
                sys.exit("\nNaN loss detected, terminate training.")
            if early_stop:
                break
        training.restore_best(scheduler, trainer)
        return training.evaluate(config, trainer, ds=test_ds, epoch=epoch, summary=summary,
                                 mode=2, print_result=True, save_result=config.output_dir)
    finally:
        summary.close()


def main(config: Config, saved_models: t.Dict[str, str]) -> str:
    """Returns the directory of the submission."""
    device = run_device()
    if config.clear_output_dir and os.path.isdir(config.output_dir):
        shutil.rmtree(config.output_dir)
    os.makedirs(config.output_dir, exist_ok=True)
    logger = Logger(config.output_dir)
    try:
        get_mouse_ids(config)
        config.micro_batch_size = config.batch_size
        train_ds, val_ds, test_ds, card = get_training_ds(
            config, data_dir=config.dataset, mouse_ids=config.mouse_ids,
            batch_size=config.batch_size)
        model = build_ensemble(config, saved_models, card, device=device)
        trainer = training.Trainer(config, model, card, device=device,
                                   regularizer_fn=ensemble_regularizer,
                                   trainable_modules=["output_module"],
                                   weight_decay=config.weight_decay)
        save_args(config)
        if config.ensemble_mode == 0 and config.train:
            print("Cannot train ensemble model with average outputs")
        if config.ensemble_mode:
            scheduler = Scheduler(config, mode="max", module_names=["output_module"])
            if config.train:
                fit_ensemble(config, trainer, scheduler, train_ds, val_ds, test_ds)
            else:
                training.restore_best(scheduler, trainer)
        else:
            val_result = training.validate(trainer, ds=val_ds, epoch=0)
            if config.verbose:
                print(f'Validation\t\tloss: {val_result["loss"]:.04f}\t\t'
                      f'correlation: {val_result["single_trial_correlation"]:.04f}\n')

        sub_test_ds, final_test_ds = get_submission_ds(config, data_dir=config.dataset,
                                                       batch_size=config.batch_size)
        csv_dir = os.path.join(config.output_dir, "submissions",
                               f"{datetime.now():%Y-%m-%d-%Hh%Mm}")
        os.makedirs(csv_dir, exist_ok=True)
        training.evaluate(config, trainer, ds=sub_test_ds, print_result=True,
                          save_result=csv_dir)
        if "sensorium" in config.dataset:
            submission_lib.write_submissions(trainer, sub_test_ds, final_test_ds, csv_dir)
        print(f"\nSubmission results saved to {csv_dir}.")
        return csv_dir
    finally:
        logger.close()


def parse_args(argv: t.Optional[t.List[str]] = None) -> t.Tuple[Config, t.Dict[str, str]]:
    """The ``Config`` and the named runs (``name=path`` or a path, named
    model0, model1, ...) of a command line."""
    parser = argparse.ArgumentParser(prog="python -m v1t_tpu_torch.ensemble")
    parser.add_argument("--dataset", type=str, default="data/sensorium")
    parser.add_argument("--output_dir", type=str, required=True)
    parser.add_argument("--mouse_ids", nargs="+", type=str, default=None)
    parser.add_argument("--behavior_mode", required=True, type=int, choices=[0, 1, 2, 3, 4])
    parser.add_argument("--saved_models", nargs="+", type=str, required=True,
                        help="run directories of the trained models to ensemble "
                             "(name=path or just path)")
    parser.add_argument("--ensemble_mode", type=int, default=0, choices=[0, 1, 2])
    parser.add_argument("--train", action="store_true", help="train the ensemble output head")
    parser.add_argument("--epochs", type=int, default=100)
    parser.add_argument("--batch_size", type=int, default=16)
    parser.add_argument("--lr", type=float, default=1e-3)
    parser.add_argument("--core_lr", type=float, default=None)
    parser.add_argument("--weight_decay", type=float, default=0.01)
    parser.add_argument("--adam_beta1", type=float, default=0.9)
    parser.add_argument("--adam_beta2", type=float, default=0.9999)
    parser.add_argument("--adam_eps", type=float, default=1e-8)
    parser.add_argument("--criterion", type=str, default="poisson")
    parser.add_argument("--ds_scale", type=int, default=1, choices=[0, 1])
    parser.add_argument("--seed", type=int, default=1234)
    parser.add_argument("--precision", type=str, default="bf16", choices=["bf16", "fp32"])
    parser.add_argument("--attention_impl", type=str, default="auto")
    parser.add_argument("--gray_scale", action="store_true")
    parser.add_argument("--resize_image", type=int, default=1, choices=[0, 1])
    parser.add_argument("--clear_output_dir", action="store_true")
    parser.add_argument("--verbose", type=int, default=1, choices=[0, 1, 2, 3])
    args = parser.parse_args(argv)
    saved = {}
    for i, item in enumerate(args.saved_models):
        name, path = item.split("=", 1) if "=" in item else (f"model{i}", item)
        saved[name] = path
    known = {f.name for f in dataclasses.fields(Config)}
    return Config(**{k: v for k, v in vars(args).items() if k in known and v is not None}), saved


if __name__ == "__main__":
    main(*parse_args())
