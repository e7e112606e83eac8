"""Demo of the port: restore a trained run, evaluate the test set with the
challenge metrics and extract attention-rollout maps (the port's
counterpart of the repository's ``demo.py``, the reference's demo.ipynb).

    python -m v1t_tpu_torch.demo --output_dir runs/v1t [--num_maps 8]

It runs on the CUDA device and raises if there is none; ``V1T_PLATFORM=cpu``
runs it on the CPU. The run keeps its ``attention_impl``: the rollout's
``return_probs`` already sends the attention through the einsum form that
exports the probabilities (the JAX demo selects "xla" for that; in the port
"xla" would select the plain path of every kernel). Writes
``<output_dir>/demo_attention_maps.pkl``.
"""

from __future__ import annotations

import argparse
import os
import pickle
import typing as t

from v1t_tpu_torch import training
from v1t_tpu_torch.analysis import extract_attention_maps
from v1t_tpu_torch.configs import load_args
from v1t_tpu_torch.data import get_training_ds
from v1t_tpu_torch.models import build_model
from v1t_tpu_torch.train import run_device
from v1t_tpu_torch.utils.scheduler import Scheduler


def main(args) -> t.Dict[str, object]:
    """Returns the test evaluation's averages and the maps written."""
    device = run_device()
    config = load_args(args.output_dir, overrides={"verbose": 1})
    _, val_ds, test_ds, card = get_training_ds(
        config, data_dir=config.dataset, mouse_ids=config.mouse_ids, batch_size=args.batch_size)
    model = build_model(config, card, seed=None, device=device)
    Scheduler(config, save_optimizer=False).restore(model, force=True)
    trainer = training.Trainer(config, model, card, device=device)

    print("\n=== Challenge metrics (test set) ===")
    result = training.evaluate(config, trainer, ds=test_ds, print_result=True)
    maps = None
    if config.core == "vit":
        print("\n=== Attention rollout ===")
        mouse_id = list(val_ds.keys())[0]
        maps = extract_attention_maps(val_ds[mouse_id], trainer.model,
                                      num_samples=args.num_maps)
        out = os.path.join(args.output_dir, "demo_attention_maps.pkl")
        with open(out, "wb") as f:
            pickle.dump(maps, f)
        print(f"Saved {args.num_maps} rollout maps to {out}.")
    return {"evaluation": result, "maps": maps}


def parse_args(argv: t.Optional[t.List[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(prog="python -m v1t_tpu_torch.demo")
    parser.add_argument("--output_dir", type=str, required=True)
    parser.add_argument("--batch_size", type=int, default=16)
    parser.add_argument("--num_maps", type=int, default=8)
    return parser.parse_args(argv)


if __name__ == "__main__":
    main(parse_args())
