"""Attention-rollout maps of every mouse's validation and test trials of a
trained run, pickled: the port's counterpart of
``misc/extract_attention_maps.py``.

    python -m v1t_tpu_torch.misc.extract_attention_maps --output_dir runs/v1t \
        [--batch_size 16] [--num_samples N] [--verbose 1]

Each tier's loader of every mouse goes through
``analysis.extract_attention_maps`` (the cropper, then the core with its
probabilities, the rollout on the host). Writes
``<output_dir>/attention_maps.pkl`` in the JAX script's layout, {tier:
{mouse: {"images", "heatmaps", "behaviors", "pupil_centers"}}}, which
``misc/figures/attention_map_visualization.py`` reads as it is. It runs on
the CUDA device and raises if there is none; ``V1T_PLATFORM=cpu`` runs it
on the CPU. The run keeps its ``attention_impl``, as ``demo.py`` does:
``return_probs`` already takes the einsum form that exports the
probabilities.
"""

from __future__ import annotations

import argparse
import os
import pickle
import typing as t

from v1t_tpu_torch.analysis import extract_attention_maps
from v1t_tpu_torch.misc.common import restore_run


def main(args) -> t.Dict[str, dict]:
    """Returns the maps written: {tier: {mouse: {...}}}."""
    _, model, loaders, _ = restore_run(args.output_dir, args.batch_size)
    results: t.Dict[str, dict] = {}
    for tier in ("validation", "test"):
        results[tier] = {}
        for mouse_id, loader in loaders[tier].items():
            if args.verbose:
                print(f"Extract attention maps: {tier} mouse {mouse_id}")
            results[tier][mouse_id] = extract_attention_maps(loader, model,
                                                             num_samples=args.num_samples)
    filename = os.path.join(args.output_dir, "attention_maps.pkl")
    with open(filename, "wb") as f:
        pickle.dump(results, f)
    print(f"Saved attention maps to {filename}.")
    return results


def parse_args(argv: t.Optional[t.List[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(prog="python -m v1t_tpu_torch.misc.extract_attention_maps")
    parser.add_argument("--output_dir", type=str, required=True)
    parser.add_argument("--batch_size", type=int, default=16)
    parser.add_argument("--num_samples", type=int, default=None)
    parser.add_argument("--verbose", type=int, default=1)
    return parser.parse_args(argv)


if __name__ == "__main__":
    main(parse_args())
