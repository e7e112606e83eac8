"""What the A/B scripts of this folder share: the CUDA-event timer, the
device time of one V1T training step, and the entry point that measures
each tree in a process of its own.

A script runs as a file (``python3 v1t_tpu_torch/tools/ab_*.py``), so it
imports this module by its name from the folder. This module imports the
port only inside ``step_device_ms``, after the script's ``measure`` has put
the tree it measures first on ``sys.path``, so that each process times its
own tree's package.
"""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# the flagship's shapes: batch, tokens, embedding, heads, MLP width, neurons
B, N, E, H, F_HID, NEURONS = 64, 1654, 155, 4, 488, 7000


def ms_of(fn, iters: int = 10) -> float:
    """Mean time of ``iters`` calls of ``fn`` after a warm-up call (CUDA
    events), in ms."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def step_device_ms(emb: int = E, mlp_dim: int = 0, precision: str = "bf16") -> float:
    """Device time of one training step of the flagship V1T at embedding
    ``emb`` (and MLP width ``mlp_dim``, 0: the configuration's default) in
    ``precision`` after a warm-up step: batch 64, two mice of 7000 neurons,
    dropout on, an AdamW update, under PyTorch's deterministic mode where it
    is on. The kernels' self time under torch.profiler, AdamW's annotation
    left out, as ``chip_smoke.py`` phase 6 sums it."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from v1t_tpu_torch.configs import Config
    from v1t_tpu_torch.data.cards import synthetic_data_card
    from v1t_tpu_torch.models import build_model
    from v1t_tpu_torch.training import Trainer

    config = Config(core="vit", readout="gaussian2d", behavior_mode=3, shift_mode=2,
                    precision=precision, resize_image=0, batch_size=B, emb_dim=emb,
                    deterministic=torch.are_deterministic_algorithms_enabled(),
                    **({"mlp_dim": mlp_dim} if mlp_dim else {}))
    card = synthetic_data_card(mouse_ids=("A", "B"), num_neurons=NEURONS,
                               input_shape=(1, 36, 64))
    trainer = Trainer(config, build_model(config, card, seed=0, device="cuda"), card,
                      device="cuda")
    rng = np.random.default_rng(2)
    batch = {"image": rng.normal(size=(B, 1, 36, 64)).astype(np.float32),
             "behavior": rng.normal(size=(B, 3)).astype(np.float32),
             "pupil_center": rng.normal(size=(B, 2)).astype(np.float32),
             "response": rng.poisson(2.0, size=(B, NEURONS)).astype(np.float32)}
    trainer.train_step("A", batch, None, update=True)  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        trainer.train_step("A", batch, None, update=True)
        torch.cuda.synchronize()

    def device_us(event):
        for name in ("self_device_time_total", "self_cuda_time_total"):
            if hasattr(event, name):
                return float(getattr(event, name))
        return 0.0

    total = sum(device_us(e) for e in prof.key_averages()
                if str(getattr(e, "device_type", "")).endswith("CUDA")
                and not e.key.startswith("Optimizer."))
    del trainer
    torch.cuda.empty_cache()
    return total / 1e3


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` prints them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()


def main(script: str, measure, doc: str, trees=None) -> int:
    """A script's entry point. ``script --measure TREE`` prints
    ``measure(TREE)`` as one JSON line. Otherwise the card's line, then one
    process a tree in the order ``trees`` gives (by default, with the parent
    tree as the one argument: parent, this tree, this tree, parent); 0 if
    every process exits 0."""
    if len(sys.argv) > 2 and sys.argv[1] == "--measure":
        print(json.dumps(measure(os.path.abspath(sys.argv[2]))), flush=True)
        return 0
    if trees is None:
        if len(sys.argv) != 2:
            print(doc, file=sys.stderr)
            return 2
        parent = os.path.abspath(sys.argv[1])
        trees = (parent, ROOT, ROOT, parent)
    print(card_line(), flush=True)
    rc = 0
    for tree in trees:
        rc |= subprocess.run([sys.executable, os.path.abspath(script), "--measure",
                              tree]).returncode
    return rc
