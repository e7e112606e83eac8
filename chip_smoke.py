#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``v1t_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each as they go:
1. the card's name and power limit;
2. the build of the CUDA kernels (one ``nvcc`` per source, in parallel,
   into ``v1t_tpu_torch/_build``), each kernel's registers and spills (none
   allowed in the bf16 flash kernels' wide instantiations, padded head
   widths 192-256, nor in the instances past the panels' widths: the flash
   column groups in both types, the LayerNorm past K 640, the wgmma dX of
   every projection past K 640), the flash
   kernels' shared memory a block, and the
   launch plans of the flash forward and backward (``fwd_plan``,
   ``bwd_plan``), of ``ln_linear`` (``linear_plan``), ``ln_linear_dx``
   (``dx_plan``) and ``ln_linear_wgrad`` (``wgrad_plan``) held against the
   library's, with each flagship use's plan (rows a block, tiles, ring
   depths, how often dY' is read, slices and clusters of the weight
   gradient), the row-1 attention core's launch (``attention_plan``) and
   the sampling forward's (``sample_fwd_plan``: channels a block, one
   shared-memory word a cell; chunks) and backward's (``sample_bwd_plan``:
   channels a block, bands) at the flagship, sweep-widest, full-resolution,
   fp32 and a map past a block's shared memory;
3. every kernel against its plain PyTorch version at the flagship shapes
   (batch 64, 1654 tokens, emb 155, 4 heads of 155, MLP 488, a 29x57 core
   map, 7000 neurons), the training variants and the backward kernels with
   the flagship's dropout on (the same keep masks), with its time, the
   plain version's time, one PyTorch library call's time where one computes
   the same function, and the least time the card could take (bytes at
   3.35 TB/s or operations at the peak rate of their type, whichever is
   larger), with each dX use's share of its bound; beside each projection
   and weight gradient, the library's time for its product alone
   (``F.linear`` on the materialised LayerNorm output, ``torch.matmul`` of
   the materialised row-major dY'^T and A), and the weight gradient run
   twice, bit for bit; the row-1 core serving and training beside SDPA
   and the parent's reading, and its row whose every key is masked (LSA at
   N 1); the sampling forward also at the sweep-widest map (C 256), its
   two launches bit for bit, beside the parent design's reading;
   3b. the backward kernels (``attention_bwd`` with and without dropout;
   the sampling backward, and the forward beside it, timed at the
   flagship's, the full-resolution and the float32 map), each fixed-order
   form called twice on the same inputs, bit for bit, and held against its
   plain version (``attention_bwd``'s dq in key order under PyTorch's
   deterministic mode, timed beside the default form; dscale's, the
   LayerNorm epilogue's column sums and the sampling's d(table) in fixed
   point and d(grid) by chunk, the only forms),
   and the bf16 one-pass backward that ``attention_bwd`` and ``flash_bwd``
   share, timed through both at the flagship shape with its kernels
   profiled; the unfolded attention sublayer (drop_path's training blocks,
   the rollout's): QKV without the behavior row and the out-projection
   without the residual (phase 3, serving and training), the QKV dX
   without the residual's cotangent, and ``fused_mha(fold_residual=False)``
   forward and backward through autograd against its plain version; and
   the folded sublayer without the behavior row (behavior mode 0, the
   pretraining core's blocks), forward and backward, against its plain
   version;
4. serving: the flagship model (random weights from a seed) serving 3
   batches of 64 through ``training.inference`` / ``Trainer.predict`` with
   the kernel launch counters set to 0 just before and read just after; the
   outputs, and the core map of one batch, are held against the same
   model's plain path on the card;
   3c. the flash-attention kernels of the composed path against their
   chunked plain versions: the full-resolution shape (batch 2 x 4 heads,
   34,114 tokens, head 155, bf16, dropout on, the keep masks bit-identical),
   the fp32 flagship shape (64 x 4 heads, 1654 tokens; serving against SDPA
   and the bound), a rectangular case
   with padded keys and an LSE cotangent, an LSA case, rows whose every
   key is masked (LSA at N 1) and key counts that fill no tile, the LSE
   form at full-resolution SP 2's blocks (17,057 queries against 34,114 and
   17,057 keys, an LSE cotangent; timed beside the bound and SDPA) and a
   block whose keys are all padding (bf16 and float32), and head
   widths 192, 224 and 256 (the wide tiles) timed at a shape of the sweep
   (batch 16 x 4 heads, 1654 tokens), the forward serving and training and
   the backward with and without dropout, beside the bound, SDPA and the
   parent design's readings; at full resolution, fp32, head widths 192-256
   and cct's DP 32 the backward's dq in key order (PyTorch's deterministic
   mode) twice, bit for bit, against the plain version, timed beside the
   default form; and the fused MLP's and the readout's kernels at the shapes
   the composed paths give them (68,228 rows; a 137x249 and a float32 map);
   3d. the forms past the panels' widths against their plain versions: the
   flash column groups, bf16 and float32, at padded head widths 288, 384,
   512, 768 and 1024 (batch 16 x 4 heads, 1654 tokens, dropout, timed
   beside the bound and SDPA in the same type; rectangular 300 x 460 with
   n_real_k 400 and an LSE cotangent; LSA; the keep masks bit-identical;
   the backward's dq in key order twice, bit for bit; the last two forms and
   the keep masks also at 2048, a cluster of 8 groups, and 2080, past it),
   rows whose every key is masked at 768, a block of padding keys
   (float32), and the emb-768
   path's shape (batch 64 x 4 heads of 768, timed, each type); ``ln_linear`` with a
   LayerNorm at K 672, 768 and 1024 (qkv head-major with bias_row; fc1 with
   bias, GELU, keep mask and the saved activation), the out-projection
   and fc2 with their residual at K 3072 and 1030, and ``ln_linear_bwd``'s
   dX on the wgmma kernel: with the LayerNorm backward (qkv's head-major dY
   with bias_row and the residual's cotangent; fc1's; at K 2304, past one
   cluster, the mma.sync kernel with its d(ln) rows in device memory) and
   in the plain form at K 3072 and 1030 (the out-projection with dY's keep mask, fc2 with
   GELU'(pre) and fc1's mask; the masks bit-identical), twice, bit for bit,
   timed beside the bound, the plain version and the library (phase 3b
   also checks the sampling at C 768);
5. training: ``Trainer.train_step`` on the flagship model (dropout on,
   readout noise on), two mice of 7000 neurons, batch 64, two cycles with
   cross-mouse accumulation and one AdamW update each, with the counters set
   to 0 just before and read just after; the per-step losses and the first
   step's gradient of every parameter are held against the same weights and
   seeds through the plain path on the card;
   5b. the full-resolution flagship (1x144x256 images, 34,114 tokens, a
   155x137x249 core map, batch 2, two mice): 2 serving batches and one cycle
   of 2 train steps on the composed path (flash kernels, fused MLP), the
   main path of this slice, held against the plain path;
   5c. the flagship at ``precision="fp32"`` (batch 64, two mice): 1 serving
   batch and 2 train steps on the composed path (flash kernels in float32,
   the readout kernel on a float32 map), held against the plain path;
   5d. the sweep's widest core (the flagship at emb 256: 4 heads of 256,
   batch 64, two mice): 1 serving batch and one cycle of 2 train steps,
   the attention on the bf16 flash kernels' wide tiles (per step the
   forward 4 times and the backward's prep, one pass and convert 4 times
   each), held against the plain path at phase 5's tolerances;
   5l (run after 5d). the V1T at ViT-Base's width: emb 768, MLP 3072, 4
   heads of 768 (batch 64, two mice): 1 serving batch and two cycles of 2
   train steps, the attention on the flash column groups and the LayerNorm
   projections past K 640 (per step the launches of 5d; every dX on the
   wgmma kernel), held against the plain path (``WIDE_TOL``), its serving
   batch and training step profiled;
   the training also from a second seed, and from each seed through the
   plain path in float32 as well, the witness of how far each bf16 path
   lies from float32;
   5m (run after 5l). the same V1T in float32 (``precision="fp32"``, batch
   64, two mice) in 5c's form: 1 serving batch and one cycle of 2 train
   steps on the float32 flash column groups (per step the forward and the
   backward 4 times each, the sampling 1 + 1), held against the plain path
   at ``F32_TOL``, its serving batch and training step profiled;
   5e. the training loop from disk: ``v1t_tpu_torch.train.main`` with the
   flagship's flags (batch 64, bf16, the bf16 image wire) on a synthetic
   Sensorium-layout dataset written by the port (the mice S1 and A of 7000
   neurons; 128 train, 64 validation, 4 x 5 test and 20 final-test trials;
   1x144x256 stimuli the
   cropper resizes to 36x64): 3 epochs, then a resume to 4 from the
   checkpoint (its scheduler state loaded), ``evaluation.yaml``, and
   ``restore_best``'s predictions on a validation batch equal to the best
   epoch's bit for bit; each epoch's launches equal phase 5's per step and
   phase 4's per validation batch (the evaluation's per test batch); every
   batch through the native host gather; one epoch of the plain path from
   the same weights and seeds against the kernel path's first
   (``LOOP_TOL``); train images/s by the host clock, the loader's host ms a
   batch and one epoch's device time under ``torch.profiler``;
   5f. the flagship's training at drop_path 0.1 (the sweep's largest
   draw): two cycles through the kernels and the plain path, a second
   kernel run (the spread of two runs: dq is summed with float atomics),
   and a run with gradient checkpointing (the forward kernels of rows 1
   and 3 launch twice a step); losses and first-step gradients against the
   plain path, checkpointing against its absence (the steps before the
   first update bit for bit), the share of samples dropped, the peak of
   allocated device memory with and without checkpointing;
   5g. patch modes 1-3 at the flagship: one serving batch and one cycle of
   two train steps each, against the plain path;
   5h. the entry points after training on phase 5e's run (the mice S1 and
   A): ``submission.main`` (S1's CSVs: rows and ids as the loaders',
   predictions against the plain path), ``ensemble.main`` of it and phase
   5e's plain run in mode 0 and in mode 2 with the head trained one epoch
   (no backward kernel launches), ``demo.main`` (rollout heatmaps against
   the plain path), ``misc.extract_attention_maps`` (every mouse's
   validation and test trials, ``NUM_EXTRACT`` each, against the plain
   path, the pickle's layout), the figure scripts' compute parts
   (``misc.figures``: ``main_figure``'s test batch against the plain path,
   ``readout_positions`` equal to it, ``franke2022`` on a synthetic
   franke2022 dataset), and ``export_checkpoint`` then ``import_checkpoint``
   (the imported run's predictions bit for bit);
   5j. data and sequence parallelism: two ranks started as subprocesses of
   this script (``--parallel-rank``), on the card over gloo (two cards over
   NCCL where the host has them), each under ``PAR_RANK_LIMIT``, a failed
   rank failing the phase; held against one rank on the same weights and
   batches: (a) the flagship at batch 64 (32 rows a rank), dropout and the
   readout's grid noise off, two cycles of ``Trainer.train_step`` at phase
   5's tolerances and launch counts, then a dropout step (finite; the keep
   rate of the rank's mask, drawn by the flash kernel, right; the ranks'
   masks distinct); (b) ``train.main`` in each rank on phase 5e's dataset
   for 2 epochs under ``--deterministic``, so that neither side carries the
   run-to-run spread of the backward's float atomics (rank 0 alone writes;
   the epochs against a one-rank run at ``LOOP_TOL``; two one-rank runs in
   the default mode printed beside it for scale); (c) full resolution
   (34,114 tokens, batch 2) at SP 2, all-gather and ring: one serving batch
   and one train step each at ``FULLRES_TOL``, the flash kernels' launches
   read per rank; one ring step profiled on rank 0; ``--deterministic``
   across ranks: (b)'s loop run a second time, and (c)'s SP step twice a
   form under the flag, each rank's runs bit for bit;
   5i. the other cores and readouts, each through ``training.inference``
   and ``Trainer.train_step`` against the plain path: cct at full width
   (emb 160, 4 heads of 10 padded to 32, 4 blocks, MLP 488, 576 tokens; one
   serving batch and one cycle of two train steps: the fused MLP kernels,
   the flash kernels at DP 32, the sampling on a 160x24x24 map; phase 3c
   holds the flash kernels at its shape, timed beside the bound and SDPA,
   whose backend is recorded), the Sensorium baseline stacked2d (4 layers
   of 64 channels, depth-separable, BatchNorm, behavior mode 1; its running
   statistics bit for bit the plain path's), stn (7 layers, 63 filters),
   mixer (emb 155, MLP 488, 1653 patches), the linear and random cores with
   the dense, linear and random readouts (one serving batch, one cycle
   each); then ``--deterministic`` (``train.set_deterministic``): two
   equal-seed cycles of each of stacked2d + dense in float32, the flagship
   (bf16, dropout on, batch 64), the fp32 flagship, cct, the sweep's emb 256,
   emb 768 (MLP 3072, 2 blocks: the column groups' dq in key order), the
   same in float32 and full resolution (batch 2), bit for bit in losses and every
   parameter and buffer, with the launches a step of phase 5's count and
   every fixed-order kernel launched; one flagship step's device time under
   the mode beside the default's, under torch.profiler;
   5k. pretraining and the tools: (a) classification and (b)
   reconstruction pretraining of the flagship core (behavior mode 0, bf16,
   dropout on, batch 64, 1000 classes) on 384 synthetic images (uint8
   from a numpy seed through ``transform_image``, 1x36x64): two steps
   through the kernels and the plain path from the same weights and seeds
   (losses within ``LOSS_TOL``, first-step gradients within ``GRAD_TOL``,
   the launches a step), train images/s over 4 steps and one step's device
   time under ``torch.profiler``, then ``pretrain.run`` for 2 epochs to its
   checkpoint (the launches of every step and validation batch); (c)
   ``train.main --pretrain_core`` (a)'s run on phase 5e's dataset for 2
   epochs (the core frozen: rows 2 and 4 launch nothing; the core after
   training equal to the injected one bit for bit), and one cycle of
   ``Trainer.train_step`` at shift mode 2 and at shift mode 1 (the image
   shifter upstream of the core) against the plain path; then, on phase
   5e's run, ``sweep --local`` (2 trials of 1 epoch drawn from
   ``configs/sweep_v1t.yaml``, each of rows 1-6 launched),
   ``estimate_aRFs`` on 4096 noise images
   against the plain path, ``core_pca``, ``prediction_v_dilation``,
   ``behaviorMLP_visualization`` and a 2-step ``profiler.trace``;
6. where the time goes: one serving batch and one training step under
   ``torch.profiler`` (and one step of each composed path, phase 5d's,
   5l's and 5m's serving batch, phase 5f's step with checkpointing, a cct
   and a stacked2d step and a cct serving batch);
7. the wall time of each phase on the host's clock (from one "phase" line
   to the next, summed by phase), a ``kernels`` JSON line, then the result
   line ``{"ok": true, "device": {...}}``.

It exits non-zero, without the result line, if there is no CUDA device, if
the port is not beside it, or if any phase fails. It imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import pickle
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# max|kernel - plain| / max|plain| on bf16 outputs: one bf16 rounding is
# 2^-8 = 3.9e-3 relative, and kernel and plain version sum in other orders
# and round some intermediates (probabilities, the normalised rows) apart
KERNEL_TOL = 2e-2
# the same measure on the main path's responses (readout features and
# behavior MLPs drawn from a second seed) and on its core map, after 4
# blocks: ~3x the largest readings on an H100 (responses 1.9e-3; core map
# 7.8e-3, one or two bf16 steps at the map's largest values, and 1.0e-2
# with the reference's init)
MODEL_TOL = 6e-3
CORE_TOL = 2.5e-2
# training, kernel path against the plain path on the card, same weights and
# seeds: |loss - ref| / |ref| per step, and max|d| / max|ref| of every
# parameter's gradient of the first step; ~3x the largest readings on an
# H100 (losses 1.4e-5, after two updates; gradients 6.8e-3, the core
# shifter's and the QKV weight's: bf16 rounding flips through 4 blocks)
LOSS_TOL = 5e-5
GRAD_TOL = 2e-2
# the float32 kernels against their plain versions (and the LSE in both
# types): summation order only; ~10x the largest reading on an H100 (1.8e-6,
# the fp32 flash backward's dk)
F32_KERNEL_TOL = 2e-5
# the composed paths against their plain paths on the card (phases 5b, 5c):
# responses, core map, per-step losses and first-step gradients. Full
# resolution keeps the flagship's bf16 bounds (readings 1.3e-3, 1.2e-2,
# 6.7e-6, 7.4e-3: bf16 rounding flips through 4 blocks, as at 1654 tokens);
# fp32 ~5x the largest readings (1.7e-7, 1.8e-7, 0 and 6.9e-7: float32
# summation order only)
FULLRES_TOL = dict(model=MODEL_TOL, core=CORE_TOL, loss=LOSS_TOL, grad=GRAD_TOL)
F32_TOL = dict(model=1e-6, core=1e-6, loss=1e-6, grad=5e-6)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet
PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12}  # dense tensor-core bf16; fp32 outside the tensor cores
# dense tensor-core TF32: the float32 column groups' second bound, their
# products taken three times (3xTF32)
TF32_FLOPS = 495e12

B, N, E, H, F_HID, NEURONS = 64, 1654, 155, 4, 488, 7000
MAP_H, MAP_W = 29, 57
OW = -(-H * E // 8) * 8  # attention's output rows: H*E rounded up to 16 bytes (624)
# readings of each kernel's previous design (this script on an NVIDIA H100
# 80GB HBM3 at 700 W, PERF.md's kernel table), printed beside this run's for
# orientation only
PARENT_MS = {"attention serving": 2.303, "attention training": 3.358,
             "bilinear_sample_cm_bwd": 0.886, "bilinear_sample_cm": 0.288}
# the parent design's readings of the bf16 flash kernels at the sweep shape
# (B 16 x H 4, N 1654: the two mma.sync backward passes and the forward on
# 32-key tiles, this script on an NVIDIA H100 80GB HBM3 at 700 W, PERF.md
# row 8w): the backward with and without dropout, the forward serving
PARENT_WIDE_MS = {192: dict(bwd=5.051, bwd_no_dropout=3.430, serving=0.350),
                  256: dict(bwd=5.689, bwd_no_dropout=4.051, serving=0.717)}
# the parent design's readings of the float32 column groups (FFMA, every
# group recomputing S and dP; PERF.md rows 7f / 8f, this script on an NVIDIA
# H100 80GB HBM3 at 700 W): (B*H, head width) -> the training and serving
# forward, the backward with dropout (at the emb-768 shape also without it
# and in key order)
PARENT_F32_WIDE_MS = {
    (64, 288): dict(training=17.140, serving=17.169, bwd=49.492),
    (64, 384): dict(training=20.232, serving=20.265, bwd=57.921),
    (64, 512): dict(training=25.086, serving=25.333, bwd=73.490),
    (64, 768): dict(training=46.395, serving=47.229, bwd=137.868),
    (64, 1024): dict(training=75.405, serving=77.145, bwd=220.949),
    (256, 768): dict(training=185.359, serving=188.723, bwd=549.420, bwd_no_dropout=546.989,
                     bwd_fixed_order=575.166)}
# phase 5e, the training loop from disk: the kernel path's first epoch
# against the plain path's, same weights, seeds, masks and batches:
# |d|/|ref| of the epoch's mean train and validation losses, |d| of the
# validation correlation; ~3.5x the largest readings of two runs on an
# H100 (train loss 2.3e-7, 6.9e-7; validation loss 3.5e-6, 4.2e-6;
# correlation 2.7e-5, 3.5e-5: bf16 rounding flips through 4 blocks and two
# updates, and the backward's float atomics move them between runs)
LOOP_TOL = dict(loss=1.5e-5, corr=1.2e-4)
# its synthetic Sensorium-layout dataset: trials a mouse by tier, and the
# native stimulus size the cropper resizes to 36x64 (1654 tokens)
LOOP_TRIALS = dict(num_train=128, num_validation=64, num_test_images=4, num_test_repeats=5,
                   num_final_test=20)
# S1 (Sensorium+) for the submission of phase 5h; S0 has no behavior data,
# which behavior mode 3 needs (reference data.py:48-68)
LOOP_MICE = ("S1", "A")
LOOP_IMAGE = (1, 144, 256)
T_DROP = 0.2544  # the flagship's transformer dropout (configs.py t_dropout)
# phase 5h: the demo's rollout heatmaps (min-max normalised to [0, 1])
# against the plain path's: bf16 roundings of the probabilities and the
# fused MLP through 4 blocks; ~3x the reading on an H100 (1.1e-3)
HEATMAP_TOL = 3.5e-3
# phase 5h: the attention-map extractor's samples of each tier and mouse
NUM_EXTRACT = 4
# phase 5f: the sweep's largest drop_path draw (configs/sweep_v1t.yaml:41-42);
# with gradient checkpointing the forward kernels launch again in the
# backward. Kernel path against the plain path: LOSS_TOL and GRAD_TOL but
# for the losses after an update, ~3x the largest readings on an H100
# (4.0e-5, step 2: two bf16 paths' updates part further when a branch is
# dropped). Checkpointing against none: losses and first-step gradients
# within CKPT_SPREAD x the spread of two runs without it, or the floors,
# ~3x the largest readings (losses 6.3e-6 after the update; gradients
# 4.6e-3, one bf16 step of a dW element flipped by dq's float atomics, the
# only source of difference)
DROP_PATH = 0.1
DROP_PATH_TOL = dict(loss=1.2e-4, grad=GRAD_TOL)
CKPT_SPREAD, CKPT_LOSS_FLOOR, CKPT_GRAD_FLOOR = 3.0, 2e-5, 1.5e-2
DEVICE = "cuda"
MICE, CYCLES = ("A", "B"), 2
# the full-resolution run (misc/train_fullres_sp.py): 1x144x256 stimuli, no
# resize, patch 8 stride 1 -> 137 x 249 patches + CLS
FR_B, FR_IMAGE, FR_N = 2, (1, 144, 256), 137 * 249 + 1
FR_MAP_H, FR_MAP_W = 137, 249
# kernel launches per train step (one micro-batch of 64, one mouse), written
# down before the first run: 4 blocks x (QKV, out-proj, fc1, fc2) forward
# projections, 4 attention cores, one readout sampling; backward per block
# 2 + 2 dX / dW for the attention sublayer and 2 + 2 for the MLP, and one
# attention_bwd (its prep, the bf16 one pass it shares with flash_bwd, its
# convert: the flash wrapper launches nothing on this path)
TRAIN_LAUNCHES_PER_STEP = {
    "ln_linear": 16, "attention": 4, "bilinear_sample_cm": 1, "ln_linear_bwd": 16,
    "ln_linear_wgrad": 16, "attention_bwd": 4, "bilinear_sample_cm_bwd": 1,
    "flash_attention": 0, "flash_attention_bwd": 0,
}
# the composed paths, written down before their first run: per block one
# flash forward and backward; full resolution keeps the fused MLP (fc1, fc2
# forward, their dX and dW backward); fp32 runs no fused sublayer
CKPT_LAUNCHES_PER_STEP = dict(TRAIN_LAUNCHES_PER_STEP, ln_linear=32, attention=8)
FULLRES_LAUNCHES_PER_STEP = {
    "ln_linear": 8, "attention": 0, "bilinear_sample_cm": 1, "ln_linear_bwd": 8,
    "ln_linear_wgrad": 8, "attention_bwd": 0, "bilinear_sample_cm_bwd": 1,
    "flash_attention": 4, "flash_attention_bwd": 4,
}
F32_LAUNCHES_PER_STEP = {
    "ln_linear": 0, "attention": 0, "bilinear_sample_cm": 1, "ln_linear_bwd": 0,
    "ln_linear_wgrad": 0, "attention_bwd": 0, "bilinear_sample_cm_bwd": 1,
    "flash_attention": 4, "flash_attention_bwd": 4,
}
# the sweep's widest core (emb 256: heads padded to 256, past the fused
# core's 160), written down before its first run: the fused projections,
# MLP and readout as in the flagship, the attention core on the flash
# kernels (flash_attention_bwd: its prep, one pass and dq convert)
SWEEP_EMB = 256
SWEEP_LAUNCHES_PER_STEP = {
    "ln_linear": 16, "attention": 0, "bilinear_sample_cm": 1, "ln_linear_bwd": 16,
    "ln_linear_wgrad": 16, "attention_bwd": 0, "bilinear_sample_cm_bwd": 1,
    "flash_attention": 4, "flash_attention_bwd": 4,
}
# phase 5l, the V1T core at ViT-Base's width (Dosovitskiy et al. 2021,
# Table 1: emb 768, MLP 3072) with V1T's 4 heads as wide as the embedding:
# padded head width 768, past the bf16 flash kernels' panels (the column
# groups) and a LayerNorm of K 768, past the projections' panels (its rows
# normalised first forward; every dX on the wgmma kernel backward).
# Launches written down before the first run: the sweep-widest path's.
# Held at phase 5's bounds against the plain path, trained from two seeds,
# each also through the plain path in float32 (the witness): a loss or
# gradient past its bound passes only where the kernel path lies no further
# from the witness than WITNESS_RATIO times the bf16 plain path does
# (``hold``). Readings on an H100, seeds 0 and 1: the first-step
# gradients' ratios median 1.000, largest 1.176 (of 154); seed 0's readout
# and shifter gradients past GRAD_TOL (five, up to 4.7e-2 from the plain
# path's at their own scale) 0.980-0.990, each bf16 path 0.58-0.95 of the gradient's
# largest element from float32 (at emb 768 these sums over every neuron's
# d(grid) are mostly bf16 rounding, in both paths alike); the losses summed
# over the 4 steps 1.015 and 1.062. 1.5 is ~1.3x the largest ratio read; a
# fault of the kernel path as large as bf16's own error would read ~2
WIDE_EMB, WIDE_MLP = 768, 3072
WIDE_LAUNCHES_PER_STEP = dict(SWEEP_LAUNCHES_PER_STEP)
WITNESS_RATIO = 1.5
WIDE_TOL = dict(model=MODEL_TOL, core=CORE_TOL, loss=LOSS_TOL, grad=GRAD_TOL,
                witness=WITNESS_RATIO)
# phase 5m, the same V1T in float32 (padded head width 768: the float32
# flash column groups), in 5c's form: one serving batch and one cycle of two
# train steps against the plain path at F32_TOL. Launches written down
# before the first run: 5c's (per block one flash forward and backward, the
# readout's sampling forward and backward; no fused sublayer in float32)
F32_WIDE_LAUNCHES_PER_STEP = dict(F32_LAUNCHES_PER_STEP)
# the flash kernels' widths checked past DP 256 (phase 3d), bf16 and float32
WIDE_DPS = (288, 384, 512, 768, 1024)
# the LayerNorm widths checked past K 640 (phase 3d)
WIDE_KS = (672, 768, 1024)
# a LayerNorm dX past one cluster's 8 x 256 columns (phase 3d): the
# mma.sync form with its d(ln) rows in device memory, no configuration's
DLN_GLOBAL_K = 2304
WIDE_DX_PER_STEP = 16  # the emb-768 step's dX calls: 4 blocks x (qkv, fc1, out-projection, fc2)

# phase 5i, the other cores and readouts. cct at full width: emb 160, 4
# heads of 160 // 4 // 4 = 10 (padded to 32), 4 blocks, MLP 488, patch 8
# stride 1, sine positions: 576 tokens (a 24x24 map). Launches written
# down before the first run: per block the fused MLP (fc1, fc2) forward
# and its backward (2 dX, 2 dW), one flash forward and backward (the QKV
# and output products are PyTorch's); one readout sampling and its backward
CCT = dict(core="cct", emb_dim=160, num_heads=4, mlp_dim=488, patch_size=8, patch_stride=1,
           pos_emb="sine")
CCT_N, CCT_D = 576, 10
CCT_LAUNCHES_PER_STEP = {
    "ln_linear": 8, "attention": 0, "bilinear_sample_cm": 1, "ln_linear_bwd": 8,
    "ln_linear_wgrad": 8, "attention_bwd": 0, "bilinear_sample_cm_bwd": 1,
    "flash_attention": 4, "flash_attention_bwd": 4,
}
# the convolutional cores and the baselines launch no kernel of their own:
# the Gaussian readout's sampling forward and backward, or nothing
SAMPLING_PER_STEP = dict(dict.fromkeys(CCT_LAUNCHES_PER_STEP, 0), bilinear_sample_cm=1,
                         bilinear_sample_cm_bwd=1)
NO_LAUNCHES = dict.fromkeys(CCT_LAUNCHES_PER_STEP, 0)
# the Sensorium 2022 baseline (stacked2d defaults: 4 layers of 64 channels,
# kernels 9 / 7, depth-separable, BatchNorm, behavior mode 1), stn at the JAX
# class defaults (7 layers, 63 filters, dropout 0.1135), mixer at the
# flagship's emb 155, MLP 488 and 1653 patches; the dense and linear
# readouts behind the linear and random cores' 1x36x64 maps
BASELINES = {
    "stacked2d + gaussian2d": dict(core="stacked2d", behavior_mode=1, num_layers=4,
                                   dropout=0.0),
    "stn + gaussian2d": dict(core="stn", behavior_mode=3, num_layers=7, num_filters=63,
                             dropout=0.1135),
    "mixer + gaussian2d": dict(core="mixer", behavior_mode=3, emb_dim=155, mlp_dim=488,
                               num_blocks=4, dropout=0.0),
    "linear + dense": dict(core="linear", readout="dense", behavior_mode=3),
    "random + linear": dict(core="random", readout="linear", behavior_mode=3),
    "linear + random": dict(core="linear", readout="random", behavior_mode=3),
}
# --deterministic (phase 5i): two equal-seed runs of one cycle a path, each
# (config overrides, image shape, launches a step, neurons a mouse):
# stacked2d + dense in float32 (no kernel), then the paths whose backward
# kernels take their fixed-order sums, at the launches a step their phase
# counts (full resolution at its batch of 2)
DETERMINISTIC_NEURONS = 1000
DETERMINISTIC_PATHS = {
    "stacked2d + dense": (dict(core="stacked2d", readout="dense", behavior_mode=1,
                               precision="fp32"), (1, 36, 64), NO_LAUNCHES,
                          DETERMINISTIC_NEURONS),
    "flagship": (dict(), (1, 36, 64), TRAIN_LAUNCHES_PER_STEP, NEURONS),
    "fp32 flagship": (dict(precision="fp32"), (1, 36, 64), F32_LAUNCHES_PER_STEP, NEURONS),
    "cct": (CCT, (1, 36, 64), CCT_LAUNCHES_PER_STEP, NEURONS),
    f"emb {SWEEP_EMB}": (dict(emb_dim=SWEEP_EMB), (1, 36, 64), SWEEP_LAUNCHES_PER_STEP, NEURONS),
    f"emb {WIDE_EMB}, 2 blocks": (dict(emb_dim=WIDE_EMB, mlp_dim=WIDE_MLP, num_blocks=2),
                                  (1, 36, 64), {k: v // 2 if k.startswith(("ln_", "flash"))
                                                else v for k, v in WIDE_LAUNCHES_PER_STEP.items()},
                                  NEURONS),
    f"fp32 emb {WIDE_EMB}, 2 blocks": (dict(precision="fp32", emb_dim=WIDE_EMB, mlp_dim=WIDE_MLP,
                                            num_blocks=2), (1, 36, 64),
                                       {k: v // 2 if k.startswith("flash") else v
                                        for k, v in F32_WIDE_LAUNCHES_PER_STEP.items()}, NEURONS),
    "full resolution": (dict(batch_size=FR_B), FR_IMAGE, FULLRES_LAUNCHES_PER_STEP, NEURONS),
}
# phase 5j, data and sequence parallelism: two ranks, on one card over gloo
# (NCCL refuses two ranks on one card) or on two cards over NCCL where the
# host has them; each group of ranks may take this long before it is killed
PAR_RANKS = 2
PAR_RANK_LIMIT = 420
# flash forward (= backward) launches a rank makes per full-resolution step
# under SP 2, written down before the first run: 4 blocks, one block pair
# each under the all-gather, two under the ring
SP_FLASH_PER_STEP = {"allgather": 4, "ring": 8}
# phase 5k, pretraining: synthetic images through transform_image, their
# classes, and the launches written down before the first run: a step of
# the behavior-free core runs the flagship's core kernels (no sampling); a
# validation batch the serving forward; under a frozen core a training
# step runs the core's forward kernels alone (no input of the core takes a
# gradient: the image shifter moves the cropper's nearest-neighbour grid,
# which passes none) and the readout's sampling forward and backward
PRETRAIN_IMAGES, PRETRAIN_CLASSES, PRETRAIN_RAW = 384, 1000, (72, 128, 3)
PRETRAIN_LAUNCHES_PER_STEP = dict(TRAIN_LAUNCHES_PER_STEP, bilinear_sample_cm=0,
                                  bilinear_sample_cm_bwd=0)
PRETRAIN_SERVE_PER_BATCH = dict(NO_LAUNCHES, ln_linear=16, attention=4)
FROZEN_LAUNCHES_PER_STEP = dict(NO_LAUNCHES, ln_linear=16, attention=4, bilinear_sample_cm=1,
                                bilinear_sample_cm_bwd=1)
# estimate_aRFs' white noise on the card
ARF_SAMPLES = 4096
SWEEP_CONFIG = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs",
                            "sweep_v1t.yaml")


# (phase, host clock) at each line that opens a phase: wall_times() sums
# the spans between them by phase
PHASE_MARKS = [("start-up", time.perf_counter())]


def log(*args) -> None:
    text = " ".join(map(str, args))
    if text.startswith("phase "):
        PHASE_MARKS.append((text.split(":", 1)[0], time.perf_counter()))
    print(*args, flush=True)


def wall_times() -> str:
    """Each phase's wall time, in seconds, summed over its spans, in the
    order the phases first opened, and the whole run's."""
    marks = PHASE_MARKS + [("end", time.perf_counter())]
    spans = {}
    for (phase, at), (_, end) in zip(marks, marks[1:]):
        spans[phase] = spans.get(phase, 0.0) + end - at
    return (", ".join(f"{phase} {sec:.1f}" for phase, sec in spans.items())
            + f"; whole run {marks[-1][1] - marks[0][1]:.1f}")


def card_line() -> str:
    if shutil.which("nvidia-smi"):
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
        if out.returncode == 0 and out.stdout.strip():
            return out.stdout.strip().splitlines()[0]
    props = torch.cuda.get_device_properties(0)
    return f"{props.name}, power limit not readable (nvidia-smi missing)"


def cuda_ms(fn, iters: int = 10) -> float:
    """Mean device time of ``fn`` over ``iters`` launches after a warm-up,
    from CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, flops: float, kind: str) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def head_bytes(qkv: torch.Tensor, head_dim: int) -> float:
    """Bytes of a head-major (3, B, H, N, DP) q/k/v at the head width the
    function needs, D, not the padded DP the layout stores."""
    return nbytes(qkv) * head_dim / qkv.shape[-1]


def sdpa_backend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """The first of SDPA's backends, in its dispatcher's order, that accepts
    (q, k, v): the one a plain call takes."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    order = getattr(torch._C, "_get_sdp_priority_order", lambda: None)()
    backends = ([SDPBackend(i) for i in order] if order else
                [SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH])
    for backend in backends:
        try:
            with sdpa_kernel([backend]):
                F.scaled_dot_product_attention(q, k, v, scale=1.0)
            return backend.name.lower()
        except RuntimeError:
            continue
    return "none"


def kernel_counters() -> dict:
    """The launch counter of every kernel wrapper, by kernel name."""
    from v1t_tpu_torch.ops.flash_attention import flash_bwd, flash_fwd
    from v1t_tpu_torch.ops.fused_mha import attention, attention_bwd
    from v1t_tpu_torch.ops.interp_matmul import bilinear_sample_cm, bilinear_sample_cm_bwd
    from v1t_tpu_torch.ops.ln_linear import ln_linear, ln_linear_bwd, ln_linear_wgrad

    return {"ln_linear": ln_linear, "attention": attention,
            "bilinear_sample_cm": bilinear_sample_cm, "ln_linear_bwd": ln_linear_bwd,
            "ln_linear_wgrad": ln_linear_wgrad, "attention_bwd": attention_bwd,
            "bilinear_sample_cm_bwd": bilinear_sample_cm_bwd, "flash_attention": flash_fwd,
            "flash_attention_bwd": flash_bwd}


def zero_counts() -> None:
    from v1t_tpu_torch.ops.ln_linear import ln_linear, ln_linear_bwd

    for fn in kernel_counters().values():
        fn.launches = 0
    ln_linear.form_launches = dict.fromkeys(ln_linear.form_launches, 0)
    ln_linear_bwd.form_launches = dict.fromkeys(ln_linear_bwd.form_launches, 0)


def read_counts() -> dict:
    return {name: fn.launches for name, fn in kernel_counters().items()}


def read_dx_forms() -> dict:
    """ln_linear_bwd's launches by kernel (its counter's split): the
    mma.sync kernel, the wgmma kernel with and without the LayerNorm; and
    ln_linear's (keys fwd_*): ln_linear_kernel up to K 640, the wgmma kernel
    past it with and without the LayerNorm."""
    from v1t_tpu_torch.ops.ln_linear import ln_linear, ln_linear_bwd

    return dict(ln_linear_bwd.form_launches, **ln_linear.form_launches)


def compare(name: str, got: torch.Tensor, ref: torch.Tensor, tol: float) -> tuple:
    torch.cuda.synchronize()
    if got.shape != ref.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != {tuple(ref.shape)}")
    got32, ref32 = got.float(), ref.float()
    if not torch.isfinite(got32).all():
        raise AssertionError(f"{name}: non-finite output")
    err = (got32 - ref32).abs().max().item()
    rel = err / max(ref32.abs().max().item(), 1e-30)
    status = "ok" if rel <= tol else "FAIL"
    log(f"  {name}: max|d| {err:.3e}, max|d|/max|ref| {rel:.3e} (tol {tol:g}) {status}")
    if rel > tol:
        raise AssertionError(f"{name}: {rel:.3e} > {tol:g}")
    return err, rel


@contextlib.contextmanager
def deterministic_mode(fill: bool = True):
    """PyTorch's deterministic mode (``train.set_deterministic``'s), which
    the flash one pass's fixed-order dq sums key off; ``fill=False`` keeps
    PyTorch from filling each new buffer first (its mode does), so that a
    kernel's fixed-order form is timed alone."""
    from torch.utils import deterministic

    saved = (torch.are_deterministic_algorithms_enabled(), deterministic.fill_uninitialized_memory)
    torch.use_deterministic_algorithms(True)
    deterministic.fill_uninitialized_memory = fill
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(saved[0])
        deterministic.fill_uninitialized_memory = saved[1]


def fixed_order_twice(label: str, fn, refs, tol: float, names) -> tuple:
    """``fn``'s fixed-order form (under PyTorch's deterministic mode) twice
    on the same inputs: every output equal bit for bit, then each held
    against its plain version ``refs`` at ``tol``; the worst (max|d|,
    max|d|/max|ref|)."""
    with deterministic_mode():
        first, second = fn(), fn()
    torch.cuda.synchronize()
    first, second = ((x,) if torch.is_tensor(x) else tuple(x) for x in (first, second))
    differ = [n for n, a, b in zip(names, first, second)
              if a is not None and not torch.equal(a, b)]
    if differ:
        raise AssertionError(f"{label}: the fixed-order form's two runs differ in {differ}")
    worst = max(compare(f"{label} fixed order {n}", a, r, tol)
                for n, a, r in zip(names, first, refs) if r is not None)
    log(f"  {label}: the fixed-order form's two runs bit for bit ({', '.join(names)})")
    return worst


def torch_ln_linear(kw: dict) -> torch.Tensor:
    """ln_linear's function as separate PyTorch calls in bf16 (LayerNorm,
    F.linear, GELU, residual): the yardstick no single library call gives."""
    import torch.nn.functional as F

    bf = torch.bfloat16
    z = kw["x"]
    if kw.get("pro_row") is not None:
        z = z + kw["pro_row"][:, None, :]
    if kw.get("gamma") is not None:
        z = F.layer_norm(z, (z.shape[-1],), kw["gamma"].to(bf), kw["beta"].to(bf), 1e-5)
    y = F.linear(z, kw["w"], None if kw.get("bias") is None else kw["bias"].to(bf))
    if kw.get("gelu"):
        y = F.gelu(y)
    if kw.get("residual") is not None:
        r = kw["residual"]
        if kw.get("res_row") is not None:
            r = r + kw["res_row"][:, None, :]
        y = y + r
    return y


def sample_forward(label: str, table: torch.Tensor, grid: torch.Tensor, hh: int,
                   ww: int) -> dict:
    """``bilinear_sample_cm`` at one map against its plain version and a
    second launch (bit for bit), timed beside its plain version,
    ``F.grid_sample`` on the same inputs and its byte bound."""
    import torch.nn.functional as F

    from v1t_tpu_torch.ops.interp_matmul import (
        bilinear_sample_cm, bilinear_sample_cm_plain, sample_fwd_plan,
    )

    b, c, _ = table.shape
    tol = KERNEL_TOL if table.dtype == torch.bfloat16 else F32_KERNEL_TOL
    got = bilinear_sample_cm(table, grid, hh, ww)
    err, rel = compare(f"bilinear_sample_cm[{label}]", got,
                       bilinear_sample_cm_plain(table, grid, hh, ww), tol)
    if not torch.equal(got, bilinear_sample_cm(table, grid, hh, ww)):
        raise AssertionError(f"bilinear_sample_cm[{label}]: two launches differ")
    table4 = table.reshape(b, c, hh, ww)
    grid4 = grid.reshape(b, 1, grid.shape[1], 2).to(table.dtype)
    lib_ms = cuda_ms(lambda: F.grid_sample(table4, grid4, mode="bilinear", padding_mode="zeros",
                                           align_corners=True))
    ms = cuda_ms(lambda: bilinear_sample_cm(table, grid, hh, ww))
    plain_ms = cuda_ms(lambda: bilinear_sample_cm_plain(table, grid, hh, ww), iters=3)
    b_ms, b_by = bound(nbytes(table, grid, got), 8.0 * got.numel(), "fp32")
    plan = sample_fwd_plan(c, hh, ww, table.dtype)
    parent = PARENT_MS["bilinear_sample_cm"] if label.startswith("flagship") else None
    log(f"  bilinear_sample_cm[{label}] (B {b}, C {c}, {hh}x{ww}, P {grid.shape[1]}, "
        f"{str(table.dtype)[6:]}; {plan.group} channels a block x {plan.chunks} chunks, table "
        f"{'staged' if plan.staged else 'in global memory'}, "
        f"{plan.smem} bytes of shared memory a block): kernel_ms {ms:.4f} plain_ms "
        f"{plain_ms:.4f} grid_sample_ms {lib_ms:.4f} bound_ms {b_ms:.4f} ({b_by}); kernel / "
        f"grid_sample {ms / lib_ms:.3f}, bound share {b_ms / ms:.3f}; two launches bit for bit"
        + (f"; the parent design's reading {parent} ms" if parent else ""))
    return dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
                max_abs_err=err, rel_err=rel, plan=plan._asdict())


def check_kernels(gen: torch.Generator) -> tuple:
    import torch.nn.functional as F

    from v1t_tpu_torch.ops.dropout import Dropout
    from v1t_tpu_torch.ops.fused_mha import attention, attention_plain
    from v1t_tpu_torch.ops.ln_linear import ln_linear, ln_linear_plain

    dev = DEVICE
    bf = torch.bfloat16

    def randn(*shape, scale=1.0, dtype=bf):
        return (torch.randn(*shape, generator=gen) * scale).to(dev, dtype)

    x = randn(B, N, E)
    row = randn(B, E, scale=0.5)
    gamma = 1.0 + randn(E, scale=0.1, dtype=torch.float32)
    beta = randn(E, scale=0.1, dtype=torch.float32)
    wqkv = randn(3 * H * E, E, scale=0.08)
    wp = randn(E, H * E, scale=0.04)
    bp = randn(E, scale=0.1, dtype=torch.float32)
    w1 = randn(F_HID, E, scale=0.08)
    b1 = randn(F_HID, scale=0.1, dtype=torch.float32)
    w2 = randn(E, F_HID, scale=0.05)
    b2 = randn(E, scale=0.1, dtype=torch.float32)
    scale = torch.full((H,), E ** -0.5, device=dev)

    qkv = ln_linear(x, wqkv, gamma=gamma, beta=beta, pro_row=row, heads=(H, E))
    o = attention(qkv, scale, E)
    wp_o = F.pad(wp, (0, OW - H * E))  # against o's aligned rows, as fused_mha pads it
    hid = ln_linear(x, w1, gamma=gamma, beta=beta, bias=b1, gelu=True)
    uses = {
        "qkv": dict(x=x, w=wqkv, gamma=gamma, beta=beta, pro_row=row, heads=(H, E)),
        "out_proj": dict(x=o, w=wp_o, bias=bp, residual=x, res_row=row),
        "fc1": dict(x=x, w=w1, gamma=gamma, beta=beta, bias=b1, gelu=True),
        "fc2": dict(x=hid, w=w2, bias=b2, residual=x),
    }

    rows = []
    log("phase 3: kernels against their plain versions at the flagship shapes")
    per_use, tot = {}, dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, torch_ms=0.0)
    worst = (0.0, 0.0)
    bound_kinds = set()
    for use, kw in uses.items():
        args = {k: v for k, v in kw.items() if k not in ("x", "w")}
        got = ln_linear(kw["x"], kw["w"], **args)
        ref = ln_linear_plain(kw["x"], kw["w"], **args)
        err, rel = compare(f"ln_linear[{use}]", got, ref, KERNEL_TOL)
        worst = max(worst, (err, rel))
        m, k = kw["x"].shape[0] * kw["x"].shape[1], kw["x"].shape[2]
        n_out = kw["w"].shape[0]
        out_bytes = head_bytes(got, E) if use == "qkv" else nbytes(got)
        moved = out_bytes + nbytes(kw["x"], kw["w"], kw.get("gamma"), kw.get("beta"),
                                   kw.get("pro_row"), kw.get("bias"), kw.get("residual"),
                                   kw.get("res_row"))
        b_ms, b_by = bound(moved, 2.0 * m * n_out * k, "bf16")
        ms = cuda_ms(lambda: ln_linear(kw["x"], kw["w"], **args))
        plain_ms = cuda_ms(lambda: ln_linear_plain(kw["x"], kw["w"], **args), iters=3)
        torch_ms = cuda_ms(lambda: torch_ln_linear(kw))
        # the library's product alone, on the materialised LayerNorm output
        z = kw["x"]
        if kw.get("gamma") is not None:
            z = z if kw.get("pro_row") is None else z + kw["pro_row"][:, None, :]
            z = F.layer_norm(z.float(), (k,), kw["gamma"], kw["beta"], 1e-5).to(bf)
        product_ms = cuda_ms(lambda: F.linear(z, kw["w"]))
        del z
        per_use[use] = dict(ms=ms, plain_ms=plain_ms, torch_bf16_ms=torch_ms, bound_ms=b_ms,
                            bound_by=b_by, max_abs_err=err, product_library_ms=product_ms)
        for key, val in (("ms", ms), ("plain_ms", plain_ms), ("bound_ms", b_ms), ("torch_ms", torch_ms)):
            tot[key] += val
        bound_kinds.add(b_by)
        log(f"  ln_linear[{use}] ({m}x{k} @ {k}x{n_out}): kernel_ms {ms:.4f} plain_ms {plain_ms:.4f} "
            f"torch_bf16_ms {torch_ms:.4f} F.linear_product_ms {product_ms:.4f} bound_ms "
            f"{b_ms:.4f} ({b_by}); bound share {b_ms / ms:.3f}")
    rows.append(dict(
        name="ln_linear", route="cuda", source="v1t_tpu_torch/csrc/ln_linear.cu",
        replaces="v1t_tpu/ops/fused_mha.py:567 (projections); v1t_tpu/ops/fused_mlp.py:111",
        max_abs_err=worst[0], rel_err=worst[1], ms=tot["ms"], plain_ms=tot["plain_ms"],
        bound_ms=tot["bound_ms"], bound_by="bytes" if bound_kinds == {"bytes"} else "operations",
        library_ms=None, torch_bf16_ms=tot["torch_ms"],
        note="times summed over the 4 calls of one block", per_use=per_use,
    ))

    # attention on the QKV kernel's output
    got = attention(qkv, scale, E)
    ref = attention_plain(qkv, scale, E)
    err, rel = compare("attention", got, ref, KERNEL_TOL)
    got_lsa = attention(qkv, scale, E, use_lsa=True)
    compare("attention[lsa]", got_lsa, attention_plain(qkv, scale, E, use_lsa=True), KERNEL_TOL)
    del got_lsa
    q, k, v = qkv[..., :E].contiguous()
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, scale=E ** -0.5))
    ms = cuda_ms(lambda: attention(qkv, scale, E))
    plain_ms = cuda_ms(lambda: attention_plain(qkv, scale, E), iters=3)
    b_ms, b_by = bound(head_bytes(qkv, E) + nbytes(scale, got), 4.0 * B * H * N * N * E, "bf16")
    log(f"  attention (B {B}, H {H}, N {N}, D {E}): kernel_ms {ms:.4f} plain_ms {plain_ms:.4f} "
        f"sdpa_ms {lib_ms:.4f} bound_ms {b_ms:.4f} ({b_by}); kernel / sdpa {ms / lib_ms:.3f}, "
        f"bound share {b_ms / ms:.3f}; the parent's reading {PARENT_MS['attention serving']} ms")
    rows.append(dict(
        name="attention", route="cuda", source="v1t_tpu_torch/csrc/attention.cu",
        replaces="v1t_tpu/ops/fused_mha.py:567 (_mha_fwd_kernel_dt2, attention core)",
        max_abs_err=err, rel_err=rel, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
        library_ms=lib_ms, library="F.scaled_dot_product_attention",
    ))
    del q, k, v

    # training variants, the flagship's dropout on: attention with the
    # probabilities' keep mask and the LSE out; ln_linear with the keep mask
    # in its epilogue and fc1's pre-GELU activation saved
    drop_p, drop_o, drop1, drop2 = (Dropout(T_DROP, 20261017, site) for site in range(4))
    (got, lse), (ref, lse_ref) = (fn(qkv, scale, E, drop=drop_p, with_lse=True)
                                  for fn in (attention, attention_plain))
    err, rel = compare("attention[train]", got, ref, KERNEL_TOL)
    compare("attention[train] lse", lse, lse_ref, KERNEL_TOL)
    train_ms = cuda_ms(lambda: attention(qkv, scale, E, drop=drop_p, with_lse=True))
    rows[-1].update(train_ms=train_ms, train_max_abs_err=err)
    log(f"  attention[train] kernel_ms {train_ms:.4f}; the parent's reading "
        f"{PARENT_MS['attention training']} ms")
    # a row whose every key is masked (LSA at N 1): o = v and the plain LSE
    qkv1 = qkv[:, :, :, :1].contiguous()
    (o1, lse1), (o1_ref, lse1_ref) = (fn(qkv1, scale, E, use_lsa=True, with_lse=True)
                                      for fn in (attention, attention_plain))
    compare("attention[N 1, lsa] o", o1, o1_ref, KERNEL_TOL)
    torch.cuda.synchronize()
    v1 = qkv1[2, :, :, 0, :E].reshape(B, H * E)
    if not (torch.equal(o1[:, 0, :H * E], v1) and torch.equal(lse1, lse1_ref)
            and torch.all(o1[..., H * E:] == 0)):
        raise AssertionError("attention[N 1, lsa]: o is not v or the LSE is not the plain one")
    log("  attention[N 1, lsa]: o equal to v, the LSE equal to the plain version's, "
        "pad columns zero")
    del qkv1, o1, lse1, o1_ref, lse1_ref
    # the keep masks bit for bit: with q = 0 every probability is 1/N, and
    # v[k] = e_(k mod D) makes o count the kept keys of each residue class:
    # exact small integers times one scale, equal only if the masks are
    qkv_ones = torch.zeros_like(qkv)
    keys = torch.arange(N, device=dev)
    qkv_ones[2, :, :, keys, keys % E] = 1.0
    o_k = attention(qkv_ones, scale, E, drop=drop_p, with_lse=True)[0]
    o_p = attention_plain(qkv_ones, scale, E, drop=drop_p, with_lse=True)[0]
    torch.cuda.synchronize()
    if not torch.equal(o_k, o_p):
        raise AssertionError("attention[train]: the kernel's keep mask differs from the plain one")
    log("  attention[train] keep mask: bit-identical to the plain version's")
    del qkv_ones, o_k, o_p
    train_uses = {
        "out_proj": dict(uses["out_proj"], drop=drop_o),
        "fc1": dict(uses["fc1"], drop=drop1, save_pre=True),
        "fc2": dict(uses["fc2"], drop=drop2),
    }
    for use, kw in train_uses.items():
        args = {k: v for k, v in kw.items() if k not in ("x", "w")}
        got, ref = ln_linear(kw["x"], kw["w"], **args), ln_linear_plain(kw["x"], kw["w"], **args)
        if use == "fc1":
            compare("ln_linear[fc1, train] pre-GELU", got[1], ref[1], KERNEL_TOL)
            got, ref = got[0], ref[0]
            torch.cuda.synchronize()
            if not torch.equal(got == 0, ref == 0):
                raise AssertionError("ln_linear[fc1, train]: the keep masks differ")
            log("  ln_linear[fc1, train] keep mask: bit-identical to the plain version's")
        compare(f"ln_linear[{use}, train]", got, ref, KERNEL_TOL)
        ms = cuda_ms(lambda: ln_linear(kw["x"], kw["w"], **args))
        rows[0]["per_use"][use]["train_ms"] = ms
        log(f"  ln_linear[{use}, train] kernel_ms {ms:.4f}")
    # the unfolded attention sublayer (drop_path in training, the rollout's
    # blocks): QKV without the behavior row, the out-projection without the
    # residual, serving and training; checked and timed apart from the
    # block's four calls
    unfolded = {
        "qkv, no row": dict(x=x, w=wqkv, gamma=gamma, beta=beta, heads=(H, E)),
        "out_proj, no residual": dict(x=o, w=wp_o, bias=bp),
        "out_proj, no residual, train": dict(x=o, w=wp_o, bias=bp, drop=drop_o),
    }
    for use, kw in unfolded.items():
        args = {k: v for k, v in kw.items() if k not in ("x", "w")}
        got, ref = ln_linear(kw["x"], kw["w"], **args), ln_linear_plain(kw["x"], kw["w"], **args)
        err, _ = compare(f"ln_linear[{use}]", got, ref, KERNEL_TOL)
        ms = cuda_ms(lambda: ln_linear(kw["x"], kw["w"], **args))
        rows[0]["per_use"][use] = dict(ms=ms, max_abs_err=err)
        log(f"  ln_linear[{use}] kernel_ms {ms:.4f}")
    del got, ref
    # the kernel's other head widths (built for padded widths 32..160), small
    ones = torch.ones(48, device=dev)
    for d_head, lsa in ((32, False), (64, True), (100, False), (128, True)):
        qkv_s = ln_linear(randn(2, 300, 48), randn(3 * 2 * d_head, 48, scale=0.2),
                          gamma=ones, beta=ones * 0.0, heads=(2, d_head))
        scale_s = torch.full((2,), d_head ** -0.5, device=dev)
        compare(f"attention[head_dim {d_head}{', lsa' if lsa else ''}]",
                attention(qkv_s, scale_s, d_head, use_lsa=lsa),
                attention_plain(qkv_s, scale_s, d_head, use_lsa=lsa), KERNEL_TOL)

    # bilinear sampling of a core map at per-neuron grid points, some
    # outside: the flagship's map, then the sweep-widest's (C 256)
    table = randn(B, E, MAP_H * MAP_W)
    grid = (torch.rand(B, NEURONS, 2, generator=gen) * 2.4 - 1.2).to(dev)
    sample_cases = {"flagship 29x57": sample_forward("flagship 29x57", table, grid, MAP_H, MAP_W)}
    wide_table = randn(B, SWEEP_EMB, MAP_H * MAP_W)
    sample_cases["sweep-widest C 256"] = sample_forward("sweep-widest C 256", wide_table, grid,
                                                        MAP_H, MAP_W)
    del wide_table
    flag = sample_cases["flagship 29x57"]
    rows.append(dict(
        name="bilinear_sample_cm", route="cuda", source="v1t_tpu_torch/csrc/bilinear_sample.cu",
        replaces="v1t_tpu/ops/interp_matmul.py:99 (_fwd_kernel)",
        max_abs_err=flag["max_abs_err"], rel_err=flag["rel_err"], ms=flag["ms"],
        plain_ms=flag["plain_ms"], bound_ms=flag["bound_ms"], bound_by=flag["bound_by"],
        library_ms=flag["library_ms"], library="F.grid_sample",
        note="times at the flagship's map; per_case holds the sweep-widest, full-resolution "
             "and fp32 maps'", per_case=sample_cases,
    ))
    tensors = dict(x=x, row=row, gamma=gamma, beta=beta, wqkv=wqkv, wp=wp, wp_o=wp_o, bp=bp,
                   w1=w1, b1=b1,
                   w2=w2, b2=b2, scale=scale, qkv=qkv, table=table, grid=grid,
                   drops=(drop_p, drop_o, drop1, drop2), sample_cases=sample_cases)
    return rows, tensors


def check_backward_kernels(gen: torch.Generator, t: dict) -> list:
    """The four backward kernels against their plain versions at the
    flagship shapes, dropout on, on the forward kernels' outputs."""
    import torch.nn.functional as F

    from v1t_tpu_torch.ops.fused_mha import attention, attention_bwd, attention_bwd_plain
    from v1t_tpu_torch.ops.interp_matmul import (
        bilinear_sample_cm_bwd, bilinear_sample_cm_bwd_plain,
    )
    from v1t_tpu_torch.ops.ln_linear import (
        _masked_dy, ln_linear, ln_linear_bwd, ln_linear_bwd_plain, ln_linear_wgrad,
        ln_linear_wgrad_plain, merge_heads,
    )

    dev, bf, f32 = DEVICE, torch.bfloat16, torch.float32
    drop_p, drop_o, drop1, drop2 = t["drops"]
    x, qkv, scale = t["x"], t["qkv"], t["scale"]
    m = B * N

    def randn(*shape, scale_=1.0):
        return (torch.randn(*shape, generator=gen) * scale_).to(dev, bf)

    o, lse = attention(qkv, scale, E, drop=drop_p, with_lse=True)
    h, pre = ln_linear(x, t["w1"], gamma=t["gamma"], beta=t["beta"], bias=t["b1"], gelu=True,
                       drop=drop1, save_pre=True)
    dout = randn(B, N, E)
    do = randn(B, N, H * E, scale_=0.1)
    rows = []
    log("phase 3b: backward kernels against their plain versions, dropout on")

    # attention_bwd (prep, the shared one pass, convert): dq, dk, dv
    # head-major and dscale, without dropout (on the no-dropout forward's o
    # and LSE) and with it
    o0, lse0 = attention(qkv, scale, E, with_lse=True)
    worst = (0.0, 0.0)
    for label, o_, lse_, drp in (("no dropout", o0, lse0, None), ("dropout", o, lse, drop_p)):
        (dqkv, dscale), (dqkv_ref, dscale_ref) = (
            fn(qkv, o_, do, lse_, scale, E, drop=drp)
            for fn in (attention_bwd, attention_bwd_plain))
        worst = max([worst] + [compare(f"attention_bwd[{label}] {part}", dqkv[i], dqkv_ref[i],
                                       KERNEL_TOL) for i, part in enumerate(("dq", "dk", "dv"))])
        compare(f"attention_bwd[{label}] dscale", dscale, dscale_ref, KERNEL_TOL)
        # dq in key order (dscale's block sums are fixed-order in either form)
        def split(res):  # (dq, dk, dv, dscale)
            return (*res[0], res[1])

        worst = max(worst, fixed_order_twice(
            f"attention_bwd[{label}]", lambda: split(attention_bwd(qkv, o_, do, lse_, scale, E,
                                                                   drop=drp)),
            (*dqkv_ref, dscale_ref), KERNEL_TOL, ("dq", "dk", "dv", "dscale")))
        del dqkv_ref
    ms0 = cuda_ms(lambda: attention_bwd(qkv, o0, do, lse0, scale, E))
    with deterministic_mode(fill=False):
        fixed0_ms = cuda_ms(lambda: attention_bwd(qkv, o0, do, lse0, scale, E))
        fixed_ms = cuda_ms(lambda: attention_bwd(qkv, o, do, lse, scale, E, drop=drop_p))
    del o0, lse0
    ms = cuda_ms(lambda: attention_bwd(qkv, o, do, lse, scale, E, drop=drop_p))
    plain_ms = cuda_ms(lambda: attention_bwd_plain(qkv, o, do, lse, scale, E, drop=drop_p),
                       iters=1)
    with torch.enable_grad():
        qs, ks, vs = (y.detach().clone().requires_grad_() for y in qkv[..., :E])
        sdpa = F.scaled_dot_product_attention(qs, ks, vs, scale=E ** -0.5)
        do_h = do.reshape(B, N, H, E).permute(0, 2, 1, 3).contiguous()
        lib_ms = cuda_ms(lambda: torch.autograd.grad(sdpa, (qs, ks, vs), do_h,
                                                     retain_graph=True))
    del qs, ks, vs, sdpa, do_h
    b_ms, b_by = bound(2 * head_bytes(qkv, E) + nbytes(o, do, lse, scale, dscale),
                       5 * 2.0 * B * H * N * N * E, "bf16")
    log(f"  attention_bwd (B {B}, H {H}, N {N}, D {E}): kernel_ms {ms:.4f} (no dropout "
        f"{ms0:.4f}) plain_ms {plain_ms:.4f} sdpa_backward_ms {lib_ms:.4f} bound_ms "
        f"{b_ms:.4f} ({b_by}); no dropout / sdpa {ms0 / lib_ms:.3f}, bound share "
        f"{b_ms / ms0:.3f}; dq in key order (--deterministic) {fixed_ms:.4f} (no dropout "
        f"{fixed0_ms:.4f}), {fixed_ms / ms:.3f}x")
    rows.append(dict(
        name="attention_bwd", route="cuda",
        source="v1t_tpu_torch/csrc/attention_bwd.cu (+ the one pass of "
               "v1t_tpu_torch/csrc/flash_attention_bwd.cu)",
        replaces="v1t_tpu/ops/fused_mha.py:676 (_mha_bwd_kernel_dt2, attention core)",
        max_abs_err=worst[0], rel_err=worst[1], ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=lib_ms,
        library="autograd backward of F.scaled_dot_product_attention (no dropout)",
        ms_like_for_like=ms0, like_for_like="no dropout", fixed_order_ms=fixed_ms,
        fixed_order_no_dropout_ms=fixed0_ms,
        fixed_order="dq added in key order under PyTorch's deterministic mode (timed without "
                    "its buffer fill); dscale's block sums in block order always",
    ))

    # ln_linear_bwd (dX, with the LayerNorm backward or fc1's GELU' fused)
    # and ln_linear_wgrad (dW, db) on each projection of a block
    heads = (H, E)
    fc2_dx = ln_linear_bwd(dout, t["w2"], drop=drop2, pre=pre, pre_drop=drop1)
    uses = {
        "out_proj": dict(dy=dout, w=t["wp"], drop=drop_o),
        "qkv": dict(dy=dqkv, w=t["wqkv"], heads=heads, x=x, pro_row=t["row"], gamma=t["gamma"],
                    beta=t["beta"], dres=dout),
        "fc2": dict(dy=dout, w=t["w2"], drop=drop2, pre=pre, pre_drop=drop1),
        "fc1": dict(dy=fc2_dx, w=t["w1"], x=x, gamma=t["gamma"], beta=t["beta"], dres=dout),
    }
    forward = {  # each projection's forward arguments, for the PyTorch yardstick
        "out_proj": dict(x=o, w=t["wp_o"], bias=t["bp"], residual=x, res_row=t["row"]),
        "qkv": dict(x=x, w=t["wqkv"], gamma=t["gamma"], beta=t["beta"], pro_row=t["row"]),
        "fc2": dict(x=h, w=t["w2"], bias=t["b2"], residual=x),
        "fc1": dict(x=x, w=t["w1"], gamma=t["gamma"], beta=t["beta"], bias=t["b1"], gelu=True),
    }
    ln_outs = {}
    bwd_row = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, torch_ms=0.0, worst=(0.0, 0.0),
                   kinds=set(), per_use={})
    wgrad_row = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, torch_ms=0.0, worst=(0.0, 0.0),
                     kinds=set(), per_use={})
    for use, kw in uses.items():
        args = {k: v for k, v in kw.items() if k not in ("dy", "w")}
        got = ln_linear_bwd(kw["dy"], kw["w"], **args)
        ref = ln_linear_bwd_plain(kw["dy"], kw["w"], **args)
        if "x" in kw:
            ln_outs[use] = got[1]
            names = ("dz", "ln_out", "dgamma", "dbeta", "dbias_row")
            errs = [compare(f"ln_linear_bwd[{use}] {n_}", g_, r_, KERNEL_TOL)
                    for n_, g_, r_ in zip(names, got, ref) if r_ is not None]
            # the column sums' partials added in an order fixed by the shape
            errs.append(fixed_order_twice(f"ln_linear_bwd[{use}]", lambda: ln_linear_bwd(
                kw["dy"], kw["w"], **args), ref, KERNEL_TOL, names))
            err = max(errs)
        else:
            err = compare(f"ln_linear_bwd[{use}]", got, ref, KERNEL_TOL)
        del ref
        nout, k = kw["w"].shape
        flops = 2.0 * m * nout * k
        out = got if "x" not in kw else got[:2] + tuple(g_ for g_ in got[2:] if g_ is not None)
        moved = (m * nout * 2 + nbytes(kw["w"], *(out if isinstance(out, tuple) else (out,)),
                                       kw.get("x"), kw.get("pro_row"), kw.get("gamma"),
                                       kw.get("beta"), kw.get("dres"), kw.get("pre")))
        b_ms, b_by = bound(moved, flops, "bf16")
        ms = cuda_ms(lambda: ln_linear_bwd(kw["dy"], kw["w"], **args))
        plain_ms = cuda_ms(lambda: ln_linear_bwd_plain(kw["dy"], kw["w"], **args), iters=3)
        # the same layer's backward as separate PyTorch calls: dX and dW together
        with torch.enable_grad():
            fw = dict(forward[use])
            fw["x"], fw["w"] = (fw[k_].detach().clone().requires_grad_() for k_ in ("x", "w"))
            y = torch_ln_linear(fw)
            dy_rm = merge_heads(kw["dy"], E).contiguous() if use == "qkv" else kw["dy"]
            torch_ms = cuda_ms(lambda: torch.autograd.grad(y, (fw["x"], fw["w"]), dy_rm,
                                                           retain_graph=True))
        del y, fw
        bwd_row["ms"] += ms
        bwd_row["plain_ms"] += plain_ms
        bwd_row["bound_ms"] += b_ms
        bwd_row["torch_ms"] += torch_ms
        bwd_row["worst"] = max(bwd_row["worst"], err)
        bwd_row["kinds"].add(b_by)
        bwd_row["per_use"][use] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                                       bound_share=b_ms / ms, torch_bf16_bwd_ms=torch_ms,
                                       max_abs_err=err[0])
        log(f"  ln_linear_bwd[{use}] ({m}x{nout} @ {nout}x{k}): kernel_ms {ms:.4f} "
            f"plain_ms {plain_ms:.4f} torch_bf16_bwd_ms {torch_ms:.4f} bound_ms {b_ms:.4f} "
            f"({b_by}); bound share {b_ms / ms:.3f}")
        del got

    # the unfolded sublayer's QKV backward: no behavior row, no residual
    # cotangent (checked and timed apart from the block's four calls)
    kw = dict(heads=heads, x=x, gamma=t["gamma"], beta=t["beta"])
    got, ref = (fn(dqkv, t["wqkv"], **kw) for fn in (ln_linear_bwd, ln_linear_bwd_plain))
    if got[4] is not None or ref[4] is not None:
        raise AssertionError("ln_linear_bwd[qkv, no residual]: a row gradient without a row")
    err = max(compare(f"ln_linear_bwd[qkv, no residual] {n_}", g_, r_, KERNEL_TOL)
              for n_, g_, r_ in zip(("dz", "ln_out", "dgamma", "dbeta"), got, ref))
    ms = cuda_ms(lambda: ln_linear_bwd(dqkv, t["wqkv"], **kw))
    bwd_row["per_use"]["qkv, no residual"] = dict(ms=ms, max_abs_err=err[0])
    log(f"  ln_linear_bwd[qkv, no residual] kernel_ms {ms:.4f}")
    del got, ref

    wgrad_uses = {
        "out_proj": dict(dy=dout, a=o, drop=drop_o, bias=True),
        "qkv": dict(dy=dqkv, a=ln_outs["qkv"], heads=heads),
        "fc2": dict(dy=dout, a=h, drop=drop2, bias=True),
        "fc1": dict(dy=fc2_dx, a=ln_outs["fc1"], bias=True),
    }
    for use, kw in wgrad_uses.items():
        args = {k: v for k, v in kw.items() if k not in ("dy", "a")}
        (dw, db), (dw_ref, db_ref) = (fn(kw["dy"], kw["a"], **args)
                                      for fn in (ln_linear_wgrad, ln_linear_wgrad_plain))
        err = compare(f"ln_linear_wgrad[{use}] dW", dw, dw_ref, KERNEL_TOL)
        if db is not None:
            compare(f"ln_linear_wgrad[{use}] db", db, db_ref, KERNEL_TOL)
        # no float atomics: a second run gives the same bits
        dw2, db2 = ln_linear_wgrad(kw["dy"], kw["a"], **args)
        torch.cuda.synchronize()
        if not (torch.equal(dw, dw2) and (db is None or torch.equal(db, db2))):
            raise AssertionError(f"ln_linear_wgrad[{use}]: two runs differ")
        log(f"  ln_linear_wgrad[{use}] rerun: dW and db bit-identical")
        del dw2, db2
        nout, k = dw.shape
        b_ms, b_by = bound(m * nout * 2 + nbytes(kw["a"], dw, db), 2.0 * m * nout * k, "bf16")
        ms = cuda_ms(lambda: ln_linear_wgrad(kw["dy"], kw["a"], **args))
        plain_ms = cuda_ms(lambda: ln_linear_wgrad_plain(kw["dy"], kw["a"], **args), iters=3)
        # the library's product alone, on materialised row-major dY' and A
        d_rm = _masked_dy(kw["dy"], args.get("heads"), args.get("drop")).reshape(m, nout)
        d_t, a_rm = d_rm.t(), kw["a"].reshape(m, k)
        product_ms = cuda_ms(lambda: torch.matmul(d_t, a_rm))
        del d_rm, d_t, a_rm
        wgrad_row["ms"] += ms
        wgrad_row["plain_ms"] += plain_ms
        wgrad_row["bound_ms"] += b_ms
        wgrad_row["worst"] = max(wgrad_row["worst"], err)
        wgrad_row["kinds"].add(b_by)
        wgrad_row["per_use"][use] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                                         max_abs_err=err[0], product_library_ms=product_ms,
                                         rerun_bit_identical=True)
        log(f"  ln_linear_wgrad[{use}] ({nout}x{m} @ {m}x{k}): kernel_ms {ms:.4f} "
            f"plain_ms {plain_ms:.4f} torch.matmul_product_ms {product_ms:.4f} bound_ms "
            f"{b_ms:.4f} ({b_by}); bound share {b_ms / ms:.3f}")
    for name, acc in (("ln_linear_bwd", bwd_row), ("ln_linear_wgrad", wgrad_row)):
        rows.append(dict(
            name=name, route="cuda", source="v1t_tpu_torch/csrc/ln_linear_bwd.cu",
            replaces="v1t_tpu/ops/fused_mha.py:676 (projection backwards); "
                     "v1t_tpu/ops/fused_mlp.py:150",
            max_abs_err=acc["worst"][0], rel_err=acc["worst"][1], ms=acc["ms"],
            plain_ms=acc["plain_ms"], bound_ms=acc["bound_ms"],
            bound_by="bytes" if acc["kinds"] == {"bytes"} else "operations", library_ms=None,
            torch_bf16_bwd_ms=bwd_row["torch_ms"],
            note="times summed over the 4 calls of one block; torch_bf16_bwd_ms is dX and dW "
                 "together as separate PyTorch calls", per_use=acc["per_use"],
        ))

    # bilinear_sample_cm_bwd: d(table) summed in shared memory, d(grid); at
    # the flagship's map, the full-resolution one and the fp32 model's
    from v1t_tpu_torch.ops.interp_matmul import sample_bwd_plan

    # (and phase 5l's: 768 channels, the emb-768 core map)
    maps = {"flagship 29x57": (B, MAP_H, MAP_W, bf, E),
            "full-res 137x249": (FR_B, FR_MAP_H, FR_MAP_W, bf, E),
            "fp32 29x57": (B, MAP_H, MAP_W, f32, E),
            f"emb-{WIDE_EMB} 29x57": (B, MAP_H, MAP_W, bf, WIDE_EMB)}
    cases = {}
    for label, (b, hh, ww, dtype, c) in maps.items():
        if label.startswith("flagship"):
            table, grid = t["table"], t["grid"]
        else:
            table = torch.randn(b, c, hh * ww, generator=gen).to(dev, dtype)
            grid = (torch.rand(b, NEURONS, 2, generator=gen) * 2.4 - 1.2).to(dev)
        if not label.startswith("flagship"):  # the forward beside the backward
            t["sample_cases"][label] = sample_forward(label, table, grid, hh, ww)
        ds = torch.randn(b, c, NEURONS, generator=gen).to(dev, dtype)
        tol = KERNEL_TOL if dtype == bf else F32_KERNEL_TOL
        got, ref = (fn(table, grid, ds, hh, ww)
                    for fn in (bilinear_sample_cm_bwd, bilinear_sample_cm_bwd_plain))
        err = compare(f"bilinear_sample_cm_bwd[{label}] d(table)", got[0], ref[0], tol)
        compare(f"bilinear_sample_cm_bwd[{label}] d(grid)", got[1], ref[1], tol)
        # d(table) in fixed point, d(grid)'s chunk partials in chunk order
        err = max(err, fixed_order_twice(
            f"bilinear_sample_cm_bwd[{label}]", lambda: bilinear_sample_cm_bwd(
                table, grid, ds, hh, ww), ref, tol, ("d(table)", "d(grid)")))
        del ref
        ms = cuda_ms(lambda: bilinear_sample_cm_bwd(table, grid, ds, hh, ww))
        plain_ms = cuda_ms(lambda: bilinear_sample_cm_bwd_plain(table, grid, ds, hh, ww),
                           iters=3)
        with torch.enable_grad():
            table4 = table.reshape(b, c, hh, ww).detach().clone().requires_grad_()
            grid4 = grid.reshape(b, 1, NEURONS, 2).to(dtype).requires_grad_()
            sampled = F.grid_sample(table4, grid4, mode="bilinear", padding_mode="zeros",
                                    align_corners=True)
            ds4 = ds.reshape(b, c, 1, NEURONS)
            lib_ms = cuda_ms(lambda: torch.autograd.grad(sampled, (table4, grid4), ds4,
                                                         retain_graph=True))
        del table4, grid4, sampled, ds4
        b_ms, b_by = bound(nbytes(table, grid, ds, *got), 16.0 * b * NEURONS * c, "fp32")
        plan = sample_bwd_plan(c, hh, ww)
        log(f"  bilinear_sample_cm_bwd[{label}] (B {b}, C {c}, {hh}x{ww}, P {NEURONS}, "
            f"{str(dtype)[6:]}; {plan.channels} channels a block x {plan.chunks} chunks, "
            f"{plan.bands} band(s), table {'staged' if plan.staged else 'in global memory'}, "
            f"{plan.smem} bytes of shared memory a block): kernel_ms "
            f"{ms:.4f} plain_ms {plain_ms:.4f} grid_sample_backward_ms {lib_ms:.4f} bound_ms "
            f"{b_ms:.4f} ({b_by}); kernel / grid_sample {ms / lib_ms:.3f}, bound share "
            f"{b_ms / ms:.3f}" + (f"; the parent's reading {PARENT_MS['bilinear_sample_cm_bwd']}"
                                   " ms" if label.startswith("flagship") else ""))
        cases[label] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                            bound_by=b_by, max_abs_err=err[0], rel_err=err[1],
                            plan=plan._asdict())
        del got
    flag = cases["flagship 29x57"]
    rows.append(dict(
        name="bilinear_sample_cm_bwd", route="cuda", source="v1t_tpu_torch/csrc/bilinear_sample.cu",
        replaces="v1t_tpu/ops/interp_matmul.py:116 (_bwd_kernel)",
        max_abs_err=flag["max_abs_err"], rel_err=flag["rel_err"], ms=flag["ms"],
        plain_ms=flag["plain_ms"], bound_ms=flag["bound_ms"], bound_by=flag["bound_by"],
        library_ms=flag["library_ms"], library="autograd backward of F.grid_sample",
        note="times at the flagship's map; per_case holds the full-resolution and fp32 maps'",
        per_case=cases,
    ))
    return rows


def one_pass_at_flagship(gen: torch.Generator) -> dict:
    """The bf16 one-pass backward at the flagship shape (B*H 256, N 1654, D
    155 padded to 160) through the wrappers that launch it: ``flash_bwd``
    (natural-log LSE, the scale folded into q) and ``attention_bwd`` (log2
    LSE, its prep and convert around it), with and without dropout, and each
    call's kernels under torch.profiler."""
    from v1t_tpu_torch.ops.dropout import Dropout
    from v1t_tpu_torch.ops.flash_attention import flash_bwd, flash_fwd
    from v1t_tpu_torch.ops.fused_mha import attention, attention_bwd

    log("phase 3b: the one-pass backward at the flagship shape, through both wrappers")
    bf = torch.bfloat16
    dp = -(-E // 32) * 32
    qkv = torch.zeros(3, B, H, N, dp, dtype=bf, device=DEVICE)
    qkv[..., :E] = torch.randn(3, B, H, N, E, generator=gen).to(DEVICE, bf)
    scale = torch.full((H,), E ** -0.5, device=DEVICE)
    q = (qkv[0] * scale.to(bf).view(1, H, 1, 1)).reshape(B * H, N, dp)
    k, v = (qkv[i].reshape(B * H, N, dp) for i in (1, 2))
    do = (torch.randn(B, N, H * E, generator=gen) * 0.1).to(DEVICE, bf)
    times, calls = {}, {}
    for label, drp in (("dropout", Dropout(T_DROP, 20261017, 0)), ("no dropout", None)):
        o, lse = flash_fwd(q, k, v, E, H, drop=drp, with_lse=True)
        calls[f"flash_bwd, {label}"] = functools.partial(
            flash_bwd, q, k, v, o, do.view(B, N, H, E), lse, E, H, drop=drp)
        o2, lse2 = attention(qkv, scale, E, drop=drp, with_lse=True)
        calls[f"attention_bwd, {label}"] = functools.partial(
            attention_bwd, qkv, o2, do, lse2, scale, E, drop=drp)
    for name, fn in calls.items():
        times[name] = cuda_ms(fn)
    log("  " + "; ".join(f"{name} {ms:.4f} ms" for name, ms in times.items())
        + f" (B*H {B * H}, N {N}, D {E})")
    for name, fn in calls.items():
        where_the_time_goes(name, fn, phase="3b")
    del qkv, q, k, v, do, calls
    torch.cuda.empty_cache()
    return times


def check_sublayer_form(gen: torch.Generator, fold_residual: bool = False) -> None:
    """The attention sublayer without the folded residual (``fused_mha``
    with ``fold_residual=False``, as drop_path's training blocks run it),
    or with it and without the behavior row (``bias_row`` None, behavior
    mode 0's blocks), forward and backward through autograd, dropout on,
    against its plain version on the same inputs, masks and cotangent."""
    from v1t_tpu_torch.ops.dropout import Dropout
    from v1t_tpu_torch.ops.fused_mha import fused_mha

    form = "folded, no behavior row" if fold_residual else "no residual"
    log("phase 3b: the attention sublayer " + (
        "with the folded residual and without the behavior row" if fold_residual
        else "without the folded residual") + ", forward and backward")
    bf, f32 = torch.bfloat16, torch.float32

    def randn(*shape, scale=1.0, dtype=bf):
        return (torch.randn(*shape, generator=gen) * scale).to(DEVICE, dtype)

    leaves = dict(x=randn(B, N, E), gamma=1.0 + randn(E, scale=0.1, dtype=f32),
                  beta=randn(E, scale=0.1, dtype=f32), wqkv=randn(3 * H * E, E, scale=0.08),
                  wp=randn(E, H * E, scale=0.04), bp=randn(E, scale=0.1, dtype=f32),
                  scale=torch.full((H,), E ** -0.5, device=DEVICE))
    dout = randn(B, N, E)
    drops = dict(drop_p=Dropout(T_DROP, 20261018, 0), drop_o=Dropout(T_DROP, 20261018, 1))
    results = {}
    for path in ("kernel", "plain"):
        inputs = {k: v.detach().clone().requires_grad_() for k, v in leaves.items()}
        with torch.enable_grad():
            out = fused_mha(*inputs.values(), num_heads=H, fold_residual=fold_residual,
                            plain=path == "plain", **drops)
            out.backward(dout)
        results[path] = dict(out=out.detach(), **{f"d{k}": v.grad for k, v in inputs.items()})
    for name, ref in results["plain"].items():
        compare(f"fused_mha[{form}] {name}", results["kernel"][name], ref, KERNEL_TOL)
    del results


def check_flash_kernels(gen: torch.Generator) -> list:
    """The flash kernels of the composed path (rows 7-8) against their
    chunked plain versions: forward (o, LSE) and backward (dq, dk, dv), with
    times at the full-resolution and fp32 flagship shapes."""
    import torch.nn.functional as F

    from v1t_tpu_torch.ops.dropout import Dropout
    from v1t_tpu_torch.ops.flash_attention import (
        flash_bwd, flash_bwd_plain, flash_fwd, flash_fwd_plain,
    )

    log("phase 3c: flash kernels against their chunked plain versions")
    bf, f32 = torch.bfloat16, torch.float32
    drop = Dropout(T_DROP, 20261017, 0)

    def operands(bh, nq, nk, d, dtype):
        dp = -(-d // 32) * 32
        out = []
        for n in (nq, nk, nk):
            x = torch.zeros(bh, n, dp, dtype=dtype, device=DEVICE)
            x[..., :d] = (torch.randn(bh, n, d, generator=gen) * d ** -0.25).to(DEVICE, dtype)
            out.append(x)
        return out

    def check(label, bh, heads, nq, nk, d, dtype, *, n_real=None, lsa=False, drp=None,
              dlse=False, timed=False, fixed=False, iters=None):
        q, k, v = operands(bh, nq, nk, d, dtype)
        kw = dict(n_real_k=n_real, use_lsa=lsa, drop=drp)
        tol = KERNEL_TOL if dtype == bf else F32_KERNEL_TOL
        (o, lse), (o_ref, lse_ref) = (fn(q, k, v, d, heads, with_lse=True, **kw)
                                      for fn in (flash_fwd, flash_fwd_plain))
        err_f = compare(f"flash_attention[{label}] o", o, o_ref, tol)
        compare(f"flash_attention[{label}] lse", lse, lse_ref, F32_KERNEL_TOL)
        do = (torch.randn(o.shape, generator=gen)).to(DEVICE, dtype)
        g_lse = (torch.randn(bh, nq, generator=gen) * 0.5).to(DEVICE) if dlse else None
        got = flash_bwd(q, k, v, o_ref, do, lse_ref, d, heads, dlse=g_lse, **kw)
        ref = flash_bwd_plain(q, k, v, o_ref, do, lse_ref, d, heads, dlse=g_lse, **kw)
        err_b = max(compare(f"flash_attention_bwd[{label}] {part}", g_, r_, tol)
                    for part, g_, r_ in zip(("dq", "dk", "dv"), got, ref))
        if fixed:  # dq added in key order, under PyTorch's deterministic mode
            err_b = max(err_b, fixed_order_twice(
                f"flash_attention_bwd[{label}]", lambda: flash_bwd(
                    q, k, v, o_ref, do, lse_ref, d, heads, dlse=g_lse, **kw),
                ref, tol, ("dq", "dk", "dv")))
        del got, ref, o_ref
        case = dict(max_abs_err=err_f[0], rel_err=err_f[1], bwd_max_abs_err=err_b[0],
                    bwd_rel_err=err_b[1])
        if timed:
            kind = "bf16" if dtype == bf else "fp32"
            d_bytes = d / q.shape[-1]  # the function reads D of the DP columns
            b_ms, b_by = bound(nbytes(q, k, v) * d_bytes + nbytes(o, lse),
                               4.0 * bh * nq * nk * d, kind)
            bb_ms, bb_by = bound(2 * nbytes(q, k, v) * d_bytes + nbytes(o, do, lse),
                                 10.0 * bh * nq * nk * d, kind)
            iters = iters or (3 if nq > 10000 else 10)
            ms = cuda_ms(lambda: flash_fwd(q, k, v, d, heads, with_lse=True, **kw), iters)
            serve_ms = cuda_ms(lambda: flash_fwd(q, k, v, d, heads), iters)
            bwd_ms = cuda_ms(lambda: flash_bwd(q, k, v, o, do, lse, d, heads, **kw), iters)
            if fixed:
                with deterministic_mode(fill=False):
                    case.update(bwd_fixed_order_ms=cuda_ms(
                        lambda: flash_bwd(q, k, v, o, do, lse, d, heads, **kw), iters))
            # like against like: SDPA runs without dropout, so the kernels are
            # timed without it too (the backward on the no-dropout forward's o
            # and LSE)
            kw0 = dict(kw, drop=None)
            o0, lse0 = flash_fwd(q, k, v, d, heads, with_lse=True, **kw0)
            bwd0_ms = cuda_ms(lambda: flash_bwd(q, k, v, o0, do, lse0, d, heads, **kw0), iters)
            del o0, lse0
            plain_ms = cuda_ms(lambda: flash_fwd_plain(q, k, v, d, heads, with_lse=True, **kw),
                               iters=1)
            plain_bwd_ms = cuda_ms(lambda: flash_bwd_plain(q, k, v, o, do, lse, d, heads, **kw),
                                   iters=1)
            # one library call: SDPA on (B, H, N, DP) (the zero columns past D
            # change no score), forward and its autograd backward, no dropout
            b4 = lambda x: x.view(bh // heads, heads, x.shape[1], x.shape[2])  # noqa: E731
            with torch.enable_grad():
                qs, ks, vs = (b4(x).detach().clone().requires_grad_() for x in (q, k, v))
                lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qs, ks, vs, scale=1.0),
                                 iters)
                y = F.scaled_dot_product_attention(qs, ks, vs, scale=1.0)
                gy = torch.randn(y.shape, generator=gen).to(DEVICE, dtype)
                lib_bwd_ms = cuda_ms(lambda: torch.autograd.grad(y, (qs, ks, vs), gy,
                                                                 retain_graph=True), iters)
                case.update(sdpa_backend=sdpa_backend(qs, ks, vs))
                if d < q.shape[-1]:
                    # SDPA on the head width itself, unpadded: the backend it
                    # takes there, and its times
                    qd, kd, vd = (x[..., :d].detach().clone().requires_grad_()
                                  for x in (qs, ks, vs))
                    yd = F.scaled_dot_product_attention(qd, kd, vd, scale=1.0)
                    case.update(
                        sdpa_unpadded_backend=sdpa_backend(qd, kd, vd),
                        library_unpadded_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
                            qd, kd, vd, scale=1.0), iters),
                        bwd_library_unpadded_ms=cuda_ms(lambda: torch.autograd.grad(
                            yd, (qd, kd, vd), gy[..., :d], retain_graph=True), iters))
                    del qd, kd, vd, yd
            del qs, ks, vs, y, gy
            case.update(ms=ms, serving_ms=serve_ms, plain_ms=plain_ms, bound_ms=b_ms,
                        bound_by=b_by, library_ms=lib_ms, bwd_ms=bwd_ms,
                        bwd_no_dropout_ms=bwd0_ms, bwd_plain_ms=plain_bwd_ms,
                        bwd_bound_ms=bb_ms, bwd_bound_by=bb_by, bwd_library_ms=lib_bwd_ms)
            if dtype == f32 and q.shape[-1] > 256:
                # the 3xTF32 column groups: their products three times at the
                # TF32 rate, beside the FFMA bound
                case.update(bound_tf32_ms=3 * 4.0 * bh * nq * nk * d / TF32_FLOPS * 1e3,
                            bwd_bound_tf32_ms=3 * 10.0 * bh * nq * nk * d / TF32_FLOPS * 1e3)
                parent = PARENT_F32_WIDE_MS.get((bh, d), {})
                log(f"  flash_attention[{label}] in 3xTF32: bound {case['bound_tf32_ms']:.4f} ms "
                    f"(share {case['bound_tf32_ms'] / serve_ms:.3f} serving), backward "
                    f"{case['bwd_bound_tf32_ms']:.4f} ms (share "
                    f"{case['bwd_bound_tf32_ms'] / bwd0_ms:.3f} without dropout); the parent "
                    "design (FFMA, PERF.md rows 7f / 8f): " + (", ".join(
                        f"{k_} {v_} ms" for k_, v_ in parent.items()) or "not measured"))
            log(f"  flash_attention[{label}] (BH {bh}, N {nq}, D {d}, {kind}): kernel_ms "
                f"{ms:.4f} (serving {serve_ms:.4f}) plain_ms {plain_ms:.4f} sdpa_ms "
                f"{lib_ms:.4f} bound_ms {b_ms:.4f} ({b_by}); serving / sdpa "
                f"{serve_ms / lib_ms:.3f}, bound share {b_ms / serve_ms:.3f}")
            log(f"  flash_attention_bwd[{label}]: kernel_ms {bwd_ms:.4f} (no dropout "
                f"{bwd0_ms:.4f}) plain_ms {plain_bwd_ms:.4f} sdpa_backward_ms {lib_bwd_ms:.4f} "
                f"bound_ms {bb_ms:.4f} ({bb_by}); no dropout / sdpa {bwd0_ms / lib_bwd_ms:.3f}, "
                f"bound share {bb_ms / bwd0_ms:.3f}" + (
                    f"; dq in key order (--deterministic) {case['bwd_fixed_order_ms']:.4f}, "
                    f"{case['bwd_fixed_order_ms'] / bwd_ms:.3f}x" if fixed else ""))
            log(f"  SDPA takes its {case['sdpa_backend']} backend at DP {q.shape[-1]}"
                + (f"; at D {d} unpadded its {case['sdpa_unpadded_backend']} backend, forward "
                   f"{case['library_unpadded_ms']:.4f} ms, backward "
                   f"{case['bwd_library_unpadded_ms']:.4f} ms" if d < q.shape[-1] else ""))
            if 160 < d <= 256 and dtype == bf:
                parent = PARENT_WIDE_MS.get(d)
                log(f"  the parent design at head width {d}: "
                    + (f"backward {parent['bwd']} ms (no dropout {parent['bwd_no_dropout']}), "
                       f"forward serving {parent['serving']} ms, training not measured "
                       "(PERF.md row 8w)" if parent else "not measured"))
        del q, k, v, o, lse, do
        torch.cuda.empty_cache()
        return case

    def masks_bit_identical(label, bh, n, d, dtype):
        """q = 0 makes every probability 1/N and v[k] = e_(k mod D) makes o
        count the kept keys of each residue class: exact small integers
        times one scale, equal only if the masks are."""
        dp = -(-d // 32) * 32
        q = torch.zeros(bh, n, dp, dtype=dtype, device=DEVICE)
        v = torch.zeros_like(q)
        keys = torch.arange(n, device=DEVICE)
        v[:, keys, keys % d] = 1.0
        o_k = flash_fwd(q, q, v, d, 1, drop=drop)
        o_p = flash_fwd_plain(q, q, v, d, 1, drop=drop)
        torch.cuda.synchronize()
        if not torch.equal(o_k, o_p):
            raise AssertionError(f"flash_attention[{label}]: the kernel's keep mask differs")
        log(f"  flash_attention[{label}] keep mask: bit-identical to the plain version's "
            f"({bh} planes x {n} rows x {n} keys)")

    def masked_rows(d=E, dtype=bf):
        """Rows whose every key is masked (LSA at N 1: P spreads over the
        masked keys, keys past Nk weigh nothing) and key counts that fill no
        tile, forward and backward against the plain versions. At N 1 the
        row's P is 1 whatever its score, so dS = P (dP - delta) vanishes but
        for rounding: dq and dk are held to the tolerance of dv's scale."""
        tol = KERNEL_TOL if dtype == bf else F32_KERNEL_TOL
        for nq, lsa in ((1, True), (1, False), (70, True)):
            q, k, v = operands(8, nq, nq, d, dtype)
            (o, lse), (o_ref, lse_ref) = (fn(q, k, v, d, 4, with_lse=True, use_lsa=lsa)
                                          for fn in (flash_fwd, flash_fwd_plain))
            label = f"N {nq}{', lsa' if lsa else ''}" + (f", head width {d}" if d != E else "") \
                + (", fp32" if dtype == f32 else "")
            compare(f"flash_attention[{label}] o", o, o_ref, tol)
            compare(f"flash_attention[{label}] lse", lse, lse_ref, F32_KERNEL_TOL)
            do = torch.randn(o.shape, generator=gen).to(DEVICE, dtype)
            got = flash_bwd(q, k, v, o_ref, do, lse_ref, d, 4, use_lsa=lsa)
            ref = flash_bwd_plain(q, k, v, o_ref, do, lse_ref, d, 4, use_lsa=lsa)
            compare(f"flash_attention_bwd[{label}] dv", got[2], ref[2], tol)
            scale = ref[2].float().abs().max().item()
            for part, g_, r_ in zip(("dq", "dk"), got[:2], ref[:2]):
                err = (g_.float() - r_.float()).abs().max().item()
                ref_max = max(r_.float().abs().max().item(), scale if nq == 1 else 0.0)
                ok = torch.isfinite(g_.float()).all().item() and err <= tol * ref_max
                log(f"  flash_attention_bwd[{label}] {part}: max|d| {err:.3e}, of the scale "
                    f"{ref_max:.3e}: {err / max(ref_max, 1e-30):.3e} (tol {tol:g}) "
                    f"{'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(f"flash_attention_bwd[{label}] {part}")

    cases = {}
    cases["full_res"] = check("full-res, dropout", FR_B * H, H, FR_N, FR_N, E, bf, drp=drop,
                              timed=True, fixed=True)
    masks_bit_identical("full-res", FR_B * H, FR_N, E, bf)
    cases["fp32_flagship"] = check("fp32 flagship, dropout", B * H, H, N, N, E, f32, drp=drop,
                                   timed=True, fixed=True)
    masks_bit_identical("fp32 flagship", B * H, N, E, f32)
    cases["rectangular"] = check("rectangular, n_real_k 1300, dlse", 8, 4, 1000, 1500, 64, bf,
                                 n_real=1300, dlse=True)
    cases["lsa"] = check("lsa", 8, 4, N, N, E, bf, lsa=True, drp=drop)
    masked_rows()
    for d in (192, 224, 256):  # the sweep's widest heads (the wide tiles), batch 16 x 4 heads
        cases[f"head_{d}"] = check(f"head width {d}, batch 16", 16 * 4, 4, N, N, d, bf,
                                   drp=drop, timed=True, fixed=True)
        masks_bit_identical(f"head width {d}", 8, N, d, bf)
    # cct's heads (phase 5i): B 64 x 4 heads of 10, padded to DP 32, 576
    # tokens; one 64-byte row is one [R][32] sub-tile of the 64-byte swizzle
    cases["cct"] = check("cct, DP 32, dropout", B * 4, 4, CCT_N, CCT_N, CCT_D, bf, drp=drop,
                         timed=True, fixed=True)
    masks_bit_identical("cct DP 32", B * 4, CCT_N, CCT_D, bf)
    # phase 5d's grid (batch 64 x 4 heads at head width 256): each block of
    # the persistent forward walks ~4x the items it does at batch 16
    cases["head_256_batch_64"] = check("head width 256, batch 64", 64 * 4, 4, N, N, 256, bf,
                                       drp=drop)
    # the LSE form at the shapes full-resolution sequence parallelism over 2
    # ranks gives it (phase 5j): the all-gather's block (a rank's 17,057
    # queries against all 34,114 keys) and the ring's (17,057 x 17,057),
    # each with an LSE cotangent; and a block whose keys are all padding
    # (n_real_k 0: a finite LSE far below a real one's, P = 1 over the
    # masked keys in both versions) in bf16 and float32
    half = FR_N // 2
    cases["sp_allgather"] = check("SP all-gather block, 17057 x 34114, dlse", FR_B * H, H, half,
                                  FR_N, E, bf, dlse=True, timed=True)
    cases["sp_ring"] = check("SP ring block, 17057 x 17057, dlse", FR_B * H, H, half, half, E,
                             bf, dlse=True, timed=True)
    for dtype, kind in ((bf, "bf16"), (f32, "fp32")):
        cases[f"padding_block_{kind}"] = check(f"a block of padding keys, n_real_k 0, {kind}, "
                                               "dlse", 8, 4, 600, 700, E, dtype, n_real=0,
                                               dlse=True)
    log("phase 3d: the bf16 flash kernels past DP 256 (column groups) against their plain "
        "versions")
    for d in WIDE_DPS:
        cases[f"wide_{d}"] = check(f"head width {d}, batch 16, dropout", 16 * 4, 4, N, N, d, bf,
                                   drp=drop, timed=True, fixed=True)
        cases[f"wide_{d}_rect"] = check(f"head width {d}, rectangular 300 x 460, n_real_k 400, "
                                        "dlse, dropout", 8, 4, 300, 460, d, bf, n_real=400,
                                        dlse=True, drp=drop, fixed=True)
        cases[f"wide_{d}_lsa"] = check(f"head width {d}, lsa, no dropout", 8, 4, 333, 333, d, bf,
                                       lsa=True, fixed=True)
        masks_bit_identical(f"head width {d}", 4, 300, d, bf)
    # the widest cluster (8 groups, DP 2048) and past it (9 groups, DP 2080:
    # the groups recompute S)
    for d in (2048, 2080):
        cases[f"wide_{d}_rect"] = check(f"head width {d}, rectangular 300 x 460, n_real_k 400, "
                                        "dlse, dropout", 8, 4, 300, 460, d, bf, n_real=400,
                                        dlse=True, drp=drop, fixed=True)
        cases[f"wide_{d}_lsa"] = check(f"head width {d}, lsa, no dropout", 8, 4, 200, 200, d, bf,
                                       lsa=True, fixed=True)
        masks_bit_identical(f"head width {d}", 4, 300, d, bf)
    masked_rows(WIDE_EMB)
    cases["emb_768"] = check(f"emb {WIDE_EMB}: batch 64 x {H} heads of {WIDE_EMB}, dropout",
                             B * H, H, N, N, WIDE_EMB, bf, drp=drop, timed=True, fixed=True)
    log("phase 3d: the float32 flash kernels past DP 256 (column groups) against their plain "
        "versions")
    for d in WIDE_DPS:
        cases[f"f32wide_{d}"] = check(f"fp32 head width {d}, batch 16, dropout", 16 * 4, 4, N, N,
                                      d, f32, drp=drop, timed=True, fixed=True, iters=3)
        cases[f"f32wide_{d}_rect"] = check(
            f"fp32 head width {d}, rectangular 300 x 460, n_real_k 400, dlse, dropout", 8, 4,
            300, 460, d, f32, n_real=400, dlse=True, drp=drop, fixed=True)
        cases[f"f32wide_{d}_lsa"] = check(f"fp32 head width {d}, lsa, no dropout", 8, 4, 333,
                                          333, d, f32, lsa=True, fixed=True)
        masks_bit_identical(f"fp32 head width {d}", 4, 300, d, f32)
    # the widest cluster (8 groups, DP 2048) and past it (9 groups, DP 2080:
    # the FFMA column groups)
    for d in (2048, 2080):
        cases[f"f32wide_{d}_rect"] = check(
            f"fp32 head width {d}, rectangular 300 x 460, n_real_k 400, dlse, dropout", 8, 4,
            300, 460, d, f32, n_real=400, dlse=True, drp=drop, fixed=True)
        cases[f"f32wide_{d}_lsa"] = check(f"fp32 head width {d}, lsa, no dropout", 8, 4, 200,
                                          200, d, f32, lsa=True, fixed=True)
    masks_bit_identical("fp32 head width 2080", 4, 300, 2080, f32)
    masked_rows(WIDE_EMB, f32)
    cases["f32wide_padding_block"] = check(
        f"fp32 head width {WIDE_EMB}, a block of padding keys, n_real_k 0, dlse", 8, 4, 600, 700,
        WIDE_EMB, f32, n_real=0, dlse=True, fixed=True)
    cases["f32emb_768"] = check(f"fp32 emb {WIDE_EMB}: batch 64 x {H} heads of {WIDE_EMB}, "
                                "dropout", B * H, H, N, N, WIDE_EMB, f32, drp=drop, timed=True,
                                fixed=True, iters=2)
    full = cases["full_res"]
    rows = []
    for name, src, replaces, pre in (
            ("flash_attention", "flash_attention.cu",
             "v1t_tpu/ops/flash_attention.py:435 (_flash_forward -> _fwd_kernel_fullk :279, "
             "_fwd_kernel :225); :603 (_flash_forward_dt -> _fwd_kernel_dt :545)", ""),
            ("flash_attention_bwd", "flash_attention_bwd.cu",
             "v1t_tpu/ops/flash_attention.py:1088 (_flash_backward); :1040 "
             "(_merged_bwd_kernel :954); :769 (_flash_backward_dt)", "bwd_")):
        rows.append(dict(
            name=name, route="cuda", source=f"v1t_tpu_torch/csrc/{src}", replaces=replaces,
            max_abs_err=full[f"{pre}max_abs_err"], rel_err=full[f"{pre}rel_err"],
            ms=full[f"{pre}ms"], plain_ms=full[f"{pre}plain_ms"],
            bound_ms=full[f"{pre}bound_ms"], bound_by=full[f"{pre}bound_by"],
            library_ms=full[f"{pre}library_ms"],
            library="F.scaled_dot_product_attention" + (" (autograd backward)" if pre else ""),
            ms_like_for_like=full["bwd_no_dropout_ms" if pre else "serving_ms"],
            like_for_like="no dropout" + ("" if pre else ", no LSE (serving)"),
            fp32={key: cases["fp32_flagship"][pre + key] for key in (
                "ms", "bound_ms", "library_ms", "plain_ms")
                + (("no_dropout_ms", "fixed_order_ms") if pre else ("serving_ms",))},
            **({"fixed_order_ms": full["bwd_fixed_order_ms"],
                "fixed_order": "dq added in key order under PyTorch's deterministic mode "
                               "(timed without its buffer fill); per_case holds it at each "
                               "shape as bwd_fixed_order_ms"} if pre else {}),
            note="times at the full-resolution shape (BH 8, N 34114, D 155, bf16, dropout "
                 "on; ms_like_for_like without dropout, as the library call runs); per_case "
                 "holds the fp32 flagship's and, at head widths 192, 224 and 256 (the wide "
                 "tiles; B*H 64, N 1654), ms is the training forward (dropout, LSE); "
                 "head_256_batch_64 is the check at phase 5d's B*H 256, untimed; cct is "
                 "phase 5i's shape (B*H 256, N 576, D 10 padded to 32), with SDPA's times "
                 "and backend also at the unpadded D; sp_allgather and sp_ring are the LSE "
                 "form at full-resolution SP 2's blocks (BH 8, Nq 17057 x Nk 34114 and "
                 "17057 x 17057, D 155, bf16, an LSE cotangent, no dropout), "
                 "padding_block_bf16 / _fp32 a block of keys all padding (checked, untimed); "
                 "launches_by_path holds each rank's SP and DP counts (phase 5j)",
            per_case={k: v for k, v in cases.items()
                      if not k.startswith(("wide_", "emb_", "f32wide_", "f32emb_"))}))
    wide = cases["emb_768"]
    for name, src, replaces, pre in (
            ("flash_attention (column groups, DP > 256)", "flash_attention.cu",
             "v1t_tpu/ops/flash_attention.py:279 (_fwd_kernel_fullk); v1t_tpu/ops/fused_mha.py:567 "
             "(_mha_fwd_kernel_dt2, attention core)", ""),
            ("flash_attention_bwd (column groups, DP > 256)", "flash_attention_bwd.cu",
             "v1t_tpu/ops/flash_attention.py:954 (_merged_bwd_kernel); "
             "v1t_tpu/ops/fused_mha.py:676 (_mha_bwd_kernel_dt2, attention core)", "bwd_")):
        rows.append(dict(
            name=name, counter=name.split(" ")[0], main_path="wide_training", route="cuda",
            source=f"v1t_tpu_torch/csrc/{src}", replaces=replaces,
            max_abs_err=max(c[f"{pre}max_abs_err"] for k, c in cases.items()
                            if k.startswith(("wide_", "emb_"))),
            rel_err=max(c[f"{pre}rel_err"] for k, c in cases.items()
                        if k.startswith(("wide_", "emb_"))),
            ms=wide[f"{pre}ms"], plain_ms=wide[f"{pre}plain_ms"],
            bound_ms=wide[f"{pre}bound_ms"], bound_by=wide[f"{pre}bound_by"],
            library_ms=wide[f"{pre}library_ms"],
            library="F.scaled_dot_product_attention" + (" (autograd backward)" if pre else "")
                    + f" ({wide['sdpa_backend']} backend at DP {WIDE_EMB})",
            ms_like_for_like=wide["bwd_no_dropout_ms" if pre else "serving_ms"],
            like_for_like="no dropout" + ("" if pre else ", no LSE (serving)"),
            **({"fixed_order_ms": wide["bwd_fixed_order_ms"]} if pre else {}),
            note=f"times at the emb-{WIDE_EMB} path's shape (B*H {B * H}, N {N}, D {WIDE_EMB}, "
                 "bf16, dropout on; ms_like_for_like without dropout, as the library call "
                 "runs); max_abs_err the largest over every column-group case; per_case holds "
                 "head widths 288, 384, 512, 768 and 1024 at B*H 64 (timed), rectangular with "
                 "n_real_k and an LSE cotangent, and LSA, also at 2048 (a cluster of 8) and "
                 "2080 (past 8 groups) (checked)",
            per_case={k: v for k, v in cases.items() if k.startswith(("wide_", "emb_"))}))
    wide = cases["f32emb_768"]
    f32_cases = {k: v for k, v in cases.items() if k.startswith(("f32wide_", "f32emb_"))}
    for name, replaces, pre in (
            ("flash_attention (float32 column groups, DP > 256)",
             "v1t_tpu/ops/flash_attention.py:615 (_flash_forward_dt -> _fwd_kernel_dt :545); "
             ":458 / :491 (_fwd_kernel_fullk :279, _fwd_kernel :225)", ""),
            ("flash_attention_bwd (float32 column groups, DP > 256)",
             "v1t_tpu/ops/flash_attention.py:786 / :811 (_flash_backward_dt -> _dq_kernel_dt "
             ":646, _dkv_kernel_dt :702); :1052 (_merged_bwd_kernel :954)", "bwd_")):
        rows.append(dict(
            name=name, counter=name.split(" ")[0], main_path="fp32_wide_training", route="cuda",
            source="v1t_tpu_torch/csrc/" + ("flash_attention_bwd.cu" if pre else
                                            "flash_attention.cu"),
            replaces=replaces,
            max_abs_err=max(c[f"{pre}max_abs_err"] for c in f32_cases.values()),
            rel_err=max(c[f"{pre}rel_err"] for c in f32_cases.values()),
            ms=wide[f"{pre}ms"], plain_ms=wide[f"{pre}plain_ms"],
            bound_ms=wide[f"{pre}bound_ms"], bound_by=wide[f"{pre}bound_by"],
            library_ms=wide[f"{pre}library_ms"],
            library="F.scaled_dot_product_attention" + (" (autograd backward)" if pre else "")
                    + f" in float32 ({wide['sdpa_backend']} backend at DP {WIDE_EMB})",
            ms_like_for_like=wide["bwd_no_dropout_ms" if pre else "serving_ms"],
            like_for_like="no dropout" + ("" if pre else ", no LSE (serving)"),
            bound_tf32_ms=wide[f"{pre}bound_tf32_ms"],
            bound_tf32="the products three times (3xTF32) at 495 TFLOP/s dense TF32",
            **({"fixed_order_ms": wide["bwd_fixed_order_ms"]} if pre else {}),
            note=f"times at the fp32 emb-{WIDE_EMB} path's shape (B*H {B * H}, N {N}, D "
                 f"{WIDE_EMB}, float32, dropout on; ms_like_for_like without dropout, as the "
                 "library call runs); 3xTF32 in a cluster of the column groups up to 8 groups, "
                 "FFMA past them; max_abs_err the largest over every float32 column-group "
                 "case; per_case holds head widths 288, 384, 512, 768 and 1024 at B*H 64 "
                 "(timed), rectangular with n_real_k and an LSE cotangent, LSA, 2048 (a "
                 "cluster of 8) and 2080 (past 8 groups) and a block of padding keys (checked)",
            per_case=f32_cases))
    return rows


def check_wide_projections(gen: torch.Generator) -> list:
    """Phase 3d: the projections past the panels' LayerNorm width (K > 640)
    against their plain versions at K 672, 768 and 1024: ln_linear's
    LayerNorm with bias_row into the head-major QKV output and with bias,
    GELU, the keep mask and the saved pre-GELU activation (fc1); and
    ln_linear_bwd's dX with the LayerNorm backward on the wgmma kernel (a
    cluster's row sums) for a head-major dY with bias_row and the residual's
    cotangent, and fc1's row-major dY; each dX twice, bit for bit (its sums
    are fixed-order). At K 768 the emb-768 path's rows (B 64 x 1654) and
    times beside the bound, the plain version and the library (F.layer_norm
    + F.linear; the product dY W on the materialised dY); 8 x 1654 rows at
    the other widths, checked and timed alike; the dX also at
    DLN_GLOBAL_K, past one cluster (the mma.sync kernel). Then the plain
    form (check_wide_plain_dx)."""
    from v1t_tpu_torch.ops.dropout import Dropout
    from v1t_tpu_torch.ops.ln_linear import (
        _masked_dy, dx_plan, linear_plan, ln_linear, ln_linear_bwd, ln_linear_bwd_plain,
        ln_linear_plain,
    )

    log("phase 3d: the projections' LayerNorm past K 640 against their plain versions")
    bf = torch.bfloat16

    def randn(*shape, scale=1.0, dtype=bf):
        return (torch.randn(*shape, generator=gen) * scale).to(DEVICE, dtype)

    def check_dx(k, b, x, row, gamma, beta, wqkv, w1, cases):
        """The dX with the LayerNorm backward at K over b x N rows into
        ``cases``: dY head-major (zero past no column: D = DP here) with
        bias_row and the residual's cotangent, and fc1's row-major dY with
        the residual's; twice, bit for bit; timed beside the bound, the
        plain version and the library."""
        m, hid = b * N, 4 * k
        dres = randn(b, N, k)
        uses_b = {"qkv": dict(dy=randn(3, b, H, N, k), w=wqkv, heads=(H, k), x=x, pro_row=row,
                              gamma=gamma, beta=beta, dres=dres),
                  "fc1": dict(dy=randn(b, N, hid, scale=0.2), w=w1, x=x, gamma=gamma, beta=beta,
                              dres=dres)}
        names = ("dz", "ln_out", "dgamma", "dbeta", "dbias_row")
        for use, kw in uses_b.items():
            args = {n_: v for n_, v in kw.items() if n_ not in ("dy", "w")}
            label = f"ln_linear_bwd[{use}, K {k}]"
            ref = ln_linear_bwd_plain(kw["dy"], kw["w"], **args)
            got = ln_linear_bwd(kw["dy"], kw["w"], **args)
            errs = [compare(f"{label} {n_}", g_, r_, KERNEL_TOL)
                    for n_, g_, r_ in zip(names, got, ref) if r_ is not None]
            errs.append(fixed_order_twice(label, lambda: ln_linear_bwd(kw["dy"], kw["w"], **args),
                                          ref, KERNEL_TOL, names))
            err = max(errs)
            nout = kw["w"].shape[0]
            moved = m * nout * 2 + nbytes(kw["w"], *(g_ for g_ in got if g_ is not None), x,
                                          kw.get("pro_row"), gamma, beta, dres)
            b_ms, b_by = bound(moved, 2.0 * m * nout * k, "bf16")
            del got, ref
            plan = dx_plan(k, nout, True, True)
            ms = cuda_ms(lambda: ln_linear_bwd(kw["dy"], kw["w"], **args))
            plain_ms = cuda_ms(lambda: ln_linear_bwd_plain(kw["dy"], kw["w"], **args), iters=1)
            dy_rm = _masked_dy(kw["dy"], kw.get("heads"), None).reshape(m, nout)
            lib_ms = cuda_ms(lambda: torch.matmul(dy_rm, kw["w"]))
            del dy_rm
            cases[f"{use}_{k}"] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                                       bound_ms=b_ms, bound_by=b_by, max_abs_err=err[0],
                                       rel_err=err[1], rows=m, plan=plan._asdict())
            form = (f"the wgmma kernel, tiles of {plan.rows} rows x 256 columns, a cluster of "
                    f"{plan.cluster} blocks a row" if plan.wgmma else
                    f"the mma.sync kernel, {plan.k_tiles} tiles of {plan.rows} rows x 160 "
                    "columns, the d(ln) rows in device memory")
            log(f"  {label} ({m}x{nout} @ {nout}x{k}; {form}): kernel_ms {ms:.4f} plain_ms "
                f"{plain_ms:.4f} matmul_ms {lib_ms:.4f} bound_ms {b_ms:.4f} ({b_by}); kernel / "
                f"library {ms / lib_ms:.3f}, bound share {b_ms / ms:.3f}")
        del dres, uses_b

    fwd_cases, bwd_cases = {}, {}
    for k in WIDE_KS:
        b = B if k == WIDE_EMB else 8
        m, hid = b * N, 4 * k
        x = randn(b, N, k)
        row = randn(b, k, scale=0.5)
        gamma = 1.0 + randn(k, scale=0.1, dtype=torch.float32)
        beta = randn(k, scale=0.1, dtype=torch.float32)
        wqkv = randn(3 * H * k, k, scale=k ** -0.5)
        w1 = randn(hid, k, scale=k ** -0.5)
        b1 = randn(hid, scale=0.1, dtype=torch.float32)
        drop1 = Dropout(T_DROP, 20261017, 2)
        uses = {"qkv": dict(x=x, w=wqkv, gamma=gamma, beta=beta, pro_row=row, heads=(H, k)),
                "fc1": dict(x=x, w=w1, gamma=gamma, beta=beta, bias=b1, gelu=True, drop=drop1,
                            save_pre=True)}
        for use, kw in uses.items():
            args = {n_: v for n_, v in kw.items() if n_ not in ("x", "w")}
            got = ln_linear(kw["x"], kw["w"], **args)
            ref = ln_linear_plain(kw["x"], kw["w"], **args)
            label = f"ln_linear[{use}, K {k}]"
            if use == "fc1":
                compare(f"{label} pre-GELU", got[1], ref[1], KERNEL_TOL)
                torch.cuda.synchronize()
                # the dropped elements are the zeros, and so are GELU's own:
                # where the float32 pre-GELU sum is exactly 0 (read once at
                # K 672, 0 against -5.1e-7, the summation orders apart) and
                # where float32 exact-erf GELU saturates to 0; every other
                # element is compared
                sat = gelu_saturation()
                live = (got[1] != 0) & (ref[1] != 0) & (got[1] > sat) & (ref[1] > sat)
                differ = ((got[0] == 0) & live) != ((ref[0] == 0) & live)
                if differ.any():
                    at = differ.nonzero()[:6].tolist()
                    raise AssertionError(
                        f"{label}: the keep masks differ at {int(differ.sum())} elements: "
                        + "; ".join(f"{i} pre {got[1][tuple(i)].item():.4g} / "
                                    f"{ref[1][tuple(i)].item():.4g}, out "
                                    f"{got[0][tuple(i)].item():.4g} / {ref[0][tuple(i)].item():.4g}"
                                    for i in at))
                log(f"  {label} keep mask: bit-identical to the plain version's (the "
                    f"{int((~live).sum())} elements whose pre-GELU value is 0 or at most "
                    f"{sat:.5f}, where GELU saturates, left out)")
                got, ref = got[0], ref[0]
            err = compare(label, got, ref, KERNEL_TOL)
            nout = kw["w"].shape[0]
            b_ms, b_by = bound(nbytes(x, kw["w"], got, kw.get("pro_row")) * 1.0
                               + (m * nout * 2 if use == "fc1" else 0), 2.0 * m * nout * k,
                               "bf16")
            del got, ref
            plan = linear_plan(m, nout, k, kw.get("heads"), True, True, False)
            ms = cuda_ms(lambda: ln_linear(kw["x"], kw["w"], **args))
            plain_ms = cuda_ms(lambda: ln_linear_plain(kw["x"], kw["w"], **args), iters=1)
            lib_kw = {n_: v for n_, v in kw.items() if n_ not in ("heads", "drop", "save_pre")}
            lib_ms = cuda_ms(lambda: torch_ln_linear(lib_kw))
            fwd_cases[f"{use}_{k}"] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                                           bound_ms=b_ms, bound_by=b_by, max_abs_err=err[0],
                                           rel_err=err[1], rows=m, plan=plan._asdict())
            log(f"  {label} ({m}x{k} @ {k}x{nout}; the LayerNorm's rows first, then the wgmma "
                f"kernel, {plan.tiles} tiles of {plan.tile} a row tile): kernel_ms {ms:.4f} plain_ms "
                f"{plain_ms:.4f} layer_norm+linear_ms {lib_ms:.4f} bound_ms {b_ms:.4f} "
                f"({b_by}); kernel / library {ms / lib_ms:.3f}, bound share {b_ms / ms:.3f}")
        check_dx(k, b, x, row, gamma, beta, wqkv, w1, bwd_cases)
        del x, row, wqkv, w1, uses
        torch.cuda.empty_cache()
    # a LayerNorm past one cluster's 8 x 256 columns (no configuration):
    # the mma.sync form, its fp32 d(ln) rows in device memory
    k, b = DLN_GLOBAL_K, 8
    dln_cases = {}
    f32 = torch.float32
    check_dx(k, b, randn(b, N, k), randn(b, k, scale=0.5), 1.0 + randn(k, scale=0.1, dtype=f32),
             randn(k, scale=0.1, dtype=f32), randn(3 * H * k, k, scale=k ** -0.5),
             randn(4 * k, k, scale=k ** -0.5), dln_cases)
    torch.cuda.empty_cache()
    plain_cases = check_wide_plain_dx(randn)
    res_cases = check_wide_residual_forward(randn)
    rows = []
    for name, counter, cases, src, replaces, lib in (
            ("ln_linear (LayerNorm past K 640, wgmma)", "ln_linear:fwd_wgmma_layernorm", fwd_cases,
             "ln_linear.cu",
             "v1t_tpu/ops/fused_mha.py:567 (_mha_fwd_kernel_dt2: +bias_row, LayerNorm, QKV); "
             "v1t_tpu/ops/fused_mlp.py:111 (_mlp_fwd_kernel: LayerNorm, fc1, GELU)",
             "F.layer_norm + F.linear (bf16)"),
            ("ln_linear_bwd (LayerNorm past K 640)", "ln_linear_bwd:wgmma_layernorm", bwd_cases,
             "ln_linear_bwd.cu",
             "v1t_tpu/ops/fused_mha.py:676 (_mha_bwd_kernel_dt2: QKV dX + LayerNorm backward); "
             "v1t_tpu/ops/fused_mlp.py:150 (_mlp_bwd_kernel: fc1 dX + LayerNorm backward)",
             "torch.matmul(dY, W) on the materialised row-major dY")):
        at = [cases[f"{use}_{WIDE_EMB}"] for use in ("qkv", "fc1")]
        rows.append(dict(
            name=name, counter=counter, main_path="wide_training", route="cuda",
            source=f"v1t_tpu_torch/csrc/{src}", replaces=replaces,
            max_abs_err=max(c["max_abs_err"] for c in cases.values()),
            rel_err=max(c["rel_err"] for c in cases.values()),
            ms=sum(c["ms"] for c in at), plain_ms=sum(c["plain_ms"] for c in at),
            bound_ms=sum(c["bound_ms"] for c in at),
            bound_by="bytes" if {c["bound_by"] for c in at} == {"bytes"} else "operations",
            library_ms=sum(c["library_ms"] for c in at), library=lib,
            note=f"times summed over qkv and fc1 at emb {WIDE_EMB} (B {B} x {N} rows); "
                 "per_case holds each use at K 672, 768 and 1024", per_case=cases))
    rows[-1]["past_one_cluster"] = dict(
        note=f"K {DLN_GLOBAL_K}, 8 x {N} rows, qkv and fc1: not the wgmma kernel but the "
             "mma.sync one with its fp32 d(ln) rows in device memory (a LayerNorm past 8 x 256)",
        per_case=dln_cases)
    at = [res_cases[f"{use}_{WIDE_MLP}"] for use in ("out_proj", "fc2")]
    rows.append(dict(
        name="ln_linear (residual past K 640, wgmma)", counter="ln_linear:fwd_wgmma_plain",
        main_path="wide_training", route="cuda", source="v1t_tpu_torch/csrc/ln_linear.cu",
        replaces="v1t_tpu/ops/fused_mha.py:567 (_mha_fwd_kernel_dt2: the out-projection + "
                 "bias + residual); v1t_tpu/ops/fused_mlp.py:111 (_mlp_fwd_kernel: fc2 + b2 + "
                 "residual)",
        max_abs_err=max(c["max_abs_err"] for c in res_cases.values()),
        rel_err=max(c["rel_err"] for c in res_cases.values()),
        ms=sum(c["ms"] for c in at), plain_ms=sum(c["plain_ms"] for c in at),
        bound_ms=sum(c["bound_ms"] for c in at),
        bound_by="bytes" if {c["bound_by"] for c in at} == {"bytes"} else "operations",
        library_ms=sum(c["library_ms"] for c in at),
        library="F.linear + the residual's add (bf16)",
        note=f"times summed over the out-projection and fc2 at emb {WIDE_EMB} (K {WIDE_MLP}, "
             f"B {B} x {N} rows, dropout on); per_case holds each also at K 1030",
        per_case=res_cases))
    at = [plain_cases[f"{use}_{WIDE_MLP}"] for use in ("out_proj", "fc2")]
    rows.append(dict(
        name="ln_linear_bwd (plain dX past K 640)", counter="ln_linear_bwd:wgmma_plain",
        main_path="wide_training", route="cuda", source="v1t_tpu_torch/csrc/ln_linear_bwd.cu",
        replaces="v1t_tpu/ops/fused_mha.py:676 (_mha_bwd_kernel_dt2: the out-projection's "
                 "masked cotangent, do = Wp dout); v1t_tpu/ops/fused_mlp.py:150 "
                 "(_mlp_bwd_kernel: fc2's da with fc1's keep mask and GELU')",
        max_abs_err=max(c["max_abs_err"] for c in plain_cases.values()),
        rel_err=max(c["rel_err"] for c in plain_cases.values()),
        ms=sum(c["ms"] for c in at), plain_ms=sum(c["plain_ms"] for c in at),
        bound_ms=sum(c["bound_ms"] for c in at),
        bound_by="bytes" if {c["bound_by"] for c in at} == {"bytes"} else "operations",
        library_ms=sum(c["library_ms"] for c in at),
        library="torch.matmul(dY, W) on the unmasked row-major dY",
        note=f"times summed over the out-projection's and fc2's dX at emb {WIDE_EMB} (K "
             f"{WIDE_MLP}, B {B} x {N} rows); per_case holds each also at K 1030",
        per_case=plain_cases))
    return rows


def check_wide_plain_dx(randn) -> dict:
    """Phase 3d, the plain form of ln_linear_bwd's dX past K 640 on the
    wgmma kernel: the out-projection's dX with dY's keep mask and fc2's with
    GELU'(pre) and fc1's keep mask, at the emb-768 path's K 3072 (B 64 x
    1654 rows) and at K 1030 (8 x 1654 rows; no multiple of 256, fc2 over a
    155-wide dY that is not 16-byte aligned), against the plain version,
    twice bit for bit, the keep masks bit-identical, timed beside the bound,
    the plain version and torch.matmul(dY, W)."""
    from v1t_tpu_torch.ops.dropout import Dropout
    from v1t_tpu_torch.ops.ln_linear import (
        _masked_dy, dx_plan, ln_linear_bwd, ln_linear_bwd_plain,
    )

    drop_o, drop1, drop2 = (Dropout(T_DROP, 20261017, site) for site in (1, 2, 3))
    cases = {}
    for use, k, nout in (("out_proj", WIDE_MLP, WIDE_EMB), ("fc2", WIDE_MLP, WIDE_EMB),
                         ("out_proj", 1030, WIDE_EMB), ("fc2", 1030, E)):
        b = B if k == WIDE_MLP else 8
        m = b * N
        dy, w = randn(b, N, nout), randn(nout, k, scale=nout ** -0.5)
        kw = (dict(drop=drop_o) if use == "out_proj"
              else dict(drop=drop2, pre=randn(b, N, k), pre_drop=drop1))
        label = f"ln_linear_bwd[{use}, K {k}]"
        ref = ln_linear_bwd_plain(dy, w, **kw)
        got = ln_linear_bwd(dy, w, **kw)
        err = max(compare(label, got, ref, KERNEL_TOL),
                  fixed_order_twice(label, lambda: ln_linear_bwd(dy, w, **kw), (ref,),
                                    KERNEL_TOL, ("dx",)))
        # the keep masks, through a W whose column j selects dY's column j
        # mod N: the out-projection's dX is dY' itself, column by column;
        # fc2's, at a pre-activation of 1 (GELU' 1.083), is zero exactly
        # where either mask drops, in every column
        cols = torch.arange(k, device=w.device)
        eye = torch.zeros(nout, k, dtype=w.dtype, device=w.device)
        eye[cols % nout, cols] = 1
        if use == "fc2":
            ones = torch.ones_like(kw["pre"])
            through = ln_linear_bwd(dy, eye, **{**kw, "pre": ones})
            plain = ln_linear_bwd_plain(dy, eye, **{**kw, "pre": ones})
            torch.cuda.synchronize()
            if not torch.equal(through == 0, plain == 0):
                raise AssertionError(f"{label}: the keep masks differ at "
                                     f"{int(((through == 0) != (plain == 0)).sum())} elements")
            # on the random inputs a zero may also be a product's rounding:
            # those elements are shown, the masks are the identity case's
            differ = (got == 0) != (ref == 0)
            worst = max(got[differ].float().abs().max().item() if differ.any() else 0.0,
                        ref[differ].float().abs().max().item() if differ.any() else 0.0)
            log(f"  {label} keep masks (dY's and fc1's): bit-identical to the plain version's "
                f"(through a selecting W at pre 1, {int((plain == 0).sum())} zeros); on the "
                f"random inputs {int(differ.sum())} elements are 0 on one side only, the "
                f"largest {worst:.3e} against max|ref| {ref.float().abs().max().item():.3e}")
            del ones, plain
        else:
            through = ln_linear_bwd(dy, eye, **kw)
            torch.cuda.synchronize()
            if not torch.equal(through, _masked_dy(dy, None, drop_o)[..., cols % nout]):
                raise AssertionError(f"{label}: dY's keep mask differs from the plain one")
            log(f"  {label} dY's keep mask: bit-identical to the plain version's (dX through a "
                "W that selects dY's columns equals the plain dY')")
        del cols, eye, through
        b_ms, b_by = bound(nbytes(dy, w, got, kw.get("pre")), 2.0 * m * nout * k, "bf16")
        del got, ref
        plan = dx_plan(k, -(-nout // 32) * 32, nout % 8 == 0, False)
        ms = cuda_ms(lambda: ln_linear_bwd(dy, w, **kw))
        plain_ms = cuda_ms(lambda: ln_linear_bwd_plain(dy, w, **kw), iters=1)
        dy_rm = dy.reshape(m, nout)
        lib_ms = cuda_ms(lambda: torch.matmul(dy_rm, w))
        cases[f"{use}_{k}"] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                                   bound_by=b_by, max_abs_err=err[0], rel_err=err[1], rows=m,
                                   plan=plan._asdict())
        log(f"  {label} ({m}x{nout} @ {nout}x{k}; the wgmma kernel, {plan.k_tiles} tiles of "
            f"{plan.rows} rows x 256 columns a row, dY' masked once first): kernel_ms {ms:.4f} "
            f"plain_ms {plain_ms:.4f} matmul_ms {lib_ms:.4f} bound_ms {b_ms:.4f} ({b_by}); "
            f"kernel / library {ms / lib_ms:.3f}, bound share {b_ms / ms:.3f}")
        del dy, w, kw, dy_rm
        torch.cuda.empty_cache()
    return cases


def check_wide_residual_forward(randn) -> dict:
    """Phase 3d, ln_linear's residual form past K 640 on the wgmma kernel:
    the out-projection (bias, the output's keep mask, the residual and
    bias_row) and fc2 (bias, keep mask, residual) at the emb-768 path's K
    3072 (B 64 x 1654 rows, N 768) and at K 1030 (8 x 1654 rows; x padded
    to aligned rows, fc2 into the flagship's 155 columns: rows that are not
    16-byte aligned), against the plain version, twice bit for bit, the
    keep mask bit-identical (a bias of 1000 leaves a zero only where the
    mask drops), timed beside the bound, the plain version and F.linear +
    the residual's add."""
    from v1t_tpu_torch.ops.dropout import Dropout
    from v1t_tpu_torch.ops.ln_linear import linear_plan, ln_linear, ln_linear_plain

    drop_o, drop2 = Dropout(T_DROP, 20261017, 1), Dropout(T_DROP, 20261017, 3)
    cases = {}
    for use, k, nout in (("out_proj", WIDE_MLP, WIDE_EMB), ("fc2", WIDE_MLP, WIDE_EMB),
                         ("out_proj", 1030, WIDE_EMB), ("fc2", 1030, E)):
        b = B if k == WIDE_MLP else 8
        m = b * N
        x, w = randn(b, N, k), randn(nout, k, scale=k ** -0.5)
        bias = randn(nout, scale=0.1, dtype=torch.float32)
        res = randn(b, N, nout)
        kw = dict(bias=bias, residual=res, drop=drop_o if use == "out_proj" else drop2)
        if use == "out_proj":
            kw["res_row"] = randn(b, nout, scale=0.5)
        label = f"ln_linear[{use}, K {k}]"
        ref = ln_linear_plain(x, w, **kw)
        got = ln_linear(x, w, **kw)
        err = compare(label, got, ref, KERNEL_TOL)
        again = ln_linear(x, w, **kw)
        torch.cuda.synchronize()
        if not torch.equal(again, got):
            raise AssertionError(f"{label}: two runs differ")
        mask_kw = dict(kw, bias=torch.full_like(bias, 1000.0), residual=torch.zeros_like(res),
                       res_row=None)
        through, plain = ln_linear(x, w, **mask_kw), ln_linear_plain(x, w, **mask_kw)
        torch.cuda.synchronize()
        if not torch.equal(through == 0, plain == 0):
            raise AssertionError(f"{label}: the keep masks differ at "
                                 f"{int(((through == 0) != (plain == 0)).sum())} elements")
        log(f"  {label}: twice bit for bit; the keep mask bit-identical to the plain "
            f"version's ({int((plain == 0).sum())} dropped of {plain.numel()})")
        del through, plain, mask_kw, again
        b_ms, b_by = bound(nbytes(x, w, res, got, kw.get("res_row")), 2.0 * m * nout * k,
                           "bf16")
        del got, ref
        plan = linear_plan(m, nout, k, None, False, k % 8 == 0, True)
        ms = cuda_ms(lambda: ln_linear(x, w, **kw))
        plain_ms = cuda_ms(lambda: ln_linear_plain(x, w, **kw), iters=1)
        lib_kw = dict(x=x, w=w, bias=bias, residual=res, res_row=kw.get("res_row"))
        lib_ms = cuda_ms(lambda: torch_ln_linear(lib_kw))
        cases[f"{use}_{k}"] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                                   bound_by=b_by, max_abs_err=err[0], rel_err=err[1], rows=m,
                                   plan=None if plan is None else plan._asdict())
        log(f"  {label} ({m}x{k} @ {k}x{nout}, + residual; the wgmma kernel, "
            + (f"{plan.tiles} tiles of {plan.tile} a row tile" if plan else
               "x padded to aligned rows first")
            + f"): kernel_ms {ms:.4f} plain_ms {plain_ms:.4f} linear+residual_ms {lib_ms:.4f} "
            f"bound_ms {b_ms:.4f} ({b_by}); kernel / library {ms / lib_ms:.3f}, bound share "
            f"{b_ms / ms:.3f}")
        del x, w, res, kw, lib_kw
        torch.cuda.empty_cache()
    return cases


@functools.lru_cache(maxsize=None)
def gelu_saturation() -> float:
    """The largest saved (bf16) pre-GELU value whose float32 GELU may be
    exactly 0: the largest point on the card where either exact-erf form
    (the kernel's 0.5 x (1 + erf(x / sqrt 2)), the plain version's
    ``F.gelu``) gives 0, plus one bf16 step there (the saved value's
    rounding)."""
    import torch.nn.functional as F

    x = torch.linspace(-6.0, -5.0, (1 << 20) + 1, device=DEVICE)
    zero = (F.gelu(x) == 0) | (0.5 * x * (1.0 + torch.erf(x * 0.70710678118654752)) == 0)
    return x[zero].max().item() + 2.0 ** -5


def check_path_shapes(gen: torch.Generator) -> None:
    """The kernels of rows 3-6 at the shapes the composed paths give them:
    the full-resolution MLP (fc1, and fc2 without the folded residual,
    68,228 rows, dropout on) forward and backward, the sampling of its
    137x249 map, and the fp32 flagship's float32 map."""
    from v1t_tpu_torch.ops.dropout import Dropout
    from v1t_tpu_torch.ops.interp_matmul import (
        bilinear_sample_cm, bilinear_sample_cm_bwd, bilinear_sample_cm_bwd_plain,
        bilinear_sample_cm_plain,
    )
    from v1t_tpu_torch.ops.ln_linear import (
        ln_linear, ln_linear_bwd, ln_linear_bwd_plain, ln_linear_plain, ln_linear_wgrad,
        ln_linear_wgrad_plain,
    )

    log("phase 3c: rows 3-6 at the composed paths' shapes")
    bf, f32 = torch.bfloat16, torch.float32

    def randn(*shape, scale=1.0, dtype=bf):
        return (torch.randn(*shape, generator=gen) * scale).to(DEVICE, dtype)

    x = randn(FR_B, FR_N, E)
    gamma, beta = 1.0 + randn(E, scale=0.1, dtype=f32), randn(E, scale=0.1, dtype=f32)
    w1, b1 = randn(F_HID, E, scale=0.08), randn(F_HID, scale=0.1, dtype=f32)
    w2, b2 = randn(E, F_HID, scale=0.05), randn(E, scale=0.1, dtype=f32)
    drop1, drop2 = Dropout(T_DROP, 20261017, 2), Dropout(T_DROP, 20261017, 3)
    fc1 = dict(gamma=gamma, beta=beta, bias=b1, gelu=True, drop=drop1, save_pre=True)
    (h, pre), (h_ref, pre_ref) = ln_linear(x, w1, **fc1), ln_linear_plain(x, w1, **fc1)
    compare("ln_linear[full-res fc1, train]", h, h_ref, KERNEL_TOL)
    compare("ln_linear[full-res fc1, train] pre-GELU", pre, pre_ref, KERNEL_TOL)
    fc2 = dict(bias=b2, drop=drop2)
    compare("ln_linear[full-res fc2, train]", ln_linear(h_ref, w2, **fc2),
            ln_linear_plain(h_ref, w2, **fc2), KERNEL_TOL)
    dout = randn(FR_B, FR_N, E)
    bwd2 = dict(drop=drop2, pre=pre_ref, pre_drop=drop1)
    dh, dh_ref = ln_linear_bwd(dout, w2, **bwd2), ln_linear_bwd_plain(dout, w2, **bwd2)
    compare("ln_linear_bwd[full-res fc2]", dh, dh_ref, KERNEL_TOL)
    bwd1 = dict(x=x, gamma=gamma, beta=beta)
    for name, g_, r_ in zip(("dz", "ln_out", "dgamma", "dbeta"), ln_linear_bwd(dh_ref, w1, **bwd1),
                            ln_linear_bwd_plain(dh_ref, w1, **bwd1)):
        compare(f"ln_linear_bwd[full-res fc1] {name}", g_, r_, KERNEL_TOL)
    for name, dy, a, kw in (("fc2", dout, h_ref, dict(drop=drop2, bias=True)),
                            ("fc1", dh_ref, x, dict(bias=True))):
        for part, g_, r_ in zip(("dW", "db"), ln_linear_wgrad(dy, a, **kw),
                                ln_linear_wgrad_plain(dy, a, **kw)):
            compare(f"ln_linear_wgrad[full-res {name}] {part}", g_, r_, KERNEL_TOL)
    del x, h, pre, h_ref, pre_ref, dout, dh, dh_ref
    for label, b, hh, ww, dtype, tol in (
            ("full-res 137x249", FR_B, FR_MAP_H, FR_MAP_W, bf, KERNEL_TOL),
            ("fp32 29x57", B, MAP_H, MAP_W, f32, F32_KERNEL_TOL)):
        table = randn(b, E, hh * ww, dtype=dtype)
        grid = (torch.rand(b, NEURONS, 2, generator=gen) * 2.4 - 1.2).to(DEVICE)
        compare(f"bilinear_sample_cm[{label}]", bilinear_sample_cm(table, grid, hh, ww),
                bilinear_sample_cm_plain(table, grid, hh, ww), tol)
        ds = randn(b, E, NEURONS, dtype=dtype)
        for part, g_, r_ in zip(("d(table)", "d(grid)"),
                                bilinear_sample_cm_bwd(table, grid, ds, hh, ww),
                                bilinear_sample_cm_bwd_plain(table, grid, ds, hh, ww)):
            compare(f"bilinear_sample_cm_bwd[{label}] {part}", g_, r_, tol)
    torch.cuda.empty_cache()


def sublayer_yardsticks(gen: torch.Generator) -> None:
    """Whole sublayers, kernel path against library-built ones (SDPA-based
    attention sublayer, nn.Sequential MLP) on the same inputs."""
    import torch.nn.functional as F
    from torch import nn

    from v1t_tpu_torch.ops.fused_mha import fused_mha
    from v1t_tpu_torch.ops.fused_mlp import fused_mlp

    dev, bf = DEVICE, torch.bfloat16
    x = torch.randn(B, N, E, generator=gen).to(dev, bf)
    row = (torch.randn(B, E, generator=gen) * 0.5).to(dev, bf)
    ln = nn.LayerNorm(E).to(dev)
    qkv_l = nn.Linear(E, 3 * H * E, bias=False).to(dev)
    proj = nn.Linear(H * E, E).to(dev)
    mlp = nn.Sequential(nn.LayerNorm(E), nn.Linear(E, F_HID), nn.GELU(), nn.Linear(F_HID, E)).to(dev)

    def sdpa_sublayer():
        z = x + row[:, None, :]
        q, k, v = F.linear(F.layer_norm(z, (E,), ln.weight.to(bf), ln.bias.to(bf)),
                           qkv_l.weight.to(bf)).reshape(B, N, 3, H, E).permute(2, 0, 3, 1, 4)
        o = F.scaled_dot_product_attention(q, k, v, scale=E ** -0.5)
        return F.linear(o.transpose(1, 2).reshape(B, N, H * E), proj.weight.to(bf),
                        proj.bias.to(bf)) + z

    mlp_bf = mlp.to(bf)

    def kernel_mha():
        return fused_mha(x, ln.weight, ln.bias, qkv_l.weight.to(bf), proj.weight.to(bf),
                         proj.bias.float(), E ** -0.5, num_heads=H, fold_residual=True, bias_row=row)

    mlp_w = [p.detach().float() for p in mlp.parameters()]

    def kernel_mlp():
        return fused_mlp(x, mlp_w[0], mlp_w[1], mlp[1].weight, mlp_w[3], mlp[3].weight, mlp_w[5],
                         fold_residual=True)

    with torch.inference_mode():
        mha_ms, sdpa_ms = cuda_ms(kernel_mha), cuda_ms(sdpa_sublayer)
        mlp_ms, seq_ms = cuda_ms(kernel_mlp), cuda_ms(lambda: mlp_bf(x) + x)
    log(f"  sublayers: fused_mha kernels_ms {mha_ms:.4f} vs SDPA-based sublayer_ms {sdpa_ms:.4f}; "
        f"fused_mlp kernels_ms {mlp_ms:.4f} vs nn.Sequential MLP_ms {seq_ms:.4f}")


def flagship_model(config, card, seed: int = 0):
    """The flagship model on the card, weights from ``seed``. Two draws from
    the next seed replace the reference's init where it would hide a fault of
    the kernel path: the readout features (a constant 1/C averages every
    response over the channels) and the behavior MLPs (trunc_normal(0.02)
    leaves a latent of ~1e-2, which the comparison could not tell from a
    dropped bias_row)."""
    from v1t_tpu_torch.models import build_model

    model = build_model(config, card, seed=seed, device=DEVICE)
    gen = torch.Generator().manual_seed(seed + 1)
    redrawn = [(readout.features, readout.features.shape[1])
               for readout in model.readouts.values() if hasattr(readout, "features")]
    for block in getattr(getattr(model.core, "transformer", None), "blocks", ()):
        for mlp in block.b_mlp.models.values() if block.b_mlp is not None else ():
            redrawn += [(mlp[0].weight, mlp[0].in_features), (mlp[3].weight, mlp[3].in_features)]
    with torch.no_grad():
        for param, fan_in in redrawn:
            param.copy_(torch.randn(param.shape, generator=gen) * fan_in ** -0.5)
    return model


def flagship_config(**kwargs):
    from v1t_tpu_torch.configs import Config

    return Config(**{**dict(core="vit", readout="gaussian2d", behavior_mode=3, shift_mode=2,
                            precision="bf16", resize_image=0, batch_size=B), **kwargs})


def host_batch(rng, n: int, image_shape, neurons: int, ids: int = 0) -> dict:
    return {
        "image": rng.normal(size=(n, *image_shape)).astype(np.float32),
        "behavior": rng.normal(size=(n, 3)).astype(np.float32),
        "pupil_center": rng.normal(size=(n, 2)).astype(np.float32),
        "response": rng.poisson(2.0, size=(n, neurons)).astype(np.float32),
        "image_id": np.arange(ids, ids + n),
        "trial_id": np.arange(ids, ids + n),
    }


def plain_config(config):
    return config.replace(attention_impl="xla", readout_impl="xla")


def serve(label: str, config, image_shape, n_batches: int, expected: dict, tol: dict,
          card_text: str) -> tuple:
    """``n_batches`` batches through ``training.inference`` (Trainer.predict)
    with the counters set to 0 just before and read just after; responses
    and one batch's core map against the same model's plain path."""
    from v1t_tpu_torch.data.cards import synthetic_data_card
    from v1t_tpu_torch.models import build_model
    from v1t_tpu_torch.training import Trainer, inference

    b = config.batch_size
    card = synthetic_data_card(mouse_ids=("A",), num_neurons=NEURONS, input_shape=image_shape)
    model = flagship_model(config, card)
    trainer = Trainer(config, model, card, device=DEVICE)
    rng = np.random.default_rng(0)
    batches = [host_batch(rng, b, image_shape, NEURONS, i * b) for i in range(n_batches)]
    trainer.predict("A", batches[0])  # warm-up, not counted
    torch.cuda.synchronize()
    zero_counts()
    torch.manual_seed(0)  # the random core and readout draw from it in eval
    start = time.perf_counter()
    result = inference(trainer, batches, "A")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    launches = read_counts()
    images = n_batches * b
    log(f"  launches over {n_batches} micro-batches: {launches}")
    if launches != expected:
        raise AssertionError(f"{label}: launch counts {launches} != {expected}")
    preds = result["predictions"]
    if preds.shape != (images, NEURONS) or not np.isfinite(preds).all() or not (preds > 0).all():
        raise AssertionError(f"predictions: shape {preds.shape}, finite/positive check failed")
    log(f"  kernel path: {images} images in {seconds:.4f} s = {images / seconds:.1f} images/s "
        f"({card_text})")

    plain_model = build_model(plain_config(config), card, seed=None, device=DEVICE)
    plain_model.load_state_dict(model.state_dict())
    plain_trainer = Trainer(plain_config(config), plain_model, card, device=DEVICE)
    plain_trainer.predict("A", batches[0])
    torch.cuda.synchronize()
    torch.manual_seed(0)
    start = time.perf_counter()
    ref = inference(plain_trainer, batches, "A")["predictions"]
    plain_seconds = time.perf_counter() - start
    log(f"  plain path: {images} images in {plain_seconds:.4f} s = "
        f"{images / plain_seconds:.1f} images/s")
    err = float(np.abs(preds - ref).max())
    rel = err / float(np.abs(ref).max())
    status = "ok" if rel <= tol["model"] else "FAIL"
    log(f"  responses vs plain path: max|d| {err:.3e}, max|d|/max|ref| {rel:.3e} "
        f"(tol {tol['model']:g}), mean|d| {float(np.abs(preds - ref).mean()):.3e} {status}")
    if rel > tol["model"]:
        raise AssertionError(f"{label}: responses differ from the plain path: {rel:.3e}")
    torch.manual_seed(0)
    got_map = core_map(model, batches[0])
    torch.manual_seed(0)
    ref_map = core_map(plain_model, batches[0])
    compare(f"core map {tuple(ref_map.shape)} vs plain path", got_map, ref_map, tol["core"])
    return launches, lambda: trainer.predict("A", batches[0]), images / seconds


def train(label: str, config, image_shape, cycles: int, per_step: dict, tol: dict,
          card_text: str, warm: bool = True, paths=("kernel", "plain"),
          core_frozen: bool = False, seed: int = 0) -> tuple:
    """Trainer.train_step, dropout and readout noise on: ``cycles`` cycles
    over two mice (gradients accumulated across the cycle, one AdamW update
    at its end), through the kernels with the counters set to 0 just before
    and read just after, then the same weights, seeds and batches through the
    plain path: per-step losses and every parameter's first-step gradient.
    ``paths=("kernel",)`` runs the kernel path alone (the caller holds it);
    a path "f32" runs the plain path in float32, the witness ``hold`` then
    takes; each run records its peak of allocated device memory.
    ``core_frozen``: the core of ``config.pretrain_core`` injected and
    frozen. ``seed``: 0 draws the weights from seed 0, the batches from
    seed 2 and the steps' seeds from ``config.seed``; another shifts all
    three by it."""
    from v1t_tpu_torch.data.cards import synthetic_data_card
    from v1t_tpu_torch.models import build_model
    from v1t_tpu_torch.pretrained import load_pretrain_core
    from v1t_tpu_torch.training import Trainer

    b = config.batch_size
    config = config.replace(seed=config.seed + seed)
    card = synthetic_data_card(mouse_ids=MICE, num_neurons=NEURONS, input_shape=image_shape)
    initial = flagship_model(config, card, seed)
    if core_frozen:
        load_pretrain_core(config, initial)
    state = initial.state_dict()
    rng = np.random.default_rng(2 + seed)
    warm_batch = host_batch(rng, b, image_shape, NEURONS)
    batches = [[host_batch(rng, b, image_shape, NEURONS) for _ in MICE] for _ in range(cycles)]
    steps = cycles * len(MICE)
    runs = {}
    for path in paths:
        cfg = {"kernel": config, "plain": plain_config(config),
               "f32": plain_config(config).replace(precision="fp32")}[path]
        model = build_model(cfg, card, seed=None, device=DEVICE)
        model.load_state_dict(state)
        trainer = Trainer(cfg, model, card, device=DEVICE, core_frozen=core_frozen)
        if warm:
            # a warm-up step without an update (the run below starts from zero
            # gradients); both paths take it, so their seeds stay in step
            trainer.train_step(MICE[0], warm_batch, None, update=False)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        losses, first_grads = [], None
        start = time.perf_counter()
        for cycle in range(cycles):
            acc = None
            for i, mouse in enumerate(MICE):
                acc, metrics = trainer.train_step(mouse, batches[cycle][i], acc,
                                                  update=i == len(MICE) - 1)
                losses.append(metrics["loss/loss"])
                if first_grads is None:
                    first_grads = {name: p.grad.detach().clone()
                                   for name, p in model.named_parameters() if p.grad is not None}
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        launches, dx_forms = read_counts(), read_dx_forms()
        losses = [float(v) for v in losses]
        log(f"  {path} path: {steps} train steps of {b} images in {seconds:.4f} s = "
            f"{steps * b / seconds:.1f} train images/s ({card_text}); losses "
            + " ".join(f"{v:.6f}" for v in losses))
        log(f"  {path} path launches over {steps} steps: {launches}")
        if not all(np.isfinite(losses)):
            raise AssertionError(f"{label}, {path} path: non-finite loss")
        runs[path] = dict(losses=losses, grads=first_grads, launches=launches,
                          dx_forms=dx_forms, images_per_s=steps * b / seconds, trainer=trainer,
                          peak_bytes=torch.cuda.max_memory_allocated())
        del model
    expected = {name: n * steps for name, n in per_step.items()}
    if runs["kernel"]["launches"] != expected:
        raise AssertionError(f"{label}: launch counts {runs['kernel']['launches']} != {expected}")
    if "plain" in runs:
        for path in ("plain", "f32"):
            if any(runs.get(path, {}).get("launches", {}).values()):
                raise AssertionError(f"{label}: the {path} path launched kernels: "
                                     f"{runs[path]['launches']}")
        hold(label, runs["kernel"], runs["plain"], tol, witness=runs.get("f32"))
    trainer = runs["kernel"]["trainer"]
    one = batches[0][0]
    return runs["kernel"]["launches"], lambda: trainer.train_step(
        MICE[0], one, None, update=True), runs


def grad_rels(grads: dict, refs: dict, label: str, by_module: bool = False) -> dict:
    """max|d| / max|ref| of every parameter's gradient; ``by_module``: over
    the largest gradient element of the parameter's top-level module (core,
    readouts, ...) where that is larger. A BatchNorm core takes it:
    BatchNorm cancels the gradients of the biases ahead of it to rounding
    noise (zero in exact arithmetic), which no parameter's own scale holds."""
    if grads.keys() != refs.keys():
        raise AssertionError(f"{label}: gradients for different parameters")
    scales: dict = {}
    for name, ref in refs.items():
        top = name.split(".")[0] if by_module else name
        scales[top] = max(scales.get(top, 1e-30), ref.abs().max().item())
    rels = {}
    for name, ref in refs.items():
        got = grads[name].float()
        if not torch.isfinite(got).all():
            raise AssertionError(f"{label}, {name}: non-finite gradient")
        scale = scales[name.split(".")[0] if by_module else name]
        rels[name] = (got - ref.float()).abs().max().item() / scale
    return rels


def from_witness(got, ref, truth) -> tuple:
    """max|got - truth| and max|ref - truth| over max|truth|: how far the
    kernel and the plain path each lie from the float32 witness."""
    got, ref, truth = (torch.as_tensor(v, dtype=torch.float64) for v in (got, ref, truth))
    scale = max(truth.abs().max().item(), 1e-30)
    return ((got - truth).abs().max().item() / scale, (ref - truth).abs().max().item() / scale)


def hold(label: str, kernel: dict, plain: dict, tol: dict,
         names: tuple = ("kernel", "plain"), witness: dict | None = None) -> None:
    """A kernel path's per-step losses and first-step gradients against the
    plain path's on the same weights, seeds and batches (``names``: what
    the two runs are). ``witness``: the same run through the plain path in
    float32. A gradient past its bound then passes where the kernel path's
    lies no further from the witness's than ``tol["witness"]`` times the
    plain path's does, and a loss past its bound where the kernel path's
    losses, summed over the steps, do so: the gap is then the plain path's
    own rounding as much as the kernel path's. A loss alone is a poor
    witness: two paths' distances from the float32 loss, each a draw of
    the roundings, can part by any ratio at one step."""
    losses = {}
    for step, (got, ref) in enumerate(zip(kernel["losses"], plain["losses"])):
        losses[step] = rel = abs(got - ref) / abs(ref)
        log(f"  step {step} loss: {names[0]} {got:.6f} {names[1]} {ref:.6f} |d|/|ref| "
            f"{rel:.3e} (tol {tol['loss']:g}) {'ok' if rel <= tol['loss'] else 'past'}")
    by_module = tol.get("grad_scale") == "module"
    rels = grad_rels(kernel["grads"], plain["grads"], label, by_module)
    worst = sorted(rels.items(), key=lambda kv: kv[1], reverse=True)
    log(f"  first step's gradients of {len(rels)} parameters, max|d|/max|ref|"
        + (" (ref: the parameter's module)" if by_module else "") + ", largest: "
        + ", ".join(f"{n} {r:.3e}" for n, r in worst[:4]) + f" (tol {tol['grad']:g})")
    read = log_witness(kernel, plain, witness, names) if witness is not None else None

    def excused(what: str, dk: float, dp: float, how: str = "") -> bool:
        ok = dk <= tol["witness"] * dp
        log(f"    {what} past its bound; from the float32 witness{how} {names[0]} {dk:.3e}, "
            f"{names[1]} {dp:.3e}: ratio {dk / max(dp, 1e-30):.3f} (bound {tol['witness']:g}) "
            + ("ok" if ok else "FAIL"))
        return ok

    past = [step for step, rel in losses.items() if rel > tol["loss"]]
    if past and not (read and excused(
            f"step {', '.join(map(str, past))} loss", sum(dk for dk, _ in read["losses"]),
            sum(dp for _, dp in read["losses"]), " (the losses summed over the steps)")):
        raise AssertionError(f"{label}, step {past[0]}: loss differs from the {names[1]} "
                             f"run by {losses[past[0]]:.3e}")
    for name, rel in worst:
        if rel > tol["grad"] and not (read and excused(name, *read["grads"][name])):
            raise AssertionError(f"{label}: gradient {name} differs from the {names[1]} "
                                 f"run: {rel:.3e}")


def log_witness(kernel: dict, plain: dict, witness: dict, names: tuple) -> dict:
    """Every loss's and first-step gradient's distance from the float32
    witness, the kernel path's beside the plain path's, logged; returns
    them (a (kernel, plain) pair per loss step and per gradient)."""
    losses = [from_witness(k, p, f) for k, p, f in
              zip(kernel["losses"], plain["losses"], witness["losses"])]
    summed = [sum(d[i] for d in losses) for i in (0, 1)]
    log("  losses from the float32 witness, |d|/|ref| " + names[0] + " / " + names[1] + ": "
        + ", ".join(f"step {i} {dk:.3e} / {dp:.3e}" for i, (dk, dp) in enumerate(losses))
        + f"; summed {summed[0]:.3e} / {summed[1]:.3e}, ratio "
        f"{summed[0] / max(summed[1], 1e-30):.3f}")
    grads = {n: from_witness(kernel["grads"][n], plain["grads"][n], g)
             for n, g in witness["grads"].items()}
    ratios = sorted(((dk / max(dp, 1e-30), n) for n, (dk, dp) in grads.items()), reverse=True)
    kp = grad_rels(kernel["grads"], plain["grads"], "witness")
    log(f"  first step's gradients from the float32 witness, max|d|/max|ref|, {names[0]} / "
        f"{names[1]}; the largest {names[0]}-{names[1]} gaps: " + ", ".join(
            f"{n} {grads[n][0]:.3e} / {grads[n][1]:.3e}"
            for n, _ in sorted(kp.items(), key=lambda kv: -kv[1])[:6])
        + f"; ratio {names[0]} / {names[1]}: median {ratios[len(ratios) // 2][0]:.3f}, "
        "largest " + ", ".join(f"{n} {r:.3f}" for r, n in ratios[:3]))
    return dict(losses=losses, grads=grads)


def serving_path(card_text: str) -> tuple:
    log("phase 4: serving, flagship V1T (Trainer.predict) on the card")
    blocks = flagship_config().num_blocks
    expected = dict.fromkeys(kernel_counters(), 0)
    expected.update(ln_linear=4 * blocks * 3, attention=blocks * 3, bilinear_sample_cm=3)
    launches, serve_one, _ = serve("serving", flagship_config(), (1, 36, 64), 3, expected,
                                   dict(model=MODEL_TOL, core=CORE_TOL), card_text)
    return launches, serve_one


def training_path(card_text: str) -> tuple:
    log("phase 5: training, flagship V1T Trainer.train_step on the card")
    return train("training", flagship_config(), (1, 36, 64), CYCLES, TRAIN_LAUNCHES_PER_STEP,
                 dict(loss=LOSS_TOL, grad=GRAD_TOL), card_text)


def composed_path(label: str, config, image_shape, serve_batches: int, cycles: int,
                  per_step: dict, tol: dict, card_text: str) -> dict:
    """A composed path's serving and training (phases 5b, 5c, 5d)."""
    per_batch = {name: 0 if "bwd" in name or "wgrad" in name else n
                 for name, n in per_step.items()}
    serving, serve_one, images_per_s = serve(f"{label} serving", config, image_shape,
                                             serve_batches,
                                             {k: v * serve_batches for k, v in per_batch.items()},
                                             tol, card_text)
    torch.cuda.empty_cache()
    launches, train_one, runs = train(f"{label} training", config, image_shape, cycles,
                                      per_step, tol, card_text, warm=False,
                                      paths=("kernel", "plain", "f32") if "witness" in tol
                                      else ("kernel", "plain"))
    log(f"  {label}: serving {images_per_s:.1f} images/s, training "
        f"{runs['kernel']['images_per_s']:.3f} train images/s (plain "
        f"{runs['plain']['images_per_s']:.3f}) ({card_text})")
    return dict(serving_launches=serving, launches=launches, train_one=train_one,
                serve_one=serve_one, images_per_s=images_per_s,
                dx_forms=runs["kernel"]["dx_forms"],
                train_images_per_s=runs["kernel"]["images_per_s"],
                plain_train_images_per_s=runs["plain"]["images_per_s"])


def drop_path_and_checkpointing(card_text: str) -> dict:
    """Phase 5f: the flagship's training at the sweep's largest drop_path,
    gradient checkpointing off (twice: the spread of two runs) and on."""
    from v1t_tpu_torch.models.cores import vit

    log(f"phase 5f: training at drop_path {DROP_PATH}, gradient checkpointing off and on")
    config = flagship_config(drop_path=DROP_PATH)
    drawn, draw = [], vit.drop_path_mask

    def recording(*args):
        mask = draw(*args)
        drawn.append(mask)
        return mask

    vit.drop_path_mask = recording
    tol = DROP_PATH_TOL
    try:
        launches, _, runs = train("drop_path", config, (1, 36, 64), CYCLES,
                                  TRAIN_LAUNCHES_PER_STEP, tol, card_text)
        torch.cuda.empty_cache()
        again = train("drop_path, again", config, (1, 36, 64), CYCLES, TRAIN_LAUNCHES_PER_STEP,
                      tol, card_text, paths=("kernel",))[2]["kernel"]
        torch.cuda.empty_cache()
        ckpt_launches, ckpt_one, ckpt = train("drop_path + checkpointing",
                                       config.replace(grad_checkpointing=1), (1, 36, 64), CYCLES,
                                       CKPT_LAUNCHES_PER_STEP, tol, card_text, paths=("kernel",))
        ckpt = ckpt["kernel"]
    finally:
        vit.drop_path_mask = draw
    first, plain = runs["kernel"], runs["plain"]
    hold("drop_path + checkpointing", ckpt, plain, tol)
    # checkpointing against its absence: the steps before the first update
    # bit for bit (the same forward kernels on the same inputs); later
    # steps and the first step's gradients within the spread of two runs
    # without it (dq is summed with float atomics)
    spread = max(abs(a - b) / abs(b) for a, b in zip(again["losses"], first["losses"]))
    loss_rels = [abs(a - b) / abs(b) for a, b in zip(ckpt["losses"], first["losses"])]
    grad_spread = max(grad_rels(again["grads"], first["grads"], "drop_path, again").values())
    ckpt_rels = grad_rels(ckpt["grads"], first["grads"], "checkpointing")
    worst = max(ckpt_rels.items(), key=lambda kv: kv[1])
    log(f"  checkpointing vs none: losses |d|/|ref| {['%.3e' % r for r in loss_rels]} (two runs "
        f"without: {spread:.3e}); first step's gradients max|d|/max|ref| {worst[1]:.3e} "
        f"({worst[0]}; two runs without: {grad_spread:.3e})")
    if ckpt["losses"][:len(MICE)] != first["losses"][:len(MICE)]:
        raise AssertionError("checkpointing: the losses before the first update differ")
    if max(loss_rels) > max(CKPT_SPREAD * spread, CKPT_LOSS_FLOOR):
        raise AssertionError(f"checkpointing: losses {loss_rels} beyond the spread {spread:.3e}")
    if worst[1] > max(CKPT_SPREAD * grad_spread, CKPT_GRAD_FLOOR):
        raise AssertionError(f"checkpointing: gradient {worst[0]} {worst[1]:.3e} beyond the "
                             f"spread {grad_spread:.3e}")
    masks = torch.cat(drawn).float()
    share = 1.0 - masks.mean().item()
    bound = 5 * (DROP_PATH * (1 - DROP_PATH) / masks.numel()) ** 0.5
    log(f"  drop-path masks: {masks.numel()} samples drawn, share dropped {share:.4f} "
        f"(rate {DROP_PATH}, 5 sigma {bound:.4f})")
    if abs(share - DROP_PATH) > bound:
        raise AssertionError(f"drop_path: share dropped {share:.4f} is not {DROP_PATH}")
    peaks = {k: r["peak_bytes"] / 2 ** 30 for k, r in (("without", first), ("with", ckpt))}
    log(f"  peak allocated device memory over the steps: without checkpointing "
        f"{peaks['without']:.3f} GiB, with {peaks['with']:.3f} GiB; train images/s without "
        f"{first['images_per_s']:.1f} / {again['images_per_s']:.1f}, with "
        f"{ckpt['images_per_s']:.1f} ({card_text})")
    return dict(launches=launches, ckpt_launches=ckpt_launches, peaks=peaks,
                images_per_s=first["images_per_s"], ckpt_images_per_s=ckpt["images_per_s"],
                train_one=ckpt_one)


def patch_modes(card_text: str) -> dict:
    """Phase 5g: patch modes 1-3 at the flagship, one serving batch and one
    cycle of two train steps each, against the plain path."""
    log("phase 5g: patch modes 1-3 (conv; shifted patches + LayerNorm; LayerNorm twice)")
    blocks = flagship_config().num_blocks
    per_batch = dict.fromkeys(kernel_counters(), 0)
    per_batch.update(ln_linear=4 * blocks, attention=blocks, bilinear_sample_cm=1)
    out = {}
    for mode in (1, 2, 3):
        config = flagship_config(patch_mode=mode)
        serving, _, images_per_s = serve(f"patch mode {mode} serving", config, (1, 36, 64), 1,
                                         per_batch, dict(model=MODEL_TOL, core=CORE_TOL),
                                         card_text)
        torch.cuda.empty_cache()
        launches, _, runs = train(f"patch mode {mode} training", config, (1, 36, 64), 1,
                                  TRAIN_LAUNCHES_PER_STEP, dict(loss=LOSS_TOL, grad=GRAD_TOL),
                                  card_text)
        torch.cuda.empty_cache()
        log(f"  patch mode {mode}: serving {images_per_s:.1f} images/s, training "
            f"{runs['kernel']['images_per_s']:.1f} train images/s ({card_text})")
        out[mode] = dict(serving=serving, launches=launches)
    return out


class LoopHooks:
    """What ``v1t_tpu_torch.train.main`` reports of a run (its ``hooks``):
    the kernel launches of each epoch and of the test evaluation, held
    against phase 5's per-step and phase 4's per-batch counts; the epoch
    results; and a validation batch's predictions by the best epoch's
    weights, to hold ``restore_best`` to them bit for bit."""

    def __init__(self, serve_per_batch: dict, per_step: dict = TRAIN_LAUNCHES_PER_STEP):
        self.serve_per_batch, self.per_step = serve_per_batch, per_step
        self.start, self.epochs, self.launches = None, [], {}
        self.trainer = self.loaders = self.best_pred = self.batch = None

    def _delta(self) -> dict:
        now = read_counts()
        delta = {k: now[k] - self.prev[k] for k in now}
        self.prev = now
        return delta

    def _predict(self, trainer) -> np.ndarray:
        out = trainer.predict("A", self.batch)
        self.prev = read_counts()  # these launches are the check's, not the run's
        return out

    def run_start(self, trainer, scheduler, epoch, loaders):
        self.trainer, self.loaders, self.start = trainer, loaders, epoch
        self.scheduler_state = scheduler.state_dict()
        self.batch = next(iter(loaders["validation"]["A"]))
        torch.cuda.synchronize()
        zero_counts()
        self.prev = read_counts()
        if epoch:  # a resume: the restored weights are the best epoch's
            self.best_pred = self._predict(trainer)

    def _expect(self, steps: int, batches: int) -> dict:
        return {k: steps * self.per_step[k] + batches * self.serve_per_batch[k]
                for k in self.per_step}

    def epoch_end(self, epoch, train_result, val_result, trainer, scheduler):
        steps = sum(len(loader) for loader in self.loaders["train"].values())
        batches = sum(len(loader) for loader in self.loaders["validation"].values())
        launches = self._delta()
        self.launches[f"epoch {epoch}"] = launches
        expected = self._expect(steps, batches)
        if trainer.config.attention_impl == "xla":
            expected = dict.fromkeys(expected, 0)
        if launches != expected:
            raise AssertionError(f"epoch {epoch}: launches {launches} != {expected} "
                                 f"({steps} train steps, {batches} validation batches)")
        values = [train_result["loss"], val_result["loss"], val_result["single_trial_correlation"]]
        if not all(np.isfinite(values)):
            raise AssertionError(f"epoch {epoch}: non-finite results {values}")
        self.epochs.append(dict(epoch=epoch, train_loss=train_result["loss"],
                                val_loss=val_result["loss"], corr=values[2],
                                best=scheduler.best_epoch))
        if scheduler.best_epoch == epoch:
            self.best_pred = self._predict(trainer)

    def run_end(self, trainer, scheduler, eval_result):
        # evaluate skips the test tier of S0 and S1 (hashed trials in the
        # challenge's data)
        batches = sum(len(loader) for mouse, loader in self.loaders["test"].items()
                      if mouse not in ("S0", "S1"))
        launches = self._delta()
        self.launches["evaluate"] = launches
        expected = self._expect(0, batches)
        if trainer.config.attention_impl == "xla":
            expected = dict.fromkeys(expected, 0)
        if launches != expected:
            raise AssertionError(f"evaluate: launches {launches} != {expected}")
        if not all(np.isfinite(list(eval_result.values()))):
            raise AssertionError(f"evaluate: non-finite results {eval_result}")
        self.eval_result, self.best = eval_result, scheduler.best_epoch
        got = self._predict(trainer)
        if not np.array_equal(got, self.best_pred):
            raise AssertionError(f"restore_best: predictions differ from epoch {self.best}'s by "
                                 f"{np.abs(got - self.best_pred).max():.3e}")


def loop_argv(root: str, out: str, epochs: int, *extra) -> list:
    """``python -m v1t_tpu_torch.train``'s flags at the flagship on the
    synthetic dataset under ``root`` (phases 5e, 5j)."""
    return ["--dataset", root, "--output_dir", out, "--behavior_mode", "3",
            "--shift_mode", "2", "--core", "vit", "--readout", "gaussian2d",
            "--emb_dim", str(E), "--num_blocks", "4", "--num_heads", str(H),
            "--mlp_dim", str(F_HID), "--patch_size", "8", "--patch_stride", "1",
            "--batch_size", str(B), "--precision", "bf16", "--image_wire_dtype", "auto",
            "--mouse_ids", *LOOP_MICE, "--data_parallel", "1", "--epochs", str(epochs),
            "--verbose", "1", *extra]


def training_loop(card_text: str, tmp: str) -> dict:
    """Phase 5e: ``python -m v1t_tpu_torch.train``'s ``main`` at the flagship
    from a synthetic Sensorium-layout dataset on disk under ``tmp`` (the
    mice S1 and A of 7000 neurons, 1x144x256 stimuli resized to 36x64): 3
    epochs, a resume to 4, checkpoint, ``restore_best`` and
    ``evaluation.yaml``; then one epoch of the plain path from the same
    weights and seeds against the kernel path's first. The runs stay under
    ``tmp`` for phase 5h."""
    import os

    from v1t_tpu_torch import train as train_cli
    from v1t_tpu_torch import training
    from v1t_tpu_torch.data import datasets, fastbatch, synthetic
    from v1t_tpu_torch.utils.scheduler import load_checkpoint_file

    log("phase 5e: the training loop from disk (python -m v1t_tpu_torch.train's main) at the "
        "flagship")
    serve_per_batch = dict.fromkeys(TRAIN_LAUNCHES_PER_STEP, 0)
    blocks = flagship_config().num_blocks
    serve_per_batch.update(ln_linear=4 * blocks, attention=blocks, bilinear_sample_cm=1)
    timed = []
    train_epoch = training.train_epoch

    def timed_train_epoch(trainer, ds, epoch, summary=None):
        torch.cuda.synchronize()
        start = time.perf_counter()
        result = train_epoch(trainer, ds, epoch, summary=summary)
        torch.cuda.synchronize()
        images = sum(len(loader.dataset) for loader in ds.values())
        path = "plain" if trainer.config.attention_impl == "xla" else "kernel"
        timed.append((path, epoch, images, time.perf_counter() - start))
        return result

    start = time.perf_counter()
    root = synthetic.generate_dataset(os.path.join(tmp, "data"), mouse_ids=LOOP_MICE,
                                      num_neurons=NEURONS, image_shape=LOOP_IMAGE,
                                      **LOOP_TRIALS)
    log(f"  synthetic dataset: mice {LOOP_MICE} x {NEURONS} neurons, {LOOP_TRIALS}, "
        f"images {LOOP_IMAGE}, written in {time.perf_counter() - start:.1f} s")
    if fastbatch.lib() is None:
        raise AssertionError(f"the native host gather did not build: {fastbatch.lib_error()}")

    argv = functools.partial(loop_argv, root)

    training.train_epoch = timed_train_epoch
    try:
        out = os.path.join(tmp, "run")
        first = LoopHooks(serve_per_batch)
        result = train_cli.main(train_cli.parse_config(argv(out, 3)), hooks=first)
        for name in ("args.yaml", os.path.join("ckpt", "model_state.pt"), "evaluation.yaml",
                     "model.txt", "model_core.txt", "model_readout.txt", "output.log"):
            if not os.path.isfile(os.path.join(out, name)):
                raise AssertionError(f"the run wrote no {name}")
        ckpt = load_checkpoint_file(os.path.join(out, "ckpt", "model_state.pt"))
        log(f"  run of 3 epochs: epochs {[e['epoch'] for e in first.epochs]}, best epoch "
            f"{first.best}, test {result}; checkpoint epoch {ckpt['epoch']}")
        second = LoopHooks(serve_per_batch)
        resumed = train_cli.main(train_cli.parse_config(argv(out, 4)), hooks=second)
        ran = [e["epoch"] for e in second.epochs]
        if (second.start != ckpt["epoch"] or second.scheduler_state != ckpt["scheduler"]
                or ran != list(range(ckpt["epoch"] + 1, 5))):
            raise AssertionError(f"resume: started after epoch {second.start}, ran {ran}, "
                                 f"scheduler {second.scheduler_state} (checkpoint epoch "
                                 f"{ckpt['epoch']}, scheduler {ckpt['scheduler']})")
        log(f"  resumed with --epochs 4: restored epoch {second.start} with the scheduler's "
            f"state {second.scheduler_state}, ran epochs {ran}, best {second.best}, test "
            f"{resumed}; restore_best's predictions equal the best epoch's bit for bit")
        plain = LoopHooks(serve_per_batch)
        plain_dir = os.path.join(tmp, "plain")
        train_cli.main(train_cli.parse_config(argv(plain_dir, 1,
                                                   "--attention_impl", "xla",
                                                   "--readout_impl", "xla")), hooks=plain)
    finally:
        training.train_epoch = train_epoch
    got, ref = first.epochs[0], plain.epochs[0]
    for key in ("train_loss", "val_loss"):
        rel = abs(got[key] - ref[key]) / abs(ref[key])
        log(f"  epoch 1 {key}: kernel {got[key]:.6f} plain {ref[key]:.6f} |d|/|ref| "
            f"{rel:.3e} (tol {LOOP_TOL['loss']:g}) {'ok' if rel <= LOOP_TOL['loss'] else 'FAIL'}")
        if rel > LOOP_TOL["loss"]:
            raise AssertionError(f"phase 5e: epoch 1 {key} differs from the plain path")
    err = abs(got["corr"] - ref["corr"])
    log(f"  epoch 1 validation correlation: kernel {got['corr']:.6f} plain {ref['corr']:.6f} "
        f"|d| {err:.3e} (tol {LOOP_TOL['corr']:g}) {'ok' if err <= LOOP_TOL['corr'] else 'FAIL'}")
    if err > LOOP_TOL["corr"]:
        raise AssertionError("phase 5e: epoch 1 validation correlation differs from the plain "
                             "path")

    # every batch of the runs came through the native host gather
    for hooks, epochs in ((first, 3), (second, len(second.epochs))):
        for tier, loaders in hooks.loaders.items():
            for mouse, loader in loaders.items():
                want = (len(loader) * (epochs if tier != "test" else 1)
                        + (1 if tier == "validation" and mouse == "A" else 0))
                if tier == "test" and mouse in ("S0", "S1"):
                    want = 0  # evaluate skips their test tier
                if loader.dataset.native_batches != want:
                    raise AssertionError(f"{tier} {mouse}: {loader.dataset.native_batches} of "
                                         f"{want} batches took the native gather")
    log(f"  host gather: the native library ({fastbatch.lib()._name}) served every batch")

    # the loader's host cost a batch of 64, native and numpy paths
    dataset = first.loaders["train"]["A"].dataset
    positions = np.random.default_rng(0).permutation(len(dataset))[:B]
    host_ms = {}
    for label, fast in (("native", "1"), ("numpy", "0")):
        os.environ["V1T_HOST_FASTPATH"] = fast
        dataset.get_batch(positions, image_dtype=datasets.BF16)
        start = time.perf_counter()
        for _ in range(10):
            dataset.get_batch(positions, image_dtype=datasets.BF16)
        host_ms[label] = (time.perf_counter() - start) / 10 * 1e3
    os.environ.pop("V1T_HOST_FASTPATH")
    log(f"  loader host ms a batch of {B} ({'x'.join(map(str, LOOP_IMAGE))}, bf16 wire): native "
        f"{host_ms['native']:.3f}, numpy {host_ms['numpy']:.3f} ({card_text})")
    for path, epoch, images, seconds in timed:
        log(f"  {path} path train_epoch {epoch}: {images} images in {seconds:.3f} s = "
            f"{images / seconds:.1f} train images/s by the host clock ({card_text}; host-clock "
            f"numbers spread 5-20% within one call)")
    trainer = second.trainer
    busy = where_the_time_goes(
        f"one training epoch ({sum(len(x) for x in second.loaders['train'].values())} steps "
        f"of {B})", lambda: training.train_epoch(trainer, second.loaders["train"], epoch=99),
        phase="5e")
    return dict(launches=first.launches, epoch_busy_ms=None if busy is None else busy[0],
                host_ms=host_ms, timed=timed, root=root, run=out, plain_run=plain_dir,
                argv=argv)


def entry_points(card_text: str, loop: dict, tmp: str) -> dict:
    """Phase 5h: the entry points after training on phase 5e's run (mice S1
    and A): ``submission``, ``ensemble`` of it and the plain run (mode 0,
    and mode 2 with the head trained an epoch), ``demo``, and export then
    import; each with the counters set to 0 just before and read just
    after, held against the plain path where it computes."""
    import csv
    import os

    from v1t_tpu_torch import demo, ensemble, export_checkpoint, import_checkpoint, submission
    from v1t_tpu_torch.analysis import extract_attention_maps
    from v1t_tpu_torch.configs import load_args
    from v1t_tpu_torch.data import get_submission_ds, get_training_ds
    from v1t_tpu_torch.data.loaders import build_data_card
    from v1t_tpu_torch.models import build_model
    from v1t_tpu_torch.training import Trainer
    from v1t_tpu_torch.utils.scheduler import Scheduler, load_checkpoint_file

    log("phase 5h: the entry points after training (submission, ensemble, demo, the "
        "attention-map extractor, export and import) on phase 5e's run")
    csv.field_size_limit(sys.maxsize)  # a prediction field holds 7000 numbers
    run, root = loop["run"], loop["root"]
    blocks = flagship_config().num_blocks
    per_batch = dict.fromkeys(kernel_counters(), 0)
    per_batch.update(ln_linear=4 * blocks, attention=blocks, bilinear_sample_cm=1)
    plain = dict(attention_impl="xla", readout_impl="xla")
    out = {}

    def trainer_of(output_dir, card, **overrides):
        config = load_args(output_dir, overrides=dict(verbose=0, **overrides))
        model = build_model(config, card, seed=None, device=DEVICE)
        Scheduler(config, save_optimizer=False).restore(model, force=True)
        return Trainer(config, model, card, device=DEVICE)

    def timed(fn):
        torch.cuda.synchronize()
        zero_counts()
        start = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        return result, time.perf_counter() - start, read_counts()

    # submission: evaluate on the test tier (but S1's), the CSVs of S1
    csv_dir, seconds, launches = timed(lambda: submission.main(submission.parse_args(
        ["--output_dir", run, "--batch_size", str(B), "--verbose", "0"])))
    config = load_args(run, overrides=dict(batch_size=B))
    test_ds, final_ds = get_submission_ds(config, config.dataset, B)
    loaders = {"live_test.csv": test_ds["S1"], "final_test.csv": final_ds["S1"]}
    batches = sum(len(x) for m, x in test_ds.items() if m != "S1") + sum(map(len, loaders.values()))
    images = sum(len(x.dataset) for m, x in test_ds.items() if m != "S1") + sum(
        len(x.dataset) for x in loaders.values())
    if launches != {k: v * batches for k, v in per_batch.items()}:
        raise AssertionError(f"submission: launches {launches} ({batches} batches)")
    plain_trainer = trainer_of(run, build_data_card(config, test_ds), batch_size=B, **plain)
    for name, loader in loaders.items():
        with open(os.path.join(csv_dir, "sensorium+", name), newline="") as f:
            rows = list(csv.reader(f))
        ref = submission.submission_inference(plain_trainer, loader, "S1")
        if rows[0] != list(submission.COLUMNS) or len(rows) - 1 != len(loader.dataset):
            raise AssertionError(f"submission {name}: header {rows[0]}, {len(rows) - 1} rows")
        for key, col in (("trial_ids", 0), ("image_ids", 1), ("neuron_ids", 3)):
            if [r[col] for r in rows[1:]] != [str(v) for v in ref[key]]:
                raise AssertionError(f"submission {name}: {key} differ from the loader's")
        preds = np.array([json.loads(r[2]) for r in rows[1:]])
        want = np.array(ref["predictions"])
        rel = np.abs(preds - want).max() / np.abs(want).max()
        log(f"  submission {name}: {len(rows) - 1} rows, ids as the loader's; predictions vs "
            f"plain path max|d|/max|ref| {rel:.3e} (tol {MODEL_TOL:g})")
        if not np.isfinite(preds).all() or rel > MODEL_TOL:
            raise AssertionError(f"submission {name}: predictions differ from the plain path")
    log(f"  submission.main: {images} images in {seconds:.3f} s = {images / seconds:.1f} images/s "
        f"(evaluation and CSVs, host clock; {card_text}); launches {launches}")
    out["submission"] = launches
    del plain_trainer

    # ensemble of the run and the plain run: the sub-models serve under
    # no_grad behind the head; no backward kernel runs. The ensemble sets
    # its sub-models' precision and attention_impl, as the JAX package's;
    # each keeps its own readout_impl (the plain run's: the plain sampling)
    subs = (run, loop["plain_run"])
    readouts = sum(load_args(d).readout_impl != "xla" for d in subs)
    for mode, extra in ((0, []), (2, ["--train", "--epochs", "1"])):
        ens_dir = os.path.join(tmp, f"ensemble{mode}")
        cfg, saved = ensemble.parse_args(
            ["--dataset", root, "--output_dir", ens_dir, "--behavior_mode", "3",
             "--mouse_ids", *LOOP_MICE, "--saved_models", *(f"{n}={d}" for n, d in zip("ab", subs)),
             "--ensemble_mode", str(mode), "--batch_size", str(B), "--verbose", "0", *extra])
        _, seconds, launches = timed(lambda: ensemble.main(cfg, saved))
        forwards = launches["attention"] // (blocks * len(subs))  # ensemble batches
        want = {k: v * forwards * len(subs) for k, v in per_batch.items()}
        want["bilinear_sample_cm"] = forwards * readouts
        if not forwards or launches != want:
            raise AssertionError(f"ensemble mode {mode}: launches {launches} != {want}")
        if mode == 2:
            keys = sorted(load_checkpoint_file(os.path.join(ens_dir, "ckpt", "model_state.pt"))[
                "model"])
            if keys != sorted(f"output_module.linear.{m}.{p}" for m in LOOP_MICE
                              for p in ("bias", "weight")):
                raise AssertionError(f"ensemble mode 2: checkpoint keys {keys}")
        log(f"  ensemble.main mode {mode}{' --train, 1 epoch' if extra else ''}: {seconds:.3f} s, "
            f"{forwards} batches through both sub-models; launches {launches} (no backward "
            f"kernel; {card_text})")
        out[f"ensemble_mode_{mode}"] = launches

    # demo: the test evaluation, then rollout maps of S1's validation trials
    num_maps, batch = 32, 16
    result, seconds, launches = timed(lambda: demo.main(demo.parse_args(
        ["--output_dir", run, "--batch_size", str(batch), "--num_maps", str(num_maps)])))
    maps = result["maps"]
    config = load_args(run, overrides=dict(verbose=0, **plain))
    _, val_ds, test_ds, card = get_training_ds(config, config.dataset, config.mouse_ids, batch)
    micro = config.effective_micro_batch_size  # Trainer.predict's forwards a batch
    evaluated = sum(-(-min(batch, len(x.dataset) - i) // micro)
                    for m, x in test_ds.items() if m != "S1"
                    for i in range(0, len(x.dataset), batch))
    rollout = min(-(-num_maps // batch), len(val_ds["S1"]))
    want = {k: v * evaluated for k, v in per_batch.items()}
    want["ln_linear"] += 2 * blocks * rollout  # the rollout's blocks: the fused MLP only
    if launches != want:
        raise AssertionError(f"demo: launches {launches} != {want}")
    model = trainer_of(run, card, **plain).model
    ref = extract_attention_maps(val_ds["S1"], model, num_samples=num_maps)
    if maps["heatmaps"].shape != (min(num_maps, len(val_ds["S1"].dataset)), 36, 64):
        raise AssertionError(f"demo: heatmaps {maps['heatmaps'].shape}")
    errs = {k: float(np.abs(maps[k] - ref[k]).max()) for k in ref}
    log(f"  demo.main: {len(maps['heatmaps'])} rollout maps in {seconds:.3f} s (with the test evaluation; "
        f"{card_text}); launches {launches}; against the plain path max|d| "
        + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()) + f" (heatmaps in [0, 1], tol "
        f"{HEATMAP_TOL:g})")
    if not np.isfinite(maps["heatmaps"]).all() or errs["heatmaps"] > HEATMAP_TOL or any(
            errs[k] > 1e-3 * np.abs(ref[k]).max() for k in ("images", "behaviors",
                                                            "pupil_centers")):
        raise AssertionError(f"demo: maps differ from the plain path: {errs}")
    out["demo"] = launches

    # the attention-map extractor: every mouse's validation and test
    # trials (NUM_EXTRACT of each), against the plain path
    from v1t_tpu_torch.misc import extract_attention_maps as extract_cli

    got, seconds, launches = timed(lambda: extract_cli.main(extract_cli.parse_args(
        ["--output_dir", run, "--batch_size", str(batch), "--num_samples", str(NUM_EXTRACT),
         "--verbose", "0"])))
    with open(os.path.join(run, "attention_maps.pkl"), "rb") as f:
        saved = pickle.load(f)
    tiers = {"validation": val_ds, "test": test_ds}
    want = dict.fromkeys(per_batch, 0)
    want["ln_linear"] = 2 * blocks * len(tiers) * len(LOOP_MICE)  # one batch a tier and mouse
    worst = 0.0
    for tier, ds in tiers.items():
        if sorted(got.get(tier, {})) != sorted(LOOP_MICE):
            raise AssertionError(f"extract_attention_maps: {tier} holds {sorted(got.get(tier, {}))}")
        for mouse in LOOP_MICE:
            ref = extract_attention_maps(ds[mouse], model, num_samples=NUM_EXTRACT)
            maps = got[tier][mouse]
            if maps.keys() != ref.keys() or maps["heatmaps"].shape != (NUM_EXTRACT, 36, 64) \
                    or not all(np.array_equal(saved[tier][mouse][k], v) for k, v in maps.items()):
                raise AssertionError(f"extract_attention_maps {tier} {mouse}: layout")
            worst = max(worst, float(np.abs(maps["heatmaps"] - ref["heatmaps"]).max()))
    log(f"  misc.extract_attention_maps: {NUM_EXTRACT} maps of each tier and mouse "
        f"({len(tiers) * len(LOOP_MICE) * NUM_EXTRACT}) in {seconds:.3f} s ({card_text}); "
        f"launches {launches}; heatmaps against the plain path max|d| {worst:.3e} (tol "
        f"{HEATMAP_TOL:g}); attention_maps.pkl as returned")
    if launches != want or worst > HEATMAP_TOL:
        raise AssertionError(f"extract_attention_maps: launches {launches} != {want}, or maps "
                             "differ from the plain path")
    out["extract_attention_maps"] = launches
    del model

    # the figure scripts' compute parts: main_figure's test batch through
    # the kernels against the plain path, the readout means, and the
    # franke2022 summary of a synthetic franke2022 dataset
    from v1t_tpu_torch.data.synthetic import generate_dataset
    from v1t_tpu_torch.misc import figures

    fig_start = time.perf_counter()
    path, seconds, launches = timed(lambda: figures.main(figures.parse_args(
        ["main_figure", "--output_dir", run, "--mouse_id", "A", "--batch_size", str(B)])))
    with np.load(path) as f:
        got = {k: f[k] for k in f.files}
    config = load_args(run, overrides=dict(verbose=0, batch_size=B, **plain))
    _, _, test_ds, card = get_training_ds(config, config.dataset, config.mouse_ids, B)
    model = trainer_of(run, card, **plain).model
    ref = figures.main_figure(config, model, dict(test=test_ds, card=card), DEVICE, "A")
    rows = len(ref["y_true"])
    want = {k: v * -(-rows // config.effective_micro_batch_size) for k, v in per_batch.items()}
    rel = float(np.abs(got["y_pred"] - ref["y_pred"]).max() / np.abs(ref["y_pred"]).max())
    same = all(np.array_equal(got[k], ref[k]) for k in ("y_true", "order", "mu", "image"))
    log(f"  figures main_figure: {rows} test trials of A in {seconds:.3f} s; launches {launches}; "
        f"predictions vs plain path max|d|/max|ref| {rel:.3e} (tol {MODEL_TOL:g}); the stimulus, "
        f"recorded responses, top-60 order and mu {'equal' if same else 'DIFFER'}")
    if launches != want or not np.isfinite(got["y_pred"]).all() or rel > MODEL_TOL or not same:
        raise AssertionError(f"figures main_figure: launches {launches} != {want}, or arrays "
                             "differ from the plain path")
    path = figures.main(figures.parse_args(["readout_positions", "--output_dir", run]))
    with np.load(path) as f:
        got = {k: f[k] for k in f.files}
    ref = figures.readout_positions(model, card)
    if sorted(got) != sorted(f"{m}/{k}" for m in ref for k in ("mu", "colors")) or not all(
            np.array_equal(got[f"{m}/{k}"], v) for m, r in ref.items() for k, v in r.items()):
        raise AssertionError("figures readout_positions: arrays differ from the plain path's")
    franke = generate_dataset(os.path.join(tmp, "franke"), ds_name="franke2022",
                              mouse_ids=("F", "G"), image_shape=(2, 36, 64))
    path = figures.main(figures.parse_args(["franke2022", "--data_dir", franke,
                                            "--mouse_ids", "F", "G", "--num_trials", "5"]))
    with np.load(path) as f:
        summary = {k: f[k] for k in f.files}
    if summary["examples/images"].shape[0] != 5 or summary["examples/order"].shape != (50,) \
            or int(summary["F/trials"]) != summary["examples/behavior"].shape[0]:
        raise AssertionError(f"figures franke2022: {sorted(summary)}")
    log(f"  figures readout_positions ({len(ref)} mice) equal the plain path's; franke2022 on a "
        f"synthetic franke2022 dataset: F {int(summary['F/neurons'])} neurons, "
        f"{int(summary['F/trials'])} trials, {int(summary['F/test'])} test; figures "
        f"{time.perf_counter() - fig_start:.1f} s")
    out["figures_main_figure"] = launches
    del model

    # export then import: the same predictions bit for bit
    export_checkpoint.main(["--output_dir", run, "--torch_out", os.path.join(tmp, "reference")])
    import_checkpoint.main(import_checkpoint.parse_args(
        ["--torch_dir", os.path.join(tmp, "reference"), "--output_dir",
         os.path.join(tmp, "imported")]))
    one = next(iter(val_ds["A"]))
    preds = [trainer_of(d, card).predict("A", one) for d in (run, os.path.join(tmp, "imported"))]
    if not np.array_equal(*preds):
        raise AssertionError("export / import: predictions differ")
    log("  export_checkpoint then import_checkpoint: the imported run's predictions equal the "
        "run's bit for bit")
    return out


def other_cores(card_text: str) -> dict:
    """Phase 5i: every core and readout beside vit + gaussian2d, on the card
    through ``training.inference`` and ``Trainer.train_step`` against the
    plain path with the same weights and seeds: cct at full width (one
    serving batch, one cycle of two train steps; rows 3-8 at its shapes),
    the Sensorium baseline stacked2d (the same; its running statistics after
    the cycle against the plain path's, bit for bit: its core runs no
    kernel), then stn, mixer and the linear and random cores with the
    dense, linear and random readouts (one serving batch, one cycle each)."""
    log("phase 5i: the other cores and readouts (cct at full width, the Sensorium "
        "baseline stacked2d, stn, mixer, linear, random; dense, linear, random readouts)")
    tol = dict(model=MODEL_TOL, core=CORE_TOL, loss=LOSS_TOL, grad=GRAD_TOL)
    out = {}
    for label, kw, per_step in [("cct + gaussian2d", CCT, CCT_LAUNCHES_PER_STEP)] + [
            (label, kw, SAMPLING_PER_STEP if kw.get("readout", "gaussian2d") == "gaussian2d"
             else NO_LAUNCHES) for label, kw in BASELINES.items()]:
        config = flagship_config(**kw)
        per_batch = {name: 0 if "bwd" in name or "wgrad" in name else n
                     for name, n in per_step.items()}
        serving, serve_one, images_per_s = serve(f"{label} serving", config, (1, 36, 64), 1,
                                                 per_batch, tol, card_text)
        torch.cuda.empty_cache()
        # stacked2d's and stn's BatchNorm and the mixer's LayerNorm cancel
        # the gradients of the biases ahead of them: held at their module's
        # scale
        norm_tol = (dict(tol, grad_scale="module")
                    if config.core in ("stacked2d", "stn", "mixer") else tol)
        launches, train_one, runs = train(f"{label} training", config, (1, 36, 64), 1,
                                          per_step, norm_tol, card_text)
        if config.core == "stacked2d":
            stats = {n: (b, dict(runs["plain"]["trainer"].model.named_buffers())[n])
                     for n, b in runs["kernel"]["trainer"].model.named_buffers()
                     if n.endswith(("running_mean", "running_var", "num_batches_tracked"))}
            differ = [n for n, (got, ref) in stats.items() if not torch.equal(got, ref)]
            log(f"  running statistics of {len(stats) // 3} BatchNorm layers after "
                f"{runs['kernel']['trainer']._step_count} train steps: "
                + ("bit for bit the plain path's" if not differ else f"differ: {differ}"))
            if differ:
                raise AssertionError(f"{label}: running statistics differ from the plain path")
        log(f"  {label}: serving {images_per_s:.1f} images/s, training "
            f"{runs['kernel']['images_per_s']:.1f} train images/s (plain "
            f"{runs['plain']['images_per_s']:.1f}) ({card_text})")
        out[label] = dict(serving=serving, launches=launches, serve_one=serve_one,
                          train_one=train_one, images_per_s=images_per_s,
                          train_images_per_s=runs["kernel"]["images_per_s"])
        del runs
        torch.cuda.empty_cache()
    return out


def deterministic_runs(card_text: str) -> dict:
    """Phase 5i, ``--deterministic``: under ``train.set_deterministic``
    (PyTorch's deterministic mode, cuDNN deterministic, no benchmark), two
    equal-seed runs of one cycle (two mice, two train steps, dropout and the
    readout's grid noise on) of each of ``DETERMINISTIC_PATHS`` from the
    same weights: the losses and every ``state_dict`` tensor bit for bit,
    the launches a step phase 5 counts (stacked2d + dense: none), every
    kernel ``training.fixed_order_kernels`` names among them; then one
    flagship step's device time under the mode beside the default's, under
    torch.profiler."""
    from v1t_tpu_torch import train as train_cli
    from v1t_tpu_torch.data.cards import synthetic_data_card
    from v1t_tpu_torch.models import build_model
    from v1t_tpu_torch.training import Trainer, fixed_order_kernels

    log("phase 5i: --deterministic, two equal-seed runs a path (" + ", ".join(
        DETERMINISTIC_PATHS) + ")")
    start = time.perf_counter()
    saved = (torch.are_deterministic_algorithms_enabled(), torch.backends.cudnn.benchmark,
             torch.backends.cudnn.deterministic)
    rng = np.random.default_rng(4)
    out = {}

    def restore_flags():
        torch.use_deterministic_algorithms(saved[0])
        torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic = saved[1:]

    try:
        for label, (kw, image_shape, per_step, neurons) in DETERMINISTIC_PATHS.items():
            config = flagship_config(deterministic=True, **kw)
            card = synthetic_data_card(mouse_ids=MICE, num_neurons=neurons,
                                       input_shape=image_shape)
            kernels = fixed_order_kernels(config.replace(input_shape=card.input_shape), DEVICE)
            state = flagship_model(config, card).state_dict()
            batches = [host_batch(rng, config.batch_size, image_shape, neurons) for _ in MICE]
            train_cli.set_deterministic(config)
            runs = []
            for _ in range(2):
                model = build_model(config, card, seed=None, device=DEVICE)
                model.load_state_dict(state)
                trainer = Trainer(config, model, card, device=DEVICE)
                torch.cuda.synchronize()
                zero_counts()
                acc, losses = None, []
                for i, mouse in enumerate(MICE):
                    acc, metrics = trainer.train_step(mouse, batches[i], acc,
                                                      update=i == len(MICE) - 1)
                    losses.append(float(metrics["loss/loss"]))
                torch.cuda.synchronize()
                runs.append((losses, {k: v.detach().clone() for k, v in model.state_dict().items()},
                             read_counts()))
                del model, trainer, acc
            restore_flags()
            (losses_a, state_a, launches), (losses_b, state_b, launches_b) = runs
            want = {name: n * len(MICE) for name, n in per_step.items()}
            differ = [k for k in state_a if not torch.equal(state_a[k], state_b[k])]
            moved = sum(not torch.equal(state_a[k], v) for k, v in state.items())
            log(f"  {label}: {len(MICE)} steps, losses {losses_a} / {losses_b}; {len(state_a)} "
                f"tensors, {moved} moved by the step, "
                + ("bit for bit" if not differ and losses_a == losses_b else
                   f"differ: {differ[:5]}") + f"; launches {launches}; fixed-order kernels "
                f"{kernels}")
            if differ or losses_a != losses_b or not moved or not np.isfinite(losses_a).all():
                raise AssertionError(f"--deterministic, {label}: two equal-seed runs differ")
            if launches != want or launches_b != want or any(not launches[k] for k in kernels):
                raise AssertionError(f"--deterministic, {label}: launches {launches} / "
                                     f"{launches_b} != {want}, or {kernels} not all launched")
            out[label] = dict(losses=losses_a, launches=launches, fixed_order_kernels=kernels)
            del runs, state_a, state_b, state
            torch.cuda.empty_cache()

        # one flagship step's device time under the mode and by default
        card = synthetic_data_card(mouse_ids=MICE, num_neurons=NEURONS, input_shape=(1, 36, 64))
        batch = host_batch(rng, B, (1, 36, 64), NEURONS)
        steps = {}
        for label, deterministic in (("--deterministic", True), ("default", False)):
            config = flagship_config(deterministic=deterministic)
            trainer = Trainer(config, flagship_model(config, card), card, device=DEVICE)
            if deterministic:
                train_cli.set_deterministic(config)
            step = functools.partial(trainer.train_step, MICE[0], batch, None, update=True)
            step()  # warm-up
            seen = where_the_time_goes(f"one flagship training step of {B}, {label}", step,
                                       "6 (5i)")
            restore_flags()
            steps[label] = None if seen is None else seen[0]
            del trainer
            torch.cuda.empty_cache()
    finally:
        restore_flags()
    seconds = time.perf_counter() - start
    log(f"  phase 5i --deterministic: {seconds:.1f} s; a flagship step's device time "
        + ", ".join(f"{k} " + ("not measured" if v is None else f"{v:.3f} ms")
                    for k, v in steps.items()) + f" ({card_text})")
    return dict(paths=out, step_ms=steps, seconds=seconds)


# --- phase 5j: data and sequence parallelism ------------------------------------------


@contextlib.contextmanager
def no_grid_noise():
    """The Gaussian readout's grid noise off in training (its mean grid):
    two ranks draw noise of their own by design, so runs that are held to a
    one-rank run draw none."""
    from v1t_tpu_torch.models.readouts.gaussian2d import Gaussian2DReadout

    draw = Gaussian2DReadout.sample_grid
    Gaussian2DReadout.sample_grid = lambda self, b, sample, generator=None: draw(
        self, b, False, generator)
    try:
        yield
    finally:
        Gaussian2DReadout.sample_grid = draw


def recording_update(trainer) -> dict:
    """The gradients the trainer's first AdamW step takes (under a grid:
    summed over the data ranks)."""
    grads, step = {}, trainer.optimizer.step

    def recording(*args, **kwargs):
        if not grads:
            grads.update({n: p.grad.detach().clone()
                          for n, p in trainer.model.named_parameters() if p.grad is not None})
        return step(*args, **kwargs)

    trainer.optimizer.step = recording
    return grads


def dp_cycles(mesh) -> dict:
    """Phase 5j (a): the flagship at batch 64 (under the grid 32 rows a
    rank), dropout and grid noise off, two cycles of ``Trainer.train_step``
    over two mice; the per-step losses, the first update's gradients and the
    launches."""
    from v1t_tpu_torch.data.cards import synthetic_data_card
    from v1t_tpu_torch.training import Trainer

    config = flagship_config(t_dropout=0.0, p_dropout=0.0)
    card = synthetic_data_card(mouse_ids=MICE, num_neurons=NEURONS, input_shape=(1, 36, 64))
    trainer = Trainer(config, flagship_model(config, card), card, device=DEVICE, mesh=mesh)
    grads = recording_update(trainer)
    rng = np.random.default_rng(2)
    warm = host_batch(rng, B, (1, 36, 64), NEURONS)
    batches = [[host_batch(rng, B, (1, 36, 64), NEURONS) for _ in MICE] for _ in range(CYCLES)]
    # a warm-up step without an update (a fresh rank's first launches and
    # collectives), as phase 5's; the cycles below start from zero gradients
    trainer.train_step(MICE[0], warm, None, update=False, sample=False)
    torch.cuda.synchronize()
    zero_counts()
    losses = []
    for cycle in range(CYCLES):
        # the last cycle is timed: the first holds AdamW's first step
        torch.cuda.synchronize()
        start, acc = time.perf_counter(), None
        for i, mouse in enumerate(MICE):
            acc, metrics = trainer.train_step(mouse, batches[cycle][i], acc,
                                              update=i == len(MICE) - 1, sample=False)
            losses.append(metrics["loss/loss"])
    torch.cuda.synchronize()
    return dict(losses=[float(v) for v in losses], grads=grads, launches=read_counts(),
                seconds=time.perf_counter() - start)


def dp_dropout(mesh) -> dict:
    """Phase 5j (a), dropout on: one flagship step at the flagship's rates;
    then the keep mask of the step's first attention site, drawn by the
    flash kernel with this rank's seed (q = 0 spreads P evenly, v = 1 makes
    o the kept share of the keys divided by the keep rate)."""
    from v1t_tpu_torch.data.cards import synthetic_data_card
    from v1t_tpu_torch.ops.dropout import Dropout, step_seed
    from v1t_tpu_torch.ops.flash_attention import flash_fwd
    from v1t_tpu_torch.training import Trainer

    config = flagship_config()
    card = synthetic_data_card(mouse_ids=MICE, num_neurons=NEURONS, input_shape=(1, 36, 64))
    trainer = Trainer(config, flagship_model(config, card), card, device=DEVICE, mesh=mesh)
    batch = host_batch(np.random.default_rng(3), B, (1, 36, 64), NEURONS)
    _, metrics = trainer.train_step(MICE[0], batch, None, update=False)
    seed = step_seed(config.seed, trainer._step_count, mesh.data.index if mesh else 0)
    from v1t_tpu_torch.ops.ln_linear import padded_head_dim

    rows = B // (mesh.data_size if mesh else 1)
    q = torch.zeros(rows * H, N, padded_head_dim(E), dtype=torch.bfloat16, device=DEVICE)
    v = torch.zeros_like(q)
    v[..., 0] = 1.0
    o = flash_fwd(q, q, v, E, H, drop=Dropout(T_DROP, seed, 0))
    kept = o[..., 0].float() * (1.0 - T_DROP)  # (B, N, H): each row's kept share
    return dict(loss=float(metrics["loss/loss"]), seed=seed, keep=float(kept.mean()),
                draws=kept.numel() * N, row=kept[0, :, 0].cpu())


def dp_loop(argv: list, out: str) -> list:
    """Phase 5j (b): ``train.main`` for 2 epochs on phase 5e's dataset,
    dropout and grid noise off; each epoch's results. PyTorch's
    deterministic flags, which ``--deterministic`` turns on, are restored
    after the run."""
    from v1t_tpu_torch import train as train_cli

    epochs = []

    class Hooks:
        def run_start(self, *args):
            pass

        def epoch_end(self, epoch, train_result, val_result, trainer, scheduler):
            epochs.append(dict(epoch=epoch, train_loss=train_result["loss"],
                               val_loss=val_result["loss"],
                               corr=val_result["single_trial_correlation"]))

        def run_end(self, *args):
            pass

    saved = (torch.are_deterministic_algorithms_enabled(), torch.backends.cudnn.benchmark,
             torch.backends.cudnn.deterministic)
    try:
        with no_grid_noise():
            train_cli.main(train_cli.parse_config(argv + ["--output_dir", out]), hooks=Hooks())
    finally:
        torch.use_deterministic_algorithms(saved[0])
        torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic = saved[1:]
    return epochs


def sp_fullres(mesh, impl: str, deterministic: bool = False) -> dict:
    """Phase 5j (c): the full-resolution flagship (34,114 tokens, batch 2,
    two mice), dropout off: one serving batch and one train step with its
    update, grid noise off, under the grid's seq axis with ``impl`` (None:
    one rank); predictions, the loss, the update's gradients and the
    launches of each. ``deterministic``: the config's flag, under PyTorch's
    deterministic mode (the caller's)."""
    from v1t_tpu_torch.data.cards import synthetic_data_card
    from v1t_tpu_torch.training import Trainer

    from v1t_tpu_torch.models.cores import vit

    config = flagship_config(batch_size=FR_B, t_dropout=0.0, p_dropout=0.0,
                             sequence_parallel=mesh.num_devices if mesh else 0,
                             sequence_parallel_impl=impl or "allgather",
                             deterministic=deterministic)
    card = synthetic_data_card(mouse_ids=MICE, num_neurons=NEURONS, input_shape=FR_IMAGE)
    trainer = Trainer(config, flagship_model(config, card), card, device=DEVICE, mesh=mesh)
    grads = recording_update(trainer)
    sharded, calls = vit.sharded_attention, []  # the attention sublayers that sharded

    def counting(*args, **kwargs):
        calls.append(1)
        return sharded(*args, **kwargs)

    vit.sharded_attention = counting
    rng = np.random.default_rng(4)
    serve_batch, train_batch = (host_batch(rng, FR_B, FR_IMAGE, NEURONS) for _ in range(2))
    torch.cuda.synchronize()
    zero_counts()
    start = time.perf_counter()
    preds = trainer.predict("A", serve_batch)
    torch.cuda.synchronize()
    serve_s, serving = time.perf_counter() - start, read_counts()
    zero_counts()
    start = time.perf_counter()
    _, metrics = trainer.train_step("A", train_batch, None, update=True, sample=False)
    torch.cuda.synchronize()
    vit.sharded_attention = sharded
    return dict(preds=preds, loss=float(metrics["loss/loss"]), grads=grads, serving=serving,
                sharded=len(calls),
                launches=read_counts(), serve_s=serve_s, step_s=time.perf_counter() - start,
                step=lambda: trainer.train_step("A", train_batch, None, update=True,
                                                sample=False))


def sp_twice(mesh, impl: str) -> dict:
    """Phase 5j (c) under ``--deterministic``: ``sp_fullres`` twice with the
    config's flag and PyTorch's deterministic mode on (``train.
    set_deterministic``); the serving batch's predictions, the step's loss
    and every gradient of its update compared bit for bit. Returns the
    names that differ (empty: bit for bit) and the largest |d| / max|ref|,
    or the error a run raised."""
    from v1t_tpu_torch import train as train_cli

    saved = (torch.are_deterministic_algorithms_enabled(), torch.backends.cudnn.benchmark,
             torch.backends.cudnn.deterministic)
    try:
        train_cli.set_deterministic(flagship_config(deterministic=True))
        runs = []
        for _ in range(2):
            run = sp_fullres(mesh, impl, deterministic=True)
            run.pop("step")
            runs.append(run)
            torch.cuda.empty_cache()
    except RuntimeError as err:
        return dict(error=str(err)[:400])
    finally:
        torch.use_deterministic_algorithms(saved[0])
        torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic = saved[1:]
    a, b = runs
    differ = [] if np.array_equal(a["preds"], b["preds"]) else ["predictions"]
    differ += [] if a["loss"] == b["loss"] else ["loss"]
    differ += [n for n in a["grads"] if not torch.equal(a["grads"][n], b["grads"][n])]
    worst = max(grad_rels(b["grads"], a["grads"], f"{impl} twice").values())
    return dict(differ=differ, grads=len(a["grads"]), worst=worst, launches=a["launches"])


def parallel_rank(argv: list) -> int:
    """One rank of phase 5j: ``chip_smoke.py --parallel-rank RANK WORLD DIR
    BACKEND``; its results go to DIR/rank<RANK>.pt."""
    import datetime

    import torch.distributed as dist

    from v1t_tpu_torch.parallel import DataParallel

    rank, world, out, backend = int(argv[0]), int(argv[1]), argv[2], argv[3]
    torch.cuda.set_device(rank if backend == "nccl" else 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group(backend, init_method=f"file://{out}/store", world_size=world,
                            rank=rank, timeout=datetime.timedelta(seconds=PAR_RANK_LIMIT))
    try:
        mesh = DataParallel.create()
        result = dict(dp=dp_cycles(mesh), dropout=dp_dropout(mesh))
        with open(os.path.join(out, "argv.json")) as f:
            argv = json.load(f)
        result["loop"] = dp_loop(argv, os.path.join(out, f"run{rank}"))
        sp = DataParallel.create(sequence_parallel=world)
        for impl in ("allgather", "ring"):
            result[impl] = sp_fullres(sp, impl)
            step = result[impl].pop("step")
            torch.cuda.empty_cache()
        # --deterministic across ranks: the DP loop and each SP step again
        # under the mode, each against its first run, bit for bit
        result["loop_again"] = dp_loop(argv, os.path.join(out, f"again{rank}"))
        result["sp_deterministic"] = {impl: sp_twice(sp, impl) for impl in ("allgather", "ring")}
        # the device's busy share of one ring step (rank 0 profiled, rank 1
        # running the same step beside it)
        if rank == 0:
            busy = where_the_time_goes(f"one full-resolution train step of {FR_B} under SP "
                                       f"{world} (ring, {backend}), rank 0", step, "5j")
            result["ring_busy_ms"] = None if busy is None else busy[0]
        else:
            step()
        torch.cuda.synchronize()
        torch.save(result, os.path.join(out, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()
    return 0


def run_ranks(out: str, backend: str) -> list:
    """Start the ranks, wait for them within ``PAR_RANK_LIMIT`` (a rank that
    fails stops the others), print their logs and return their results."""
    procs, logs = [], []
    for rank in range(PAR_RANKS):
        logs.append(open(os.path.join(out, f"rank{rank}.log"), "w"))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--parallel-rank", str(rank),
             str(PAR_RANKS), out, backend], stdout=logs[-1], stderr=subprocess.STDOUT))
    deadline = time.time() + PAR_RANK_LIMIT
    try:
        while any(p.poll() is None for p in procs):
            if time.time() > deadline or any(p.poll() not in (None, 0) for p in procs):
                break
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in logs:
            f.close()
    failed = []
    for rank, p in enumerate(procs):
        with open(os.path.join(out, f"rank{rank}.log")) as f:
            text = f.read()
        for line in text.splitlines():
            log(f"  [rank {rank}] {line}")
        if p.returncode != 0:
            failed.append(rank)
    if failed:
        raise AssertionError(f"phase 5j: ranks {failed} failed or ran past {PAR_RANK_LIMIT} s "
                             f"(exit codes {[p.returncode for p in procs]})")
    # each rank's tensors onto this process's device (ranks on two cards
    # saved theirs on cuda:0 and cuda:1)
    return [torch.load(os.path.join(out, f"rank{r}.pt"), map_location=DEVICE,
                       weights_only=False) for r in range(PAR_RANKS)]


def parallel_paths(card_text: str, loop: dict, tmp: str) -> dict:
    """Phase 5j: two ranks against one. The one-rank runs first (the
    references), then the ranks: (a) the flagship's two cycles under DP 2
    and a dropout step; (b) ``train.main`` for 2 epochs on phase 5e's
    dataset; (c) full resolution under SP 2, all-gather and ring."""
    backend = "nccl" if torch.cuda.device_count() >= PAR_RANKS else "gloo"
    log(f"phase 5j: data and sequence parallelism, {PAR_RANKS} ranks "
        + ("on two cards over NCCL" if backend == "nccl" else
           "on one card over gloo (NCCL refuses two ranks on one card; device tensors go "
           "through host buffers)"))
    start = time.perf_counter()
    out = os.path.join(tmp, "parallel")
    os.makedirs(out)
    ref_dp = dp_cycles(None)
    # phase 5e's flags (--data_parallel 1) with dropout off, under
    # --deterministic: in the default mode dq's float atomics add a spread of
    # their own to each side, on top of the grid's rounding, and it carried a
    # second epoch's validation correlation past LOOP_TOL; the ranks run the
    # flags with --data_parallel 0, and each rank's --output_dir comes last
    argv = loop["argv"](os.path.join(out, "single"), 2, "--t_dropout", "0", "--p_dropout", "0",
                        "--deterministic")
    with open(os.path.join(out, "argv.json"), "w") as f:
        json.dump(argv + ["--data_parallel", "0"], f)
    ref_loop = dp_loop(argv, os.path.join(out, "single"))
    # for scale, not held: two one-rank runs in the default mode
    default = [a for a in argv if a != "--deterministic"]
    spread = [dp_loop(default, os.path.join(out, f"default{i}")) for i in range(2)]
    ref_sp = sp_fullres(None, None)
    ref_sp.pop("step")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    ref_s = time.perf_counter() - start
    ranks = run_ranks(out, backend)
    rank_s = time.perf_counter() - start - ref_s

    log("  (a) the flagship, batch 64 under DP 2 (32 rows a rank), dropout and grid noise off, "
        "against one rank on the same weights and batches")
    expected = {k: n * CYCLES * len(MICE) for k, n in TRAIN_LAUNCHES_PER_STEP.items()}
    for rank, r in enumerate(ranks):
        if r["dp"]["launches"] != expected:
            raise AssertionError(f"5j (a) rank {rank}: launches {r['dp']['launches']} != "
                                 f"{expected}")
        hold(f"5j (a) rank {rank}", r["dp"], ref_dp, dict(loss=LOSS_TOL, grad=GRAD_TOL),
             ("two ranks", "one rank"))
    if ranks[0]["dp"]["losses"] != ranks[1]["dp"]["losses"]:
        raise AssertionError("5j (a): the ranks' summed losses differ")
    log(f"  ranks' launches over {CYCLES * len(MICE)} steps (each): {ranks[0]['dp']['launches']};"
        f" train images/s over the last cycle: one rank {len(MICE) * B / ref_dp['seconds']:.1f}, "
        f"two ranks {len(MICE) * B / max(r['dp']['seconds'] for r in ranks):.1f} ({card_text})")
    drops = [r["dropout"] for r in ranks]
    for rank, d in enumerate(drops):
        # 5 sigma of the draws' binomial spread, and 1e-4 for o's bf16 rounding
        tol = 5.0 * (T_DROP * (1.0 - T_DROP) / d["draws"]) ** 0.5 + 1e-4
        ok = np.isfinite(d["loss"]) and abs(d["keep"] - (1.0 - T_DROP)) <= tol
        log(f"  dropout on, rank {rank}: loss {d['loss']:.6f}, seed {d['seed']}, the kernel's "
            f"keep rate at block 0 {d['keep']:.5f} of {d['draws']} draws (want "
            f"{1.0 - T_DROP:.5f} +- {tol:.1e}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"5j (a) rank {rank}: dropout step")
    if drops[0]["seed"] == drops[1]["seed"] or torch.equal(drops[0]["row"], drops[1]["row"]):
        raise AssertionError("5j (a): the two ranks drew the same dropout masks")
    log("  the ranks' masks differ (distinct seeds; sample 0's kept shares differ)")

    log("  (b) train.main, 2 epochs on phase 5e's dataset, dropout and grid noise off, "
        "--deterministic, against one rank")
    if not os.path.isfile(os.path.join(out, "run0", "ckpt", "model_state.pt")) \
            or os.path.exists(os.path.join(out, "run1")):
        raise AssertionError("5j (b): rank 0 alone must write the run")
    for got, ref in zip(ranks[0]["loop"], ref_loop):
        for key in ("train_loss", "val_loss"):
            rel = abs(got[key] - ref[key]) / abs(ref[key])
            log(f"  epoch {got['epoch']} {key}: two ranks {got[key]:.6f} one {ref[key]:.6f} "
                f"|d|/|ref| {rel:.3e} (tol {LOOP_TOL['loss']:g}) "
                f"{'ok' if rel <= LOOP_TOL['loss'] else 'FAIL'}")
            if rel > LOOP_TOL["loss"]:
                raise AssertionError(f"5j (b): epoch {got['epoch']} {key}")
        err = abs(got["corr"] - ref["corr"])
        log(f"  epoch {got['epoch']} validation correlation |d| {err:.3e} (tol "
            f"{LOOP_TOL['corr']:g}) {'ok' if err <= LOOP_TOL['corr'] else 'FAIL'}")
        if err > LOOP_TOL["corr"]:
            raise AssertionError(f"5j (b): epoch {got['epoch']} validation correlation")
    log("  for scale, two one-rank runs in the default mode part by " + "; ".join(
        f"epoch {a['epoch']} |d| {abs(a['corr'] - b['corr']):.3e} in validation correlation"
        for a, b in zip(*spread)))
    if len(ranks[0]["loop"]) != 2 or ranks[0]["loop"] != ranks[1]["loop"]:
        raise AssertionError("5j (b): the ranks' epochs differ")
    log("  rank 0 alone wrote the run; the ranks' epochs are equal")
    again = [r["loop_again"] for r in ranks]
    log("  --deterministic across ranks: the two-rank loop run again, epochs " + "; ".join(
        f"{a['epoch']}: train loss {a['train_loss']!r} / {b['train_loss']!r}, validation "
        f"correlation {a['corr']!r} / {b['corr']!r}" for a, b in zip(ranks[0]["loop"], again[0]))
        + (" (bit for bit)" if again[0] == ranks[0]["loop"] and again[1] == ranks[1]["loop"]
           else " DIFFER"))
    if again[0] != ranks[0]["loop"] or again[1] != ranks[1]["loop"] \
            or not os.path.isfile(os.path.join(out, "again0", "ckpt", "model_state.pt")) \
            or os.path.exists(os.path.join(out, "again1")):
        raise AssertionError("5j (b): two runs of the two-rank loop under --deterministic "
                             "differ, or rank 1 wrote one")

    log(f"  (c) full resolution ({FR_N} tokens, batch {FR_B}) under SP {PAR_RANKS}, against one "
        "rank")
    launches = {}
    for impl in ("allgather", "ring"):
        flash = SP_FLASH_PER_STEP[impl]
        for rank, r in enumerate(ranks):
            got = r[impl]
            step = dict(FULLRES_LAUNCHES_PER_STEP, flash_attention=flash, flash_attention_bwd=flash)
            serving = {k: 0 if "bwd" in k or "wgrad" in k else v for k, v in step.items()}
            blocks = flagship_config().num_blocks
            if got["sharded"] != 2 * blocks:  # a serving batch and a train step
                raise AssertionError(f"5j (c) {impl} rank {rank}: {got['sharded']} attention "
                                     f"sublayers sharded their tokens, not {2 * blocks}")
            if got["launches"] != step or got["serving"] != serving:
                raise AssertionError(f"5j (c) {impl} rank {rank}: launches {got['launches']} / "
                                     f"serving {got['serving']} != {step} / {serving}")
            err = float(np.abs(got["preds"] - ref_sp["preds"]).max())
            rel = err / float(np.abs(ref_sp["preds"]).max())
            log(f"  {impl} rank {rank}: responses max|d|/max|ref| {rel:.3e} (tol "
                f"{FULLRES_TOL['model']:g}) {'ok' if rel <= FULLRES_TOL['model'] else 'FAIL'}; "
                f"serving {got['serve_s']:.3f} s, train step {got['step_s']:.3f} s (one rank "
                f"{ref_sp['serve_s']:.3f}, {ref_sp['step_s']:.3f})")
            if rel > FULLRES_TOL["model"]:
                raise AssertionError(f"5j (c) {impl} rank {rank}: responses")
            hold(f"5j (c) {impl} rank {rank}", dict(losses=[got["loss"]], grads=got["grads"]),
                 dict(losses=[ref_sp["loss"]], grads=ref_sp["grads"]), FULLRES_TOL,
                 (f"SP {impl}", "one rank"))
            launches[f"sp_{impl}_training_rank{rank}"] = got["launches"]
            launches[f"sp_{impl}_serving_rank{rank}"] = got["serving"]
        log(f"  {impl}: per rank a step flash forward {flash}, backward {flash} (one rank: "
            f"{FULLRES_LAUNCHES_PER_STEP['flash_attention']})")
        for rank, r in enumerate(ranks):
            det = r["sp_deterministic"][impl]
            ok = "error" not in det and not det["differ"]
            log(f"  {impl} rank {rank} under --deterministic, two runs: " + (
                f"raised {det['error']}" if "error" in det else
                f"predictions, loss and {det['grads']} gradients "
                + ("bit for bit" if ok else f"differ in {det['differ'][:6]} (largest |d| / "
                                            f"max|ref| {det['worst']:.3e})")))
            if not ok:
                raise AssertionError(f"5j (c) {impl} rank {rank}: two runs under "
                                     "--deterministic differ")
    launches["dp_training_rank0"] = ranks[0]["dp"]["launches"]
    seconds = time.perf_counter() - start
    log(f"  phase 5j: {seconds:.1f} s (one-rank references {ref_s:.1f} s, ranks {rank_s:.1f} s; "
        f"{card_text})")
    return dict(launches=launches, seconds=seconds, ring_busy_ms=ranks[0].get("ring_busy_ms"))


# --- phase 5k: pretraining, the frozen core and the tools ------------------------------


def pretrain_dataset():
    """Phase 5k's images: uint8 RGB from a numpy seed through
    ``transform_image`` (standardised 1x36x64), labels over
    ``PRETRAIN_CLASSES`` classes (the last one among them)."""
    from v1t_tpu_torch.pretrain.data import ArrayImageDataset, transform_image

    rng = np.random.default_rng(18)
    raw = rng.integers(0, 256, size=(PRETRAIN_IMAGES, *PRETRAIN_RAW), dtype=np.uint8)
    images = np.stack([transform_image(image, resize_image=1) for image in raw])
    labels = rng.integers(0, PRETRAIN_CLASSES, size=PRETRAIN_IMAGES).astype(np.int32)
    labels[0] = PRETRAIN_CLASSES - 1
    return ArrayImageDataset(images, labels, seed=1234)


def pretrain_steps(label: str, args, dataset, tol: dict, card_text: str) -> dict:
    """Two ``pretrain.train_step``s from the same weights, seeds and batches
    through the kernels (the counters set to 0 just before and read just
    after) and through the plain path: the losses and every parameter's
    first-step gradient held, the launches a step checked; then train
    images/s over 4 more kernel steps (``profiler.StepTimer``) and one
    step's device time under ``torch.profiler``."""
    from v1t_tpu_torch.pretrain import __main__ as pretrain
    from v1t_tpu_torch.utils.profiler import StepTimer

    config = pretrain.make_config(args)
    shape = tuple(dataset.images.shape[1:])
    batches = [(torch.from_numpy(images).to(DEVICE),
                torch.from_numpy(labels.astype(np.int64)).to(DEVICE))
               for images, labels in dataset.loader("train", B, shuffle=True, seed=1)()][:2]
    model = pretrain.build(config, shape, PRETRAIN_CLASSES, args.mode, DEVICE)
    state = {k: v.clone() for k, v in model.state_dict().items()}
    runs = {}
    for path in ("kernel", "plain"):
        cfg = config if path == "kernel" else plain_config(config)
        if path == "plain":
            model = pretrain.build(cfg, shape, PRETRAIN_CLASSES, args.mode, DEVICE)
            model.load_state_dict(state)
        optimizer = pretrain.build_optimizer(cfg, model)
        torch.cuda.synchronize()
        zero_counts()
        losses, grads = [], None
        start = time.perf_counter()
        for step, (images, labels) in enumerate(batches, 1):
            loss, _ = pretrain.train_step(model, optimizer, args.mode, images, labels, cfg, step)
            losses.append(loss)
            if grads is None:
                grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        runs[path] = dict(losses=[float(v) for v in losses], grads=grads, launches=read_counts(),
                          model=model, optimizer=optimizer)
        log(f"  {path} path: {len(batches)} pretraining steps of {B} in {seconds:.4f} s; losses "
            + " ".join(f"{v:.6f}" for v in runs[path]["losses"]))
    expected = {k: v * len(batches) for k, v in PRETRAIN_LAUNCHES_PER_STEP.items()}
    log(f"  kernel path launches over {len(batches)} steps: {runs['kernel']['launches']}")
    if runs["kernel"]["launches"] != expected:
        raise AssertionError(f"{label}: launch counts {runs['kernel']['launches']} != {expected}")
    if any(runs["plain"]["launches"].values()):
        raise AssertionError(f"{label}: the plain path launched kernels")
    hold(label, runs["kernel"], runs["plain"], tol)

    model, optimizer = runs["kernel"]["model"], runs["kernel"]["optimizer"]
    images, labels = batches[0]
    del runs["plain"]
    timer = StepTimer()
    for step in range(3, 8):
        timer.start()
        loss, _ = pretrain.train_step(model, optimizer, args.mode, images, labels, config, step)
        timer.stop(loss)
    seconds = sum(timer.times[1:]) / len(timer.times[1:])  # the first: a warm-up
    busy = where_the_time_goes(f"one {label} step of {B}", lambda: pretrain.train_step(
        model, optimizer, args.mode, images, labels, config, 8), phase="6 (5k)")
    log(f"  {label}: {B / seconds:.1f} train images/s over 4 steps by the host clock, "
        f"device busy {'not measured' if busy is None else f'{busy[0]:.3f} ms'} a step "
        f"({card_text})")
    return dict(launches=runs["kernel"]["launches"], images_per_s=B / seconds,
                busy_ms=None if busy is None else busy[0], model=model, optimizer=optimizer,
                batch=batches[0], config=config)


def pretrain_run(label: str, args, dataset) -> dict:
    """``pretrain.run`` for ``args.epochs`` epochs to its checkpoint, the
    counters set to 0 just before and read just after: every step's and
    validation batch's launches."""
    from v1t_tpu_torch.pretrain import __main__ as pretrain
    from v1t_tpu_torch.utils.scheduler import load_checkpoint_file

    torch.cuda.synchronize()
    zero_counts()
    start = time.perf_counter()
    result = pretrain.run(pretrain.make_config(args), args, dataset)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    launches = read_counts()
    epochs = len(result["epochs"])
    val_batches = -(-len(dataset.splits["validation"]) // args.batch_size) * epochs
    expected = {k: result["steps"] * PRETRAIN_LAUNCHES_PER_STEP[k]
                + val_batches * PRETRAIN_SERVE_PER_BATCH[k] for k in PRETRAIN_LAUNCHES_PER_STEP}
    log(f"  pretrain.run ({label}): {epochs} epochs, {result['steps']} steps, {val_batches} "
        f"validation batches in {seconds:.2f} s; {result['epochs']}; launches {launches}")
    if launches != expected:
        raise AssertionError(f"{label} run: launches {launches} != {expected}")
    values = [v for e in result["epochs"] for k, v in e.items() if k != "epoch" and v is not None]
    if not all(np.isfinite(values)):
        raise AssertionError(f"{label} run: non-finite results {result['epochs']}")
    ckpt = load_checkpoint_file(os.path.join(args.output_dir, "ckpt", "model_state.pt"))
    head = "head" if args.mode == 0 else "decoder"
    heads = sorted(k for k in ckpt["model"] if not k.startswith("core."))
    if heads != [f"{head}.bias", f"{head}.weight"] or "optimizer" in ckpt:
        raise AssertionError(f"{label} run: checkpoint holds {heads} beside the core")
    return dict(launches=launches, result=result, seconds=seconds)


def frozen_core(card_text: str, loop: dict, tmp: str, pre: str) -> dict:
    """Phase 5k (c): ``train.main --pretrain_core <pre>`` on phase 5e's
    dataset for 2 epochs, then one cycle at shift mode 2 and at shift mode 1
    against the plain path; the core after training equal to the injected
    one bit for bit."""
    from v1t_tpu_torch import train as train_cli
    from v1t_tpu_torch.utils.scheduler import load_checkpoint_file

    injected = {k: v for k, v in load_checkpoint_file(
        os.path.join(pre, "ckpt", "model_state.pt"))["model"].items() if k.startswith("core.")}

    def same_core(label: str, model) -> None:
        state = model.state_dict()
        differ = [k for k, v in injected.items() if not torch.equal(state[k].cpu(), v)]
        trains = [n for n, p in model.named_parameters() if n.startswith("core.")
                  and p.requires_grad]
        if differ or trains:
            raise AssertionError(f"{label}: core entries {differ[:4]} differ from the injected "
                                 f"ones, {trains[:4]} take gradients")
        log(f"  {label}: the core's {len(injected)} injected entries equal bit for bit")

    serve_per_batch = dict(PRETRAIN_SERVE_PER_BATCH, bilinear_sample_cm=1)
    hooks = LoopHooks(serve_per_batch, FROZEN_LAUNCHES_PER_STEP)
    out = os.path.join(tmp, "frozen")
    start = time.perf_counter()
    result = train_cli.main(train_cli.parse_config(loop["argv"](out, 2, "--pretrain_core", pre)),
                            hooks=hooks)
    log(f"  train.main --pretrain_core: epochs {hooks.epochs}, test {result}, launches "
        f"{hooks.launches} in {time.perf_counter() - start:.1f} s")
    same_core("train.main --pretrain_core", hooks.trainer.model)
    launches = {"frozen_core_loop_epoch_1": hooks.launches["epoch 1"]}
    for shift in (2, 1):
        label = f"frozen core, shift mode {shift}"
        config = flagship_config(shift_mode=shift, pretrain_core=pre)
        launches[f"frozen_core_shift_{shift}_training"], train_one, runs = train(
            label, config, (1, 36, 64), 1, FROZEN_LAUNCHES_PER_STEP,
            dict(loss=LOSS_TOL, grad=GRAD_TOL), card_text, core_frozen=True)
        for path, run in runs.items():
            same_core(f"{label}, {path} path", run["trainer"].model)
        if shift == 2:
            where_the_time_goes(f"one training step of {B} with the core frozen", train_one,
                                phase="6 (5k)")
        del runs, train_one
        torch.cuda.empty_cache()
    return launches


def tools_on_the_run(card_text: str, loop: dict, tmp: str) -> dict:
    """Phase 5k: the sweep's local search, ``estimate_aRFs`` against the
    plain path and the other analysis scripts on phase 5e's run."""
    import types

    from v1t_tpu_torch import sweep
    from v1t_tpu_torch.misc import behaviorMLP_visualization, core_pca, estimate_aRFs
    from v1t_tpu_torch.misc import prediction_v_dilation
    from v1t_tpu_torch.misc.common import restore_run
    from v1t_tpu_torch.models import build_model

    torch.cuda.synchronize()
    zero_counts()
    start = time.perf_counter()
    results = sweep.main(sweep.parse_args([
        "--dataset", loop["root"], "--output_dir", os.path.join(tmp, "sweep"), "--local",
        "--sweep_config", SWEEP_CONFIG, "--count", "2", "--epochs", "1", "--batch_size", str(B),
        "--mouse_ids", *LOOP_MICE]))
    torch.cuda.synchronize()
    sweep_launches = read_counts()
    log(f"  sweep --local: {len(results)} trials in {time.perf_counter() - start:.1f} s: "
        + "; ".join(f"trial {r['trial']} {r['overrides']} -> test correlation "
                    f"{r['single_trial_correlation']:.4f}" for r in results)
        + f"; launches {sweep_launches}")
    if len(results) != 2 or not all(np.isfinite(r["single_trial_correlation"]) for r in results):
        raise AssertionError(f"sweep --local: {results}")
    # the trials (vit + gaussian2d in bf16, below FUSED_MAX_N tokens) train
    # and serve through rows 1-6
    idle = [name for name in ("ln_linear", "attention", "ln_linear_bwd", "ln_linear_wgrad",
                              "attention_bwd", "bilinear_sample_cm", "bilinear_sample_cm_bwd")
            if not sweep_launches[name]]
    if idle:
        raise AssertionError(f"sweep --local: kernels {idle} never launched")

    config, model, loaders, _ = restore_run(loop["run"], B)
    plain = build_model(plain_config(config), loaders["card"], seed=None, device=DEVICE)
    plain.load_state_dict(model.state_dict())
    images, noise = estimate_aRFs.generate_noise(ARF_SAMPLES)
    responses, seconds = {}, {}
    for path, m in (("kernel", model), ("plain", plain)):
        estimate_aRFs.white_noise_responses(m, images[:B], "A", B)  # warm-up
        torch.cuda.synchronize()
        zero_counts()
        start = time.perf_counter()
        responses[path] = estimate_aRFs.white_noise_responses(m, images, "A", B)
        torch.cuda.synchronize()
        seconds[path] = time.perf_counter() - start
        if path == "kernel":
            arf_launches = read_counts()
    batches = ARF_SAMPLES // B
    expected = {k: batches * v for k, v in dict(PRETRAIN_SERVE_PER_BATCH,
                                                   bilinear_sample_cm=1).items()}
    if arf_launches != expected:
        raise AssertionError(f"estimate_aRFs: launches {arf_launches} != {expected}")
    got, ref = responses["kernel"], responses["plain"]
    rel = float(np.abs(got - ref).max() / np.abs(ref).max())
    arfs = estimate_aRFs.estimate_RFs(got, noise)
    ref_arfs = estimate_aRFs.estimate_RFs(ref, noise)
    arf_rel = float(np.abs(arfs - ref_arfs).max() / np.abs(ref_arfs).max())
    log(f"  estimate_aRFs: {ARF_SAMPLES} noise images, kernel path "
        f"{ARF_SAMPLES / seconds['kernel']:.1f} images/s, plain {ARF_SAMPLES / seconds['plain']:.1f}"
        f" ({card_text}); launches {arf_launches}; responses vs plain max|d|/max|ref| {rel:.3e}, "
        f"aRFs {arf_rel:.3e} (tol {MODEL_TOL:g})")
    if rel > MODEL_TOL or arf_rel > MODEL_TOL or got.shape != (ARF_SAMPLES, NEURONS):
        raise AssertionError(f"estimate_aRFs: responses {got.shape} {rel:.3e}, aRFs {arf_rel:.3e}")
    popts = estimate_aRFs.fit_gaussian(arfs[:32])
    log(f"  estimate_aRFs: Gaussian fits of 32 neurons, {int(np.isfinite(popts).all(1).sum())} "
        "converged")
    del plain, model
    torch.cuda.empty_cache()

    ns = types.SimpleNamespace(output_dir=loop["run"], batch_size=B, num_components=5)
    pca = core_pca.main(ns)
    dilation = prediction_v_dilation.main(ns)
    latents = behaviorMLP_visualization.main(ns)
    for mouse in LOOP_MICE:
        values = [pca[mouse]["components"], pca[mouse]["behavior_corr"],
                  list(dilation[mouse].values()), *latents[mouse]["latents"].values()]
        if not all(np.isfinite(np.asarray(v, np.float64)).all() for v in values):
            raise AssertionError(f"the analysis scripts: non-finite output for mouse {mouse}")
        shapes = {k: v.shape for k, v in latents[mouse]["latents"].items()}
        log(f"  mouse {mouse}: core_pca components {pca[mouse]['components'].shape}, "
            f"|corr| max {np.abs(pca[mouse]['behavior_corr']).max():.3f}; dilation "
            f"{dilation[mouse]}; b-MLP latents {shapes}")
    for name in ("aRFs.pkl", "core_pca.pkl", "prediction_v_dilation.pkl",
                 "behavior_mlp_latents.pkl"):
        if name != "aRFs.pkl" and not os.path.isfile(os.path.join(loop["run"], name)):
            raise AssertionError(f"the analysis scripts wrote no {name}")
    return dict(aRF_serving=arf_launches, sweep_local=sweep_launches)


def pretraining_paths(card_text: str, loop: dict, tmp: str) -> dict:
    """Phase 5k: (a) classification and (b) reconstruction pretraining of
    the flagship core, (c) ``--pretrain_core`` with a frozen core, and the
    tools on phase 5e's run; a profiler trace of two pretraining steps."""
    from v1t_tpu_torch.pretrain import __main__ as pretrain
    from v1t_tpu_torch.utils.profiler import trace

    log("phase 5k: pretraining of the flagship core (behavior mode 0), --pretrain_core with a "
        "frozen core, and the tools")
    start = time.perf_counter()
    dataset = pretrain_dataset()
    log(f"  {PRETRAIN_IMAGES} synthetic images ({'x'.join(map(str, PRETRAIN_RAW))} uint8 -> "
        f"{dataset.images.shape[1:]}), {PRETRAIN_CLASSES} classes, split "
        f"{ {k: len(v) for k, v in dataset.splits.items()} }, made in "
        f"{time.perf_counter() - start:.1f} s")
    launches, steps = {}, {}
    for mode, name in ((0, "classification"), (1, "reconstruction")):
        args = pretrain.parse_args(["--dataset", "-", "--output_dir",
                                    os.path.join(tmp, f"pretrain_{name}"), "--mode", str(mode),
                                    "--epochs", "2", "--batch_size", str(B)])
        log(f"  ({'ab'[mode]}) {name} pretraining, kernel path against the plain path")
        steps[name] = pretrain_steps(f"{name} pretraining", args, dataset,
                                     dict(loss=LOSS_TOL, grad=GRAD_TOL), card_text)
        launches[f"pretrain_{name}_training"] = steps[name]["launches"]
        launches[f"pretrain_{name}_run"] = pretrain_run(name, args, dataset)["launches"]
        torch.cuda.empty_cache()

    first = steps["classification"]
    images, labels = first["batch"]
    with trace(os.path.join(tmp, "profiled")) as prof:
        for step in (20, 21):
            pretrain.train_step(first["model"], first["optimizer"], 0, images, labels,
                                first["config"], step)
        torch.cuda.synchronize()
    files = os.listdir(os.path.join(tmp, "profiled", "profile"))
    kernels = sum(1 for e in prof.events() if str(getattr(e, "device_type", "")).endswith("CUDA"))
    size = sum(os.path.getsize(os.path.join(tmp, "profiled", "profile", f)) for f in files)
    log(f"  profiler.trace of 2 pretraining steps: {files} ({size} bytes), {kernels} device events")
    if len(files) != 1 or not size:
        raise AssertionError(f"profiler.trace wrote {files}")
    for name in list(steps):
        steps[name] = {k: v for k, v in steps[name].items() if k in ("images_per_s", "busy_ms")}
    torch.cuda.empty_cache()

    log("  (c) train.main --pretrain_core (a)'s run, the core frozen")
    launches.update(frozen_core(card_text, loop, tmp, os.path.join(tmp,
                                                                    "pretrain_classification")))
    launches.update(tools_on_the_run(card_text, loop, tmp))
    seconds = time.perf_counter() - start
    log(f"  phase 5k: {seconds:.1f} s; pretraining "
        + ", ".join(f"{k} {v['images_per_s']:.1f} train images/s, {v['busy_ms']} ms device time "
                    "a step" for k, v in steps.items()) + f" ({card_text})")
    return dict(launches=launches, steps=steps, seconds=seconds)


def core_map(model, batch) -> torch.Tensor:
    """The core's (B, C, h, w) output for one host batch: what the readout
    samples, compared before any channel sum."""
    x, behaviors, pupils = (torch.from_numpy(batch[k]).to(DEVICE)
                            for k in ("image", "behavior", "pupil_center"))
    with torch.inference_mode():
        images, _ = model.image_cropper(x, "A", behaviors, pupils)
        return model.core(images, "A", behaviors, pupils)


def where_the_time_goes(label: str, fn, phase: str = "6"):
    """Device time by kernel over one call of ``fn`` (torch.profiler), and
    the device's busy share of the call's wall time; returns the busy ms and
    the kernels' names (None where the profiler saw no device time)."""
    from torch.profiler import ProfilerActivity, profile

    log(f"phase {phase}: where the time goes, {label} under torch.profiler")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - start) * 1e3

    def device_us(event) -> float:
        for name in ("self_device_time_total", "self_cuda_time_total"):
            if hasattr(event, name):
                return float(getattr(event, name))
        return 0.0

    # kernels only: an operator's entry repeats the time of its kernels, and
    # so does the optimizer's annotation on the device's timeline
    # ("Optimizer.step#AdamW.step"), which spans the update's kernels
    events = [e for e in prof.key_averages()
              if str(getattr(e, "device_type", "")).endswith("CUDA") and device_us(e) > 0
              and not e.key.startswith("Optimizer.")]
    if not events:
        log("  the profiler saw no device time: not measured")
        return None
    busy_ms = sum(device_us(e) for e in events) / 1e3
    log(f"  device busy {busy_ms:.3f} ms of {wall_ms:.3f} ms wall (profiled call)")
    for e in sorted(events, key=device_us, reverse=True)[:16]:
        log(f"  {device_us(e) / 1e3:9.3f} ms  x{e.count:<4d} {e.key[:90]}")
    return busy_ms, [e.key for e in events], {e.key: e.count for e in events}


def check_launch_plans(lib) -> None:
    """The host's mirrors of the plans compiled into the kernels
    (``fwd_plan``, ``bwd_plan``, ``dx_plan``, ``linear_plan``, ``wgrad_plan``)
    against the library's, the bf16 flash kernels' wide tiles, and the plan
    of each flagship use: rows a block, tiles, ring depth, whether dY' stays
    in shared memory, how often each dY' element is read, the weight
    gradient's slices and clusters, shared memory a block."""
    from v1t_tpu_torch.ops.flash_attention import bwd_plan, fwd_plan
    from v1t_tpu_torch.ops.fused_mha import attention_plan
    from v1t_tpu_torch.ops.interp_matmul import sample_bwd_plan, sample_fwd_plan
    from v1t_tpu_torch.ops.ln_linear import COPIES, dx_plan, linear_plan, wgrad_plan

    for dp in range(32, 257, 32):
        for dtype, f32 in ((torch.bfloat16, 0), (torch.float32, 1)):
            if lib.v1t_flash_attention_smem(dp, f32) != fwd_plan(dtype, dp).smem:
                raise AssertionError(f"fwd_plan({dtype}, {dp}) disagrees with the library")
            if lib.v1t_flash_attention_bwd_smem(dp, f32) != bwd_plan(dtype, 1, 1, dp).smem:
                raise AssertionError(f"bwd_plan({dtype}, {dp}) disagrees with the library")
    for dp in (192, 224, 256):
        f, b = fwd_plan(torch.bfloat16, dp), bwd_plan(torch.bfloat16, B * H, N, dp)
        log(f"  bf16 flash at DP {dp} (the wide tiles): forward {f.queries} query rows a block, "
            f"{f.q_panels} q panel(s), key tiles of {f.keys} in K and V rings {f.stages} deep, "
            f"{f.smem} bytes a block; backward {' -> '.join(b.kernels)}, {b.keys} keys a block, "
            f"a float32 dq accumulator {b.dq_acc}, {b.smem} bytes a block")
    for dp in WIDE_DPS:  # the column groups, bf16 and float32
        plans = [(fwd_plan(dt, dp), bwd_plan(dt, B * H, N, dp))
                 for dt in (torch.bfloat16, torch.float32)]
        got = [lib.v1t_flash_attention_smem(dp, 0), lib.v1t_flash_attention_bwd_smem(dp, 0),
               lib.v1t_flash_attention_smem(dp, 1), lib.v1t_flash_attention_bwd_smem(dp, 1)]
        if got != [p.smem for pair in plans for p in pair]:
            raise AssertionError(f"the column groups' plans at DP {dp} disagree: {got}")
        for (f, b), kind in zip(plans, ("bf16", "float32")):
            how = (f"one cluster of {f.cluster} blocks summing the partial scores, q "
                   f"resident, key tiles of {f.keys} {f.stages} deep" if f.cluster > 1 else
                   f"q and K chunks of 64 columns in a ring {f.stages} deep")
            log(f"  {kind} flash at DP {dp} (column groups): forward {f.groups} groups of "
                f"{f.group_cols} columns, {f.queries} query rows a block, {how}, {f.smem} bytes "
                f"a block; backward "
                f"{' -> '.join(b.kernels)}, {b.groups} groups of {b.group_cols}, {b.keys} keys "
                f"a block, {b.smem} bytes a block, {b.order} fixed-order counters at B*H "
                f"{B * H}")
    wide_fwd = {"qkv": (3 * H * WIDE_EMB, WIDE_EMB, H, True, True, False),
                "out_proj": (WIDE_EMB, H * WIDE_EMB, 0, False, True, True),
                "fc1": (WIDE_MLP, WIDE_EMB, 0, True, True, False),
                "fc2": (WIDE_EMB, WIDE_MLP, 0, False, True, True)}
    for use, (n_, k, h, ln, al, res) in wide_fwd.items():
        plan = linear_plan(B * N, n_, k, (h, WIDE_EMB) if h else None, ln, al, res)
        got = [lib.v1t_ln_linear_plan(B * N, n_, k, -(-k // 32) * 32, h, WIDE_EMB if h else 0,
                                      WIDE_EMB if h else 0, int(ln), int(al), int(res), f)
               for f in range(7)]
        if plan is None or not plan.wgmma or got != [
                int(plan.stream), plan.rows, plan.tile, plan.tiles, plan.stages, plan.smem,
                int(plan.wgmma)]:
            raise AssertionError(f"linear_plan of {use} at emb {WIDE_EMB} disagrees: {got}")
        log(f"  ln_linear[{use}, emb {WIDE_EMB}] (K {k}, N {n_}): the persistent wgmma "
            + ("kernel, the LayerNorm's rows first (ln_rows_kernel), then streamed, " if ln
               else "kernel, x streamed, ")
            + f"{plan.rows} rows a tile, {plan.tiles} output tiles of {plan.tile} a row tile, "
            f"{plan.stages} stages, {plan.smem} bytes")
    wide_dx = {"qkv": (WIDE_EMB, 3 * H * WIDE_EMB, True, True),
               "out_proj": (H * WIDE_EMB, WIDE_EMB, True, False),
               "fc1": (WIDE_EMB, WIDE_MLP, True, True),
               "fc2": (WIDE_MLP, WIDE_EMB, True, False)}
    for use, (k, ns, aligned, ln) in wide_dx.items():
        plan = dx_plan(k, ns, aligned, ln)
        got = [lib.v1t_ln_linear_dx_plan(k, ns, int(aligned), int(ln), f) for f in range(8)]
        if plan is None or not plan.wgmma or got != [
                plan.rows, plan.stages, int(plan.resident), plan.k_tiles, int(plan.dln_global),
                int(plan.wgmma), plan.cluster, plan.smem]:
            raise AssertionError(f"dx_plan of {use} at emb {WIDE_EMB} disagrees with the "
                                 f"library: {got}")
        log(f"  ln_linear_dx[{use}, emb {WIDE_EMB}] (K {k}, {ns} stored reduction columns): "
            f"the wgmma kernel, {plan.k_tiles} tiles of {plan.rows} rows x 256 columns a row, "
            f"{plan.stages} stages, a cluster of {plan.cluster} block(s), dY' copied by "
            f"{plan.dy_reads} blocks (its L2 hits not measured), {plan.smem} bytes of shared "
            "memory a block")
    dp = -(-E // 32) * 32
    plan = attention_plan(B, H, N, dp)
    log(f"  attention (row 1's core, the bf16 flash forward in log2 units): {plan.items} items "
        f"of {plan.tiles.queries} query rows over {plan.blocks} persistent blocks (at "
        f"{torch.cuda.get_device_properties(0).multi_processor_count} SMs), key tiles of "
        f"{plan.tiles.keys} in a ring of {plan.stages}, {lib.v1t_flash_attention_smem(dp, 0)} "
        f"bytes of shared memory a block (the library's; the mirror's {plan.tiles.smem}); o "
        f"rows of {OW} columns")
    for label, (c, hh, ww) in {"flagship / fp32 29x57": (E, MAP_H, MAP_W),
                               "full-res 137x249": (E, FR_MAP_H, FR_MAP_W),
                               "300x300, 3 channels": (3, 300, 300)}.items():
        plan = sample_bwd_plan(c, hh, ww)
        got = [lib.v1t_bilinear_sample_cm_bwd_plan(c, hh, ww, f) for f in range(6)]
        if got != list(plan):
            raise AssertionError(f"sample_bwd_plan of {label} disagrees with the library: {got}")
        log(f"  bilinear_sample_cm_bwd[{label}]: {plan.channels} channels a block x "
            f"{plan.chunks} chunks, {plan.bands} band(s) of {plan.band_rows} rows, the table "
            f"{'staged beside it' if plan.staged else 'in global memory'}, {plan.smem} bytes of "
            f"shared memory a block")
    for label, (c, hh, ww, dtype) in {
            "flagship 29x57": (E, MAP_H, MAP_W, torch.bfloat16),
            "sweep-widest C 256": (SWEEP_EMB, MAP_H, MAP_W, torch.bfloat16),
            "fp32 29x57": (E, MAP_H, MAP_W, torch.float32),
            "full-res 137x249": (E, FR_MAP_H, FR_MAP_W, torch.bfloat16),
            "full-res 137x249 fp32": (E, FR_MAP_H, FR_MAP_W, torch.float32),
            "400x300, 3 channels": (3, 400, 300, torch.bfloat16)}.items():
        plan = sample_fwd_plan(c, hh, ww, dtype)
        f32 = int(dtype == torch.float32)
        got = [lib.v1t_bilinear_sample_cm_plan(c, hh, ww, f32, f) for f in range(4)]
        if got != list(plan):
            raise AssertionError(f"sample_fwd_plan of {label} disagrees with the library: {got}")
        log(f"  bilinear_sample_cm[{label}]: " + (
            f"{plan.group} channels a block (a shared-memory word a cell), {plan.chunks} "
            f"blocks an image, {plan.smem} bytes of shared memory a block"
            if plan.staged else f"unstaged: a block a channel, {plan.chunks} an image"))
    uses = {  # (K, stored reduction columns, rows 16-byte aligned, LayerNorm)
        "out_proj": (H * E, dp, E % 8 == 0, False),
        "qkv": (E, 3 * H * dp, True, True),
        "fc2": (F_HID, dp, E % 8 == 0, False),
        "fc1": (E, -(-F_HID // 32) * 32, F_HID % 8 == 0, True),
    }
    for use, (k, ns, aligned, ln) in uses.items():
        plan = dx_plan(k, ns, aligned, ln)
        if plan is None or lib.v1t_ln_linear_dx_plan(k, ns, int(aligned), int(ln), 7) != plan.smem:
            raise AssertionError(f"dx_plan of {use} disagrees with the library")
        log(f"  ln_linear_dx[{use}] (K {k}, {ns} stored reduction columns): {plan.rows} rows "
            f"a block, {plan.stages} stages, {'resident' if plan.resident else 'streamed'}, "
            f"dY' read {plan.dy_reads}x, {plan.smem} bytes of shared memory a block")
    # the forward and the weight gradient at the flagship's and the
    # full-resolution path's rows: (N, K, heads, LayerNorm, x aligned,
    # residual) and (N, K, heads, dY aligned, A aligned)
    m, fr_m = B * N, FR_B * FR_N
    fwd = {"qkv": (3 * H * E, E, H, True, False, False),
           "out_proj": (E, OW, 0, False, True, True),  # o's aligned rows, wp padded
           "fc1": (F_HID, E, 0, True, False, False),
           "fc2": (E, F_HID, 0, False, F_HID % 8 == 0, True)}
    for use, (n_, k, h, ln, al, res) in fwd.items():
        plan = linear_plan(m, n_, k, (h, E) if h else None, ln, al, res)
        got = [lib.v1t_ln_linear_plan(m, n_, k, -(-k // 32) * 32, h, E if h else 0,
                                      dp if h else 0, int(ln), int(al), int(res), f)
               for f in range(6)]
        if plan is None or got != [int(plan.stream), plan.rows, plan.tile, plan.tiles,
                                   plan.stages, plan.smem]:
            raise AssertionError(f"linear_plan of {use} disagrees with the library: {got}")
        log(f"  ln_linear[{use}] (K {k}, N {n_}): {'x streamed' if plan.stream else 'panel'}, "
            f"{plan.rows} rows a block, {plan.tiles} tiles of {plan.tile}, {plan.stages} stages, "
            f"{plan.smem} bytes of shared memory a block")
    wg = {"out_proj": (E, OW, 0, E % 8 == 0, True),
          "qkv": (3 * H * E, E, H, True, E % 8 == 0),
          "fc2": (E, F_HID, 0, E % 8 == 0, F_HID % 8 == 0),
          "fc1": (F_HID, E, 0, F_HID % 8 == 0, E % 8 == 0)}
    for rows, path in ((m, "flagship"), (fr_m, "full-res")):
        for use, (n_, k, h, dy_al, a_al) in wg.items():
            if path == "full-res" and use not in ("fc1", "fc2"):
                continue
            per_batch = N if path == "flagship" else FR_N
            plan = wgrad_plan(rows, n_, k, per_batch, (h, E) if h else None, dy_al, a_al)
            got = [lib.v1t_ln_linear_wgrad_plan(rows, n_, k, per_batch, h, E if h else 0,
                                                dp if h else 0, int(dy_al), int(a_al), f)
                   for f in range(11)]
            want = [plan.tile, plan.n_tiles, plan.k_tiles, plan.slices, plan.cluster,
                    plan.stages, plan.smem, plan.chunks, COPIES.index(plan.a_copy),
                    COPIES.index(plan.dy_copy), plan.copied_stages]
            if got != want:
                raise AssertionError(f"wgrad_plan of {use} ({path}) disagrees: {got} != {want}")
            log(f"  ln_linear_wgrad[{use}, {path}] (N {n_}, K {k}, {rows} rows): "
                f"{plan.n_tiles} x {plan.k_tiles} tiles, {plan.slices} slices, clusters of "
                f"{plan.cluster}, {plan.blocks} blocks, dY copied {plan.dy_reads}x, A by "
                f"{plan.a_copy}, dY by {plan.dy_copy}, partials "
                f"{plan.slices * n_ * k * 4 / (rows * n_ * 2):.3f} of dY's bytes, "
                f"{plan.smem} bytes of shared memory a block")


def main() -> int:
    # deterministic cuBLAS (phase 5i's --deterministic runs) needs this set
    # before the first cuBLAS call; it is the workspace PyTorch gives an H100
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; this script runs only on a GPU",
              file=sys.stderr, flush=True)
        return 1
    text = card_line()
    log("phase 1: card")
    log(text)
    from v1t_tpu_torch import _build

    log("phase 2: build")
    start = time.perf_counter()
    so_path = _build.build()
    _build.library()
    log(f"  kernels ready in {time.perf_counter() - start:.1f} s ({so_path})")
    wide = {}  # the bf16 flash kernels' wide instantiations: (registers, spill stores)
    # the kernels past the panels' widths (the flash column groups, the
    # LayerNorm's rows, the dX with its d(ln) rows in device memory, the
    # wgmma dX): (registers, spill stores)
    past = {}
    try:  # each kernel's registers and spills (ptxas -v), one line each
        with open(so_path + ".log") as f:
            entry, spills = "", ""
            for line in f:
                if "Compiling entry function" in line:
                    mangled = line.split("'")[1] if "'" in line else line.strip()
                    # _ZN..._cu_<8 hex>[<length><namespace>...]<length><name>I<template args>
                    m = re.search(r"_cu_[0-9a-f]{8}", mangled)
                    entry = mangled[:60]
                    at = m.end() if m else len(mangled)
                    while m and (d := re.match(r"\d+", mangled[at:])):
                        start = at + len(d.group(0))
                        at = start + int(d.group(0))
                        if not mangled[at:at + 1].isdigit():  # not a namespace: the name
                            entry = mangled[start:at + 16]
                            break
                elif "spill" in line:
                    spills = line.split(":", 1)[-1].strip()
                elif "registers" in line:
                    log(f"  {entry}: {line.split(':', 1)[-1].strip()}; {spills}")
                    m = re.match(r"(flash_fwd_wgmma_kernel|flash_bwd_one_pass_kernel)"
                                 r"ILi(192|224|256)E(?:Lb([01])E)?", entry)
                    regs = re.search(r"Used (\d+) registers", line)
                    stores = re.search(r"(\d+) bytes spill stores", spills)
                    reading = (int(regs.group(1)) if regs else None,
                               int(stores.group(1)) if stores else 0)
                    if m:
                        name = ("forward " + ("training" if m.group(3) == "1" else "serving")
                                if m.group(1).startswith("flash_fwd") else "backward one pass")
                        wide[(int(m.group(2)), name)] = reading
                    m = re.match(r"flash_fwd_wide_kernelILb([01])E|flash_bwd_wide_kernel|"
                                 r"flash_fwd_f32_wide_kernelILb([01])E|flash_bwd_f32_wide_kernel|"
                                 r"flash_fwd_f32_cluster_kernelILb([01])E|"
                                 r"flash_bwd_f32_cluster_kernel|flash_fwd_cluster_kernelILb([01])E|"
                                 r"ln_rows_kernel|linear_wgmma_kernel|"
                                 r"ln_linear_dx_kernelILi([24])ELb1ELb1E|"
                                 r"dx_wgmma_kernelILb([01])E", entry)
                    if m:
                        past[m.group(0)] = reading
    except FileNotFoundError:
        pass
    lib = _build.library()
    log("  the bf16 flash kernels' wide tiles (padded head widths 192-256), ptxas's registers "
        "a thread (the forward's: its launch allotment; setmaxnreg gives its consumers 240) / "
        "spill stores / shared memory a block: " + "; ".join(
            f"DP {dp} {name} {r} / {sp} B / "
            f"{(lib.v1t_flash_attention_smem if 'forward' in name else lib.v1t_flash_attention_bwd_smem)(dp, 0)} B"
            for (dp, name), (r, sp) in sorted(wide.items())))
    if len(wide) != 9 or any(sp for _, sp in wide.values()):
        raise AssertionError(f"the wide instantiations' ptxas report: {wide} (9 expected, "
                             "no spill)")
    log("  the kernels past the panels' widths (flash column groups above DP 256: bf16 in "
        "wgmma clusters to 8 groups and recomputing S past them, float32 in 3xTF32 clusters "
        "to 8 groups and on FFMA past them; the projection past K 640 on wgmma after its "
        "LayerNorm's pass; the wgmma dX; the wgmma kernels' registers the launch's "
        "allotment with setmaxnreg giving their consumers 232), ptxas's registers a thread / "
        "spill stores: "
        + "; ".join(f"{name} {r} / {sp} B" for name, (r, sp) in sorted(past.items())))
    if len(past) != 17 or any(sp for _, sp in past.values()):
        raise AssertionError(f"the instances past the panels' widths: {past} (17 expected, "
                             "no spill)")
    widths = range(32, 257, 32)
    log("  dynamic shared memory a block (bytes), by padded head width: the bf16 flash "
        "forward " + ", ".join(f"{dp}: {lib.v1t_flash_attention_smem(dp, 0)}" for dp in widths)
        + "; the float32 forward "
        + ", ".join(f"{dp}: {lib.v1t_flash_attention_smem(dp, 1)}" for dp in widths)
        + "; the bf16 backward's one pass (of flash_bwd, and of attention_bwd to 160) "
        + ", ".join(f"{dp}: {lib.v1t_flash_attention_bwd_smem(dp, 0)}" for dp in widths)
        + "; the float32 backward's one pass "
        + ", ".join(f"{dp}: {lib.v1t_flash_attention_bwd_smem(dp, 1)}" for dp in widths))
    check_launch_plans(lib)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        rows, tensors = check_kernels(gen)
        rows += check_backward_kernels(gen, tensors)
        del tensors
        torch.cuda.empty_cache()
        check_sublayer_form(gen)
        check_sublayer_form(gen, fold_residual=True)
        torch.cuda.empty_cache()
        next(row for row in rows if row["name"] == "attention_bwd")[
            "one_pass_at_flagship_ms"] = one_pass_at_flagship(gen)
        rows += check_flash_kernels(gen)
        torch.cuda.empty_cache()
        rows += check_wide_projections(gen)
        torch.cuda.empty_cache()
        check_path_shapes(gen)
    torch.cuda.empty_cache()
    sublayer_yardsticks(gen)
    torch.cuda.empty_cache()
    serving_launches, serve_one = serving_path(text)
    torch.cuda.empty_cache()
    train_launches, train_one, runs = training_path(text)
    torch.cuda.empty_cache()
    log("phase 5b: the full-resolution flagship (34,114 tokens) on the composed path, "
        "the main path of this slice")
    full = composed_path("full-res", flagship_config(batch_size=FR_B), FR_IMAGE, 2, 1,
                         FULLRES_LAUNCHES_PER_STEP, FULLRES_TOL, text)
    torch.cuda.empty_cache()
    log("phase 5c: the flagship at precision fp32 on the composed path")
    fp32 = composed_path("fp32", flagship_config(precision="fp32"), (1, 36, 64), 1, 1,
                         F32_LAUNCHES_PER_STEP, F32_TOL, text)
    torch.cuda.empty_cache()
    log(f"phase 5d: the sweep's widest core (emb {SWEEP_EMB}, {H} heads of {SWEEP_EMB}) on the "
        "bf16 flash kernels' wide tiles")
    sweep = composed_path("sweep-widest", flagship_config(emb_dim=SWEEP_EMB), (1, 36, 64), 1, 1,
                          SWEEP_LAUNCHES_PER_STEP, dict(model=MODEL_TOL, core=CORE_TOL,
                                                        loss=LOSS_TOL, grad=GRAD_TOL), text)
    torch.cuda.empty_cache()
    log(f"phase 5l: the V1T core at ViT-Base's width (emb {WIDE_EMB}, MLP {WIDE_MLP}, {H} heads "
        f"of {WIDE_EMB}) on the bf16 flash column groups, the LayerNorm past K 640 and the "
        "wgmma dX")
    wide = composed_path(f"emb-{WIDE_EMB}", flagship_config(emb_dim=WIDE_EMB, mlp_dim=WIDE_MLP),
                         (1, 36, 64), 1, CYCLES, WIDE_LAUNCHES_PER_STEP, WIDE_TOL, text)
    # every dX on the wgmma kernel, half of them with the LayerNorm (qkv,
    # fc1), half without (out-projection, fc2); the flagship's on mma.sync
    # and every forward projection on the wgmma kernel past K 640 likewise
    dx_total, fwd_total = wide["launches"]["ln_linear_bwd"], wide["launches"]["ln_linear"]
    for label, forms, want in (
            (f"emb-{WIDE_EMB} training", wide["dx_forms"],
             dict(mma_sync=0, wgmma_layernorm=dx_total // 2, wgmma_plain=dx_total // 2,
                  fwd_panel_or_streamed=0, fwd_wgmma_layernorm=fwd_total // 2,
                  fwd_wgmma_plain=fwd_total // 2)),
            ("flagship training", runs["kernel"]["dx_forms"],
             dict(mma_sync=train_launches["ln_linear_bwd"], wgmma_layernorm=0, wgmma_plain=0,
                  fwd_panel_or_streamed=train_launches["ln_linear"], fwd_wgmma_layernorm=0,
                  fwd_wgmma_plain=0))):
        log(f"  {label}: ln_linear_bwd's and ln_linear's launches by kernel {forms}")
        if forms != want:
            raise AssertionError(f"{label}: the projections' launches by kernel {forms} != "
                                 f"{want}")
    torch.cuda.empty_cache()
    log(f"  emb-{WIDE_EMB} training from a second seed, held as the first")
    train(f"emb-{WIDE_EMB} training, seed 1", flagship_config(emb_dim=WIDE_EMB, mlp_dim=WIDE_MLP),
          (1, 36, 64), CYCLES, WIDE_LAUNCHES_PER_STEP, WIDE_TOL, text, warm=False,
          paths=("kernel", "plain", "f32"), seed=1)
    torch.cuda.empty_cache()
    log(f"phase 5m: the V1T at emb {WIDE_EMB} (MLP {WIDE_MLP}, {H} heads of {WIDE_EMB}) in "
        "float32 on the float32 flash column groups")
    f32_wide = composed_path(f"fp32 emb-{WIDE_EMB}",
                             flagship_config(precision="fp32", emb_dim=WIDE_EMB, mlp_dim=WIDE_MLP),
                             (1, 36, 64), 1, 1, F32_WIDE_LAUNCHES_PER_STEP, F32_TOL, text)
    torch.cuda.empty_cache()
    dropped = drop_path_and_checkpointing(text)
    torch.cuda.empty_cache()
    modes = patch_modes(text)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="v1t_loop_") as tmp:
        loop = training_loop(text, tmp)
        torch.cuda.empty_cache()
        entries = entry_points(text, loop, tmp)
        torch.cuda.empty_cache()
        parallel = parallel_paths(text, loop, tmp)
        torch.cuda.empty_cache()
        pretraining = pretraining_paths(text, loop, tmp)
    torch.cuda.empty_cache()
    others = other_cores(text)
    deterministic = deterministic_runs(text)
    where_the_time_goes("one serving batch of 64", serve_one)
    where_the_time_goes(f"one training step of {B} (forward, backward, AdamW update)", train_one)
    where_the_time_goes(f"one full-resolution training step of {FR_B}", full["train_one"])
    where_the_time_goes(f"one fp32 training step of {B}", fp32["train_one"])
    where_the_time_goes(f"one training step of {B} at drop_path {DROP_PATH} with gradient "
                        "checkpointing", dropped["train_one"])
    for label in ("cct + gaussian2d", "stacked2d + gaussian2d"):
        where_the_time_goes(f"one {label} training step of {B} (forward, backward, AdamW "
                            "update)", others[label]["train_one"], "6 (5i)")
    where_the_time_goes(f"one cct + gaussian2d serving batch of {B}",
                        others["cct + gaussian2d"]["serve_one"], "6 (5i)")
    sweep_device = {}
    for kind, fn in (("serving", sweep["serve_one"]), ("training", sweep["train_one"])):
        seen = where_the_time_goes(f"one sweep-widest {kind} {'batch' if kind == 'serving' else 'step'}"
                                   f" of {B} (emb {SWEEP_EMB})", fn)
        if seen is None:
            continue
        sweep_device[kind] = seen[0]
        # the flash kernels' wide instantiations ran, and no row-1 or row-2 core
        names = " ".join(seen[1])
        want = [f"flash_fwd_wgmma_kernel<{SWEEP_EMB}"] + (
            [f"flash_bwd_one_pass_kernel<{SWEEP_EMB}>", "flash_bwd_prep_kernel",
             "flash_bwd_dq_convert_kernel"] if kind == "training" else [])
        missing = [w for w in want if w not in names]
        if missing or "attention_bwd_" in names:
            raise AssertionError(f"sweep-widest {kind}: kernels {missing} missing from the "
                                 f"profile, or attention_bwd's ran")
    wide_device = {}
    for kind, fn in (("serving", wide["serve_one"]), ("training", wide["train_one"])):
        seen = where_the_time_goes(f"one emb-{WIDE_EMB} {kind} "
                                   f"{'batch' if kind == 'serving' else 'step'} of {B}", fn)
        if seen is None:
            continue
        wide_device[kind] = seen[0]
        # the column groups' cluster forward, the LayerNorm's rows and the
        # wgmma projections ran, and no row-1 or row-2 core; no
        # recomputing forward, no streamed projection
        names = " ".join(seen[1])
        want = ["flash_fwd_cluster_kernel", "ln_rows_kernel", "linear_wgmma_kernel"] + (
            ["flash_bwd_wide_kernel", "flash_bwd_prep_kernel", "flash_bwd_dq_convert_kernel"]
            if kind == "training" else [])
        missing = [w for w in want if w not in names]
        if kind == "training":
            # every dX of the step (4 blocks x qkv, fc1, out-projection, fc2)
            # on the wgmma kernel, and none on the mma.sync one
            dx = {key: c for key, c in seen[2].items() if "dx_wgmma_kernel" in key}
            forms = [(re.search(r"dx_wgmma_kernel<\w+>", key).group(0), c)
                     for key, c in sorted(dx.items())]
            log(f"  emb-{WIDE_EMB} step: the wgmma dX kernel launched "
                + ", ".join(f"{c}x as {form}" for form, c in forms))
            if sum(dx.values()) != WIDE_DX_PER_STEP or "ln_linear_dx_kernel" in names:
                missing.append(f"dx_wgmma_kernel x{WIDE_DX_PER_STEP} (seen {dx}), and no "
                               "ln_linear_dx_kernel")
        proj = sum(c for key, c in seen[2].items() if "linear_wgmma_kernel" in key)
        log(f"  emb-{WIDE_EMB} {kind}: the wgmma projection launched {proj}x")
        if proj != 16:
            missing.append(f"linear_wgmma_kernel x16 (seen {proj})")
        if missing or "attention_bwd_" in names or "flash_fwd_wgmma_kernel" in names or \
                "flash_fwd_wide_kernel" in names or "ln_linear_kernel" in names:
            raise AssertionError(f"emb-{WIDE_EMB} {kind}: kernels {missing} missing from the "
                                 "profile, or a narrower core's, the recomputing column "
                                 "groups' or the streamed projection's ran")
    f32_wide_device = {}
    for kind, fn in (("serving", f32_wide["serve_one"]), ("training", f32_wide["train_one"])):
        seen = where_the_time_goes(f"one fp32 emb-{WIDE_EMB} {kind} "
                                   f"{'batch' if kind == 'serving' else 'step'} of {B}", fn)
        if seen is None:
            continue
        f32_wide_device[kind] = seen[0]
        # the float32 column groups ran, and no float32 flash kernel of a
        # width within 256
        names = " ".join(seen[1])
        want = ["flash_fwd_f32_cluster_kernel"] + (
            ["flash_bwd_f32_cluster_kernel", "flash_bwd_prep_kernel"] if kind == "training"
            else [])
        missing = [w for w in want if w not in names]
        if missing or "flash_fwd_f32_kernel<" in names or "flash_bwd_f32_kernel<" in names \
                or "f32_wide_kernel" in names:
            raise AssertionError(f"fp32 emb-{WIDE_EMB} {kind}: kernels {missing} missing from "
                                 "the profile, or a float32 flash kernel within 256 or an "
                                 "FFMA column-group kernel ran")
    paths = {"training": train_launches, "full_res_training": full["launches"],
             "wide_training": wide["launches"], "wide_serving": wide["serving_launches"],
             "fp32_wide_training": f32_wide["launches"],
             "fp32_wide_serving": f32_wide["serving_launches"],
             "fp32_training": fp32["launches"], "sweep_widest_training": sweep["launches"],
             "serving": serving_launches, "full_res_serving": full["serving_launches"],
             "fp32_serving": fp32["serving_launches"],
             "sweep_widest_serving": sweep["serving_launches"],
             "loop_epoch_1": loop["launches"]["epoch 1"],
             "drop_path_training": dropped["launches"],
             "drop_path_checkpointing_training": dropped["ckpt_launches"],
             **{f"patch_mode_{m}_training": r["launches"] for m, r in modes.items()},
             **{f"patch_mode_{m}_serving": r["serving"] for m, r in modes.items()},
             **entries, **parallel["launches"], **pretraining["launches"],
             **{f"{label.replace(' + ', '_')}_training": r["launches"]
                for label, r in others.items()},
             **{f"{label.replace(' + ', '_')}_serving": r["serving"]
                for label, r in others.items()}}
    # ln_linear_bwd's launches by kernel, on the training paths that
    # record them
    dx_forms = {"training": runs["kernel"]["dx_forms"], "full_res_training": full["dx_forms"],
                "fp32_training": fp32["dx_forms"], "sweep_widest_training": sweep["dx_forms"],
                "wide_training": wide["dx_forms"], "fp32_wide_training": f32_wide["dx_forms"]}
    for row in rows:
        # launches: the path each kernel serves first (the flash kernels: the
        # full-resolution training run; the forms past the panels' widths:
        # the emb-768 training run, bf16 or float32); every path's count
        # beside it ("ln_linear_bwd:<form>": that kernel's own count)
        counter = row.pop("counter", row["name"])
        main_path = row.pop("main_path", "full_res_training" if counter.startswith("flash")
                            else "training")
        by_path = paths
        if ":" in counter:
            counter, by_path = counter.split(":")[1], dx_forms
        row["launches"] = by_path[main_path][counter]
        row["launches_by_path"] = {p: c[counter] for p, c in by_path.items()}
    log(f"training throughput: kernel path {runs['kernel']['images_per_s']:.1f}, plain path "
        f"{runs['plain']['images_per_s']:.1f} train images/s; launches are those of the "
        f"training phase ({CYCLES * len(MICE)} steps)")
    log(f"full resolution: {full['images_per_s']:.2f} images/s serving, "
        f"{full['train_images_per_s']:.3f} train images/s (plain "
        f"{full['plain_train_images_per_s']:.3f}); fp32: {fp32['images_per_s']:.1f} images/s "
        f"serving, {fp32['train_images_per_s']:.2f} train images/s (plain "
        f"{fp32['plain_train_images_per_s']:.2f}) ({text})")
    log(f"sweep-widest (emb {SWEEP_EMB}): {sweep['images_per_s']:.1f} images/s serving, "
        f"{sweep['train_images_per_s']:.1f} train images/s (plain "
        f"{sweep['plain_train_images_per_s']:.2f}); device ms "
        + ", ".join(f"{k} {v:.3f}" for k, v in sweep_device.items()) + f" ({text})")
    log(f"emb {WIDE_EMB}: {wide['images_per_s']:.1f} images/s serving, "
        f"{wide['train_images_per_s']:.2f} train images/s (plain "
        f"{wide['plain_train_images_per_s']:.2f}); device ms "
        + ", ".join(f"{k} {v:.3f}" for k, v in wide_device.items()) + f" ({text})")
    log(f"fp32 emb {WIDE_EMB}: {f32_wide['images_per_s']:.2f} images/s serving, "
        f"{f32_wide['train_images_per_s']:.3f} train images/s (plain "
        f"{f32_wide['plain_train_images_per_s']:.3f}); device ms "
        + ", ".join(f"{k} {v:.3f}" for k, v in f32_wide_device.items()) + f" ({text})")
    log("phase 5i: " + "; ".join(
        f"{label} {r['images_per_s']:.1f} images/s serving, {r['train_images_per_s']:.1f} "
        "train images/s" for label, r in others.items())
        + "; --deterministic: two runs bit for bit on " + ", ".join(deterministic["paths"])
        + "; a flagship step's device time " + ", ".join(
            f"{k} " + ("not measured" if v is None else f"{v:.3f} ms")
            for k, v in deterministic["step_ms"].items()) + f" ({text})")
    log("phase 5k: " + "; ".join(
        f"{name} pretraining {r['images_per_s']:.1f} train images/s, device "
        + ("not measured" if r["busy_ms"] is None else f"{r['busy_ms']:.3f} ms") + " a step"
        for name, r in pretraining["steps"].items()) + f" ({text})")
    log("wall time by phase, s on the host's clock (from each phase's line to the next, "
        "summed by phase): " + wall_times())
    log(text)
    log(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--parallel-rank"]:  # one rank of phase 5j
        sys.exit(parallel_rank(sys.argv[2:]))
    sys.exit(main())
