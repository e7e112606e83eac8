#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``v1t_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each as they go:
1. the card's name and power limit;
2. the build of the CUDA kernels (one ``nvcc`` per source, in parallel,
   into ``v1t_tpu_torch/_build``), each kernel's registers and spills, the
   flash kernels' shared memory a block, and the launch plans of the flash
   forward, of ``ln_linear`` (``linear_plan``), ``ln_linear_dx``
   (``dx_plan``) and ``ln_linear_wgrad`` (``wgrad_plan``) held against the
   library's, with each flagship use's plan (rows a block, tiles, ring
   depths, how often dY' is read, slices and clusters of the weight
   gradient), the row-1 attention core's launch (``attention_plan``) and
   the sampling backward's (``sample_bwd_plan``: channels a block, bands)
   at the flagship, full-resolution, fp32 and a banded map;
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
   N 1);
   3b. the backward kernels (``attention_bwd`` with and without dropout;
   the sampling backward timed at the flagship's, the full-resolution and
   the float32 map),
   and the bf16 one-pass backward that ``attention_bwd`` and ``flash_bwd``
   share, timed through both at the flagship shape with its kernels
   profiled;
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
   key is masked (LSA at N 1) and key counts that fill no tile, and head
   widths 192 and 256 timed at a shape of the sweep (batch 16 x 4 heads,
   1654 tokens), forward and backward; and the fused MLP's and the readout's kernels at the shapes
   the composed paths give them (68,228 rows; a 137x249 and a float32 map);
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
6. where the time goes: one serving batch and one training step under
   ``torch.profiler``;
7. a ``kernels`` JSON line, then the result line
   ``{"ok": true, "device": {...}}``.

It exits non-zero, without the result line, if there is no CUDA device, if
the port is not beside it, or if any phase fails. It imports nothing of JAX.
"""

from __future__ import annotations

import functools
import json
import re
import shutil
import subprocess
import sys
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

B, N, E, H, F_HID, NEURONS = 64, 1654, 155, 4, 488, 7000
MAP_H, MAP_W = 29, 57
OW = -(-H * E // 8) * 8  # attention's output rows: H*E rounded up to 16 bytes (624)
# the parent tree's readings (PR 10's chip_smoke.py on an NVIDIA H100 80GB
# HBM3 at 700 W, PERF.md), printed beside this run's for orientation only
PARENT_MS = {"attention serving": 2.303, "attention training": 3.358,
             "bilinear_sample_cm_bwd": 2.946}
T_DROP = 0.2544  # the flagship's transformer dropout (configs.py t_dropout)
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


def log(*args) -> None:
    print(*args, flush=True)


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
    for fn in kernel_counters().values():
        fn.launches = 0


def read_counts() -> dict:
    return {name: fn.launches for name, fn in kernel_counters().items()}


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


def check_kernels(gen: torch.Generator) -> tuple:
    import torch.nn.functional as F

    from v1t_tpu_torch.ops.dropout import Dropout
    from v1t_tpu_torch.ops.fused_mha import attention, attention_plain
    from v1t_tpu_torch.ops.interp_matmul import bilinear_sample_cm, bilinear_sample_cm_plain
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
    # the kernel's other head widths (built for padded widths 32..160), small
    ones = torch.ones(48, device=dev)
    for d_head, lsa in ((32, False), (64, True), (100, False), (128, True)):
        qkv_s = ln_linear(randn(2, 300, 48), randn(3 * 2 * d_head, 48, scale=0.2),
                          gamma=ones, beta=ones * 0.0, heads=(2, d_head))
        scale_s = torch.full((2,), d_head ** -0.5, device=dev)
        compare(f"attention[head_dim {d_head}{', lsa' if lsa else ''}]",
                attention(qkv_s, scale_s, d_head, use_lsa=lsa),
                attention_plain(qkv_s, scale_s, d_head, use_lsa=lsa), KERNEL_TOL)

    # bilinear sampling of a core map at per-neuron grid points, some outside
    table = randn(B, E, MAP_H * MAP_W)
    grid = (torch.rand(B, NEURONS, 2, generator=gen) * 2.4 - 1.2).to(dev)
    got = bilinear_sample_cm(table, grid, MAP_H, MAP_W)
    ref = bilinear_sample_cm_plain(table, grid, MAP_H, MAP_W)
    err, rel = compare("bilinear_sample_cm", got, ref, KERNEL_TOL)
    table4 = table.reshape(B, E, MAP_H, MAP_W)
    grid4 = grid.reshape(B, 1, NEURONS, 2).to(bf)
    lib_ms = cuda_ms(lambda: F.grid_sample(table4, grid4, mode="bilinear", padding_mode="zeros",
                                           align_corners=True))
    ms = cuda_ms(lambda: bilinear_sample_cm(table, grid, MAP_H, MAP_W))
    plain_ms = cuda_ms(lambda: bilinear_sample_cm_plain(table, grid, MAP_H, MAP_W), iters=3)
    b_ms, b_by = bound(nbytes(table, grid, got), 8.0 * B * NEURONS * E, "fp32")
    log(f"  bilinear_sample_cm (B {B}, C {E}, {MAP_H}x{MAP_W}, P {NEURONS}): kernel_ms {ms:.4f} "
        f"plain_ms {plain_ms:.4f} grid_sample_ms {lib_ms:.4f} bound_ms {b_ms:.4f} ({b_by})")
    rows.append(dict(
        name="bilinear_sample_cm", route="cuda", source="v1t_tpu_torch/csrc/bilinear_sample.cu",
        replaces="v1t_tpu/ops/interp_matmul.py:99 (_fwd_kernel)",
        max_abs_err=err, rel_err=rel, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
        library_ms=lib_ms, library="F.grid_sample",
    ))
    tensors = dict(x=x, row=row, gamma=gamma, beta=beta, wqkv=wqkv, wp=wp, wp_o=wp_o, bp=bp,
                   w1=w1, b1=b1,
                   w2=w2, b2=b2, scale=scale, qkv=qkv, table=table, grid=grid,
                   drops=(drop_p, drop_o, drop1, drop2))
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
        del dqkv_ref
    ms0 = cuda_ms(lambda: attention_bwd(qkv, o0, do, lse0, scale, E))
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
        f"{b_ms / ms0:.3f}")
    rows.append(dict(
        name="attention_bwd", route="cuda",
        source="v1t_tpu_torch/csrc/attention_bwd.cu (+ the one pass of "
               "v1t_tpu_torch/csrc/flash_attention_bwd.cu)",
        replaces="v1t_tpu/ops/fused_mha.py:676 (_mha_bwd_kernel_dt2, attention core)",
        max_abs_err=worst[0], rel_err=worst[1], ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=lib_ms,
        library="autograd backward of F.scaled_dot_product_attention (no dropout)",
        ms_like_for_like=ms0, like_for_like="no dropout",
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

    maps = {"flagship 29x57": (B, MAP_H, MAP_W, bf), "full-res 137x249": (FR_B, FR_MAP_H, FR_MAP_W, bf),
            "fp32 29x57": (B, MAP_H, MAP_W, f32)}
    cases = {}
    for label, (b, hh, ww, dtype) in maps.items():
        if label.startswith("flagship"):
            table, grid = t["table"], t["grid"]
        else:
            table = torch.randn(b, E, hh * ww, generator=gen).to(dev, dtype)
            grid = (torch.rand(b, NEURONS, 2, generator=gen) * 2.4 - 1.2).to(dev)
        ds = torch.randn(b, E, NEURONS, generator=gen).to(dev, dtype)
        tol = KERNEL_TOL if dtype == bf else F32_KERNEL_TOL
        got, ref = (fn(table, grid, ds, hh, ww)
                    for fn in (bilinear_sample_cm_bwd, bilinear_sample_cm_bwd_plain))
        err = compare(f"bilinear_sample_cm_bwd[{label}] d(table)", got[0], ref[0], tol)
        compare(f"bilinear_sample_cm_bwd[{label}] d(grid)", got[1], ref[1], tol)
        del ref
        ms = cuda_ms(lambda: bilinear_sample_cm_bwd(table, grid, ds, hh, ww))
        plain_ms = cuda_ms(lambda: bilinear_sample_cm_bwd_plain(table, grid, ds, hh, ww),
                           iters=3)
        with torch.enable_grad():
            table4 = table.reshape(b, E, hh, ww).detach().clone().requires_grad_()
            grid4 = grid.reshape(b, 1, NEURONS, 2).to(dtype).requires_grad_()
            sampled = F.grid_sample(table4, grid4, mode="bilinear", padding_mode="zeros",
                                    align_corners=True)
            ds4 = ds.reshape(b, E, 1, NEURONS)
            lib_ms = cuda_ms(lambda: torch.autograd.grad(sampled, (table4, grid4), ds4,
                                                         retain_graph=True))
        del table4, grid4, sampled, ds4
        b_ms, b_by = bound(nbytes(table, grid, ds, *got), 16.0 * b * NEURONS * E, "fp32")
        plan = sample_bwd_plan(E, hh, ww)
        log(f"  bilinear_sample_cm_bwd[{label}] (B {b}, C {E}, {hh}x{ww}, P {NEURONS}, "
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
              dlse=False, timed=False):
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
            iters = 3 if nq > 10000 else 10
            ms = cuda_ms(lambda: flash_fwd(q, k, v, d, heads, with_lse=True, **kw), iters)
            serve_ms = cuda_ms(lambda: flash_fwd(q, k, v, d, heads), iters)
            bwd_ms = cuda_ms(lambda: flash_bwd(q, k, v, o, do, lse, d, heads, **kw), iters)
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
            del qs, ks, vs, y, gy
            case.update(ms=ms, serving_ms=serve_ms, plain_ms=plain_ms, bound_ms=b_ms,
                        bound_by=b_by, library_ms=lib_ms, bwd_ms=bwd_ms,
                        bwd_no_dropout_ms=bwd0_ms, bwd_plain_ms=plain_bwd_ms,
                        bwd_bound_ms=bb_ms, bwd_bound_by=bb_by, bwd_library_ms=lib_bwd_ms)
            log(f"  flash_attention[{label}] (BH {bh}, N {nq}, D {d}, {kind}): kernel_ms "
                f"{ms:.4f} (serving {serve_ms:.4f}) plain_ms {plain_ms:.4f} sdpa_ms "
                f"{lib_ms:.4f} bound_ms {b_ms:.4f} ({b_by}); serving / sdpa "
                f"{serve_ms / lib_ms:.3f}, bound share {b_ms / serve_ms:.3f}")
            log(f"  flash_attention_bwd[{label}]: kernel_ms {bwd_ms:.4f} (no dropout "
                f"{bwd0_ms:.4f}) plain_ms {plain_bwd_ms:.4f} sdpa_backward_ms {lib_bwd_ms:.4f} "
                f"bound_ms {bb_ms:.4f} ({bb_by}); no dropout / sdpa {bwd0_ms / lib_bwd_ms:.3f}, "
                f"bound share {bb_ms / bwd0_ms:.3f}")
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

    def masked_rows():
        """bf16 rows whose every key is masked (LSA at N 1: P spreads over the
        masked keys, keys past Nk weigh nothing) and key counts that fill no
        tile, forward and backward against the plain versions. At N 1 the
        row's P is 1 whatever its score, so dS = P (dP - delta) vanishes but
        for rounding: dq and dk are held to the tolerance of dv's scale."""
        for nq, lsa in ((1, True), (1, False), (70, True)):
            q, k, v = operands(8, nq, nq, E, bf)
            (o, lse), (o_ref, lse_ref) = (fn(q, k, v, E, 4, with_lse=True, use_lsa=lsa)
                                          for fn in (flash_fwd, flash_fwd_plain))
            label = f"N {nq}{', lsa' if lsa else ''}"
            compare(f"flash_attention[{label}] o", o, o_ref, KERNEL_TOL)
            compare(f"flash_attention[{label}] lse", lse, lse_ref, F32_KERNEL_TOL)
            do = torch.randn(o.shape, generator=gen).to(DEVICE, bf)
            got = flash_bwd(q, k, v, o_ref, do, lse_ref, E, 4, use_lsa=lsa)
            ref = flash_bwd_plain(q, k, v, o_ref, do, lse_ref, E, 4, use_lsa=lsa)
            compare(f"flash_attention_bwd[{label}] dv", got[2], ref[2], KERNEL_TOL)
            scale = ref[2].float().abs().max().item()
            for part, g_, r_ in zip(("dq", "dk"), got[:2], ref[:2]):
                err = (g_.float() - r_.float()).abs().max().item()
                ref_max = max(r_.float().abs().max().item(), scale if nq == 1 else 0.0)
                ok = torch.isfinite(g_.float()).all().item() and err <= KERNEL_TOL * ref_max
                log(f"  flash_attention_bwd[{label}] {part}: max|d| {err:.3e}, of the scale "
                    f"{ref_max:.3e}: {err / max(ref_max, 1e-30):.3e} (tol {KERNEL_TOL:g}) "
                    f"{'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(f"flash_attention_bwd[{label}] {part}")

    cases = {}
    cases["full_res"] = check("full-res, dropout", FR_B * H, H, FR_N, FR_N, E, bf, drp=drop,
                              timed=True)
    masks_bit_identical("full-res", FR_B * H, FR_N, E, bf)
    cases["fp32_flagship"] = check("fp32 flagship, dropout", B * H, H, N, N, E, f32, drp=drop,
                                   timed=True)
    masks_bit_identical("fp32 flagship", B * H, N, E, f32)
    cases["rectangular"] = check("rectangular, n_real_k 1300, dlse", 8, 4, 1000, 1500, 64, bf,
                                 n_real=1300, dlse=True)
    cases["lsa"] = check("lsa", 8, 4, N, N, E, bf, lsa=True, drp=drop)
    masked_rows()
    for d in (192, 256):  # the sweep's widest heads: emb 192 / 256, batch 16 x 4 heads
        cases[f"head_{d}"] = check(f"head width {d}, batch 16", 16 * 4, 4, N, N, d, bf,
                                   drp=drop, timed=True)
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
                + (("no_dropout_ms",) if pre else ("serving_ms",))},
            note="times at the full-resolution shape (BH 8, N 34114, D 155, bf16, dropout "
                 "on; ms_like_for_like without dropout, as the library call runs); per_case "
                 "holds the fp32 flagship's", per_case=cases))
    return rows


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


def flagship_model(config, card):
    """The flagship model on the card, weights from seed 0. Two draws from a
    second seed replace the reference's init where it would hide a fault of
    the kernel path: the readout features (a constant 1/C averages every
    response over the channels) and the behavior MLPs (trunc_normal(0.02)
    leaves a latent of ~1e-2, which the comparison could not tell from a
    dropped bias_row)."""
    from v1t_tpu_torch.models import build_model

    model = build_model(config, card, seed=0, device=DEVICE)
    gen = torch.Generator().manual_seed(1)
    redrawn = [(readout.features, E) for readout in model.readouts.values()]
    for block in model.core.transformer.blocks:
        for mlp in block.b_mlp.models.values():
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
    got_map, ref_map = core_map(model, batches[0]), core_map(plain_model, batches[0])
    compare(f"core map {tuple(ref_map.shape)} vs plain path", got_map, ref_map, tol["core"])
    return launches, lambda: trainer.predict("A", batches[0]), images / seconds


def train(label: str, config, image_shape, cycles: int, per_step: dict, tol: dict,
          card_text: str, warm: bool = True) -> tuple:
    """Trainer.train_step, dropout and readout noise on: ``cycles`` cycles
    over two mice (gradients accumulated across the cycle, one AdamW update
    at its end), through the kernels with the counters set to 0 just before
    and read just after, then the same weights, seeds and batches through the
    plain path: per-step losses and every parameter's first-step gradient."""
    from v1t_tpu_torch.data.cards import synthetic_data_card
    from v1t_tpu_torch.models import build_model
    from v1t_tpu_torch.training import Trainer

    b = config.batch_size
    card = synthetic_data_card(mouse_ids=MICE, num_neurons=NEURONS, input_shape=image_shape)
    state = flagship_model(config, card).state_dict()
    rng = np.random.default_rng(2)
    warm_batch = host_batch(rng, b, image_shape, NEURONS)
    batches = [[host_batch(rng, b, image_shape, NEURONS) for _ in MICE] for _ in range(cycles)]
    steps = cycles * len(MICE)
    runs = {}
    for path, cfg in (("kernel", config), ("plain", plain_config(config))):
        model = build_model(cfg, card, seed=None, device=DEVICE)
        model.load_state_dict(state)
        trainer = Trainer(cfg, model, card, device=DEVICE)
        if warm:
            # a warm-up step without an update (the run below starts from zero
            # gradients); both paths take it, so their seeds stay in step
            trainer.train_step(MICE[0], warm_batch, None, update=False)
        torch.cuda.synchronize()
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
        launches = read_counts()
        losses = [float(v) for v in losses]
        log(f"  {path} path: {steps} train steps of {b} images in {seconds:.4f} s = "
            f"{steps * b / seconds:.1f} train images/s ({card_text}); losses "
            + " ".join(f"{v:.4f}" for v in losses))
        log(f"  {path} path launches over {steps} steps: {launches}")
        if not all(np.isfinite(losses)):
            raise AssertionError(f"{label}, {path} path: non-finite loss")
        runs[path] = dict(losses=losses, grads=first_grads, launches=launches,
                          images_per_s=steps * b / seconds, trainer=trainer)
        del model
    expected = {name: n * steps for name, n in per_step.items()}
    if runs["kernel"]["launches"] != expected:
        raise AssertionError(f"{label}: launch counts {runs['kernel']['launches']} != {expected}")
    if any(runs["plain"]["launches"].values()):
        raise AssertionError(f"{label}: the plain path launched kernels: "
                             f"{runs['plain']['launches']}")
    for step, (got, ref) in enumerate(zip(runs["kernel"]["losses"], runs["plain"]["losses"])):
        rel = abs(got - ref) / abs(ref)
        log(f"  step {step} loss: kernel {got:.6f} plain {ref:.6f} |d|/|ref| {rel:.3e} "
            f"(tol {tol['loss']:g}) {'ok' if rel <= tol['loss'] else 'FAIL'}")
        if rel > tol["loss"]:
            raise AssertionError(f"{label}, step {step}: loss differs from the plain path "
                                 f"by {rel:.3e}")
    grads, refs = runs["kernel"]["grads"], runs["plain"]["grads"]
    if grads.keys() != refs.keys():
        raise AssertionError(f"{label}: the two paths gave gradients for different parameters")
    rels = {}
    for name, ref in refs.items():
        got = grads[name].float()
        if not torch.isfinite(got).all():
            raise AssertionError(f"{label}, {name}: non-finite gradient")
        rels[name] = (got - ref.float()).abs().max().item() / max(ref.abs().max().item(), 1e-30)
    worst = sorted(rels.items(), key=lambda kv: kv[1], reverse=True)
    log(f"  first step's gradients of {len(rels)} parameters, max|d|/max|ref|, largest: "
        + ", ".join(f"{n} {r:.3e}" for n, r in worst[:4]) + f" (tol {tol['grad']:g})")
    if worst[0][1] > tol["grad"]:
        raise AssertionError(f"{label}: gradient {worst[0][0]} differs from the plain path: "
                             f"{worst[0][1]:.3e}")
    trainer = runs["kernel"]["trainer"]
    one = batches[0][0]
    return runs["kernel"]["launches"], lambda: trainer.train_step(
        MICE[0], one, None, update=True), runs


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
    """A composed path's serving and training (phases 5b, 5c)."""
    per_batch = {name: 0 if "bwd" in name or "wgrad" in name else n
                 for name, n in per_step.items()}
    serving, _, images_per_s = serve(f"{label} serving", config, image_shape, serve_batches,
                                     {k: v * serve_batches for k, v in per_batch.items()},
                                     tol, card_text)
    torch.cuda.empty_cache()
    launches, train_one, runs = train(f"{label} training", config, image_shape, cycles,
                                      per_step, tol, card_text, warm=False)
    log(f"  {label}: serving {images_per_s:.1f} images/s, training "
        f"{runs['kernel']['images_per_s']:.3f} train images/s (plain "
        f"{runs['plain']['images_per_s']:.3f}) ({card_text})")
    return dict(serving_launches=serving, launches=launches, train_one=train_one,
                images_per_s=images_per_s, train_images_per_s=runs["kernel"]["images_per_s"],
                plain_train_images_per_s=runs["plain"]["images_per_s"])


def core_map(model, batch) -> torch.Tensor:
    """The core's (B, C, h, w) output for one host batch: what the readout
    samples, compared before any channel sum."""
    x, behaviors, pupils = (torch.from_numpy(batch[k]).to(DEVICE)
                            for k in ("image", "behavior", "pupil_center"))
    with torch.inference_mode():
        images, _ = model.image_cropper(x, "A", behaviors, pupils)
        return model.core(images, "A", behaviors, pupils)


def where_the_time_goes(label: str, fn, phase: str = "6") -> None:
    """Device time by kernel over one call of ``fn`` (torch.profiler), and
    the device's busy share of the call's wall time."""
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

    # kernels only: an operator's entry repeats the time of its kernels
    events = [e for e in prof.key_averages()
              if str(getattr(e, "device_type", "")).endswith("CUDA") and device_us(e) > 0]
    if not events:
        log("  the profiler saw no device time: not measured")
        return
    busy_ms = sum(device_us(e) for e in events) / 1e3
    log(f"  device busy {busy_ms:.3f} ms of {wall_ms:.3f} ms wall (profiled call)")
    for e in sorted(events, key=device_us, reverse=True)[:16]:
        log(f"  {device_us(e) / 1e3:9.3f} ms  x{e.count:<4d} {e.key[:90]}")


def check_launch_plans(lib) -> None:
    """The host's mirrors of the plans compiled into the kernels
    (``fwd_plan``, ``dx_plan``, ``linear_plan``, ``wgrad_plan``) against the
    library's, and the plan of each flagship use: rows a block, tiles, ring
    depth, whether dY' stays in shared memory, how often each dY' element is
    read, the weight gradient's slices and clusters, shared memory a block."""
    from v1t_tpu_torch.ops.flash_attention import fwd_plan
    from v1t_tpu_torch.ops.fused_mha import attention_plan
    from v1t_tpu_torch.ops.interp_matmul import sample_bwd_plan
    from v1t_tpu_torch.ops.ln_linear import COPIES, dx_plan, linear_plan, wgrad_plan

    for dp in range(32, 257, 32):
        for dtype, f32 in ((torch.bfloat16, 0), (torch.float32, 1)):
            if lib.v1t_flash_attention_smem(dp, f32) != fwd_plan(dtype, dp).smem:
                raise AssertionError(f"fwd_plan({dtype}, {dp}) disagrees with the library")
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
    uses = {  # (K, stored reduction columns, rows 16-byte aligned, LayerNorm)
        "out_proj": (H * E, dp, E % 8 == 0, False),
        "qkv": (E, 3 * H * dp, True, True),
        "fc2": (F_HID, dp, E % 8 == 0, False),
        "fc1": (E, -(-F_HID // 32) * 32, F_HID % 8 == 0, True),
    }
    for use, (k, ns, aligned, ln) in uses.items():
        plan = dx_plan(k, ns, aligned, ln)
        if plan is None or lib.v1t_ln_linear_dx_smem(k, ns, int(aligned), int(ln)) != plan.smem:
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
    try:  # each kernel's registers and spills (ptxas -v), one line each
        with open(so_path + ".log") as f:
            entry, spills = "", ""
            for line in f:
                if "Compiling entry function" in line:
                    mangled = line.split("'")[1] if "'" in line else line.strip()
                    # _ZN..._cu_<8 hex><length><name>I<template args>...
                    m = re.search(r"_cu_[0-9a-f]{8}(\d+)", mangled)
                    entry = (mangled[m.end():m.end() + int(m.group(1)) + 16] if m
                             else mangled[:60])
                elif "spill" in line:
                    spills = line.split(":", 1)[-1].strip()
                elif "registers" in line:
                    log(f"  {entry}: {line.split(':', 1)[-1].strip()}; {spills}")
    except FileNotFoundError:
        pass
    lib = _build.library()
    widths = range(32, 257, 32)
    log("  dynamic shared memory a block (bytes), by padded head width: the bf16 flash "
        "forward " + ", ".join(f"{dp}: {lib.v1t_flash_attention_smem(dp, 0)}" for dp in widths)
        + "; the float32 forward "
        + ", ".join(f"{dp}: {lib.v1t_flash_attention_smem(dp, 1)}" for dp in widths)
        + "; the bf16 backward (the one pass of flash_bwd and attention_bwd to 160, dq / dkdv "
        "above) " + ", ".join(f"{dp}: {lib.v1t_flash_attention_bwd_smem(dp, 0)}" for dp in widths)
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
        next(row for row in rows if row["name"] == "attention_bwd")[
            "one_pass_at_flagship_ms"] = one_pass_at_flagship(gen)
        rows += check_flash_kernels(gen)
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
    where_the_time_goes("one serving batch of 64", serve_one)
    where_the_time_goes(f"one training step of {B} (forward, backward, AdamW update)", train_one)
    where_the_time_goes(f"one full-resolution training step of {FR_B}", full["train_one"])
    where_the_time_goes(f"one fp32 training step of {B}", fp32["train_one"])
    paths = {"training": train_launches, "full_res_training": full["launches"],
             "fp32_training": fp32["launches"], "serving": serving_launches,
             "full_res_serving": full["serving_launches"],
             "fp32_serving": fp32["serving_launches"]}
    for row in rows:
        # launches: the path each kernel serves first (the flash kernels: the
        # full-resolution training run); every path's count beside it
        main_path = "full_res_training" if row["name"].startswith("flash") else "training"
        row["launches"] = paths[main_path][row["name"]]
        row["launches_by_path"] = {p: c[row["name"]] for p, c in paths.items()}
    log(f"training throughput: kernel path {runs['kernel']['images_per_s']:.1f}, plain path "
        f"{runs['plain']['images_per_s']:.1f} train images/s; launches are those of the "
        f"training phase ({CYCLES * len(MICE)} steps)")
    log(f"full resolution: {full['images_per_s']:.2f} images/s serving, "
        f"{full['train_images_per_s']:.3f} train images/s (plain "
        f"{full['plain_train_images_per_s']:.3f}); fp32: {fp32['images_per_s']:.1f} images/s "
        f"serving, {fp32['train_images_per_s']:.2f} train images/s (plain "
        f"{fp32['plain_train_images_per_s']:.2f}) ({text})")
    log(text)
    log(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
