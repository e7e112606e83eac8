#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``v1t_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each as they go:
1. the card's name and power limit;
2. the build of the CUDA kernels (one ``nvcc`` call, ``v1t_tpu_torch/_build``);
3. every kernel against its plain PyTorch version at the flagship serving
   shapes (batch 64, 1654 tokens, emb 155, 4 heads of 155, MLP 488, a 29x57
   core map, 7000 neurons), with its time, the plain version's time, one
   PyTorch library call's time where one computes the same function, and the
   least time the card could take (bytes at 3.35 TB/s or operations at the
   peak rate of their type, whichever is larger);
4. the main path: the flagship model (random weights from a seed) serving 3
   batches of 64 through ``training.inference`` / ``Trainer.predict`` with
   the kernel launch counters set to 0 just before and read just after; the
   outputs, and the core map of one batch, are held against the same
   model's plain path on the card;
5. a ``kernels`` JSON line, then the result line
   ``{"ok": true, "device": {...}}``.

It exits non-zero, without the result line, if there is no CUDA device, if
the port is not beside it, or if any phase fails. It imports nothing of JAX.
"""

from __future__ import annotations

import json
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
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet
PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12}  # dense tensor-core bf16; fp32 outside the tensor cores

B, N, E, H, F_HID, NEURONS = 64, 1654, 155, 4, 488, 7000
MAP_H, MAP_W = 29, 57
DEVICE = "cuda"


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


def check_kernels(gen: torch.Generator) -> list:
    import torch.nn.functional as F

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
    hid = ln_linear(x, w1, gamma=gamma, beta=beta, bias=b1, gelu=True)
    uses = {
        "qkv": dict(x=x, w=wqkv, gamma=gamma, beta=beta, pro_row=row, heads=(H, E)),
        "out_proj": dict(x=o, w=wp, bias=bp, residual=x, res_row=row),
        "fc1": dict(x=x, w=w1, gamma=gamma, beta=beta, bias=b1, gelu=True),
        "fc2": dict(x=hid, w=w2, bias=b2, residual=x),
    }

    def torch_ln_linear(kw):
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
        per_use[use] = dict(ms=ms, plain_ms=plain_ms, torch_bf16_ms=torch_ms, bound_ms=b_ms,
                            bound_by=b_by, max_abs_err=err)
        for key, val in (("ms", ms), ("plain_ms", plain_ms), ("bound_ms", b_ms), ("torch_ms", torch_ms)):
            tot[key] += val
        bound_kinds.add(b_by)
        log(f"  ln_linear[{use}] ({m}x{k} @ {k}x{n_out}): kernel_ms {ms:.4f} plain_ms {plain_ms:.4f} "
            f"torch_bf16_ms {torch_ms:.4f} bound_ms {b_ms:.4f} ({b_by})")
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
        f"sdpa_ms {lib_ms:.4f} bound_ms {b_ms:.4f} ({b_by})")
    rows.append(dict(
        name="attention", route="cuda", source="v1t_tpu_torch/csrc/attention.cu",
        replaces="v1t_tpu/ops/fused_mha.py:567 (_mha_fwd_kernel_dt2, attention core)",
        max_abs_err=err, rel_err=rel, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
        library_ms=lib_ms, library="F.scaled_dot_product_attention",
    ))
    del q, k, v
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
    return rows


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


def main_path(card_text: str) -> dict:
    from v1t_tpu_torch.configs import Config
    from v1t_tpu_torch.data.cards import synthetic_data_card
    from v1t_tpu_torch.models import build_model
    from v1t_tpu_torch.ops.fused_mha import attention
    from v1t_tpu_torch.ops.interp_matmul import bilinear_sample_cm
    from v1t_tpu_torch.ops.ln_linear import ln_linear
    from v1t_tpu_torch.training import Trainer, inference

    log("phase 4: main path, flagship V1T serving (Trainer.predict) on the card")
    config = Config(core="vit", readout="gaussian2d", behavior_mode=3, shift_mode=2,
                    precision="bf16", resize_image=0, batch_size=B)
    card = synthetic_data_card(mouse_ids=("A",), num_neurons=NEURONS, input_shape=(1, 36, 64))
    model = build_model(config, card, seed=0, device=DEVICE)
    # two draws from a second seed replace the reference's init where it
    # would hide a fault of the kernel path: the readout features (a
    # constant 1/C averages every response over the channels) and the
    # behavior MLPs (trunc_normal(0.02) leaves a latent of ~1e-2, which the
    # comparison could not tell from a dropped bias_row)
    gen = torch.Generator().manual_seed(1)
    redrawn = [(model.readouts["A"].features, E)]
    for block in model.core.transformer.blocks:
        for mlp in block.b_mlp.models.values():
            redrawn += [(mlp[0].weight, mlp[0].in_features), (mlp[3].weight, mlp[3].in_features)]
    with torch.no_grad():
        for param, fan_in in redrawn:
            param.copy_(torch.randn(param.shape, generator=gen) * fan_in ** -0.5)
    trainer = Trainer(config, model, card, device=DEVICE)
    rng = np.random.default_rng(0)
    batches = [
        {
            "image": rng.normal(size=(B, 1, 36, 64)).astype(np.float32),
            "behavior": rng.normal(size=(B, 3)).astype(np.float32),
            "pupil_center": rng.normal(size=(B, 2)).astype(np.float32),
            "response": rng.poisson(2.0, size=(B, NEURONS)).astype(np.float32),
            "image_id": np.arange(i * B, (i + 1) * B),
            "trial_id": np.arange(i * B, (i + 1) * B),
        }
        for i in range(3)
    ]
    trainer.predict("A", batches[0])  # warm-up, not counted
    torch.cuda.synchronize()

    counters = (ln_linear, attention, bilinear_sample_cm)
    for fn in counters:
        fn.launches = 0
    start = time.perf_counter()
    result = inference(trainer, batches, "A")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    launches = {fn.__name__: fn.launches for fn in counters}
    images = len(batches) * B
    log(f"  launches over {len(batches)} micro-batches: {launches}")
    blocks = config.num_blocks
    expected = {"ln_linear": 4 * blocks * 3, "attention": blocks * 3, "bilinear_sample_cm": 3}
    if launches != expected:
        raise AssertionError(f"launch counts {launches} != {expected}")
    preds = result["predictions"]
    if preds.shape != (images, NEURONS) or not np.isfinite(preds).all() or not (preds > 0).all():
        raise AssertionError(f"predictions: shape {preds.shape}, finite/positive check failed")
    log(f"  kernel path: {images} images in {seconds:.4f} s = {images / seconds:.1f} images/s "
        f"({card_text})")

    plain_cfg = config.replace(attention_impl="xla", readout_impl="xla")
    plain_model = build_model(plain_cfg, card, seed=None, device=DEVICE)
    plain_model.load_state_dict(model.state_dict())
    plain_trainer = Trainer(plain_cfg, plain_model, card, device=DEVICE)
    plain_trainer.predict("A", batches[0])
    torch.cuda.synchronize()
    start = time.perf_counter()
    ref = inference(plain_trainer, batches, "A")["predictions"]
    plain_seconds = time.perf_counter() - start
    log(f"  plain path: {images} images in {plain_seconds:.4f} s = "
        f"{images / plain_seconds:.1f} images/s")
    err = float(np.abs(preds - ref).max())
    rel = err / float(np.abs(ref).max())
    status = "ok" if rel <= MODEL_TOL else "FAIL"
    log(f"  responses vs plain path: max|d| {err:.3e}, max|d|/max|ref| {rel:.3e} "
        f"(tol {MODEL_TOL:g}), mean|d| {float(np.abs(preds - ref).mean()):.3e} {status}")
    if rel > MODEL_TOL:
        raise AssertionError(f"model responses differ from the plain path: {rel:.3e}")
    got_map, ref_map = core_map(model, batches[0]), core_map(plain_model, batches[0])
    compare(f"core map {tuple(ref_map.shape)} vs plain path", got_map, ref_map, CORE_TOL)
    where_the_time_goes(trainer, batches[0])
    return launches


def core_map(model, batch) -> torch.Tensor:
    """The core's (B, C, h, w) output for one host batch: what the readout
    samples, compared before any channel sum."""
    x, behaviors, pupils = (torch.from_numpy(batch[k]).to(DEVICE)
                            for k in ("image", "behavior", "pupil_center"))
    with torch.inference_mode():
        images, _ = model.image_cropper(x, "A", behaviors, pupils)
        return model.core(images, "A", behaviors, pupils)


def where_the_time_goes(trainer, batch) -> None:
    """Device time by kernel over one Trainer.predict call (torch.profiler),
    and the device's busy share of the call's wall time."""
    from torch.profiler import ProfilerActivity, profile

    log("phase 5: where the time goes, one batch of 64 under torch.profiler")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        trainer.predict("A", batch)
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
    for e in sorted(events, key=device_us, reverse=True)[:12]:
        log(f"  {device_us(e) / 1e3:9.3f} ms  x{e.count:<4d} {e.key[:90]}")


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
    try:
        with open(so_path + ".log") as f:
            for line in f:
                if "registers" in line or "spill" in line:
                    log("  " + line.strip())
    except FileNotFoundError:
        pass

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(0)
    with torch.inference_mode():
        rows = check_kernels(gen)
    torch.cuda.empty_cache()
    sublayer_yardsticks(gen)
    torch.cuda.empty_cache()
    launches = main_path(text)
    for row in rows:
        row["launches"] = launches[row["name"]]
    log(text)
    log(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
