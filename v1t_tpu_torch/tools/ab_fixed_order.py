"""The backward kernels' fixed-order sums against a parent tree, whose
kernels add with float atomics: each backward wrapper whose sums changed,
at the shapes the main paths give it, timed in each tree.

    python3 v1t_tpu_torch/tools/ab_fixed_order.py PARENT_TREE

PARENT_TREE is an unpacked ``git archive`` of the parent commit in a
gitignored directory (``_archive/parent``). Each tree runs in its own
process, in the order parent, this tree, this tree, parent; each builds its
kernel library. Cases: ``attention_bwd`` at the flagship (B 64 x 4 heads,
N 1654, D 155; with and without dropout), ``ln_linear_bwd``'s LayerNorm
epilogue at the flagship's qkv and fc1, ``bilinear_sample_cm_bwd`` at the
flagship's, the full-resolution and the float32 map, and ``flash_bwd`` at
full resolution (B*H 8, N 34,114), head widths 192 and 256 (B*H 64), the
fp32 flagship and cct's DP 32 (B*H 256, N 576), dropout on. Each time is
the mean of 10 launches after a warm-up (3 at full resolution and fp32;
CUDA events). Last, one flagship training step (batch 64, two mice of 7000
neurons, dropout on, an AdamW update) after a warm-up step: its device
time under torch.profiler (``ab_common.step_device_ms``). In this tree each case
and the step also run under PyTorch's deterministic mode (its buffer fill
off, so that the kernels alone are timed): two runs equal bit for bit, the
largest difference from the default form and from the plain version
(max|d| / max|ref|), and the time. Prints the card's name and power
limit, then one JSON line a process; with ``cuobjdump`` beside ``nvcc``,
this tree's shared-memory atomic instructions of the sampling backward.
"""

import contextlib
import os
import shutil
import subprocess
import sys

import ab_common
from ab_common import B, E, F_HID, H, N, NEURONS, ms_of, step_device_ms

FR_N = 137 * 249 + 1


def measure(tree: str) -> dict:
    sys.path.insert(0, tree)
    import torch

    from v1t_tpu_torch import _build
    from v1t_tpu_torch.ops import flash_attention as fa
    from v1t_tpu_torch.ops.dropout import Dropout
    from v1t_tpu_torch.ops.fused_mha import attention, attention_bwd, attention_bwd_plain
    from v1t_tpu_torch.ops.interp_matmul import (
        bilinear_sample_cm_bwd, bilinear_sample_cm_bwd_plain,
    )
    from v1t_tpu_torch.ops.ln_linear import ln_linear, ln_linear_bwd, ln_linear_bwd_plain

    so = _build.build()
    _build.library()
    fixed = hasattr(fa, "fixed_order")  # the parent has atomic sums only
    gen = torch.Generator().manual_seed(0)
    dev, bf, f32 = "cuda", torch.bfloat16, torch.float32
    drop = Dropout(0.2544, 20261017, 0)
    out = dict(tree=tree, fixed_order=fixed, cases={})

    def randn(*shape, scale=1.0, dtype=bf):
        return (torch.randn(*shape, generator=gen) * scale).to(dev, dtype)

    @contextlib.contextmanager
    def mode():
        from torch.utils import deterministic

        saved = (torch.are_deterministic_algorithms_enabled(),
                 deterministic.fill_uninitialized_memory)
        torch.use_deterministic_algorithms(True)
        deterministic.fill_uninitialized_memory = False
        try:
            yield
        finally:
            torch.use_deterministic_algorithms(saved[0])
            deterministic.fill_uninitialized_memory = saved[1]

    def flat(x):
        return [z for y in x for z in flat(y)] if isinstance(x, (tuple, list)) else [x]

    def rel(a, b):
        a, b = a.float(), b.float()
        return ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()

    def case(name, fn, plain=None, iters=10):
        row = {}
        if fixed:
            with mode():
                first, second = flat(fn()), flat(fn())
            torch.cuda.synchronize()
            default = flat(fn())
            row["rerun_bit_identical"] = all(
                a is None or torch.equal(a, b) for a, b in zip(first, second))
            row["vs_default"] = max(rel(a, b) for a, b in zip(first, default) if a is not None)
            if plain is not None:
                ref = flat(plain())
                row["vs_plain"] = max(rel(a, r) for a, r in zip(first, ref)
                                      if a is not None and r is not None)
                del ref
            with mode():
                row["fixed_order_ms"] = ms_of(fn, iters)
            del first, second, default
        row["ms"] = ms_of(fn, iters)
        out["cases"][name] = row
        torch.cuda.empty_cache()

    with torch.no_grad():
        x = randn(B, N, E)
        row = randn(B, E, scale=0.5)
        gamma = 1.0 + randn(E, scale=0.1, dtype=f32)
        beta = randn(E, scale=0.1, dtype=f32)
        wqkv = randn(3 * H * E, E, scale=0.08)
        w1 = randn(F_HID, E, scale=0.08)
        scale = torch.full((H,), E ** -0.5, device=dev)
        qkv = ln_linear(x, wqkv, gamma=gamma, beta=beta, pro_row=row, heads=(H, E))
        do = randn(B, N, H * E, scale=0.1)
        for label, drp in (("dropout", drop), ("no dropout", None)):
            o, lse = attention(qkv, scale, E, drop=drp, with_lse=True)
            case(f"attention_bwd flagship, {label}",
                 lambda: attention_bwd(qkv, o, do, lse, scale, E, drop=drp),
                 lambda: attention_bwd_plain(qkv, o, do, lse, scale, E, drop=drp))
        dqkv = attention_bwd(qkv, o, do, lse, scale, E)[0]
        dres = randn(B, N, E)
        kwq = dict(heads=(H, E), x=x, pro_row=row, gamma=gamma, beta=beta, dres=dres)
        case("ln_linear_bwd qkv", lambda: ln_linear_bwd(dqkv, wqkv, **kwq),
             lambda: ln_linear_bwd_plain(dqkv, wqkv, **kwq))
        dh = randn(B, N, F_HID)
        kw1 = dict(x=x, gamma=gamma, beta=beta, dres=dres)
        case("ln_linear_bwd fc1", lambda: ln_linear_bwd(dh, w1, **kw1),
             lambda: ln_linear_bwd_plain(dh, w1, **kw1))
        del dqkv, qkv, o, lse, do, dh, x
        for label, (b, hh, ww, dt) in {"flagship 29x57": (B, 29, 57, bf),
                                       "full-res 137x249": (2, 137, 249, bf),
                                       "fp32 29x57": (B, 29, 57, f32)}.items():
            table = randn(b, E, hh * ww, dtype=dt)
            grid = (torch.rand(b, NEURONS, 2, generator=gen) * 2.4 - 1.2).to(dev)
            ds = randn(b, E, NEURONS, dtype=dt)
            case(f"bilinear_sample_cm_bwd {label}",
                 lambda: bilinear_sample_cm_bwd(table, grid, ds, hh, ww),
                 lambda: bilinear_sample_cm_bwd_plain(table, grid, ds, hh, ww))
            del table, grid, ds

        def flash(label, bh, n, d, dt, plain=True, iters=10):
            dp = -(-d // 32) * 32
            q, k, v = (torch.zeros(bh, n, dp, dtype=dt, device=dev) for _ in range(3))
            for y in (q, k, v):
                y[..., :d] = randn(bh, n, d, scale=d ** -0.25, dtype=dt)
            o, lse = fa.flash_fwd(q, k, v, d, H, drop=drop, with_lse=True)
            g = randn(*o.shape, dtype=dt)
            case(f"flash_bwd {label}", lambda: fa.flash_bwd(q, k, v, o, g, lse, d, H, drop=drop),
                 (lambda: fa.flash_bwd_plain(q, k, v, o, g, lse, d, H, drop=drop)) if plain
                 else None, iters)

        flash("full-res, DP 160", 2 * H, FR_N, E, bf, plain=False, iters=3)
        flash("DP 192, B*H 64", 64, N, 192, bf)
        flash("DP 256, B*H 64", 64, N, 256, bf)
        flash("fp32 flagship", B * H, N, E, f32, iters=3)
        flash("cct DP 32", B * H, 576, 10, bf)

    out["step_device_ms"] = step_device_ms()
    if fixed:
        with mode():
            out["step_device_ms_fixed_order"] = step_device_ms()
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    if fixed and shutil.which(cuobjdump):
        sass = subprocess.run([cuobjdump, "-sass", so], capture_output=True, text=True).stdout
        fn, ops = "", {}
        for line in sass.splitlines():
            if "Function :" in line:
                fn = line.split("Function :")[-1]
            elif "bilinear_sample_cm_bwd" in fn and "ATOMS" in line and "*/" in line:
                op = line.split("*/")[1].split()[0]
                ops[op] = ops.get(op, 0) + 1
        out["sampling_backward_shared_atomics"] = ops
    return out


if __name__ == "__main__":
    sys.exit(ab_common.main(__file__, measure, __doc__))
