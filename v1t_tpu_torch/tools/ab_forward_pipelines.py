"""A/B of the bf16 flash forward's two pipelines at padded head width 160.

``flash_fwd_wgmma_kernel`` runs one pipeline up to DP 160 (two q panels,
K and V in one ring) and another above (``fwd_wide``: one q panel, K and V
in rings of their own, one set of P fragments). This script copies the
port into ``_archive/fwd_wide_at_160/`` (gitignored) with ``fwd_wide``
moved to DP > 128, so that DP 160 runs the wide pipeline, and times both
trees in separate processes in the order tree, copy, copy, tree on one
card: the row-1 attention core at the flagship shape (B 64, H 4, N 1654,
D 155; serving, and training with dropout and the LSE) and the flash
forward at the full-resolution shape (8 planes, N 34114, D 155). Each
process first holds its kernels against their plain versions.

    python3 v1t_tpu_torch/tools/ab_forward_pipelines.py

Prints the card's name and power limit, then one JSON line a process.
"""

import os
import shutil
import sys

import ab_common
from ab_common import ROOT, ms_of

VARIANT = os.path.join(ROOT, "_archive", "fwd_wide_at_160")
NARROW = "constexpr bool fwd_wide() { return DP > 160; }"
WIDE_AT_160 = "constexpr bool fwd_wide() { return DP > 128; }"


def make_variant() -> None:
    shutil.rmtree(VARIANT, ignore_errors=True)
    shutil.copytree(os.path.join(ROOT, "v1t_tpu_torch"), os.path.join(VARIANT, "v1t_tpu_torch"),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    path = os.path.join(VARIANT, "v1t_tpu_torch", "csrc", "flash_attention.cu")
    src = open(path).read()
    if src.count(NARROW) != 1:
        raise SystemExit(f"{NARROW!r} not found once in {path}")
    open(path, "w").write(src.replace(NARROW, WIDE_AT_160))


def measure(tree: str) -> dict:
    sys.path.insert(0, tree)
    import torch

    import v1t_tpu_torch
    if not v1t_tpu_torch.__file__.startswith(tree):
        raise SystemExit(f"imported {v1t_tpu_torch.__file__}, not the tree {tree}")
    from v1t_tpu_torch.ops.dropout import Dropout
    from v1t_tpu_torch.ops.flash_attention import flash_fwd, flash_fwd_plain
    from v1t_tpu_torch.ops.fused_mha import attention, attention_plain

    def rel_err(pairs):
        worst = 0.0
        for got, ref in pairs:
            got, ref = got.float(), ref.float()
            if not torch.isfinite(got).all():
                raise SystemExit("non-finite output")
            worst = max(worst, ((got - ref).abs().max() / ref.abs().max()).item())
        if worst > 2e-2:  # chip_smoke.py's KERNEL_TOL
            raise SystemExit(f"the kernel disagrees with its plain version: {worst:.3e}")
        return worst

    gen = torch.Generator().manual_seed(0)
    bf, dev, d, dp = torch.bfloat16, "cuda", 155, 160
    drop = Dropout(0.2544, 20261017, 0)
    out = {"tree": os.path.relpath(tree, ROOT)}
    qkv = torch.zeros(3, 64, 4, 1654, dp, dtype=bf, device=dev)
    qkv[..., :d] = (torch.randn(3, 64, 4, 1654, d, generator=gen) * 0.35).to(dev, bf)
    scale = torch.full((4,), d ** -0.5, device=dev)
    train = dict(drop=drop, with_lse=True)
    out["core_rel_err"] = rel_err(
        [(attention(qkv, scale, d), attention_plain(qkv, scale, d)),
         *zip(attention(qkv, scale, d, **train), attention_plain(qkv, scale, d, **train))])
    out["core_serving_ms"] = ms_of(lambda: attention(qkv, scale, d), 20)
    out["core_training_ms"] = ms_of(lambda: attention(qkv, scale, d, **train), 20)
    del qkv

    def planes(bh, n):
        xs = [torch.zeros(bh, n, dp, dtype=bf, device=dev) for _ in range(3)]
        for x in xs:
            x[..., :d] = (torch.randn(bh, n, d, generator=gen) * d ** -0.25).to(dev, bf)
        return xs

    q, k, v = planes(16, 1654)
    out["flash_rel_err"] = rel_err(zip(flash_fwd(q, k, v, d, 4, **train),
                                       flash_fwd_plain(q, k, v, d, 4, **train)))
    q, k, v = planes(8, 34114)
    out["fullres_serving_ms"] = ms_of(lambda: flash_fwd(q, k, v, d, 4), 5)
    out["fullres_training_ms"] = ms_of(lambda: flash_fwd(q, k, v, d, 4, **train), 5)
    return out


def main() -> int:
    if sys.argv[1:2] != ["--measure"]:
        make_variant()
    return ab_common.main(__file__, measure, __doc__, trees=(ROOT, VARIANT, VARIANT, ROOT))


if __name__ == "__main__":
    sys.exit(main())
