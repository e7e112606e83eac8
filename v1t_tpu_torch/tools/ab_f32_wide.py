"""The float32 flash kernels past padded head width 256 (the column
groups), their step, and the kernels beside them that must stay as they
were, against a parent tree.

    python3 v1t_tpu_torch/tools/ab_f32_wide.py PARENT_TREE

PARENT_TREE is an unpacked ``git archive`` of the parent commit in a
gitignored directory (``_archive/parent``). Each tree runs in its own
process, in the order parent, this tree, this tree, parent; each builds its
kernel library. Cases, float32 unless named, N 1654, 4 heads:
- the emb-768 shape (B*H 256, head width 768): the training forward (LSE,
  dropout), the serving forward, the backward with dropout, without it and
  with dq in key order (PyTorch's deterministic mode, its buffer fill off);
- B*H 64 at head widths 288, 768 and 1024: the serving forward and the
  backward without dropout;
- controls, no change expected: float32 at head width 256 (B*H 64) and bf16
  at 768 (B*H 64, the bf16 column groups), serving forward and backward.
Each time is the mean of 3 launches (5 below B*H 256) after a warm-up (CUDA
events). Last, the device time of one float32 emb-768 training step (batch
64, 4 heads of 768, MLP 3072, two mice of 7000 neurons, an AdamW update)
after a warm-up step (``ab_common.step_device_ms``). Prints the card's name
and power limit, then one JSON line a process, with the name of the kernel
library it built (its hash covers every kernel source).
"""

import os
import sys

import ab_common
from ab_common import N, ROOT, ms_of, step_device_ms

WIDE_EMB, WIDE_MLP = 768, 3072


def measure(tree: str) -> dict:
    sys.path.insert(0, tree)
    import torch

    from v1t_tpu_torch import _build
    from v1t_tpu_torch.ops.dropout import Dropout
    from v1t_tpu_torch.ops.flash_attention import flash_bwd, flash_fwd

    _build.library()
    library = os.path.basename(_build.library_path())
    gen = torch.Generator().manual_seed(0)
    drop = Dropout(0.2544, 20261017, 0)

    def operands(bh, d, dtype):
        dp = -(-d // 32) * 32
        out = []
        for _ in range(3):
            x = torch.zeros(bh, N, dp, dtype=dtype, device="cuda")
            x[..., :d] = (torch.randn(bh, N, d, generator=gen) * d ** -0.25).to("cuda", dtype)
            out.append(x)
        do = torch.randn(bh // 4, N, 4, d, generator=gen).to("cuda", dtype)
        return out, do

    cases = {}
    with torch.no_grad():
        for bh, d, dtype, full in ((256, WIDE_EMB, torch.float32, True),
                                   (64, 288, torch.float32, False),
                                   (64, WIDE_EMB, torch.float32, False),
                                   (64, 1024, torch.float32, False),
                                   (64, 256, torch.float32, False),
                                   (64, WIDE_EMB, torch.bfloat16, False)):
            (q, k, v), do = operands(bh, d, dtype)
            iters = 3 if bh == 256 else 5
            label = f"{'bf16' if dtype == torch.bfloat16 else 'fp32'} B*H {bh} D {d}"
            o, lse = flash_fwd(q, k, v, d, 4, with_lse=True)
            cases[f"{label} forward serving"] = ms_of(lambda: flash_fwd(q, k, v, d, 4), iters)
            cases[f"{label} backward"] = ms_of(lambda: flash_bwd(q, k, v, o, do, lse, d, 4),
                                               iters)
            if full:
                od, lsed = flash_fwd(q, k, v, d, 4, with_lse=True, drop=drop)
                cases[f"{label} forward training"] = ms_of(
                    lambda: flash_fwd(q, k, v, d, 4, with_lse=True, drop=drop), iters)
                cases[f"{label} backward, dropout"] = ms_of(
                    lambda: flash_bwd(q, k, v, od, do, lsed, d, 4, drop=drop), iters)
                torch.use_deterministic_algorithms(True)
                fill = torch.utils.deterministic.fill_uninitialized_memory
                torch.utils.deterministic.fill_uninitialized_memory = False
                try:
                    cases[f"{label} backward, dropout, dq in key order"] = ms_of(
                        lambda: flash_bwd(q, k, v, od, do, lsed, d, 4, drop=drop), iters)
                finally:
                    torch.utils.deterministic.fill_uninitialized_memory = fill
                    torch.use_deterministic_algorithms(False)
                del od, lsed
            del q, k, v, do, o, lse
            torch.cuda.empty_cache()
    steps = {f"fp32 emb {WIDE_EMB}": step_device_ms(WIDE_EMB, WIDE_MLP, "fp32")}
    return dict(tree=os.path.relpath(tree, ROOT), library=library, kernel_ms=cases,
                step_device_ms=steps)


if __name__ == "__main__":
    sys.exit(ab_common.main(__file__, measure, __doc__))
