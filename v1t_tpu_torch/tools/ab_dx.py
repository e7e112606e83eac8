"""``ln_linear_bwd``'s dX at every shape that routes past K 640 (the wgmma
kernel in a tree that has it), and the flagship's rows 2 and 4 that must
stay as they were, against a parent tree.

    python3 v1t_tpu_torch/tools/ab_dx.py PARENT_TREE

PARENT_TREE is an unpacked ``git archive`` of the parent commit in a
gitignored directory (``_archive/parent``). Each tree runs in its own
process, in the order parent, this tree, this tree, parent; each builds its
kernel library. Cases, B 64 x 1654 rows, dropout on where the path has it:
- emb 768 (4 heads of 768, MLP 3072): qkv (head-major dY, K 768, the
  LayerNorm backward with bias_row and the residual's cotangent), fc1 (K
  768, the LayerNorm backward with the residual's), the out-projection (K
  3072, with dY's keep mask and without it: the dX kernel's masking step
  is the difference) and fc2 (K 3072, GELU'(pre) and fc1's keep mask);
- the sweep: phase 5d's out-projection at emb 256 x 4 heads (K 1024) and
  fc2 at the widest MLP (K 768) over emb 256 and over emb 155 (a dY of 155
  columns, rows not 16-byte aligned);
- the flagship (emb 155, K <= 640, no change expected): the
  out-projection, qkv, fc2 and fc1.
Each time is the mean of 10 launches after a warm-up (CUDA events). Last,
the device time of one emb-768 and one flagship training step (batch 64,
two mice of 7000 neurons, an AdamW update) after a warm-up step
(``ab_common.step_device_ms``). Prints the card's name and power limit,
then one JSON line a process, with the name of the kernel library it built
(its hash covers every kernel source).
"""

import os
import sys

import ab_common
from ab_common import B, E, F_HID, H, N, ROOT, ms_of, step_device_ms

WIDE_EMB, WIDE_MLP, SWEEP_EMB, SWEEP_MLP = 768, 3072, 256, 768


def measure(tree: str) -> dict:
    sys.path.insert(0, tree)
    import torch

    from v1t_tpu_torch import _build
    from v1t_tpu_torch.ops.dropout import Dropout
    from v1t_tpu_torch.ops.ln_linear import ln_linear_bwd

    _build.library()
    library = os.path.basename(_build.library_path())
    gen = torch.Generator().manual_seed(0)
    dev, bf, f32 = "cuda", torch.bfloat16, torch.float32
    drop_o, drop1, drop2 = (Dropout(0.2544, 20261017, site) for site in (1, 2, 3))

    def randn(*shape, scale=1.0, dtype=bf):
        return (torch.randn(*shape, generator=gen) * scale).to(dev, dtype)

    def layernorm(k):
        return dict(x=randn(B, N, k), gamma=1.0 + randn(k, scale=0.1, dtype=f32),
                    beta=randn(k, scale=0.1, dtype=f32), dres=randn(B, N, k))

    def uses(emb, heads, mlp, ow):
        """dy, w and keywords of a block's four dX calls at these widths."""
        ln = layernorm(emb)
        head_pad = -(-emb // 32) * 32
        return {
            "qkv": (randn(3, B, heads, N, head_pad, scale=0.3), randn(3 * heads * emb, emb,
                                                                      scale=emb ** -0.5),
                    dict(heads=(heads, emb), pro_row=randn(B, emb, scale=0.5), **ln)),
            "fc1": (randn(B, N, mlp, scale=0.2), randn(mlp, emb, scale=emb ** -0.5), ln),
            "out_proj": (randn(B, N, emb), randn(emb, ow, scale=emb ** -0.5),
                         dict(drop=drop_o)),
            "out_proj unmasked": (randn(B, N, emb), randn(emb, ow, scale=emb ** -0.5), {}),
            "fc2": (randn(B, N, emb), randn(emb, mlp, scale=emb ** -0.5),
                    dict(drop=drop2, pre=randn(B, N, mlp), pre_drop=drop1)),
        }

    cases = {}
    with torch.no_grad():
        for label, (emb, heads, mlp, ow, names) in {
                f"emb {WIDE_EMB}": (WIDE_EMB, H, WIDE_MLP, H * WIDE_EMB,
                                    ("qkv", "fc1", "out_proj", "out_proj unmasked", "fc2")),
                f"sweep emb {SWEEP_EMB}": (SWEEP_EMB, H, SWEEP_MLP, H * SWEEP_EMB,
                                           ("out_proj", "fc2")),
                f"sweep emb {E}": (E, H, SWEEP_MLP, H * E, ("fc2",)),
                f"flagship emb {E}": (E, H, F_HID, H * E, ("out_proj", "qkv", "fc2", "fc1")),
        }.items():
            calls = uses(emb, heads, mlp, ow)
            for name in names:
                dy, w, kw = calls[name]
                cases[f"{label} {name} (K {w.shape[1]})"] = ms_of(
                    lambda: ln_linear_bwd(dy, w, **kw))
            del calls
            torch.cuda.empty_cache()
    steps = {f"emb {WIDE_EMB}": step_device_ms(WIDE_EMB, WIDE_MLP), f"flagship emb {E}":
             step_device_ms(E)}
    return dict(tree=os.path.relpath(tree, ROOT), library=library, kernel_ms=cases,
                step_device_ms=steps)


if __name__ == "__main__":
    sys.exit(ab_common.main(__file__, measure, __doc__))
