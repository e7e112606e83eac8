"""The flagship's and the sweep-widest core's kernels against a parent
tree: the paths that the kernels' forms past the panels' widths (the flash
column groups above padded head width 256, the LayerNorm past K 640) must
leave as they were.

    python3 v1t_tpu_torch/tools/ab_wide.py PARENT_TREE

PARENT_TREE is an unpacked ``git archive`` of the parent commit in a
gitignored directory (``_archive/parent``). Each tree runs in its own
process, in the order parent, this tree, this tree, parent; each builds its
kernel library. Cases, dropout on where the path has it: ``ln_linear`` at
the flagship's four projections (B 64 x 1654 rows; qkv, out-projection,
fc1, fc2), ``attention`` (row 1's core, training) and ``attention_bwd``,
``ln_linear_bwd`` at the four projections, and ``flash_fwd`` /
``flash_bwd`` at the sweep-widest core's head width 256 (B*H 256, N 1654).
Each time is the mean of 10 launches after a warm-up (CUDA events). Last,
one flagship and one sweep-widest (emb 256) training step (batch 64, two
mice of 7000 neurons, an AdamW update) after a warm-up step: each step's
device time under torch.profiler (``ab_common.step_device_ms``). Prints
the card's name and power limit, then one JSON line a process, with the
name of the kernel library it built (its hash covers every kernel source).
"""

import os
import sys

import ab_common
from ab_common import B, E, F_HID, H, N, ROOT, ms_of, step_device_ms


def measure(tree: str) -> dict:
    sys.path.insert(0, tree)
    import torch

    from v1t_tpu_torch import _build
    from v1t_tpu_torch.ops import flash_attention as fa
    from v1t_tpu_torch.ops.dropout import Dropout
    from v1t_tpu_torch.ops.fused_mha import attention, attention_bwd
    from v1t_tpu_torch.ops.ln_linear import ln_linear, ln_linear_bwd

    _build.library()
    library = os.path.basename(_build.library_path())
    gen = torch.Generator().manual_seed(0)
    dev, bf, f32 = "cuda", torch.bfloat16, torch.float32
    drops = [Dropout(0.2544, 20261017, site) for site in range(4)]

    def randn(*shape, scale=1.0, dtype=bf):
        return (torch.randn(*shape, generator=gen) * scale).to(dev, dtype)

    cases = {}
    ow = -(-H * E // 8) * 8
    with torch.no_grad():
        x, row = randn(B, N, E), randn(B, E, scale=0.5)
        gamma, beta = 1.0 + randn(E, scale=0.1, dtype=f32), randn(E, scale=0.1, dtype=f32)
        wqkv, wp = randn(3 * H * E, E, scale=0.08), randn(E, ow, scale=0.04)
        w1, w2 = randn(F_HID, E, scale=0.08), randn(E, F_HID, scale=0.05)
        bp, b1 = randn(E, scale=0.1, dtype=f32), randn(F_HID, scale=0.1, dtype=f32)
        b2 = randn(E, scale=0.1, dtype=f32)
        scale = torch.full((H,), E ** -0.5, device=dev)
        qkv = ln_linear(x, wqkv, gamma=gamma, beta=beta, pro_row=row, heads=(H, E))
        o, lse = attention(qkv, scale, E, drop=drops[0], with_lse=True)
        hid, pre = ln_linear(x, w1, gamma=gamma, beta=beta, bias=b1, gelu=True, drop=drops[2],
                             save_pre=True)
        fwd = {"qkv": (x, wqkv, dict(gamma=gamma, beta=beta, pro_row=row, heads=(H, E))),
               "out_proj": (o, wp, dict(bias=bp, residual=x, res_row=row, drop=drops[1])),
               "fc1": (x, w1, dict(gamma=gamma, beta=beta, bias=b1, gelu=True, drop=drops[2],
                                   save_pre=True)),
               "fc2": (hid, w2, dict(bias=b2, residual=x, drop=drops[3]))}
        for use, (a, w, kw) in fwd.items():
            cases[f"ln_linear {use}"] = ms_of(lambda: ln_linear(a, w, **kw))
        cases["attention training"] = ms_of(lambda: attention(qkv, scale, E, drop=drops[0],
                                                              with_lse=True))
        do = randn(B, N, H * E, scale=0.1)
        cases["attention_bwd"] = ms_of(lambda: attention_bwd(qkv, o, do, lse, scale, E,
                                                             drop=drops[0]))
        dqkv, _ = attention_bwd(qkv, o, do, lse, scale, E, drop=drops[0])
        dout = randn(B, N, E)
        fc2_dx = ln_linear_bwd(dout, w2, drop=drops[3], pre=pre, pre_drop=drops[2])
        bwd = {"out_proj": (dout, wp[:, :H * E].contiguous(), dict(drop=drops[1])),
               "qkv": (dqkv, wqkv, dict(heads=(H, E), x=x, pro_row=row, gamma=gamma, beta=beta,
                                        dres=dout)),
               "fc2": (dout, w2, dict(drop=drops[3], pre=pre, pre_drop=drops[2])),
               "fc1": (fc2_dx, w1, dict(x=x, gamma=gamma, beta=beta, dres=dout))}
        for use, (dy, w, kw) in bwd.items():
            cases[f"ln_linear_bwd {use}"] = ms_of(lambda: ln_linear_bwd(dy, w, **kw))
        del x, qkv, o, lse, hid, pre, do, dqkv, dout, fc2_dx
        torch.cuda.empty_cache()
        d = 256
        q, k, v = (randn(B * H, N, d, scale=d ** -0.25) for _ in range(3))
        o, lse = fa.flash_fwd(q, k, v, d, H, drop=drops[0], with_lse=True)
        cases["flash_fwd DP 256"] = ms_of(lambda: fa.flash_fwd(q, k, v, d, H, drop=drops[0],
                                                               with_lse=True))
        gy = randn(*o.shape)
        cases["flash_bwd DP 256"] = ms_of(lambda: fa.flash_bwd(q, k, v, o, gy, lse, d, H,
                                                               drop=drops[0]))
        del q, k, v, o, lse, gy
        torch.cuda.empty_cache()
    steps = {label: step_device_ms(emb) for label, emb in (("flagship", E),
                                                            ("sweep-widest", 256))}
    return dict(tree=os.path.relpath(tree, ROOT), library=library, kernel_ms=cases,
                step_device_ms=steps)


if __name__ == "__main__":
    sys.exit(ab_common.main(__file__, measure, __doc__))
