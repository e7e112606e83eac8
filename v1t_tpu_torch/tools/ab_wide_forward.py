"""The two forward kernels past the panels' widths against a parent tree:
``ln_linear`` past K 640 (the projections) and the bf16 flash forward past
padded head width 256 (the column groups), with controls that must stay as
they were.

    python3 v1t_tpu_torch/tools/ab_wide_forward.py PARENT_TREE

PARENT_TREE is an unpacked ``git archive`` of the parent commit in a
gitignored directory (``_archive/parent``). Each tree runs in its own
process, in the order parent, this tree, this tree, parent; each builds its
kernel library. Cases, dropout on where the path has it:
- the projections at emb 768 (B 64 x 1654 rows): qkv (bias_row,
  LayerNorm, head-major, K 768, N 4 x 3 x 768), fc1 in training (LayerNorm,
  bias, GELU, keep mask, the pre-GELU activation saved) and serving, the
  out-projection (K 3072, bias, keep mask, residual and bias_row) and fc2
  (K 3072, bias, keep mask, residual); qkv and fc1 at K 672 and 1024 and the
  sweep's out-projection at K 1024 (8 x 1654 rows);
- the flash forward at the emb-768 shape (B*H 256, N 1654, DP 768) in
  training (keep mask, LSE) and serving, and at B*H 64 x 1654 serving at DP
  288, 384, 512, 768 and 1024;
- controls: the bf16 flash forward at DP 192 and 256 and the float32 one
  at DP 768 (B*H 64 serving), and the flagship's projections (K <= 640).
Each time is the mean of 10 launches after a warm-up (CUDA events; 5 at
the emb-768 flash shape). Beside each, a digest of its output's bits, so
that the four lines show whether y equals the parent's bit for bit (a note,
not a gate). Last, the device time of one emb-768 and one flagship training
step (batch 64, two mice of 7000 neurons, an AdamW update) after a warm-up
step (``ab_common.step_device_ms``). Prints the card's name and power limit,
then one JSON line a process, with the name of the kernel library it built
(its hash covers every kernel source). ``tools/ab_wide.py`` times the
flagship's and sweep-widest's kernels and steps against the same parent.
"""

import hashlib
import os
import sys

import ab_common
from ab_common import B, E, F_HID, H, N, ROOT, ms_of, step_device_ms

WIDE_EMB, WIDE_MLP = 768, 3072


def measure(tree: str) -> dict:
    sys.path.insert(0, tree)
    import torch

    from v1t_tpu_torch import _build
    from v1t_tpu_torch.ops.dropout import Dropout
    from v1t_tpu_torch.ops.flash_attention import flash_fwd
    from v1t_tpu_torch.ops.ln_linear import ln_linear

    _build.library()
    library = os.path.basename(_build.library_path())
    gen = torch.Generator().manual_seed(0)
    dev, bf, f32 = "cuda", torch.bfloat16, torch.float32
    drop_o, drop1, drop2, drop_p = (Dropout(0.2544, 20261017, site) for site in (1, 2, 3, 0))

    def randn(*shape, scale=1.0, dtype=bf):
        return (torch.randn(*shape, generator=gen) * scale).to(dev, dtype)

    def digest(out) -> str:
        out = out if isinstance(out, tuple) else (out,)
        h = hashlib.sha256()
        for t in out:
            h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
        return h.hexdigest()[:16]

    kernel_ms, bits = {}, {}

    def case(name, fn, iters=10):
        bits[name] = digest(fn())
        kernel_ms[name] = ms_of(fn, iters)

    def projections(label, emb, heads, mlp, b, names):
        """A block's projections at these widths over b x N rows."""
        x = randn(b, N, emb)
        ln = dict(gamma=1.0 + randn(emb, scale=0.1, dtype=f32),
                  beta=randn(emb, scale=0.1, dtype=f32))
        o, h_ = randn(b, N, heads * emb), randn(b, N, mlp)
        calls = {
            "qkv": (x, randn(3 * heads * emb, emb, scale=emb ** -0.5),
                    dict(pro_row=randn(b, emb, scale=0.5), heads=(heads, emb), **ln)),
            "fc1 training": (x, randn(mlp, emb, scale=emb ** -0.5),
                             dict(bias=randn(mlp, scale=0.1, dtype=f32), gelu=True, drop=drop1,
                                  save_pre=True, **ln)),
            "fc1 serving": (x, randn(mlp, emb, scale=emb ** -0.5),
                            dict(bias=randn(mlp, scale=0.1, dtype=f32), gelu=True, **ln)),
            "out_proj": (o, randn(emb, heads * emb, scale=(heads * emb) ** -0.5),
                         dict(bias=randn(emb, scale=0.1, dtype=f32), drop=drop_o, residual=x,
                              res_row=randn(b, emb, scale=0.5))),
            "fc2": (h_, randn(emb, mlp, scale=mlp ** -0.5),
                    dict(bias=randn(emb, scale=0.1, dtype=f32), drop=drop2, residual=x)),
        }
        for name in names:
            xx, w, kw = calls[name]
            case(f"{label} {name} (K {w.shape[1]})", lambda: ln_linear(xx, w, **kw))
        del calls, x, o, h_
        torch.cuda.empty_cache()

    def flash(label, bh, d, dtype, train, iters=10):
        dp = -(-d // 32) * 32
        q, k, v = (randn(bh, N, dp, scale=d ** -0.25 if i < 2 else 1.0, dtype=dtype)
                   for i in range(3))
        for t in (q, k, v):
            t[..., d:] = 0
        kw = dict(drop=drop_p, with_lse=True) if train else {}
        case(label, lambda: flash_fwd(q, k, v, d, H, **kw), iters)
        del q, k, v
        torch.cuda.empty_cache()

    with torch.no_grad():
        projections(f"emb {WIDE_EMB}", WIDE_EMB, H, WIDE_MLP, B,
                    ("qkv", "fc1 training", "fc1 serving", "out_proj", "fc2"))
        for k in (672, 1024):
            projections(f"8 x {N} rows, emb {k}", k, H, 4 * k, 8,
                        ("qkv", "fc1 training") + (("out_proj",) if k == 1024 else ()))
        projections(f"sweep emb 256 (8 x {N} rows)", 256, H, 768, 8, ("out_proj",))
        projections(f"control: flagship emb {E}", E, H, F_HID, B,
                    ("qkv", "fc1 training", "out_proj", "fc2"))
        flash(f"flash B*H {B * H} DP {WIDE_EMB} training", B * H, WIDE_EMB, bf, True, 5)
        flash(f"flash B*H {B * H} DP {WIDE_EMB} serving", B * H, WIDE_EMB, bf, False, 5)
        for d in (288, 384, 512, 768, 1024):
            flash(f"flash B*H 64 DP {d} serving", 64, d, bf, False)
        for d in (192, 256):
            flash(f"control: flash B*H 64 DP {d} serving", 64, d, bf, False)
        flash(f"control: float32 flash B*H 64 DP {WIDE_EMB} serving", 64, WIDE_EMB, f32, False,
              3)
    steps = {f"emb {WIDE_EMB}": step_device_ms(WIDE_EMB, WIDE_MLP), f"flagship emb {E}":
             step_device_ms(E)}
    return dict(tree=os.path.relpath(tree, ROOT), library=library, kernel_ms=kernel_ms,
                step_device_ms=steps, output_digest=bits)


if __name__ == "__main__":
    sys.exit(ab_common.main(__file__, measure, __doc__))
