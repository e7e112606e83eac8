"""Write ``wgmma.cuh``: the warpgroup matrix products (``wgmma.mma_async``,
bf16 inputs, fp32 accumulation) that the flash kernels issue, one inline-PTX
wrapper per width N, since PTX names every accumulator register of an
instruction. Run ``python3 v1t_tpu_torch/csrc/gen_wgmma.py`` after changing
the widths; a CPU test checks that the committed header is this output."""

from __future__ import annotations

import os

SS_WIDTHS = (32, 64, 96, 128, 160, 256)  # both operands in shared memory
RS_WIDTHS = (32, 64, 96, 128, 160, 192, 224, 256)  # A in registers

HEAD = """\
// Generated by gen_wgmma.py: do not edit by hand.
//
// wgmma.mma_async m64nNk16, bf16 x bf16 -> fp32, for the four warps of a
// warpgroup. d[N / 2] holds the thread's accumulator in the layout of
// mma.sync m16n8's C fragment, per warp w of the group and 8-column tile j:
// d[4j + 0..1] = (row 16w + g, cols 8j + 2t, +1), d[4j + 2..3] = row 16w +
// g + 8 (g = lane / 4, t = lane % 4). ss: A and B from shared-memory
// descriptors; rs: A from registers (a[4], mma.sync m16n8k16's A fragment
// per warp). TA / TB: 0 for a K-major operand, 1 for an MN-major one.
// scale_d 0 overwrites d, 1 accumulates.
#pragma once

#include <stdint.h>

namespace wgmma {

template <int N>
struct Mma;
"""


def _rows(items: list, per: int, sep: str) -> str:
    return sep.join(", ".join(items[i:i + per]) for i in range(0, len(items), per))


def _regs(n: int) -> str:
    return _rows([f"%{i}" for i in range(n)], 16, ', "\n        "')


def _outs(n: int) -> str:
    return _rows([f'"+f"(d[{i}])' for i in range(n)], 8, ",\n          ")


def _struct(n: int) -> str:
    r = n // 2
    ss_ops = f"%{r}, %{r + 1}, p, 1, 1, %{r + 3}, %{r + 4}"
    rs_ops = f"{{%{r}, %{r + 1}, %{r + 2}, %{r + 3}}}, %{r + 4}, p, 1, 1, %{r + 6}"
    lines = [f"template <>\nstruct Mma<{n}> {{"]
    if n in SS_WIDTHS:
        lines += [
            "  template <int TA, int TB>",
            f"  __device__ __forceinline__ static void ss(float (&d)[{r}], uint64_t da, "
            "uint64_t db, int scale_d) {",
            "    asm volatile(",
            '        "{\\n.reg .pred p;\\n"',
            f'        "setp.ne.b32 p, %{r + 2}, 0;\\n"',
            f'        "wgmma.mma_async.sync.aligned.m64n{n}k16.f32.bf16.bf16 "',
            f'        "{{{_regs(r)}}}, "',
            f'        "{ss_ops};\\n}}\\n"',
            f"        : {_outs(r)}",
            '        : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));',
            "  }",
        ]
    lines += [
        "  template <int TB>",
        f"  __device__ __forceinline__ static void rs(float (&d)[{r}], const uint32_t (&a)[4], "
        "uint64_t db, int scale_d) {",
        "    asm volatile(",
        '        "{\\n.reg .pred p;\\n"',
        f'        "setp.ne.b32 p, %{r + 5}, 0;\\n"',
        f'        "wgmma.mma_async.sync.aligned.m64n{n}k16.f32.bf16.bf16 "',
        f'        "{{{_regs(r)}}}, "',
        f'        "{rs_ops};\\n}}\\n"',
        f"        : {_outs(r)}",
        '        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), '
        '"n"(TB));',
        "  }",
        "};",
    ]
    return "\n".join(lines) + "\n"


def render() -> str:
    body = "\n".join(_struct(n) for n in sorted(set(SS_WIDTHS) | set(RS_WIDTHS)))
    return HEAD + "\n" + body + "\n}  // namespace wgmma\n"


def main() -> None:
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "wgmma.cuh")
    with open(path, "w") as f:
        f.write(render())


if __name__ == "__main__":
    main()
