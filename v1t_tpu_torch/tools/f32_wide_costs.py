"""What holds the float32 flash column groups (``flash_fwd_f32_cluster_kernel``,
``flash_bwd_f32_cluster_kernel``): the tensor cores' own rate, and the
kernels in variants of their sources that each take one cost away.

    python3 v1t_tpu_torch/tools/f32_wide_costs.py

First a probe of ``mma.sync``'s issue rate alone (m16n8k8 TF32 and m16n8k16
bf16, 8 independent accumulators a warp, 2 blocks a SM of 128-512 threads;
a CUDA source written and built with ``nvcc`` under
``_archive/f32_wide_costs/``). Then the package's tree is copied there once
a variant (``VARIANTS``: text substitutions of ``csrc/``, each of which must
match exactly once; all but ``tree`` and ``cvt.rna`` compute wrong outputs
on purpose), the copies build their libraries in parallel, and each runs in
a process of its own, in two rounds, the second in reverse order: the
forward (serving) and the backward without dropout at the emb-768 shape
(B*H 256, N 1654, head width 768; the mean of 3 launches after a warm-up,
CUDA events), and both against their plain versions at B*H 8 x 300 x 768
(max|d| / max|ref| of o and of dq, dk, dv). Prints the card's name and power
limit, then one JSON line a probe and a variant process.
"""

import json
import os
import shutil
import subprocess
import sys

import ab_common
from ab_common import N, ROOT, ms_of

OUT = os.path.join(ROOT, "_archive", "f32_wide_costs")
MMA_RATE_CU = r"""
#include <cstdio>
#include <cstdint>
#include <cuda_runtime.h>
template <bool TF32>
__global__ void rate(float* out, int iters) {
  float c[8][4] = {};
  const uint32_t a[4] = {threadIdx.x, 1u, 2u, 3u}, b[2] = {5u, 7u};
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      if (TF32)
        asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
                     "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                     : "+f"(c[k][0]), "+f"(c[k][1]), "+f"(c[k][2]), "+f"(c[k][3])
                     : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
      else
        asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
                     "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                     : "+f"(c[k][0]), "+f"(c[k][1]), "+f"(c[k][2]), "+f"(c[k][3])
                     : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
    }
  }
  float s = 0.f;
  for (int k = 0; k < 8; ++k) s += c[k][0] + c[k][1] + c[k][2] + c[k][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
template <bool TF32>
void run(int sms, int threads) {
  float* out;
  cudaMalloc(&out, (size_t)sms * 2 * threads * sizeof(float));
  const int iters = 4096;
  rate<TF32><<<sms * 2, threads>>>(out, 16);
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  cudaEventRecord(a);
  rate<TF32><<<sms * 2, threads>>>(out, iters);
  cudaEventRecord(b);
  cudaEventSynchronize(b);
  float ms = 0.f;
  cudaEventElapsedTime(&ms, a, b);
  const double flop = (TF32 ? 2048.0 : 4096.0) * sms * 2 * (threads / 32) * (double)iters * 8;
  printf("{\"probe\": \"mma.sync %s\", \"threads\": %d, \"tflops\": %.1f}\n",
         TF32 ? "m16n8k8 tf32" : "m16n8k16 bf16", threads, flop / ms / 1e9);
  cudaFree(out);
}
int main() {
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  for (int threads : {128, 256, 512}) {
    run<true>(sms, threads);
    run<false>(sms, threads);
  }
  return cudaGetLastError() != cudaSuccess;
}
"""

_SPLIT = """  big = to_tf32(x);
  small = to_tf32(x - __uint_as_float(big));"""
_ATOMIC = """          if (row < Nq)
            atomicAdd(reinterpret_cast<float4*>(dq + ((size_t)bh * Nq + row) * DP + g0 + col), val);"""
# name -> {source file: [(text, replacement)]}
VARIANTS = {
    "tree": {},
    # cvt.rna.tf32.f32 itself for the rounding (the same bits on finite values)
    "cvt.rna": {"tf32.cuh": [("  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;",
                              "  uint32_t r;\n  asm(\"cvt.rna.tf32.f32 %0, %1;\\n\" : \"=r\"(r) : "
                              "\"f\"(x));\n  return r;")]},
    # no splits: each operand's bits fed to the three products as they are
    "no splits": {"tf32.cuh": [(_SPLIT, "  big = __float_as_uint(x);\n  small = big;")]},
    # no cluster exchange: each block sums its own partials G times, behind a
    # block barrier instead of the cluster's
    "no cluster exchange": {
        name: [("cluster.map_shared_rank(sp, r)", "sp"),
               ("hopper::cluster_arrive();", "__syncthreads();"),
               ("hopper::cluster_wait();", "")]
        for name in ("flash_attention.cu", "flash_attention_bwd.cu")},
    # no dq adds in the backward
    "no dq atomics": {"flash_attention_bwd.cu": [
        (_ATOMIC, _ATOMIC.replace("row < Nq", "row < 0"))]},
}


def make_variant(name: str) -> str:
    tree = os.path.join(OUT, name.replace(" ", "_").replace(".", "_"))
    shutil.rmtree(tree, ignore_errors=True)
    shutil.copytree(os.path.join(ROOT, "v1t_tpu_torch"), os.path.join(tree, "v1t_tpu_torch"),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    for source, subs in VARIANTS[name].items():
        path = os.path.join(tree, "v1t_tpu_torch", "csrc", source)
        with open(path) as f:
            text = f.read()
        for old, new in subs:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: {old!r} is not in {source} exactly once")
            text = text.replace(old, new)
        with open(path, "w") as f:
            f.write(text)
    return tree


def measure(tree: str) -> dict:
    sys.path.insert(0, tree)
    import torch

    from v1t_tpu_torch import _build
    from v1t_tpu_torch.ops.flash_attention import (
        flash_bwd, flash_bwd_plain, flash_fwd, flash_fwd_plain,
    )

    _build.library()
    gen = torch.Generator().manual_seed(0)
    d, heads = 768, 4

    def operands(bh, n):
        xs = [(torch.randn(bh, n, d, generator=gen) * d ** -0.25).to("cuda") for _ in range(3)]
        return xs, torch.randn(bh // heads, n, heads, d, generator=gen).to("cuda")

    def rel(got, ref):
        return float((got - ref).abs().max() / ref.abs().max())

    with torch.no_grad():
        (q, k, v), do = operands(8, 300)
        o, lse = flash_fwd_plain(q, k, v, d, heads, with_lse=True)
        errors = {"o": rel(flash_fwd(q, k, v, d, heads), o)}
        for part, got, ref in zip(("dq", "dk", "dv"), flash_bwd(q, k, v, o, do, lse, d, heads),
                                  flash_bwd_plain(q, k, v, o, do, lse, d, heads)):
            errors[part] = rel(got, ref)
        (q, k, v), do = operands(256, N)
        o, lse = flash_fwd(q, k, v, d, heads, with_lse=True)
        times = {"forward serving": ms_of(lambda: flash_fwd(q, k, v, d, heads), 3),
                 "backward": ms_of(lambda: flash_bwd(q, k, v, o, do, lse, d, heads), 3)}
    return dict(tree=os.path.relpath(tree, ROOT),
                library=os.path.basename(_build.library_path()), ms=times, max_rel_err=errors)


def main() -> int:
    if len(sys.argv) > 2 and sys.argv[1] == "--measure":
        print(json.dumps(measure(os.path.abspath(sys.argv[2]))), flush=True)
        return 0
    print(ab_common.card_line(), flush=True)
    os.makedirs(OUT, exist_ok=True)
    probe = os.path.join(OUT, "mma_rate")
    with open(probe + ".cu", "w") as f:
        f.write(MMA_RATE_CU)
    rc = subprocess.run(["nvcc", "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-o", probe,
                         probe + ".cu"]).returncode or subprocess.run([probe]).returncode
    trees = [make_variant(name) for name in VARIANTS]
    build = ("import sys; sys.path.insert(0, sys.argv[1]); "
             "from v1t_tpu_torch import _build; _build.build()")
    builds = [subprocess.Popen([sys.executable, "-c", build, tree], stdout=subprocess.DEVNULL)
              for tree in trees]
    rc |= any(b.wait() for b in builds)
    for tree in trees + trees[::-1]:
        rc |= subprocess.run([sys.executable, os.path.abspath(__file__), "--measure",
                              tree]).returncode
    return int(bool(rc))


if __name__ == "__main__":
    sys.exit(main())
