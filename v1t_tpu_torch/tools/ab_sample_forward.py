"""The readout's sampling forward ``bilinear_sample_cm`` against a parent
tree, and against variants of its own source that each take one cost away.

Maps: the four the main paths give the kernel (the flagship's 29 x 57 bf16
map at C 155, the sweep-widest's at C 256, the full-resolution 137 x 249
bf16 map at batch 2, the fp32 model's 29 x 57 float32 map), 7000 grid
points an image, some outside the map. Each time is the mean of 20
launches after a warm-up (CUDA events), beside the least time the card
could take (table, grid and output bytes at 3.35 TB/s).

    python3 v1t_tpu_torch/tools/ab_sample_forward.py PARENT_TREE
    python3 v1t_tpu_torch/tools/ab_sample_forward.py --variants

With a parent tree (an unpacked ``git archive`` of the parent commit in a
gitignored directory such as ``_archive/parent``) each tree runs in its own
process, in the order parent, this tree, this tree, parent, through the
package's wrapper; each process first holds the kernel against its plain
version and a second launch (bit for bit) and times ``F.grid_sample`` on
the same inputs. With ``--variants`` the script builds
``csrc/bilinear_sample.cu`` alone with ``nvcc`` as it is and in variants
(``VARIANTS``: text substitutions, several of which compute wrong
outputs on purpose), under ``_archive/sample_forward_variants/``, and
times each at the four maps in two rounds, the second in reverse order.
Prints the card's name and power limit, then one JSON line a process or
variant (a variant's with ptxas's registers and spills of each forward
instantiation).
"""

import ctypes
import json
import os
import subprocess
import sys

import ab_common
from ab_common import ROOT, ms_of

SOURCE = os.path.join(ROOT, "v1t_tpu_torch", "csrc", "bilinear_sample.cu")
KERNEL_TOL, F32_KERNEL_TOL = 2e-2, 2e-5  # chip_smoke.py's
HBM_BYTES_PER_S = 3.35e12
# (batch, channels, height, width, dtype name)
MAPS = {"flagship 29x57": (64, 155, 29, 57, "bfloat16"),
        "sweep-widest C 256": (64, 256, 29, 57, "bfloat16"),
        "full-res 137x249": (2, 155, 137, 249, "bfloat16"),
        "fp32 29x57": (64, 155, 29, 57, "float32")}
NEURONS = 7000
_STORE = "      T* o = ob + (size_t)j * P + p;\n"
_LOOP = "  for (int q = threadIdx.x; 2 * q < P; q += THREADS) {\n"
_GRID = ("    const float* g = gb + 4 * (size_t)q;\n"
         "    const bool second = p + 1 < P;\n"
         "    int cell[2][4];\n"
         "    float wt[2][4];\n"
         "    corners(__ldg(g), __ldg(g + 1), true, height, width, cell[0], wt[0]);\n"
         "    corners(second ? __ldg(g + 2) : 0.f, second ? __ldg(g + 3) : 0.f, second, height, "
         "width,\n            cell[1], wt[1]);\n")
_NEXT = ("    {\n      const int n = {q};\n      const float* g = gb + 4 * (size_t)n;\n"
         "      const bool second = 2 * n + 1 < P;\n"
         "      next = make_float4(__ldg(g), __ldg(g + 1), second ? __ldg(g + 2) : 0.f,\n"
         "                         second ? __ldg(g + 3) : 0.f);\n    }\n")
# name -> [(text of the source, its replacement)]: each takes one cost away
# or tries another shape
VARIANTS = {
    "no output stores (stores only if a sum is 1234.5)": [
        (_STORE, "      if (acc[0][j] + acc[1][j] != 1234.5f) continue;\n" + _STORE)],
    "no staging (the walk reads uninitialised shared memory)": [
        ("    stage<T, G>(tb, words, cells, nc);\n", "")],
    "staging alone (no walk)": [
        ("    walk<T, G, true>(tb, words, gb, ob, nc, height, width, P);\n", "")],
    "no bank conflicts (lane l gathers cell l + 32 i)": [
        ("lds<BYTES>(words + (uint32_t)(cell[k][i] * BYTES), r);",
         "lds<BYTES>(words + (uint32_t)(((threadIdx.x & 31) + 32 * i) * BYTES), r);")],
    "no grid loads (points from sin / cos of p)": [
        (_GRID, _GRID.replace("__ldg(g), __ldg(g + 1)", "__sinf(p * 1.7f), __cosf(p * 2.3f)")
         .replace("__ldg(g + 2)", "__sinf(p * 1.3f)").replace("__ldg(g + 3)", "__cosf(p * 2.9f)"))],
    "the next pair's grid loaded into registers a pair ahead": [
        (_LOOP, "  float4 next = make_float4(0.f, 0.f, 0.f, 0.f);\n"
                "  if (2 * (int)threadIdx.x < P)\n" + _NEXT.replace("{q}", "threadIdx.x") + _LOOP),
        (_GRID, "    const float4 xy = next;\n    if (2 * (q + THREADS) < P)\n"
                + _NEXT.replace("{q}", "q + THREADS") + "    const bool second = p + 1 < P;\n"
                "    int cell[2][4];\n    float wt[2][4];\n"
                "    corners(xy.x, xy.y, true, height, width, cell[0], wt[0]);\n"
                "    corners(xy.z, xy.w, second, height, width, cell[1], wt[1]);\n")],
    "32 loads in flight a thread while staging": [
        ("constexpr int STAGE_LOADS = 16;", "constexpr int STAGE_LOADS = 32;")],
    "512 threads a block, two blocks a SM": [
        ("constexpr int THREADS = 256;", "constexpr int THREADS = 512;"),
        ("__launch_bounds__(THREADS, FWD_BLOCKS_PER_SM)", "__launch_bounds__(THREADS, 2)")],
}


def _inputs(torch):
    gen = torch.Generator().manual_seed(0)
    for label, (b, c, hh, ww, dtype_name) in MAPS.items():
        dtype = getattr(torch, dtype_name)
        table = torch.randn(b, c, hh * ww, generator=gen).to("cuda", dtype)
        grid = (torch.rand(b, NEURONS, 2, generator=gen) * 2.4 - 1.2).to("cuda")
        yield label, table, grid, hh, ww


def _bound_ms(*tensors) -> float:
    return sum(x.numel() * x.element_size() for x in tensors) / HBM_BYTES_PER_S * 1e3


def measure(tree: str) -> dict:
    """This tree's or the parent's kernel through the package's wrapper."""
    sys.path.insert(0, tree)
    import torch
    import torch.nn.functional as F

    import v1t_tpu_torch
    if not v1t_tpu_torch.__file__.startswith(tree):
        raise SystemExit(f"imported {v1t_tpu_torch.__file__}, not the tree {tree}")
    from v1t_tpu_torch.ops import interp_matmul as im

    out = {"tree": os.path.relpath(tree, ROOT)}
    for label, table, grid, hh, ww in _inputs(torch):
        got = im.bilinear_sample_cm(table, grid, hh, ww)
        ref = im.bilinear_sample_cm_plain(table, grid, hh, ww)
        torch.cuda.synchronize()
        if not torch.isfinite(got.float()).all():
            raise SystemExit(f"{label}: non-finite output")
        rel = ((got.float() - ref.float()).abs().max() / ref.float().abs().max()).item()
        if rel > (KERNEL_TOL if table.dtype == torch.bfloat16 else F32_KERNEL_TOL):
            raise SystemExit(f"{label}: the kernel disagrees with its plain version: {rel:.3e}")
        if not torch.equal(got, im.bilinear_sample_cm(table, grid, hh, ww)):
            raise SystemExit(f"{label}: two launches differ")
        b, c, _ = table.shape
        table4, grid4 = table.reshape(b, c, hh, ww), grid.reshape(b, 1, NEURONS, 2).to(table.dtype)
        kernel_ms = ms_of(lambda: im.bilinear_sample_cm(table, grid, hh, ww), 20)
        out[label] = dict(
            kernel_ms=kernel_ms, bound_ms=_bound_ms(table, grid, got), rel_err=rel,
            grid_sample_ms=ms_of(lambda: F.grid_sample(
                table4, grid4, mode="bilinear", padding_mode="zeros", align_corners=True), 20))
        out[label]["bound_share"] = out[label]["bound_ms"] / kernel_ms
        del table, grid, got, ref, table4, grid4
        torch.cuda.empty_cache()
    return out


def variants() -> int:
    """Build the source and its variants alone and time each."""
    import torch

    src = open(SOURCE).read()
    build = os.path.join(ROOT, "_archive", "sample_forward_variants")
    os.makedirs(build, exist_ok=True)
    sources = {"as built": src}
    for name, subs in VARIANTS.items():
        text = src
        for old, new in subs:
            if text.count(old) != 1:
                raise SystemExit(f"{name}: {old!r} not found once in {SOURCE}")
            text = text.replace(old, new)
        sources[name] = text
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    procs = {}
    for i, (name, text) in enumerate(sources.items()):
        path = os.path.join(build, f"v{i}.cu")
        open(path, "w").write(text)
        procs[name] = (path[:-3] + ".so", subprocess.Popen(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xcompiler",
             "-fPIC", "-Xptxas=-v", "-shared", "-I", os.path.dirname(SOURCE), "-o",
             path[:-3] + ".so", path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs, ptxas = {}, {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{name}: nvcc failed:\n{log[-3000:]}")
        # each forward instantiation's registers and spill stores
        lines = log.splitlines()
        ptxas[name] = {
            line.split("bilinear_sample_cm_kernelI")[1].split("EE")[0]: " ".join(
                part.split(":")[-1].strip() for part in lines[i + 2:i + 4])
            for i, line in enumerate(lines)
            if "Compiling entry function" in line and "bilinear_sample_cm_kernelI" in line}
        lib = ctypes.CDLL(so)
        lib.v1t_bilinear_sample_cm.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [
            ctypes.c_void_p]
        libs[name] = lib
    inputs = list(_inputs(torch))
    bounds = {label: _bound_ms(table, grid) + table.shape[0] * table.shape[1] * NEURONS
              * table.element_size() / HBM_BYTES_PER_S * 1e3
              for label, table, grid, _, _ in inputs}
    times = {name: {label: [] for label in bounds} for name in libs}
    for order in (list(libs), list(libs)[::-1]):
        for name in order:
            for label, table, grid, hh, ww in inputs:
                b, c, _ = table.shape
                out = torch.empty(b, c, NEURONS, dtype=table.dtype, device="cuda")
                stream = torch.cuda.current_stream().cuda_stream

                def launch():
                    rc = libs[name].v1t_bilinear_sample_cm(
                        table.data_ptr(), grid.data_ptr(), out.data_ptr(), b, c, hh, ww, NEURONS,
                        int(table.dtype == torch.float32), stream)
                    if rc:
                        raise SystemExit(f"{name}: launch failed with {rc}")
                times[name][label].append(ms_of(launch, 20))
    for name, by_map in times.items():
        print(json.dumps({"variant": name, "ptxas": ptxas[name], **{
            label: dict(kernel_ms=ms, bound_ms=bounds[label],
                        bound_share=[bounds[label] / m for m in ms])
            for label, ms in by_map.items()}}), flush=True)
    return 0


def main() -> int:
    if sys.argv[1:] == ["--variants"]:
        print(ab_common.card_line(), flush=True)
        return variants()
    return ab_common.main(__file__, measure, __doc__)


if __name__ == "__main__":
    sys.exit(main())
