"""Build and load the port's CUDA kernels.

Every ``.cu`` source under ``csrc/`` is compiled by its own ``nvcc -c``
process, all started together, and the objects are linked by one more into
a shared library with a plain C interface (no PyTorch headers: that build
takes seconds, where ``torch.utils.cpp_extension.load`` takes minutes),
which is loaded with ``ctypes``. The library lands in
``v1t_tpu_torch/_build/`` (listed in ``.gitignore``), named by a hash of the
sources and the flags, so it is built at first use and reused until a
source changes.

Nothing here runs at import: the CPU test suite imports every module of the
port on machines without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas=-v",
]
LINK_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-shared"]

_P, _I, _U, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
# C entry point -> argtypes: a c_void_p for every pointer and the stream,
# a c_int for every int (ctypes would otherwise cut pointers to 32 bits),
# a c_uint for every unsigned (dropout seeds, sites, thresholds), a c_float
# for every float
_DROP = [_U] * 3 + [_F]  # seed, site, threshold, scale
SIGNATURES = {
    "v1t_ln_linear": [_P] * 10 + [_I] * 9 + _DROP + [_P],
    "v1t_ln_linear_plan": [_I] * 11,
    "v1t_ln_linear_dx": [_P] * 3 + [_I] * 8 + [_U] * 3 + [_P] + [_U] * 2 + [_F] + [_P] * 10,
    "v1t_ln_linear_dx_smem": [_I] * 4,
    "v1t_ln_linear_wgrad": [_P] * 4 + [_I] * 7 + _DROP + [_P],
    "v1t_ln_linear_wgrad_plan": [_I] * 10,
    "v1t_attention": [_P] * 4 + [_I] * 7 + _DROP + [_P],
    "v1t_attention_bwd": [_P] * 11 + [_I] * 7 + _DROP + [_P],
    "v1t_bilinear_sample_cm": [_P] * 3 + [_I] * 6 + [_P],
    "v1t_bilinear_sample_cm_bwd": [_P] * 5 + [_I] * 6 + [_P],
    "v1t_bilinear_sample_cm_bwd_plan": [_I] * 4,
    "v1t_flash_attention": [_P] * 5 + [_I] * 12 + _DROP + [_P],
    "v1t_flash_attention_bwd": [_P] * 13 + [_I] * 12 + _DROP + [_P],
    "v1t_flash_attention_smem": [_I, _I],
    "v1t_flash_attention_bwd_smem": [_I, _I],
}


def sources() -> list:
    return sorted(
        glob.glob(os.path.join(CSRC_DIR, "*.cu"))
        + glob.glob(os.path.join(CSRC_DIR, "*.cuh"))
    )


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path() -> str:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for path in sources():
        digest.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"libv1t_kernels-{digest.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the kernels if the library for these sources is missing;
    returns its path. Prints the build's seconds; the compiler's register and
    shared-memory report goes to ``<library>.log``."""
    so_path = library_path()
    if os.path.exists(so_path):
        return so_path
    os.makedirs(BUILD_DIR, exist_ok=True)
    cu = [p for p in sources() if p.endswith(".cu")]
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        start = time.perf_counter()
        objects = [os.path.join(tmp, os.path.basename(p) + ".o") for p in cu]
        procs = [
            subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", obj, src],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src, obj in zip(cu, objects)
        ]
        logs, failed = [], []
        try:
            for src, proc in zip(cu, procs):
                out, _ = proc.communicate(timeout=600)
                logs.append(out)
                if proc.returncode != 0:
                    failed.append(f"{os.path.basename(src)} ({proc.returncode}):\n{out}")
        finally:  # a timeout or an interrupt leaves no compiler running
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        tmp_so = os.path.join(tmp, "lib.so")
        if not failed:
            link = subprocess.run([nvcc, *LINK_FLAGS, "-o", tmp_so, *objects],
                                  capture_output=True, text=True, timeout=600)
            logs.append(link.stdout + link.stderr)
            if link.returncode != 0:
                failed.append(f"link ({link.returncode}):\n{link.stdout}\n{link.stderr}")
        seconds = time.perf_counter() - start
        if failed:
            raise RuntimeError(f"nvcc failed in {seconds:.1f} s:\n" + "\n".join(failed))
        with open(so_path + ".log", "w") as log:
            log.write("".join(logs))
        # atomic publish: a concurrent build never sees a partial file
        os.replace(tmp_so, so_path)
    print(
        f"v1t_tpu_torch: nvcc built {len(cu)} kernel sources in parallel in "
        f"{seconds:.1f} s -> {os.path.relpath(so_path, _HERE)}",
        flush=True,
    )
    return so_path


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    lib = ctypes.CDLL(build())
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check_launch(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")


def ptr(tensor: torch.Tensor):
    """Device pointer of a tensor (None, i.e. NULL, for an absent one)."""
    return None if tensor is None else tensor.data_ptr()


def stream_of(tensor: torch.Tensor) -> int:
    return torch.cuda.current_stream(tensor.device).cuda_stream


def require_cuda(name: str, dtypes: tuple, *tensors) -> None:
    """Raise unless every given tensor lies on the first one's CUDA device,
    is contiguous, and has the dtype ``dtypes`` names for its position."""
    device = tensors[0].device
    if device.type != "cuda":
        raise ValueError(f"{name}: expected CUDA or CPU tensors, got {device}")
    for i, tensor in enumerate(tensors):
        if tensor is None:
            continue
        if tensor.device != device:
            raise ValueError(f"{name}: argument {i} on {tensor.device}, not {device}")
        if not tensor.is_contiguous():
            raise ValueError(f"{name}: argument {i} is not contiguous")
        if tensor.dtype != dtypes[i]:
            raise ValueError(f"{name}: argument {i} is {tensor.dtype}, expected {dtypes[i]}")
