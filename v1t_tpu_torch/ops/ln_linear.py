"""``ln_linear``: y = epilogue(prologue(x) @ w^T), the projection kernel of the
ViT block (``csrc/ln_linear.cu``), and its plain PyTorch version.

- prologue (optional): ``+ pro_row`` (a per-batch row, the behavior latent),
  then LayerNorm (eps 1e-5) with ``gamma``/``beta``;
- epilogue (optional): ``+ bias``, exact-erf GELU, ``+ residual`` (itself
  plus an optional per-batch ``res_row``).

It serves the QKV projection (LayerNorm, no bias), the output projection
(bias + residual), fc1 (LayerNorm, bias, GELU) and fc2 (bias + residual) of
``fused_mha`` and ``fused_mlp``. For the QKV projection ``heads=(H, D)``
writes the output head-major, (Nout / (H*D), B, H, N, DP) with each head's
rows zero-padded from D to DP = ``padded_head_dim(D)``, the layout the
attention kernel streams with 16-byte copies.

Activations round to the input dtype where the JAX package's fused TPU
kernels round them: the (x + row) sum, the normalised input, the projection
before a residual add and the output.

A CUDA tensor launches the kernel (bf16 only); a CPU tensor takes the plain
version (bf16 or float32). ``ln_linear.launches`` counts kernel launches.
"""

from __future__ import annotations

import typing as t

import torch
import torch.nn.functional as F

from v1t_tpu_torch import _build

Tensor = torch.Tensor
MAX_K = 640  # the kernel keeps a 64 x K panel of x in shared memory


def padded_head_dim(head_dim: int) -> int:
    """Head width padded to a multiple of 32 (155 -> 160): a whole number
    of 16-wide mma k-steps and of 8-wide ldmatrix pairs."""
    return -(-head_dim // 32) * 32


def _check(x, w, gamma, beta, pro_row, bias, residual, res_row, heads) -> None:
    if x.ndim != 3 or w.ndim != 2 or w.shape[1] != x.shape[2]:
        raise ValueError(f"ln_linear: x {tuple(x.shape)} and w {tuple(w.shape)} do not match")
    if x.dtype not in (torch.bfloat16, torch.float32) or w.dtype != x.dtype:
        raise ValueError(f"ln_linear: x {x.dtype} / w {w.dtype}: expected one of bf16, float32")
    b, n, k = x.shape
    nout = w.shape[0]
    if (gamma is None) != (beta is None):
        raise ValueError("ln_linear: gamma and beta come together")
    expected = {
        "gamma": (gamma, (k,), torch.float32),
        "beta": (beta, (k,), torch.float32),
        "pro_row": (pro_row, (b, k), x.dtype),
        "bias": (bias, (nout,), torch.float32),
        "residual": (residual, (b, n, nout), x.dtype),
        "res_row": (res_row, (b, nout), x.dtype),
    }
    for name, (tensor, shape, dtype) in expected.items():
        if tensor is None:
            continue
        if tuple(tensor.shape) != shape or tensor.dtype != dtype:
            raise ValueError(
                f"ln_linear: {name} is {tuple(tensor.shape)} {tensor.dtype}, "
                f"expected {shape} {dtype}"
            )
    if res_row is not None and residual is None:
        raise ValueError("ln_linear: res_row needs a residual")
    if pro_row is not None and gamma is None:
        raise ValueError("ln_linear: pro_row is applied before the LayerNorm")
    if heads is not None:
        num_heads, head_dim = heads
        if num_heads < 1 or head_dim < 1 or nout % (num_heads * head_dim):
            raise ValueError(f"ln_linear: {nout} outputs do not split into heads {heads}")
        if residual is not None:
            raise ValueError("ln_linear: a head-major output takes no residual")


def _split_heads(y: Tensor, heads) -> Tensor:
    """(B, N, S*H*D) -> (S, B, H, N, DP), zero-padded past D."""
    num_heads, head_dim = heads
    b, n, nout = y.shape
    y = y.reshape(b, n, nout // (num_heads * head_dim), num_heads, head_dim)
    y = y.permute(2, 0, 3, 1, 4)
    return F.pad(y, (0, padded_head_dim(head_dim) - head_dim)).contiguous()


def ln_linear_plain(
    x: Tensor, w: Tensor, *, gamma: t.Optional[Tensor] = None,
    beta: t.Optional[Tensor] = None, pro_row: t.Optional[Tensor] = None,
    bias: t.Optional[Tensor] = None, gelu: bool = False,
    residual: t.Optional[Tensor] = None, res_row: t.Optional[Tensor] = None,
    heads: t.Optional[t.Tuple[int, int]] = None,
) -> Tensor:
    """The plain PyTorch version of the kernel, in float32 between the
    rounding points (any device)."""
    dt = x.dtype
    z = x.float()
    if pro_row is not None:
        z = (z + pro_row.float()[:, None, :]).to(dt).float()
    if gamma is not None:
        z = F.layer_norm(z, (z.shape[-1],), gamma, beta, eps=1e-5)
    y = z.to(dt).float() @ w.float().t()
    if bias is not None:
        y = y + bias
    if gelu:
        y = F.gelu(y)
    if residual is not None:
        r = residual.float()
        if res_row is not None:
            r = (r + res_row.float()[:, None, :]).to(dt).float()
        y = y.to(dt).float() + r
    y = y.to(dt)
    return y if heads is None else _split_heads(y, heads)


def ln_linear(
    x: Tensor, w: Tensor, *, gamma: t.Optional[Tensor] = None,
    beta: t.Optional[Tensor] = None, pro_row: t.Optional[Tensor] = None,
    bias: t.Optional[Tensor] = None, gelu: bool = False,
    residual: t.Optional[Tensor] = None, res_row: t.Optional[Tensor] = None,
    heads: t.Optional[t.Tuple[int, int]] = None,
) -> Tensor:
    """x (B, N, K), w (Nout, K) -> (B, N, Nout), or with ``heads=(H, D)``
    (Nout / (H*D), B, H, N, DP). gamma/beta (K,) and bias (Nout,) are
    float32; pro_row (B, K), residual (B, N, Nout) and res_row (B, Nout)
    have x's dtype."""
    _check(x, w, gamma, beta, pro_row, bias, residual, res_row, heads)
    if x.device.type == "cpu":
        return ln_linear_plain(
            x, w, gamma=gamma, beta=beta, pro_row=pro_row, bias=bias,
            gelu=gelu, residual=residual, res_row=res_row, heads=heads,
        )
    bf, f32 = torch.bfloat16, torch.float32
    args = (x, w, gamma, beta, pro_row, bias, residual, res_row)
    _build.require_cuda("ln_linear", (bf, bf, f32, f32, bf, f32, bf, bf), *args)
    b, n, k = x.shape
    nout = w.shape[0]
    if k > MAX_K:
        raise ValueError(f"ln_linear: K = {k} > {MAX_K}")
    # w's rows zero-padded to a multiple of 32 (16-byte aligned copies)
    kp = -(-k // 32) * 32
    w_pad = w if kp == k else F.pad(w, (0, kp - k))
    if heads is None:
        num_heads = head_dim = head_pad = 0
        y = torch.empty((b, n, nout), dtype=bf, device=x.device)
    else:
        num_heads, head_dim = heads
        head_pad = padded_head_dim(head_dim)
        y = torch.empty((nout // (num_heads * head_dim), b, num_heads, n, head_pad),
                        dtype=bf, device=x.device)
    args = (x, w_pad, *args[2:])
    rc = _build.library().v1t_ln_linear(
        *(_build.ptr(a) for a in args), y.data_ptr(),
        b * n, nout, k, kp, n, int(gelu), num_heads, head_dim, head_pad, _build.stream_of(x),
    )
    _build.check_launch("ln_linear", rc)
    ln_linear.launches += 1
    return y


ln_linear.launches = 0
