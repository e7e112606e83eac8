"""The pre-LN attention sublayer of the V1T core, forward, on CUDA kernels.

The JAX package computes the whole sublayer in one Pallas kernel
(``v1t_tpu/ops/fused_mha.py`` ``fused_mha`` -> ``_mha_fwd_kernel_dt2``):
+bias_row, LayerNorm, bias-free QKV, per-head scale, key-pad and LSA masks,
softmax, head concat, output projection + bias, optional residual. Here it is
three launches of two hand-written kernels:

    ln_linear (+bias_row, LayerNorm, QKV; head-major out)  ->  attention
    ->  ln_linear (output projection + bias [+ x + bias_row])

``attention`` (``csrc/attention.cu``) is defined below with its plain
version; ``ln_linear`` lives in ``ops/ln_linear.py``. Dropout is training
only and comes with the training slice.
"""

from __future__ import annotations

import typing as t

import torch

from v1t_tpu_torch import _build
from v1t_tpu_torch.ops.ln_linear import ln_linear, ln_linear_plain, padded_head_dim

Tensor = torch.Tensor
LOG2E = 1.4426950408889634
KERNEL_HEAD_PADS = (32, 64, 96, 128, 160)  # padded head widths the kernel is built for


def _check(qkv: Tensor, scale: Tensor, head_dim: int) -> None:
    if qkv.ndim != 5 or qkv.shape[0] != 3 or not head_dim <= qkv.shape[-1]:
        raise ValueError(
            f"attention: qkv {tuple(qkv.shape)} is not (3, B, H, N, DP >= {head_dim})"
        )
    if qkv.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"attention: qkv is {qkv.dtype}: expected bf16 or float32")
    num_heads = qkv.shape[2]
    if tuple(scale.shape) != (num_heads,) or scale.dtype != torch.float32:
        raise ValueError(
            f"attention: scale is {tuple(scale.shape)} {scale.dtype}, "
            f"expected ({num_heads},) float32"
        )


def attention_plain(qkv: Tensor, scale: Tensor, head_dim: int, use_lsa: bool = False) -> Tensor:
    """Plain PyTorch version of the kernel: q is scaled (log2(e) folded in)
    and rounded to the input dtype, the softmax runs in base 2 in float32,
    the unnormalised probabilities round to the input dtype for P.V and rows
    are divided by their sum at the end, as in the kernel and in the TPU
    kernel it replaces."""
    dt = qkv.dtype
    _, b, h, n, _ = qkv.shape
    q, k, v = qkv[..., :head_dim].float()  # (B, H, N, D) each
    q = (q * (scale * LOG2E).view(1, -1, 1, 1)).to(dt).float()
    s = q @ k.transpose(-1, -2)  # (B, H, N, N) in log2 units
    if use_lsa:
        eye = torch.eye(n, dtype=torch.bool, device=qkv.device)
        s = s.masked_fill(eye, -torch.finfo(torch.float32).max)
    p = torch.exp2(s - s.amax(dim=-1, keepdim=True))
    o = (p.to(dt).float() @ v) / p.sum(dim=-1, keepdim=True)
    return o.permute(0, 2, 1, 3).reshape(b, n, h * head_dim).to(dt)


def attention(qkv: Tensor, scale: Tensor, head_dim: int, use_lsa: bool = False) -> Tensor:
    """qkv (3, B, H, N, DP) head-major as ``ln_linear(..., heads=(H, D))``
    writes it (rows zero-padded from D to DP), scale (H,) float32 ->
    (B, N, H*D): softmax(scale_h q.k) v per head (LSA: diagonal masked)."""
    _check(qkv, scale, head_dim)
    if qkv.device.type == "cpu":
        return attention_plain(qkv, scale, head_dim, use_lsa)
    _build.require_cuda("attention", (torch.bfloat16, torch.float32), qkv, scale)
    _, b, h, n, dp = qkv.shape
    if dp != padded_head_dim(head_dim) or dp not in KERNEL_HEAD_PADS:
        raise ValueError(f"attention: head width {head_dim} padded to {dp} is not supported")
    if b > 65535 or h > 65535:
        raise ValueError("attention: batch or heads exceed the launch grid")
    out = torch.empty((b, n, h * head_dim), dtype=qkv.dtype, device=qkv.device)
    rc = _build.library().v1t_attention(
        qkv.data_ptr(), scale.data_ptr(), out.data_ptr(),
        b, n, h, head_dim, dp, int(use_lsa), _build.stream_of(qkv),
    )
    _build.check_launch("attention", rc)
    attention.launches += 1
    return out


attention.launches = 0


def fused_mha(
    x: Tensor,
    gamma: Tensor,
    beta: Tensor,
    wqkv: Tensor,
    wp: Tensor,
    bp: Tensor,
    scale: t.Union[Tensor, float],
    *,
    num_heads: int,
    use_lsa: bool = False,
    fold_residual: bool = False,
    bias_row: t.Optional[Tensor] = None,
    plain: bool = False,
) -> Tensor:
    """The pre-LN attention sublayer, forward (eval: no dropout).

    Args:
        x: (B, N, E) residual stream.
        gamma/beta: (E,) LayerNorm affine, float32.
        wqkv: (3*H*D, E) bias-free QKV weight in nn.Linear layout, x's dtype.
        wp: (E, H*D) output projection weight, x's dtype; bp (E,) float32.
        scale: per-head (H,) float32 scale, or one float for every head.
        bias_row: (B, E) row added to every token before the LayerNorm (the
            behavior latent); the sublayer input is z = x + bias_row.
        fold_residual: return sublayer(z) + z instead of sublayer(z).
        plain: use the kernels' plain versions on any device (the composed
            path); otherwise CUDA tensors launch the kernels.
    Returns:
        (B, N, E) in x's dtype.
    """
    lin = ln_linear_plain if plain else ln_linear
    attn = attention_plain if plain else attention
    if not torch.is_tensor(scale):
        scale = torch.full((num_heads,), float(scale), device=x.device)
    scale = scale.float().reshape(-1).expand(num_heads).contiguous()
    head_dim = wqkv.shape[0] // (3 * num_heads)
    qkv = lin(x, wqkv, gamma=gamma, beta=beta, pro_row=bias_row, heads=(num_heads, head_dim))
    o = attn(qkv, scale, head_dim, use_lsa)
    return lin(
        o, wp, bias=bp,
        residual=x if fold_residual else None,
        res_row=bias_row if fold_residual else None,
    )
