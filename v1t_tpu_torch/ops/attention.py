"""Multi-head attention of the composed attention path: the flash kernels
(``ops/flash_attention.py``) or a plain einsum form
(``v1t_tpu/ops/attention.py`` ``multi_head_attention`` and
``_attention_xla``).

Dispatch, as the JAX package's: ``impl`` "auto" takes flash attention for
N >= 256 and the einsum form below (tiny sequences are not worth a kernel
launch); "pallas" always flash; ``return_probs`` the einsum form, the only
one that exports the probabilities (attention rollout). Flash attention
launches the kernels on a CUDA tensor and runs their plain versions on a
CPU tensor, the port's counterpart of the Pallas interpreter. "xla" is the
port's plain path: the plain flash version (chunked, so that a 34,114-token
reference fits on the card) where "auto" would launch the kernels.
"""

from __future__ import annotations

import typing as t

import torch

from v1t_tpu_torch.ops.dropout import Dropout, keep_mask
from v1t_tpu_torch.ops.flash_attention import flash_attention

Tensor = torch.Tensor
MIN_FLASH_N = 256


def attention_einsum(q: Tensor, k: Tensor, v: Tensor, scale: t.Union[Tensor, float],
                     use_lsa: bool = False, drop: t.Optional[Dropout] = None,
                     return_probs: bool = False):
    """q, k, v (B, H, N, D); scale a float or per-head (H,). Scores and
    softmax in float32, the (dropped) probabilities cast to v's dtype for
    the product, the output in q's dtype (``_attention_xla``). Dropout uses
    the keep mask of element (b * H + h, query, key), as the kernels do."""
    b, h, n, _ = q.shape
    scale = torch.as_tensor(scale, dtype=torch.float32, device=q.device)
    if scale.ndim == 1:
        scale = scale.view(1, -1, 1, 1)
    dots = (q.float() @ k.float().transpose(-1, -2)) * scale
    if use_lsa:
        eye = torch.eye(n, dtype=torch.bool, device=q.device)
        dots = dots.masked_fill(eye, -torch.finfo(torch.float32).max)
    probs = torch.softmax(dots, dim=-1)
    attn = probs
    if drop is not None and drop.active:
        keep = keep_mask(drop, b * h, n, n, q.device).view(b, h, n, n)
        attn = torch.where(keep, attn * drop.scale, 0.0)
    out = (attn.to(v.dtype).float() @ v.float()).to(q.dtype)
    return (out, probs) if return_probs else out


def multi_head_attention(q: Tensor, k: Tensor, v: Tensor, scale: t.Union[Tensor, float], *,
                         use_lsa: bool = False, drop: t.Optional[Dropout] = None,
                         impl: str = "auto", return_probs: bool = False):
    """(B, H, N, D) q, k, v -> (B, H, N, D) context, plus the (B, H, N, N)
    probabilities with ``return_probs``. ``drop``: training dropout of the
    probabilities."""
    if impl not in ("auto", "pallas", "xla"):
        raise ValueError(f"multi_head_attention: impl {impl!r}")
    if return_probs or (impl != "pallas" and q.shape[2] < MIN_FLASH_N):
        return attention_einsum(q, k, v, scale, use_lsa, drop, return_probs)
    return flash_attention(q, k, v, scale, use_lsa=use_lsa, drop=drop, plain=impl == "xla")
