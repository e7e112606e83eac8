"""The pre-LN MLP sublayer of the V1T core on CUDA kernels, forward and
backward.

The JAX package computes LayerNorm -> fc1 -> exact-erf GELU -> dropout ->
fc2 -> dropout -> optional residual in one Pallas kernel per direction
(``v1t_tpu/ops/fused_mlp.py`` ``fused_mlp`` -> ``_mlp_fwd_kernel`` /
``_mlp_bwd_kernel``). Here the forward is two launches of ``ln_linear``
(``csrc/ln_linear.cu``):

    ln_linear (LayerNorm, fc1 + b1, GELU, dropout)  ->  ln_linear (fc2 + b2,
    dropout [+ x])

The hidden layer rounds to the input dtype between them, where the TPU
kernel rounded it before fc2. In training fc1 also writes its pre-GELU
activation (bf16), which the backward's GELU' reads: the TPU kernel
recomputed it from x; here it is saved, one (B, N, F) tensor per block.
The backward, behind ``torch.autograd.Function`` with the JAX
``custom_vjp``'s boundary and cotangents (dx; dgamma, dbeta, db1, db2
float32; dw1, dw2 in the weights' dtype), is

    ln_linear_bwd (fc2 dX, with fc1's keep mask and GELU' fused) +
    ln_linear_wgrad (dW2, db2)  ->  ln_linear_bwd (fc1 dX + LayerNorm
    backward + the residual's cotangent) + ln_linear_wgrad (dW1, db1)

with both keep masks regenerated from (seed, site) (``ops/dropout.py``).
"""

from __future__ import annotations

import typing as t

import torch

from v1t_tpu_torch.ops.dropout import Dropout
from v1t_tpu_torch.ops.ln_linear import (
    ln_linear, ln_linear_bwd, ln_linear_bwd_plain, ln_linear_plain, ln_linear_wgrad,
    ln_linear_wgrad_plain,
)

Tensor = torch.Tensor


class _Cfg(t.NamedTuple):
    fold_residual: bool
    drop1: t.Optional[Dropout]  # the hidden layer, after the GELU
    drop2: t.Optional[Dropout]  # the output, before the residual
    plain: bool


def _forward(cfg: _Cfg, x, gamma, beta, w1, b1, w2, b2, train: bool):
    lin = ln_linear_plain if cfg.plain else ln_linear
    h = lin(x, w1, gamma=gamma, beta=beta, bias=b1, gelu=True, drop=cfg.drop1, save_pre=train)
    h, pre = h if train else (h, None)
    out = lin(h, w2, bias=b2, drop=cfg.drop2, residual=x if cfg.fold_residual else None)
    return out, h, pre


class _FusedMLP(torch.autograd.Function):
    """The sublayer with the JAX ``custom_vjp``'s forward/backward boundary."""

    @staticmethod
    def forward(ctx, x, gamma, beta, w1, b1, w2, b2, cfg: _Cfg):
        out, h, pre = _forward(cfg, x, gamma, beta, w1, b1, w2, b2, True)
        ctx.cfg = cfg
        ctx.save_for_backward(x, gamma, beta, w1, w2, h, pre)
        return out

    @staticmethod
    def backward(ctx, dout):
        cfg = ctx.cfg
        x, gamma, beta, w1, w2, h, pre = ctx.saved_tensors
        bwd = ln_linear_bwd_plain if cfg.plain else ln_linear_bwd
        wgrad = ln_linear_wgrad_plain if cfg.plain else ln_linear_wgrad
        dout = dout.to(x.dtype).contiguous()
        # fc2: dh = keep1 * (mask2(dout) W2) * GELU'(pre); dW2, db2
        dh = bwd(dout, w2, drop=cfg.drop2, pre=pre, pre_drop=cfg.drop1)
        dw2, db2 = wgrad(dout, h, drop=cfg.drop2, bias=True)
        # fc1 and the LayerNorm (+ the residual's cotangent); dW1, db1
        dx, ln_out, dgamma, dbeta, _ = bwd(
            dh, w1, x=x, gamma=gamma, beta=beta, dres=dout if cfg.fold_residual else None,
        )
        dw1, db1 = wgrad(dh, ln_out, bias=True)
        return dx, dgamma, dbeta, dw1.to(w1.dtype), db1, dw2.to(w2.dtype), db2, None


def fused_mlp(
    x: Tensor,
    gamma: Tensor,
    beta: Tensor,
    w1: Tensor,
    b1: Tensor,
    w2: Tensor,
    b2: Tensor,
    *,
    fold_residual: bool = False,
    drop1: t.Optional[Dropout] = None,
    drop2: t.Optional[Dropout] = None,
    plain: bool = False,
) -> Tensor:
    """drop2(fc2(drop1(gelu(fc1(layernorm(x)))))) [+ x].

    x: (B, N, E); gamma/beta (E,), b1 (F,), b2 (E,) float32; w1 (F, E) and
    w2 (E, F) in nn.Linear layout, x's dtype. ``drop1`` / ``drop2`` are the
    training dropout of the hidden layer and of the output (None: off);
    they share one rate and seed. ``plain`` uses the plain versions on any
    device; otherwise CUDA tensors launch the kernels. When autograd
    records, the backward runs on the backward kernels (or, with ``plain``,
    their plain versions)."""
    cfg = _Cfg(fold_residual, drop1, drop2, plain)
    inputs = (x, gamma, beta, w1, b1, w2, b2)
    if torch.is_grad_enabled() and any(v.requires_grad for v in inputs):
        return _FusedMLP.apply(*inputs, cfg)
    return _forward(cfg, *inputs, False)[0]
