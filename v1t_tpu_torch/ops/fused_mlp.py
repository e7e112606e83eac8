"""The pre-LN MLP sublayer of the V1T core, forward, on CUDA kernels.

The JAX package computes LayerNorm -> fc1 -> exact-erf GELU -> dropout ->
fc2 -> dropout -> optional residual in one Pallas kernel
(``v1t_tpu/ops/fused_mlp.py`` ``fused_mlp`` -> ``_mlp_fwd_kernel``). Here it
is two launches of ``ln_linear`` (``csrc/ln_linear.cu``):

    ln_linear (LayerNorm, fc1 + b1, GELU)  ->  ln_linear (fc2 + b2 [+ x])

The hidden layer rounds to the input dtype between them, where the TPU
kernel rounded it before fc2. Dropout is training only.
"""

from __future__ import annotations

import torch

from v1t_tpu_torch.ops.ln_linear import ln_linear, ln_linear_plain

Tensor = torch.Tensor


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
    plain: bool = False,
) -> Tensor:
    """fc2(gelu(fc1(layernorm(x)))) [+ x], forward (eval: no dropout).

    x: (B, N, E); gamma/beta (E,), b1 (F,), b2 (E,) float32; w1 (F, E) and
    w2 (E, F) in nn.Linear layout, x's dtype. ``plain`` uses the plain
    version on any device; otherwise CUDA tensors launch the kernel."""
    lin = ln_linear_plain if plain else ln_linear
    h = lin(x, w1, gamma=gamma, beta=beta, bias=b1, gelu=True)
    return lin(h, w2, bias=b2, residual=x if fold_residual else None)
