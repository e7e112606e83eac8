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

Training adds ``drop`` (the output's keep mask, after bias and GELU and
before the rounding and the residual, ``ops/dropout.py``) and ``save_pre``
(fc1 also returns its pre-GELU activation in bf16, which the backward's
GELU' reads: saved, not recomputed). The backward is two kernels
(``csrc/ln_linear_bwd.cu``): ``ln_linear_bwd`` (dX = dY' W, with fc1's
mask and GELU' or the LayerNorm backward fused; it reads each dY' element
once a call when K <= 160 or dY' fits in shared memory, ``dx_plan``, against
the W^T of ``dx_weight``) and ``ln_linear_wgrad`` (dW = dY'^T A and db,
per-batch partials summed here).

Activations round to the input dtype where the JAX package's fused TPU
kernels round them: the (x + row) sum, the normalised input, the projection
before a residual add and the output.

A CUDA tensor launches the kernel (bf16 only: the fp32 model takes the
composed path, ``models/cores/vit.py``); a CPU tensor takes the plain
version (bf16 or float32). Any K runs on the card, the LayerNorm's up to
``MAX_LN_K`` (the kernels hold whole rows: 64 x K bf16 forward, fp32
backward). ``ln_linear.launches`` (and ``ln_linear_bwd``'s,
``ln_linear_wgrad``'s) counts kernel launches.
"""

from __future__ import annotations

import typing as t

import torch
import torch.nn.functional as F

from v1t_tpu_torch import _build
from v1t_tpu_torch.ops.dropout import Dropout, apply_dropout

Tensor = torch.Tensor
MAX_LN_K = 640  # a LayerNorm's width on the card: whole rows in shared memory


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


def merge_heads(y: Tensor, head_dim: int) -> Tensor:
    """(S, B, H, N, DP) -> (B, N, S*H*D): the inverse of ``_split_heads``."""
    s, b, h, n, _ = y.shape
    return y[..., :head_dim].permute(1, 3, 0, 2, 4).reshape(b, n, s * h * head_dim)


def drop_args(drop: t.Optional[Dropout]) -> tuple:
    """(seed, site, threshold, scale) for a kernel; threshold 0 = off."""
    if drop is None or not drop.active:
        return 0, 0, 0, 1.0
    return drop.seed, drop.site, drop.threshold, drop.scale


def ln_linear_plain(
    x: Tensor, w: Tensor, *, gamma: t.Optional[Tensor] = None,
    beta: t.Optional[Tensor] = None, pro_row: t.Optional[Tensor] = None,
    bias: t.Optional[Tensor] = None, gelu: bool = False,
    residual: t.Optional[Tensor] = None, res_row: t.Optional[Tensor] = None,
    heads: t.Optional[t.Tuple[int, int]] = None,
    drop: t.Optional[Dropout] = None, save_pre: bool = False,
) -> t.Union[Tensor, t.Tuple[Tensor, Tensor]]:
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
    pre = y.to(dt) if save_pre else None
    if gelu:
        y = F.gelu(y)
    if drop is not None and drop.active:
        y = apply_dropout(y.reshape(-1, y.shape[-1]), drop).reshape(y.shape)
    if residual is not None:
        r = residual.float()
        if res_row is not None:
            r = (r + res_row.float()[:, None, :]).to(dt).float()
        y = y.to(dt).float() + r
    y = y.to(dt)
    y = y if heads is None else _split_heads(y, heads)
    return (y, pre) if save_pre else y


def ln_linear(
    x: Tensor, w: Tensor, *, gamma: t.Optional[Tensor] = None,
    beta: t.Optional[Tensor] = None, pro_row: t.Optional[Tensor] = None,
    bias: t.Optional[Tensor] = None, gelu: bool = False,
    residual: t.Optional[Tensor] = None, res_row: t.Optional[Tensor] = None,
    heads: t.Optional[t.Tuple[int, int]] = None,
    drop: t.Optional[Dropout] = None, save_pre: bool = False,
) -> t.Union[Tensor, t.Tuple[Tensor, Tensor]]:
    """x (B, N, K), w (Nout, K) -> (B, N, Nout), or with ``heads=(H, D)``
    (Nout / (H*D), B, H, N, DP). gamma/beta (K,) and bias (Nout,) are
    float32; pro_row (B, K), residual (B, N, Nout) and res_row (B, Nout)
    have x's dtype. ``drop`` masks the output (element (0, b*N + n, col));
    ``save_pre`` also returns the (B, N, Nout) activation before the GELU."""
    _check(x, w, gamma, beta, pro_row, bias, residual, res_row, heads)
    if heads is not None and (save_pre or drop is not None):
        raise ValueError("ln_linear: a head-major output takes no dropout or saved activation")
    if x.device.type == "cpu":
        return ln_linear_plain(
            x, w, gamma=gamma, beta=beta, pro_row=pro_row, bias=bias,
            gelu=gelu, residual=residual, res_row=res_row, heads=heads,
            drop=drop, save_pre=save_pre,
        )
    bf, f32 = torch.bfloat16, torch.float32
    args = (x, w, gamma, beta, pro_row, bias, residual, res_row)
    _build.require_cuda("ln_linear", (bf, bf, f32, f32, bf, f32, bf, bf), *args)
    b, n, k = x.shape
    nout = w.shape[0]
    if gamma is not None and k > MAX_LN_K:
        raise ValueError(f"ln_linear: a LayerNorm of K = {k} > {MAX_LN_K} "
                         "(ROADMAP queue 3 item 1)")
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
    pre = torch.empty((b, n, nout), dtype=bf, device=x.device) if save_pre else None
    args = (x, w_pad, *args[2:])
    rc = _build.library().v1t_ln_linear(
        *(_build.ptr(a) for a in args), y.data_ptr(), _build.ptr(pre),
        b * n, nout, k, kp, n, int(gelu), num_heads, head_dim, head_pad,
        *drop_args(drop), _build.stream_of(x),
    )
    _build.check_launch("ln_linear", rc)
    ln_linear.launches += 1
    return (y, pre) if save_pre else y


ln_linear.launches = 0


def _dy_rows(dy: Tensor, heads) -> t.Tuple[int, int, int]:
    """(B, N, Nout) of a cotangent given row-major or head-major."""
    if heads is None:
        if dy.ndim != 3:
            raise ValueError(f"ln_linear_bwd: dy {tuple(dy.shape)} is not (B, N, Nout)")
        return tuple(dy.shape)
    num_heads, head_dim = heads
    if dy.ndim != 5 or dy.shape[2] != num_heads or dy.shape[4] != padded_head_dim(head_dim):
        raise ValueError(f"ln_linear_bwd: dy {tuple(dy.shape)} is not head-major for {heads}")
    s, b, _, n, _ = dy.shape
    return b, n, s * num_heads * head_dim


def _masked_dy(dy: Tensor, heads, drop: t.Optional[Dropout]) -> Tensor:
    """dY' = bf16(keep * dy / (1 - rate)), row-major (B, N, Nout), as the
    kernels gather it."""
    if heads is not None:
        dy = merge_heads(dy, heads[1])
    if drop is None or not drop.active:
        return dy
    return apply_dropout(dy.reshape(-1, dy.shape[-1]), drop).reshape(dy.shape)


def dx_weight(w: Tensor, heads=None) -> Tensor:
    """W^T (K, NS) over the stored columns of the cotangent ``ln_linear_bwd``
    reads: (Nout, K) w transposed and zero-padded at the end to a multiple of
    32 for a row-major dy, or each head's D columns zero-padded to
    ``padded_head_dim(D)`` for a head-major one, so that the kernel walks
    its (S, B, H, N, DP) planes as they lie (NS = S * H * DP)."""
    nout, k = w.shape
    if heads is None:
        return F.pad(w.t(), (0, -(-nout // 32) * 32 - nout)).contiguous()
    head_dim = heads[1]
    wt = w.t().reshape(k, nout // head_dim, head_dim)
    return F.pad(wt, (0, padded_head_dim(head_dim) - head_dim)).reshape(k, -1).contiguous()


class DxPlan(t.NamedTuple):
    rows: int  # rows a block: 128 or 64
    stages: int  # depth of the copy ring
    resident: bool  # the block's dY' rows stay in shared memory for every output tile
    k_tiles: int  # output tiles of DX_TILE columns
    smem: int  # dynamic shared memory a block, bytes

    @property
    def dy_reads(self) -> int:
        """How many times each dY' element is read from device memory."""
        return 1 if self.resident else self.k_tiles


DX_TILE, DX_CHUNK, DX_MAX_SMEM = 160, 32, 232448


def dx_plan(k: int, ns: int, aligned: bool, ln: bool) -> t.Optional[DxPlan]:
    """The launch ``csrc/ln_linear_bwd.cu`` ``dx_plan`` picks for a K-wide
    dX over NS stored reduction columns, dY rows 16-byte aligned or not,
    with the LayerNorm epilogue or not (None: no launch fits). A block owns
    a 160-column output tile; its dY' rows stay in shared memory across the
    tiles when they fit (resident), else dY streams once per tile; 128 rows
    before 64; of the ring depths 4, 3, 2 the deepest that leaves room for
    two blocks a SM, else the deepest that fits. The products go through an
    fp32 tile; the LayerNorm's fp32 rows reuse the ring when K fits one
    tile."""
    k_tiles = -(-k // DX_TILE)
    ld = DX_CHUNK + 8
    for resident in ((True, False) if k_tiles > 1 else (False,)):
        for rows in (128, 64):
            for limit in (DX_MAX_SMEM // 2 - 1024, DX_MAX_SMEM):
                for stages in (4, 3, 2):
                    w = stages * DX_TILE * ld * 2
                    a = rows * (ns + 8) * 2 if resident else (stages if aligned else 2) * rows * ld * 2
                    ring = w + a + (0 if aligned else stages * rows * ld * 2)
                    e = (rows * (k_tiles * DX_TILE + 4) * 4 + rows * 16 if ln
                         else rows * (DX_TILE + 4) * 4)
                    e_off = 0 if ln and k_tiles == 1 and e <= ring else ring
                    smem = max(ring, e_off + e)
                    if smem <= limit:
                        return DxPlan(rows, stages, resident, k_tiles, smem)
    return None


def gelu_grad(x: Tensor) -> Tensor:
    """d/dx of the exact-erf GELU, in float32."""
    x = x.float()
    return 0.5 * (1.0 + torch.erf(x * 0.7071067811865476)) + x * torch.exp(
        -0.5 * x * x) * 0.3989422804014327


def ln_linear_bwd_plain(
    dy: Tensor, w: Tensor, *, heads=None, drop: t.Optional[Dropout] = None,
    pre: t.Optional[Tensor] = None, pre_drop: t.Optional[Dropout] = None,
    x: t.Optional[Tensor] = None, pro_row: t.Optional[Tensor] = None,
    gamma: t.Optional[Tensor] = None, beta: t.Optional[Tensor] = None,
    dres: t.Optional[Tensor] = None,
):
    """The plain PyTorch version of ``ln_linear_bwd`` (any device)."""
    dt = w.dtype
    acc = _masked_dy(dy, heads, drop).float() @ w.float()  # (B, N, K)
    if x is None:
        if pre is not None:
            if pre_drop is not None and pre_drop.active:
                acc = apply_dropout(acc.reshape(-1, acc.shape[-1]), pre_drop).reshape(acc.shape)
            acc = acc * gelu_grad(pre)
        return acc.to(dt)
    z = x.float()
    if pro_row is not None:
        z = (z + pro_row.float()[:, None, :]).to(dt).float()
    mean = z.mean(-1, keepdim=True)
    rstd = torch.rsqrt(((z - mean) ** 2).mean(-1, keepdim=True) + 1e-5)
    xhat = (z - mean) * rstd
    dxhat = acc * gamma
    dz = rstd * (dxhat - dxhat.mean(-1, keepdim=True)
                 - xhat * (dxhat * xhat).mean(-1, keepdim=True))
    if dres is not None:
        dz = dz + dres.float()
    ln_out = (xhat * gamma + beta).to(dt)
    dgamma = (acc * xhat).sum((0, 1))
    dbeta = acc.sum((0, 1))
    dbrow = dz.sum(1) if pro_row is not None else None
    return dz.to(dt), ln_out, dgamma, dbeta, dbrow


def ln_linear_bwd(
    dy: Tensor, w: Tensor, *, heads=None, drop: t.Optional[Dropout] = None,
    pre: t.Optional[Tensor] = None, pre_drop: t.Optional[Dropout] = None,
    x: t.Optional[Tensor] = None, pro_row: t.Optional[Tensor] = None,
    gamma: t.Optional[Tensor] = None, beta: t.Optional[Tensor] = None,
    dres: t.Optional[Tensor] = None,
):
    """The dX half of ``ln_linear``'s backward: dX = dY' w for dy (B, N,
    Nout) (head-major (S, B, H, N, DP) with ``heads``), dY' = dy under the
    keep mask ``drop``, and w (Nout, K).

    Without ``x``: returns dX (B, N, K) in w's dtype; with ``pre`` (fc1's
    pre-GELU activation, (B, N, K)) it returns fc1's dY' instead:
    keep(pre_drop) * dX * GELU'(pre). With ``x`` (and gamma/beta, the
    forward's LayerNorm; pro_row its row bias; dres the residual's
    cotangent): returns (dz (B, N, K), the recomputed LayerNorm output
    (B, N, K), dgamma (K,), dbeta (K,), dbrow (B, K) or None), the last
    three float32."""
    b, n, nout = _dy_rows(dy, heads)
    k = w.shape[1]
    if w.ndim != 2 or w.shape[0] != nout:
        raise ValueError(f"ln_linear_bwd: w {tuple(w.shape)} does not match {nout} outputs")
    if x is not None and (gamma is None or beta is None or tuple(x.shape) != (b, n, k)):
        raise ValueError("ln_linear_bwd: the LayerNorm backward needs x (B, N, K), gamma, beta")
    if pre is not None and (x is not None or tuple(pre.shape) != (b, n, k)):
        raise ValueError("ln_linear_bwd: pre is fc1's (B, N, K) activation, without x")
    kwargs = dict(heads=heads, drop=drop, pre=pre, pre_drop=pre_drop, x=x, pro_row=pro_row,
                  gamma=gamma, beta=beta, dres=dres)
    if dy.device.type == "cpu":
        return ln_linear_bwd_plain(dy, w, **kwargs)
    bf, f32 = torch.bfloat16, torch.float32
    _build.require_cuda("ln_linear_bwd", (bf, bf, bf, bf, bf, f32, f32, bf),
                        dy, w, pre, x, pro_row, gamma, beta, dres)
    if x is not None and k > MAX_LN_K:
        raise ValueError(f"ln_linear_bwd: a LayerNorm of K = {k} > {MAX_LN_K} "
                         "(ROADMAP queue 3 item 1)")
    if drop is not None and pre_drop is not None and drop.active and pre_drop.active and (
            drop.rate != pre_drop.rate or drop.seed != pre_drop.seed):
        raise ValueError("ln_linear_bwd: the two masks share one rate and seed")
    if heads is not None and dy.data_ptr() % 16:
        raise ValueError("ln_linear_bwd: a head-major dy starts 16-byte aligned")
    wt = dx_weight(w, heads)  # (K, NS)
    num_heads, head_dim = heads or (0, 0)
    head_pad = padded_head_dim(head_dim) if heads else 0
    dx = torch.empty((b, n, k), dtype=bf, device=dy.device)
    ln_out = dgamma = dbeta = dbrow = None
    if x is not None:
        ln_out = torch.empty_like(dx)
        dgamma = torch.zeros(k, dtype=f32, device=dy.device)
        dbeta = torch.zeros(k, dtype=f32, device=dy.device)
        dbrow = torch.zeros((b, k), dtype=f32, device=dy.device) if pro_row is not None else None
    seed, site_in, thr_in, scale = drop_args(drop)
    _, site_out, thr_out, _ = drop_args(pre_drop)
    if thr_out and not thr_in:  # the two masks share one seed and scale
        seed, _, _, scale = drop_args(pre_drop)
    rc = _build.library().v1t_ln_linear_dx(
        dy.data_ptr(), dx.data_ptr(), wt.data_ptr(), b * n, nout, k, wt.shape[1], n, num_heads,
        head_dim, head_pad, seed, site_in, thr_in, _build.ptr(pre), site_out,
        thr_out, scale, _build.ptr(x), _build.ptr(pro_row),
        _build.ptr(gamma), _build.ptr(beta), _build.ptr(dres), _build.ptr(ln_out),
        _build.ptr(dgamma), _build.ptr(dbeta), _build.ptr(dbrow), _build.stream_of(dy),
    )
    _build.check_launch("ln_linear_bwd", rc)
    ln_linear_bwd.launches += 1
    return dx if x is None else (dx, ln_out, dgamma, dbeta, dbrow)


ln_linear_bwd.launches = 0


def ln_linear_wgrad_plain(dy: Tensor, a: Tensor, *, heads=None,
                          drop: t.Optional[Dropout] = None, bias: bool = False):
    """The plain PyTorch version of ``ln_linear_wgrad`` (any device)."""
    d = _masked_dy(dy, heads, drop).float().reshape(-1, _dy_rows(dy, heads)[2])
    dw = d.t() @ a.float().reshape(-1, a.shape[-1])
    return dw, (d.sum(0) if bias else None)


def ln_linear_wgrad(dy: Tensor, a: Tensor, *, heads=None, drop: t.Optional[Dropout] = None,
                    bias: bool = False):
    """The weight-gradient half of ``ln_linear``'s backward: dW = dY'^T a
    (Nout, K) and, with ``bias``, db = colsum(dY') (Nout,), both float32,
    for dy (B, N, Nout) (head-major with ``heads``) under the keep mask
    ``drop`` and the layer's input a (B, N, K). The kernel writes per-batch
    partials; they are summed here."""
    b, n, nout = _dy_rows(dy, heads)
    if a.ndim != 3 or tuple(a.shape[:2]) != (b, n):
        raise ValueError(f"ln_linear_wgrad: a {tuple(a.shape)} does not match dy's (B, N)")
    if dy.device.type == "cpu":
        return ln_linear_wgrad_plain(dy, a, heads=heads, drop=drop, bias=bias)
    bf, f32 = torch.bfloat16, torch.float32
    _build.require_cuda("ln_linear_wgrad", (bf, bf), dy, a)
    if b > 65535:
        raise ValueError("ln_linear_wgrad: batch exceeds the launch grid")
    k = a.shape[2]
    num_heads, head_dim = heads or (0, 0)
    head_pad = padded_head_dim(head_dim) if heads else 0
    dw_part = torch.empty((b, nout, k), dtype=f32, device=dy.device)
    db_part = torch.empty((b, nout), dtype=f32, device=dy.device) if bias else None
    rc = _build.library().v1t_ln_linear_wgrad(
        dy.data_ptr(), a.data_ptr(), dw_part.data_ptr(), _build.ptr(db_part), b * n, nout, k,
        n, num_heads, head_dim, head_pad, *drop_args(drop), _build.stream_of(dy),
    )
    _build.check_launch("ln_linear_wgrad", rc)
    ln_linear_wgrad.launches += 1
    return dw_part.sum(0), (db_part.sum(0) if bias else None)


ln_linear_wgrad.launches = 0
