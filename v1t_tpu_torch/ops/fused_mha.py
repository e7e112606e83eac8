"""The pre-LN attention sublayer of the V1T core on CUDA kernels, forward and
backward.

The JAX package computes the whole sublayer in one Pallas kernel per
direction (``v1t_tpu/ops/fused_mha.py`` ``fused_mha`` ->
``_mha_fwd_kernel_dt2`` / ``_mha_bwd_kernel_dt2``): +bias_row, LayerNorm,
bias-free QKV, per-head scale, key-pad and LSA masks, softmax, probability
dropout, head concat, output projection + bias, output dropout, optional
residual. Here the forward is three launches of two hand-written kernels:

    ln_linear (+bias_row, LayerNorm, QKV; head-major out)  ->  attention
    ->  ln_linear (output projection + bias, dropout [+ x + bias_row])

and the backward, behind ``torch.autograd.Function`` with the JAX
``custom_vjp``'s boundary (inputs x, bias_row, gamma, beta, wqkv, wp, bp,
scale) and cotangents (per-batch fp32 partials summed, then cast to the
weights' dtype; dgamma, dbeta and dscale float32), is

    ln_linear_bwd (out-proj dX) + ln_linear_wgrad (dWp, dbp)
    ->  attention_bwd (dq, dk, dv, dscale; csrc/attention_bwd.cu: a prep,
        the bf16 one-pass kernel that flash_bwd also runs, a convert)
    ->  ln_linear_bwd (QKV dX + LayerNorm backward: dx, dgamma, dbeta,
        dbias_row) + ln_linear_wgrad (dWqkv).

The attention's training forward saves its log2-domain LSE and the backward
recomputes P from it; both dropout masks are regenerated from (seed, site)
(``ops/dropout.py``), never stored. ``attention`` and ``attention_bwd``
(``csrc/attention.cu``, ``csrc/attention_bwd.cu``) are defined below with
their plain versions; ``ln_linear`` and its backward live in
``ops/ln_linear.py``. ``attention.cu`` runs the bf16 flash forward's wgmma
kernel in its log2 mode (q scaled in shared memory, ``attention_plan``) at
padded head widths up to 160; wider heads (192-256: the sweep's emb_dim
reaches 256) run on the flash kernels of ``ops/flash_attention.py`` as
they are: q is scaled and rounded before them (as the JAX flash path
does), the LSE converts between natural log and log2, dq = scale dq_s and
dscale = sum q . dq_s; the plain versions compose the flash plain versions
the same way.

Every route writes o as (B, N, ``o_width``): the H*D columns rounded up to
a multiple of 8, the pad columns zero, so that its rows are 16-byte
aligned and the output projection streams them by TMA (620 -> 624 at the
flagship). The out-projection takes ``wp`` zero-padded to that width at
the call (exact zeros), its weight gradient the padded o (dWp sliced back
to H*D columns), and the attention backward reads o at that stride.
"""

from __future__ import annotations

import typing as t

import torch

from v1t_tpu_torch import _build
from v1t_tpu_torch.ops.dropout import Dropout, keep_mask
from v1t_tpu_torch.ops.flash_attention import (
    MASKED, MAX_HEAD_PAD, BwdPlan, FwdPlan, bwd_plan, flash_bwd, flash_bwd_plain, flash_fwd,
    flash_fwd_plain, fwd_plan,
)
from v1t_tpu_torch.ops.ln_linear import (
    drop_args, ln_linear, ln_linear_bwd, ln_linear_bwd_plain, ln_linear_plain,
    ln_linear_wgrad, ln_linear_wgrad_plain, padded_head_dim,
)

Tensor = torch.Tensor
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453
KERNEL_HEAD_PADS = (32, 64, 96, 128, 160)  # padded head widths the kernel is built for


def o_width(num_heads: int, head_dim: int) -> int:
    """Columns of attention's output rows: H*D rounded up to a multiple of
    8, so that bf16 rows are 16-byte aligned."""
    return -(-num_heads * head_dim // 8) * 8


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


def _scaled_scores(qkv: Tensor, scale: Tensor, head_dim: int, use_lsa: bool):
    """q rounded after the scale (log2(e) folded in), the (B, H, N, N)
    float32 scores in log2 units (the LSA diagonal at the kernels' finite
    masked score) and q, k, v in float32, as the kernels compute them."""
    dt = qkv.dtype
    n = qkv.shape[3]
    q, k, v = qkv[..., :head_dim].float()  # (B, H, N, D) each
    q_s = (q * (scale * LOG2E).view(1, -1, 1, 1)).to(dt).float()
    s = q_s @ k.transpose(-1, -2)
    if use_lsa:
        eye = torch.eye(n, dtype=torch.bool, device=qkv.device)
        s = s.masked_fill(eye, MASKED)
    return s, q, q_s, k, v


def _head_width_check(name: str, dp: int, head_dim: int) -> None:
    if dp != padded_head_dim(head_dim) or dp > MAX_HEAD_PAD:
        raise ValueError(f"{name}: head width {head_dim} padded to {dp} is not supported "
                         f"(padded widths up to {MAX_HEAD_PAD}; ROADMAP queue 3 item 1)")


def _flash_operands(qkv: Tensor, scale: Tensor):
    """(B*H, N, DP) planes of q scaled (natural units) and rounded to qkv's
    dtype, and of k and v, for the flash kernels."""
    _, b, h, n, dp = qkv.shape
    q_s = (qkv[0] * scale.to(qkv.dtype).view(1, h, 1, 1)).reshape(b * h, n, dp)
    return q_s, qkv[1].reshape(b * h, n, dp), qkv[2].reshape(b * h, n, dp)


def _heads_view(y: Tensor, num_heads: int, head_dim: int) -> Tensor:
    """The (B, N, H, D) view of the first H*D columns of (B, N, width) rows."""
    return y[..., :num_heads * head_dim].unflatten(-1, (num_heads, head_dim))


def _attention_flash(fwd, qkv, scale, head_dim, use_lsa, drop, with_lse):
    """``attention`` for padded head widths past attention.cu's, on the flash
    forward ``fwd`` (the kernel or its plain version), written into o's
    aligned rows; the LSE in log2."""
    _, b, h, n, _ = qkv.shape
    o = torch.empty((b, n, o_width(h, head_dim)), dtype=qkv.dtype, device=qkv.device)
    if o.shape[-1] != h * head_dim:
        o[..., h * head_dim:].zero_()
    res = fwd(*_flash_operands(qkv, scale), head_dim, h, use_lsa=use_lsa, drop=drop,
              with_lse=with_lse, out=_heads_view(o, h, head_dim))
    return (o, res[1].view(b, h, n) * LOG2E) if with_lse else o


def _attention_bwd_flash(bwd, qkv, o, do, lse, scale, head_dim, use_lsa, drop):
    """``attention_bwd`` on the flash backward ``bwd`` (the kernel or its
    plain version): dq = scale dq_s, dscale = sum q . dq_s."""
    _, b, h, n, dp = qkv.shape
    dqkv = torch.empty_like(qkv)
    q_s, k, v = _flash_operands(qkv, scale)
    if do.shape[-1] != o.shape[-1]:  # dO at o's aligned stride: one layout for both
        do = torch.nn.functional.pad(do, (0, o.shape[-1] - do.shape[-1]))
    bwd(q_s, k, v, _heads_view(o, h, head_dim), _heads_view(do, h, head_dim),
        (lse * LN2).view(b * h, n), head_dim, h, use_lsa=use_lsa, drop=drop,
        out=tuple(dqkv[i].view(b * h, n, dp) for i in range(3)))
    dscale = (qkv[0].float() * dqkv[0].float()).sum((0, 2, 3))
    dqkv[0].mul_(scale.to(qkv.dtype).view(1, h, 1, 1))
    return dqkv, dscale


def _keep(drop: Dropout, b: int, h: int, n: int, device) -> Tensor:
    """The probabilities' keep mask, (B, H, N queries, N keys)."""
    return keep_mask(drop, b * h, n, n, device).view(b, h, n, n)


def attention_plain(qkv: Tensor, scale: Tensor, head_dim: int, use_lsa: bool = False,
                    drop: t.Optional[Dropout] = None, with_lse: bool = False):
    """Plain PyTorch version of the kernel: q is scaled (log2(e) folded in)
    and rounded to the input dtype, the softmax runs in base 2 in float32,
    the unnormalised probabilities (with the keep mask applied, select only)
    round to the input dtype for P.V and rows are divided by their sum
    (taken before the mask) and by the keep rate at the end, as in the
    kernel and in the TPU kernel it replaces; o in ``attention``'s aligned
    rows, pad columns zero. ``with_lse`` also returns the (B, H, N) float32
    log2-domain log-sum-exp. Past attention.cu's head widths, the flash
    plain version, as the kernel path takes the flash kernels there."""
    if qkv.shape[-1] not in KERNEL_HEAD_PADS:
        return _attention_flash(flash_fwd_plain, qkv, scale, head_dim, use_lsa, drop, with_lse)
    dt = qkv.dtype
    _, b, h, n, _ = qkv.shape
    s, _, _, _, v = _scaled_scores(qkv, scale, head_dim, use_lsa)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp2(s - m)
    l = p.sum(dim=-1, keepdim=True)
    inv = 1.0 / l
    if drop is not None and drop.active:
        p = p.masked_fill(~_keep(drop, b, h, n, qkv.device), 0.0)
        inv = inv * drop.scale
    o = (p.to(dt).float() @ v) * inv
    o = o.permute(0, 2, 1, 3).reshape(b, n, h * head_dim).to(dt)
    o = torch.nn.functional.pad(o, (0, o_width(h, head_dim) - h * head_dim))
    if not with_lse:
        return o
    return o, (m + torch.log2(l.clamp_min(1e-37)))[..., 0]


def attention(qkv: Tensor, scale: Tensor, head_dim: int, use_lsa: bool = False,
              drop: t.Optional[Dropout] = None, with_lse: bool = False):
    """qkv (3, B, H, N, DP) head-major as ``ln_linear(..., heads=(H, D))``
    writes it (rows zero-padded from D to DP), scale (H,) float32 ->
    (B, N, ``o_width(H, D)``), the heads' H*D columns then zeros:
    softmax(scale_h q.k) v per head (LSA: diagonal masked).
    Training: ``drop`` masks the probabilities (element (b*H + h, query,
    key)); ``with_lse`` also returns the (B, H, N) log2-domain LSE that
    ``attention_bwd`` reads."""
    _check(qkv, scale, head_dim)
    if qkv.device.type == "cpu":
        return attention_plain(qkv, scale, head_dim, use_lsa, drop, with_lse)
    _build.require_cuda("attention", (torch.bfloat16, torch.float32), qkv, scale)
    _, b, h, n, dp = qkv.shape
    _head_width_check("attention", dp, head_dim)
    if dp not in KERNEL_HEAD_PADS:  # wider heads: the flash kernels
        return _attention_flash(flash_fwd, qkv, scale, head_dim, use_lsa, drop, with_lse)
    attention_plan(b, h, n, dp)  # raises past the launch grid
    out = torch.empty((b, n, o_width(h, head_dim)), dtype=qkv.dtype, device=qkv.device)
    train = with_lse or (drop is not None and drop.active)
    lse = torch.empty((b, h, n), dtype=torch.float32, device=qkv.device) if train else None
    rc = _build.library().v1t_attention(
        qkv.data_ptr(), scale.data_ptr(), out.data_ptr(), _build.ptr(lse),
        b, n, h, head_dim, dp, out.shape[-1], int(use_lsa), *drop_args(drop),
        _build.stream_of(qkv),
    )
    _build.check_launch("attention", rc)
    attention.launches += 1
    return (out, lse) if with_lse else out


attention.launches = 0


class AttentionPlan(t.NamedTuple):
    items: int  # (query tile of 128 rows, plane) items: ceil(N / 128) x B*H
    blocks: int  # persistent blocks, one a SM, each walking items b, b + blocks, ...
    stages: int  # depth of the K / V ring
    tiles: FwdPlan  # the bf16 flash forward's tiles and shared memory a block


H100_SMS = 132  # streaming multiprocessors of an H100 SXM


def attention_plan(b: int, h: int, n: int, dp: int) -> AttentionPlan:
    """The launch ``attention`` makes on the card for qkv (3, B, H, N, DP) at
    attention.cu's padded head widths: the bf16 flash forward's wgmma
    kernel (``fwd_plan``: items of 128 queries on two consumer warpgroups,
    key tiles of 64, a TMA ring 3 deep), persistent: min(items, SMs)
    blocks on an H100. Wider heads run ``flash_fwd``."""
    if dp not in KERNEL_HEAD_PADS:
        raise ValueError(f"attention: padded head width {dp} runs on flash_fwd")
    if b * h > 65535:
        raise ValueError("attention: batch x heads exceeds the launch grid")
    tiles = fwd_plan(torch.bfloat16, dp)
    items = -(-n // tiles.queries) * b * h
    return AttentionPlan(items, min(items, H100_SMS), tiles.stages, tiles)


def attention_bwd_plain(qkv: Tensor, o: Tensor, do: Tensor, lse: Tensor, scale: Tensor,
                        head_dim: int, use_lsa: bool = False,
                        drop: t.Optional[Dropout] = None) -> t.Tuple[Tensor, Tensor]:
    """Plain PyTorch version of ``attention_bwd``, with the kernels' rounding
    points: dS and the masked P round to the input dtype before their
    products; dq, dk, dv round at the end. Past attention.cu's head widths,
    the flash plain version."""
    if qkv.shape[-1] not in KERNEL_HEAD_PADS:
        return _attention_bwd_flash(flash_bwd_plain, qkv, o, do, lse, scale, head_dim,
                                    use_lsa, drop)
    dt = qkv.dtype
    _, b, h, n, dp = qkv.shape
    s, q, q_s, k, v = _scaled_scores(qkv, scale, head_dim, use_lsa)
    p = torch.exp2(s - lse[..., None])
    heads = lambda y: _heads_view(y, h, head_dim).float().permute(0, 2, 1, 3)  # noqa: E731
    do_h, o_h = heads(do), heads(o)
    delta = (do_h * o_h).sum(-1, keepdim=True)
    dp_ = do_h @ v.transpose(-1, -2)
    p_kept = p
    if drop is not None and drop.active:
        keep = _keep(drop, b, h, n, qkv.device)
        dp_ = torch.where(keep, dp_ * drop.scale, 0.0)
        p_kept = p.masked_fill(~keep, 0.0)
    ds = (p * (dp_ - delta)).to(dt).float()
    dq_acc = ds @ k
    dq = dq_acc * scale.view(1, -1, 1, 1)
    dk = (ds.transpose(-1, -2) @ q_s) * LN2
    dv = p_kept.to(dt).float().transpose(-1, -2) @ do_h
    if drop is not None and drop.active:
        dv = dv * drop.scale
    dscale = (q * dq_acc).sum((0, 2, 3))
    dqkv = torch.stack([dq, dk, dv]).to(dt)
    return torch.nn.functional.pad(dqkv, (0, dp - head_dim)).contiguous(), dscale


def attention_bwd_plan(b: int, h: int, n: int, dp: int) -> BwdPlan:
    """Which kernels ``attention_bwd`` launches on the card for qkv (3, B, H,
    N, DP) at attention.cu's padded head widths, and the float32 dq
    accumulator it allocates: its prep (q_s, dO head-major, delta), the
    one-pass kernel that ``flash_bwd`` also runs (here with log2-domain
    scores and LSE, dk = ln2 dS^T q_s), which adds dS k into a (B*H, N, DP)
    float32 buffer, and its convert (dq = scale_h acc, dscale = sum q . acc).
    Wider heads run ``flash_bwd`` (``bwd_plan``)."""
    if dp not in KERNEL_HEAD_PADS:
        raise ValueError(f"attention_bwd: padded head width {dp} runs on flash_bwd")
    if b * h > 65535:
        raise ValueError("attention_bwd: batch x heads exceeds the launch grid")
    return bwd_plan(torch.bfloat16, b * h, n, dp)._replace(
        kernels=("prep", "one_pass", "convert"))


def attention_bwd(qkv: Tensor, o: Tensor, do: Tensor, lse: Tensor, scale: Tensor,
                  head_dim: int, use_lsa: bool = False,
                  drop: t.Optional[Dropout] = None) -> t.Tuple[Tensor, Tensor]:
    """The backward of ``attention``'s training forward: qkv (3, B, H, N, DP)
    and scale as the forward took them, its output o (B, N, ``o_width(H,
    D)``) and the cotangent do of its H*D columns (B, N, H*D), its LSE
    (B, H, N), its keep mask ``drop`` (regenerated) ->
    (dqkv (3, B, H, N, DP) zero past D, in qkv's dtype; dscale (H,)
    float32, the per-batch partials summed)."""
    _check(qkv, scale, head_dim)
    _, b, h, n, dp = qkv.shape
    if tuple(o.shape) != (b, n, o_width(h, head_dim)) or tuple(do.shape) != (b, n, h * head_dim):
        raise ValueError(f"attention_bwd: o {tuple(o.shape)} / do {tuple(do.shape)} do not "
                         f"match qkv {tuple(qkv.shape)}")
    if tuple(lse.shape) != (b, h, n) or lse.dtype != torch.float32:
        raise ValueError(f"attention_bwd: lse is {tuple(lse.shape)} {lse.dtype}")
    if qkv.device.type == "cpu":
        return attention_bwd_plain(qkv, o, do, lse, scale, head_dim, use_lsa, drop)
    bf, f32 = torch.bfloat16, torch.float32
    _build.require_cuda("attention_bwd", (bf, bf, bf, f32, f32), qkv, o, do, lse, scale)
    _head_width_check("attention_bwd", dp, head_dim)
    if dp not in KERNEL_HEAD_PADS:  # wider heads: the flash kernels
        return _attention_bwd_flash(flash_bwd, qkv, o, do, lse, scale, head_dim, use_lsa, drop)
    plan = attention_bwd_plan(b, h, n, dp)
    dqkv = torch.empty_like(qkv)
    dscale = torch.zeros((b, h), dtype=f32, device=qkv.device)
    qs = torch.empty((b, h, n, dp), dtype=bf, device=qkv.device)  # scratch: scaled q
    dohm = torch.empty_like(qs)  # scratch: dO head-major
    delta = torch.empty((b, h, n), dtype=f32, device=qkv.device)
    dq_acc = torch.empty(plan.dq_acc, dtype=f32, device=qkv.device)  # scratch: dS k
    rc = _build.library().v1t_attention_bwd(
        qkv.data_ptr(), o.data_ptr(), do.data_ptr(), lse.data_ptr(), scale.data_ptr(),
        dqkv.data_ptr(), dscale.data_ptr(), qs.data_ptr(), dohm.data_ptr(), delta.data_ptr(),
        dq_acc.data_ptr(), b, n, h, head_dim, dp, o.shape[-1], int(use_lsa), *drop_args(drop),
        _build.stream_of(qkv),
    )
    _build.check_launch("attention_bwd", rc)
    attention_bwd.launches += 1
    return dqkv, dscale.sum(0)


attention_bwd.launches = 0


class _Cfg(t.NamedTuple):
    num_heads: int
    use_lsa: bool
    fold_residual: bool
    drop_p: t.Optional[Dropout]  # attention probabilities
    drop_o: t.Optional[Dropout]  # the sublayer's output
    plain: bool


def _forward(cfg: _Cfg, x, bias_row, gamma, beta, wqkv, wp, bp, scale, train: bool):
    lin = ln_linear_plain if cfg.plain else ln_linear
    attn = attention_plain if cfg.plain else attention
    head_dim = wqkv.shape[0] // (3 * cfg.num_heads)
    qkv = lin(x, wqkv, gamma=gamma, beta=beta, pro_row=bias_row,
              heads=(cfg.num_heads, head_dim))
    o = attn(qkv, scale, head_dim, cfg.use_lsa, drop=cfg.drop_p, with_lse=train)
    o, lse = o if train else (o, None)
    if o.shape[-1] != wp.shape[1]:  # o's aligned rows: wp's zero columns add exact zeros
        wp = torch.nn.functional.pad(wp, (0, o.shape[-1] - wp.shape[1]))
    out = lin(
        o, wp, bias=bp, drop=cfg.drop_o,
        residual=x if cfg.fold_residual else None,
        res_row=bias_row if cfg.fold_residual else None,
    )
    return out, qkv, o, lse


class _FusedMHA(torch.autograd.Function):
    """The sublayer with the JAX ``custom_vjp``'s forward/backward boundary."""

    @staticmethod
    def forward(ctx, x, bias_row, gamma, beta, wqkv, wp, bp, scale, cfg: _Cfg):
        out, qkv, o, lse = _forward(cfg, x, bias_row, gamma, beta, wqkv, wp, bp, scale, True)
        ctx.cfg = cfg
        ctx.save_for_backward(x, bias_row, gamma, beta, wqkv, wp, scale, qkv, o, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        cfg = ctx.cfg
        x, bias_row, gamma, beta, wqkv, wp, scale, qkv, o, lse = ctx.saved_tensors
        dt = x.dtype
        bwd = ln_linear_bwd_plain if cfg.plain else ln_linear_bwd
        wgrad = ln_linear_wgrad_plain if cfg.plain else ln_linear_wgrad
        attn_bwd = attention_bwd_plain if cfg.plain else attention_bwd
        heads = (cfg.num_heads, wqkv.shape[0] // (3 * cfg.num_heads))
        dout = dout.to(dt).contiguous()
        # output projection: dO = mask(dout) Wp; dWp, dbp
        do = bwd(dout, wp, drop=cfg.drop_o)
        dwp, dbp = wgrad(dout, o, drop=cfg.drop_o, bias=True)
        dwp = dwp[:, :wp.shape[1]]  # o's pad columns: no weight
        dqkv, dscale = attn_bwd(qkv, o, do, lse, scale, heads[1], cfg.use_lsa, cfg.drop_p)
        # QKV projection and LayerNorm: dz (+ the residual's cotangent)
        dx, ln_out, dgamma, dbeta, dbrow = bwd(
            dqkv, wqkv, heads=heads, x=x, pro_row=bias_row, gamma=gamma, beta=beta,
            dres=dout if cfg.fold_residual else None,
        )
        dwqkv, _ = wgrad(dqkv, ln_out, heads=heads)
        return (
            dx,
            None if bias_row is None else dbrow.to(bias_row.dtype),
            dgamma, dbeta, dwqkv.to(dt), dwp.to(dt), dbp.to(dt),
            dscale, None,
        )


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
    drop_p: t.Optional[Dropout] = None,
    drop_o: t.Optional[Dropout] = None,
    plain: bool = False,
) -> Tensor:
    """The pre-LN attention sublayer.

    Args:
        x: (B, N, E) residual stream.
        gamma/beta: (E,) LayerNorm affine, float32.
        wqkv: (3*H*D, E) bias-free QKV weight in nn.Linear layout, x's dtype.
        wp: (E, H*D) output projection weight, x's dtype; bp (E,) float32.
        scale: per-head (H,) float32 scale, or one float for every head.
        bias_row: (B, E) row added to every token before the LayerNorm (the
            behavior latent); the sublayer input is z = x + bias_row.
        fold_residual: return sublayer(z) + z instead of sublayer(z).
        drop_p / drop_o: training dropout of the attention probabilities and
            of the sublayer's output (before the residual), or None.
        plain: use the kernels' plain versions on any device (the composed
            path); otherwise CUDA tensors launch the kernels.
    Returns:
        (B, N, E) in x's dtype. When autograd records, the backward runs
        on the backward kernels (or, with ``plain``, their plain versions).
    """
    if not torch.is_tensor(scale):
        scale = torch.full((num_heads,), float(scale), device=x.device)
    scale = scale.float().reshape(-1).expand(num_heads).contiguous()
    cfg = _Cfg(num_heads, use_lsa, fold_residual, drop_p, drop_o, plain)
    inputs = (x, bias_row, gamma, beta, wqkv, wp, bp, scale)
    if torch.is_grad_enabled() and any(
            v is not None and v.requires_grad for v in inputs):
        return _FusedMHA.apply(*inputs, cfg)
    return _forward(cfg, *inputs, False)[0]
