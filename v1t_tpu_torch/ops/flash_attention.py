"""Flash attention for the composed attention path: ``flash_attention`` and
its rectangular LSE form ``flash_attention_with_lse``, on the CUDA kernels
``csrc/flash_attention.cu`` (forward) and ``csrc/flash_attention_bwd.cu``
(backward), with their plain PyTorch versions.

The JAX package's ``v1t_tpu/ops/flash_attention.py`` computes softmax(q.k^T)
v blockwise in Pallas kernels (``_flash_forward`` / ``_flash_backward`` and
their whole-K, merged and transposed variants) behind ``custom_vjp``s whose
boundary is the padded (B*H, N, D) q, k, v (``_flash_core``,
``_flash_lse_core``); the per-head scale is folded into q outside, in q's
dtype, so its gradient flows through autodiff. Here the same boundary is a
``torch.autograd.Function``:

- ``flash_fwd`` / ``flash_bwd``: the kernel launches on padded (B*H, N, DP)
  tensors (DP = D rounded up to 32, rows zero-padded), bf16 or float32.
  ``o`` is written as a (B, Nq, H, D) buffer, so that the heads' concat
  before the output projection is a view (or into ``out``, such a view of
  a buffer with wider rows; the backward then takes o and dO as two views
  of one layout). The forward returns the
  natural-log LSE (B*H, Nq); the backward folds the LSE's cotangent into
  delta = rowsum(dO . o) - dlse, as the JAX backward does. ``fwd_plan``
  says which tiles the forward runs on; ``bwd_plan`` says which backward
  kernels run and on which tiles: in bf16 one wgmma pass that adds dq into
  a float32 accumulator (above ``WIDE_DP`` on blocks of 64 keys, dK and dV
  split by columns); in float32 one FFMA pass that adds dq into the output
  itself.
- ``flash_fwd_plain`` / ``flash_bwd_plain``: the same functions in PyTorch,
  with the kernels' rounding points, in chunks of query rows so that their
  memory is O(chunk x Nk): at 34,114 tokens the whole float32 score matrix
  is 4.7 GB per head. The backward recomputes P per chunk from the LSE.
  A CPU tensor takes them; ``plain=True`` selects them on any device.

Dropout: the TPU draws its keep mask from its hardware PRNG per (bh,
q-block, k-block) tile; here mask element (bh, query, key) of the site
(``ops/dropout.py``), drawn inside the kernels and by the plain versions
alike, regenerated in the backward. The row sum is taken before the mask;
kept probabilities are divided by the keep rate.

``flash_fwd.launches`` and ``flash_bwd.launches`` count kernel launches.
"""

from __future__ import annotations

import typing as t

import torch
import torch.nn.functional as F

from v1t_tpu_torch import _build
from v1t_tpu_torch.ops.dropout import Dropout, keep_mask
from v1t_tpu_torch.ops.ln_linear import drop_args, padded_head_dim

Tensor = torch.Tensor
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453
MASKED = -1e30  # the kernels' masked score (log2 units)
MAX_HEAD_PAD = 256  # padded head widths the kernels are built for: 32, 64, ..., 256
WIDE_DP = 160  # the bf16 kernels' tiles change above this padded head width
PLAIN_CHUNK_ELEMENTS = 1 << 26  # the plain versions' (B*H, chunk, Nk) float32 scores


def _check(q: Tensor, k: Tensor, v: Tensor, head_dim: int, heads: int,
           n_real_k: t.Optional[int], use_lsa: bool) -> int:
    """Validate the padded operands; returns n_real_k."""
    if q.ndim != 3 or k.ndim != 3 or k.shape != v.shape or q.shape[0] != k.shape[0] \
            or q.shape[2] != k.shape[2]:
        raise ValueError(f"flash attention: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} are not (BH, Nq, DP), (BH, Nk, DP)")
    if q.dtype not in (torch.bfloat16, torch.float32) or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"flash attention: {q.dtype} / {k.dtype} / {v.dtype}: "
                         "expected one of bf16, float32")
    bh, nq, dp = q.shape
    nk = k.shape[1]
    if dp != padded_head_dim(head_dim) or heads < 1 or bh % heads:
        raise ValueError(f"flash attention: head width {head_dim} padded to {dp}, "
                         f"{bh} planes of {heads} heads")
    n_real_k = nk if n_real_k is None else int(n_real_k)
    if not 1 <= n_real_k <= nk or (use_lsa and nq != nk):
        raise ValueError(f"flash attention: n_real_k {n_real_k} of {nk} keys, "
                         f"lsa {use_lsa} with {nq} queries")
    return n_real_k


def _chunk_rows(bh: int, nk: int) -> int:
    return max(16, PLAIN_CHUNK_ELEMENTS // (bh * nk))


def _scores(q_c: Tensor, k: Tensor, r0: int, n_real_k: int, use_lsa: bool) -> Tensor:
    """(BH, c, Nk) float32 scores in log2 units of query rows r0 .. r0 + c - 1,
    masked as the kernels mask them."""
    s = (q_c.float() @ k.float().transpose(1, 2)) * LOG2E
    c, nk = s.shape[1], s.shape[2]
    keys = torch.arange(nk, device=s.device)
    mask = (keys >= n_real_k).view(1, 1, nk)
    if use_lsa:
        rows = torch.arange(r0, r0 + c, device=s.device).view(1, c, 1)
        mask = mask | (keys.view(1, 1, nk) == rows)
    return s.masked_fill(mask, MASKED)


def _keep(drop: t.Optional[Dropout], bh: int, r0: int, c: int, nk: int, device):
    if drop is None or not drop.active:
        return None
    return keep_mask(drop, bh, c, nk, device, row0=r0)


def _out_buffer(q: Tensor, heads: int, head_dim: int) -> Tensor:
    bh, nq, _ = q.shape
    return torch.empty((bh // heads, nq, heads, head_dim), dtype=q.dtype, device=q.device)


class FwdPlan(t.NamedTuple):
    queries: int  # query rows a block
    keys: int  # keys a tile
    smem: int  # dynamic shared memory a block, bytes
    q_panels: int  # q panels a block holds
    stages: int  # depth of the K / V ring


def fwd_plan(dtype: torch.dtype, dp: int) -> FwdPlan:
    """The tiles ``csrc/flash_attention.cu`` runs the forward on at padded
    head width DP: bf16, items of 128 queries (two consumer warpgroups of
    64) against key tiles of 64 in a TMA ring 3 deep (2 at DP 256), two q
    panels up to ``WIDE_DP`` (a persistent block's item and its next) and
    one above, where K and V have barriers of their own; float32, 128 queries (8 rows a thread) up to DP 160 and 64
    (4 rows) above, so that o fits the registers, one q tile, key tiles of
    64 whose K and V take turns in a two-stage cp.async ring, every tile's
    rows padded by 4 floats and 4 more every 8 rows."""
    if dp % 32 or not 32 <= dp <= MAX_HEAD_PAD:
        raise ValueError(f"flash_attention: padded head width {dp}")
    if dtype == torch.float32:
        queries = 128 if dp <= 160 else 64

        def tile(rows):
            return rows * (dp + 4) + 4 * -(-rows // 8)

        return FwdPlan(queries, 64, (tile(queries) + 2 * tile(64) + queries * 68) * 4, 1, 2)
    wide = dp > WIDE_DP
    q_panels, stages = (1 if wide else 2), (3 if dp <= 224 else 2)
    bars = 4 + 2 * stages * (2 if wide else 1)  # q; K and V (wide: K, V apart)
    smem = 1024 + (q_panels * 128 + 2 * stages * 64) * dp * 2 + bars * 8
    return FwdPlan(128, 64, smem, q_panels, stages)


def _one_layout(*xs: Tensor) -> bool:
    """(B, Nq, H, D) views whose strides agree wherever a size is above 1
    (a size-1 dimension's stride is never used), D contiguous: one layout
    the kernels address as (batch, head, row) strides."""
    x0 = xs[0]
    return all(x.shape == x0.shape and all(
        sa == sb for sa, sb, n in zip(x.stride(), x0.stride(), x0.shape) if n > 1)
        for x in xs) and (x0.shape[3] == 1 or x0.stride(3) == 1)


def _check_out(out: Tensor, q: Tensor, heads: int, head_dim: int) -> Tensor:
    bh, nq, _ = q.shape
    if tuple(out.shape) != (bh // heads, nq, heads, head_dim) or out.dtype != q.dtype \
            or out.device != q.device or not _one_layout(out):
        raise ValueError(f"flash attention: out {tuple(out.shape)} {out.dtype} is not a "
                         f"(B, Nq, H, D) view with contiguous rows like q's")
    return out


def flash_fwd_plain(q: Tensor, k: Tensor, v: Tensor, head_dim: int, heads: int = 1, *,
                    n_real_k: t.Optional[int] = None, use_lsa: bool = False,
                    drop: t.Optional[Dropout] = None, with_lse: bool = False,
                    out: t.Optional[Tensor] = None):
    """Plain PyTorch version of ``flash_fwd``, query rows in chunks: scores in
    float32 in base 2, the unnormalised probabilities (the keep mask applied,
    select only) rounded to the input dtype for P.V, rows divided by their sum
    (taken before the mask) and by the keep rate at the end, as the kernels
    do."""
    n_real_k = _check(q, k, v, head_dim, heads, n_real_k, use_lsa)
    dt = q.dtype
    bh, nq, _ = q.shape
    nk = k.shape[1]
    o_h = torch.empty((bh, nq, head_dim), dtype=dt, device=q.device)
    lse = torch.empty((bh, nq), dtype=torch.float32, device=q.device)
    v32 = v[..., :head_dim].float()
    step = _chunk_rows(bh, nk)
    for r0 in range(0, nq, step):
        r1 = min(r0 + step, nq)
        s = _scores(q[:, r0:r1], k, r0, n_real_k, use_lsa)
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp2(s - m)
        l = p.sum(dim=-1, keepdim=True)
        inv = torch.where(l == 0.0, 1.0, 1.0 / l)
        keep = _keep(drop, bh, r0, r1 - r0, nk, q.device)
        if keep is not None:
            p = p.masked_fill(~keep, 0.0)
            inv = inv * drop.scale
        o_h[:, r0:r1] = ((p.to(dt).float() @ v32) * inv).to(dt)
        lse[:, r0:r1] = ((m + torch.log2(l.clamp_min(1e-37))) * LN2)[..., 0]
    o = o_h.view(bh // heads, heads, nq, head_dim).transpose(1, 2)
    out = o.contiguous() if out is None else _check_out(out, q, heads, head_dim).copy_(o)
    return (out, lse) if with_lse else out


def flash_fwd(q: Tensor, k: Tensor, v: Tensor, head_dim: int, heads: int = 1, *,
              n_real_k: t.Optional[int] = None, use_lsa: bool = False,
              drop: t.Optional[Dropout] = None, with_lse: bool = False,
              out: t.Optional[Tensor] = None):
    """softmax(q.k^T) v for q (BH, Nq, DP), k and v (BH, Nk, DP) (BH = B *
    heads planes, rows zero-padded from ``head_dim`` to DP, the scale already
    in q), bf16 or float32 -> o (B, Nq, heads, head_dim) in q's dtype (into
    ``out`` when given: such a view, rows contiguous) and, with
    ``with_lse``, the (BH, Nq) float32 natural-log LSE. Keys at or past
    ``n_real_k`` are masked, with ``use_lsa`` (Nq == Nk) the diagonal too;
    ``drop`` masks the probabilities (element (bh, query, key))."""
    n_real_k = _check(q, k, v, head_dim, heads, n_real_k, use_lsa)
    kwargs = dict(n_real_k=n_real_k, use_lsa=use_lsa, drop=drop, with_lse=with_lse, out=out)
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, head_dim, heads, **kwargs)
    _build.require_cuda("flash_attention", (q.dtype,) * 3, q, k, v)
    bh, nq, dp = q.shape
    if dp > MAX_HEAD_PAD:
        raise ValueError(f"flash_attention: head width {head_dim} padded to {dp} > "
                         f"{MAX_HEAD_PAD} (ROADMAP queue 3 item 1)")
    if bh > 65535:
        raise ValueError("flash_attention: batch x heads exceeds the launch grid")
    out = _out_buffer(q, heads, head_dim) if out is None else _check_out(out, q, heads, head_dim)
    train = with_lse or (drop is not None and drop.active)
    lse = torch.empty((bh, nq), dtype=torch.float32, device=q.device) if train else None
    rc = _build.library().v1t_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), _build.ptr(lse),
        bh, nq, k.shape[1], n_real_k, head_dim, dp, heads, out.stride(0), out.stride(2),
        out.stride(1), int(q.dtype == torch.float32), int(use_lsa), *drop_args(drop),
        _build.stream_of(q),
    )
    _build.check_launch("flash_attention", rc)
    flash_fwd.launches += 1
    return (out, lse) if with_lse else out


flash_fwd.launches = 0


def _check_bwd(q: Tensor, o: Tensor, do: Tensor, lse: Tensor, dlse: t.Optional[Tensor],
               head_dim: int, heads: int) -> None:
    bh, nq, _ = q.shape
    shape = (bh // heads, nq, heads, head_dim)
    if tuple(o.shape) != shape or tuple(do.shape) != shape or o.dtype != q.dtype \
            or do.dtype != q.dtype:
        raise ValueError(f"flash_attention_bwd: o {tuple(o.shape)} / do {tuple(do.shape)} "
                         f"are not {shape} {q.dtype}")
    for name, x in (("lse", lse), ("dlse", dlse)):
        if x is not None and (tuple(x.shape) != (bh, nq) or x.dtype != torch.float32):
            raise ValueError(f"flash_attention_bwd: {name} is {tuple(x.shape)} {x.dtype}")


class BwdPlan(t.NamedTuple):
    kernels: t.Tuple[str, ...]  # the launches of one flash_bwd call, in order
    dq_acc: t.Optional[t.Tuple[int, int, int]]  # float32 scratch shape, or None
    keys: int  # keys a block of the main pass
    smem: int  # its dynamic shared memory a block, bytes


def bwd_plan(dtype: torch.dtype, bh: int, nq: int, dp: int) -> BwdPlan:
    """Which kernels ``flash_bwd`` launches for these operands, the float32
    dq accumulator it allocates and the main pass's tiles: bf16 takes the
    one-pass wgmma kernel, which adds dq's partial sums into a (BH, Nq, DP)
    float32 buffer that a last kernel rounds to bf16 (blocks of 128 keys up
    to ``WIDE_DP``, 64 above, where dK and dV are split by columns between
    the warpgroups; query tiles of 64 in a 2-stage ring, with P and dS
    panels); float32 takes one FFMA pass that adds dq's partial sums into dq
    itself (blocks of 64 keys up to DP 160, 32 above; query tiles of 32,
    every row padded by 4 floats). The same tiles are compiled into
    ``csrc/flash_attention_bwd.cu``."""
    if dp % 32 or not 32 <= dp <= MAX_HEAD_PAD:
        raise ValueError(f"flash_attention_bwd: padded head width {dp}")
    if dtype == torch.float32:
        keys, qt = (64 if dp <= 160 else 32), 32
        smem = (2 * keys * (dp + 4) + 2 * 2 * qt * (dp + 4) + 2 * qt * (keys + 4)
                + 2 * 2 * qt) * 4
        return BwdPlan(("prep", "one_pass_f32"), None, keys, smem)
    wide = dp > WIDE_DP
    keys, qb, stages = (64 if wide else 128), 64, 2
    dq_boxes = 8 * 16 * 32 * 4 if wide else 0  # a float32 box of 16 x 32 a warp
    smem = (1024 + 2 * keys * dp * 2 + stages * (2 * qb * dp * 2 + 2 * qb * 4)
            + 2 * qb * keys * 2 + dq_boxes + (1 + stages) * 8)
    return BwdPlan(("prep", "one_pass", "dq_convert"), (bh, nq, dp), keys, smem)


def flash_bwd_plain(q: Tensor, k: Tensor, v: Tensor, o: Tensor, do: Tensor, lse: Tensor,
                    head_dim: int, heads: int = 1, *, dlse: t.Optional[Tensor] = None,
                    n_real_k: t.Optional[int] = None, use_lsa: bool = False,
                    drop: t.Optional[Dropout] = None, out=None):
    """Plain PyTorch version of ``flash_bwd``, query rows in chunks, P
    recomputed from the LSE per chunk; dS and the kept P round to the input
    dtype before their products, dq, dk, dv at the end, as the kernels
    round them."""
    n_real_k = _check(q, k, v, head_dim, heads, n_real_k, use_lsa)
    _check_bwd(q, o, do, lse, dlse, head_dim, heads)
    dt = q.dtype
    bh, nq, dp = q.shape
    nk = k.shape[1]
    heads_major = lambda y: y.permute(0, 2, 1, 3).reshape(bh, nq, head_dim)  # noqa: E731
    do_h = F.pad(heads_major(do).float(), (0, dp - head_dim))
    delta = (heads_major(do).float() * heads_major(o).float()).sum(-1)
    if dlse is not None:
        delta = delta - dlse
    k32, v32 = k.float(), v.float()
    dq = torch.empty((bh, nq, dp), dtype=dt, device=q.device) if out is None else out[0]
    dk32 = torch.zeros((bh, nk, dp), dtype=torch.float32, device=q.device)
    dv32 = torch.zeros_like(dk32)
    step = _chunk_rows(bh, nk)
    for r0 in range(0, nq, step):
        r1 = min(r0 + step, nq)
        s = _scores(q[:, r0:r1], k, r0, n_real_k, use_lsa)
        p = torch.exp2(s - lse[:, r0:r1, None] * LOG2E)
        do_c = do_h[:, r0:r1]
        dp_ = do_c @ v32.transpose(1, 2)
        p_kept = p
        keep = _keep(drop, bh, r0, r1 - r0, nk, q.device)
        if keep is not None:
            dp_ = torch.where(keep, dp_ * drop.scale, 0.0)
            p_kept = p.masked_fill(~keep, 0.0)
        ds = (p * (dp_ - delta[:, r0:r1, None])).to(dt).float()
        dq[:, r0:r1] = (ds @ k32).to(dt)
        dk32 += ds.transpose(1, 2) @ q[:, r0:r1].float()
        dv32 += p_kept.to(dt).float().transpose(1, 2) @ do_c
    if drop is not None and drop.active:
        dv32 = dv32 * drop.scale
    if out is None:
        return dq, dk32.to(dt), dv32.to(dt)
    out[1].copy_(dk32)
    out[2].copy_(dv32)
    return out


def flash_bwd(q: Tensor, k: Tensor, v: Tensor, o: Tensor, do: Tensor, lse: Tensor,
              head_dim: int, heads: int = 1, *, dlse: t.Optional[Tensor] = None,
              n_real_k: t.Optional[int] = None, use_lsa: bool = False,
              drop: t.Optional[Dropout] = None, out=None):
    """The backward of ``flash_fwd``'s training forward: q, k, v as it took
    them, its output o and cotangent do (B, Nq, heads, head_dim; two views
    with the same strides, rows contiguous), its LSE and
    the LSE's cotangent dlse (BH, Nq) float32 (None: zero), its keep mask
    ``drop`` (regenerated) -> (dq (BH, Nq, DP), dk, dv (BH, Nk, DP)) in q's
    dtype, zero past head_dim; into ``out``'s three tensors when given."""
    n_real_k = _check(q, k, v, head_dim, heads, n_real_k, use_lsa)
    _check_bwd(q, o, do, lse, dlse, head_dim, heads)
    kwargs = dict(dlse=dlse, n_real_k=n_real_k, use_lsa=use_lsa, drop=drop, out=out)
    if q.device.type == "cpu":
        return flash_bwd_plain(q, k, v, o, do, lse, head_dim, heads, **kwargs)
    dt, f32 = q.dtype, torch.float32
    _build.require_cuda("flash_attention_bwd", (dt, dt, dt, f32, f32), q, k, v, lse, dlse)
    if o.device != q.device or do.device != q.device or not _one_layout(o, do):
        raise ValueError("flash_attention_bwd: o and do are not views of one layout with "
                         "contiguous rows on q's device")
    bh, nq, dp = q.shape
    nk = k.shape[1]
    if dp > MAX_HEAD_PAD:
        raise ValueError(f"flash_attention_bwd: head width {head_dim} padded to {dp} > "
                         f"{MAX_HEAD_PAD} (ROADMAP queue 3 item 1)")
    if bh > 65535:
        raise ValueError("flash_attention_bwd: batch x heads exceeds the launch grid")
    if out is None:
        out = (torch.empty_like(q), torch.empty_like(k), torch.empty_like(v))
    elif any(not x.is_contiguous() or x.dtype != dt or x.shape != y.shape
             for x, y in zip(out, (q, k, v))):
        raise ValueError("flash_attention_bwd: out is not three contiguous tensors like q, k, v")
    plan = bwd_plan(dt, bh, nq, dp)
    dohm = torch.empty_like(q)  # scratch: dO head-major
    delta = torch.empty((bh, nq), dtype=f32, device=q.device)
    dq_acc = None if plan.dq_acc is None else torch.empty(plan.dq_acc, dtype=f32,
                                                           device=q.device)
    rc = _build.library().v1t_flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
        lse.data_ptr(), _build.ptr(dlse), out[0].data_ptr(), out[1].data_ptr(),
        out[2].data_ptr(), dohm.data_ptr(), delta.data_ptr(), _build.ptr(dq_acc), bh, nq, nk,
        n_real_k, head_dim, dp, heads, o.stride(0), o.stride(2), o.stride(1),
        int(dt == torch.float32), int(use_lsa), *drop_args(drop), _build.stream_of(q),
    )
    _build.check_launch("flash_attention_bwd", rc)
    flash_bwd.launches += 1
    return out


flash_bwd.launches = 0


def _pad_planes(x: Tensor) -> Tensor:
    """(B, H, N, D) -> contiguous (B*H, N, DP), zero past D."""
    b, h, n, d = x.shape
    return F.pad(x, (0, padded_head_dim(d) - d)).reshape(b * h, n, -1).contiguous()


class _Cfg(t.NamedTuple):
    n_real_k: t.Optional[int]
    use_lsa: bool
    drop: t.Optional[Dropout]
    with_lse: bool
    plain: bool


class _FlashCore(torch.autograd.Function):
    """The JAX ``_flash_core`` / ``_flash_lse_core`` boundary: q (scaled),
    k, v (B, H, N, D) in, o (and the LSE) out."""

    @staticmethod
    def forward(ctx, q, k, v, cfg: _Cfg):
        b, h, nq, d = q.shape
        qp, kp, vp = (_pad_planes(x) for x in (q, k, v))
        fwd = flash_fwd_plain if cfg.plain else flash_fwd
        o, lse = fwd(qp, kp, vp, d, h, n_real_k=cfg.n_real_k, use_lsa=cfg.use_lsa,
                     drop=cfg.drop, with_lse=True)
        ctx.cfg, ctx.dims = cfg, (b, h, d)
        ctx.save_for_backward(qp, kp, vp, o, lse)
        o = o.permute(0, 2, 1, 3)
        return (o, lse.view(b, h, nq)) if cfg.with_lse else o

    @staticmethod
    def backward(ctx, do, dlse=None):
        cfg, (b, h, d) = ctx.cfg, ctx.dims
        qp, kp, vp, o, lse = ctx.saved_tensors
        do = do.to(qp.dtype).transpose(1, 2).contiguous()  # (B, Nq, H, D)
        if dlse is not None:
            dlse = dlse.float().reshape(b * h, -1).contiguous()
        bwd = flash_bwd_plain if cfg.plain else flash_bwd
        grads = bwd(qp, kp, vp, o, do, lse, d, h, dlse=dlse, n_real_k=cfg.n_real_k,
                    use_lsa=cfg.use_lsa, drop=cfg.drop)
        dq, dk, dv = (g.view(b, h, g.shape[1], -1)[..., :d] for g in grads)
        return dq, dk, dv, None


def _run(q: Tensor, k: Tensor, v: Tensor, cfg: _Cfg):
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return _FlashCore.apply(q, k, v, cfg)
    b, h, nq, d = q.shape
    fwd = flash_fwd_plain if cfg.plain else flash_fwd
    out = fwd(*(_pad_planes(x) for x in (q, k, v)), d, h, n_real_k=cfg.n_real_k,
              use_lsa=cfg.use_lsa, drop=cfg.drop, with_lse=cfg.with_lse)
    if cfg.with_lse:
        return out[0].permute(0, 2, 1, 3), out[1].view(b, h, nq)
    return out.permute(0, 2, 1, 3)


def flash_attention(q: Tensor, k: Tensor, v: Tensor, scale: t.Union[Tensor, float], *,
                    use_lsa: bool = False, drop: t.Optional[Dropout] = None,
                    plain: bool = False) -> Tensor:
    """softmax(q k^T * scale) v with LSA and fused dropout; (B, H, N, D) in
    and out (``v1t_tpu/ops/flash_attention.py`` ``flash_attention``).

    The (possibly per-head, learnable) ``scale`` is folded into q outside
    the kernel, in q's dtype, so that its gradient flows through autograd;
    the ``torch.autograd.Function`` covers only the attention itself.
    ``drop``: the probabilities' training dropout. ``plain``: the plain
    versions on any device (otherwise a CUDA tensor launches the kernels).
    The result is a (B, H, N, D) view of a (B, N, H, D) buffer."""
    scale = torch.as_tensor(scale, dtype=torch.float32, device=q.device)
    if scale.ndim == 1:
        q = q * scale.to(q.dtype)[None, :, None, None]
    else:
        q = q * scale.to(q.dtype)
    return _run(q, k, v, _Cfg(None, bool(use_lsa), drop, False, plain))


def flash_attention_with_lse(q: Tensor, k: Tensor, v: Tensor, *,
                             n_real_k: t.Optional[int] = None,
                             drop: t.Optional[Dropout] = None,
                             plain: bool = False) -> t.Tuple[Tensor, Tensor]:
    """Rectangular attention returning ``(out, lse)``: q (B, H, Nq, D)
    against k, v (B, H, Nk, D), the softmax scale already in q, keys at or
    past ``n_real_k`` masked, no LSA -> out (B, H, Nq, D) and the natural-log
    LSE (B, H, Nq) float32, both differentiable (the LSE's cotangent folds
    into delta) (``v1t_tpu/ops/flash_attention.py``
    ``flash_attention_with_lse``)."""
    return _run(q, k, v, _Cfg(n_real_k, False, drop, True, plain))
