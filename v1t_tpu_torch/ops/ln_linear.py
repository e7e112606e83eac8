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
the W^T of ``dx_weight``; past K 640 on wgmma, a LayerNorm's row sums added
across a cluster of blocks) and ``ln_linear_wgrad`` (dW = dY'^T A and db on
wgmma, one fp32 partial per slice of the rows, ``wgrad_plan``, summed
here in slice order). The forward's launch is ``linear_plan``.

Activations round to the input dtype where the JAX package's fused TPU
kernels round them: the (x + row) sum, the normalised input, the projection
before a residual add and the output.

A CUDA tensor launches the kernel (bf16 only: the fp32 model takes the
composed path, ``models/cores/vit.py``); a CPU tensor takes the plain
version (bf16 or float32). Any K runs on the card. Up to ``MAX_LN_K`` the
kernels hold a LayerNorm's whole rows (a panel of K bf16 columns forward,
fp32 rows in shared memory backward); past it the forward runs the wgmma
kernel of 128 x 256 tiles (``LinearPlan.wgmma``; a LayerNorm's rows first
normalised into bf16 scratch by ``ln_rows_kernel``, which then streams like
an aligned x), and the backward's dX runs on the wgmma kernel (``DxPlan.wgmma``;
a masked or unaligned row-major dY first masked once into aligned
scratch); a LayerNorm wider than 2048 keeps its fp32 d(ln) rows in scratch
of device memory (``DxPlan.dln_global``). The kernels copy operands by TMA
(16-byte aligned rows) or as the contiguous span of whole rows (rows of
155 bf16 are 310 bytes), the weight gradient also row by row; only a
forward x without LayerNorm, rows not 16-byte aligned and K > 640, is
zero-padded here to a multiple of 8 columns first (no configuration's use).
``ln_linear.launches`` (and ``ln_linear_bwd``'s, ``ln_linear_wgrad``'s)
counts kernel launches; ``ln_linear.form_launches`` and
``ln_linear_bwd.form_launches`` count them again by kernel
(``FORWARD_FORMS``, ``DX_FORMS``).
"""

from __future__ import annotations

import typing as t

import torch
import torch.nn.functional as F

from v1t_tpu_torch import _build
from v1t_tpu_torch.ops.dropout import Dropout, apply_dropout

Tensor = torch.Tensor
MAX_LN_K = 640  # a LayerNorm's widest rows held whole in shared memory


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


MAX_TILE = 160  # output columns a forward tile / dY columns a weight-gradient tile at most
WIDE_TILE = 256  # output columns a forward tile past MAX_LN_K at most (the wgmma kernel)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _tiles(n: int, heads, max_tile: int = MAX_TILE) -> t.Tuple[int, int, int]:
    """(tile columns NT, tiles a head-major plane, tiles) of an output of N
    logical columns: each head's plane of ``padded_head_dim`` split evenly
    (wider than ``max_tile``: in two or more), or N split evenly; NT a
    multiple of 32 up to ``max_tile``, so that the accumulator fits the
    registers."""
    if heads is not None:
        head_pad = padded_head_dim(heads[1])
        parts = _cdiv(head_pad, max_tile)
        return _cdiv(_cdiv(head_pad, parts), 32) * 32, parts, n // heads[1] * parts
    tiles = _cdiv(n, max_tile)
    return _cdiv(_cdiv(n, tiles), 32) * 32, 1, tiles


def _aligned(x: Tensor) -> bool:
    """Rows of a contiguous (., K) bf16 operand 16-byte aligned: TMA can copy them."""
    return x.shape[-1] % 8 == 0 and x.data_ptr() % 16 == 0


def _pad_columns(x: Tensor) -> Tensor:
    """x zero-padded to a multiple of 8 columns (16-byte aligned rows)."""
    k = x.shape[-1]
    return F.pad(x, (0, -(-k // 8) * 8 - k)).contiguous()


class LinearPlan(t.NamedTuple):
    stream: bool  # x streams through the ring by TMA (else a panel built once a block)
    rows: int  # rows a block: 128 (two consumer warpgroups) or 64
    tile: int  # output columns a tile
    tiles: int  # output tiles a block walks (the wgmma kernel: output tiles a row tile)
    stages: int  # depth of the ring
    smem: int  # dynamic shared memory a block, bytes
    wgmma: bool = False  # past PANEL_MAX_K: the persistent wgmma kernel, tiles of 128 x 256


PANEL_MAX_K, PANEL_MAX_K128, SMEM_LIMIT = 640, 320, 232448
# the wgmma kernel past PANEL_MAX_K: chunks of 64 reduction columns, x's
# [128][64] and w's [256][64] in rings of 3 stages each, each consumer
# warpgroup's 64 output rows staged in bf16 [64][256], room for 16
# mbarriers
WL_ROWS, WL_STAGES, WL_W_STAGES, WL_CHUNK = 128, 3, 3, 64
WL_SMEM = 1024 + (WL_STAGES * WL_ROWS + WL_W_STAGES * WIDE_TILE) * WL_CHUNK * 2 + (
    2 * 64 * WIDE_TILE * 2 + 16 * 8)


def linear_plan(m: int, n: int, k: int, heads=None, ln: bool = False, x_aligned: bool = False,
                residual: bool = False) -> t.Optional[LinearPlan]:
    """The launch ``csrc/ln_linear.cu`` ``linear_plan`` picks (None: none
    fits). x streams through the ring beside w when it needs no LayerNorm
    and its rows are 16-byte aligned; otherwise its rows' span is copied
    whole and turned into a resident panel of K rounded up to 64 columns
    (KP, a multiple of 32, up to 640; blocks of 128 rows up to 320). Of ring
    depths 4, 3, 2 the deepest that fits; the output tile is staged in fp32
    (and, with a residual or rows not 16-byte aligned, once more in bf16)
    in a region of its own, which the panel's x span uses first. Past
    ``PANEL_MAX_K`` every call takes the persistent wgmma kernel
    (``wgmma``): tiles of 128 rows x up to 256 columns (planes and N split
    evenly into multiples of 32), x and w by TMA through rings of 3 stages
    each, so x's rows must be 16-byte aligned there (None otherwise: the
    wrapper pads them), but for a LayerNorm's, which are first normalised
    into aligned scratch."""
    kp = _cdiv(k, 32) * 32
    if kp > PANEL_MAX_K:
        nt, _, tiles = _tiles(n, heads, WIDE_TILE)
        return (LinearPlan(True, WL_ROWS, nt, tiles, WL_STAGES, WL_SMEM, True)
                if x_aligned or ln else None)
    nt, _, tiles = _tiles(n, heads)
    stream = not ln and x_aligned
    direct = heads is not None or (n % 8 == 0 and not residual)
    for rows in ((128,) if stream else (128, 64)):
        if not stream and rows == 128 and kp > PANEL_MAX_K128:
            continue
        out = rows * (nt + 8) * (4 if direct else 6)
        raw = 0 if stream else _cdiv(rows * k * 2 + 32, 128) * 128
        region = _cdiv(max(out, raw), 1024) * 1024
        panel = 0 if stream else rows * _cdiv(kp, 64) * 64 * 2
        stage = (rows * 64 * 2 if stream else 0) + nt * 64 * 2
        for stages in (4, 3, 2):
            smem = 3072 + panel + stages * stage + region
            if smem <= SMEM_LIMIT:
                return LinearPlan(stream, rows, nt, tiles, stages, smem)
    return None


def forward_weight(w: Tensor, heads=None) -> Tensor:
    """The (rows, KP) w the forward kernel streams: K zero-padded to a
    multiple of 32 (16-byte aligned rows) and, head-major, each head's D
    rows zero-padded to ``padded_head_dim(D)``, so that the plane's pad
    columns come out zero."""
    nout, k = w.shape
    kp = _cdiv(k, 32) * 32
    if heads is None:
        return w if kp == k else F.pad(w, (0, kp - k))
    d = heads[1]
    w3 = w.reshape(nout // d, d, k)
    return F.pad(w3, (0, kp - k, 0, padded_head_dim(d) - d)).reshape(-1, kp).contiguous()


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
    kp = _cdiv(k, 32) * 32
    # past a panel (the wgmma kernel, x streamed by TMA): a LayerNorm's rows
    # normalised into aligned scratch first; other unaligned rows padded to
    # 8 columns (ldx their stride)
    ln_x = (torch.empty((b * n, _cdiv(k, 8) * 8), dtype=bf, device=x.device)
            if gamma is not None and kp > PANEL_MAX_K else None)
    if kp > PANEL_MAX_K and gamma is None and not _aligned(x):
        x = _pad_columns(x)
    w_pad = forward_weight(w, heads)
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
        *(_build.ptr(a) for a in args), y.data_ptr(), _build.ptr(pre), _build.ptr(ln_x),
        b * n, nout, k, kp, x.shape[2], n, int(gelu), num_heads, head_dim, head_pad,
        *drop_args(drop), _build.stream_of(x),
    )
    _build.check_launch("ln_linear", rc)
    ln_linear.launches += 1
    ln_linear.form_launches[
        "fwd_panel_or_streamed" if kp <= PANEL_MAX_K
        else "fwd_wgmma_layernorm" if gamma is not None else "fwd_wgmma_plain"] += 1
    return (y, pre) if save_pre else y


ln_linear.launches = 0
# the same launches by kernel: ln_linear_kernel (K <= 640, a panel or x
# streamed) and the wgmma kernel past it, with and without the LayerNorm
FORWARD_FORMS = ("fwd_panel_or_streamed", "fwd_wgmma_layernorm", "fwd_wgmma_plain")
ln_linear.form_launches = dict.fromkeys(FORWARD_FORMS, 0)


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


class WgradPlan(t.NamedTuple):
    tile: int  # dY columns (dW rows) a block
    n_tiles: int  # tiles over dY's columns
    k_tiles: int  # tiles of 192 over A's columns
    slices: int  # fp32 partials written, summed in slice order
    cluster: int  # blocks a slice and tile, summed in distributed shared memory
    stages: int  # depth of the panel ring (the products' operands)
    copied_stages: int  # depth of the ring of rows copied whole (0: every operand by TMA)
    smem: int  # dynamic shared memory a block, bytes
    chunks: int  # 64-row chunks of the rows
    a_copy: str  # how A reaches shared memory: "tma", "span" or "segments"
    dy_copy: str  # the same for dY

    @property
    def blocks(self) -> int:
        return self.slices * self.cluster * self.n_tiles * self.k_tiles

    @property
    def dy_reads(self) -> int:
        """How many blocks copy each dY element: one per tile over A's
        columns (the k-tiles of one slice run side by side, so that all
        but the first find it in L2)."""
        return self.k_tiles


WGRAD_KT, WGRAD_TARGET, WGRAD_MAX_CLUSTER, WGRAD_PARTIAL_SHARE = 192, 264, 8, 20
COPIES = ("tma", "span", "segments")


def wgrad_plan(m: int, n: int, k: int, rows_per_batch: int, heads=None, dy_aligned: bool = True,
               a_aligned: bool = True) -> WgradPlan:
    """The launch ``csrc/ln_linear_bwd.cu`` ``wgrad_plan`` picks for dW =
    dY'^T A over M rows, dY (M, N) (head-major with ``heads``), A (M, K).
    A block owns an output tile of up to 160 dY columns (a head's plane)
    x 192 A columns, accumulated on three consumer warpgroups over a fixed
    range of 64-row chunks. The slices (fp32 partials) depend on the shape
    alone: at most M / (20 K), so that the partials stay within 10% of dY's
    bytes, and enough to reach 264 blocks with a cluster of up to 8 blocks
    a slice and tile that sum their tiles in distributed shared memory. An
    operand with 16-byte aligned rows goes by TMA; otherwise as the span of
    a chunk's whole rows where one tile takes them, else as one copy of
    each row's segment, unpacked in shared memory."""
    nt, _, n_tiles = _tiles(n, heads)
    k_tiles = _cdiv(k, WGRAD_KT)
    rows = rows_per_batch if heads is not None else m
    chunks = (m // rows) * _cdiv(rows, 64)
    tiles = n_tiles * k_tiles
    slices = min(max(1, m // (WGRAD_PARTIAL_SHARE * k)), _cdiv(WGRAD_TARGET, tiles), chunks)
    cluster = max(1, min(WGRAD_MAX_CLUSTER, _cdiv(WGRAD_TARGET, slices * tiles),
                         chunks // slices))
    a_copy = 0 if a_aligned else 1 if k_tiles == 1 else 2
    dy_copy = 0 if heads is not None or dy_aligned else 1 if n_tiles == 1 else 2

    def staged(copy, row_elems, tile):
        return (_cdiv(64 * row_elems * 2 + 32, 128) * 128 if copy == 1
                else _cdiv(64 * (tile + 16) * 2 + 32, 128) * 128 if copy == 2 else 0)

    sub = 64 * 64
    pstage = WGRAD_KT // 32 * sub + nt // 32 * sub
    rstage = _cdiv(staged(a_copy, k, WGRAD_KT) + staged(dy_copy, n, nt), 1024) * 1024
    tile = nt * (WGRAD_KT + 4) * 4
    stages, copied, smem = 0, 0, 0
    for ps in (4, 3, 2):
        for rs in ((4, 3, 2) if rstage else (0,)):
            need = 2048 + max(ps * pstage + rs * rstage, tile)
            if not smem and need <= SMEM_LIMIT:
                stages, copied, smem = ps, rs, need
    return WgradPlan(nt, n_tiles, k_tiles, slices, cluster, stages, copied, smem, chunks,
                     COPIES[a_copy], COPIES[dy_copy])


class DxPlan(t.NamedTuple):
    rows: int  # rows a block: 128 or 64
    stages: int  # depth of the copy ring
    resident: bool  # the block's dY' rows stay in shared memory for every output tile
    k_tiles: int  # output tiles of DX_TILE columns (wgmma: of WX_TILE)
    smem: int  # dynamic shared memory a block, bytes
    dln_global: bool = False  # a LayerNorm past WX_LN_MAX_K: its fp32 d(ln) rows in device memory
    wgmma: bool = False  # past MAX_LN_K: the wgmma kernel, tiles of 128 rows x 256 columns
    cluster: int = 1  # its blocks a cluster: a LayerNorm's k_tiles (its row sums), else 1

    @property
    def dy_reads(self) -> int:
        """How many blocks copy each dY' element: one per output tile, or
        one when the block's dY' rows stay in shared memory (resident). How
        many of the wgmma kernel's copies find it in L2 (its row tile's
        blocks run side by side) is not measured."""
        return 1 if self.resident else self.k_tiles


DX_TILE, DX_CHUNK, DX_MAX_SMEM = 160, 32, 232448
# the wgmma dX kernel: tiles of 128 rows x 256 output columns a block, a ring
# of 4 stages of 64 reduction columns ([128][64] of dY', [256][64] of W^T), a
# LayerNorm's row in one cluster of up to 8 blocks
WX_ROWS, WX_TILE, WX_CHUNK, WX_STAGES, WX_MAX_CLUSTER = 128, 256, 64, 4, 8
WX_LN_MAX_K = WX_MAX_CLUSTER * WX_TILE
WX_SMEM = 1024 + 8192 + WX_STAGES * (WX_ROWS + WX_TILE) * WX_CHUNK * 2
DX_FORMS = ("mma_sync", "wgmma_layernorm", "wgmma_plain")  # ln_linear_bwd.form_launches' keys


def _dx_wgmma(k: int, ln: bool) -> bool:
    """Whether a K-wide dX takes the wgmma kernel: every K past ``MAX_LN_K``
    but a LayerNorm wider than one cluster's 8 x 256 columns."""
    return k > MAX_LN_K and not (ln and k > WX_LN_MAX_K)


def dx_plan(k: int, ns: int, aligned: bool, ln: bool) -> t.Optional[DxPlan]:
    """The launch ``csrc/ln_linear_bwd.cu`` ``dx_plan`` picks for a K-wide
    dX over NS stored reduction columns, dY rows 16-byte aligned or not,
    with the LayerNorm epilogue or not (None: no launch fits).

    Up to ``MAX_LN_K``: a block owns a 160-column output tile; its dY' rows
    stay in shared memory across the tiles when they fit (resident), else
    dY streams once per tile; 128 rows before 64; of the ring depths 4, 3, 2
    the deepest that leaves room for two blocks a SM, else the deepest that
    fits. The products go through an fp32 tile; the LayerNorm's fp32 rows
    reuse the ring when K fits one tile.

    Past it, every K takes the wgmma kernel: a block owns a tile of 128
    rows x 256 output columns, accumulated in registers; a LayerNorm's row
    lies in one cluster of ceil(K / 256) <= 8 blocks, which add its sums in
    distributed shared memory. A LayerNorm wider than 8 x 256 (no
    configuration) keeps its fp32 d(ln) rows in (M, K) float32 scratch in
    device memory and only 4 statistics a row in shared memory
    (``dln_global``)."""
    if _dx_wgmma(k, ln):
        k_tiles = _cdiv(k, WX_TILE)
        return DxPlan(WX_ROWS, WX_STAGES, False, k_tiles, WX_SMEM, False, True,
                      k_tiles if ln else 1)
    k_tiles = -(-k // DX_TILE)
    dln_global = ln and k > MAX_LN_K
    ld = DX_CHUNK + 8
    for resident in ((True, False) if k_tiles > 1 else (False,)):
        for rows in (128, 64):
            for limit in (DX_MAX_SMEM // 2 - 1024, DX_MAX_SMEM):
                for stages in (4, 3, 2):
                    w = stages * DX_TILE * ld * 2
                    a = rows * (ns + 8) * 2 if resident else (stages if aligned else 2) * rows * ld * 2
                    ring = w + a + (0 if aligned else stages * rows * ld * 2)
                    e = (rows * 16 if dln_global
                         else rows * (k_tiles * DX_TILE + 4) * 4 + rows * 16 if ln
                         else rows * (DX_TILE + 4) * 4)
                    e_off = 0 if ln and k_tiles == 1 and e <= ring else ring
                    smem = max(ring, e_off + e)
                    if smem <= limit:
                        return DxPlan(rows, stages, resident, k_tiles, smem, dln_global)
    return None


def dx_col_parts(plan: DxPlan, m: int, k: int, batches: int, brow: bool) -> t.Tuple[int, int]:
    """The (rows, K) float32 scratch of the LayerNorm epilogue's column sums
    over M rows: each block's d(gamma) and d(beta) partials and, with
    ``brow``, the d(bias_row) partial of each (block, batch) pair its rows
    meet (blocks + batches - 1 of them); the wgmma kernel's row tiles lie
    within a batch, ceil(rows / 128) a batch, one partial of each a tile. A
    last kernel adds each column's partials in an order fixed by the shape
    (``csrc/ln_linear_bwd.cu`` ``ln_dx_column_sums_kernel``), so that
    reruns agree bit for bit."""
    if plan.wgmma:
        tiles = batches * _cdiv(m // batches, plan.rows)
        return (3 if brow else 2) * tiles, k
    blocks = -(-m // plan.rows)
    return 2 * blocks + (blocks + batches - 1 if brow else 0), k


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
    if drop is not None and pre_drop is not None and drop.active and pre_drop.active and (
            drop.rate != pre_drop.rate or drop.seed != pre_drop.seed):
        raise ValueError("ln_linear_bwd: the two masks share one rate and seed")
    if heads is not None and dy.data_ptr() % 16:
        raise ValueError("ln_linear_bwd: a head-major dy starts 16-byte aligned")
    wt = dx_weight(w, heads)  # (K, NS)
    num_heads, head_dim = heads or (0, 0)
    head_pad = padded_head_dim(head_dim) if heads else 0
    aligned = heads is not None or _aligned(dy)
    wgmma = _dx_wgmma(k, x is not None)
    masked = drop is not None and drop.active
    if wgmma and heads is not None and masked:
        raise ValueError("ln_linear_bwd: past K 640 a head-major dy takes no keep mask")
    dx = torch.empty((b, n, k), dtype=bf, device=dy.device)
    ln_out = dgamma = dbeta = dbrow = col_part = dln = dy_prep = None
    if wgmma and heads is None and (masked or not aligned):
        # scratch: dY' masked once and in 16-byte aligned rows, for TMA
        dy_prep = torch.empty((b * n, wt.shape[1]), dtype=bf, device=dy.device)
    if x is not None:
        ln_out = torch.empty_like(dx)
        dgamma = torch.empty(k, dtype=f32, device=dy.device)
        dbeta = torch.empty(k, dtype=f32, device=dy.device)
        dbrow = torch.empty((b, k), dtype=f32, device=dy.device) if pro_row is not None else None
        plan = dx_plan(k, wt.shape[1], aligned, True)
        col_part = torch.empty(dx_col_parts(plan, b * n, k, b, pro_row is not None),
                               dtype=f32, device=dy.device)
        if plan.dln_global:  # scratch: the fp32 d(ln) rows
            dln = torch.empty((b * n, k), dtype=f32, device=dy.device)
    seed, site_in, thr_in, scale = drop_args(drop)
    _, site_out, thr_out, _ = drop_args(pre_drop)
    if thr_out and not thr_in:  # the two masks share one seed and scale
        seed, _, _, scale = drop_args(pre_drop)
    rc = _build.library().v1t_ln_linear_dx(
        dy.data_ptr(), dx.data_ptr(), wt.data_ptr(), b * n, nout, k, wt.shape[1], n, num_heads,
        head_dim, head_pad, seed, site_in, thr_in, _build.ptr(pre), site_out,
        thr_out, scale, _build.ptr(x), _build.ptr(pro_row),
        _build.ptr(gamma), _build.ptr(beta), _build.ptr(dres), _build.ptr(ln_out),
        _build.ptr(dgamma), _build.ptr(dbeta), _build.ptr(dbrow), _build.ptr(col_part),
        _build.ptr(dln), _build.ptr(dy_prep), _build.stream_of(dy),
    )
    _build.check_launch("ln_linear_bwd", rc)
    ln_linear_bwd.launches += 1
    ln_linear_bwd.form_launches[
        "mma_sync" if not wgmma else "wgmma_layernorm" if x is not None else "wgmma_plain"] += 1
    return dx if x is None else (dx, ln_out, dgamma, dbeta, dbrow)


ln_linear_bwd.launches = 0
# the same launches by kernel: the mma.sync ln_linear_dx_kernel (K <= 640,
# and a LayerNorm past 2048) and the wgmma dx_wgmma_kernel with and without
# the LayerNorm epilogue
ln_linear_bwd.form_launches = dict.fromkeys(DX_FORMS, 0)


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
    ``drop`` and the layer's input a (B, N, K). The kernel writes one fp32
    partial per slice of the rows (``wgrad_plan``); they are summed here in
    slice order, so that reruns agree bit for bit."""
    b, n, nout = _dy_rows(dy, heads)
    if a.ndim != 3 or tuple(a.shape[:2]) != (b, n):
        raise ValueError(f"ln_linear_wgrad: a {tuple(a.shape)} does not match dy's (B, N)")
    if heads is not None and drop is not None and drop.active:
        raise ValueError("ln_linear_wgrad: a head-major dy takes no keep mask")
    if dy.device.type == "cpu":
        return ln_linear_wgrad_plain(dy, a, heads=heads, drop=drop, bias=bias)
    bf, f32 = torch.bfloat16, torch.float32
    _build.require_cuda("ln_linear_wgrad", (bf, bf), dy, a)
    if heads is not None and dy.data_ptr() % 16:
        raise ValueError("ln_linear_wgrad: a head-major dy starts 16-byte aligned")
    k = a.shape[2]
    plan = wgrad_plan(b * n, nout, k, n, heads, heads is not None or _aligned(dy), _aligned(a))
    if plan.slices > 65535:
        raise ValueError("ln_linear_wgrad: slices exceed the launch grid")
    num_heads, head_dim = heads or (0, 0)
    head_pad = padded_head_dim(head_dim) if heads else 0
    dw_part = torch.empty((plan.slices, nout, k), dtype=f32, device=dy.device)
    db_part = torch.empty((plan.slices, nout), dtype=f32, device=dy.device) if bias else None
    rc = _build.library().v1t_ln_linear_wgrad(
        dy.data_ptr(), a.data_ptr(), dw_part.data_ptr(), _build.ptr(db_part), b * n, nout, k,
        n, num_heads, head_dim, head_pad, *drop_args(drop), _build.stream_of(dy),
    )
    _build.check_launch("ln_linear_wgrad", rc)
    ln_linear_wgrad.launches += 1
    return dw_part.sum(0), (db_part.sum(0) if bias else None)


ln_linear_wgrad.launches = 0
