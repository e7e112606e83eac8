"""The port's CUDA kernels against their plain versions at edge shapes, on
the card: rows, outputs and K that are no multiple of a tile, one row, one
key tile, every padded head width, batch 1, dropout rates 0 and 0.5 (the
kernels and the plain versions draw the same masks), the widths of the sweep
space (head widths 192 and 256, projection K up to 2048, LayerNorms up to
640), the flash kernels of the composed path (bf16 and float32, N > 4096,
rectangular with padded keys and an LSE cotangent), and the small model end
to end in bf16 and float32, forward and training step.

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py -q

(``--noconftest``: ``tests/conftest.py`` configures JAX, which a GPU host
running only the port lacks.) Without a CUDA device every test skips.

Tolerance: max|kernel - plain| <= 2e-2 * max|plain| on bf16 outputs, as in
``chip_smoke.py`` (one bf16 rounding is 2^-8; the two sum in other orders),
and on float32 sums of bf16 products (weight, bias and LayerNorm gradients,
dscale, d(grid)): the two take the same bf16 operands, but a rounding flip in
an intermediate (dS, P) moves a sum by up to a bf16 step of one term. On
float32 kernels (flash attention, the readout's fp32 table) 1e-4: summation
order only; the fp32 model end to end, kernel path against plain path, 1e-4
on responses, losses and gradients.
"""

import numpy as np
import pytest
import torch

from v1t_tpu_torch.ops.dropout import Dropout
from v1t_tpu_torch.ops.flash_attention import (
    flash_bwd, flash_bwd_plain, flash_fwd, flash_fwd_plain,
)
from v1t_tpu_torch.ops.fused_mha import fused_mha
from v1t_tpu_torch.ops.fused_mha import (
    attention, attention_bwd, attention_bwd_plain, attention_plain,
)
from v1t_tpu_torch.ops.interp_matmul import (
    bilinear_sample_cm, bilinear_sample_cm_bwd, bilinear_sample_cm_bwd_plain,
    bilinear_sample_cm_plain,
)
from v1t_tpu_torch.ops.ln_linear import (
    ln_linear, ln_linear_bwd, ln_linear_bwd_plain, ln_linear_plain, ln_linear_wgrad,
    ln_linear_wgrad_plain,
)

pytestmark = pytest.mark.cuda
TOL = 2e-2
F32_TOL = 1e-4
# the small model's training step, kernel path against the plain path:
# max|d| / max|ref| of every parameter's gradient, ~3x the reading on an
# H100 (2.1e-3: bf16 rounding flips carried through 2 blocks of a bf16
# residual stream)
GRAD_TOL = 6e-3


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.Generator().manual_seed(0)


def _randn(gen, *shape, scale=1.0, dtype=torch.bfloat16):
    return (torch.randn(*shape, generator=gen) * scale).to("cuda", dtype)


def _close(got, ref, tol=TOL):
    torch.cuda.synchronize()
    assert got.shape == ref.shape and got.dtype == ref.dtype
    got, ref = got.float(), ref.float()
    assert torch.isfinite(got).all()
    assert (got - ref).abs().max().item() <= tol * ref.abs().max().item() + 1e-6


def _drop(rate, site=3):
    return Dropout(rate, 12345, site) if rate else None


LN_CASES = [
    # (B, N, K, Nout, options)
    (1, 1, 7, 5, "ln"),
    (2, 65, 155, 130, "ln+row"),
    (1, 70, 488, 155, "bias+residual"),
    (3, 100, 640, 64, "bias+residual+row"),
    (2, 129, 33, 200, "ln+bias+gelu"),
    (2, 129, 155, 3 * 4 * 155, "ln+row+heads"),
    (1, 17, 48, 3 * 2 * 17, "ln+heads"),
    # the sweep's widths: out-projections of 8 heads of 155 and of 256, fc2
    # of a 768-wide MLP (panels of 640 columns), LayerNorms of 320 and 640
    (2, 70, 1240, 155, "bias+residual"),
    (1, 65, 2048, 256, "bias+residual+row"),
    (2, 50, 768, 200, "bias+residual"),
    (2, 40, 320, 100, "ln+bias+gelu"),
    (1, 33, 640, 64, "ln+row"),
    # no LayerNorm, rows not 16-byte aligned and wider than a panel: padded
    # to aligned rows by the wrapper, then streamed
    (2, 33, 1001, 64, "bias+residual"),
]


@pytest.mark.parametrize("b,n,k,nout,opts", LN_CASES, ids=lambda v: str(v))
def test_ln_linear_matches_plain(gen, b, n, k, nout, opts):
    x = _randn(gen, b, n, k)
    w = _randn(gen, nout, k, scale=k ** -0.5)
    kw = {}
    if "ln" in opts:
        kw["gamma"] = 1.0 + _randn(gen, k, scale=0.1, dtype=torch.float32)
        kw["beta"] = _randn(gen, k, scale=0.1, dtype=torch.float32)
    if "row" in opts and "ln" in opts:
        kw["pro_row"] = _randn(gen, b, k, scale=0.5)
    if "bias" in opts:
        kw["bias"] = _randn(gen, nout, scale=0.1, dtype=torch.float32)
    if "gelu" in opts:
        kw["gelu"] = True
    if "residual" in opts:
        kw["residual"] = _randn(gen, b, n, nout)
        if "row" in opts:
            kw["res_row"] = _randn(gen, b, nout, scale=0.5)
    if "heads" in opts:
        d = 155 if nout == 3 * 4 * 155 else 17
        kw["heads"] = (nout // (3 * d), d)
    _close(ln_linear(x, w, **kw), ln_linear_plain(x, w, **kw))


@pytest.mark.parametrize("b,n,h,d,lsa", [
    (1, 2, 1, 32, False), (2, 65, 3, 155, True), (1, 129, 2, 17, False),
    (2, 300, 1, 160, True), (1, 64, 2, 96, False), (3, 200, 2, 128, True),
    (2, 150, 2, 192, True), (1, 130, 3, 256, False),  # on the flash kernels
], ids=lambda v: str(v))
def test_attention_matches_plain(gen, b, n, h, d, lsa):
    x = _randn(gen, b, n, 48)
    w = _randn(gen, 3 * h * d, 48, scale=0.3)
    ones = torch.ones(48, device="cuda")
    qkv = ln_linear(x, w, gamma=ones, beta=ones * 0.0, heads=(h, d))
    scale = torch.full((h,), d ** -0.5, device="cuda")
    _close(attention(qkv, scale, d, use_lsa=lsa), attention_plain(qkv, scale, d, use_lsa=lsa))


# grid points exactly on the map's corners and edges, and outside it
EDGE_POINTS = [(-1.0, -1.0), (1.0, 1.0), (-1.0, 1.0), (1.0, -1.0), (0.0, 1.0), (1.0, 0.25),
               (-1.5, 0.2), (0.3, 1.7)]


def _sample_grid(gen, b, p):
    """(B, P, 2) points in [-1.5, 1.5] (some outside the map), the first
    ones on its corners and edges and outside it."""
    grid = torch.rand(b, p, 2, generator=gen) * 3.0 - 1.5
    k = min(p, len(EDGE_POINTS))
    grid[:, :k] = torch.tensor(EDGE_POINTS[:k])
    return grid.to("cuda")


@pytest.mark.parametrize("b,c,height,width,p", [
    (1, 1, 1, 2, 1), (3, 7, 5, 9, 1000), (2, 155, 29, 57, 37), (1, 3, 4, 1, 300),
    (2, 155, 29, 57, 7000),  # the flagship's map: 8 channels a block
    (2, 256, 29, 57, 1001),  # the sweep-widest's; P odd: scalar stores
    (3, 3, 29, 57, 515), (2, 11, 29, 57, 513),  # a partial block of 8 channels
    (2, 5, 60, 100, 998), (2, 5, 100, 100, 999),  # 4 and 2 channels a block
    (2, 155, 137, 249, 700),  # the full-resolution map: one channel a block
    (1, 3, 400, 300, 999),  # a channel past a block's shared memory: unstaged
], ids=lambda v: str(v))
def test_bilinear_sample_cm_matches_plain(gen, b, c, height, width, p):
    """bf16 tables under every forward plan (``sample_fwd_plan``): 8, 4, 2
    and 1 channels a block, a partial last block, and the unstaged gather;
    P neither a multiple of a block's 512 points nor even; points on the
    map's corners and edges and outside it."""
    from v1t_tpu_torch.ops.interp_matmul import sample_fwd_plan

    plan = sample_fwd_plan(c, height, width, torch.bfloat16)
    assert plan.staged == (height * width * 2 <= 232448)
    table = _randn(gen, b, c, height * width)
    grid = _sample_grid(gen, b, p)
    _close(bilinear_sample_cm(table, grid, height, width),
           bilinear_sample_cm_plain(table, grid, height, width))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
@pytest.mark.parametrize("b,c,height,width,p", [
    (2, 155, 29, 57, 7000), (2, 11, 29, 57, 513), (2, 155, 137, 249, 700), (1, 3, 400, 300, 999),
], ids=lambda v: str(v))
def test_bilinear_sample_cm_reruns_agree(gen, dtype, b, c, height, width, p):
    """No atomics: two launches on the same inputs give the same bits."""
    table = _randn(gen, b, c, height * width, dtype=dtype)
    grid = _sample_grid(gen, b, p)
    first = bilinear_sample_cm(table, grid, height, width)
    second = bilinear_sample_cm(table, grid, height, width)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def _small_model(precision):
    from v1t_tpu_torch.configs import Config
    from v1t_tpu_torch.data.cards import synthetic_data_card
    from v1t_tpu_torch.models import build_model

    config = Config(core="vit", readout="gaussian2d", behavior_mode=3, shift_mode=2,
                    precision=precision, resize_image=0, num_blocks=2, emb_dim=32,
                    num_heads=2, mlp_dim=64, batch_size=3, micro_batch_size=2)
    card = synthetic_data_card(mouse_ids=("A",), num_neurons=24, input_shape=(1, 36, 64))
    rng = np.random.default_rng(0)
    batch = {
        "image": rng.normal(size=(3, 1, 36, 64)).astype(np.float32),
        "behavior": rng.normal(size=(3, 3)).astype(np.float32),
        "pupil_center": rng.normal(size=(3, 2)).astype(np.float32),
    }
    return config, card, batch, build_model(config, card, seed=0, device="cuda")


def test_small_model_kernel_path_matches_plain_path(gen):
    from v1t_tpu_torch.models import build_model
    from v1t_tpu_torch.training import Trainer

    config, card, batch, model = _small_model("bf16")
    counts = (ln_linear.launches, attention.launches, bilinear_sample_cm.launches)
    preds = Trainer(config, model, card).predict("A", batch)
    launched = (ln_linear.launches - counts[0], attention.launches - counts[1],
                bilinear_sample_cm.launches - counts[2])
    assert launched == (2 * 4 * 2, 2 * 2, 2)  # 2 micro-batches
    plain_cfg = config.replace(attention_impl="xla", readout_impl="xla")
    plain = build_model(plain_cfg, card, seed=None, device="cuda")
    plain.load_state_dict(model.state_dict())
    ref = Trainer(plain_cfg, plain, card).predict("A", batch)
    assert np.isfinite(preds).all() and (preds > 0).all()
    assert np.abs(preds - ref).max() <= TOL * np.abs(ref).max()


def test_float32_model_runs_on_the_card(gen):
    """The fp32 model takes the composed path on the card: flash kernels for
    the attention core and the readout kernel on a float32 map, no fused
    sublayer; serving and a training step agree with the plain path."""
    from v1t_tpu_torch.models import build_model
    from v1t_tpu_torch.training import Trainer

    config, card, batch, model = _small_model("fp32")
    counters = (ln_linear, attention, flash_fwd, bilinear_sample_cm, ln_linear_bwd,
                ln_linear_wgrad, attention_bwd, flash_bwd, bilinear_sample_cm_bwd)
    before = [fn.launches for fn in counters]
    preds = Trainer(config, model, card).predict("A", batch)
    launched = [fn.launches - n for fn, n in zip(counters, before)]
    assert launched == [0, 0, 2 * 2, 2, 0, 0, 0, 0, 0]  # 2 micro-batches of 2 blocks
    plain_cfg = config.replace(attention_impl="xla", readout_impl="xla")
    plain = build_model(plain_cfg, card, seed=None, device="cuda")
    plain.load_state_dict(model.state_dict())
    ref = Trainer(plain_cfg, plain, card).predict("A", batch)
    assert np.isfinite(preds).all() and (preds > 0).all()
    assert np.abs(preds - ref).max() <= F32_TOL * np.abs(ref).max()
    batch["response"] = np.random.default_rng(1).poisson(2.0, (3, 24)).astype(np.float32)
    runs = []
    for cfg, m in ((config, model), (plain_cfg, plain)):
        before = [fn.launches for fn in counters]
        _, metrics = Trainer(cfg, m, card).train_step("A", batch, None, update=False)
        launched = [fn.launches - n for fn, n in zip(counters, before)]
        grads = {name: p.grad.clone() for name, p in m.named_parameters() if p.grad is not None}
        runs.append((float(metrics["loss/loss"]), grads, launched))
    # per micro-batch: 2 flash forwards and backwards, one sampling each way
    assert runs[0][2] == [0, 0, 2 * 2, 2, 0, 0, 0, 2 * 2, 2]
    assert not any(runs[1][2])
    assert abs(runs[0][0] - runs[1][0]) <= F32_TOL * abs(runs[1][0])
    for name, g_ in runs[0][1].items():
        r_ = runs[1][1][name]
        assert (g_ - r_).abs().max().item() <= F32_TOL * r_.abs().max().item() + 1e-9, name


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
@pytest.mark.parametrize("bh,heads,nq,nk,n_real,d,lsa,rate", [
    (2, 2, 4500, 4500, 4500, 155, False, 0.25),  # above the fused path's 4096 tokens
    (3, 3, 300, 300, 300, 24, True, 0.0),
    (2, 1, 200, 333, 250, 40, False, 0.5),  # rectangular, padded keys
    (2, 2, 129, 129, 129, 192, True, 0.25),
    (1, 1, 100, 100, 100, 256, False, 0.0),
    # every padded head width of the bf16 one-pass backward and the wgmma
    # forward, at lengths no multiple of 64 or 128, queries and keys apart
    (2, 2, 77, 77, 77, 32, True, 0.25),
    (2, 1, 190, 130, 100, 64, False, 0.0),
    (2, 2, 131, 259, 259, 96, False, 0.25),
    (1, 1, 333, 201, 180, 128, False, 0.5),
    (2, 2, 65, 65, 65, 160, True, 0.0),
    (2, 2, 257, 385, 300, 155, False, 0.25),
    (1, 1, 140, 140, 140, 224, False, 0.25),
    # the wide tiles (padded head widths 192-256: one q panel in the
    # forward, blocks of 64 keys in the backward) at ragged lengths,
    # rectangular with padded keys, LSA and dropout
    (1, 1, 65, 200, 130, 192, False, 0.0),
    (2, 1, 190, 300, 250, 200, False, 0.5),
    (2, 2, 333, 77, 70, 256, False, 0.25),
    (2, 2, 257, 257, 257, 256, True, 0.5),
    (4, 4, 1000, 1000, 1000, 230, True, 0.0),
], ids=lambda v: str(v))
def test_flash_attention_matches_plain(gen, dtype, bh, heads, nq, nk, n_real, d, lsa, rate):
    """Forward (o, LSE) and backward (dq, dk, dv, with an LSE cotangent)."""
    dp = -(-d // 32) * 32

    def operand(n):
        x = torch.zeros(bh, n, dp, dtype=dtype, device="cuda")
        x[..., :d] = _randn(gen, bh, n, d, dtype=dtype) * (d ** -0.25)
        return x

    q, k, v = operand(nq), operand(nk), operand(nk)
    drop = _drop(rate, site=6)
    kw = dict(n_real_k=n_real, use_lsa=lsa, drop=drop)
    tol = TOL if dtype == torch.bfloat16 else F32_TOL
    o, lse = flash_fwd(q, k, v, d, heads, with_lse=True, **kw)
    o_ref, lse_ref = flash_fwd_plain(q, k, v, d, heads, with_lse=True, **kw)
    _close(o, o_ref, tol)
    _close(lse, lse_ref, F32_TOL)
    do = _randn(gen, *o.shape, dtype=dtype)
    dlse = _randn(gen, bh, nq, scale=0.5, dtype=torch.float32)
    got = flash_bwd(q, k, v, o_ref, do, lse_ref, d, heads, dlse=dlse, **kw)
    ref = flash_bwd_plain(q, k, v, o_ref, do, lse_ref, d, heads, dlse=dlse, **kw)
    for g_, r_ in zip(got, ref):  # dq, dk, dv
        _close(g_, r_, tol)
        assert torch.all(g_[..., d:] == 0)
    assert torch.all(got[1][:, n_real:] == 0) and torch.all(got[2][:, n_real:] == 0)


def test_flash_backward_reruns_agree(gen):
    """The bf16 backward adds dq's partial sums from its key blocks with
    atomics in no fixed order: two runs on the same inputs agree within the
    kernel tolerance on dq, and exactly on dk and dv (one block each)."""
    bh, heads, n, d = 2, 2, 1000, 155
    q, k, v = (torch.zeros(bh, n, 160, dtype=torch.bfloat16, device="cuda") for _ in range(3))
    for x in (q, k, v):
        x[..., :d] = _randn(gen, bh, n, d) * (d ** -0.25)
    drop = _drop(0.25, site=7)
    o, lse = flash_fwd(q, k, v, d, heads, with_lse=True, drop=drop)
    do = _randn(gen, *o.shape)
    first = flash_bwd(q, k, v, o, do, lse, d, heads, drop=drop)
    second = flash_bwd(q, k, v, o, do, lse, d, heads, drop=drop)
    _close(second[0], first[0], TOL)
    assert torch.equal(second[1], first[1]) and torch.equal(second[2], first[2])


def test_attention_backward_reruns_agree(gen):
    """dq and dscale are float32 sums that the one pass's key blocks add
    with atomics in no fixed order: two runs on the same inputs agree within
    the kernel tolerance on them, and exactly on dk and dv (one block
    each)."""
    b, n, h, d = 2, 1000, 2, 155
    qkv = ln_linear(_randn(gen, b, n, 48), _randn(gen, 3 * h * d, 48, scale=0.3),
                    gamma=torch.ones(48, device="cuda"),
                    beta=torch.zeros(48, device="cuda"), heads=(h, d))
    scale = torch.full((h,), d ** -0.5, device="cuda")
    drop = _drop(0.25, site=5)
    o, lse = attention(qkv, scale, d, drop=drop, with_lse=True)
    do = _randn(gen, b, n, h * d)
    (first, ds1), (second, ds2) = (attention_bwd(qkv, o, do, lse, scale, d, drop=drop)
                                   for _ in range(2))
    _close(second[0], first[0])
    _close(ds2, ds1)
    assert torch.equal(second[1:], first[1:])


def test_flash_backward_float32_reruns_agree(gen):
    """The float32 pass adds dq's partial sums with atomics in no fixed
    order: two runs agree within the float32 tolerance on dq, and exactly on
    dk and dv."""
    bh, heads, n, d = 2, 2, 1000, 155
    q, k, v = (torch.zeros(bh, n, 160, device="cuda") for _ in range(3))
    for x in (q, k, v):
        x[..., :d] = _randn(gen, bh, n, d, dtype=torch.float32) * d ** -0.25
    drop = _drop(0.25, site=9)
    o, lse = flash_fwd(q, k, v, d, heads, with_lse=True, drop=drop)
    do = _randn(gen, *o.shape, dtype=torch.float32)
    first = flash_bwd(q, k, v, o, do, lse, d, heads, drop=drop)
    second = flash_bwd(q, k, v, o, do, lse, d, heads, drop=drop)
    _close(second[0], first[0], F32_TOL)
    assert torch.equal(second[1], first[1]) and torch.equal(second[2], first[2])


@pytest.mark.parametrize("e,h", [(192, 2), (200, 4), (256, 8)], ids=str)
def test_fused_mha_wide_heads_match_plain(gen, e, h):
    """The sublayer at the sweep's widest heads (192, 200 and 256, padded to
    192, 224 and 256; 8 of 256 is an out-projection K of 2048), forward and
    backward, dropout on."""
    b, n = 2, 150
    x = _randn(gen, b, n, e).requires_grad_()
    gamma = 1.0 + _randn(gen, e, scale=0.1, dtype=torch.float32)
    beta = _randn(gen, e, scale=0.1, dtype=torch.float32)
    wqkv = _randn(gen, 3 * h * e, e, scale=e ** -0.5)
    wp = _randn(gen, e, h * e, scale=(h * e) ** -0.5)
    bp = _randn(gen, e, scale=0.1, dtype=torch.float32)
    row = _randn(gen, b, e, scale=0.5)
    dout = _randn(gen, b, n, e)
    leaves = [gamma, beta, wqkv, wp, bp]
    results = []
    for plain in (False, True):
        xs = x.detach().clone().requires_grad_()
        ws = [w.detach().clone().requires_grad_() for w in leaves]
        out = fused_mha(xs, *ws, e ** -0.5, num_heads=h, fold_residual=True, bias_row=row,
                        drop_p=_drop(0.25, 1), drop_o=_drop(0.25, 2), plain=plain)
        out.backward(dout)
        results.append([out, xs.grad] + [w.grad for w in ws])
    for got, ref in zip(*results):
        _close(got, ref)


@pytest.mark.parametrize("b,c,height,width,p", [
    (2, 155, 137, 249, 300), (1, 3, 4, 1, 50),
    (2, 155, 29, 57, 7000),  # the fp32 model's map: 4 channels a word
    (1, 11, 29, 57, 333),  # a partial block of 4 channels; P odd
    (1, 5, 60, 100, 401),  # 2 channels a block
    (1, 2, 250, 250, 401),  # a channel past a block's shared memory: unstaged
], ids=lambda v: str(v))
def test_bilinear_sample_cm_float32_matches_plain(gen, b, c, height, width, p):
    """A float32 table (the fp32 model's map; 137 x 249 the full-resolution
    one, past the TPU kernel's 4096-row cap, one channel a block; 250 x 250
    past a block's shared memory), forward and backward; points on the
    map's corners and edges and outside it."""
    table = _randn(gen, b, c, height * width, dtype=torch.float32)
    grid = _sample_grid(gen, b, p)
    _close(bilinear_sample_cm(table, grid, height, width),
           bilinear_sample_cm_plain(table, grid, height, width), F32_TOL)
    dout = _randn(gen, b, c, p, dtype=torch.float32)
    for got, ref in zip(bilinear_sample_cm_bwd(table, grid, dout, height, width),
                        bilinear_sample_cm_bwd_plain(table, grid, dout, height, width)):
        _close(got, ref, F32_TOL)


@pytest.mark.parametrize("rate", [0.0, 0.5])
@pytest.mark.parametrize("b,n,k,nout,opts", [
    (1, 1, 7, 5, "ln+gelu+pre"), (2, 65, 155, 488, "ln+bias+gelu+pre"),
    (3, 100, 620, 155, "bias+residual+row"), (1, 70, 488, 155, "bias+residual"),
], ids=lambda v: str(v))
def test_ln_linear_training_matches_plain(gen, rate, b, n, k, nout, opts):
    x = _randn(gen, b, n, k)
    w = _randn(gen, nout, k, scale=k ** -0.5)
    kw = {"drop": _drop(rate)}
    if "ln" in opts:
        kw["gamma"] = 1.0 + _randn(gen, k, scale=0.1, dtype=torch.float32)
        kw["beta"] = _randn(gen, k, scale=0.1, dtype=torch.float32)
    if "bias" in opts:
        kw["bias"] = _randn(gen, nout, scale=0.1, dtype=torch.float32)
    if "gelu" in opts:
        kw["gelu"] = True
    if "residual" in opts:
        kw["residual"] = _randn(gen, b, n, nout)
        if "row" in opts:
            kw["res_row"] = _randn(gen, b, nout, scale=0.5)
    if "pre" in opts:
        kw["save_pre"] = True
        (y, pre), (y_ref, pre_ref) = ln_linear(x, w, **kw), ln_linear_plain(x, w, **kw)
        _close(pre, pre_ref)
        # the same keep mask: the dropped elements are exactly the zeros
        assert torch.equal(y == 0, y_ref == 0)
    else:
        y, y_ref = ln_linear(x, w, **kw), ln_linear_plain(x, w, **kw)
    _close(y, y_ref)


@pytest.mark.parametrize("rate", [0.0, 0.5])
@pytest.mark.parametrize("b,n,h,d,lsa", [
    (1, 2, 1, 32, False), (2, 65, 3, 155, True), (1, 129, 2, 17, False),
    (2, 300, 1, 160, True), (1, 64, 2, 96, False), (3, 200, 2, 128, True),
    # the flagship's head width at lengths around the one pass's blocks of
    # 128 keys and query tiles of 64
    (2, 1, 2, 155, False), (2, 1, 2, 155, True), (2, 63, 2, 155, True), (1, 63, 2, 155, False),
    (2, 65, 2, 155, False), (1, 129, 2, 155, True), (1, 1654, 2, 155, True),
    (1, 1654, 2, 155, False),
    (2, 150, 2, 192, True), (1, 130, 3, 256, False),  # on the flash kernels
    (1, 100, 2, 200, True), (2, 1, 2, 256, True),
], ids=lambda v: str(v))
def test_attention_training_and_backward_match_plain(gen, rate, b, n, h, d, lsa):
    x = _randn(gen, b, n, 48)
    w = _randn(gen, 3 * h * d, 48, scale=0.3)
    ones = torch.ones(48, device="cuda")
    qkv = ln_linear(x, w, gamma=ones, beta=ones * 0.0, heads=(h, d))
    scale = torch.full((h,), d ** -0.5, device="cuda") * (1.0 + 0.2 * torch.rand(h, generator=gen)).cuda()
    drop = _drop(rate, site=1)
    o, lse = attention(qkv, scale, d, use_lsa=lsa, drop=drop, with_lse=True)
    o_ref, lse_ref = attention_plain(qkv, scale, d, use_lsa=lsa, drop=drop, with_lse=True)
    _close(o, o_ref)
    _close(lse, lse_ref)
    do = _randn(gen, b, n, h * d)
    dqkv, dscale = attention_bwd(qkv, o_ref, do, lse_ref, scale, d, use_lsa=lsa, drop=drop)
    dqkv_ref, dscale_ref = attention_bwd_plain(qkv, o_ref, do, lse_ref, scale, d, use_lsa=lsa,
                                               drop=drop)
    assert torch.all(dqkv[..., d:] == 0)
    if n == 1:
        # one key: P = 1 and the softmax has no gradient. dq, dk and dscale
        # are then float32 rounding on both sides (dS = P (dP - delta), two
        # sums of the same products in other orders), so they are held to
        # the size of the one real cotangent, dv = dO, not to each other
        _close(dqkv[2], dqkv_ref[2])
        size = dqkv_ref[2].float().abs().max().item()
        assert dqkv[:2].float().abs().max().item() <= TOL * size
        assert dscale.abs().max().item() <= TOL * size * qkv[0].float().abs().sum(-1).max().item()
        return
    for i in range(3):  # dq, dk, dv
        _close(dqkv[i], dqkv_ref[i])
    _close(dscale, dscale_ref)


@pytest.mark.parametrize("rate", [0.0, 0.5])
@pytest.mark.parametrize("b,n,k,nout,opts", [
    (1, 1, 5, 7, "plain"), (2, 65, 620, 155, "plain"), (3, 100, 640, 33, "plain"),
    (2, 129, 488, 155, "gelu"), (1, 70, 155, 488, "ln+res"),
    (2, 65, 155, 3 * 4 * 155, "ln+heads+row+res"), (1, 17, 48, 3 * 2 * 17, "ln+heads"),
    # the sweep's widths: the out-projection's dX at K = 2048, fc2's at a
    # 768-wide MLP, the LayerNorm backward at K = 320 and 640
    (2, 65, 2048, 155, "plain"), (2, 40, 768, 155, "gelu"), (1, 70, 320, 640, "ln+res"),
    (1, 33, 640, 96, "ln+row+res"),
], ids=lambda v: str(v))
def test_ln_linear_backward_matches_plain(gen, rate, b, n, k, nout, opts):
    w = _randn(gen, nout, k, scale=nout ** -0.5)
    heads = None
    if "heads" in opts:
        d = 155 if nout == 3 * 4 * 155 else 17
        heads = (nout // (3 * d), d)
        dy = ln_linear(_randn(gen, b, n, 32), _randn(gen, nout, 32, scale=0.3), heads=heads)
    else:
        dy = _randn(gen, b, n, nout)
    kw = {"heads": heads, "drop": None if heads else _drop(rate, site=2)}
    if "gelu" in opts:
        kw.update(pre=_randn(gen, b, n, k), pre_drop=_drop(rate, site=5))
    if "ln" in opts:
        kw.update(x=_randn(gen, b, n, k), gamma=1.0 + _randn(gen, k, scale=0.1, dtype=torch.float32),
                  beta=_randn(gen, k, scale=0.1, dtype=torch.float32))
        if "row" in opts:
            kw["pro_row"] = _randn(gen, b, k, scale=0.5)
        if "res" in opts:
            kw["dres"] = _randn(gen, b, n, k)
    got, ref = ln_linear_bwd(dy, w, **kw), ln_linear_bwd_plain(dy, w, **kw)
    if "ln" not in opts:
        _close(got, ref)
    else:
        for g_, r_ in zip(got, ref):
            if r_ is None:
                assert g_ is None
            else:
                _close(g_, r_)
    a = _randn(gen, b, n, k)
    for bias in (False, True):
        kw_w = {"heads": heads, "drop": kw["drop"], "bias": bias and heads is None}
        (dw, db), (dw_ref, db_ref) = ln_linear_wgrad(dy, a, **kw_w), ln_linear_wgrad_plain(dy, a, **kw_w)
        _close(dw, dw_ref)
        if kw_w["bias"]:
            _close(db, db_ref)
        else:
            assert db is None


@pytest.mark.parametrize("b,h,d", [(2, 2, 155), (1, 4, 155), (3, 1, 32), (2, 3, 17)], ids=str)
def test_attention_all_masked_row_matches_plain(gen, b, h, d):
    """LSA at N 1 masks a row's only key: the row-1 kernel gives it P = 1,
    o = v and the plain version's LSE (the key tile's zero fill past N
    weighs nothing), serving and training, o's pad columns zero."""
    x = _randn(gen, b, 1, 48)
    qkv = ln_linear(x, _randn(gen, 3 * h * d, 48, scale=0.3), gamma=torch.ones(48, device="cuda"),
                    beta=torch.zeros(48, device="cuda"), heads=(h, d))
    scale = torch.full((h,), d ** -0.5, device="cuda")
    o, lse = attention(qkv, scale, d, use_lsa=True, with_lse=True)
    o_ref, lse_ref = attention_plain(qkv, scale, d, use_lsa=True, with_lse=True)
    v = qkv[2, :, :, 0, :d].reshape(b, h * d)  # (B, H*D) of the row's only key
    torch.cuda.synchronize()
    assert torch.equal(o[:, 0, :h * d], v) and torch.equal(o_ref[:, 0, :h * d], v)
    assert torch.all(o[..., h * d:] == 0)
    assert torch.equal(lse, lse_ref)
    assert torch.equal(attention(qkv, scale, d, use_lsa=True), o)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
@pytest.mark.parametrize("b,c,height,width,p", [
    (2, 3, 300, 300, 1001),  # two bands of 150 rows
    (1, 2, 1000, 64, 777),  # two bands of 500 rows
    (2, 37, 29, 57, 513),  # 5 chunks of 8 channels, the last of 5, the table staged
], ids=lambda v: str(v))
def test_bilinear_sample_cm_backward_bands_match_plain(gen, dtype, b, c, height, width, p):
    """The sampling backward's launch plans past the flagship's: maps whose
    float32 d(table) channel does not fit a block's shared memory go in row
    bands (corners on both sides of a band's edge), and chunks of channels
    that do not divide C; P no multiple of the block's 512 threads, points
    outside the map (all corners, and some), bf16 and float32 tables."""
    from v1t_tpu_torch.ops.interp_matmul import sample_bwd_plan

    plan = sample_bwd_plan(c, height, width)
    assert (plan.bands > 1) == (height * width * 4 > 232448)
    table = _randn(gen, b, c, height * width, dtype=dtype)
    grid = (torch.rand(b, p, 2, generator=gen) * 2.4 - 1.2).to("cuda")
    grid[:, :4] = torch.tensor([[-1.5, 0.0], [0.0, 1.6], [1.0, 1.0], [-1.0, -1.0]], device="cuda")
    # rows on either side of the first band's last row
    y = (2.0 * (plan.band_rows - 1) + torch.rand(p - 4, generator=gen) * 2.0 - 1.0) / (height - 1)
    grid[0, 4:, 1] = (y - 1.0).to("cuda")
    dout = _randn(gen, b, c, p, dtype=dtype)
    got = bilinear_sample_cm_bwd(table, grid, dout, height, width)
    ref = bilinear_sample_cm_bwd_plain(table, grid, dout, height, width)
    assert got[0].dtype == dtype and got[1].dtype == torch.float32
    for g_, r_ in zip(got, ref):
        _close(g_, r_, TOL if dtype == torch.bfloat16 else F32_TOL)


@pytest.mark.parametrize("b,c,height,width,p", [
    (1, 1, 1, 2, 1), (3, 7, 5, 9, 1000), (2, 155, 29, 57, 37), (1, 3, 4, 1, 300),
], ids=lambda v: str(v))
def test_bilinear_sample_cm_backward_matches_plain(gen, b, c, height, width, p):
    table = _randn(gen, b, c, height * width)
    grid = (torch.rand(b, p, 2, generator=gen) * 3.0 - 1.5).to("cuda")
    dout = _randn(gen, b, c, p)
    for got, ref in zip(bilinear_sample_cm_bwd(table, grid, dout, height, width),
                        bilinear_sample_cm_bwd_plain(table, grid, dout, height, width)):
        _close(got, ref)


def test_small_model_training_step_matches_plain_path(gen):
    """Two train steps of the small model, dropout on, through the kernels
    and through the plain path: the losses and the first step's gradients
    agree, and every backward kernel was launched."""
    from v1t_tpu_torch.models import build_model
    from v1t_tpu_torch.training import Trainer

    config, card, batch, model = _small_model("bf16")  # the flagship's dropout rates
    assert config.t_dropout > 0.0 and config.p_dropout > 0.0
    batch["response"] = np.random.default_rng(1).poisson(2.0, (3, 24)).astype(np.float32)
    plain_cfg = config.replace(attention_impl="xla", readout_impl="xla")
    plain = build_model(plain_cfg, card, seed=None, device="cuda")
    plain.load_state_dict(model.state_dict())
    counters = (ln_linear_bwd, ln_linear_wgrad, attention_bwd, bilinear_sample_cm_bwd)
    before = [fn.launches for fn in counters]
    runs = []
    for cfg, m in ((config, model), (plain_cfg, plain)):
        trainer = Trainer(cfg, m, card)
        acc, metrics = trainer.train_step("A", batch, None, update=False)
        grads = {name: p.grad.clone() for name, p in m.named_parameters() if p.grad is not None}
        runs.append((metrics["loss/loss"], grads))
    assert all(fn.launches > n for fn, n in zip(counters, before))
    (loss, grads), (loss_ref, grads_ref) = runs
    assert abs(loss - loss_ref) <= TOL * abs(loss_ref)
    assert grads.keys() == grads_ref.keys()
    worst = 0.0
    for name, g_ in grads.items():
        r_ = grads_ref[name]
        assert torch.isfinite(g_).all(), name
        rel = (g_ - r_).abs().max().item() / max(r_.abs().max().item(), 1e-30)
        worst = max(worst, rel)
        assert rel <= GRAD_TOL, (name, rel)
    print(f"worst gradient max|d|/max|ref| {worst:.3e}")


# the float32 kernels against their plain versions: summation order only
# (chip_smoke.py's F32_KERNEL_TOL)
F32_KERNEL_TOL = 2e-5


@pytest.mark.parametrize("lsa", [False, True], ids=["no_lsa", "lsa"])
@pytest.mark.parametrize("n", [1, 63, 65, 129, 1654])
@pytest.mark.parametrize("d", [27, 64, 90, 128, 155, 190, 224, 256])
def test_flash_forward_float32_matches_plain(gen, d, n, lsa):
    """The float32 forward at every padded head width (32-256), lengths
    that fill no tile of 32 keys or of 128 (64) queries, with and without
    LSA, with dropout and the LSE: o and the LSE within the float32
    tolerance, and the keep mask bit for bit (q = 0 makes every probability
    1 / N and v[k] = e_(k mod D) makes o count the kept keys of each
    residue class: exact small integers times one scale)."""
    bh, heads = 2, 2
    dp = -(-d // 32) * 32
    drop = _drop(0.25, site=11)

    def operand():
        x = torch.zeros(bh, n, dp, device="cuda")
        x[..., :d] = _randn(gen, bh, n, d, dtype=torch.float32) * d ** -0.25
        return x

    q, k, v = operand(), operand(), operand()
    for drp in (None, drop):
        kw = dict(use_lsa=lsa, drop=drp)
        (o, lse), (o_ref, lse_ref) = (fn(q, k, v, d, heads, with_lse=True, **kw)
                                      for fn in (flash_fwd, flash_fwd_plain))
        _close(o, o_ref, F32_KERNEL_TOL)
        _close(lse, lse_ref, F32_KERNEL_TOL)
        _close(flash_fwd(q, k, v, d, heads, **kw), o_ref, F32_KERNEL_TOL)  # serving
    zero = torch.zeros_like(q)
    onehot = torch.zeros_like(v)
    keys = torch.arange(n, device="cuda")
    onehot[:, keys, keys % d] = 1.0
    got = flash_fwd(zero, zero, onehot, d, heads, use_lsa=lsa, drop=drop)
    ref = flash_fwd_plain(zero, zero, onehot, d, heads, use_lsa=lsa, drop=drop)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)


def test_flash_forward_float32_rectangular_matches_plain(gen):
    """Queries and keys apart, keys past n_real_k masked, at the flagship's
    head width."""
    bh, heads, nq, nk, n_real, d = 4, 2, 300, 1000, 777, 155
    q, k, v = (torch.zeros(bh, n, 160, device="cuda") for n in (nq, nk, nk))
    for x in (q, k, v):
        x[..., :d] = _randn(gen, bh, x.shape[1], d, dtype=torch.float32) * d ** -0.25
    kw = dict(n_real_k=n_real, drop=_drop(0.5, site=12))
    for got, ref in zip(flash_fwd(q, k, v, d, heads, with_lse=True, **kw),
                        flash_fwd_plain(q, k, v, d, heads, with_lse=True, **kw)):
        _close(got, ref, F32_KERNEL_TOL)


def _offset(x):
    """x as a contiguous view that starts 2 bytes past a 16-byte boundary."""
    buf = torch.empty(x.numel() + 8, dtype=x.dtype, device=x.device)
    y = buf[1:1 + x.numel()].view(x.shape)
    y.copy_(x)
    assert y.data_ptr() % 16 == 2
    return y


def _dx_case(gen, use, b, n, k, nout, rate, head_dim=None, row=True, res=True):
    """dy, w and ln_linear_bwd's keywords for one use of the dX kernel:
    out_proj / fc2 (row-major dy, keep mask; fc2 with fc1's pre-GELU
    activation and mask), qkv (head-major dy as ln_linear writes it,
    LayerNorm epilogue), fc1 (row-major dy, LayerNorm epilogue)."""
    w = _randn(gen, nout, k, scale=nout ** -0.5)
    kw = {}
    if use == "qkv":
        heads = (nout // (3 * head_dim), head_dim)
        dy = ln_linear(_randn(gen, b, n, 32), _randn(gen, nout, 32, scale=0.3), heads=heads)
        kw["heads"] = heads
    else:
        dy = _randn(gen, b, n, nout)
    if use in ("out_proj", "fc2"):
        kw["drop"] = _drop(rate, site=2)
    if use == "fc2":
        kw.update(pre=_randn(gen, b, n, k), pre_drop=_drop(rate, site=5))
    if use in ("qkv", "fc1"):
        kw.update(x=_randn(gen, b, n, k), gamma=1.0 + _randn(gen, k, scale=0.1, dtype=torch.float32),
                  beta=_randn(gen, k, scale=0.1, dtype=torch.float32))
        if row:
            kw["pro_row"] = _randn(gen, b, k, scale=0.5)
        if res:
            kw["dres"] = _randn(gen, b, n, k)
    return dy, w, kw


def _check_dx(dy, w, kw):
    got, ref = ln_linear_bwd(dy, w, **kw), ln_linear_bwd_plain(dy, w, **kw)
    if "x" not in kw:
        _close(got, ref)
        return
    for g_, r_ in zip(got, ref):
        if r_ is None:
            assert g_ is None
        else:
            _close(g_, r_)


@pytest.mark.parametrize("offset", [False, True], ids=["aligned", "offset"])
@pytest.mark.parametrize("use,nout,k", [
    ("out_proj", 155, 620), ("fc2", 155, 488), ("fc1", 488, 155), ("qkv", 3 * 4 * 155, 155),
])
@pytest.mark.parametrize("b,n", [(2, 65), (3, 1654), (1, 1)], ids=str)
def test_ln_linear_dx_uses_match_plain(gen, b, n, use, nout, k, offset):
    """The four uses of a block at the flagship's widths, at row counts that
    fill no block of 128 (130, 4962, 1), dropout on; row-major dy also from
    a start 2 bytes past a 16-byte boundary, so that every slab starts
    unaligned (a head-major dy must start aligned)."""
    dy, w, kw = _dx_case(gen, use, b, n, k, nout, 0.25, head_dim=155)
    if offset and use == "qkv":
        with pytest.raises(ValueError):
            ln_linear_bwd(_offset(dy.reshape(-1)).view(dy.shape), w, **kw)
        return
    _check_dx(_offset(dy) if offset else dy, w, kw)


@pytest.mark.parametrize("rate", [0.0, 0.5])
@pytest.mark.parametrize("nout,k", [
    (155, 32), (155, 100), (155, 160), (155, 161), (96, 320), (33, 640), (640, 96), (1001, 155),
    (3001, 320),
], ids=str)
def test_ln_linear_dx_widths_match_plain(gen, nout, k, rate):
    """The plain epilogue from K 32 to 640 (one, two and four output tiles),
    over reductions that are aligned (96, 640) or not (33, 155, 1001, 3001;
    3001 is too wide to stay in shared memory across two output tiles, so
    dY streams once per tile), with and without fc1's mask and GELU'."""
    for use in ("out_proj", "fc2"):
        dy, w, kw = _dx_case(gen, use, 2, 129, k, nout, rate)
        _check_dx(dy, w, kw)


@pytest.mark.parametrize("row,res", [(False, False), (True, False), (False, True), (True, True)])
@pytest.mark.parametrize("use,k,nout,head_dim", [
    ("fc1", 155, 488, None), ("fc1", 320, 640, None), ("fc1", 640, 96, None),
    ("fc1", 640, 155, None), ("qkv", 155, 3 * 4 * 155, 155), ("qkv", 192, 3 * 2 * 192, 192),
    ("qkv", 256, 3 * 8 * 256, 256), ("qkv", 48, 3 * 2 * 17, 17),
], ids=str)
def test_ln_linear_dx_layernorm_matches_plain(gen, use, k, nout, head_dim, row, res):
    """The LayerNorm epilogue with and without pro_row and dres, K from 48
    to 640, head widths 17 to 256 (a K above 160 takes two or four output
    tiles; 640 takes blocks of 64 rows)."""
    dy, w, kw = _dx_case(gen, use, 2, 65, k, nout, 0.0, head_dim=head_dim, row=row, res=res)
    _check_dx(dy, w, kw)


def test_ln_linear_dx_reruns_agree(gen):
    """The LayerNorm epilogue adds dgamma, dbeta and dbias_row with fp32
    atomics in no fixed order: two runs agree within the kernel tolerance on
    them, and exactly on dz and the LayerNorm output (one row, one warp)."""
    dy, w, kw = _dx_case(gen, "qkv", 3, 700, 155, 3 * 4 * 155, 0.0, head_dim=155)
    first, second = (ln_linear_bwd(dy, w, **kw) for _ in range(2))
    assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])
    for g_, r_ in zip(second[2:], first[2:]):
        _close(g_, r_)


def test_attention_backward_pads_stay_zero_for_the_dx_kernel(gen):
    """The dX kernel reads a head-major dq/dk/dv as it lies, its pad
    columns against zero rows of W^T: 0 x NaN would poison dX, so
    attention_bwd must leave exact zeros past D, and dX over its output must
    be finite and match the plain version."""
    b, n, h, d = 2, 300, 4, 155
    x = _randn(gen, b, n, d)
    gamma = torch.ones(d, device="cuda")
    qkv = ln_linear(x, _randn(gen, 3 * h * d, d, scale=0.08), gamma=gamma, beta=gamma * 0.0,
                    heads=(h, d))
    scale = torch.full((h,), d ** -0.5, device="cuda")
    o, lse = attention(qkv, scale, d, with_lse=True)
    dqkv, _ = attention_bwd(qkv, o, _randn(gen, b, n, h * d), lse, scale, d)
    torch.cuda.synchronize()
    assert torch.all(dqkv[..., d:] == 0)
    w = _randn(gen, 3 * h * d, d, scale=0.05)
    kw = dict(heads=(h, d), x=x, gamma=gamma, beta=gamma * 0.0)
    _check_dx(dqkv, w, kw)


def test_launch_plans_match_the_library(gen):
    """ops/ln_linear.py dx_plan, ops/flash_attention.py fwd_plan and
    bwd_plan and ops/interp_matmul.py sample_fwd_plan and sample_bwd_plan
    mirror the plans compiled into the kernels: the same shared memory a
    block (and the sampling kernels' groups, channels, bands and chunks)."""
    from v1t_tpu_torch import _build
    from v1t_tpu_torch.ops.flash_attention import bwd_plan, fwd_plan
    from v1t_tpu_torch.ops.ln_linear import dx_plan

    from v1t_tpu_torch.ops.interp_matmul import sample_bwd_plan, sample_fwd_plan

    lib = _build.library()
    for dp in range(32, 257, 32):
        for dtype, f32 in ((torch.bfloat16, 0), (torch.float32, 1)):
            assert lib.v1t_flash_attention_smem(dp, f32) == fwd_plan(dtype, dp).smem
            assert lib.v1t_flash_attention_bwd_smem(dp, f32) == bwd_plan(dtype, 1, 1, dp).smem
    for c, height, width in ((155, 29, 57), (155, 137, 249), (3, 300, 300), (7, 1, 2),
                             (2, 1000, 64), (37, 29, 57), (1, 3, 58112)):
        plan = sample_bwd_plan(c, height, width)
        assert [lib.v1t_bilinear_sample_cm_bwd_plan(c, height, width, f)
                for f in range(6)] == list(plan)
    for c, height, width in ((155, 29, 57), (256, 29, 57), (155, 137, 249), (7, 1, 2),
                             (11, 29, 57), (5, 60, 100), (5, 100, 100), (3, 400, 300),
                             (2, 250, 250), (1, 341, 341)):
        for f32, dtype in ((0, torch.bfloat16), (1, torch.float32)):
            plan = sample_fwd_plan(c, height, width, dtype)
            assert [lib.v1t_bilinear_sample_cm_plan(c, height, width, f32, f)
                    for f in range(4)] == list(plan)
    for k in (1, 32, 155, 160, 161, 320, 488, 620, 640, 2048):
        for ns in (32, 96, 160, 512, 640, 1920, 6144):
            for aligned in (0, 1):
                for ln in (0, 1) if k <= 640 else (0,):
                    plan = dx_plan(k, ns, bool(aligned), bool(ln))
                    assert lib.v1t_ln_linear_dx_smem(k, ns, aligned, ln) == plan.smem


# the sweep space (configs/sweep_v1t.yaml): emb, heads, MLP width
SWEEP = [(e, h, f) for e in (64, 155, 256) for h in (2, 8) for f in (128, 487, 768)]


@pytest.mark.parametrize("rate", [0.0, 0.5])
@pytest.mark.parametrize("emb,heads,mlp", SWEEP, ids=str)
def test_projection_kernels_cover_the_sweep(gen, emb, heads, mlp, rate):
    """The forward (a resident LayerNorm panel, an unaligned panel or a
    streamed x) and the weight gradient (TMA, whole-row spans, row segments)
    at every width of the sweep space, the four projections of a block with
    their dropout, over 2 x 67 rows (no multiple of 64 or 128)."""
    b, n = 2, 67
    drop = _drop(rate, site=4)
    d = emb
    x = _randn(gen, b, n, emb)
    gamma = 1.0 + _randn(gen, emb, scale=0.1, dtype=torch.float32)
    beta = _randn(gen, emb, scale=0.1, dtype=torch.float32)
    row = _randn(gen, b, emb, scale=0.5)
    wqkv = _randn(gen, 3 * heads * d, emb, scale=emb ** -0.5)
    wp = _randn(gen, emb, heads * d, scale=(heads * d) ** -0.5)
    w1 = _randn(gen, mlp, emb, scale=emb ** -0.5)
    w2 = _randn(gen, emb, mlp, scale=mlp ** -0.5)
    bias = {k_: _randn(gen, k_, scale=0.1, dtype=torch.float32) for k_ in (emb, mlp)}
    o = _randn(gen, b, n, heads * d)
    hid = _randn(gen, b, n, mlp)
    forward = {
        "qkv": (x, wqkv, dict(gamma=gamma, beta=beta, pro_row=row, heads=(heads, d))),
        "out_proj": (o, wp, dict(bias=bias[emb], residual=x, res_row=row, drop=drop)),
        "fc1": (x, w1, dict(gamma=gamma, beta=beta, bias=bias[mlp], gelu=True, drop=drop,
                            save_pre=True)),
        "fc2": (hid, w2, dict(bias=bias[emb], residual=x, drop=drop)),
    }
    for use, (xx, ww, kw) in forward.items():
        got, ref = ln_linear(xx, ww, **kw), ln_linear_plain(xx, ww, **kw)
        for g_, r_ in zip(*((got, ref) if kw.get("save_pre") else ((got,), (ref,)))):
            _close(g_, r_)
    qkv = ln_linear(x, wqkv, gamma=gamma, beta=beta, heads=(heads, d))
    wgrad = {
        "out_proj": (_randn(gen, b, n, emb), o, dict(drop=drop, bias=True)),
        "qkv": (qkv, _randn(gen, b, n, emb), dict(heads=(heads, d))),
        "fc2": (_randn(gen, b, n, emb), hid, dict(drop=drop, bias=True)),
        "fc1": (_randn(gen, b, n, mlp), _randn(gen, b, n, emb), dict(bias=True)),
    }
    for use, (dy, a, kw) in wgrad.items():
        (dw, db), (dw_ref, db_ref) = ln_linear_wgrad(dy, a, **kw), ln_linear_wgrad_plain(dy, a, **kw)
        _close(dw, dw_ref)
        if db_ref is not None:
            _close(db, db_ref)


@pytest.mark.parametrize("b,n", [(1, 1), (1, 65), (2, 129), (2, 1000)], ids=str)
@pytest.mark.parametrize("nout,k", [(155, 620), (155, 488), (488, 155), (33, 70)], ids=str)
def test_ln_linear_wgrad_offset_operands_match_plain(gen, b, n, nout, k):
    """dY and A that start 2 bytes past a 16-byte boundary (whole-row spans
    and row segments at any offset), batch 1 and 2, rows that fill no chunk
    of 64, the keep mask on."""
    dy, a = _offset(_randn(gen, b, n, nout)), _offset(_randn(gen, b, n, k))
    kw = dict(drop=_drop(0.25, site=9), bias=True)
    for g_, r_ in zip(ln_linear_wgrad(dy, a, **kw), ln_linear_wgrad_plain(dy, a, **kw)):
        _close(g_, r_)


@pytest.mark.parametrize("use", ["out_proj", "qkv", "fc2", "fc1"])
def test_ln_linear_wgrad_reruns_agree(gen, use):
    """No float atomics: the slices' partials are summed in a fixed order
    (the cluster's in rank order, the slices in slice order), so two runs
    give the same dW and db bit for bit."""
    b, n, emb, heads, mlp = 3, 700, 155, 4, 488
    drop = _drop(0.25, site=2)
    if use == "qkv":
        dy = ln_linear(_randn(gen, b, n, 32), _randn(gen, 3 * heads * emb, 32, scale=0.3),
                       heads=(heads, emb))
        a, kw = _randn(gen, b, n, emb), dict(heads=(heads, emb))
    else:
        nout, k = dict(out_proj=(emb, heads * emb), fc2=(emb, mlp), fc1=(mlp, emb))[use]
        dy, a = _randn(gen, b, n, nout), _randn(gen, b, n, k)
        kw = dict(drop=drop if use != "fc1" else None, bias=True)
    first, second = (ln_linear_wgrad(dy, a, **kw) for _ in range(2))
    torch.cuda.synchronize()
    for f_, s_ in zip(first, second):
        assert (f_ is None and s_ is None) or torch.equal(f_, s_)


@pytest.mark.parametrize("lsa", [False, True], ids=["no_lsa", "lsa"])
@pytest.mark.parametrize("n", [129, 1000])
@pytest.mark.parametrize("d", [155, 192, 200, 256])
def test_flash_bf16_keep_mask_matches_plain(gen, d, n, lsa):
    """The bf16 forward's keep mask bit for bit, at the narrow tiles (D 155)
    and the wide ones (padded 192, 224, 256): q = 0 makes every probability
    1 / N (1 / (N - 1) under LSA) and v[k] = e_(k mod D) makes o count the
    kept keys of each residue class, exact small integers times one scale."""
    bh, heads, dp = 4, 2, -(-d // 32) * 32
    zero = torch.zeros(bh, n, dp, dtype=torch.bfloat16, device="cuda")
    onehot = torch.zeros_like(zero)
    keys = torch.arange(n, device="cuda")
    onehot[:, keys, keys % d] = 1.0
    kw = dict(use_lsa=lsa, drop=_drop(0.25, site=13), with_lse=True)
    got = flash_fwd(zero, zero, onehot, d, heads, **kw)[0]
    ref = flash_fwd_plain(zero, zero, onehot, d, heads, **kw)[0]
    torch.cuda.synchronize()
    assert torch.equal(got, ref)


@pytest.mark.parametrize("d", [155, 200, 256])
@pytest.mark.parametrize("nq,nk,n_real,lsa", [
    (1, 1, 1, True),  # the row's one key is masked: P spreads over the masked keys
    (3, 3, 3, True), (1, 1, 1, False),
    (70, 70, 70, True), (130, 200, 150, False),  # Nk no multiple of the key tile
], ids=str)
def test_flash_bf16_masked_rows_match_plain(gen, nq, nk, n_real, lsa, d):
    """The bf16 flash forward and one-pass backward where a row's every key
    is masked (LSA at N 1) and where Nk fills no key tile, at the narrow
    tiles (D 155) and the wide ones (padded 224 and 256): keys past Nk weigh
    nothing, masked keys keep the plain version's masked score; at N 1 with
    LSA o is v and the LSE the plain one, bit for bit. At N 1 the row's P is
    1 whatever its score, so dS = P (dP - delta) vanishes but for rounding:
    dq and dk are held to the kernel tolerance of dv's scale."""
    bh, heads, dp = 4, 2, -(-d // 32) * 32
    q, k, v = (torch.zeros(bh, m, dp, dtype=torch.bfloat16, device="cuda") for m in (nq, nk, nk))
    for x in (q, k, v):
        x[..., :d] = _randn(gen, bh, x.shape[1], d) * d ** -0.25
    kw = dict(n_real_k=n_real, use_lsa=lsa)
    o, lse = flash_fwd(q, k, v, d, heads, with_lse=True, **kw)
    o_ref, lse_ref = flash_fwd_plain(q, k, v, d, heads, with_lse=True, **kw)
    _close(o, o_ref)
    _close(lse, lse_ref, F32_TOL)
    if nq == 1 and lsa:
        assert torch.equal(o.permute(0, 2, 1, 3).reshape(bh, 1, d), v[..., :d])
        assert torch.equal(lse, lse_ref)
    do = _randn(gen, *o.shape)
    got = flash_bwd(q, k, v, o_ref, do, lse_ref, d, heads, **kw)
    ref = flash_bwd_plain(q, k, v, o_ref, do, lse_ref, d, heads, **kw)
    torch.cuda.synchronize()
    scale = ref[2].float().abs().max().item()
    for g_, r_ in zip(got, ref):  # dq, dk, dv
        assert torch.isfinite(g_.float()).all()
        assert (g_.float() - r_.float()).abs().max().item() <= TOL * max(
            r_.float().abs().max().item(), scale if nq == 1 else 0.0) + 1e-6


def test_projection_plans_match_the_library(gen):
    """ops/ln_linear.py linear_plan and wgrad_plan mirror the plans compiled
    into csrc/ln_linear.cu and csrc/ln_linear_bwd.cu: the same launch."""
    from v1t_tpu_torch import _build
    from v1t_tpu_torch.ops.ln_linear import COPIES, linear_plan, wgrad_plan

    lib = _build.library()
    for m, rows in ((64 * 1654, 1654), (2 * 34114, 34114), (130, 65)):
        for emb, heads, mlp in SWEEP + [(155, 4, 488)]:
            kp = lambda k_: -(-k_ // 32) * 32  # noqa: E731
            dp = -(-emb // 32) * 32
            fwd = [(3 * heads * emb, emb, heads, True, False, False),
                   (emb, heads * emb, 0, False, heads * emb % 8 == 0, True),
                   (mlp, emb, 0, True, False, False), (emb, mlp, 0, False, mlp % 8 == 0, True)]
            for n_, k_, h_, ln, al, res in fwd:
                plan = linear_plan(m, n_, k_, (h_, emb) if h_ else None, ln, al, res)
                got = [lib.v1t_ln_linear_plan(m, n_, k_, kp(k_), h_, emb if h_ else 0,
                                              dp if h_ else 0, int(ln), int(al), int(res), f)
                       for f in range(6)]
                if plan is None:
                    assert got[5] == 0
                else:
                    assert got == [int(plan.stream), plan.rows, plan.tile, plan.tiles,
                                   plan.stages, plan.smem]
            bwd = [(emb, heads * emb, 0), (3 * heads * emb, emb, heads), (emb, mlp, 0),
                   (mlp, emb, 0)]
            for n_, k_, h_ in bwd:
                for dy_al, a_al in ((True, True), (False, False)):
                    plan = wgrad_plan(m, n_, k_, rows, (h_, emb) if h_ else None, dy_al, a_al)
                    got = [lib.v1t_ln_linear_wgrad_plan(m, n_, k_, rows, h_, emb if h_ else 0,
                                                        dp if h_ else 0, int(dy_al), int(a_al), f)
                           for f in range(11)]
                    assert got == [plan.tile, plan.n_tiles, plan.k_tiles, plan.slices,
                                   plan.cluster, plan.stages, plan.smem, plan.chunks,
                                   COPIES.index(plan.a_copy), COPIES.index(plan.dy_copy),
                                   plan.copied_stages]
