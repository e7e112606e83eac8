"""The port's CUDA kernels against their plain versions at edge shapes, on
the card: rows, outputs and K that are no multiple of a tile, one row, one
key tile, every padded head width, batch 1, and the small model end to end.

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py -q

(``--noconftest``: ``tests/conftest.py`` configures JAX, which a GPU host
running only the port lacks.) Without a CUDA device every test skips.

Tolerance: max|kernel - plain| <= 2e-2 * max|plain| on bf16 outputs, as in
``chip_smoke.py`` (one bf16 rounding is 2^-8; the two sum in other orders).
"""

import numpy as np
import pytest
import torch

from v1t_tpu_torch.ops.fused_mha import attention, attention_plain
from v1t_tpu_torch.ops.interp_matmul import bilinear_sample_cm, bilinear_sample_cm_plain
from v1t_tpu_torch.ops.ln_linear import ln_linear, ln_linear_plain

pytestmark = pytest.mark.cuda
TOL = 2e-2


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.Generator().manual_seed(0)


def _randn(gen, *shape, scale=1.0, dtype=torch.bfloat16):
    return (torch.randn(*shape, generator=gen) * scale).to("cuda", dtype)


def _close(got, ref):
    torch.cuda.synchronize()
    assert got.shape == ref.shape and got.dtype == ref.dtype
    got, ref = got.float(), ref.float()
    assert torch.isfinite(got).all()
    assert (got - ref).abs().max().item() <= TOL * ref.abs().max().item() + 1e-6


LN_CASES = [
    # (B, N, K, Nout, options)
    (1, 1, 7, 5, "ln"),
    (2, 65, 155, 130, "ln+row"),
    (1, 70, 488, 155, "bias+residual"),
    (3, 100, 640, 64, "bias+residual+row"),
    (2, 129, 33, 200, "ln+bias+gelu"),
    (2, 129, 155, 3 * 4 * 155, "ln+row+heads"),
    (1, 17, 48, 3 * 2 * 17, "ln+heads"),
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
], ids=lambda v: str(v))
def test_attention_matches_plain(gen, b, n, h, d, lsa):
    x = _randn(gen, b, n, 48)
    w = _randn(gen, 3 * h * d, 48, scale=0.3)
    ones = torch.ones(48, device="cuda")
    qkv = ln_linear(x, w, gamma=ones, beta=ones * 0.0, heads=(h, d))
    scale = torch.full((h,), d ** -0.5, device="cuda")
    _close(attention(qkv, scale, d, use_lsa=lsa), attention_plain(qkv, scale, d, use_lsa=lsa))


@pytest.mark.parametrize("b,c,height,width,p", [
    (1, 1, 1, 2, 1), (3, 7, 5, 9, 1000), (2, 155, 29, 57, 37), (1, 3, 4, 1, 300),
], ids=lambda v: str(v))
def test_bilinear_sample_cm_matches_plain(gen, b, c, height, width, p):
    table = _randn(gen, b, c, height * width)
    grid = (torch.rand(b, p, 2, generator=gen) * 3.0 - 1.5).to("cuda")
    _close(bilinear_sample_cm(table, grid, height, width),
           bilinear_sample_cm_plain(table, grid, height, width))


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


def test_float32_model_on_the_card_raises(gen):
    """The kernels take bf16 only: a float32 model on the card raises
    instead of running the plain versions."""
    from v1t_tpu_torch.training import Trainer

    config, card, batch, model = _small_model("fp32")
    counts = (ln_linear.launches, attention.launches, bilinear_sample_cm.launches)
    with pytest.raises(ValueError, match="expected torch.bfloat16"):
        Trainer(config, model, card).predict("A", batch)
    readout = model.readouts["A"]
    core_map = _randn(gen, 2, 32, 29, 57, dtype=torch.float32)
    with pytest.raises(ValueError, match="expected torch.bfloat16"):
        readout(core_map)
    assert counts == (ln_linear.launches, attention.launches, bilinear_sample_cm.launches)
