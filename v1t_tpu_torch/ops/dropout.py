"""Counter-based dropout keep masks, the same function bit for bit in the
CUDA kernels (``csrc/common.cuh`` ``keep_words``) and here in PyTorch
integer ops.

The JAX package draws its fused dropout from the TPU's hardware PRNG,
seeded per tile (``v1t_tpu/ops/flash_attention.py`` ``_keep_draw`` /
``_dropout_keep_mask`` / ``_dropout_raw_bits`` / ``_apply_keep_halves``,
``fused_mha._out_keep_mask``, ``fused_mlp._keep_mask``), and regenerates the
same bits in the backward. Those bits exist only on a TPU. Here the mask of
element (plane, row, col) of dropout site ``site`` under seed ``seed`` is
word ``col % 4`` of Philox4x32-10 (Salmon et al., SC'11, "Parallel random
numbers: as easy as 1, 2, 3"; the generator of cuRAND and of PyTorch's own
CUDA dropout) with

    key     = (seed, site)
    counter = (col // 4, row, plane, 0)

and the element is kept when that word is below ``keep_threshold(rate)`` =
floor((1 - rate) * 2^32): the keep probability to full 32-bit resolution,
not the TPU kernels' 1/65536 step (``PARITY.md``). A forward and its
backward regenerate the mask from (seed, site) and the coordinates; no mask
is stored. Kept elements are scaled by 1 / (1 - rate).

The coordinates per site: attention probabilities (plane b * H + h, row
query, col key); a projection's output (plane 0, row b * N + n, col
channel).
"""

from __future__ import annotations

import typing as t

import torch

M0, M1 = 0xD2511F53, 0xCD9E8D57
W0, W1 = 0x9E3779B9, 0xBB67AE85
ROUNDS = 10
MASK32 = 0xFFFFFFFF


class Dropout(t.NamedTuple):
    """One dropout site of one step: rate, the step's seed and the site id
    (both uint32)."""

    rate: float
    seed: int
    site: int

    @property
    def active(self) -> bool:
        return self.rate > 0.0

    @property
    def threshold(self) -> int:
        return keep_threshold(self.rate)

    @property
    def scale(self) -> float:
        return 1.0 / (1.0 - self.rate)


def keep_threshold(rate: float) -> int:
    """Keep an element when its 32-bit word is below this."""
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate {rate} not in [0, 1)")
    return min(int((1.0 - rate) * 2.0 ** 32), MASK32)


def _mulhilo(m: int, x: torch.Tensor) -> t.Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) 32-bit halves of m * x for uint32 x held in int64, without
    int64 overflow: x is split into 16-bit halves (every partial < 2^49)."""
    xh, xl = x >> 16, x & 0xFFFF
    p = m * xh
    r = ((p & 0xFFFF) << 16) + m * xl
    return (p >> 16) + (r >> 32), r & MASK32


def philox4x32(counter: t.Sequence[torch.Tensor], key: t.Tuple[int, int]) -> t.List[torch.Tensor]:
    """Philox4x32-10 on int64 tensors holding uint32 values (broadcast
    together); returns the 4 output words."""
    c0, c1, c2, c3 = (torch.as_tensor(c, dtype=torch.int64) for c in counter)
    k0, k1 = key[0] & MASK32, key[1] & MASK32
    for r in range(ROUNDS):
        if r:
            k0, k1 = (k0 + W0) & MASK32, (k1 + W1) & MASK32
        hi0, lo0 = _mulhilo(M0, c0)
        hi1, lo1 = _mulhilo(M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return [c0, c1, c2, c3]


def keep_mask(drop: Dropout, planes: int, rows: int, cols: int,
              device: t.Union[str, torch.device] = "cpu", row0: int = 0) -> torch.Tensor:
    """(planes, rows, cols) bool keep mask of one site: rows row0 .. row0 +
    rows - 1 of every plane, so that a caller working in row chunks draws
    only its own rows."""
    groups = -(-cols // 4)
    col4 = torch.arange(groups, dtype=torch.int64, device=device).view(1, 1, -1)
    row = torch.arange(row0, row0 + rows, dtype=torch.int64, device=device).view(1, -1, 1)
    out = torch.empty((planes, rows, groups * 4), dtype=torch.bool, device=device)
    thr = drop.threshold
    # planes in chunks of ~4M counters bound the int64 temporaries
    chunk = max(1, (1 << 22) // (rows * groups))
    for first in range(0, planes, chunk):
        last = min(first + chunk, planes)
        plane = torch.arange(first, last, dtype=torch.int64, device=device).view(-1, 1, 1)
        words = philox4x32((col4, row, plane, 0), (drop.seed, drop.site))
        out[first:last] = torch.stack([w < thr for w in words], dim=-1).reshape(
            last - first, rows, -1)
    return out[..., :cols]


def apply_dropout(y: torch.Tensor, drop: t.Optional[Dropout]) -> torch.Tensor:
    """where(keep, y / (1 - rate), 0) for y (rows, cols) of plane 0, in
    float32 arithmetic, y's dtype out."""
    if drop is None or not drop.active:
        return y
    keep = keep_mask(drop, 1, y.shape[0], y.shape[1], y.device)[0]
    return torch.where(keep, y.float() * drop.scale, 0.0).to(y.dtype)


def step_seed(seed: int, step: int) -> int:
    """The uint32 dropout/noise seed of training step ``step`` of a run
    seeded with ``seed``: Philox4x32-10 of the step under the run's seed, so
    neighbouring steps and seeds share no structure."""
    words = philox4x32((step & MASK32, step >> 32, 0, 0), (seed, 0x5EED))
    return int(words[0])
