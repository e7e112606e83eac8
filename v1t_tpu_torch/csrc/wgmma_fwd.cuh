// The bf16 flash forward on wgmma, defined once in flash_attention.cu and
// launched by both forwards built on it: flash_attention.cu (natural-log
// scores and LSE, the softmax scale folded into q by the caller) and
// attention.cu (log2 scores and LSE: q read unscaled and scaled in shared
// memory, q_s = bf16(q * scale_h * log2 e)).
#pragma once

#include "common.cuh"

namespace wgmma_fwd {

// One launch over q (BH, Nq, DP), k and v (BH, Nk, DP) bf16, rows
// zero-padded from D to DP = 32, 64, ..., 256: o = softmax(q.k^T, masked) v
// into out at element (bh, row, d) -> ol.at(bh, row) + d, d < D. With
// q_scale null, the scores are natural-log units (p = 2^(q.k log2 e - m))
// and lse, when not null, receives the (BH, Nq) natural-log LSE; with
// q_scale, (H,) float32 indexed by bh % ol.H, q's rows are scaled by
// q_scale[h] log2 e and rounded to bf16 first, the scores are log2 units
// and lse receives m + log2 l. Keys at or past n_real are masked, with lsa
// also key == row; keys past Nk weigh nothing. When o_pad > 0, the last
// head of each batch (bh % H == H - 1) also writes zeros to the o_pad
// columns after its D, the row's pad to an aligned stride. train selects
// the training kernel (keep mask of drop when drop.on(), the LSE).
// Returns a CUDA error code.
int launch(const bf16* q, const bf16* k, const bf16* v, bf16* out, float* lse, int BH, int Nq,
           int Nk, int n_real, int D, int DP, RowLayout ol, int lsa, Drop drop,
           const float* q_scale, int o_pad, bool train, cudaStream_t stream);

// Dynamic shared memory of a block at padded head width dp (0 for a width
// it is not built for).
int smem(int dp);

}  // namespace wgmma_fwd
