// The bf16 one-pass attention backward on wgmma, defined once in
// flash_attention_bwd.cu and launched by both backwards built on it:
// flash_attention_bwd.cu (natural-log scores and LSE, the softmax scale
// folded into q) and attention_bwd.cu (log2 scores and LSE, q_s = bf16(q *
// scale * log2 e), dk = ln2 dS^T q_s).
#pragma once

#include "common.cuh"

namespace one_pass {

// One launch over q (BH, Nq, DP), k, v (BH, Nk, DP), dO head-major (BH, Nq,
// DP) bf16 and lse, delta (BH, Nq) float32, DP = 32, 64, ..., 256: P =
// exp2(s_log2 (q.k - lse)) (s_log2 = log2 e for natural units, 1 for log2
// ones); adds dq's partial sums dS k into dq_acc (BH, Nq, DP) float32, which
// the caller zeroes; writes dk = dk_scale dS^T q and dv (BH, Nk, DP) bf16,
// zero past D. Keys at or past n_real and, with lsa, the diagonal are masked;
// drop regenerates the keep mask of element (bh, query, key). Returns a CUDA
// error code.
int launch(const void* q, const void* k, const void* v, const void* dohm, const float* lse,
           const float* delta, float* dq_acc, bf16* dk, bf16* dv, int BH, int Nq, int Nk,
           int n_real, int D, int DP, int lsa, Drop drop, float s_log2, float dk_scale,
           cudaStream_t stream);

}  // namespace one_pass
