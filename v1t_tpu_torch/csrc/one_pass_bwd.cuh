// The bf16 one-pass attention backward on wgmma, defined once in
// flash_attention_bwd.cu and launched by both backwards built on it:
// flash_attention_bwd.cu (natural-log scores and LSE, the softmax scale
// folded into q) and attention_bwd.cu (log2 scores and LSE, q_s = bf16(q *
// scale * log2 e), dk = ln2 dS^T q_s).
#pragma once

#include "common.cuh"

namespace one_pass {

// One launch over q (BH, Nq, DP), k, v (BH, Nk, DP), dO head-major (BH, Nq,
// DP) bf16 and lse, delta (BH, Nq) float32, DP = 32, 64, ..., 256 or any
// multiple of 32 above (the column groups: a block a (key block, group of
// <= 256 columns)): P =
// exp2(s_log2 (q.k - lse)) (s_log2 = log2 e for natural units, 1 for log2
// ones); adds dq's partial sums dS k into dq_acc (BH, Nq, DP) float32, which
// the caller zeroes; writes dk = dk_scale dS^T q and dv (BH, Nk, DP) bf16,
// zero past D. Keys at or past n_real and, with lsa, the diagonal are masked;
// drop regenerates the keep mask of element (bh, query, key). order null:
// the key blocks add into dq_acc in no fixed order; else int32 scratch of
// 1 + BH ceil(Nq / 64) counters (a ticket, a turn a plane and query tile of
// 64; above DP 256, 1 + BH G ceil(Nq / 64), a turn a plane, group and query
// tile, G = ceil(DP / 256)), which the launch zeroes: the key blocks add in key order, the same
// bits every run. Returns a CUDA error code.
int launch(const void* q, const void* k, const void* v, const void* dohm, const float* lse,
           const float* delta, float* dq_acc, bf16* dk, bf16* dv, int BH, int Nq, int Nk,
           int n_real, int D, int DP, int lsa, Drop drop, float s_log2, float dk_scale,
           int* order, cudaStream_t stream);

}  // namespace one_pass
