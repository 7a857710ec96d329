// Causal FlashAttention-2 forward with an optional packed-segment mask
// (Hopper, sm_90a).
//
// Replaces the Pallas TPU kernel skypilot_tpu/ops/flash_attention.py
// (_fwd_kernel, driven by _fwd / flash_attention). Computes
// O = softmax(Q K^T / sqrt(D) + mask) V and the row logsumexp, where the
// mask admits k_pos <= q_pos (causal) and, with segments, only positions
// of the query's own segment. Grouped-query attention reads the kv-head
// h / (H / Hkv) directly, so K/V are never expanded.
//
// What bounds it: operations (4 * S^2 / 2 * D per head under the causal
// mask) at the prefill shapes (S >= 512). Two bodies, chosen by dtype:
//
// bf16 (flash_fwd_bf16_kernel), the served and trained path: wgmma on
// TMA tiles (sm90.cuh). One block per (128-row q tile, head, batch): a
// producer warpgroup, whose first warp issues every TMA load and which
// hands its registers to the others (setmaxnreg), and two consumer
// warpgroups of 64 q rows each. Q, K and V stay bf16 in shared memory in
// the swizzled boxes that TMA writes and wgmma reads. K/V tiles of 128
// keys stream through a two-stage ring with a full and an empty mbarrier
// per stage, so the next tile lands while the current one is multiplied
// and each warpgroup runs at its own pace. S = Q K^T is wgmma m64n128k16
// from shared memory with fp32 accumulators; the 1/sqrt(D) scale, folded
// with log2(e), is applied to the fp32 S, never to a bf16 Q. The online
// softmax runs on the accumulator registers (row max and sum by quad
// shuffles, the sum taken from fp32 P). P is split in registers into two
// bf16 A operands, hi = bf16(P) and lo = bf16(P - hi), for
// O += P_hi V + P_lo V (wgmma with A from registers, V MN-major): one
// bf16 rounding of P would cost up to 2^-9 of |v| in rows that attend to
// few keys, past the bf16 output's own rounding, while the split leaves
// only the order of fp32 sums, at the price of a second P V product.
// Tiles past the diagonal are never loaded; only tiles that cross the
// diagonal, the sequence end or a segment boundary pay the element mask;
// the heaviest q tiles are issued first. Each warpgroup multiplies, then
// does its softmax, then multiplies again: what bounds it below its
// bound is that this chain is not overlapped inside a warpgroup (only
// across the two), and the second P V product.
//
// fp32 (flash_fwd_kernel): CUDA-core FMA, exact fp32 products. One block
// per (64-row q tile, head, batch) of 256 threads, each owning a 4x4
// score micro-tile and a 4 x D/16 slice of the output in registers, with
// fp32 tiles staged in shared memory. Bounded by the FMA rate (67
// TFLOP/s); tensor cores would round the inputs (TF32) and break the
// fp32 parity checks.
//
// Layouts: q, o [B, S, H, D]; k, v [B, S, Hkv, D] (f32 or bf16, D = 32, 64
// or 128); segments [B, S] int32 or null; lse [B, H, S] float32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "sm90.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;  // query rows per thread block
constexpr int kBK = 64;  // key rows per shared-memory tile
constexpr int kPP = kBK + 1;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (kBQ * D + kBK * (D + 1) + kBK * D + kBQ * kPP +
                          3 * kBQ) +
         sizeof(int) * (kBQ + kBK);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const int* __restrict__ seg,
    T* __restrict__ o, float* __restrict__ lse, int S, int H, int Hkv,
    int causal, float scale) {
  constexpr int DP = D + 1;
  constexpr int NC = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* q_s = smem;              // [kBQ][D], pre-scaled
  float* k_s = q_s + kBQ * D;     // [kBK][DP]
  float* v_s = k_s + kBK * DP;    // [kBK][D]
  float* p_s = v_s + kBK * D;     // [kBQ][kPP] scores, then weights
  float* m_s = p_s + kBQ * kPP;   // [kBQ]
  float* l_s = m_s + kBQ;         // [kBQ]
  float* a_s = l_s + kBQ;         // [kBQ] rescale factor of this tile
  int* qseg_s = reinterpret_cast<int*>(a_s + kBQ);  // [kBQ]
  int* kseg_s = qseg_s + kBQ;                        // [kBK]

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const size_t q_row = static_cast<size_t>(H) * D;
  const size_t kv_row = static_cast<size_t>(Hkv) * D;
  const T* qb = q + static_cast<size_t>(b) * S * q_row + static_cast<size_t>(h) * D;
  const T* kb = k + static_cast<size_t>(b) * S * kv_row + static_cast<size_t>(hk) * D;
  const T* vb = v + static_cast<size_t>(b) * S * kv_row + static_cast<size_t>(hk) * D;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D;
    const int d = i - r * D;
    const int s = q0 + r;
    q_s[i] = s < S ? to_f(qb[static_cast<size_t>(s) * q_row + d]) * scale : 0.f;
  }
  if (tid < kBQ) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
    if (seg != nullptr)
      qseg_s[tid] = (q0 + tid < S) ? seg[static_cast<size_t>(b) * S + q0 + tid] : -1;
  }
  float acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[i][j] = 0.f;
  __syncthreads();

  int n_kv = (S + kBK - 1) / kBK;
  if (causal) n_kv = min(n_kv, (q0 + kBQ - 1) / kBK + 1);
  for (int kj = 0; kj < n_kv; ++kj) {
    const int k0 = kj * kBK;
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int r = i / D;
      const int d = i - r * D;
      const int s = k0 + r;
      float kv = 0.f, vv = 0.f;
      if (s < S) {
        kv = to_f(kb[static_cast<size_t>(s) * kv_row + d]);
        vv = to_f(vb[static_cast<size_t>(s) * kv_row + d]);
      }
      k_s[r * DP + d] = kv;
      v_s[r * D + d] = vv;
    }
    if (seg != nullptr && tid < kBK)
      kseg_s[tid] = (k0 + tid < S) ? seg[static_cast<size_t>(b) * S + k0 + tid] : -2;
    __syncthreads();

    // Scores: rows ty*4 + i, columns tx + 16*j.
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = q_s[(ty * 4 + i) * D + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = k_s[(tx + 16 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }
    const bool edge = (causal && k0 + kBK > q0) || k0 + kBK > S ||
                      seg != nullptr;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        float s = sc[i][j];
        if (edge) {
          const int qp = q0 + r;
          const int kp = k0 + c;
          bool ok = kp < S;
          if (causal) ok = ok && qp >= kp;
          if (seg != nullptr) ok = ok && qseg_s[r] == kseg_s[c];
          if (!ok) s = kNegInf;
        }
        p_s[r * kPP + c] = s;
      }
    }
    __syncthreads();

    // Online softmax: each warp owns 8 rows, each lane two columns.
    for (int rr = 0; rr < kBQ / (kThreads / 32); ++rr) {
      const int r = warp * (kBQ / (kThreads / 32)) + rr;
      const float s0 = p_s[r * kPP + lane];
      const float s1 = p_s[r * kPP + lane + 32];
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      const float p0 = expf(s0 - m_new);
      const float p1 = expf(s1 - m_new);
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      p_s[r * kPP + lane] = p0;
      p_s[r * kPP + lane + 32] = p1;
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        m_s[r] = m_new;
        l_s[r] = l_s[r] * alpha + sum;
        a_s[r] = alpha;
      }
    }
    __syncthreads();

    // Accumulate: rows ty*4 + i, columns tx + 16*j.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float al = a_s[ty * 4 + i];
#pragma unroll
      for (int j = 0; j < NC; ++j) acc[i][j] *= al;
    }
    for (int c = 0; c < kBK; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = p_s[(ty * 4 + i) * kPP + c];
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const float vv = v_s[c * D + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
    __syncthreads();
  }

  T* ob = o + static_cast<size_t>(b) * S * q_row + static_cast<size_t>(h) * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    const int s = q0 + r;
    if (s >= S) continue;
    const float l = fmaxf(l_s[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < NC; ++j)
      ob[static_cast<size_t>(s) * q_row + tx + 16 * j] = from_f<T>(acc[i][j] / l);
    if (tx == 0)
      lse[(static_cast<size_t>(b) * H + h) * S + s] = m_s[r] + logf(l);
  }
}

// ---------------------------------------------------------------------------
// bf16 body: wgmma on TMA tiles
// ---------------------------------------------------------------------------

constexpr int kConsumers = 256;            // two warpgroups, 64 q rows each
constexpr int kThreadsTC = kConsumers + 128;  // and a producer warpgroup
constexpr int kBQT = 128;                    // q rows per block
constexpr int kBKT = 128;                    // key rows per stage
constexpr int kStages = 2;                   // K/V ring
constexpr float kLn2 = 0.6931471805599453f;

// Q (kBQT x D) and the K/V ring (2 kStages x kBKT x D), bf16 in TMA boxes;
// barriers (Q, then full and empty per stage), segment ids and per-stage
// segment flags; 1 KB to align the boxes to the swizzle atom. O is staged
// at the end over the ring ([kBQT][D + 8]).
template <int D>
constexpr size_t tc_smem_bytes() {
  return 1024 + sizeof(__nv_bfloat16) * (kBQT + 2 * kStages * kBKT) * D +
         sizeof(uint64_t) * (1 + 2 * kStages) +
         sizeof(int) * (kBQT + kStages * kBKT + kStages);
}

template <int D>
__global__ void __launch_bounds__(kThreadsTC, 1) flash_fwd_bf16_kernel(
    const __grid_constant__ CUtensorMap tq,
    const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, const int* __restrict__ seg,
    sm90::bf16* __restrict__ o, float* __restrict__ lse, int S, int H,
    int Hkv, int causal, float scale_log2) {
  using sm90::bf16;
  using Bx = sm90::Boxes<D>;
  constexpr int BC = Bx::BC;
  constexpr int ROW = Bx::ROW;
  constexpr int ND = D / 8;     // 8-wide output tiles
  constexpr int NS = kBKT / 8;  // 8-wide score tiles per stage
  constexpr int KS = BC / 16;   // 16-deep steps per box
  constexpr int TILE = kBKT * D;  // elements of one K or V tile
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  bf16* q_s = reinterpret_cast<bf16*>(base);  // NB boxes [kBQT][BC]
  bf16* kv_s = q_s + kBQT * D;  // stage st: K at 2 st TILE, V after it
  uint64_t* q_full = reinterpret_cast<uint64_t*>(kv_s + 2 * kStages * TILE);
  uint64_t* full = q_full + 1;      // [kStages]: the stage has landed
  uint64_t* empty = full + kStages;  // [kStages]: 8 consumer warps are done
  int* qseg_s = reinterpret_cast<int*>(empty + kStages);  // [kBQT]
  int* kseg_s = qseg_s + kBQT;                             // [kStages][kBKT]
  int* sflag_s = kseg_s + kStages * kBKT;  // [kStages]: a key's segment
                                           // differs from the q tile's

  // Heaviest q tiles first: under the causal mask tile i sweeps i + 1
  // key tiles, and blocks are issued in order of blockIdx.z.
  const int n_q = (S + kBQT - 1) / kBQT;
  const int q0 = (n_q - 1 - static_cast<int>(blockIdx.z)) * kBQT;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const bool segs = seg != nullptr;
  const int* sb = segs ? seg + static_cast<size_t>(b) * S : nullptr;

  if (tid == 0) {
    sm90::mbar_init(q_full, 1);
    for (int i = 0; i < kStages; ++i) {
      sm90::mbar_init(&full[i], 1);
      sm90::mbar_init(&empty[i], kConsumers / 32);
    }
    sm90::fence_barrier_init();
  }
  // Segments: is the whole q tile one segment (then a key tile of that
  // same segment needs no element mask)?
  int qs0 = 0;
  bool q_uni = true;
  if (segs) {
    qs0 = sb[q0];
    int mine = -1;
    if (tid < kBQT) {
      mine = q0 + tid < S ? sb[q0 + tid] : -1;
      qseg_s[tid] = mine;
    }
    q_uni = __syncthreads_and(!(tid < kBQT && q0 + tid < S && mine != qs0));
  } else {
    __syncthreads();
  }

  int n_kv = (S + kBKT - 1) / kBKT;
  if (causal) n_kv = min(n_kv, (q0 + kBQT - 1) / kBKT + 1);

  if (tid >= kConsumers) {
    // The producer warpgroup gives its registers to the consumers; its
    // first warp issues every load.
    sm90::reg_dealloc<sm90::kProducerRegs>();
    if (tid >= kConsumers + 32) return;
    // Producer warp: Q once, then the K/V ring. A stage is refilled once
    // every consumer warp has released it; segment ids travel with it.
    const int hk = h / (H / Hkv);
    if (lane == 0) {
      sm90::mbar_expect_tx(q_full, kBQT * D * 2);
      for (int x = 0; x < Bx::NB; ++x)
        sm90::tma_load_4d(q_s + x * kBQT * BC, &tq, q_full, x * BC, h, q0, b);
    }
    for (int kj = 0; kj < n_kv; ++kj) {
      const int st = kj % kStages;
      if (kj >= kStages) sm90::mbar_wait(&empty[st], (kj / kStages - 1) & 1);
      if (segs) {
        bool diff = false;
        for (int i = lane; i < kBKT; i += 32) {
          const int s = kj * kBKT + i;
          const int id = s < S ? sb[s] : -2;
          kseg_s[st * kBKT + i] = id;
          diff = diff || (s < S && id != qs0);
        }
        diff = __any_sync(0xffffffffu, diff);
        if (lane == 0) sflag_s[st] = diff;
        __threadfence_block();
        __syncwarp();
      }
      if (lane == 0) {
        bf16* kd = kv_s + 2 * st * TILE;
        sm90::mbar_expect_tx(&full[st], 2 * TILE * 2);
        for (int x = 0; x < Bx::NB; ++x) {
          sm90::tma_load_4d(kd + x * kBKT * BC, &tk, &full[st], x * BC, hk,
                            kj * kBKT, b);
          sm90::tma_load_4d(kd + TILE + x * kBKT * BC, &tv, &full[st],
                            x * BC, hk, kj * kBKT, b);
        }
      }
    }
    return;
  }

  sm90::reg_alloc<sm90::kConsumerRegs>();
  // Consumers: warpgroup wg owns q rows 64 wg .. 64 wg + 63.
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int g = lane / 4;
  const int t = lane % 4;
  float acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  // This thread's rows are r0 and r0 + 8 of the tile; m in log2 units,
  // l a partial sum over the thread's columns (the quad's sum at the end).
  const int r0 = wg * 64 + warp * 16 + g;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
  const bf16* qw = q_s + wg * 64 * BC;  // this warpgroup's Q rows

  sm90::mbar_wait(q_full, 0);

  for (int kj = 0; kj < n_kv; ++kj) {
    const int st = kj % kStages;
    const int k0 = kj * kBKT;
    sm90::mbar_wait(&full[st], (kj / kStages) & 1);
    const bf16* ks = kv_s + 2 * st * TILE;
    const bf16* vs = ks + TILE;

    // S = Q K^T: both K-major, 16 columns of the head dim per step.
    float sc[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
    sm90::fence_regs(sc);
    sm90::wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int x = kk / KS;
      const int off = (kk % KS) * 16;
      sm90::wgmma_ss(
          sc,
          sm90::desc(qw + x * kBQT * BC + off, 0, 8 * ROW, Bx::LAYOUT),
          sm90::desc(ks + x * kBKT * BC + off, 0, 8 * ROW, Bx::LAYOUT));
    }
    sm90::wg_commit();
    sm90::wg_wait<0>();
    sm90::fence_regs(sc);

    const bool edge = (causal && k0 + kBKT > q0) || k0 + kBKT > S ||
                      (segs && (sflag_s[st] || !q_uni));
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[j][e] * scale_log2;
        if (edge) {
          const int r = r0 + (e >> 1) * 8;
          const int c = j * 8 + 2 * t + (e & 1);
          bool ok = k0 + c < S;
          if (causal) ok = ok && k0 + c <= q0 + r;
          if (segs) ok = ok && qseg_s[r] == kseg_s[st * kBKT + c];
          if (!ok) x = kNegInf;
        }
        sc[j][e] = x;
      }

    // Online softmax on the registers: the 4 threads of a quad share
    // rows r0 and r0 + 8.
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      mx0 = fmaxf(mx0, fmaxf(sc[j][0], sc[j][1]));
      mx1 = fmaxf(mx1, fmaxf(sc[j][2], sc[j][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0);
    const float mn1 = fmaxf(m1, mx1);
    const float al0 = exp2f(m0 - mn0);
    const float al1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      sc[j][0] = exp2f(sc[j][0] - mn0);
      sc[j][1] = exp2f(sc[j][1] - mn0);
      sc[j][2] = exp2f(sc[j][2] - mn1);
      sc[j][3] = exp2f(sc[j][3] - mn1);
      ps0 += sc[j][0] + sc[j][1];
      ps1 += sc[j][2] + sc[j][3];
    }
    l0 = l0 * al0 + ps0;
    l1 = l1 * al1 + ps1;
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      acc[j][0] *= al0;
      acc[j][1] *= al0;
      acc[j][2] *= al1;
      acc[j][3] *= al1;
    }

    // O += P V: P from registers as two bf16 A operands (hi and lo), V
    // MN-major (16 keys down its rows per step).
    uint32_t pa[2 * (kBKT / 16)][4];
#pragma unroll
    for (int kk = 0; kk < kBKT / 16; ++kk)
      sm90::a_from_c(pa[2 * kk], pa[2 * kk + 1], sc, kk);
    sm90::fence_regs(acc);
    sm90::fence_regs(pa);
    sm90::wg_fence();
#pragma unroll
    for (int kk = 0; kk < kBKT / 16; ++kk) {
      const uint64_t dv =
          sm90::desc(vs + kk * 16 * BC, kBKT * ROW, 8 * ROW, Bx::LAYOUT);
      sm90::wgmma_rs(acc, pa[2 * kk + 1], dv);
      sm90::wgmma_rs(acc, pa[2 * kk], dv);
    }
    sm90::wg_commit();
    sm90::wg_wait<0>();
    sm90::fence_regs(acc);
    sm90::fence_regs(pa);
    if (lane == 0) sm90::mbar_arrive(&empty[st]);  // this warp is done
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / fmaxf(l0, 1e-30f);
  const float inv1 = 1.f / fmaxf(l1, 1e-30f);
  if (t == 0) {
    float* lb = lse + (static_cast<size_t>(b) * H + h) * S;
    if (q0 + r0 < S) lb[q0 + r0] = (m0 + log2f(fmaxf(l0, 1e-30f))) * kLn2;
    if (q0 + r0 + 8 < S)
      lb[q0 + r0 + 8] = (m1 + log2f(fmaxf(l1, 1e-30f))) * kLn2;
  }
  // Stage O over the ring once both warpgroups are done with it (every
  // load was consumed, so no copy is in flight), then store 16-byte rows.
  constexpr int LD = D + 8;
  bf16* os = kv_s;
  sm90::named_sync(1, kConsumers);
#pragma unroll
  for (int j = 0; j < ND; ++j) {
    const int c = j * 8 + 2 * t;
    *reinterpret_cast<uint32_t*>(os + r0 * LD + c) =
        sm90::pack(acc[j][0] * inv0, acc[j][1] * inv0);
    *reinterpret_cast<uint32_t*>(os + (r0 + 8) * LD + c) =
        sm90::pack(acc[j][2] * inv1, acc[j][3] * inv1);
  }
  sm90::named_sync(1, kConsumers);
  const size_t q_row = static_cast<size_t>(H) * D;
  bf16* ob = o + static_cast<size_t>(b) * S * q_row +
             static_cast<size_t>(h) * D;
  constexpr int CH = D / 8;  // 16-byte chunks per row
  for (int i = tid; i < kBQT * CH; i += kConsumers) {
    const int r = i / CH;
    const int c = i % CH;
    const int s = q0 + r;
    if (s < S)
      *reinterpret_cast<uint4*>(ob + static_cast<size_t>(s) * q_row + c * 8) =
          *reinterpret_cast<const uint4*>(os + r * LD + c * 8);
  }
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

// The dynamic shared memory opt-in, once per kernel; 0 or the error.
template <typename K>
int allow_smem(K kern, size_t smem, bool& configured) {
  if (configured) return 0;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  configured = true;
  return 0;
}

template <int D>
int launch_fp32(const void* q, const void* k, const void* v, const void* seg,
                void* o, void* lse, int B, int S, int H, int Hkv, int causal,
                cudaStream_t stream) {
  auto kern = flash_fwd_kernel<float, D>;
  constexpr size_t smem = smem_bytes<D>();
  static bool configured = false;
  if (int e = allow_smem(kern, smem, configured)) return e;
  dim3 grid((S + kBQ - 1) / kBQ, H, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const int*>(seg),
      static_cast<float*>(o), static_cast<float*>(lse), S, H, Hkv, causal,
      static_cast<float>(1.0 / std::sqrt(static_cast<double>(D))));
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, const void* seg,
                void* o, void* lse, int B, int S, int H, int Hkv, int causal,
                cudaStream_t stream) {
  // TMA reads 16-byte aligned tensors; O is stored in 16-byte rows.
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o)) &
      15)
    return static_cast<int>(cudaErrorMisalignedAddress);
  constexpr int BC = sm90::Boxes<D>::BC;
  CUtensorMap tq, tk, tv;
  if (int e = sm90::bf16_map(&tq, q, D, H, S, B, BC, kBQT)) return e;
  if (int e = sm90::bf16_map(&tk, k, D, Hkv, S, B, BC, kBKT)) return e;
  if (int e = sm90::bf16_map(&tv, v, D, Hkv, S, B, BC, kBKT)) return e;
  auto kern = flash_fwd_bf16_kernel<D>;
  constexpr size_t smem = tc_smem_bytes<D>();
  static bool configured = false;
  if (int e = allow_smem(kern, smem, configured)) return e;
  dim3 grid(H, B, (S + kBQT - 1) / kBQT);
  kern<<<grid, kThreadsTC, smem, stream>>>(
      tq, tk, tv, static_cast<const int*>(seg), static_cast<sm90::bf16*>(o),
      static_cast<float*>(lse), S, H, Hkv, causal,
      static_cast<float>(1.4426950408889634 /
                         std::sqrt(static_cast<double>(D))));
  return static_cast<int>(cudaGetLastError());
}

template <bool kBf16>
int launch_d(int D, const void* q, const void* k, const void* v,
             const void* seg, void* o, void* lse, int B, int S, int H,
             int Hkv, int causal, cudaStream_t stream) {
#define FLASH_FWD_CASE(DD)                                                  \
  if (D == DD)                                                              \
    return kBf16 ? launch_bf16<DD>(q, k, v, seg, o, lse, B, S, H, Hkv,      \
                                   causal, stream)                          \
                 : launch_fp32<DD>(q, k, v, seg, o, lse, B, S, H, Hkv,      \
                                   causal, stream);
  FLASH_FWD_CASE(32)
  FLASH_FWD_CASE(64)
  FLASH_FWD_CASE(128)
#undef FLASH_FWD_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = float32 (FMA body), 1 = bfloat16 (tensor-core body). seg may
// be null. Returns the cudaError_t of the launch (0 = success).
extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v,
                                const void* seg, void* o, void* lse, int B,
                                int S, int H, int Hkv, int D, int causal,
                                int dtype, void* stream) {
  if (Hkv <= 0 || H % Hkv != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (B * S * H == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_d<false>(D, q, k, v, seg, o, lse, B, S, H, Hkv, causal, s);
  if (dtype == 1)
    return launch_d<true>(D, q, k, v, seg, o, lse, B, S, H, Hkv, causal, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
