// Causal FlashAttention-2 backward with an optional packed-segment mask
// (Hopper, sm_90a): K3 (dK, dV) and K4 (dQ).
//
// Replaces the Pallas TPU kernels skypilot_tpu/ops/flash_attention.py
// _bwd_dkv_kernel (via _bwd / _pack_dkv) and _bwd_dq_kernel (via _bwd /
// _pack_dq). Both recompute P = exp(S - lse) from the forward's row
// logsumexp instead of storing it, with S = (Q / sqrt(D)) K^T under the
// causal and segment masks, and form dS = P * (dP - delta), where
// dP = dO V^T and delta = rowsum(dO * O) comes from the caller.
//
//   K3: dV = P^T dO and dK = dS^T (Q / sqrt(D)), summed over the q-heads
//       of the kv-head's group.
//   K4: dQ = dS K / sqrt(D).
//
// What bounds them: operations. Per causal (q, k) pair K3 does 8 * D
// (four products: S, dP, dV, dK) and K4 6 * D (S, dP, dQ); the bytes are
// each input read once, a few hundred MB at the training shapes.
//
// Design. The Pallas grid swept its inner dimension in order on one
// core; here that sweep becomes a loop inside one thread block, so
// nothing is carried between blocks:
//   K3: one block per (k tile, kv-head, batch). K and V stay in shared
//       memory while the block loops over the group's H / Hkv q-heads
//       and, under the causal mask, over the q tiles from the diagonal
//       on. One block owns its kv-head's tile for the whole group, so dK
//       and dV are summed in registers without atomics and the result
//       does not depend on the order blocks run in.
//   K4: one block per (q tile, head, batch), looping over the k tiles up
//       to the diagonal; kv-head h / (H / Hkv) is read directly, so K/V
//       are never expanded. One block owns its dQ rows, so dQ too is
//       summed in registers without atomics.
// Only tiles that cross the diagonal, the sequence end or a segment
// boundary pay the element mask.
//
// K3 in bf16 (flash_bwd_dkv_bf16_kernel), the trained path: wgmma on
// TMA tiles (sm90.cuh). One block per (128-row k tile, kv-head, batch):
// a producer warpgroup, whose first warp issues every load and which
// hands its registers to the others (setmaxnreg), and two consumer
// warpgroups of 64 k rows each, which keep their dK and dV accumulators
// (fp32, 2 x 64 registers a thread at D = 128) for the whole sweep. K and
// V are loaded once; Q and dO tiles of 32 rows, with their rows of
// lse * log2(e), delta and segment ids, stream through a three-stage
// ring with a full and an empty mbarrier per stage. Per tile the
// consumers form the transposed products, so every per-k-row operand is
// in their registers: S^T = K Q^T and dP^T = V dO^T (wgmma m64n32k16,
// both operands from shared memory), P^T = exp2(S^T * scale * log2 e -
// lse * log2 e) and dS^T = P^T * (dP^T - delta) on the fp32
// accumulators, then dV += P^T dO and dK += dS^T Q (wgmma with A from
// registers, dO and Q MN-major from the same boxes). P^T and dS^T enter
// as two bf16 A operands each, hi = bf16(x) and lo = bf16(x - hi): one
// bf16 rounding would cost up to 2^-9 of every term of dK and dV, past
// the bf16 outputs' own rounding. The scale is applied to the fp32 S and,
// once, to dK in the epilogue, never to a bf16 Q. k tiles with the most
// q tiles are issued first. The products of a tile run one after the
// other inside a warpgroup; the two warpgroups overlap each other.
//
// K4 in bf16 (flash_bwd_dq_bf16_kernel), the trained path: the forward's
// layout (flash_fwd.cu) with K3's products. One block per (128-row q
// tile, q-head, batch): the same producer warpgroup and two consumer
// warpgroups of 64 q rows each, whose dQ accumulators (fp32, 64 registers
// a thread at D = 128) stay in registers for the whole sweep. Q and dO
// are loaded once and stay resident, with the tile's lse * log2(e),
// delta and segment ids; K and V tiles of 64 rows stream through a
// three-stage ring with a full and an empty mbarrier per stage. Per tile
// the consumers form S = Q K^T and dP = dO V^T (wgmma m64n64k16, both
// operands from shared memory), P = exp2(S * scale * log2 e - lse *
// log2 e) and dS = P * (dP - delta) on the fp32 accumulators, then
// dQ += dS K (wgmma with A from registers, K MN-major as V is in the
// forward's P V). dS enters as two bf16 A operands, hi = bf16(dS) and
// lo = bf16(dS - hi), for K3's reason; the 1/sqrt(D) of dQ is applied
// once to the fp32 accumulator in the epilogue. 64-row k tiles keep S,
// dP, dQ and the dS operands (32 + 32 + 64 + 32 registers) inside the
// consumers' 232; 128-row ones would not fit. k tiles past the diagonal
// are never loaded, and the first warpgroup skips the one k tile that
// lies wholly above its rows; the heaviest q tiles are issued first.
//
// K3 and K4 in fp32: CUDA-core FMA. 256 threads, each owning a 4 x 4
// micro-tile of S and dP and a 4 x D/16 slice of each output accumulator
// in registers, over fp32 tiles in shared memory (rows padded by one
// float against bank conflicts). Bounded by the FMA rate (67 TFLOP/s);
// the fp32 bodies stay exact fp32 products for the fp32 parity checks.
//
// Layouts: q, dO, dQ [B, S, H, D]; k, v, dK, dV [B, S, Hkv, D] (f32 or
// bf16, D = 32, 64 or 128); lse, delta [B, H, S] float32; segments
// [B, S] int32 or null.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <type_traits>

#include "sm90.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kB = 64;       // rows of a q or k tile
constexpr int kPP = kB + 1;  // padded row of a P / dS tile

__device__ __forceinline__ float to_f(float x) { return x; }
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}

// Rows [r0, r0 + kB) of a [S, row_stride] operand (D columns from src)
// into dst [kB][D + 1] as float, times mul; rows past S are zero.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          size_t row_stride, int r0, int S,
                                          float mul) {
  for (int i = threadIdx.x; i < kB * D; i += kThreads) {
    const int r = i / D;
    const int d = i - r * D;
    const int s = r0 + r;
    dst[r * (D + 1) + d] =
        s < S ? to_f(src[static_cast<size_t>(s) * row_stride + d]) * mul
              : 0.f;
  }
}

// S = Qs K^T and dP = dO V^T for this thread's micro-tile: q rows
// ty*4 + i, k rows tx + 16*j.
template <int D>
__device__ __forceinline__ void scores(float (&sc)[4][4], float (&dp)[4][4],
                                       const float* q_s, const float* do_s,
                                       const float* k_s, const float* v_s,
                                       int ty, int tx) {
  constexpr int DP = D + 1;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) sc[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float qv[4], ov[4], kv[4], vv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      qv[i] = q_s[(ty * 4 + i) * DP + d];
      ov[i] = do_s[(ty * 4 + i) * DP + d];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      kv[j] = k_s[(tx + 16 * j) * DP + d];
      vv[j] = v_s[(tx + 16 * j) * DP + d];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
        dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
      }
  }
}

// P = exp(S - lse) under the mask, and dS = P * (dP - delta), into
// p_s (when given) and ds_s, both [kB q][kPP].
__device__ __forceinline__ void probs(const float (&sc)[4][4],
                                      const float (&dp)[4][4], float* p_s,
                                      float* ds_s, const float* lse_s,
                                      const float* dl_s, const int* qseg_s,
                                      const int* kseg_s, bool edge,
                                      bool causal, bool segs, int q0, int k0,
                                      int S, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j;
      float p = expf(sc[i][j] - lse_s[r]);
      if (edge) {
        const int qp = q0 + r;
        const int kp = k0 + c;
        bool ok = qp < S && kp < S;
        if (causal) ok = ok && qp >= kp;
        if (segs) ok = ok && qseg_s[r] == kseg_s[c];
        if (!ok) p = 0.f;
      }
      if (p_s != nullptr) p_s[r * kPP + c] = p;
      ds_s[r * kPP + c] = p * (dp[i][j] - dl_s[r]);
    }
  }
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  return sizeof(float) * (4 * kB * (D + 1) + 2 * kB * kPP + 2 * kB) +
         sizeof(int) * 2 * kB;
}

template <int D>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * (4 * kB * (D + 1) + kB * kPP + 2 * kB) +
         sizeof(int) * 2 * kB;
}

// ---------------------------------------------------------------------------
// K3: dK, dV
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const int* __restrict__ seg, T* __restrict__ dk, T* __restrict__ dv,
    int S, int H, int Hkv, int causal, float scale) {
  constexpr int DP = D + 1;
  constexpr int NC = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* k_s = smem;              // [kB][DP]
  float* v_s = k_s + kB * DP;     // [kB][DP]
  float* q_s = v_s + kB * DP;     // [kB][DP], pre-scaled
  float* do_s = q_s + kB * DP;    // [kB][DP]
  float* p_s = do_s + kB * DP;    // [kB q][kPP]
  float* ds_s = p_s + kB * kPP;   // [kB q][kPP]
  float* lse_s = ds_s + kB * kPP; // [kB]
  float* dl_s = lse_s + kB;       // [kB]
  int* qseg_s = reinterpret_cast<int*>(dl_s + kB);  // [kB]
  int* kseg_s = qseg_s + kB;                         // [kB]

  const int k0 = blockIdx.x * kB;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int rep = H / Hkv;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const bool segs = seg != nullptr;
  const size_t q_row = static_cast<size_t>(H) * D;
  const size_t kv_row = static_cast<size_t>(Hkv) * D;
  const size_t kv_off = static_cast<size_t>(b) * S * kv_row +
                        static_cast<size_t>(hk) * D;

  load_tile<T, D>(k_s, k + kv_off, kv_row, k0, S, 1.f);
  load_tile<T, D>(v_s, v + kv_off, kv_row, k0, S, 1.f);
  if (segs && tid < kB)
    kseg_s[tid] = k0 + tid < S ? seg[static_cast<size_t>(b) * S + k0 + tid]
                               : -2;

  float dk_acc[4][NC], dv_acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NC; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  const int n_q = (S + kB - 1) / kB;
  // Causal: q tiles before the diagonal see nothing of this k tile.
  const int q_first = causal ? blockIdx.x : 0;
  for (int hh = 0; hh < rep; ++hh) {
    const int h = hk * rep + hh;
    const size_t q_off = static_cast<size_t>(b) * S * q_row +
                         static_cast<size_t>(h) * D;
    const float* lse_h = lse + (static_cast<size_t>(b) * H + h) * S;
    const float* dl_h = delta + (static_cast<size_t>(b) * H + h) * S;
    for (int qi = q_first; qi < n_q; ++qi) {
      const int q0 = qi * kB;
      __syncthreads();  // the last tile's readers are done
      load_tile<T, D>(q_s, q + q_off, q_row, q0, S, scale);
      load_tile<T, D>(do_s, dout + q_off, q_row, q0, S, 1.f);
      if (tid < kB) {
        const int s = q0 + tid;
        lse_s[tid] = s < S ? lse_h[s] : 0.f;
        dl_s[tid] = s < S ? dl_h[s] : 0.f;
        if (segs)
          qseg_s[tid] = s < S ? seg[static_cast<size_t>(b) * S + s] : -1;
      }
      __syncthreads();

      float sc[4][4], dp[4][4];
      scores<D>(sc, dp, q_s, do_s, k_s, v_s, ty, tx);
      const bool edge =
          (causal && q0 < k0 + kB) || q0 + kB > S || k0 + kB > S || segs;
      probs(sc, dp, p_s, ds_s, lse_s, dl_s, qseg_s, kseg_s, edge, causal,
            segs, q0, k0, S, ty, tx);
      __syncthreads();

      // dV += P^T dO and dK += dS^T Qs: k rows ty*4 + i, columns
      // tx + 16*j, summed over the tile's q rows.
#pragma unroll 2
      for (int r = 0; r < kB; ++r) {
        float pv[4], sv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pv[i] = p_s[r * kPP + ty * 4 + i];
          sv[i] = ds_s[r * kPP + ty * 4 + i];
        }
#pragma unroll
        for (int j = 0; j < NC; ++j) {
          const float o = do_s[r * DP + tx + 16 * j];
          const float qq = q_s[r * DP + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            dv_acc[i][j] = fmaf(pv[i], o, dv_acc[i][j]);
            dk_acc[i][j] = fmaf(sv[i], qq, dk_acc[i][j]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = k0 + ty * 4 + i;
    if (s >= S) continue;
    const size_t row = kv_off + static_cast<size_t>(s) * kv_row;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      dk[row + tx + 16 * j] = from_f<T>(dk_acc[i][j]);
      dv[row + tx + 16 * j] = from_f<T>(dv_acc[i][j]);
    }
  }
}

// K3, bf16 body: wgmma on TMA tiles.
constexpr int kConsumers = 256;            // two warpgroups, 64 k rows each
constexpr int kThreadsTC = kConsumers + 128;  // and a producer warpgroup
constexpr int kBKT = 128;                  // k rows per block
constexpr int kBQT = 32;                   // q rows per stage
constexpr int kStages = 3;                 // Q / dO ring
constexpr float kLog2e = 1.4426950408889634f;
static_assert(kBQT == 32, "the producer warp loads one q row per lane");

// K and V (2 x kBKT x D) and the Q / dO ring (2 kStages x kBQT x D), bf16
// in TMA boxes; barriers (K/V, then full and empty per stage); per stage
// lse * log2 e, delta, q segment ids and a segment flag; k segment ids;
// 1 KB to align the boxes. dK and dV are staged at the end over K, V and
// the ring (2 x [kBKT][D + 8]).
template <int D>
constexpr size_t dkv_tc_smem_bytes() {
  return 1024 + sizeof(__nv_bfloat16) * (2 * kBKT + 2 * kStages * kBQT) * D +
         sizeof(uint64_t) * (1 + 2 * kStages) +
         sizeof(float) * 2 * kStages * kBQT +
         sizeof(int) * (kStages * kBQT + kStages + kBKT);
}

template <int D>
__global__ void __launch_bounds__(kThreadsTC, 1) flash_bwd_dkv_bf16_kernel(
    const __grid_constant__ CUtensorMap tq,
    const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv,
    const __grid_constant__ CUtensorMap tdo, const float* __restrict__ lse,
    const float* __restrict__ delta, const int* __restrict__ seg,
    sm90::bf16* __restrict__ dk, sm90::bf16* __restrict__ dv, int S, int H,
    int Hkv, int causal, float scale, float scale_log2) {
  using sm90::bf16;
  using Bx = sm90::Boxes<D>;
  constexpr int BC = Bx::BC;
  constexpr int ROW = Bx::ROW;
  constexpr int ND = D / 8;     // 8-wide output tiles
  constexpr int NS = kBQT / 8;  // 8-wide tiles of S^T per stage
  constexpr int KS = BC / 16;   // 16-deep steps per box
  constexpr int QT = kBQT * D;  // elements of one Q or dO tile
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  bf16* k_s = reinterpret_cast<bf16*>(base);  // NB boxes [kBKT][BC]
  bf16* v_s = k_s + kBKT * D;
  bf16* ring = v_s + kBKT * D;  // stage st: Q at 2 st QT, dO after it
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(ring + 2 * kStages * QT);
  uint64_t* full = kv_full + 1;      // [kStages]: the stage has landed
  uint64_t* empty = full + kStages;  // [kStages]: 8 consumer warps are done
  float* lse_s = reinterpret_cast<float*>(empty + kStages);  // [kStages][kBQT]
  float* dl_s = lse_s + kStages * kBQT;                      // [kStages][kBQT]
  int* qseg_s = reinterpret_cast<int*>(dl_s + kStages * kBQT);
  int* sflag_s = qseg_s + kStages * kBQT;  // [kStages]: a q row's segment
                                           // differs from the k tile's
  int* kseg_s = sflag_s + kStages;         // [kBKT]

  const int k0 = blockIdx.z * kBKT;  // k tile 0, the most work, first
  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const int rep = H / Hkv;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const bool segs = seg != nullptr;
  const int* sb = segs ? seg + static_cast<size_t>(b) * S : nullptr;

  if (tid == 0) {
    sm90::mbar_init(kv_full, 1);
    for (int i = 0; i < kStages; ++i) {
      sm90::mbar_init(&full[i], 1);
      sm90::mbar_init(&empty[i], kConsumers / 32);
    }
    sm90::fence_barrier_init();
  }
  // Segments: is the whole k tile one segment (then a q tile of that
  // same segment needs no element mask)?
  int ks0 = 0;
  bool k_uni = true;
  if (segs) {
    ks0 = sb[k0];
    int mine = -2;
    if (tid < kBKT) {
      mine = k0 + tid < S ? sb[k0 + tid] : -2;
      kseg_s[tid] = mine;
    }
    k_uni = __syncthreads_and(!(tid < kBKT && k0 + tid < S && mine != ks0));
  } else {
    __syncthreads();
  }

  // Steps: the group's q-heads, each over the q tiles from the diagonal.
  const int n_qt = (S + kBQT - 1) / kBQT;
  const int q_first = causal ? k0 / kBQT : 0;
  const int per_head = n_qt - q_first;
  const int n_steps = rep * per_head;

  if (tid >= kConsumers) {
    // The producer warpgroup gives its registers to the consumers; its
    // first warp issues every load.
    sm90::reg_dealloc<sm90::kProducerRegs>();
    if (tid >= kConsumers + 32) return;
    // Producer warp: K and V once, then the Q / dO ring with each step's
    // lse, delta and segment ids.
    if (lane == 0) {
      sm90::mbar_expect_tx(kv_full, 2 * kBKT * D * 2);
      for (int x = 0; x < Bx::NB; ++x) {
        sm90::tma_load_4d(k_s + x * kBKT * BC, &tk, kv_full, x * BC, hk, k0,
                          b);
        sm90::tma_load_4d(v_s + x * kBKT * BC, &tv, kv_full, x * BC, hk, k0,
                          b);
      }
    }
    for (int it = 0; it < n_steps; ++it) {
      const int st = it % kStages;
      const int h = hk * rep + it / per_head;
      const int q0 = (q_first + it % per_head) * kBQT;
      if (it >= kStages) sm90::mbar_wait(&empty[st], (it / kStages - 1) & 1);
      {
        const int s = q0 + lane;  // kBQT == 32: one row per lane
        const size_t row = (static_cast<size_t>(b) * H + h) * S;
        lse_s[st * kBQT + lane] = s < S ? lse[row + s] * kLog2e : 0.f;
        dl_s[st * kBQT + lane] = s < S ? delta[row + s] : 0.f;
        if (segs) {
          const int id = s < S ? sb[s] : -1;
          qseg_s[st * kBQT + lane] = id;
          const bool diff = __any_sync(0xffffffffu, s < S && id != ks0);
          if (lane == 0) sflag_s[st] = diff;
        }
        __threadfence_block();
        __syncwarp();
      }
      if (lane == 0) {
        bf16* qd = ring + 2 * st * QT;
        sm90::mbar_expect_tx(&full[st], 2 * QT * 2);
        for (int x = 0; x < Bx::NB; ++x) {
          sm90::tma_load_4d(qd + x * kBQT * BC, &tq, &full[st], x * BC, h,
                            q0, b);
          sm90::tma_load_4d(qd + QT + x * kBQT * BC, &tdo, &full[st], x * BC,
                            h, q0, b);
        }
      }
    }
    return;
  }

  sm90::reg_alloc<sm90::kConsumerRegs>();
  // Consumers: warpgroup wg owns k rows 64 wg .. 64 wg + 63.
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int r0 = wg * 64 + warp * 16 + g;  // this thread's k rows: r0, r0 + 8
  const bf16* kw = k_s + wg * 64 * BC;     // this warpgroup's K rows
  const bf16* vw = v_s + wg * 64 * BC;     // and V rows
  float dka[ND][4], dva[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.f;
  sm90::mbar_wait(kv_full, 0);

  for (int it = 0; it < n_steps; ++it) {
    const int st = it % kStages;
    const int q0 = (q_first + it % per_head) * kBQT;
    sm90::mbar_wait(&full[st], (it / kStages) & 1);
    const bf16* qs = ring + 2 * st * QT;
    const bf16* dos = qs + QT;
    const float* ls = lse_s + st * kBQT;
    const float* dls = dl_s + st * kBQT;
    const int* qsg = qseg_s + st * kBQT;

    // S^T = K Q^T and dP^T = V dO^T: K-major operands, one group.
    float pt[NS][4], dst[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) pt[j][e] = dst[j][e] = 0.f;
    sm90::fence_regs(pt);
    sm90::fence_regs(dst);
    sm90::wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int x = kk / KS;
      const int off = (kk % KS) * 16;
      const uint64_t dq =
          sm90::desc(qs + x * kBQT * BC + off, 0, 8 * ROW, Bx::LAYOUT);
      const uint64_t ddo =
          sm90::desc(dos + x * kBQT * BC + off, 0, 8 * ROW, Bx::LAYOUT);
      sm90::wgmma_ss(
          pt, sm90::desc(kw + x * kBKT * BC + off, 0, 8 * ROW, Bx::LAYOUT),
          dq);
      sm90::wgmma_ss(
          dst, sm90::desc(vw + x * kBKT * BC + off, 0, 8 * ROW, Bx::LAYOUT),
          ddo);
    }
    sm90::wg_commit();
    sm90::wg_wait<0>();
    sm90::fence_regs(pt);
    sm90::fence_regs(dst);

    // P^T = exp(S^T / sqrt(D) - lse) under the mask, in fp32, then
    // dS^T = P^T * (dP^T - delta).
    const bool edge = (causal && q0 < k0 + kBKT) || q0 + kBQT > S ||
                      k0 + kBKT > S || (segs && (sflag_s[st] || !k_uni));
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = j * 8 + 2 * t + (e & 1);  // q row in the stage
        float p = exp2f(pt[j][e] * scale_log2 - ls[c]);
        if (edge) {
          const int r = r0 + (e >> 1) * 8;      // k row in the tile
          bool ok = q0 + c < S && k0 + r < S;
          if (causal) ok = ok && k0 + r <= q0 + c;
          if (segs) ok = ok && qsg[c] == kseg_s[r];
          if (!ok) p = 0.f;
        }
        pt[j][e] = p;
        dst[j][e] = p * (dst[j][e] - dls[c]);
      }

    // dV += P^T dO and dK += dS^T Q: P^T and dS^T from registers as two
    // bf16 A operands each (hi and lo), dO and Q MN-major (16 q rows down
    // their rows per step). The 1/sqrt(D) of dK comes in the epilogue.
    uint32_t pa[2 * (kBQT / 16)][4], sa[2 * (kBQT / 16)][4];
#pragma unroll
    for (int kk = 0; kk < kBQT / 16; ++kk) {
      sm90::a_from_c(pa[2 * kk], pa[2 * kk + 1], pt, kk);
      sm90::a_from_c(sa[2 * kk], sa[2 * kk + 1], dst, kk);
    }
    sm90::fence_regs(dva);
    sm90::fence_regs(dka);
    sm90::fence_regs(pa);
    sm90::fence_regs(sa);
    sm90::wg_fence();
#pragma unroll
    for (int kk = 0; kk < kBQT / 16; ++kk) {
      const uint64_t ddo =
          sm90::desc(dos + kk * 16 * BC, kBQT * ROW, 8 * ROW, Bx::LAYOUT);
      const uint64_t dq =
          sm90::desc(qs + kk * 16 * BC, kBQT * ROW, 8 * ROW, Bx::LAYOUT);
      sm90::wgmma_rs(dva, pa[2 * kk + 1], ddo);
      sm90::wgmma_rs(dva, pa[2 * kk], ddo);
      sm90::wgmma_rs(dka, sa[2 * kk + 1], dq);
      sm90::wgmma_rs(dka, sa[2 * kk], dq);
    }
    sm90::wg_commit();
    sm90::wg_wait<0>();
    sm90::fence_regs(dva);
    sm90::fence_regs(dka);
    sm90::fence_regs(pa);
    sm90::fence_regs(sa);
    if (lane == 0) sm90::mbar_arrive(&empty[st]);  // this warp is done
  }

  // Stage dK and dV over K, V and the ring once both warpgroups are done
  // with them (every load was consumed), then store 16-byte rows.
  constexpr int LD = D + 8;
  bf16* dks = k_s;
  bf16* dvs = k_s + kBKT * LD;
  sm90::named_sync(1, kConsumers);
#pragma unroll
  for (int j = 0; j < ND; ++j) {
    const int c = j * 8 + 2 * t;
    *reinterpret_cast<uint32_t*>(dks + r0 * LD + c) =
        sm90::pack(dka[j][0] * scale, dka[j][1] * scale);
    *reinterpret_cast<uint32_t*>(dks + (r0 + 8) * LD + c) =
        sm90::pack(dka[j][2] * scale, dka[j][3] * scale);
    *reinterpret_cast<uint32_t*>(dvs + r0 * LD + c) =
        sm90::pack(dva[j][0], dva[j][1]);
    *reinterpret_cast<uint32_t*>(dvs + (r0 + 8) * LD + c) =
        sm90::pack(dva[j][2], dva[j][3]);
  }
  sm90::named_sync(1, kConsumers);
  const size_t kv_row = static_cast<size_t>(Hkv) * D;
  const size_t kv_off = static_cast<size_t>(b) * S * kv_row +
                        static_cast<size_t>(hk) * D;
  constexpr int CH = D / 8;  // 16-byte chunks per row
  for (int i = tid; i < kBKT * CH; i += kConsumers) {
    const int r = i / CH;
    const int c = i % CH;
    const int s = k0 + r;
    if (s >= S) continue;
    const size_t off = kv_off + static_cast<size_t>(s) * kv_row + c * 8;
    *reinterpret_cast<uint4*>(dk + off) =
        *reinterpret_cast<const uint4*>(dks + r * LD + c * 8);
    *reinterpret_cast<uint4*>(dv + off) =
        *reinterpret_cast<const uint4*>(dvs + r * LD + c * 8);
  }
}

// ---------------------------------------------------------------------------
// K4: dQ
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const int* __restrict__ seg, T* __restrict__ dq, int S, int H, int Hkv,
    int causal, float scale) {
  constexpr int DP = D + 1;
  constexpr int NC = D / 16;
  extern __shared__ float smem[];
  float* q_s = smem;              // [kB][DP], pre-scaled
  float* do_s = q_s + kB * DP;    // [kB][DP]
  float* k_s = do_s + kB * DP;    // [kB][DP]
  float* v_s = k_s + kB * DP;     // [kB][DP]
  float* ds_s = v_s + kB * DP;    // [kB q][kPP]
  float* lse_s = ds_s + kB * kPP; // [kB]
  float* dl_s = lse_s + kB;       // [kB]
  int* qseg_s = reinterpret_cast<int*>(dl_s + kB);  // [kB]
  int* kseg_s = qseg_s + kB;                         // [kB]

  const int q0 = blockIdx.x * kB;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const bool segs = seg != nullptr;
  const size_t q_row = static_cast<size_t>(H) * D;
  const size_t kv_row = static_cast<size_t>(Hkv) * D;
  const size_t q_off = static_cast<size_t>(b) * S * q_row +
                       static_cast<size_t>(h) * D;
  const size_t kv_off = static_cast<size_t>(b) * S * kv_row +
                        static_cast<size_t>(hk) * D;

  load_tile<T, D>(q_s, q + q_off, q_row, q0, S, scale);
  load_tile<T, D>(do_s, dout + q_off, q_row, q0, S, 1.f);
  if (tid < kB) {
    const int s = q0 + tid;
    const size_t st = (static_cast<size_t>(b) * H + h) * S;
    lse_s[tid] = s < S ? lse[st + s] : 0.f;
    dl_s[tid] = s < S ? delta[st + s] : 0.f;
    if (segs) qseg_s[tid] = s < S ? seg[static_cast<size_t>(b) * S + s] : -1;
  }

  float acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[i][j] = 0.f;

  int n_kv = (S + kB - 1) / kB;
  // Causal: k tiles past the diagonal contribute nothing.
  if (causal) n_kv = min(n_kv, static_cast<int>(blockIdx.x) + 1);
  for (int kj = 0; kj < n_kv; ++kj) {
    const int k0 = kj * kB;
    __syncthreads();  // the last tile's readers are done
    load_tile<T, D>(k_s, k + kv_off, kv_row, k0, S, 1.f);
    load_tile<T, D>(v_s, v + kv_off, kv_row, k0, S, 1.f);
    if (segs && tid < kB)
      kseg_s[tid] =
          k0 + tid < S ? seg[static_cast<size_t>(b) * S + k0 + tid] : -2;
    __syncthreads();

    float sc[4][4], dp[4][4];
    scores<D>(sc, dp, q_s, do_s, k_s, v_s, ty, tx);
    const bool edge =
        (causal && q0 < k0 + kB) || q0 + kB > S || k0 + kB > S || segs;
    probs(sc, dp, nullptr, ds_s, lse_s, dl_s, qseg_s, kseg_s, edge, causal,
          segs, q0, k0, S, ty, tx);
    __syncthreads();

    // dQ += dS K: q rows ty*4 + i, columns tx + 16*j.
#pragma unroll 2
    for (int c = 0; c < kB; ++c) {
      float sv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) sv[i] = ds_s[(ty * 4 + i) * kPP + c];
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const float kk = k_s[c * DP + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(sv[i], kk, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = q0 + ty * 4 + i;
    if (s >= S) continue;
    const size_t row = q_off + static_cast<size_t>(s) * q_row;
#pragma unroll
    for (int j = 0; j < NC; ++j)
      dq[row + tx + 16 * j] = from_f<T>(acc[i][j] * scale);
  }
}

// K4, bf16 body: wgmma on TMA tiles.
constexpr int kBQ4 = 128;    // q rows per block: two warpgroups of 64
constexpr int kBK4 = 64;     // k rows per stage
constexpr int kStages4 = 3;  // K / V ring

// Q and dO (2 x kBQ4 x D) and the K / V ring (2 kStages4 x kBK4 x D), bf16
// in TMA boxes; barriers (Q/dO, then full and empty per stage); the q
// tile's lse * log2 e, delta and segment ids; per stage k segment ids and
// a segment flag; 1 KB to align the boxes. dQ is staged at the end over
// the ring ([kBQ4][D + 8]).
template <int D>
constexpr size_t dq_tc_smem_bytes() {
  return 1024 + sizeof(__nv_bfloat16) * (2 * kBQ4 + 2 * kStages4 * kBK4) * D +
         sizeof(uint64_t) * (1 + 2 * kStages4) + sizeof(float) * 2 * kBQ4 +
         sizeof(int) * (kBQ4 + kStages4 * kBK4 + kStages4);
}

template <int D>
__global__ void __launch_bounds__(kThreadsTC, 1) flash_bwd_dq_bf16_kernel(
    const __grid_constant__ CUtensorMap tq,
    const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv,
    const __grid_constant__ CUtensorMap tdo, const float* __restrict__ lse,
    const float* __restrict__ delta, const int* __restrict__ seg,
    sm90::bf16* __restrict__ dq, int S, int H, int Hkv, int causal,
    float scale, float scale_log2) {
  using sm90::bf16;
  using Bx = sm90::Boxes<D>;
  constexpr int BC = Bx::BC;
  constexpr int ROW = Bx::ROW;
  constexpr int ND = D / 8;     // 8-wide dQ tiles
  constexpr int NS = kBK4 / 8;  // 8-wide tiles of S per stage
  constexpr int KS = BC / 16;   // 16-deep steps per box
  constexpr int QT = kBQ4 * D;  // elements of Q or dO
  constexpr int TILE = kBK4 * D;  // elements of one K or V tile
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  bf16* q_s = reinterpret_cast<bf16*>(base);  // NB boxes [kBQ4][BC]
  bf16* do_s = q_s + QT;
  bf16* ring = do_s + QT;  // stage st: K at 2 st TILE, V after it
  uint64_t* qd_full = reinterpret_cast<uint64_t*>(ring + 2 * kStages4 * TILE);
  uint64_t* full = qd_full + 1;       // [kStages4]: the stage has landed
  uint64_t* empty = full + kStages4;  // [kStages4]: 8 consumer warps are done
  float* lse_s = reinterpret_cast<float*>(empty + kStages4);  // [kBQ4]
  float* dl_s = lse_s + kBQ4;                                 // [kBQ4]
  int* qseg_s = reinterpret_cast<int*>(dl_s + kBQ4);          // [kBQ4]
  int* kseg_s = qseg_s + kBQ4;  // [kStages4][kBK4]
  int* sflag_s = kseg_s + kStages4 * kBK4;  // [kStages4]: a key's segment
                                            // differs from the q tile's

  // Heaviest q tiles first: under the causal mask tile i sweeps 2 i + 2
  // k tiles, and blocks are issued in order of blockIdx.z.
  const int n_q = (S + kBQ4 - 1) / kBQ4;
  const int q0 = (n_q - 1 - static_cast<int>(blockIdx.z)) * kBQ4;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const bool segs = seg != nullptr;
  const int* sb = segs ? seg + static_cast<size_t>(b) * S : nullptr;

  if (tid == 0) {
    sm90::mbar_init(qd_full, 1);
    for (int i = 0; i < kStages4; ++i) {
      sm90::mbar_init(&full[i], 1);
      sm90::mbar_init(&empty[i], kConsumers / 32);
    }
    sm90::fence_barrier_init();
  }
  // The q tile's rows of lse * log2 e and delta (rows past S: 0, never
  // stored) and, with segments, whether the whole tile is one segment
  // (then a k tile of that same segment needs no element mask).
  if (tid < kBQ4) {
    const int s = q0 + tid;
    const size_t row = (static_cast<size_t>(b) * H + h) * S;
    lse_s[tid] = s < S ? lse[row + s] * kLog2e : 0.f;
    dl_s[tid] = s < S ? delta[row + s] : 0.f;
  }
  int qs0 = 0;
  bool q_uni = true;
  if (segs) {
    qs0 = sb[q0];
    int mine = -1;
    if (tid < kBQ4) {
      mine = q0 + tid < S ? sb[q0 + tid] : -1;
      qseg_s[tid] = mine;
    }
    q_uni = __syncthreads_and(!(tid < kBQ4 && q0 + tid < S && mine != qs0));
  } else {
    __syncthreads();
  }

  // Causal: k tiles past the tile's last row contribute nothing.
  int n_kv = (S + kBK4 - 1) / kBK4;
  if (causal) n_kv = min(n_kv, (q0 + kBQ4 - 1) / kBK4 + 1);

  if (tid >= kConsumers) {
    // The producer warpgroup gives its registers to the consumers; its
    // first warp issues every load.
    sm90::reg_dealloc<sm90::kProducerRegs>();
    if (tid >= kConsumers + 32) return;
    // Producer warp: Q and dO once, then the K / V ring of kv-head
    // h / (H / Hkv), each stage with its k segment ids.
    const int hk = h / (H / Hkv);
    if (lane == 0) {
      sm90::mbar_expect_tx(qd_full, 2 * QT * 2);
      for (int x = 0; x < Bx::NB; ++x) {
        sm90::tma_load_4d(q_s + x * kBQ4 * BC, &tq, qd_full, x * BC, h, q0,
                          b);
        sm90::tma_load_4d(do_s + x * kBQ4 * BC, &tdo, qd_full, x * BC, h, q0,
                          b);
      }
    }
    for (int kj = 0; kj < n_kv; ++kj) {
      const int st = kj % kStages4;
      if (kj >= kStages4) sm90::mbar_wait(&empty[st], (kj / kStages4 - 1) & 1);
      if (segs) {
        bool diff = false;
        for (int i = lane; i < kBK4; i += 32) {
          const int s = kj * kBK4 + i;
          const int id = s < S ? sb[s] : -2;
          kseg_s[st * kBK4 + i] = id;
          diff = diff || (s < S && id != qs0);
        }
        diff = __any_sync(0xffffffffu, diff);
        if (lane == 0) sflag_s[st] = diff;
        __threadfence_block();
        __syncwarp();
      }
      if (lane == 0) {
        bf16* kd = ring + 2 * st * TILE;
        sm90::mbar_expect_tx(&full[st], 2 * TILE * 2);
        for (int x = 0; x < Bx::NB; ++x) {
          sm90::tma_load_4d(kd + x * kBK4 * BC, &tk, &full[st], x * BC, hk,
                            kj * kBK4, b);
          sm90::tma_load_4d(kd + TILE + x * kBK4 * BC, &tv, &full[st],
                            x * BC, hk, kj * kBK4, b);
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
  const int r0 = wg * 64 + warp * 16 + g;  // this thread's rows: r0, r0 + 8
  const bf16* qw = q_s + wg * 64 * BC;     // this warpgroup's Q rows
  const bf16* dw = do_s + wg * 64 * BC;    // and dO rows
  const float ls0 = lse_s[r0], ls1 = lse_s[r0 + 8];
  const float dl0 = dl_s[r0], dl1 = dl_s[r0 + 8];
  const int wq0 = q0 + wg * 64;  // this warpgroup's first q row
  float dqa[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[j][e] = 0.f;
  sm90::mbar_wait(qd_full, 0);

  for (int kj = 0; kj < n_kv; ++kj) {
    const int st = kj % kStages4;
    const int k0 = kj * kBK4;
    sm90::mbar_wait(&full[st], (kj / kStages4) & 1);
    // Causal: the tile's last k tile lies wholly above this warpgroup's
    // rows when it is the first warpgroup.
    if (causal && k0 > wq0 + 63) {
      if (lane == 0) sm90::mbar_arrive(&empty[st]);
      continue;
    }
    const bf16* ks = ring + 2 * st * TILE;
    const bf16* vs = ks + TILE;

    // S = Q K^T and dP = dO V^T: K-major operands, one group.
    float sc[NS][4], dp[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = dp[j][e] = 0.f;
    sm90::fence_regs(sc);
    sm90::fence_regs(dp);
    sm90::wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int x = kk / KS;
      const int off = (kk % KS) * 16;
      const uint64_t dk =
          sm90::desc(ks + x * kBK4 * BC + off, 0, 8 * ROW, Bx::LAYOUT);
      const uint64_t dv =
          sm90::desc(vs + x * kBK4 * BC + off, 0, 8 * ROW, Bx::LAYOUT);
      sm90::wgmma_ss(
          sc, sm90::desc(qw + x * kBQ4 * BC + off, 0, 8 * ROW, Bx::LAYOUT),
          dk);
      sm90::wgmma_ss(
          dp, sm90::desc(dw + x * kBQ4 * BC + off, 0, 8 * ROW, Bx::LAYOUT),
          dv);
    }
    sm90::wg_commit();
    sm90::wg_wait<0>();
    sm90::fence_regs(sc);
    sm90::fence_regs(dp);

    // P = exp(S / sqrt(D) - lse) under the mask, in fp32, then
    // dS = P * (dP - delta), in place of dP.
    const bool edge = (causal && k0 + kBK4 - 1 > wq0) || k0 + kBK4 > S ||
                      (segs && (sflag_s[st] || !q_uni));
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool hi = e >> 1;  // row r0 + 8
        float p = exp2f(sc[j][e] * scale_log2 - (hi ? ls1 : ls0));
        if (edge) {
          const int r = r0 + (e >> 1) * 8;      // q row in the tile
          const int c = j * 8 + 2 * t + (e & 1);  // k row in the stage
          bool ok = k0 + c < S;
          if (causal) ok = ok && k0 + c <= q0 + r;
          if (segs) ok = ok && qseg_s[r] == kseg_s[st * kBK4 + c];
          if (!ok) p = 0.f;
        }
        dp[j][e] = p * (dp[j][e] - (hi ? dl1 : dl0));
      }

    // dQ += dS K: dS from registers as two bf16 A operands (hi and lo), K
    // MN-major (16 k rows down its rows per step), as V is in the
    // forward's P V. The 1/sqrt(D) of dQ comes in the epilogue.
    uint32_t sa[2 * (kBK4 / 16)][4];
#pragma unroll
    for (int kk = 0; kk < kBK4 / 16; ++kk)
      sm90::a_from_c(sa[2 * kk], sa[2 * kk + 1], dp, kk);
    sm90::fence_regs(dqa);
    sm90::fence_regs(sa);
    sm90::wg_fence();
#pragma unroll
    for (int kk = 0; kk < kBK4 / 16; ++kk) {
      const uint64_t dk =
          sm90::desc(ks + kk * 16 * BC, kBK4 * ROW, 8 * ROW, Bx::LAYOUT);
      sm90::wgmma_rs(dqa, sa[2 * kk + 1], dk);
      sm90::wgmma_rs(dqa, sa[2 * kk], dk);
    }
    sm90::wg_commit();
    sm90::wg_wait<0>();
    sm90::fence_regs(dqa);
    sm90::fence_regs(sa);
    if (lane == 0) sm90::mbar_arrive(&empty[st]);  // this warp is done
  }

  // Stage dQ over the ring once both warpgroups are done with it (every
  // load was consumed), then store 16-byte rows.
  constexpr int LD = D + 8;
  bf16* qds = ring;
  sm90::named_sync(1, kConsumers);
#pragma unroll
  for (int j = 0; j < ND; ++j) {
    const int c = j * 8 + 2 * t;
    *reinterpret_cast<uint32_t*>(qds + r0 * LD + c) =
        sm90::pack(dqa[j][0] * scale, dqa[j][1] * scale);
    *reinterpret_cast<uint32_t*>(qds + (r0 + 8) * LD + c) =
        sm90::pack(dqa[j][2] * scale, dqa[j][3] * scale);
  }
  sm90::named_sync(1, kConsumers);
  const size_t q_row = static_cast<size_t>(H) * D;
  bf16* qb = dq + static_cast<size_t>(b) * S * q_row +
             static_cast<size_t>(h) * D;
  constexpr int CH = D / 8;  // 16-byte chunks per row
  for (int i = tid; i < kBQ4 * CH; i += kConsumers) {
    const int r = i / CH;
    const int c = i % CH;
    const int s = q0 + r;
    if (s < S)
      *reinterpret_cast<uint4*>(qb + static_cast<size_t>(s) * q_row + c * 8) =
          *reinterpret_cast<const uint4*>(qds + r * LD + c * 8);
  }
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const void* lse;
  const void* delta;
  const void* seg;
  void* out0;  // dK (K3) or dQ (K4)
  void* out1;  // dV (K3)
  int B, S, H, Hkv, causal;
  cudaStream_t stream;
};

template <int D>
int launch_dkv_bf16(const Args& a) {
  // TMA reads 16-byte aligned tensors; dK and dV are stored in 16-byte
  // rows.
  if ((reinterpret_cast<uintptr_t>(a.q) | reinterpret_cast<uintptr_t>(a.k) |
       reinterpret_cast<uintptr_t>(a.v) |
       reinterpret_cast<uintptr_t>(a.dout) |
       reinterpret_cast<uintptr_t>(a.out0) |
       reinterpret_cast<uintptr_t>(a.out1)) &
      15)
    return static_cast<int>(cudaErrorMisalignedAddress);
  constexpr int BC = sm90::Boxes<D>::BC;
  CUtensorMap tq, tk, tv, tdo;
  if (int e = sm90::bf16_map(&tq, a.q, D, a.H, a.S, a.B, BC, kBQT)) return e;
  if (int e = sm90::bf16_map(&tk, a.k, D, a.Hkv, a.S, a.B, BC, kBKT))
    return e;
  if (int e = sm90::bf16_map(&tv, a.v, D, a.Hkv, a.S, a.B, BC, kBKT))
    return e;
  if (int e = sm90::bf16_map(&tdo, a.dout, D, a.H, a.S, a.B, BC, kBQT))
    return e;
  auto kern = flash_bwd_dkv_bf16_kernel<D>;
  constexpr size_t smem = dkv_tc_smem_bytes<D>();
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const double scale = 1.0 / std::sqrt(static_cast<double>(D));
  dim3 grid(a.Hkv, a.B, (a.S + kBKT - 1) / kBKT);
  kern<<<grid, kThreadsTC, smem, a.stream>>>(
      tq, tk, tv, tdo, static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<const int*>(a.seg),
      static_cast<sm90::bf16*>(a.out0), static_cast<sm90::bf16*>(a.out1), a.S,
      a.H, a.Hkv, a.causal, static_cast<float>(scale),
      static_cast<float>(scale * 1.4426950408889634));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_dkv(const Args& a) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    return launch_dkv_bf16<D>(a);
  } else {
    auto kern = flash_bwd_dkv_kernel<T, D>;
    constexpr size_t smem = dkv_smem_bytes<D>();
    static bool configured = false;
    if (!configured) {
      cudaError_t e = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (e != cudaSuccess) return static_cast<int>(e);
      configured = true;
    }
    dim3 grid((a.S + kB - 1) / kB, a.Hkv, a.B);
    kern<<<grid, kThreads, smem, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
        static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
        static_cast<const int*>(a.seg), static_cast<T*>(a.out0),
        static_cast<T*>(a.out1), a.S, a.H, a.Hkv, a.causal,
        static_cast<float>(1.0 / std::sqrt(static_cast<double>(D))));
    return static_cast<int>(cudaGetLastError());
  }
}

template <int D>
int launch_dq_bf16(const Args& a) {
  // TMA reads 16-byte aligned tensors; dQ is stored in 16-byte rows.
  if ((reinterpret_cast<uintptr_t>(a.q) | reinterpret_cast<uintptr_t>(a.k) |
       reinterpret_cast<uintptr_t>(a.v) |
       reinterpret_cast<uintptr_t>(a.dout) |
       reinterpret_cast<uintptr_t>(a.out0)) &
      15)
    return static_cast<int>(cudaErrorMisalignedAddress);
  constexpr int BC = sm90::Boxes<D>::BC;
  CUtensorMap tq, tk, tv, tdo;
  if (int e = sm90::bf16_map(&tq, a.q, D, a.H, a.S, a.B, BC, kBQ4)) return e;
  if (int e = sm90::bf16_map(&tk, a.k, D, a.Hkv, a.S, a.B, BC, kBK4))
    return e;
  if (int e = sm90::bf16_map(&tv, a.v, D, a.Hkv, a.S, a.B, BC, kBK4))
    return e;
  if (int e = sm90::bf16_map(&tdo, a.dout, D, a.H, a.S, a.B, BC, kBQ4))
    return e;
  auto kern = flash_bwd_dq_bf16_kernel<D>;
  constexpr size_t smem = dq_tc_smem_bytes<D>();
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const double scale = 1.0 / std::sqrt(static_cast<double>(D));
  dim3 grid(a.H, a.B, (a.S + kBQ4 - 1) / kBQ4);
  kern<<<grid, kThreadsTC, smem, a.stream>>>(
      tq, tk, tv, tdo, static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<const int*>(a.seg),
      static_cast<sm90::bf16*>(a.out0), a.S, a.H, a.Hkv, a.causal,
      static_cast<float>(scale),
      static_cast<float>(scale * 1.4426950408889634));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_dq(const Args& a) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    return launch_dq_bf16<D>(a);
  } else {
    auto kern = flash_bwd_dq_kernel<T, D>;
    constexpr size_t smem = dq_smem_bytes<D>();
    static bool configured = false;
    if (!configured) {
      cudaError_t e = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (e != cudaSuccess) return static_cast<int>(e);
      configured = true;
    }
    dim3 grid((a.S + kB - 1) / kB, a.H, a.B);
    kern<<<grid, kThreads, smem, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
        static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
        static_cast<const int*>(a.seg), static_cast<T*>(a.out0), a.S, a.H,
        a.Hkv, a.causal,
        static_cast<float>(1.0 / std::sqrt(static_cast<double>(D))));
    return static_cast<int>(cudaGetLastError());
  }
}

template <typename T>
int dispatch(bool dkv, int D, const Args& a) {
  if (D == 32) return dkv ? launch_dkv<T, 32>(a) : launch_dq<T, 32>(a);
  if (D == 64) return dkv ? launch_dkv<T, 64>(a) : launch_dq<T, 64>(a);
  if (D == 128) return dkv ? launch_dkv<T, 128>(a) : launch_dq<T, 128>(a);
  return static_cast<int>(cudaErrorInvalidValue);
}

int run(bool dkv, int D, int dtype, const Args& a) {
  if (a.Hkv <= 0 || a.H % a.Hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.B * a.S * a.H == 0) return 0;
  if (dtype == 0) return dispatch<float>(dkv, D, a);
  if (dtype == 1) return dispatch<__nv_bfloat16>(dkv, D, a);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = float32 (FMA bodies), 1 = bfloat16 (the tensor-core
// bodies). seg may be null. Each returns the cudaError_t of its launch
// (0 = success).
extern "C" int flash_bwd_dkv_launch(const void* q, const void* k,
                                    const void* v, const void* dout,
                                    const void* lse, const void* delta,
                                    const void* seg, void* dk, void* dv,
                                    int B, int S, int H, int Hkv, int D,
                                    int causal, int dtype, void* stream) {
  const Args a{q, k, v, dout, lse, delta, seg, dk, dv, B, S, H, Hkv, causal,
               static_cast<cudaStream_t>(stream)};
  return run(true, D, dtype, a);
}

extern "C" int flash_bwd_dq_launch(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const void* lse, const void* delta,
                                   const void* seg, void* dq, int B, int S,
                                   int H, int Hkv, int D, int causal,
                                   int dtype, void* stream) {
  const Args a{q,  k,  v, dout, lse, delta, seg, dq, nullptr,
               B,  S,  H, Hkv,  causal, static_cast<cudaStream_t>(stream)};
  return run(false, D, dtype, a);
}
