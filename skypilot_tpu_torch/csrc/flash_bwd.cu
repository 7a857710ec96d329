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
//   K3: one block per (64-row k tile, kv-head, batch). K and V stay in
//       shared memory while the block loops over the group's H / Hkv
//       q-heads and, under the causal mask, over the q tiles from the
//       diagonal on. One block owns its kv-head's tile for the whole
//       group, so dK and dV are summed in registers without atomics and
//       the result does not depend on the order blocks run in.
//   K4: one block per (64-row q tile, head, batch), looping over the k
//       tiles up to the diagonal; kv-head h / (H / Hkv) is read directly,
//       so K/V are never expanded.
// Each of the 256 threads owns a 4 x 4 micro-tile of S and dP and a
// 4 x D/16 slice of each output accumulator in registers. Products use
// fp32 FMA; all accumulation is fp32 and each output is written once.
// Every shared tile row is padded by one float so the column walks of
// the products hit distinct banks. Only tiles that cross the diagonal,
// the sequence end or a segment boundary pay the element mask.
// Tensor cores (mma / wgmma) and TMA loads are the next step.
//
// Layouts: q, dO, dQ [B, S, H, D]; k, v, dK, dV [B, S, Hkv, D] (f32 or
// bf16, D = 32, 64 or 128); lse, delta [B, H, S] float32; segments
// [B, S] int32 or null.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kThreads = 256;
constexpr int kB = 64;       // rows of a q or k tile
constexpr int kPP = kB + 1;  // padded row of a P / dS tile

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
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

template <typename T, int D>
int launch_dkv(const Args& a) {
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

template <typename T, int D>
int launch_dq(const Args& a) {
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

// dtype: 0 = float32, 1 = bfloat16. seg may be null. Each returns the
// cudaError_t of its launch (0 = success).
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
