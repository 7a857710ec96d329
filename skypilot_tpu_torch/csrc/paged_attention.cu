// Paged attention over the block-table KV pool (Hopper, sm_90a): the
// decode body and the multi-row body of chunked prefill.
//
// Replaces the Pallas TPU kernel skypilot_tpu/ops/paged_attention.py
// (_kernel, driven by paged_attention). For each (slot b, kv-head g) it
// returns the unnormalized online-softmax stats (acc, m, l) of the slot's
// R query rows over logical blocks 0..span_blocks-1 of the slot's block
// table: acc = sum_c p_c * v_c (with V's int8 scale folded into p),
// m = running row max, l = sum_c p_c. Columns are masked by
// col < lengths[b]; rows past lengths[b], or behind a sentinel table
// entry (outside [0, n_blocks)), are never read. A slot of length 0
// reports m = -1e30, l = 0, acc = 0.
//
// Two bodies, chosen by the wrapper from R * hd: the decode body
// (paged_attention_kernel, below) for R * hd <= 4096, the few GQA rows of
// a decode step, and the multi-row body (paged_rows_kernel, after it) for
// the C * rep rows of a prefill chunk.
//
// The decode body. What bounds it: the bytes of the K/V rows below each
// slot's length (decode reads every cached row once per step and does
// ~4*R flops per element).
//
// Design: flash decoding. Each (slot, kv-head) sweep is cut into chunks
// of kChunk = 128 logical rows, and each chunk is a thread block of its
// own (grid: B * G by ceil(span rows / 128)); it reads its own table
// entries and length (no scalar prefetch). A chunk at or past the slot's
// length exits at once. Why 128 rows: at the serve shape (16 slots x 8
// kv-heads, spans of 3 blocks of 256) the live chunks number ~480, one
// wave at four blocks an SM, so long slots no longer serialise the
// launch while short ones idle; a chunk still streams four tiles through
// its ring, and a 4096-row slot merges only 32 partials.
//
// Loads: the chunk's 32-row K and V tiles are copied with cp.async (16
// bytes a thread, straight to shared memory) into a three-stage ring in
// their storage dtype, tile t + 2 issued before tile t is used; values
// are widened to fp32 in registers. Rows behind a sentinel or past the
// length are zero-filled without a read. Warp 0 carries each tile's int8
// scales in registers, loaded with the tile's copies and stored one step
// later, so their latency overlaps a tile of compute.
//
// Compute, fp32: scores with warp w on 8 of the tile's rows and each lane
// on hd/32 elements of the head dim; a transposing butterfly sums a
// lane's 8 partial dots across the warp (9 shuffles for 8 columns), so
// no thread runs an hd-long serial dot product. Online softmax with one
// warp per query row and one column per lane. P V with each thread on
// one head-dim column (two at hd 256) of its query rows, reading every
// V value once for all of them.
//
// Merge, in the same launch: with more than one live chunk, each writes
// its partial (acc, m, l) to a workspace and takes a ticket on its
// (slot, kv-head) counter; the last to finish merges all partials in
// chunk order (m = max m_i, l = sum l_i e^(m_i - m), acc = sum acc_i
// e^(m_i - m)) and resets the counter to 0. The bits do not depend on
// which block finishes last. A slot with one live chunk writes its stats
// directly. Empty partials (m = -1e30, l = 0) weigh 0.
//
// Pool layout [L, n_blocks, block_len, G, hd] (f32, bf16 or int8;
// hd = 32, 64, 128 or 256); int8 scales [L, n_blocks, G, block_len] bf16;
// q [B, G, R, hd] (f32 or bf16); table [B, table_stride] int32; lengths
// [B] int32; workspace [B * G, n_chunks, R * hd + 2 R] f32 (null for one
// chunk); counters [>= B * G] int32, zero between calls.
//
// The multi-row body. The chunk path hands it all C * rep query rows of a
// chunk for one (slot, kv-head) (2048 at llama3-8b, chunk 512, rep 4), with
// the same mask for every row (col < the chunk's start) and at most a
// span's rows of K/V (512 at max_len 1024). What bounds it: at that shape
// about 4 R hd start G = 4.3 GFLOP against ~15 MB (q, the K/V rows, the
// stats), 4.3 us of tensor-core time at the bf16 peak and 4.4 us of bytes:
// bytes and operations nearly equally, where an FMA body (67 TFLOP/s)
// would take two orders of magnitude longer. So the products run on
// tensor cores (mma.sync m16n8k16, bf16 operands, fp32
// accumulators), in the FlashAttention-2 layout: a thread block of 8
// warps takes 128 q rows of one (slot, kv-head), 16 rows a warp, with q
// held in registers as the A operand; 64-row K/V tiles stream through a
// two-stage cp.async ring in shared memory (rows padded by 8 elements
// against bank conflicts of the fragment loads), each row addressed through
// the table on its own, so a tile may cross physical blocks of any
// length. S = Q K^T accumulates in registers; the online softmax runs on
// the accumulators (quad shuffles for row max and sum); P enters P V as
// hi + lo bf16 (sm90::split), since one bf16 rounding of P breaks the
// tolerance in rows that attend to few keys. Float32 operands (an fp32 q
// or an fp32 pool) enter as hi + lo bf16 pairs too, with the product of
// the two lo halves dropped (about 2^-16 of each term): the same body then
// serves fp32 pools on tensor cores. Columns count only below the length
// and inside a real block (the same rule as the decode body; the engine's
// trash block, inside the pool, lies past every length); rows outside are
// zero-filled without a read and their p is 0. No split across the sweep
// and no atomics: two calls give equal bits. int8 pools are refused (by
// the wrapper, and here by an error code). Grid: ceil(R / 128) by B * G,
// 16 x 8 = 128 blocks at the serve chunk shape, one wave on 132 SMs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>
#include <type_traits>

#include "sm90.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;    // K/V rows per ring stage
constexpr int kChunk = 128;  // rows per thread block
constexpr int kStages = 3;
constexpr int kMaxAcc = 32;  // accumulators per thread: R*hd <= 4096
constexpr float kNegInf = -1e30f;
static_assert(kTile == 32, "the softmax puts one column on each lane");
static_assert(kTile == 8 * kWarps, "each warp scores 8 columns");
static_assert(kChunk % kTile == 0, "whole tiles per chunk");

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(int8_t x) {
  return static_cast<float>(x);
}
__device__ __forceinline__ float bf16_bits(unsigned short x) {
  return __uint_as_float(static_cast<uint32_t>(x) << 16);
}

// 16 bytes from global to shared memory, asynchronously; when !ok nothing
// is read and the 16 bytes are zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile(
      "cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
          static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
      "l"(src), "r"(ok ? 16 : 0)
      : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Waits until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// v[0..7] summed over the warp's 32 lanes: lane l returns the sum of
// v[(l >> 2) & 7]. Each step keeps the half of its values that its own
// lane bit selects and adds the partner's copy of that half.
__device__ __forceinline__ float warp_sum8(const float (&v)[8], int lane) {
  const bool b4 = lane & 16, b3 = lane & 8, b2 = lane & 4;
  float w[4], u[2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    w[i] = (b4 ? v[i + 4] : v[i]) +
           __shfl_xor_sync(0xffffffffu, b4 ? v[i] : v[i + 4], 16);
#pragma unroll
  for (int i = 0; i < 2; ++i)
    u[i] = (b3 ? w[i + 2] : w[i]) +
           __shfl_xor_sync(0xffffffffu, b3 ? w[i] : w[i + 2], 8);
  float x = (b2 ? u[1] : u[0]) +
            __shfl_xor_sync(0xffffffffu, b2 ? u[0] : u[1], 4);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Accumulator j of thread tid is element tid + j * kThreads of the
// [R][HD] output: head-dim column col(tid, j) of query row row(tid, j).
template <int HD>
__device__ __forceinline__ int acc_col(int tid, int j) {
  return HD <= kThreads ? tid % HD : tid + kThreads * (j & 1);
}
template <int HD>
__device__ __forceinline__ int acc_row(int tid, int j) {
  return HD <= kThreads ? tid / HD + j * (kThreads / HD) : j >> 1;
}

template <typename TQ, typename TKV, int HD, int NA>
__global__ void __launch_bounds__(kThreads, NA <= 4 ? 4 : 2)
    paged_attention_kernel(
        const TQ* __restrict__ q, const TKV* __restrict__ k_pool,
        const TKV* __restrict__ v_pool,
        const __nv_bfloat16* __restrict__ k_scale,
        const __nv_bfloat16* __restrict__ v_scale,
        const int* __restrict__ table, const int* __restrict__ lengths,
        float* __restrict__ acc_out, float* __restrict__ m_out,
        float* __restrict__ l_out, float* __restrict__ ws,
        int* __restrict__ tickets, int G, int R, int layer, int n_blocks,
        int block_len, int table_stride, int span_blocks, float scale) {
  constexpr int E = HD / 32;                  // head-dim elements per lane
  constexpr int EPV = 16 / sizeof(TKV);       // elements per 16 bytes
  constexpr int VPR = HD / EPV;               // 16-byte vectors per row
  constexpr int TILE = kTile * HD;            // elements of a K or V tile
  static_assert(VPR >= 1 && HD % 32 == 0, "rows of whole 16-byte vectors");
  extern __shared__ __align__(16) unsigned char smem[];
  TKV* ring = reinterpret_cast<TKV*>(smem);  // stage st: K at 2 st TILE, V
  float* q_s = reinterpret_cast<float*>(ring + 2 * kStages * TILE);
  float* p_s = q_s + R * HD;            // [R][kTile] scores, then weights
  float* m_s = p_s + R * kTile;         // [R]
  float* l_s = m_s + R;                 // [R]
  float* a_s = l_s + R;                 // [R] rescale factor of this tile
  float* ks_s = a_s + R;                // [kStages][kTile] int8 K scales
  float* vs_s = ks_s + kStages * kTile;  // [kStages][kTile] int8 V scales
  int* tab_s = reinterpret_cast<int*>(vs_s + kStages * kTile);
  __shared__ int last_s;

  const int bg = blockIdx.x;
  const int b = bg / G;
  const int g = bg - b * G;
  const int chunk = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const bool quant = k_scale != nullptr;
  const int n_acc = R * HD;
  const size_t out0 = static_cast<size_t>(bg) * n_acc;
  // Rows the sweep admits: below the length and inside the span.
  const int n_rows = max(0, min(lengths[b], span_blocks * block_len));
  const int n_live = (n_rows + kChunk - 1) / kChunk;

  if (n_live == 0) {  // nothing to read: the empty stats, once
    if (chunk == 0) {
      for (int i = tid; i < n_acc; i += kThreads) acc_out[out0 + i] = 0.f;
      if (tid < R) {
        m_out[static_cast<size_t>(bg) * R + tid] = kNegInf;
        l_out[static_cast<size_t>(bg) * R + tid] = 0.f;
      }
    }
    return;
  }
  if (chunk >= n_live) return;

  const int c0 = chunk * kChunk;  // the chunk's first logical row
  const int rows = min(kChunk, n_rows - c0);
  const int nt = (rows + kTile - 1) / kTile;
  const int j0 = c0 / block_len;  // its first table column
  const int n_tab = (c0 + rows - 1) / block_len - j0 + 1;
  for (int i = tid; i < n_tab; i += kThreads) {
    const int id = table[static_cast<size_t>(b) * table_stride + j0 + i];
    tab_s[i] = id >= 0 && id < n_blocks ? id : -1;  // -1: sentinel
  }
  __syncthreads();

  const size_t row_stride = static_cast<size_t>(G) * HD;
  const size_t layer_blocks = static_cast<size_t>(layer) * n_blocks;
  // The physical block of the chunk's row y, or -1 past the length or
  // behind a sentinel.
  auto block_of = [&](int y) -> int {
    return y < rows ? tab_s[(c0 + y) / block_len - j0] : -1;
  };

  auto issue = [&](int t) {  // tile t's K and V rows into its stage
    TKV* kd = ring + (t % kStages) * 2 * TILE;
    TKV* vd = kd + TILE;
    for (int i = tid; i < kTile * VPR; i += kThreads) {
      const int r = i / VPR;
      const int c = (i - r * VPR) * EPV;
      const int y = t * kTile + r;
      const int id = block_of(y);
      size_t off = 0;
      if (id >= 0)
        off = ((layer_blocks + id) * block_len + (c0 + y) % block_len) *
                  row_stride +
              static_cast<size_t>(g) * HD + c;
      cp_async16(kd + r * HD + c, k_pool + off, id >= 0);
      cp_async16(vd + r * HD + c, v_pool + off, id >= 0);
    }
  };

  // int8 scales: lane r of warp 0 loads row r's when the tile is issued
  // (scales(t)) and stores them at the next call, one step later.
  const auto* ks16 = reinterpret_cast<const unsigned short*>(k_scale);
  const auto* vs16 = reinterpret_cast<const unsigned short*>(v_scale);
  unsigned short sk = 0, sv = 0;
  int s_st = -1;  // the stage whose scales sk, sv hold
  auto scales = [&](int t) {
    if (!quant || warp != 0) return;
    if (s_st >= 0) {
      ks_s[s_st * kTile + lane] = bf16_bits(sk);
      vs_s[s_st * kTile + lane] = bf16_bits(sv);
    }
    s_st = -1;
    if (t < nt) {
      const int y = t * kTile + lane;
      const int id = block_of(y);
      sk = sv = 0;
      if (id >= 0) {
        const size_t o = ((layer_blocks + id) * G + g) * block_len +
                         (c0 + y) % block_len;
        sk = __ldg(ks16 + o);
        sv = __ldg(vs16 + o);
      }
      s_st = t % kStages;
    }
  };

  float acc[NA];
#pragma unroll
  for (int j = 0; j < NA; ++j) acc[j] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nt) issue(s);
    scales(s);
    cp_async_commit();
  }
  // q and the running stats while the first tiles are in flight (the
  // loop's first barrier publishes them).
  const TQ* qb = q + out0;
  for (int i = tid; i < n_acc; i += kThreads) q_s[i] = to_f(qb[i]) * scale;
  if (tid < R) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  for (int t = 0; t < nt; ++t) {
    const int tn = t + kStages - 1;
    if (tn < nt) issue(tn);
    scales(tn);
    cp_async_commit();
    cp_async_wait<kStages - 1>();  // tile t has landed
    __syncthreads();

    const int st = t % kStages;
    const TKV* kt = ring + st * 2 * TILE;
    const TKV* vt = kt + TILE;
    const int y0 = t * kTile;

    // Scores: warp w on rows 8 w .. 8 w + 7 of the tile, lane on
    // head-dim elements [E lane, E lane + E).
    {
      float kr[8][E];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < E; ++e)
          kr[j][e] = to_f(kt[(warp * 8 + j) * HD + lane * E + e]);
      const int col = warp * 8 + ((lane >> 2) & 7);
      const bool valid = block_of(y0 + col) >= 0;
      const float ksc = quant ? ks_s[st * kTile + col] : 1.f;
      for (int r = 0; r < R; ++r) {
        const float* qr = q_s + r * HD + lane * E;
        float part[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float s = 0.f;
#pragma unroll
          for (int e = 0; e < E; ++e) s = fmaf(qr[e], kr[j][e], s);
          part[j] = s;
        }
        const float x = warp_sum8(part, lane);
        if ((lane & 3) == 0) p_s[r * kTile + col] = valid ? x * ksc : kNegInf;
      }
    }
    __syncthreads();

    // Online softmax: one warp per query row, one column per lane.
    {
      const bool valid = block_of(y0 + lane) >= 0;
      for (int r = warp; r < R; r += kWarps) {
        const float s = p_s[r * kTile + lane];
        const float m_prev = m_s[r];
        const float m_new = fmaxf(m_prev, warp_max(valid ? s : kNegInf));
        float p = valid ? expf(s - m_new) : 0.f;
        const float sum = warp_sum(p);
        if (quant) p *= vs_s[st * kTile + lane];
        p_s[r * kTile + lane] = p;
        if (lane == 0) {
          const float alpha = expf(m_prev - m_new);
          m_s[r] = m_new;
          l_s[r] = l_s[r] * alpha + sum;
          a_s[r] = alpha;
        }
      }
    }
    __syncthreads();

    // acc = acc * alpha + P V: each V value read once for all of this
    // thread's rows, four columns of P at a time.
#pragma unroll
    for (int j = 0; j < NA; ++j)
      if (acc_row<HD>(tid, j) < R) acc[j] *= a_s[acc_row<HD>(tid, j)];
#pragma unroll 2
    for (int c = 0; c < kTile; c += 4) {
      float v[2][4];
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        v[0][cc] = to_f(vt[(c + cc) * HD + acc_col<HD>(tid, 0)]);
        if (HD > kThreads)
          v[1][cc] = to_f(vt[(c + cc) * HD + acc_col<HD>(tid, 1)]);
      }
#pragma unroll
      for (int j = 0; j < NA; ++j) {
        const int r = acc_row<HD>(tid, j);
        if (r < R) {
          const float4 p =
              *reinterpret_cast<const float4*>(p_s + r * kTile + c);
          const int h = HD > kThreads ? (j & 1) : 0;
          float a = acc[j];
          a = fmaf(p.x, v[h][0], a);
          a = fmaf(p.y, v[h][1], a);
          a = fmaf(p.z, v[h][2], a);
          a = fmaf(p.w, v[h][3], a);
          acc[j] = a;
        }
      }
    }
    __syncthreads();  // the stage and P are free for the next tile
  }

  if (n_live == 1) {  // the whole sweep: the stats themselves
#pragma unroll
    for (int j = 0; j < NA; ++j)
      if (acc_row<HD>(tid, j) < R) acc_out[out0 + tid + j * kThreads] = acc[j];
    if (tid < R) {
      m_out[static_cast<size_t>(bg) * R + tid] = m_s[tid];
      l_out[static_cast<size_t>(bg) * R + tid] = l_s[tid];
    }
    return;
  }

  // This chunk's partial into the workspace, then a ticket.
  const int part = n_acc + 2 * R;
  float* wb = ws + static_cast<size_t>(bg) * gridDim.y * part;
  float* wp = wb + static_cast<size_t>(chunk) * part;
#pragma unroll
  for (int j = 0; j < NA; ++j)
    if (acc_row<HD>(tid, j) < R) wp[tid + j * kThreads] = acc[j];
  if (tid < R) {
    wp[n_acc + tid] = m_s[tid];
    wp[n_acc + R + tid] = l_s[tid];
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) last_s = atomicAdd(&tickets[bg], 1) == n_live - 1;
  __syncthreads();
  if (!last_s) return;

  // The last chunk to finish merges every partial in chunk order (reads
  // bypass L1, which other blocks' writes do not reach) and returns the
  // counter to 0 for the next call.
  __threadfence();
  if (tid == 0) tickets[bg] = 0;
  if (tid < R) {
    float m = kNegInf;
    for (int i = 0; i < n_live; ++i)
      m = fmaxf(m, __ldcg(wb + static_cast<size_t>(i) * part + n_acc + tid));
    float l = 0.f;
    for (int i = 0; i < n_live; ++i) {
      const float* pi = wb + static_cast<size_t>(i) * part + n_acc;
      l += __ldcg(pi + R + tid) * expf(__ldcg(pi + tid) - m);
    }
    m_out[static_cast<size_t>(bg) * R + tid] = m;
    l_out[static_cast<size_t>(bg) * R + tid] = l;
    m_s[tid] = m;
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < NA; ++j) {
    const int r = acc_row<HD>(tid, j);
    if (r < R) {
      const int e = tid + j * kThreads;
      float a = 0.f;
      for (int i = 0; i < n_live; ++i) {
        const float* pi = wb + static_cast<size_t>(i) * part;
        a += __ldcg(pi + e) * expf(__ldcg(pi + n_acc + r) - m_s[r]);
      }
      acc_out[out0 + e] = a;
    }
  }
}

struct Args {
  const void *q, *k_pool, *v_pool, *k_scale, *v_scale, *table, *lengths;
  void *acc, *m, *l, *ws, *tickets;
  int B, G, R, layer, n_blocks, block_len, table_stride, span_blocks;
  cudaStream_t stream;
};

template <typename TQ, typename TKV, int HD, int NA>
int launch(const Args& a) {
  const size_t smem =
      sizeof(TKV) * 2 * kStages * kTile * HD +
      sizeof(float) * (static_cast<size_t>(a.R) * HD + a.R * kTile +
                       3 * a.R + 2 * kStages * kTile) +
      sizeof(int) * ((kChunk - 1) / a.block_len + 2);
  auto kern = paged_attention_kernel<TQ, TKV, HD, NA>;
  static size_t allowed = 0;  // the dynamic shared memory granted so far
  if (smem > allowed) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    allowed = smem;
  }
  const long long span_rows =
      static_cast<long long>(a.span_blocks) * a.block_len;
  const int n_chunks =
      span_rows > kChunk ? static_cast<int>((span_rows + kChunk - 1) / kChunk)
                         : 1;
  if (n_chunks > 1 && (a.ws == nullptr || a.tickets == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(a.B * a.G, n_chunks);
  kern<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const TQ*>(a.q), static_cast<const TKV*>(a.k_pool),
      static_cast<const TKV*>(a.v_pool),
      static_cast<const __nv_bfloat16*>(a.k_scale),
      static_cast<const __nv_bfloat16*>(a.v_scale),
      static_cast<const int*>(a.table), static_cast<const int*>(a.lengths),
      static_cast<float*>(a.acc), static_cast<float*>(a.m),
      static_cast<float*>(a.l), static_cast<float*>(a.ws),
      static_cast<int*>(a.tickets), a.G, a.R, a.layer, a.n_blocks,
      a.block_len, a.table_stride, a.span_blocks,
      static_cast<float>(1.0 / std::sqrt(static_cast<double>(HD))));
  return static_cast<int>(cudaGetLastError());
}

// Four accumulators a thread cover the decode rows (R * hd <= 512); up to
// kMaxAcc the rest.
template <typename TQ, typename TKV, int HD>
int launch_acc(const Args& a) {
  return a.R * HD <= 4 * kThreads ? launch<TQ, TKV, HD, 4>(a)
                                  : launch<TQ, TKV, HD, kMaxAcc>(a);
}

template <typename TQ, typename TKV>
int launch_hd(int hd, const Args& a) {
  switch (hd) {
    case 32: return launch_acc<TQ, TKV, 32>(a);
    case 64: return launch_acc<TQ, TKV, 64>(a);
    case 128: return launch_acc<TQ, TKV, 128>(a);
    case 256: return launch_acc<TQ, TKV, 256>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename TQ>
int launch_kv(int kv_dtype, int hd, const Args& a) {
  switch (kv_dtype) {
    case 0: return launch_hd<TQ, float>(hd, a);
    case 1: return launch_hd<TQ, __nv_bfloat16>(hd, a);
    case 2: return launch_hd<TQ, int8_t>(hd, a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ---------------------------------------------------------------------------
// The multi-row body
// ---------------------------------------------------------------------------

constexpr int kRowWarps = 8;
constexpr int kRowThreads = 32 * kRowWarps;
constexpr int kRowTile = 16 * kRowWarps;  // q rows a thread block
constexpr int kKeyTile = 64;              // K/V rows a ring stage
constexpr int kRowStages = 2;
constexpr int kPad = 8;                   // shared row padding, elements
static_assert(kKeyTile % 16 == 0, "whole 16-deep steps of P V");

// d += a b on tensor cores: m16n8k16, bf16 operands, fp32 accumulators.
// Per warp (lane = 4 gr + tc): a holds rows gr and gr + 8 at columns
// 2 tc, 2 tc + 1 and 2 tc + 8, 2 tc + 9; b0 holds rows 2 tc, 2 tc + 1 and
// b1 rows 2 tc + 8, 2 tc + 9 of column gr; d holds rows gr (d[0], d[1])
// and gr + 8 (d[2], d[3]) at columns 2 tc, 2 tc + 1. Two bf16 to a
// register, the lower index in the low half.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two elements as an operand register: a bf16 pair as it is (lo = 0), an
// fp32 pair as hi + lo bf16 pairs (sm90::split). pair_at reads p[0] and
// p[1] (4- or 8-byte aligned), pair two elements from anywhere.
__device__ __forceinline__ void pair_at(const __nv_bfloat16* p, uint32_t& hi,
                                        uint32_t& lo) {
  hi = *reinterpret_cast<const uint32_t*>(p);
  lo = 0;
}
__device__ __forceinline__ void pair_at(const float* p, uint32_t& hi,
                                        uint32_t& lo) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  sm90::split(v.x, v.y, hi, lo);
}
__device__ __forceinline__ void pair(__nv_bfloat16 x, __nv_bfloat16 y,
                                     uint32_t& hi, uint32_t& lo) {
  hi = static_cast<uint32_t>(__bfloat16_as_ushort(x)) |
       (static_cast<uint32_t>(__bfloat16_as_ushort(y)) << 16);
  lo = 0;
}
__device__ __forceinline__ void pair(float x, float y, uint32_t& hi,
                                     uint32_t& lo) {
  sm90::split(x, y, hi, lo);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <typename TQ, typename TKV, int HD>
__global__ void __launch_bounds__(kRowThreads, 1)
    paged_rows_kernel(const TQ* __restrict__ q,
                      const TKV* __restrict__ k_pool,
                      const TKV* __restrict__ v_pool,
                      const int* __restrict__ table,
                      const int* __restrict__ lengths,
                      float* __restrict__ acc_out, float* __restrict__ m_out,
                      float* __restrict__ l_out, int G, int R, int layer,
                      int n_blocks, int block_len, int table_stride,
                      int span_blocks, float scale) {
  constexpr bool kSplitQ = std::is_same_v<TQ, float>;
  constexpr bool kSplitKV = std::is_same_v<TKV, float>;
  constexpr int LD = HD + kPad;             // shared row stride, elements
  constexpr int EPV = 16 / sizeof(TKV);     // elements per 16-byte copy
  constexpr int VPR = HD / EPV;             // copies per row
  constexpr int NK = HD / 16;               // 16-deep steps over hd
  constexpr int ND = HD / 8;                // 8-wide tiles of the output
  constexpr int NS = kKeyTile / 8;          // 8-wide tiles of the scores
  constexpr int STAGE = 2 * kKeyTile * LD;  // K rows, then V rows
  static_assert(HD % 16 == 0 && VPR >= 1, "head dim of whole steps");
  extern __shared__ __align__(16) unsigned char smem[];
  TKV* ring = reinterpret_cast<TKV*>(smem);
  // Per stage and tile row: 1 if the row is a column the mask admits.
  int* ok_s = reinterpret_cast<int*>(ring + kRowStages * STAGE);

  const int bg = blockIdx.y;
  const int b = bg / G;
  const int g = bg - b * G;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int gr = lane >> 2;
  const int tc = lane & 3;
  const int row0 = blockIdx.x * kRowTile;
  const int ra = row0 + warp * 16 + gr;  // this thread's two q rows
  const int rb = ra + 8;
  const int n_rows = max(0, min(lengths[b], span_blocks * block_len));
  float* acc_b = acc_out + static_cast<size_t>(bg) * R * HD;
  float* m_b = m_out + static_cast<size_t>(bg) * R;
  float* l_b = l_out + static_cast<size_t>(bg) * R;

  if (n_rows == 0) {  // nothing to read: the empty stats
    for (int i = tid; i < kRowTile * HD; i += kRowThreads)
      if (row0 + i / HD < R) acc_b[static_cast<size_t>(row0) * HD + i] = 0.f;
    if (tid < kRowTile && row0 + tid < R) {
      m_b[row0 + tid] = kNegInf;
      l_b[row0 + tid] = 0.f;
    }
    return;
  }

  const size_t row_stride = static_cast<size_t>(G) * HD;
  const size_t layer_blocks = static_cast<size_t>(layer) * n_blocks;
  const int* tab = table + static_cast<size_t>(b) * table_stride;
  // Tile t's K and V rows into stage t % 2, each row through the table;
  // rows past the length or behind a sentinel are zeros, not reads.
  auto issue = [&](int t) {
    TKV* kd = ring + (t % kRowStages) * STAGE;
    TKV* vd = kd + kKeyTile * LD;
    for (int i = tid; i < kKeyTile * VPR; i += kRowThreads) {
      const int r = i / VPR;
      const int c = (i - r * VPR) * EPV;
      const int y = t * kKeyTile + r;
      int id = -1;
      if (y < n_rows) {
        id = __ldg(tab + y / block_len);
        if (id >= n_blocks) id = -1;
      }
      size_t off = 0;
      if (id >= 0)
        off = ((layer_blocks + id) * block_len + y % block_len) * row_stride +
              static_cast<size_t>(g) * HD + c;
      cp_async16(kd + r * LD + c, k_pool + off, id >= 0);
      cp_async16(vd + r * LD + c, v_pool + off, id >= 0);
      if (c == 0) ok_s[(t % kRowStages) * kKeyTile + r] = id >= 0;
    }
  };

  // q rows ra and rb as A operands (hi, and lo for an fp32 q); rows past
  // R are zeros, computed and never written.
  uint32_t qh[NK][4], ql[kSplitQ ? NK : 1][4];
  {
    const TQ* qb = q + static_cast<size_t>(bg) * R * HD;
#pragma unroll
    for (int kk = 0; kk < NK; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = (i & 1) ? rb : ra;
        uint32_t hi = 0, lo = 0;
        if (r < R)
          pair_at(qb + static_cast<size_t>(r) * HD + kk * 16 + (i >> 1) * 8 +
                      2 * tc,
                  hi, lo);
        qh[kk][i] = hi;
        ql[kSplitQ ? kk : 0][i] = lo;
      }
  }

  float o[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m_a = kNegInf, m_r = kNegInf, l_a = 0.f, l_r = 0.f;  // rows ra, rb

  const int nt = (n_rows + kKeyTile - 1) / kKeyTile;
  issue(0);
  cp_async_commit();
  for (int t = 0; t < nt; ++t) {
    if (t + 1 < nt) issue(t + 1);
    cp_async_commit();
    cp_async_wait<1>();  // tile t has landed
    __syncthreads();
    const TKV* kt = ring + (t % kRowStages) * STAGE;
    const TKV* vt = kt + kKeyTile * LD;
    const int* okt = ok_s + (t % kRowStages) * kKeyTile;

    // S = Q K^T: B operand column n is key n of the tile, K's rows as
    // stored.
    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NK; ++kk)
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const TKV* kr = kt + (j * 8 + gr) * LD + kk * 16 + 2 * tc;
        uint32_t b0h, b0l, b1h, b1l;
        pair_at(kr, b0h, b0l);
        pair_at(kr + 8, b1h, b1l);
        mma_bf16(s[j], qh[kk], b0h, b1h);
        if constexpr (kSplitQ) mma_bf16(s[j], ql[kk], b0h, b1h);
        if constexpr (kSplitKV) mma_bf16(s[j], qh[kk], b0l, b1l);
      }

    // Online softmax on the accumulators: s[j][0..1] are row ra's scores
    // at keys 8 j + 2 tc, 8 j + 2 tc + 1, s[j][2..3] row rb's.
    float mx_a = kNegInf, mx_r = kNegInf;
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x =
            okt[j * 8 + 2 * tc + (e & 1)] ? s[j][e] * scale : kNegInf;
        s[j][e] = x;
        if (e < 2)
          mx_a = fmaxf(mx_a, x);
        else
          mx_r = fmaxf(mx_r, x);
      }
    const float mn_a = fmaxf(m_a, quad_max(mx_a));
    const float mn_r = fmaxf(m_r, quad_max(mx_r));
    const float al_a = expf(m_a - mn_a), al_r = expf(m_r - mn_r);
    float sum_a = 0.f, sum_r = 0.f;
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = okt[j * 8 + 2 * tc + (e & 1)]
                            ? expf(s[j][e] - (e < 2 ? mn_a : mn_r))
                            : 0.f;
        s[j][e] = p;
        if (e < 2)
          sum_a += p;
        else
          sum_r += p;
      }
    l_a = l_a * al_a + quad_sum(sum_a);
    l_r = l_r * al_r + quad_sum(sum_r);
    m_a = mn_a;
    m_r = mn_r;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      o[n][0] *= al_a;
      o[n][1] *= al_a;
      o[n][2] *= al_r;
      o[n][3] *= al_r;
    }

    // O += P V: P's 8-wide tiles 2 kk, 2 kk + 1 are the A operand of
    // step kk (hi + lo); B operand column n is head-dim column n, rows
    // are keys (V's rows, read two at a time across rows).
#pragma unroll
    for (int kk = 0; kk < kKeyTile / 16; ++kk) {
      uint32_t ph[4], pl[4];
      sm90::a_from_c(ph, pl, s, kk);
      const TKV* v0 = vt + (kk * 16 + 2 * tc) * LD + gr;
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        const TKV* vp = v0 + n * 8;
        uint32_t b0h, b0l, b1h, b1l;
        pair(vp[0], vp[LD], b0h, b0l);
        pair(vp[8 * LD], vp[9 * LD], b1h, b1l);
        mma_bf16(o[n], ph, b0h, b1h);
        mma_bf16(o[n], pl, b0h, b1h);
        if constexpr (kSplitKV) mma_bf16(o[n], ph, b0l, b1l);
      }
    }
    __syncthreads();  // the stage is free for tile t + 2
  }

#pragma unroll
  for (int n = 0; n < ND; ++n) {
    const int c = n * 8 + 2 * tc;
    if (ra < R)
      *reinterpret_cast<float2*>(acc_b + static_cast<size_t>(ra) * HD + c) =
          make_float2(o[n][0], o[n][1]);
    if (rb < R)
      *reinterpret_cast<float2*>(acc_b + static_cast<size_t>(rb) * HD + c) =
          make_float2(o[n][2], o[n][3]);
  }
  if (tc == 0) {
    if (ra < R) {
      m_b[ra] = m_a;
      l_b[ra] = l_a;
    }
    if (rb < R) {
      m_b[rb] = m_r;
      l_b[rb] = l_r;
    }
  }
}

template <typename TQ, typename TKV, int HD>
int launch_rows(const Args& a) {
  const size_t smem =
      sizeof(TKV) * kRowStages * 2 * kKeyTile * (HD + kPad) +
      sizeof(int) * kRowStages * kKeyTile;
  auto kern = paged_rows_kernel<TQ, TKV, HD>;
  static size_t allowed = 0;  // the dynamic shared memory granted so far
  if (smem > allowed) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    allowed = smem;
  }
  dim3 grid((a.R + kRowTile - 1) / kRowTile, a.B * a.G);
  kern<<<grid, kRowThreads, smem, a.stream>>>(
      static_cast<const TQ*>(a.q), static_cast<const TKV*>(a.k_pool),
      static_cast<const TKV*>(a.v_pool), static_cast<const int*>(a.table),
      static_cast<const int*>(a.lengths), static_cast<float*>(a.acc),
      static_cast<float*>(a.m), static_cast<float*>(a.l), a.G, a.R, a.layer,
      a.n_blocks, a.block_len, a.table_stride, a.span_blocks,
      static_cast<float>(1.0 / std::sqrt(static_cast<double>(HD))));
  return static_cast<int>(cudaGetLastError());
}

template <typename TQ, typename TKV>
int launch_rows_hd(int hd, const Args& a) {
  switch (hd) {
    case 32: return launch_rows<TQ, TKV, 32>(a);
    case 64: return launch_rows<TQ, TKV, 64>(a);
    case 128: return launch_rows<TQ, TKV, 128>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename TQ>
int launch_rows_kv(int kv_dtype, int hd, const Args& a) {
  switch (kv_dtype) {
    case 0: return launch_rows_hd<TQ, float>(hd, a);
    case 1: return launch_rows_hd<TQ, __nv_bfloat16>(hd, a);
    default: return static_cast<int>(cudaErrorInvalidValue);  // int8
  }
}

}  // namespace

// Logical rows per thread block: the wrapper sizes the workspace with it.
extern "C" int paged_attention_chunk_rows() { return kChunk; }

// dtype codes: 0 = float32, 1 = bfloat16, 2 = int8 (pool only). ws holds
// B * G * ceil(span_blocks * block_len / chunk_rows) * (R * hd + 2 R)
// floats (null when that is one chunk); tickets >= B * G zeroed ints.
// Returns the cudaError_t of the launch (0 = success).
extern "C" int paged_attention_launch(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* table,
    const void* lengths, void* acc, void* m, void* l, void* ws,
    void* tickets, int B, int G, int R, int hd, int layer, int n_blocks,
    int block_len, int table_stride, int span_blocks, int q_dtype,
    int kv_dtype, void* stream) {
  if (R <= 0 || R * hd > kMaxAcc * kThreads || block_len <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B * G == 0) return 0;
  const Args a{q, k_pool, v_pool, k_scale, v_scale, table, lengths,
               acc, m, l, ws, tickets,
               B, G, R, layer, n_blocks, block_len, table_stride,
               span_blocks, static_cast<cudaStream_t>(stream)};
  if (q_dtype == 0) return launch_kv<float>(kv_dtype, hd, a);
  if (q_dtype == 1) return launch_kv<__nv_bfloat16>(kv_dtype, hd, a);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The multi-row body: the same arguments less the int8 scales, the
// workspace and the counters (it needs none). hd = 32, 64 or 128; pools
// float32 or bfloat16.
extern "C" int paged_attention_rows_launch(
    const void* q, const void* k_pool, const void* v_pool, const void* table,
    const void* lengths, void* acc, void* m, void* l, int B, int G, int R,
    int hd, int layer, int n_blocks, int block_len, int table_stride,
    int span_blocks, int q_dtype, int kv_dtype, void* stream) {
  if (R <= 0 || block_len <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (B * G == 0) return 0;
  const Args a{q, k_pool, v_pool, nullptr, nullptr, table, lengths,
               acc, m, l, nullptr, nullptr,
               B, G, R, layer, n_blocks, block_len, table_stride,
               span_blocks, static_cast<cudaStream_t>(stream)};
  if (q_dtype == 0) return launch_rows_kv<float>(kv_dtype, hd, a);
  if (q_dtype == 1) return launch_rows_kv<__nv_bfloat16>(kv_dtype, hd, a);
  return static_cast<int>(cudaErrorInvalidValue);
}
