// Paged attention over the block-table KV pool (Hopper, sm_90a): the
// decode body and the two multi-row bodies of chunked prefill.
//
// Replaces the Pallas TPU kernel skypilot_tpu/ops/paged_attention.py
// (_kernel, driven by paged_attention). For each (slot b, kv-head g) it
// returns the unnormalized online-softmax stats (acc, m, l) of the slot's
// R query rows over logical blocks 0..span_blocks-1 of the slot's block
// table: acc = sum_c p_c * v_c (with V's int8 scale folded into p),
// m = running row max, l = sum_c p_c. Columns count only below
// lengths[b] and in a block whose table entry lies in [0, n_blocks); a
// masked column adds exactly 0 to l and acc. A slot of length 0 reports
// m = -1e30, l = 0, acc = 0.
//
// Three bodies, chosen by the wrapper (ops/paged_attention.py) from the
// shapes and dtypes alone: the decode body (paged_attention_kernel,
// below) for R * hd <= 4096, the few GQA rows of a decode step; above
// that, for the C * rep rows of a prefill chunk, the wgmma + TMA body
// (paged_rows_tc_kernel, last) for a bf16 q on bf16 or int8 pools whose
// block length is 8, 16, 32 or a multiple of 64 (the chunk path's dtypes
// and the engine's 256), and the mma.sync body (paged_rows_kernel) for
// every other float case: fp32 pools (the engine's fp32 parity leg), an
// fp32 q, a bf16 pool of another block length. Each multi-row body has
// its own entry point; neither stands in for the other.
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
// The multi-row bodies replace the same _kernel in its chunk use
// (skypilot_tpu/infer/kvcache.py's chunk program calls it with all
// C * rep query rows of a chunk per (slot, kv-head): 2048 at llama3-8b,
// chunk 512, rep 4), with one mask for every row (col < the chunk's
// start) over the slot's rows below the start, up to the span rung:
// 4 R hd start G operations a chunk. What bounds them, by shape (bf16,
// H100 peaks):
//   serve chunk, start 512 of max_len 1024: 4.3 GFLOP against ~15 MB (q,
//     the K/V rows, the stats): 4.3 us of operations, 4.4 us of bytes,
//     both below a launch's fixed cost and the pipeline's fill;
//   long prompt, start 7680 (span 8192, llama3-8b's longest context):
//     64.4 GFLOP against ~44 MB (13 us): operations, 65.1 us at the bf16
//     peak (start 3584: 30 GFLOP, 30.4 us).
// An FMA body (67 TFLOP/s) would take 15x that; the products belong on
// the tensor cores.
//
// The wgmma + TMA body (bf16 q; bf16 or int8 pools) is K2's layout
// (flash_fwd.cu, sm90.cuh) with the block table in the loads and one mask
// for every row. One block per (128 q rows, slot, kv-head): a producer
// warpgroup, which gives its registers to the others (setmaxnreg), and
// two consumer warpgroups of 64 rows. Q's 128 x hd tile comes in once by
// TMA (sm90::bf16_map over q viewed as [B G][R][1][hd]), rows past R
// zero-filled by the hardware. Each layer of the pool [L, n_blocks, bl,
// G, hd] is a 4-d box space [n_blocks][bl][G][hd] (the map's base is the
// layer's first block), so a 64-key K or V tile inside one block is one
// box per 64 columns at (column, g, row in block, block id): the
// producer's first warp reads the slot's table entries itself, issues K
// and V as separate 128-byte-swizzled boxes into a 4-stage ring with a
// full and an empty mbarrier per stage, and writes each stage's 64-bit
// column mask. Block lengths that are multiples of 64 take one box per
// tile and column box; lengths 8, 16 and 32 take 64 / bl, each from its
// own entry; other lengths go to the mma.sync body (bf16) or are refused
// (int8). An entry outside [0, n_blocks), or a box wholly past the
// sweep's rows, is never a coordinate: block 0 is loaded instead and its
// keys masked. The engine's trash block lies inside the pool, so for its
// rows only col < length keeps them out.
//   Products: S = Q K^T by wgmma m64n64k16 from shared memory (K K-major
// as stored); the online softmax on the accumulators in log2 units (quad
// shuffles for max and sum; ex2 on the special-function unit), with the
// scale applied to fp32 S, folded into exp2's argument by one FMA where
// no column of the tile is masked; m converted back to natural-log units
// at the end, as the caller's merge expects. No column is causal, so the
// element mask runs only in a tile that crosses the sweep's end or holds
// a key behind an entry outside the pool, and there sets p to exactly 0:
// masked keys' V rows (block 0's, or real rows past the length) add
// 0 * v = 0, since the pools the engine writes hold only finite values
// (zero-initialised, infer/kvcache.py init_paged_cache, then written with
// finite rows). O += P V by wgmma with P from registers (sm90::a_from_c)
// as hi + lo bf16 and V MN-major: one rounding of P breaks the tolerance
// in rows that attend to few keys. A warp whose row maxima all hold skips
// the rescale of O (alpha is exactly 1: no bit changes).
//   int8 pools: the producer's first warp loads the int8 tiles by TMA
// (sm90::int8_map, unswizzled boxes) into an int8 ring; warps 1-3 widen
// each one into a bf16 stage in the swizzled layout TMA would have
// written (int8 -> bf16 is exact; byte permutes and a float add, no
// quarter-rate conversions), warp 1 also writing the tile's 64 K and V
// scales beside the mask, and fence it for wgmma. The consumers fold K's
// scale into S per column and V's into P on its way into P V (l sums the
// unscaled p), as the decode body does. The widening runs off the
// consumers' path.
//   Order: the two consumer warpgroups take turns issuing their products
// (named barriers 1 and 2, FA3's ping-pong), so one's softmax runs while
// the other's products hold the tensor cores; each turn issues P V of
// the previous tile with S of the current one, in one group. What holds
// it below its bound: P V's second product (P's lo half, 1/3 of the
// tensor work, so 2/3 of the bound at most) and the softmax's
// instruction stream (each scheduler holds one warp of each consumer
// warpgroup, so the softmax runs at the pace of its dependent
// instructions).
//   No split across the sweep (the decode body's ticket counters are not
// used) and no atomics: two calls give equal bits. Grid: ceil(R / 128) by
// B * G, 16 x 8 = 128 blocks at the serve chunk shape, one wave on 132
// SMs. Its times, as chip_smoke.py's multi-row lines print them on an
// H100 80GB HBM3 at 700 W (graph replay): 0.0242 ms at the serve chunk
// (18.2% of its bound), 0.0909 at start 3584 (33.5%), 0.1817 at start
// 7680 (35.9%), 0.0390 on int8 pools at the serve chunk.
//
// The mma.sync body (fp32 pools, fp32 q, other block lengths):
// mma.sync m16n8k16 in the FlashAttention-2 layout: a thread block of 8
// warps takes 128 q rows of one (slot, kv-head), 16 rows a warp, with q
// held in registers as the A operand; 64-row K/V tiles stream through a
// two-stage cp.async ring in shared memory (rows padded by 8 elements
// against bank conflicts of the fragment loads), each row addressed
// through the table on its own, so a tile may cross physical blocks of
// any length. The online softmax runs on the accumulators; P enters P V
// as hi + lo bf16. Float32 operands (an fp32 q or an fp32 pool) enter as
// hi + lo bf16 pairs too, with the product of the two lo halves dropped
// (about 2^-16 of each term): the same body serves fp32 pools on tensor
// cores, whose rounding the fp32 parity legs test against. Rows past the
// length or behind an entry outside the pool are zero-filled without a
// read and their p is 0. No split and no atomics. Grid as above. On
// float32 pools at the serve chunk it takes 0.0802 ms (chip_smoke.py,
// the same run), 80% of the float32 bound.

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

// ---------------------------------------------------------------------------
// The multi-row body on wgmma + TMA (bf16 q; bf16 or int8 pools)
// ---------------------------------------------------------------------------

constexpr int kTcConsumers = 256;  // two warpgroups, 64 q rows each
constexpr int kTcThreads = kTcConsumers + 128;  // and a producer warpgroup
constexpr int kTcRows = 128;                    // q rows a block
constexpr int kTcKeys = 64;                     // keys a ring stage
constexpr int kWideners = 96;                   // producer warps 1-3 (int8)
constexpr float kLn2 = 0.6931471805599453f;

// Ring depths and register budgets. bf16 pools: TMA fills the bf16 ring
// directly. int8 pools: TMA fills an int8 ring that producer warps 1-3
// widen into the bf16 ring; those warps keep a few more registers (the
// split still sums to the 168 a thread of one 384-thread block).
template <bool Q8>
struct TcRing {
  static constexpr int kStages = Q8 ? 3 : 4;   // bf16 stages
  static constexpr int kStages8 = Q8 ? 4 : 0;  // int8 stages
  static constexpr int kProducerRegs = Q8 ? 56 : sm90::kProducerRegs;
  static constexpr int kConsumerRegs = Q8 ? 224 : sm90::kConsumerRegs;
};

// Q (kTcRows x HD) and the bf16 ring (2 kStages x kTcKeys x HD) in TMA
// boxes, the int8 ring (2 kStages8 x kTcKeys x HD bytes), the barriers
// (Q, then full and empty per bf16 and per int8 stage), a column mask per
// bf16 stage and, for int8, the K and V scales of its 64 keys; 1 KB to
// align the boxes to the swizzle atom.
template <int HD, bool Q8>
constexpr size_t tc_smem_bytes() {
  using T = TcRing<Q8>;
  return 1024 + sizeof(__nv_bfloat16) * (kTcRows + 2 * T::kStages * kTcKeys) *
                    HD +
         2 * T::kStages8 * kTcKeys * HD +
         sizeof(uint64_t) * (1 + 2 * T::kStages + 2 * T::kStages8) +
         sizeof(uint64_t) * T::kStages +
         (Q8 ? sizeof(float) * 2 * T::kStages * kTcKeys : 0);
}

// int8 bytes 2 h and 2 h + 1 of `w` as a bf16 pair (exact): with the
// sign bit flipped a byte is x + 128, and 2^23 + x + 128 is a float whose
// low mantissa bits are that byte; less 2^23 + 128 it is x exactly, and a
// float of at most 8 significant bits is its own top 16 bits as a bf16.
// Byte permutes and adds, no quarter-rate conversion instructions.
__device__ __forceinline__ uint32_t widen2(uint32_t w, int h) {
  const uint32_t u = w ^ 0x80808080u;
  const float a = __uint_as_float(__byte_perm(u, 0x4b000000u, 0x7540 + 2 * h)) -
                  8388736.f;
  const float b =
      __uint_as_float(__byte_perm(u, 0x4b000000u, 0x7541 + 2 * h)) -
      8388736.f;
  return __byte_perm(__float_as_uint(a), __float_as_uint(b), 0x7632);
}

// 2^x by the special-function unit alone (flushing results below 2^-126,
// which weigh nothing next to a row's largest p of 1).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Arrive at named barrier `id` (of `n` threads) without waiting.
__device__ __forceinline__ void named_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// Makes this thread's ordinary shared-memory writes visible to the async
// proxy (wgmma reads the widened int8 tiles through it).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

template <int HD, bool Q8>
__global__ void __launch_bounds__(kTcThreads, 1) paged_rows_tc_kernel(
    const __grid_constant__ CUtensorMap tq,
    const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv,
    const __nv_bfloat16* __restrict__ k_scale,
    const __nv_bfloat16* __restrict__ v_scale,
    const int* __restrict__ table, const int* __restrict__ lengths,
    float* __restrict__ acc_out, float* __restrict__ m_out,
    float* __restrict__ l_out, int G, int R, int n_blocks, int block_len,
    int box_rows, int table_stride, int span_blocks, float scale_log2) {
  using sm90::bf16;
  using Ring = TcRing<Q8>;
  using Bx = sm90::Boxes<HD>;
  constexpr int BC = Bx::BC;
  constexpr int ROW = Bx::ROW;
  constexpr int KS = BC / 16;         // 16-deep steps per box
  constexpr int ND = HD / 8;          // 8-wide output tiles
  constexpr int NS = kTcKeys / 8;     // 8-wide score tiles per stage
  constexpr int TILE = kTcKeys * HD;  // elements of one K or V tile
  constexpr int S = Ring::kStages;
  constexpr int S8 = Ring::kStages8;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  bf16* q_s = reinterpret_cast<bf16*>(base);  // NB boxes [kTcRows][BC]
  bf16* ring = q_s + kTcRows * HD;  // stage st: K at 2 st TILE, V after it
  int8_t* ring8 = reinterpret_cast<int8_t*>(ring + 2 * S * TILE);  // [64][HD]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(ring8 + 2 * S8 * TILE);
  uint64_t* full = q_full + 1;     // [S]: the bf16 stage is ready
  uint64_t* empty = full + S;      // [S]: 8 consumer warps are done
  uint64_t* full8 = empty + S;     // [S8]: the int8 stage has landed
  uint64_t* empty8 = full8 + S8;   // [S8]: the wideners are done
  uint64_t* vmask_s = empty8 + S8;  // [S]: bit c = key c counts
  float* ksc_s = reinterpret_cast<float*>(vmask_s + S);  // [S][kTcKeys]
  float* vsc_s = ksc_s + S * kTcKeys;                     // [S][kTcKeys]

  const int bg = blockIdx.y;
  const int b = bg / G;
  const int g = bg - b * G;
  const int row0 = blockIdx.x * kTcRows;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int n_rows = max(0, min(lengths[b], span_blocks * block_len));
  float* acc_b = acc_out + static_cast<size_t>(bg) * R * HD;
  float* m_b = m_out + static_cast<size_t>(bg) * R;
  float* l_b = l_out + static_cast<size_t>(bg) * R;

  if (n_rows == 0) {  // nothing to read: the empty stats
    for (int i = tid; i < kTcRows * HD; i += kTcThreads)
      if (row0 + i / HD < R) acc_b[static_cast<size_t>(row0) * HD + i] = 0.f;
    if (tid < kTcRows && row0 + tid < R) {
      m_b[row0 + tid] = kNegInf;
      l_b[row0 + tid] = 0.f;
    }
    return;
  }
  const int nt = (n_rows + kTcKeys - 1) / kTcKeys;

  if (tid == 0) {
    sm90::mbar_init(q_full, 1);
    for (int i = 0; i < S; ++i) {
      sm90::mbar_init(&full[i], Q8 ? kWideners : 1);
      sm90::mbar_init(&empty[i], kTcConsumers / 32);
    }
    for (int i = 0; i < S8; ++i) {
      sm90::mbar_init(&full8[i], 1);
      sm90::mbar_init(&empty8[i], kWideners);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (tid >= kTcConsumers) {
    sm90::reg_dealloc<Ring::kProducerRegs>();
    const int pw = (tid - kTcConsumers) / 32;
    const int* tab = table + static_cast<size_t>(b) * table_stride;

    // Tile kj's column mask (and int8 scales) into bf16 stage st, one
    // warp, two keys a lane. A key counts below the sweep's rows and in
    // a block whose table entry lies in [0, n_blocks).
    auto tile_meta = [&](int kj, int st) {
      uint64_t vm = 0;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = lane + 32 * h;
        const int y = kj * kTcKeys + c;
        int id = -1;
        if (y < n_rows) {
          id = __ldg(tab + y / block_len);
          if (id >= n_blocks) id = -1;
        }
        vm |= static_cast<uint64_t>(__ballot_sync(0xffffffffu, id >= 0))
              << (32 * h);
        if (Q8) {
          float sk = 0.f, sv = 0.f;
          if (id >= 0) {
            const size_t o =
                (static_cast<size_t>(id) * G + g) * block_len + y % block_len;
            sk = __bfloat162float(k_scale[o]);
            sv = __bfloat162float(v_scale[o]);
          }
          ksc_s[st * kTcKeys + c] = sk;
          vsc_s[st * kTcKeys + c] = sv;
        }
      }
      if (lane == 0) vmask_s[st] = vm;
      __threadfence_block();
      __syncwarp();
    };

    if (pw == 0) {
      // Producer warp: Q once, then every K/V tile. A tile is one box of
      // 64 rows per column box when the block length is a multiple of 64
      // (the tile lies in one block), else 64 / block_len boxes, each
      // from its own table entry. An entry outside [0, n_blocks), or a
      // box wholly past the sweep's rows, loads the layer's block 0
      // instead: its rows are masked (p = 0), and the pools hold only
      // finite values (zero-initialised, kvcache.init_paged_cache, then
      // written with finite rows), so 0 * v adds exactly 0.
      if (lane == 0) {
        sm90::mbar_expect_tx(q_full, kTcRows * HD * 2);
        for (int x = 0; x < Bx::NB; ++x)
          sm90::tma_load_4d(q_s + x * kTcRows * BC, &tq, q_full, x * BC, 0,
                            row0, bg);
      }
      for (int kj = 0; kj < nt; ++kj) {
        const int st = kj % (Q8 ? S8 : S);
        const int use = kj / (Q8 ? S8 : S);
        if (use > 0)
          sm90::mbar_wait(Q8 ? &empty8[st] : &empty[st], (use - 1) & 1);
        if (!Q8) tile_meta(kj, st);
        if (lane == 0) {
          uint64_t* bar = Q8 ? &full8[st] : &full[st];
          sm90::mbar_expect_tx(bar, 2 * TILE * (Q8 ? 1 : 2));
          for (int i = 0; i < kTcKeys; i += box_rows) {
            const int y = kj * kTcKeys + i;
            int id = 0, row = 0;
            if (y < n_rows) {
              const int e = __ldg(tab + y / block_len);
              if (e >= 0 && e < n_blocks) id = e;
              row = y % block_len;
            }
            if (Q8) {
              int8_t* kd = ring8 + 2 * st * TILE + i * HD;
              sm90::tma_load_4d(kd, &tk, bar, 0, g, row, id);
              sm90::tma_load_4d(kd + TILE, &tv, bar, 0, g, row, id);
            } else {
              bf16* kd = ring + 2 * st * TILE + i * BC;
              for (int x = 0; x < Bx::NB; ++x) {
                sm90::tma_load_4d(kd + x * kTcKeys * BC, &tk, bar, x * BC, g,
                                  row, id);
                sm90::tma_load_4d(kd + TILE + x * kTcKeys * BC, &tv, bar,
                                  x * BC, g, row, id);
              }
            }
          }
        }
      }
      return;
    }

    if constexpr (Q8) {
      // int8: warps 1-3 widen each landed int8 tile into a bf16 stage in
      // the swizzled layout TMA would have written (int8 -> bf16 is exact),
      // warp 1 also writing the stage's mask and scales; then each thread
      // fences its writes for wgmma and arrives.
      const int wt = tid - kTcConsumers - 32;  // 0 .. kWideners - 1
      constexpr int CPR = HD / 16;             // 16-byte int8 chunks a row
      constexpr uint32_t kSwz = ROW == 128 ? 0x70 : 0x30;
      for (int kj = 0; kj < nt; ++kj) {
        const int st8 = kj % S8;
        const int st = kj % S;
        sm90::mbar_wait(&full8[st8], (kj / S8) & 1);
        if (kj >= S) sm90::mbar_wait(&empty[st], (kj / S - 1) & 1);
        if (pw == 1) tile_meta(kj, st);
        const int8_t* src = ring8 + 2 * st8 * TILE;
        unsigned char* dst =
            reinterpret_cast<unsigned char*>(ring + 2 * st * TILE);
        for (int i = wt; i < 2 * kTcKeys * CPR; i += kWideners) {
          const int kv = i / (kTcKeys * CPR);  // 0 = K, 1 = V
          const int rem = i - kv * kTcKeys * CPR;
          const int r = rem / CPR;
          const int c = (rem - r * CPR) * 16;
          const uint4 raw =
              *reinterpret_cast<const uint4*>(src + kv * TILE + r * HD + c);
          const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
          uint32_t o[8];
#pragma unroll
          for (int j = 0; j < 8; ++j) o[j] = widen2(w[j / 2], j % 2);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int cc = c + 8 * h;
            const uint32_t off = r * ROW + (cc % BC) * 2;
            *reinterpret_cast<uint4*>(
                dst + 2 * (kv * TILE + (cc / BC) * kTcKeys * BC) +
                (off ^ ((off >> 3) & kSwz))) =
                make_uint4(o[4 * h], o[4 * h + 1], o[4 * h + 2], o[4 * h + 3]);
          }
        }
        fence_proxy_async();
        sm90::mbar_arrive(&full[st]);
        sm90::mbar_arrive(&empty8[st8]);
      }
    }
    return;
  }

  sm90::reg_alloc<Ring::kConsumerRegs>();
  // Consumers: warpgroup wg owns q rows 64 wg .. 64 wg + 63 of the tile.
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int gq = lane / 4;
  const int t = lane % 4;
  float acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  // This thread's rows are r0 and r0 + 8 of the tile; m in log2 units,
  // l a partial sum over the thread's columns (the quad's sum at the end).
  const int r0 = wg * 64 + warp * 16 + gq;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
  const bf16* qw = q_s + wg * 64 * BC;  // this warpgroup's Q rows
  float sc[NS][4];                      // S of the current tile, then P
  uint32_t pa[2 * (kTcKeys / 16)][4];   // P of the previous tile, hi + lo

  // S = Q K^T of stage st into sc: both K-major, 16 columns of the head
  // dim per step.
  auto issue_s = [&](int st) {
    const bf16* ks = ring + 2 * st * TILE;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const int x = kk / KS;
      const int off = (kk % KS) * 16;
      sm90::wgmma_ss(
          sc, sm90::desc(qw + x * kTcRows * BC + off, 0, 8 * ROW, Bx::LAYOUT),
          sm90::desc(ks + x * kTcKeys * BC + off, 0, 8 * ROW, Bx::LAYOUT));
    }
  };
  // O += P V of stage st: P from registers (hi and lo), V MN-major (16
  // keys down its rows per step).
  auto issue_pv = [&](int st) {
    const bf16* vs = ring + 2 * st * TILE + TILE;
#pragma unroll
    for (int kk = 0; kk < kTcKeys / 16; ++kk) {
      const uint64_t dv =
          sm90::desc(vs + kk * 16 * BC, kTcKeys * ROW, 8 * ROW, Bx::LAYOUT);
      sm90::wgmma_rs(acc, pa[2 * kk + 1], dv);
      sm90::wgmma_rs(acc, pa[2 * kk], dv);
    }
  };
  auto zero_s = [&] {
#pragma unroll
    for (int j = 0; j < NS; ++j)
      sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
  };
  auto fence_all = [&] {
    sm90::fence_regs(sc);
    sm90::fence_regs(acc);
    sm90::fence_regs(pa);
  };

  // The online softmax of tile kj (stage st) on the registers: scores in
  // log2 units with K's int8 scale per column; no column is causal, so
  // only a tile that crosses the sweep's end (or holds a key behind an
  // entry outside the pool) pays the element mask, and there a masked
  // key's p is exactly 0. The 4 threads of a quad share rows r0 and
  // r0 + 8. Leaves P (V's int8 scale folded in) in pa and acc rescaled.
  auto softmax = [&](int st) {
    const uint64_t vm = vmask_s[st];
    const bool edge = vm != ~0ull;
    auto ok = [&](int j, int e) {
      return ((vm >> (j * 8 + 2 * t + (e & 1))) & 1) != 0;
    };
    // A bf16 tile inside the sweep keeps its raw scores: max and scale
    // commute, and the scale folds into exp2's argument (one FMA).
    float sl = scale_log2;
    if (Q8 || edge) {
      sl = 1.f;
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        float2 ksc = make_float2(1.f, 1.f);
        if (Q8)
          ksc = *reinterpret_cast<const float2*>(ksc_s + st * kTcKeys +
                                                 j * 8 + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = sc[j][e] * scale_log2;
          if (Q8) x *= (e & 1) ? ksc.y : ksc.x;
          if (edge && !ok(j, e)) x = kNegInf;
          sc[j][e] = x;
        }
      }
    }
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      mx0 = fmaxf(mx0, fmaxf(sc[j][0], sc[j][1]));
      mx1 = fmaxf(mx1, fmaxf(sc[j][2], sc[j][3]));
    }
    const float mn0 = fmaxf(m0, quad_max(mx0) * sl);
    const float mn1 = fmaxf(m1, quad_max(mx1) * sl);
    const float al0 = ex2(m0 - mn0);
    const float al1 = ex2(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = ex2(fmaf(sc[j][e], sl, -(e < 2 ? mn0 : mn1)));
        if (edge && !ok(j, e)) p = 0.f;
        sc[j][e] = p;
      }
      ps0 += sc[j][0] + sc[j][1];
      ps1 += sc[j][2] + sc[j][3];
    }
    l0 = l0 * al0 + ps0;
    l1 = l1 * al1 + ps1;
    if (Q8) {  // V's scale enters P on its way into P V, not l
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const float2 vsc = *reinterpret_cast<const float2*>(
            vsc_s + st * kTcKeys + j * 8 + 2 * t);
        sc[j][0] *= vsc.x;
        sc[j][1] *= vsc.y;
        sc[j][2] *= vsc.x;
        sc[j][3] *= vsc.y;
      }
    }
    // Past the first tiles the row max rarely moves: a warp whose rows
    // all keep theirs (alpha exactly 1) skips the rescale, which would
    // change no bit.
    if (__any_sync(0xffffffffu, al0 != 1.f || al1 != 1.f)) {
#pragma unroll
      for (int j = 0; j < ND; ++j) {
        acc[j][0] *= al0;
        acc[j][1] *= al0;
        acc[j][2] *= al1;
        acc[j][3] *= al1;
      }
    }
#pragma unroll
    for (int kk = 0; kk < kTcKeys / 16; ++kk)
      sm90::a_from_c(pa[2 * kk], pa[2 * kk + 1], sc, kk);
  };

  // Ping-pong: the warpgroups take turns issuing their products (named
  // barrier 1 + wg is this warpgroup's turn, given by the other's
  // arrival), so one's softmax runs while the other's products hold the
  // tensor cores. Each turn issues P V of the previous tile with S of
  // the current one, in one group, and the softmax follows the wait.
  // Both warpgroups take nt + 1 turns; the last turn's hand-over (by
  // warpgroup 1) would have no taker and is left out.
  const int mine = 1 + wg;
  const int other = 2 - wg;
  sm90::mbar_wait(q_full, 0);
  if (wg == 1) named_arrive(other, kTcConsumers);  // warpgroup 0 first

  sm90::mbar_wait(&full[0], 0);
  sm90::named_sync(mine, kTcConsumers);
  zero_s();
  fence_all();
  sm90::wg_fence();
  issue_s(0);
  sm90::wg_commit();
  named_arrive(other, kTcConsumers);
  sm90::wg_wait<0>();
  fence_all();
  softmax(0);

  for (int kj = 1; kj < nt; ++kj) {
    const int st = kj % S;
    const int sp = (kj - 1) % S;
    sm90::mbar_wait(&full[st], (kj / S) & 1);
    sm90::named_sync(mine, kTcConsumers);
    zero_s();
    fence_all();
    sm90::wg_fence();
    issue_pv(sp);
    issue_s(st);
    sm90::wg_commit();
    named_arrive(other, kTcConsumers);
    sm90::wg_wait<0>();
    fence_all();
    if (lane == 0) sm90::mbar_arrive(&empty[sp]);  // this warp is done
    softmax(st);
  }

  {
    const int sp = (nt - 1) % S;
    sm90::named_sync(mine, kTcConsumers);
    fence_all();
    sm90::wg_fence();
    issue_pv(sp);
    sm90::wg_commit();
    if (wg == 0) named_arrive(other, kTcConsumers);
    sm90::wg_wait<0>();
    fence_all();
    if (lane == 0) sm90::mbar_arrive(&empty[sp]);
  }

  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const int ra = row0 + r0;
  const int rb = ra + 8;
#pragma unroll
  for (int j = 0; j < ND; ++j) {
    const int c = j * 8 + 2 * t;
    if (ra < R)
      *reinterpret_cast<float2*>(acc_b + static_cast<size_t>(ra) * HD + c) =
          make_float2(acc[j][0], acc[j][1]);
    if (rb < R)
      *reinterpret_cast<float2*>(acc_b + static_cast<size_t>(rb) * HD + c) =
          make_float2(acc[j][2], acc[j][3]);
  }
  // m back in natural-log units (the caller merges with exp); a row that
  // no key reached keeps exactly -1e30.
  if (t == 0) {
    if (ra < R) {
      m_b[ra] = m0 == kNegInf ? kNegInf : m0 * kLn2;
      l_b[ra] = l0;
    }
    if (rb < R) {
      m_b[rb] = m1 == kNegInf ? kNegInf : m1 * kLn2;
      l_b[rb] = l1;
    }
  }
}

template <int HD, bool Q8>
int launch_rows_tc(const Args& a) {
  constexpr int BC = sm90::Boxes<HD>::BC;
  const int box_rows = a.block_len % kTcKeys == 0 ? kTcKeys : a.block_len;
  if (kTcKeys % box_rows != 0 || box_rows % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  // TMA reads 16-byte aligned tensors.
  if ((reinterpret_cast<uintptr_t>(a.q) |
       reinterpret_cast<uintptr_t>(a.k_pool) |
       reinterpret_cast<uintptr_t>(a.v_pool)) &
      15)
    return static_cast<int>(cudaErrorMisalignedAddress);
  // The maps cover one layer of the pool: table entries index it as is.
  const size_t layer_elems =
      static_cast<size_t>(a.layer) * a.n_blocks * a.block_len * a.G * HD;
  const size_t item = Q8 ? 1 : 2;
  const char* kl = static_cast<const char*>(a.k_pool) + layer_elems * item;
  const char* vl = static_cast<const char*>(a.v_pool) + layer_elems * item;
  const __nv_bfloat16* ksl = nullptr;
  const __nv_bfloat16* vsl = nullptr;
  CUtensorMap tq, tk, tv;
  if (int e = sm90::bf16_map(&tq, a.q, HD, 1, a.R, a.B * a.G, BC, kTcRows))
    return e;
  if (Q8) {
    if (a.k_scale == nullptr || a.v_scale == nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
    const size_t scale_off =
        static_cast<size_t>(a.layer) * a.n_blocks * a.G * a.block_len;
    ksl = static_cast<const __nv_bfloat16*>(a.k_scale) + scale_off;
    vsl = static_cast<const __nv_bfloat16*>(a.v_scale) + scale_off;
    if (int e = sm90::int8_map(&tk, kl, HD, a.G, a.block_len,
                               a.n_blocks, box_rows))
      return e;
    if (int e = sm90::int8_map(&tv, vl, HD, a.G, a.block_len,
                               a.n_blocks, box_rows))
      return e;
  } else {
    if (int e = sm90::bf16_map(&tk, kl, HD, a.G, a.block_len, a.n_blocks, BC,
                               box_rows))
      return e;
    if (int e = sm90::bf16_map(&tv, vl, HD, a.G, a.block_len, a.n_blocks, BC,
                               box_rows))
      return e;
  }
  auto kern = paged_rows_tc_kernel<HD, Q8>;
  constexpr size_t smem = tc_smem_bytes<HD, Q8>();
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  dim3 grid((a.R + kTcRows - 1) / kTcRows, a.B * a.G);
  kern<<<grid, kTcThreads, smem, a.stream>>>(
      tq, tk, tv, ksl, vsl, static_cast<const int*>(a.table),
      static_cast<const int*>(a.lengths), static_cast<float*>(a.acc),
      static_cast<float*>(a.m), static_cast<float*>(a.l), a.G, a.R,
      a.n_blocks, a.block_len, box_rows, a.table_stride, a.span_blocks,
      static_cast<float>(1.4426950408889634 /
                         std::sqrt(static_cast<double>(HD))));
  return static_cast<int>(cudaGetLastError());
}

template <bool Q8>
int launch_rows_tc_hd(int hd, const Args& a) {
  switch (hd) {
    case 32: return launch_rows_tc<32, Q8>(a);
    case 64: return launch_rows_tc<64, Q8>(a);
    case 128: return launch_rows_tc<128, Q8>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
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

// The mma.sync multi-row body: the same arguments less the int8 scales,
// the workspace and the counters (it needs none). hd = 32, 64 or 128; q
// float32 or bfloat16; pools float32 or bfloat16; any block length.
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

// The wgmma + TMA multi-row body: the mma.sync body's arguments and the
// int8 scales (null for bfloat16 pools). q bfloat16; pools bfloat16, or
// int8 with their scales; block lengths 8, 16, 32 or a multiple of 64;
// hd = 32, 64 or 128. Anything else is refused (cudaErrorInvalidValue).
extern "C" int paged_attention_rows_tc_launch(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* table,
    const void* lengths, void* acc, void* m, void* l, int B, int G, int R,
    int hd, int layer, int n_blocks, int block_len, int table_stride,
    int span_blocks, int kv_dtype, void* stream) {
  if (R <= 0 || block_len <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (B * G == 0) return 0;
  const Args a{q, k_pool, v_pool, k_scale, v_scale, table, lengths,
               acc, m, l, nullptr, nullptr,
               B, G, R, layer, n_blocks, block_len, table_stride,
               span_blocks, static_cast<cudaStream_t>(stream)};
  if (kv_dtype == 1) return launch_rows_tc_hd<false>(hd, a);
  if (kv_dtype == 2) return launch_rows_tc_hd<true>(hd, a);
  return static_cast<int>(cudaErrorInvalidValue);
}
