// Paged attention over a block-table KV pool, for Hopper (sm_90a).
//
// Replaces the TPU kernel accelerate_tpu/ops/paged_attention.py:_pallas_kernel
// (line 159, launched by _paged_attention_pallas). It computes the same
// function: attention of q [b, s, nh, hd] against each row's block-paged
// span of the pools [nb, bs, n_kv, hd], read through block_tables [b, mb].
// Query j of row b attends logical positions <= idx[b] + j. GQA by grouped
// heads (q head h reads kv head h / rep, no KV repeat). int8 / fp8-e4m3
// pools are dequantized on load with per-(position, kv-head) f32 scales.
// Scores, softmax and the accumulator are f32; one divide by max(l, 1e-30)
// at the end (a row with no valid position gives 0), stored in q's dtype.
//
// What bounds it: bytes. Per launch it must read the valid K/V prefix of
// every row once (plus q, scales and the table) and write the output; the
// arithmetic is 4*hd flops per (query row, key) pair, far below the card's
// ~295 flops per byte at bf16. The bound is the bytes of valid KV over the
// HBM rate, so the design is about keeping enough loads in flight.
//
// Design (simple first; see PERF.md for what it leaves on the table):
//  * The TPU grid (b, max_blocks) ran its second axis in order, carrying the
//    online-softmax state in VMEM scratch. Here the key axis is cut into
//    splits of kSplitKeys logical positions, and one thread block owns
//    (split, kv head n, a tile of up to kRows of the rep*s query rows that
//    share that kv head, row b). A decode step (one query row per kv head)
//    thus still spreads over b * n_kv * splits blocks. Splits wholly past
//    the valid prefix exit at once; when there is more than one split, each
//    block writes an unnormalised partial (m, l, acc) and a second small
//    kernel merges the splits of each query row (flash-decoding).
//  * Inside a split, keys are walked in tiles of kKeys = 32 positions. K and
//    V rows are loaded 16 bytes a thread (8 bf16, 16 int8/fp8, 4 f32), with
//    one block-table lookup per (thread, key), so any block_size works and a
//    tile may straddle pool blocks. Positions are masked by logical
//    position, never by block id, so the null block 0 that pads the tables
//    is never attended.
//  * The tile is dequantized to f32 in shared memory (K rows padded to
//    hd + 1 floats so the per-lane score loop is free of bank conflicts).
//  * Each warp owns up to kRowsPerWarp query rows. For scores a lane owns a
//    key; the tile max and sum are warp shuffles; for P.V a lane owns
//    hd / 32 output dims and reads p from the owning lane by shuffle.
//  * No fast-math: expf and IEEE divide, so f32 pools meet 1e-5 against the
//    plain PyTorch version.

#include <cfloat>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 4;
constexpr int kRows = kWarps * kRowsPerWarp;  // query rows per thread block
constexpr int kKeys = 32;                     // key positions per tile, one per lane
constexpr int kSplitKeys = 128;               // key positions per split (a multiple of kKeys)
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return static_cast<float>(x); }
__device__ __forceinline__ float to_f32(__nv_fp8_e4m3 x) { return static_cast<float>(x); }

__device__ __forceinline__ void store_as(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

template <int HD, typename QT, typename KT, bool kQuant>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const QT* __restrict__ q, const KT* __restrict__ k_pages,
                       const KT* __restrict__ v_pages, const float* __restrict__ k_scale,
                       const float* __restrict__ v_scale, const int* __restrict__ block_tables,
                       const int* __restrict__ idx, QT* __restrict__ out,
                       float* __restrict__ part_acc, float* __restrict__ part_ml, int s, int nh,
                       int n_kv, int nb, int bs, int mb, int splits) {
  constexpr int kDims = HD / 32;          // output dims per lane
  constexpr int kVec = 16 / sizeof(KT);   // pool elements per 16-byte load
  constexpr int kVecsPerRow = HD / kVec;
  __shared__ float q_s[kRows][HD];
  __shared__ float k_s[kKeys][HD + 1];
  __shared__ float v_s[kKeys][HD];

  const int split = blockIdx.x;
  const int row_tiles = gridDim.y / n_kv;
  const int n = blockIdx.y / row_tiles;
  const int row0 = (blockIdx.y % row_tiles) * kRows;
  const int b = blockIdx.z;
  const int rep = nh / n_kv;
  const int rows = rep * s;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int start = idx[b];
  const int kv_end = min(start + s, mb * bs);  // no row attends a position >= kv_end
  const int k_lo = split * kSplitKeys;
  if (k_lo >= kv_end) return;  // the split lies wholly past the valid prefix
  const int k_hi = min(k_lo + kSplitKeys, kv_end);
  const int* table = block_tables + static_cast<int64_t>(b) * mb;

  // q tile, scaled once by 1/sqrt(hd) (as the plain version folds it into q)
  const float root = sqrtf(static_cast<float>(HD));
  for (int e = tid; e < kRows * HD; e += kThreads) {
    const int r = e / HD, d = e % HD;
    const int row = row0 + r;
    float x = 0.f;
    if (row < rows) {
      const int qj = row / rep, head = n * rep + row % rep;
      x = to_f32(q[((static_cast<int64_t>(b) * s + qj) * nh + head) * HD + d]) / root;
    }
    q_s[r][d] = x;
  }

  int q_pos[kRowsPerWarp];
  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kDims];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int row = row0 + warp + i * kWarps;
    q_pos[i] = row < rows ? start + row / rep : -1;
    m[i] = -FLT_MAX;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kDims; ++c) acc[i][c] = 0.f;
  }

  for (int t0 = k_lo; t0 < k_hi; t0 += kKeys) {
    __syncthreads();  // the previous tile is consumed (and q_s written)
    for (int e = tid; e < kKeys * kVecsPerRow; e += kThreads) {
      const int t = e / kVecsPerRow, d0 = (e % kVecsPerRow) * kVec;
      const int p = t0 + t;
      float kx[kVec], vx[kVec];
      if (p < k_hi) {
        const int blk = min(max(table[p / bs], 0), nb - 1);
        const int64_t pool_row = (static_cast<int64_t>(blk) * bs + p % bs) * n_kv + n;
        const uint4 kraw = __ldg(reinterpret_cast<const uint4*>(k_pages + pool_row * HD + d0));
        const uint4 vraw = __ldg(reinterpret_cast<const uint4*>(v_pages + pool_row * HD + d0));
        const KT* ke = reinterpret_cast<const KT*>(&kraw);
        const KT* ve = reinterpret_cast<const KT*>(&vraw);
        float ks = 1.f, vs = 1.f;  // x * 1.f is exact: float pools pass unchanged
        if constexpr (kQuant) {
          ks = k_scale[pool_row];
          vs = v_scale[pool_row];
        }
#pragma unroll
        for (int i = 0; i < kVec; ++i) {
          kx[i] = to_f32(ke[i]) * ks;
          vx[i] = to_f32(ve[i]) * vs;
        }
      } else {
#pragma unroll
        for (int i = 0; i < kVec; ++i) kx[i] = vx[i] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        k_s[t][d0 + i] = kx[i];
        v_s[t][d0 + i] = vx[i];
      }
    }
    __syncthreads();

    const int t_end = min(kKeys, k_hi - t0);
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      if (q_pos[i] < 0) continue;  // warp-uniform: depends on warp and i only
      const int r = warp + i * kWarps;
      const int p = t0 + lane;
      const bool valid = p <= q_pos[i] && p < k_hi;
      float sc = 0.f;
#pragma unroll 8
      for (int d = 0; d < HD; ++d) sc = fmaf(q_s[r][d], k_s[lane][d], sc);
      sc = valid ? sc : -FLT_MAX;
      const float m_new = fmaxf(m[i], warp_max(sc));
      // while every position so far is masked, m_new == -FLT_MAX: the
      // explicit mask keeps those lanes at p = 0
      const float pv = valid ? expf(sc - m_new) : 0.f;
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + warp_sum(pv);
#pragma unroll
      for (int c = 0; c < kDims; ++c) acc[i][c] *= alpha;
      for (int t = 0; t < t_end; ++t) {
        const float pt = __shfl_sync(kFull, pv, t);
#pragma unroll
        for (int c = 0; c < kDims; ++c) acc[i][c] = fmaf(pt, v_s[t][lane + 32 * c], acc[i][c]);
      }
      m[i] = m_new;
    }
  }

#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    if (q_pos[i] < 0) continue;
    const int row = row0 + warp + i * kWarps;
    const int qj = row / rep, head = n * rep + row % rep;
    const int64_t out_row = (static_cast<int64_t>(b) * s + qj) * nh + head;
    if (splits == 1) {
      const float den = fmaxf(l[i], 1e-30f);
      QT* o = out + out_row * HD;
#pragma unroll
      for (int c = 0; c < kDims; ++c) store_as(o + lane + 32 * c, acc[i][c] / den);
    } else {
      const int64_t part = out_row * splits + split;
      float* pa = part_acc + part * HD;
#pragma unroll
      for (int c = 0; c < kDims; ++c) pa[lane + 32 * c] = acc[i][c];
      if (lane == 0) {
        part_ml[2 * part] = m[i];
        part_ml[2 * part + 1] = l[i];
      }
    }
  }
}

// Merge the splits of each query row: one block per (b, qj, head), one
// thread per output dim. Only the splits the row's block wrote are read.
template <int HD, typename QT>
__global__ void __launch_bounds__(HD)
combine_splits_kernel(const float* __restrict__ part_acc, const float* __restrict__ part_ml,
                      const int* __restrict__ idx, QT* __restrict__ out, int s, int nh, int bs,
                      int mb, int splits) {
  const int64_t out_row = blockIdx.x;
  const int b = static_cast<int>(out_row / (static_cast<int64_t>(s) * nh));
  const int d = threadIdx.x;
  const int kv_end = min(idx[b] + s, mb * bs);
  const int used = min(splits, (kv_end + kSplitKeys - 1) / kSplitKeys);
  const float* ml = part_ml + 2 * out_row * splits;
  const float* pa = part_acc + out_row * splits * HD;
  float m_all = -FLT_MAX;
  for (int j = 0; j < used; ++j) m_all = fmaxf(m_all, ml[2 * j]);
  float l_all = 0.f, o = 0.f;
  for (int j = 0; j < used; ++j) {
    const float w = expf(ml[2 * j] - m_all);
    l_all = fmaf(ml[2 * j + 1], w, l_all);
    o = fmaf(pa[j * HD + d], w, o);
  }
  store_as(out + out_row * HD + d, o / fmaxf(l_all, 1e-30f));
}

struct Args {
  const void* q;
  const void* k_pages;
  const void* v_pages;
  const void* k_scale;
  const void* v_scale;
  const void* block_tables;
  const void* idx;
  void* out;
  float* part_acc;
  float* part_ml;
  int b, s, nh, n_kv, nb, bs, mb, splits;
};

template <int HD, typename QT, typename KT, bool kQuant>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const int rows = (a.nh / a.n_kv) * a.s;
  const dim3 grid(a.splits, a.n_kv * ((rows + kRows - 1) / kRows), a.b);
  paged_attention_kernel<HD, QT, KT, kQuant><<<grid, kThreads, 0, stream>>>(
      static_cast<const QT*>(a.q), static_cast<const KT*>(a.k_pages),
      static_cast<const KT*>(a.v_pages), static_cast<const float*>(a.k_scale),
      static_cast<const float*>(a.v_scale), static_cast<const int*>(a.block_tables),
      static_cast<const int*>(a.idx), static_cast<QT*>(a.out), a.part_acc, a.part_ml, a.s,
      a.nh, a.n_kv, a.nb, a.bs, a.mb, a.splits);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.splits == 1) return err;
  combine_splits_kernel<HD, QT><<<a.b * a.s * a.nh, HD, 0, stream>>>(
      a.part_acc, a.part_ml, static_cast<const int*>(a.idx), static_cast<QT*>(a.out), a.s,
      a.nh, a.bs, a.mb, a.splits);
  return cudaGetLastError();
}

// dtype codes shared with the Python wrapper: q 0 = f32, 1 = bf16;
// pools 0 = f32, 1 = bf16, 2 = int8, 3 = fp8 e4m3 (2 and 3 carry scales)
template <int HD, typename QT>
cudaError_t by_pool(const Args& a, int kv_dtype, cudaStream_t stream) {
  switch (kv_dtype) {
    case 0: return launch<HD, QT, float, false>(a, stream);
    case 1: return launch<HD, QT, __nv_bfloat16, false>(a, stream);
    case 2: return launch<HD, QT, int8_t, true>(a, stream);
    case 3: return launch<HD, QT, __nv_fp8_e4m3, true>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <int HD>
cudaError_t by_query(const Args& a, int q_dtype, int kv_dtype, cudaStream_t stream) {
  switch (q_dtype) {
    case 0: return by_pool<HD, float>(a, kv_dtype, stream);
    case 1: return by_pool<HD, __nv_bfloat16>(a, kv_dtype, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Key positions per split: the wrapper sizes the partial buffers with it.
extern "C" int paged_attention_split_keys() { return kSplitKeys; }

// part_acc [b, s, nh, splits, hd] and part_ml [b, s, nh, splits, 2] (f32)
// are scratch the wrapper allocates when splits > 1, else null.
extern "C" int paged_attention_forward(const void* q, const void* k_pages, const void* v_pages,
                                       const void* k_scale, const void* v_scale,
                                       const void* block_tables, const void* idx, void* out,
                                       void* part_acc, void* part_ml, int b, int s, int nh,
                                       int n_kv, int hd, int nb, int bs, int mb, int splits,
                                       int q_dtype, int kv_dtype, void* stream) {
  (void)cudaGetLastError();  // report this launch's error, not a stale one
  if (b < 1 || s < 1 || n_kv < 1 || nh % n_kv != 0 || nb < 1 || bs < 1 || mb < 1 ||
      splits != (mb * bs + kSplitKeys - 1) / kSplitKeys ||
      (splits > 1 && (part_acc == nullptr || part_ml == nullptr)))
    return cudaErrorInvalidValue;
  const Args a{q, k_pages, v_pages, k_scale, v_scale, block_tables, idx, out,
               static_cast<float*>(part_acc), static_cast<float*>(part_ml),
               b, s, nh, n_kv, nb, bs, mb, splits};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 64: return by_query<64>(a, q_dtype, kv_dtype, st);
    case 128: return by_query<128>(a, q_dtype, kv_dtype, st);
    default: return cudaErrorInvalidValue;
  }
}

// Resident blocks an SM holds of the split kernel and of the combine kernel
// at hd 128 with bf16 queries and a bf16 pool (the flagship's decode), by
// the runtime's occupancy calculator for this device.
extern "C" int paged_attention_blocks_per_sm(int* split, int* combine) {
  (void)cudaGetLastError();
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      split, paged_attention_kernel<128, __nv_bfloat16, __nv_bfloat16, false>, kThreads, 0);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      combine, combine_splits_kernel<128, __nv_bfloat16>, 128, 0);
}

extern "C" const char* paged_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
