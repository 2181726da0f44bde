// Flash attention forward and backward, for Hopper (sm_90a).
//
// Replaces the three TPU kernels of accelerate_tpu/ops/flash_attention.py:
//   flash_fwd_*      <- _fwd_kernel     (line 48, launched by _fwd_call)
//   flash_bwd_dq_*   <- _bwd_dq_kernel  (line 131, launched by _bwd_call)
//   flash_bwd_dkv_*  <- _bwd_dkv_kernel (line 184, launched by _bwd_call)
// and computes what they compute:
//   forward   O = softmax(scale * Q K^T + mask) V and lse = the row logsumexp,
//             an f32 online softmax over key tiles; a row with no valid key
//             gives O = 0 and lse = NEG_INF (NEG_INF = -FLT_MAX, finite);
//   dq        dQ = sum_kv [P * (dO V^T - delta)] K * scale, P recomputed as
//             exp(S - lse) and forced to 0 where lse == NEG_INF;
//   dk, dv    dV = P^T dO and dK = dS^T Q, dS carrying the scale.
// delta = rowsum(dO * O) in f32 is computed by the caller, as the JAX
// package computes it outside Pallas. The mask gets no gradient.
//
// Tensors are read in the model layout [b, s, heads, hd] (contiguous) by
// strides: no transposed or padded copies. The optional key mask is
// [b, skv] bytes (1 = valid) and applies where(valid, s, NEG_INF), equal to
// the JAX "s + bias" after rounding because NEG_INF is the f32 minimum.
// Causal attention compares query index >= key index. GQA: query head h
// reads kv head h / (nh / n_kv); nothing is repeated. lse and delta are f32
// [b, nh, s].
//
// What bounds them: at the flagship training shape (b 8, s 1024, 12 heads
// x 128, bf16, causal) the three kernels do 25.8, 38.7 and 51.6 GFLOP
// against 101, 127 and 152 MB of compulsory traffic; at the tensor cores'
// 989 TFLOP/s and HBM's 3.35 TB/s the bounds are 0.030 (bytes), 0.039 and
// 0.052 ms (operations). So they are to be judged by the tensor cores' rate.
//
// Design (simple first), shared by both families:
//  * The TPU grid (b, h, nq, nkv) ran its last axis in order, carrying the
//    online-softmax state or the gradient accumulator in VMEM scratch. Here
//    one thread block owns one output tile and loops over the other axis
//    itself: forward and dq one block per (64 query rows, head, batch) over
//    key tiles up to the causal limit; dk/dv one block per (64 keys, kv
//    head, batch) over the rep query heads that share the kv head and over
//    the query tiles from the causal start. Summing the GQA heads inside
//    the block needs no atomics and keeps dK/dV deterministic.
//  * Tiles are staged in shared memory with 16-byte loads; rows past the
//    sequence are zero and masked, so any length works. Loads and products
//    do not overlap (no cp.async / TMA pipeline): later work, with wgmma.
//  * f32 inputs run every product on the FMA units (67 TFLOP/s peak), with
//    no TF32, so they meet the JAX gates (2e-5) against the plain version:
//    256 threads form a 16 x 16 grid over a 64 x 64 score tile, tiles are
//    staged as f32 with rows padded by one float.
//  * bf16 inputs (the training path) run every product on the tensor cores,
//    mma.sync m16n8k16 with f32 accumulators (section below).
//  * Rounding points follow the TPU kernels, so the kernels and the plain
//    version agree in bf16: P is rounded to the value dtype before P V, P to
//    dO's dtype before P^T dO, dS to K's / Q's dtype before dS K and dS^T Q.
//    Every accumulator is f32; expf, logf and IEEE division, no fast-math.

#include <cfloat>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 64;                  // query rows and keys per tile
constexpr int kThreads = 256;
constexpr int kGrid = 16;                   // threads form a kGrid x kGrid square
constexpr int kRows = kBlock / kGrid;       // tile rows per thread
constexpr int kCols = kBlock / kGrid;       // score columns per thread
constexpr int kSStride = kBlock + 1;        // row stride of a staged score tile
constexpr float kNegInf = -FLT_MAX;
constexpr unsigned kFull = 0xffffffffu;

// reductions over the 16 threads that share a tile row (one half-warp)
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = kGrid / 2; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = kGrid / 2; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// Stage rows [row0, row0 + kBlock) of one head of an f32 [b, s, heads, HD]
// tensor into dst (row stride HD + 1). `src` points at (b, row 0, head, 0),
// `pitch` = heads * HD; rows >= n_rows are zero.
template <int HD>
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ src,
                                          int64_t pitch, int row0, int n_rows) {
  constexpr int kVecs = HD / 4;
  constexpr int kStride = HD + 1;
  for (int e = threadIdx.x; e < kBlock * kVecs; e += kThreads) {
    const int r = e / kVecs, c = (e % kVecs) * 4;
    const int row = row0 + r;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < n_rows) x = __ldg(reinterpret_cast<const float4*>(src + row * pitch + c));
    float* d = dst + r * kStride + c;
    d[0] = x.x;
    d[1] = x.y;
    d[2] = x.z;
    d[3] = x.w;
  }
}

// acc[i][j] += sum_d a[row i][d] * b[col j][d] over a 64 x 64 tile: thread
// (ty, tx) owns rows ty + 16 i and columns tx + 16 j.
template <int HD>
__device__ __forceinline__ void tile_dot(float (&acc)[kRows][kCols], const float* a,
                                         const float* b, int ty, int tx) {
  constexpr int kStride = HD + 1;
#pragma unroll 8
  for (int d = 0; d < HD; ++d) {
    float av[kRows], bv[kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i) av[i] = a[(ty + kGrid * i) * kStride + d];
#pragma unroll
    for (int j = 0; j < kCols; ++j) bv[j] = b[(tx + kGrid * j) * kStride + d];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// out[i][c] += sum_t p[row i][t] * x[t][tx + 16 c]: a 64 x 64 staged score
// tile times a 64 x HD staged value tile.
template <int HD>
__device__ __forceinline__ void tile_pv(float (&out)[kRows][HD / kGrid], const float* p,
                                        const float* x, int ty, int tx) {
  constexpr int kStride = HD + 1;
  constexpr int kD = HD / kGrid;
#pragma unroll 4
  for (int t = 0; t < kBlock; ++t) {
    float xv[kD];
#pragma unroll
    for (int c = 0; c < kD; ++c) xv[c] = x[t * kStride + tx + kGrid * c];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const float pv = p[(ty + kGrid * i) * kSStride + t];
#pragma unroll
      for (int c = 0; c < kD; ++c) out[i][c] = fmaf(pv, xv[c], out[i][c]);
    }
  }
}

__device__ __forceinline__ bool key_valid(const uint8_t* __restrict__ mask_b, int key, int skv) {
  return key < skv && (mask_b == nullptr || mask_b[key] != 0);
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const uint8_t* __restrict__ mask,
                 float* __restrict__ o, float* __restrict__ lse, int sq, int skv, int nh,
                 int n_kv, float scale, int causal) {
  constexpr int kStride = HD + 1;
  constexpr int kD = HD / kGrid;
  extern __shared__ float smem[];
  float* q_s = smem;
  float* k_s = q_s + kBlock * kStride;
  float* v_s = k_s + kBlock * kStride;
  float* p_s = v_s + kBlock * kStride;

  const int q0 = blockIdx.x * kBlock, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (nh / n_kv);
  const int ty = threadIdx.x / kGrid, tx = threadIdx.x % kGrid;
  const int64_t q_pitch = static_cast<int64_t>(nh) * HD;
  const int64_t kv_pitch = static_cast<int64_t>(n_kv) * HD;
  const float* q_bh = q + (static_cast<int64_t>(b) * sq * nh + h) * HD;
  const float* k_bg = k + (static_cast<int64_t>(b) * skv * n_kv + g) * HD;
  const float* v_bg = v + (static_cast<int64_t>(b) * skv * n_kv + g) * HD;
  const uint8_t* mask_b = mask == nullptr ? nullptr : mask + static_cast<int64_t>(b) * skv;

  load_tile<HD>(q_s, q_bh, q_pitch, q0, sq);
  float m[kRows], l[kRows], acc[kRows][kD];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kD; ++c) acc[i][c] = 0.f;
  }

  // causal: key tiles wholly above the diagonal are skipped
  const int kv_end = causal ? min(skv, q0 + kBlock) : skv;
  for (int t0 = 0; t0 < kv_end; t0 += kBlock) {
    __syncthreads();  // the previous tile is consumed (and q_s written)
    load_tile<HD>(k_s, k_bg, kv_pitch, t0, skv);
    load_tile<HD>(v_s, v_bg, kv_pitch, t0, skv);
    __syncthreads();

    float s[kRows][kCols] = {};
    tile_dot<HD>(s, q_s, k_s, ty, tx);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qi = q0 + ty + kGrid * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int kj = t0 + tx + kGrid * j;
        const bool valid = key_valid(mask_b, kj, skv) && (!causal || qi >= kj);
        s[i][j] = valid ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      // NEG_INF is finite: while a row has seen no valid key, m_new ==
      // NEG_INF and exp(s - m_new) would be 1, so such rows take p = 0
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = m_new == kNegInf ? 0.f : expf(s[i][j] - m_new);
        sum += p;
        p_s[(ty + kGrid * i) * kSStride + tx + kGrid * j] = p;
      }
      const float alpha = expf(m[i] - m_new);
      l[i] = alpha * l[i] + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kD; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();
    tile_pv<HD>(acc, p_s, v_s, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qi = q0 + ty + kGrid * i;
    if (qi >= sq) continue;
    const bool empty = l[i] == 0.f;
    const float den = empty ? 1.f : l[i];
    float* o_row = o + ((static_cast<int64_t>(b) * sq + qi) * nh + h) * HD;
#pragma unroll
    for (int c = 0; c < kD; ++c) o_row[tx + kGrid * c] = acc[i][c] / den;
    if (tx == 0)
      lse[(static_cast<int64_t>(b) * nh + h) * sq + qi] = empty ? kNegInf : m[i] + logf(den);
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const uint8_t* __restrict__ mask, const float* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    float* __restrict__ dq, int sq, int skv, int nh, int n_kv, float scale,
                    int causal) {
  constexpr int kStride = HD + 1;
  constexpr int kD = HD / kGrid;
  extern __shared__ float smem[];
  float* q_s = smem;
  float* do_s = q_s + kBlock * kStride;
  float* k_s = do_s + kBlock * kStride;
  float* v_s = k_s + kBlock * kStride;
  float* ds_s = v_s + kBlock * kStride;

  const int q0 = blockIdx.x * kBlock, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (nh / n_kv);
  const int ty = threadIdx.x / kGrid, tx = threadIdx.x % kGrid;
  const int64_t q_pitch = static_cast<int64_t>(nh) * HD;
  const int64_t kv_pitch = static_cast<int64_t>(n_kv) * HD;
  const int64_t q_off = (static_cast<int64_t>(b) * sq * nh + h) * HD;
  const int64_t kv_off = (static_cast<int64_t>(b) * skv * n_kv + g) * HD;
  const int64_t row_off = (static_cast<int64_t>(b) * nh + h) * sq;
  const uint8_t* mask_b = mask == nullptr ? nullptr : mask + static_cast<int64_t>(b) * skv;

  load_tile<HD>(q_s, q + q_off, q_pitch, q0, sq);
  load_tile<HD>(do_s, dout + q_off, q_pitch, q0, sq);
  float lse_r[kRows], delta_r[kRows], acc[kRows][kD];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qi = q0 + ty + kGrid * i;
    lse_r[i] = qi < sq ? lse[row_off + qi] : kNegInf;
    delta_r[i] = qi < sq ? delta[row_off + qi] : 0.f;
#pragma unroll
    for (int c = 0; c < kD; ++c) acc[i][c] = 0.f;
  }

  const int kv_end = causal ? min(skv, q0 + kBlock) : skv;
  for (int t0 = 0; t0 < kv_end; t0 += kBlock) {
    __syncthreads();
    load_tile<HD>(k_s, k + kv_off, kv_pitch, t0, skv);
    load_tile<HD>(v_s, v + kv_off, kv_pitch, t0, skv);
    __syncthreads();

    float s[kRows][kCols] = {}, dp[kRows][kCols] = {};
    tile_dot<HD>(s, q_s, k_s, ty, tx);
    tile_dot<HD>(dp, do_s, v_s, ty, tx);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qi = q0 + ty + kGrid * i;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int kj = t0 + tx + kGrid * j;
        const bool valid = key_valid(mask_b, kj, skv) && (!causal || qi >= kj);
        const float sc = valid ? s[i][j] * scale : kNegInf;
        // a fully masked row has lse == NEG_INF and must give p = 0
        const float p = lse_r[i] == kNegInf ? 0.f : expf(sc - lse_r[i]);
        const float ds = p * (dp[i][j] - delta_r[i]) * scale;
        ds_s[(ty + kGrid * i) * kSStride + tx + kGrid * j] = ds;
      }
    }
    __syncthreads();
    tile_pv<HD>(acc, ds_s, k_s, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qi = q0 + ty + kGrid * i;
    if (qi >= sq) continue;
    float* row = dq + ((static_cast<int64_t>(b) * sq + qi) * nh + h) * HD;
#pragma unroll
    for (int c = 0; c < kD; ++c) row[tx + kGrid * c] = acc[i][c];
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const uint8_t* __restrict__ mask, const float* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     float* __restrict__ dk, float* __restrict__ dv, int sq, int skv, int nh, int n_kv,
                     float scale, int causal) {
  constexpr int kStride = HD + 1;
  constexpr int kD = HD / kGrid;
  extern __shared__ float smem[];
  float* k_s = smem;
  float* v_s = k_s + kBlock * kStride;
  float* q_s = v_s + kBlock * kStride;
  float* do_s = q_s + kBlock * kStride;
  float* p_s = do_s + kBlock * kStride;
  float* ds_s = p_s + kBlock * kSStride;
  float* lse_s = ds_s + kBlock * kSStride;
  float* delta_s = lse_s + kBlock;

  const int k0 = blockIdx.x * kBlock, g = blockIdx.y, b = blockIdx.z;
  const int rep = nh / n_kv;
  const int ty = threadIdx.x / kGrid, tx = threadIdx.x % kGrid;
  const int64_t q_pitch = static_cast<int64_t>(nh) * HD;
  const int64_t kv_pitch = static_cast<int64_t>(n_kv) * HD;
  const int64_t kv_off = (static_cast<int64_t>(b) * skv * n_kv + g) * HD;
  const uint8_t* mask_b = mask == nullptr ? nullptr : mask + static_cast<int64_t>(b) * skv;

  load_tile<HD>(k_s, k + kv_off, kv_pitch, k0, skv);
  load_tile<HD>(v_s, v + kv_off, kv_pitch, k0, skv);
  bool key_ok[kRows];
  float dk_acc[kRows][kD], dv_acc[kRows][kD];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    key_ok[i] = key_valid(mask_b, k0 + ty + kGrid * i, skv);
#pragma unroll
    for (int c = 0; c < kD; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;
  }

  // causal: query tiles wholly before this key tile see none of its keys
  const int q_start = causal ? (k0 / kBlock) * kBlock : 0;
  for (int r = 0; r < rep; ++r) {
    const int h = g * rep + r;
    const int64_t q_off = (static_cast<int64_t>(b) * sq * nh + h) * HD;
    const int64_t row_off = (static_cast<int64_t>(b) * nh + h) * sq;
    for (int q0 = q_start; q0 < sq; q0 += kBlock) {
      __syncthreads();  // the previous query tile is consumed
      load_tile<HD>(q_s, q + q_off, q_pitch, q0, sq);
      load_tile<HD>(do_s, dout + q_off, q_pitch, q0, sq);
      if (threadIdx.x < kBlock) {
        const int qi = q0 + threadIdx.x;
        lse_s[threadIdx.x] = qi < sq ? lse[row_off + qi] : kNegInf;  // padded rows: p = 0
        delta_s[threadIdx.x] = qi < sq ? delta[row_off + qi] : 0.f;
      }
      __syncthreads();

      // transposed score tiles: row = key (ty + 16 i), column = query (tx + 16 j)
      float s[kRows][kCols] = {}, dp[kRows][kCols] = {};
      tile_dot<HD>(s, k_s, q_s, ty, tx);
      tile_dot<HD>(dp, v_s, do_s, ty, tx);
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int kj = k0 + ty + kGrid * i;
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          const int col = tx + kGrid * j;
          const int qi = q0 + col;
          const bool valid = key_ok[i] && (!causal || qi >= kj);
          const float sc = valid ? s[i][j] * scale : kNegInf;
          const float lq = lse_s[col];
          const float p = lq == kNegInf ? 0.f : expf(sc - lq);
          const float ds = p * (dp[i][j] - delta_s[col]) * scale;
          p_s[(ty + kGrid * i) * kSStride + col] = p;
          ds_s[(ty + kGrid * i) * kSStride + col] = ds;
        }
      }
      __syncthreads();
      tile_pv<HD>(dv_acc, p_s, do_s, ty, tx);
      tile_pv<HD>(dk_acc, ds_s, q_s, ty, tx);
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int kj = k0 + ty + kGrid * i;
    if (kj >= skv) continue;
    const int64_t row = ((static_cast<int64_t>(b) * skv + kj) * n_kv + g) * HD;
#pragma unroll
    for (int c = 0; c < kD; ++c) {
      dk[row + tx + kGrid * c] = dk_acc[i][c];
      dv[row + tx + kGrid * c] = dv_acc[i][c];
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: the same three kernels on the tensor cores (mma.sync m16n8k16, f32
// accumulators). Four warps per block; a warp owns 16 rows of the block's
// 64-row tile. Tiles are staged in shared memory as bf16 with rows padded by
// 8 elements, so fragment loads (32-bit, 8 rows x 4 words) and ldmatrix
// rows (16 bytes at a 16-byte offset mod 128) are free of bank conflicts.
// The f32 score accumulators of one product are laid out as the A operand of
// the next (the C fragment of a 16 x 16 score slice is the A fragment of the
// same slice), so P and dS pass from one product to the next in registers,
// rounded to bf16 on the way as the TPU kernels round them.
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr int kMmaThreads = 128;
constexpr int kQTile3 = 32;  // query rows per step of the dk/dv kernel

template <int HD>
__host__ __device__ constexpr int mma_stride() { return HD + 8; }

__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8 x 8 bf16 matrices, transposed: the B fragments (k = row of the
// staged tile, n = column) of two neighbouring 8-column n-tiles
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ uint32_t lds32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// two f32 values rounded to bf16, the lower column in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// A fragment (16 rows from r0, 16 columns from c0) of a staged row-major tile
template <int HD>
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const bf16* t, int r0, int c0, int gr,
                                       int tg) {
  constexpr int S = mma_stride<HD>();
  a[0] = lds32(t + (r0 + gr) * S + c0 + 2 * tg);
  a[1] = lds32(t + (r0 + gr + 8) * S + c0 + 2 * tg);
  a[2] = lds32(t + (r0 + gr) * S + c0 + 8 + 2 * tg);
  a[3] = lds32(t + (r0 + gr + 8) * S + c0 + 8 + 2 * tg);
}

// B fragment of X^T for a staged X[n][k] (k contiguous): 8 rows from n0,
// 16 columns from k0
template <int HD>
__device__ __forceinline__ void frag_bt(uint32_t& b0, uint32_t& b1, const bf16* t, int n0, int k0,
                                        int gr, int tg) {
  constexpr int S = mma_stride<HD>();
  b0 = lds32(t + (n0 + gr) * S + k0 + 2 * tg);
  b1 = lds32(t + (n0 + gr) * S + k0 + 8 + 2 * tg);
}

// acc[HD/8][4] += A (16 x 16*KSTEPS, from score accumulators s[2*KSTEPS][4]
// rounded to bf16) times the staged tile X[k][HD] (k = rows from row 0)
template <int HD, int KSTEPS>
__device__ __forceinline__ void mma_scores_x(float (&acc)[HD / 8][4],
                                             const float (&s)[2 * KSTEPS][4], const bf16* x,
                                             int lane) {
  constexpr int S = mma_stride<HD>();
  const int r = (lane & 7) + ((lane >> 3) & 1) * 8, c = (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                           pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                           pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                           pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
    for (int np = 0; np < HD / 16; ++np) {
      uint32_t b[4];
      ldsm_x4_trans(b, x + (16 * kk + r) * S + 16 * np + c);
      mma16816(acc[2 * np], a, b[0], b[1]);
      mma16816(acc[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// Stage rows [row0, row0 + ROWS) of one head of a bf16 [b, s, heads, HD]
// tensor; rows >= n_rows are zero.
template <int HD, int ROWS>
__device__ __forceinline__ void load_tile_bf16(bf16* dst, const bf16* __restrict__ src,
                                               int64_t pitch, int row0, int n_rows) {
  constexpr int S = mma_stride<HD>();
  constexpr int kVecs = HD / 8;
  for (int e = threadIdx.x; e < ROWS * kVecs; e += kMmaThreads) {
    const int r = e / kVecs, c = (e % kVecs) * 8;
    const int row = row0 + r;
    uint4 x = make_uint4(0, 0, 0, 0);
    if (row < n_rows) x = __ldg(reinterpret_cast<const uint4*>(src + row * pitch + c));
    *reinterpret_cast<uint4*>(dst + r * S + c) = x;
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(kFull, x, 1));
  return fmaxf(x, __shfl_xor_sync(kFull, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(kFull, x, 1);
  return x + __shfl_xor_sync(kFull, x, 2);
}

template <int HD>
__global__ void __launch_bounds__(kMmaThreads)
flash_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const uint8_t* __restrict__ mask,
                     bf16* __restrict__ o, float* __restrict__ lse, int sq, int skv, int nh,
                     int n_kv, float scale, int causal) {
  constexpr int S = mma_stride<HD>();
  constexpr int kNT = kBlock / 8;  // key n-tiles of a score tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* k_s = q_s + kBlock * S;
  bf16* v_s = k_s + kBlock * S;

  const int q0 = blockIdx.x * kBlock, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (nh / n_kv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, gr = lane >> 2, tg = lane & 3;
  const int64_t q_pitch = static_cast<int64_t>(nh) * HD;
  const int64_t kv_pitch = static_cast<int64_t>(n_kv) * HD;
  const bf16* k_bg = k + (static_cast<int64_t>(b) * skv * n_kv + g) * HD;
  const bf16* v_bg = v + (static_cast<int64_t>(b) * skv * n_kv + g) * HD;
  const uint8_t* mask_b = mask == nullptr ? nullptr : mask + static_cast<int64_t>(b) * skv;

  load_tile_bf16<HD, kBlock>(q_s, q + (static_cast<int64_t>(b) * sq * nh + h) * HD, q_pitch, q0,
                             sq);
  const int rows[2] = {q0 + warp * 16 + gr, q0 + warp * 16 + gr + 8};
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, acc[HD / 8][4] = {};

  const int kv_end = causal ? min(skv, q0 + kBlock) : skv;
  for (int t0 = 0; t0 < kv_end; t0 += kBlock) {
    __syncthreads();  // the previous tile is consumed (and q_s written)
    load_tile_bf16<HD, kBlock>(k_s, k_bg, kv_pitch, t0, skv);
    load_tile_bf16<HD, kBlock>(v_s, v_bg, kv_pitch, t0, skv);
    __syncthreads();

    float s[kNT][4] = {};
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t aq[4];
      frag_a<HD>(aq, q_s, warp * 16, 16 * kk, gr, tg);
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        uint32_t b0, b1;
        frag_bt<HD>(b0, b1, k_s, 8 * j, 16 * kk, gr, tg);
        mma16816(s[j], aq, b0, b1);
      }
    }

    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = rows[e >> 1], key = t0 + 8 * j + 2 * tg + (e & 1);
        const bool valid = key_valid(mask_b, key, skv) && (!causal || row >= key);
        s[j][e] = valid ? s[j][e] * scale : kNegInf;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], quad_max(mx[r]));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) {
          // NEG_INF is finite: a row with no valid key yet takes p = 0
          s[j][e] = m_new == kNegInf ? 0.f : expf(s[j][e] - m_new);
          sum += s[j][e];
        }
      const float alpha = expf(m[r] - m_new);
      l[r] = alpha * l[r] + quad_sum(sum);
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < HD / 8; ++c) {
        acc[c][2 * r] *= alpha;
        acc[c][2 * r + 1] *= alpha;
      }
    }
    mma_scores_x<HD, kNT / 2>(acc, s, v_s, lane);  // P rounded to V's dtype
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= sq) continue;
    const bool empty = l[r] == 0.f;
    const float den = empty ? 1.f : l[r];
    bf16* o_row = o + ((static_cast<int64_t>(b) * sq + rows[r]) * nh + h) * HD;
#pragma unroll
    for (int c = 0; c < HD / 8; ++c)
      *reinterpret_cast<uint32_t*>(o_row + 8 * c + 2 * tg) =
          pack_bf16(acc[c][2 * r] / den, acc[c][2 * r + 1] / den);
    if (tg == 0)
      lse[(static_cast<int64_t>(b) * nh + h) * sq + rows[r]] = empty ? kNegInf : m[r] + logf(den);
  }
}

template <int HD>
__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const uint8_t* __restrict__ mask,
                        const bf16* __restrict__ dout, const float* __restrict__ lse,
                        const float* __restrict__ delta, bf16* __restrict__ dq, int sq, int skv,
                        int nh, int n_kv, float scale, int causal) {
  constexpr int S = mma_stride<HD>();
  constexpr int kNT = kBlock / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* do_s = q_s + kBlock * S;
  bf16* k_s = do_s + kBlock * S;
  bf16* v_s = k_s + kBlock * S;

  const int q0 = blockIdx.x * kBlock, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (nh / n_kv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, gr = lane >> 2, tg = lane & 3;
  const int64_t q_pitch = static_cast<int64_t>(nh) * HD;
  const int64_t kv_pitch = static_cast<int64_t>(n_kv) * HD;
  const int64_t q_off = (static_cast<int64_t>(b) * sq * nh + h) * HD;
  const int64_t kv_off = (static_cast<int64_t>(b) * skv * n_kv + g) * HD;
  const int64_t row_off = (static_cast<int64_t>(b) * nh + h) * sq;
  const uint8_t* mask_b = mask == nullptr ? nullptr : mask + static_cast<int64_t>(b) * skv;

  load_tile_bf16<HD, kBlock>(q_s, q + q_off, q_pitch, q0, sq);
  load_tile_bf16<HD, kBlock>(do_s, dout + q_off, q_pitch, q0, sq);
  const int rows[2] = {q0 + warp * 16 + gr, q0 + warp * 16 + gr + 8};
  float lse_r[2], delta_r[2], acc[HD / 8][4] = {};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lse_r[r] = rows[r] < sq ? lse[row_off + rows[r]] : kNegInf;
    delta_r[r] = rows[r] < sq ? delta[row_off + rows[r]] : 0.f;
  }

  const int kv_end = causal ? min(skv, q0 + kBlock) : skv;
  for (int t0 = 0; t0 < kv_end; t0 += kBlock) {
    __syncthreads();  // the previous tile is consumed (and q_s, do_s written)
    load_tile_bf16<HD, kBlock>(k_s, k + kv_off, kv_pitch, t0, skv);
    load_tile_bf16<HD, kBlock>(v_s, v + kv_off, kv_pitch, t0, skv);
    __syncthreads();

    float s[kNT][4] = {}, dp[kNT][4] = {};
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t aq[4], ad[4];
      frag_a<HD>(aq, q_s, warp * 16, 16 * kk, gr, tg);
      frag_a<HD>(ad, do_s, warp * 16, 16 * kk, gr, tg);
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        uint32_t b0, b1;
        frag_bt<HD>(b0, b1, k_s, 8 * j, 16 * kk, gr, tg);
        mma16816(s[j], aq, b0, b1);
        frag_bt<HD>(b0, b1, v_s, 8 * j, 16 * kk, gr, tg);
        mma16816(dp[j], ad, b0, b1);
      }
    }
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, key = t0 + 8 * j + 2 * tg + (e & 1);
        const bool valid = key_valid(mask_b, key, skv) && (!causal || rows[r] >= key);
        const float sc = valid ? s[j][e] * scale : kNegInf;
        // a fully masked row has lse == NEG_INF and must give p = 0
        const float p = lse_r[r] == kNegInf ? 0.f : expf(sc - lse_r[r]);
        s[j][e] = p * (dp[j][e] - delta_r[r]) * scale;  // dS
      }
    mma_scores_x<HD, kNT / 2>(acc, s, k_s, lane);  // dS rounded to K's dtype
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= sq) continue;
    bf16* row = dq + ((static_cast<int64_t>(b) * sq + rows[r]) * nh + h) * HD;
#pragma unroll
    for (int c = 0; c < HD / 8; ++c)
      *reinterpret_cast<uint32_t*>(row + 8 * c + 2 * tg) =
          pack_bf16(acc[c][2 * r], acc[c][2 * r + 1]);
  }
}

template <int HD>
__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_dkv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const uint8_t* __restrict__ mask,
                         const bf16* __restrict__ dout, const float* __restrict__ lse,
                         const float* __restrict__ delta, bf16* __restrict__ dk,
                         bf16* __restrict__ dv, int sq, int skv, int nh, int n_kv, float scale,
                         int causal) {
  constexpr int S = mma_stride<HD>();
  constexpr int kNT = kQTile3 / 8;  // query n-tiles of a transposed score tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* v_s = k_s + kBlock * S;
  bf16* q_s = v_s + kBlock * S;
  bf16* do_s = q_s + kQTile3 * S;
  float* lse_s = reinterpret_cast<float*>(do_s + kQTile3 * S);
  float* delta_s = lse_s + kQTile3;

  const int k0 = blockIdx.x * kBlock, g = blockIdx.y, b = blockIdx.z;
  const int rep = nh / n_kv;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, gr = lane >> 2, tg = lane & 3;
  const int64_t q_pitch = static_cast<int64_t>(nh) * HD;
  const int64_t kv_pitch = static_cast<int64_t>(n_kv) * HD;
  const int64_t kv_off = (static_cast<int64_t>(b) * skv * n_kv + g) * HD;
  const uint8_t* mask_b = mask == nullptr ? nullptr : mask + static_cast<int64_t>(b) * skv;

  load_tile_bf16<HD, kBlock>(k_s, k + kv_off, kv_pitch, k0, skv);
  load_tile_bf16<HD, kBlock>(v_s, v + kv_off, kv_pitch, k0, skv);
  // transposed score tiles: row = key (this warp's 16), column = query
  const int keys[2] = {k0 + warp * 16 + gr, k0 + warp * 16 + gr + 8};
  const bool key_ok[2] = {key_valid(mask_b, keys[0], skv), key_valid(mask_b, keys[1], skv)};
  float dk_acc[HD / 8][4] = {}, dv_acc[HD / 8][4] = {};

  // causal: query tiles wholly before this key tile see none of its keys
  const int q_start = causal ? k0 : 0;
  for (int r = 0; r < rep; ++r) {
    const int h = g * rep + r;
    const int64_t q_off = (static_cast<int64_t>(b) * sq * nh + h) * HD;
    const int64_t row_off = (static_cast<int64_t>(b) * nh + h) * sq;
    for (int q0 = q_start; q0 < sq; q0 += kQTile3) {
      __syncthreads();  // the previous query tile is consumed (and k_s, v_s written)
      load_tile_bf16<HD, kQTile3>(q_s, q + q_off, q_pitch, q0, sq);
      load_tile_bf16<HD, kQTile3>(do_s, dout + q_off, q_pitch, q0, sq);
      if (threadIdx.x < kQTile3) {
        const int qi = q0 + threadIdx.x;
        lse_s[threadIdx.x] = qi < sq ? lse[row_off + qi] : kNegInf;  // padded rows: p = 0
        delta_s[threadIdx.x] = qi < sq ? delta[row_off + qi] : 0.f;
      }
      __syncthreads();

      float s[kNT][4] = {}, dp[kNT][4] = {};
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        uint32_t ak[4], av[4];
        frag_a<HD>(ak, k_s, warp * 16, 16 * kk, gr, tg);
        frag_a<HD>(av, v_s, warp * 16, 16 * kk, gr, tg);
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          uint32_t b0, b1;
          frag_bt<HD>(b0, b1, q_s, 8 * j, 16 * kk, gr, tg);
          mma16816(s[j], ak, b0, b1);
          frag_bt<HD>(b0, b1, do_s, 8 * j, 16 * kk, gr, tg);
          mma16816(dp[j], av, b0, b1);
        }
      }
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1, col = 8 * j + 2 * tg + (e & 1), qi = q0 + col;
          const bool valid = key_ok[i] && (!causal || qi >= keys[i]);
          const float sc = valid ? s[j][e] * scale : kNegInf;
          const float lq = lse_s[col];
          const float p = lq == kNegInf ? 0.f : expf(sc - lq);
          dp[j][e] = p * (dp[j][e] - delta_s[col]) * scale;  // dS^T
          s[j][e] = p;                                       // P^T
        }
      mma_scores_x<HD, kNT / 2>(dv_acc, s, do_s, lane);  // P rounded to dO's dtype
      mma_scores_x<HD, kNT / 2>(dk_acc, dp, q_s, lane);  // dS rounded to Q's dtype
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (keys[i] >= skv) continue;
    const int64_t row = ((static_cast<int64_t>(b) * skv + keys[i]) * n_kv + g) * HD;
#pragma unroll
    for (int c = 0; c < HD / 8; ++c) {
      *reinterpret_cast<uint32_t*>(dk + row + 8 * c + 2 * tg) =
          pack_bf16(dk_acc[c][2 * i], dk_acc[c][2 * i + 1]);
      *reinterpret_cast<uint32_t*>(dv + row + 8 * c + 2 * tg) =
          pack_bf16(dv_acc[c][2 * i], dv_acc[c][2 * i + 1]);
    }
  }
}

template <int HD>
constexpr int fwd_mma_smem_bytes() { return 3 * kBlock * mma_stride<HD>() * 2; }
template <int HD>
constexpr int dq_mma_smem_bytes() { return 4 * kBlock * mma_stride<HD>() * 2; }
template <int HD>
constexpr int dkv_mma_smem_bytes() {
  return (2 * kBlock + 2 * kQTile3) * mma_stride<HD>() * 2 + 2 * kQTile3 * 4;
}

template <int HD>
constexpr int fwd_smem_bytes() { return (3 * kBlock * (HD + 1) + kBlock * kSStride) * 4; }
template <int HD>
constexpr int dq_smem_bytes() { return (4 * kBlock * (HD + 1) + kBlock * kSStride) * 4; }
template <int HD>
constexpr int dkv_smem_bytes() {
  return (4 * kBlock * (HD + 1) + 2 * kBlock * kSStride + 2 * kBlock) * 4;
}

// Above 48 KB a kernel needs an opt-in for dynamic shared memory; once per
// kernel instance and process.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, bool& done) {
  if (done) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  done = err == cudaSuccess;
  return err;
}

struct Shape {
  int b, sq, skv, nh, n_kv;
  float scale;
  int causal;
};

// dtype 0 (f32) takes the FMA kernels, dtype 1 (bf16) the tensor-core ones
template <int HD>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, const void* mask, void* o,
                       float* lse, const Shape& a, int dtype, cudaStream_t stream) {
  const dim3 grid((a.sq + kBlock - 1) / kBlock, a.nh, a.b);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  cudaError_t err;
  if (dtype == 0) {
    static bool ready = false;
    constexpr int bytes = fwd_smem_bytes<HD>();
    if ((err = allow_smem(flash_fwd_kernel<HD>, bytes, ready)) != cudaSuccess) return err;
    flash_fwd_kernel<HD><<<grid, kThreads, bytes, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        m, static_cast<float*>(o), lse, a.sq, a.skv, a.nh, a.n_kv, a.scale, a.causal);
  } else {
    static bool ready = false;
    constexpr int bytes = fwd_mma_smem_bytes<HD>();
    if ((err = allow_smem(flash_fwd_mma_kernel<HD>, bytes, ready)) != cudaSuccess) return err;
    flash_fwd_mma_kernel<HD><<<grid, kMmaThreads, bytes, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v), m,
        static_cast<bf16*>(o), lse, a.sq, a.skv, a.nh, a.n_kv, a.scale, a.causal);
  }
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* mask,
                      const void* dout, const float* lse, const float* delta, void* dq,
                      const Shape& a, int dtype, cudaStream_t stream) {
  const dim3 grid((a.sq + kBlock - 1) / kBlock, a.nh, a.b);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  cudaError_t err;
  if (dtype == 0) {
    static bool ready = false;
    constexpr int bytes = dq_smem_bytes<HD>();
    if ((err = allow_smem(flash_bwd_dq_kernel<HD>, bytes, ready)) != cudaSuccess)
      return err;
    flash_bwd_dq_kernel<HD><<<grid, kThreads, bytes, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        m, static_cast<const float*>(dout), lse, delta, static_cast<float*>(dq), a.sq, a.skv,
        a.nh, a.n_kv, a.scale, a.causal);
  } else {
    static bool ready = false;
    constexpr int bytes = dq_mma_smem_bytes<HD>();
    if ((err = allow_smem(flash_bwd_dq_mma_kernel<HD>, bytes, ready)) != cudaSuccess) return err;
    flash_bwd_dq_mma_kernel<HD><<<grid, kMmaThreads, bytes, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v), m,
        static_cast<const bf16*>(dout), lse, delta, static_cast<bf16*>(dq), a.sq, a.skv, a.nh,
        a.n_kv, a.scale, a.causal);
  }
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* mask,
                       const void* dout, const float* lse, const float* delta, void* dk,
                       void* dv, const Shape& a, int dtype, cudaStream_t stream) {
  const dim3 grid((a.skv + kBlock - 1) / kBlock, a.n_kv, a.b);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  cudaError_t err;
  if (dtype == 0) {
    static bool ready = false;
    constexpr int bytes = dkv_smem_bytes<HD>();
    if ((err = allow_smem(flash_bwd_dkv_kernel<HD>, bytes, ready)) != cudaSuccess)
      return err;
    flash_bwd_dkv_kernel<HD><<<grid, kThreads, bytes, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        m, static_cast<const float*>(dout), lse, delta, static_cast<float*>(dk),
        static_cast<float*>(dv), a.sq, a.skv, a.nh, a.n_kv, a.scale, a.causal);
  } else {
    static bool ready = false;
    constexpr int bytes = dkv_mma_smem_bytes<HD>();
    if ((err = allow_smem(flash_bwd_dkv_mma_kernel<HD>, bytes, ready)) != cudaSuccess)
      return err;
    flash_bwd_dkv_mma_kernel<HD><<<grid, kMmaThreads, bytes, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v), m,
        static_cast<const bf16*>(dout), lse, delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv),
        a.sq, a.skv, a.nh, a.n_kv, a.scale, a.causal);
  }
  return cudaGetLastError();
}

bool valid_shape(const Shape& a, int hd, int dtype) {
  return a.b >= 1 && a.sq >= 1 && a.skv >= 1 && a.n_kv >= 1 && a.nh >= a.n_kv &&
         a.nh % a.n_kv == 0 && (hd == 64 || hd == 128) && (dtype == 0 || dtype == 1) &&
         a.b <= 65535 && a.nh <= 65535;
}

}  // namespace

// dtype codes shared with the Python wrapper: 0 = f32, 1 = bf16 (q, k, v, o,
// dO and the gradients all share it). mask is null or [b, skv] bytes.

extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, const void* mask,
                                   void* o, void* lse, int b, int sq, int skv, int nh, int n_kv,
                                   int hd, float scale, int causal, int dtype, void* stream) {
  (void)cudaGetLastError();  // report this launch's error, not a stale one
  const Shape a{b, sq, skv, nh, n_kv, scale, causal};
  if (!valid_shape(a, hd, dtype)) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  return hd == 64 ? launch_fwd<64>(q, k, v, mask, o, l, a, dtype, st)
                  : launch_fwd<128>(q, k, v, mask, o, l, a, dtype, st);
}

extern "C" int flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                                      const void* mask, const void* dout, const void* lse,
                                      const void* delta, void* dq, int b, int sq, int skv,
                                      int nh, int n_kv, int hd, float scale, int causal,
                                      int dtype, void* stream) {
  (void)cudaGetLastError();
  const Shape a{b, sq, skv, nh, n_kv, scale, causal};
  if (!valid_shape(a, hd, dtype)) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* d = static_cast<const float*>(delta);
  return hd == 64 ? launch_dq<64>(q, k, v, mask, dout, l, d, dq, a, dtype, st)
                  : launch_dq<128>(q, k, v, mask, dout, l, d, dq, a, dtype, st);
}

extern "C" int flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                       const void* mask, const void* dout, const void* lse,
                                       const void* delta, void* dk, void* dv, int b, int sq,
                                       int skv, int nh, int n_kv, int hd, float scale,
                                       int causal, int dtype, void* stream) {
  (void)cudaGetLastError();
  const Shape a{b, sq, skv, nh, n_kv, scale, causal};
  if (!valid_shape(a, hd, dtype)) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* d = static_cast<const float*>(delta);
  return hd == 64 ? launch_dkv<64>(q, k, v, mask, dout, l, d, dk, dv, a, dtype, st)
                  : launch_dkv<128>(q, k, v, mask, dout, l, d, dk, dv, a, dtype, st);
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
