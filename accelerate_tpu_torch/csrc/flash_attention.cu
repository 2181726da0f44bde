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
// 989 TFLOP/s and HBM's 3.35 TB/s the bounds are 0.030 (bytes, just: the
// operations take 0.026), 0.039 and 0.052 ms (operations). So all three are
// to be judged by the tensor cores' rate.
//
// Design, shared by every family:
//  * The TPU grid (b, h, nq, nkv) ran its last axis in order, carrying the
//    online-softmax state or the gradient accumulator in VMEM scratch. Here
//    one thread block owns one output tile and loops over the other axis
//    itself: forward and dq one block per (query rows, head, batch) over
//    key tiles up to the causal limit; dk/dv one block per (keys, kv head,
//    batch) over the rep query heads that share the kv head and over the
//    query tiles from the causal start. Summing the GQA heads inside the
//    block needs no atomics and keeps dK/dV deterministic.
//  * Rows past a sequence's end are zero and masked, so any length works.
//  * Rounding points follow the TPU kernels, so the kernels and the plain
//    version agree in bf16: P is rounded to the value dtype before P V, P to
//    dO's dtype before P^T dO, dS to K's / Q's dtype before dS K and dS^T Q.
//    Every accumulator is f32.
// The families:
//  * f32 inputs run every product on the FMA units (67 TFLOP/s peak), with
//    no TF32, so they meet the JAX gates (2e-5) against the plain version:
//    64-row tiles, 256 threads form a 16 x 16 grid over a 64 x 64 score
//    tile, tiles staged as f32 with rows padded by one float; expf, logf.
//  * bf16 forward (B1), dq (B2) and dk/dv (B3): wgmma fed by a ring of TMA
//    copies with mbarriers, two warpgroups of products (section "bf16
//    forward (B1), dq (B2) and dk/dv (B3) for Hopper"). B1 takes 128
//    query rows a block, with a producer warp in a third
//    warpgroup, and streams K/V tiles of 128 keys through three stages, so
//    the next tiles' loads overlap this tile's products; it applies the
//    causal compare and the key mask only on the tiles that need them (the
//    diagonal, the ragged edge, masked keys) and launches the heaviest
//    causal query tiles first. B3 takes 128 keys a block, loads K and V
//    once and streams tiles of 64 query rows (Q, dO, lse, delta) through
//    three stages; its four products per tile are wgmmas, P^T and dS^T never
//    leave registers, and it masks only the diagonal and masked keys. B2
//    takes 128 query rows a block, loads Q and dO once and streams K/V
//    tiles of 64 keys (with their mask bytes) through four stages; S and dP
//    are SS wgmmas, dS stays in registers as the A operand of dS K against
//    the same K tile read MN-major; it masks as B1 does and launches the
//    heaviest causal query tiles first. exp is ex2.approx with
//    scale * log2(e) folded in; lse stays a natural log.

#include <cfloat>
#include <cstdint>

#include <cuda.h>
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
// bf16 helpers shared by the tensor-core kernels
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

// two f32 values rounded to bf16, the lower column in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(kFull, x, 1));
  return fmaxf(x, __shfl_xor_sync(kFull, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(kFull, x, 1);
  return x + __shfl_xor_sync(kFull, x, 2);
}


// ---------------------------------------------------------------------------
// bf16 forward (B1), dq (B2) and dk/dv (B3) for Hopper: wgmma fed by a TMA
// ring.
//
// Two warpgroups compute: each owns 64 rows of the block's 128-row output
// tile (the wgmma M) and runs the products. One warp keeps a ring of stages
// in shared memory filled: it issues the TMA copies and stages the small
// per-tile vectors (mask bytes, lse, delta) beside them. Each stage has a
// "full" mbarrier (the copies' bytes plus that warp's 32 arrivals) and an
// "empty" one (the 256 computing threads' arrivals), so the next tiles'
// loads overlap this tile's products.
//  * B1 adds a third warpgroup whose first warp is that producer; it gives
//    up its registers with setmaxnreg. B1's consumers fit in the 168
//    registers that a 384-thread launch bound leaves.
//  * B3's consumers need 228 registers (the dK and dV accumulators alone
//    are 128). ptxas budgets every warpgroup of a block at the launch bound
//    (a 288- or 384-thread block: 168) and does not allocate above it after
//    setmaxnreg.inc, so a producer warpgroup made B3 spill. B3 is two
//    warpgroups (a 255-register budget) and warp 0 refills, at the top of
//    each tile, the stage the previous tile used.
//  * B2 takes B3's shape with the roles of queries and keys swapped: Q and
//    dO of 128 query rows are loaded once, and tiles of 64 keys (K, V and
//    the tile's mask bytes) stream through four stages. ptxas gives it
//    160 registers a thread at hd 128 (the dQ accumulator is 64 of them).
//
// Operand tiles live in shared memory exactly as TMA writes them with the
// 128-byte swizzle: rows of 64 bf16 (128 bytes), a head of 128 split into
// two such halves, each half 1024-byte aligned. A wgmma descriptor reads
// them K-major (a 16-wide K step is 32 bytes into the row, walking across
// the halves) or MN-major (a 16-row K step is 2048 bytes on, the second
// half of the MN extent one half-tile on). Tensor maps are 4-D over
// (hd, heads, s, b), so TMA's zero fill stops at each sequence's own end.
//
// Score accumulators stay in registers: the wgmma accumulator layout of a
// 64 x 16 slice is the register A layout of the next wgmma, so P (forward)
// P^T, dS^T (dk/dv) and dS (dq) are rounded to bf16 where the TPU kernels
// round them and fed to register-A wgmmas against V, dO, Q and K.
// ---------------------------------------------------------------------------

constexpr int kWgThreads = 128;                  // one warpgroup
constexpr int kFwdThreads = 3 * kWgThreads;      // two consumer warpgroups + the producer's
constexpr int kSwizzleRow = 128;                 // bytes of a swizzled row: 64 bf16
constexpr int kFwdRows = 128;                    // query rows of a forward block
constexpr int kFwdTileKeys = 128;                // keys per forward tile (the plain forward's tile)
constexpr int kFwdStages = 3;
constexpr int kDkvKeys = 128;                    // keys of a dk/dv block
constexpr int kDkvQRows = 64;                    // query rows per dk/dv tile (the wgmma N)
constexpr int kDkvStages = 3;
constexpr int kDkvThreads = 2 * kWgThreads;      // two warpgroups, no producer warpgroup
constexpr int kDqRows = 128;                     // query rows of a dq block
constexpr int kDqTileKeys = 64;                  // keys per dq tile (the wgmma N of S and dP)
constexpr int kDqStages = 4;
constexpr int kDqThreads = 2 * kWgThreads;       // two warpgroups, as B3
// B1's registers a thread after setmaxnreg: 128 x kProducerRegs + 256 x
// kConsumerRegs is the pool of 384 threads at 168 each (the launch bound)
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr int kLaunchRegs = 168;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// one arrival that also announces `bytes` of copies still to land
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Wait until the barrier's phase of the given parity has completed. A wait
// that outlasts 10 s is a broken ring: trap, so the launch reports an error
// instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint64_t t0 = 0;
  for (uint32_t spin = 1;; ++spin) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (spin % 4096 == 0) {
      const uint64_t now = global_ns();
      if (t0 == 0) t0 = now;
      else if (now - t0 > 10000000000ull) __trap();
    }
  }
}

// TMA: one box of a 4-D tensor map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, int c3, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

template <int N>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// wgmma shared-memory descriptor of a 128-byte swizzled tile: start address,
// leading and stride byte offsets (each >> 4), layout type 1 (128-byte
// swizzle) in bits 62-63. K-major: the stride offset is 1024 (8 rows of 128
// bytes) and the leading offset unused. MN-major: the stride offset is 1024
// (8 K-rows), the leading offset the step to the next 64 MN columns (the
// next half-tile).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lead, uint32_t stride) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(lead >> 4) << 16 | static_cast<uint64_t>(stride >> 4) << 32 |
         1ull << 62;
}

__device__ __forceinline__ uint64_t desc_kmajor(uint32_t addr) { return smem_desc(addr, 16, 1024); }

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Registers an in-flight wgmma reads or writes: after the wait, each is
// "touched" so the compiler neither reads an accumulator early nor reuses
// an A register before the product has landed.
template <int N>
__device__ __forceinline__ void settle(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void settle(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// wgmma m64nNk16, bf16 in, f32 accumulators. ss: d = A B (+ d if
// accumulate), A and B K-major in shared memory. rs: d += A B, A in
// registers (the accumulator layout), B MN-major in shared memory.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t desc_a, uint64_t desc_b,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], uint32_t a0, uint32_t a1, uint32_t a2,
                                              uint32_t a3, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], uint32_t a0, uint32_t a1, uint32_t a2,
                                             uint32_t a3, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(1));
}

// d (64 x HD) += A B over 16 K-rows: A is register fragment kk of `a`, B the
// MN-major tile at `b_addr` (K-rows of 128 bytes, halves `half` bytes apart)
template <int HD, int NA>
__device__ __forceinline__ void wgmma_rs_hd(float (&d)[HD / 2], const uint32_t (&a)[NA], int kk,
                                            uint32_t b_addr, uint32_t half) {
  const uint64_t desc = smem_desc(b_addr, half, 1024);
  if constexpr (HD == 128)
    wgmma_rs_n128(d, a[4 * kk], a[4 * kk + 1], a[4 * kk + 2], a[4 * kk + 3], desc);
  else
    wgmma_rs_n64(d, a[4 * kk], a[4 * kk + 1], a[4 * kk + 2], a[4 * kk + 3], desc);
}

// Accumulators (64 x 16*KSTEPS, element i of a thread: row +8 if bit 1,
// column 8 * (i / 4) + 2 * (lane % 4) + bit 0) rounded to bf16 as the A
// fragments of the next wgmma, 16 columns per K step.
template <int KSTEPS>
__device__ __forceinline__ void pack_a(uint32_t (&a)[4 * KSTEPS], const float (&s)[8 * KSTEPS]) {
#pragma unroll
  for (int i = 0; i < 4 * KSTEPS; ++i) a[i] = pack_bf16(s[2 * i], s[2 * i + 1]);
}

template <int HD>
struct FwdSmem {
  static constexpr int kHalves = HD / 64;
  static constexpr uint32_t kQHalf = kFwdRows * kSwizzleRow;
  static constexpr uint32_t kKVHalf = kFwdTileKeys * kSwizzleRow;
  static constexpr uint32_t kKVStage = kHalves * kKVHalf;
  static constexpr uint32_t kQ = 0;
  static constexpr uint32_t kK = kQ + kHalves * kQHalf;
  static constexpr uint32_t kV = kK + kFwdStages * kKVStage;
  // barriers: Q, then K full, V full and empty for each stage
  static constexpr uint32_t kBars = kV + kFwdStages * kKVStage;
  static constexpr uint32_t kMask = kBars + (1 + 3 * kFwdStages) * 8;
  static constexpr uint32_t kNeed = kMask + kFwdStages * kFwdTileKeys;
  static constexpr uint32_t kBytes = kNeed + kFwdStages * 4 + 1024;  // + alignment slack
};

template <int HD>
__global__ void __launch_bounds__(kFwdThreads, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                       const __grid_constant__ CUtensorMap k_map,
                       const __grid_constant__ CUtensorMap v_map,
                       const uint8_t* __restrict__ mask, bf16* __restrict__ o,
                       float* __restrict__ lse, int sq, int skv, int nh, int n_kv, float scale,
                       int causal) {
  using L = FwdSmem<HD>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // 128-byte swizzle: 1024-byte aligned tiles
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t bar_q = base + L::kBars;
  const uint32_t bar_k = bar_q + 8, bar_v = bar_k + 8 * kFwdStages, bar_e = bar_v + 8 * kFwdStages;
  uint8_t* mask_s = smem + L::kMask;
  int* need_s = reinterpret_cast<int*>(smem + L::kNeed);

  // the heaviest causal query tiles first: the last grid axis, reversed
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kFwdRows, h = blockIdx.x, b = blockIdx.y;
  const int g = h / (nh / n_kv);
  const int kv_end = causal ? min(skv, q0 + kFwdRows) : skv;
  const int n_tiles = (kv_end + kFwdTileKeys - 1) / kFwdTileKeys;
  const uint8_t* mask_b = mask == nullptr ? nullptr : mask + static_cast<int64_t>(b) * skv;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kFwdStages; ++s) {
      mbar_init(bar_k + 8 * s, 32);  // the producer warp: mask bytes, then K's copies
      mbar_init(bar_v + 8 * s, 1);
      mbar_init(bar_e + 8 * s, 2 * kWgThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / kWgThreads;
  if (wg == 2) {
    // producer: one warp issues the copies; the other three leave
    regs_dec<kProducerRegs>();
    if (threadIdx.x % kWgThreads >= 32) return;
    const int lane = threadIdx.x % 32;
    if (lane == 0) {
      mbar_expect_tx(bar_q, L::kHalves * L::kQHalf);
      for (int hf = 0; hf < L::kHalves; ++hf)
        tma_load_4d(base + L::kQ + hf * L::kQHalf, &q_map, 64 * hf, h, q0, b, bar_q);
    }
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % kFwdStages, t0 = j * kFwdTileKeys;
      mbar_wait(bar_e + 8 * s, ((j / kFwdStages) & 1) ^ 1);
      int need = 0;
      if (mask_b != nullptr) {  // this tile's mask bytes, and whether any key is masked
        uint32_t word = 0;
        bool all = true;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int key = t0 + 4 * lane + i;
          const uint32_t mv = key < skv ? mask_b[key] : 1u;
          word |= mv << (8 * i);
          all = all && mv != 0;
        }
        reinterpret_cast<uint32_t*>(mask_s + s * kFwdTileKeys)[lane] = word;
        need = !__all_sync(kFull, all);
      }
      if (lane == 0) {
        need_s[s] = need;
        mbar_expect_tx(bar_k + 8 * s, L::kKVStage);
        for (int hf = 0; hf < L::kHalves; ++hf)
          tma_load_4d(base + L::kK + s * L::kKVStage + hf * L::kKVHalf, &k_map, 64 * hf, g, t0, b,
                      bar_k + 8 * s);
        mbar_expect_tx(bar_v + 8 * s, L::kKVStage);
        for (int hf = 0; hf < L::kHalves; ++hf)
          tma_load_4d(base + L::kV + s * L::kKVStage + hf * L::kKVHalf, &v_map, 64 * hf, g, t0, b,
                      bar_v + 8 * s);
      } else {
        mbar_arrive(bar_k + 8 * s);
      }
    }
  } else {
    regs_inc<kConsumerRegs>();
    const int tid = threadIdx.x % kWgThreads, warp = tid / 32, lane = tid % 32;
    const int gr = lane >> 2, tg = lane & 3;
    const int r0 = q0 + 64 * wg;  // this warpgroup's first query row
    const int rows[2] = {r0 + 16 * warp + gr, r0 + 16 * warp + gr + 8};
    const float c = scale * kLog2e;  // exp(scale * x) = 2^(c * x)
    const uint32_t q_wg = base + L::kQ + 64 * wg * kSwizzleRow;
    float acc[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
    // m is the running max of the raw scores Q K^T (NEG_INF while a row has
    // seen no valid key); l the running sum of p
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
    mbar_wait(bar_q, 0);

    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % kFwdStages, t0 = j * kFwdTileKeys;
      const uint32_t phase = (j / kFwdStages) & 1;
      const uint32_t k_s = base + L::kK + s * L::kKVStage, v_s = base + L::kV + s * L::kKVStage;

      float sc[kFwdTileKeys / 2];  // S = Q K^T, 64 rows x 128 keys
      mbar_wait(bar_k + 8 * s, phase);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;
        wgmma_ss_n128(sc, desc_kmajor(q_wg + (kk / 4) * L::kQHalf + off),
                      desc_kmajor(k_s + (kk / 4) * L::kKVHalf + off), kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      settle(sc);

      // the causal compare and the key mask, only where a tile needs them
      const bool need = need_s[s] != 0 || t0 + kFwdTileKeys > skv ||
                        (causal && t0 + kFwdTileKeys - 1 > r0);
      if (need) {
        const uint8_t* mk = mask_s + s * kFwdTileKeys;
#pragma unroll
        for (int i = 0; i < kFwdTileKeys / 2; ++i) {
          const int col = 8 * (i >> 2) + 2 * tg + (i & 1), key = t0 + col;
          const bool valid = key < skv && (!causal || rows[(i >> 1) & 1] >= key) &&
                             (mask_b == nullptr || mk[col] != 0);
          if (!valid) sc[i] = kNegInf;
        }
      }

      float mx[2] = {m[0], m[1]}, sum[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < kFwdTileKeys / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
      float alpha[2], mc[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = quad_max(mx[r]);
        alpha[r] = ex2((m[r] - mx[r]) * c);  // 0 when m was NEG_INF and mx is not
        mc[r] = mx[r] * c;
      }
#pragma unroll
      for (int i = 0; i < kFwdTileKeys / 2; ++i) {
        const int r = (i >> 1) & 1;
        // NEG_INF is finite: a row with no valid key yet takes p = 0
        sc[i] = mx[r] == kNegInf ? 0.f : ex2(fmaf(sc[i], c, -mc[r]));
        sum[r] += sc[i];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] = alpha[r] * l[r] + quad_sum(sum[r]);
        m[r] = mx[r];
      }
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];

      uint32_t pa[kFwdTileKeys / 4];  // P rounded to V's dtype
      pack_a<kFwdTileKeys / 16>(pa, sc);
      mbar_wait(bar_v + 8 * s, phase);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kFwdTileKeys / 16; ++kk)
        wgmma_rs_hd<HD>(acc, pa, kk, v_s + kk * 16 * kSwizzleRow, L::kKVHalf);
      wgmma_commit();
      wgmma_wait_all();
      settle(acc);
      settle(pa);
      mbar_arrive(bar_e + 8 * s);
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (rows[r] >= sq) continue;
      const bool empty = l[r] == 0.f;
      const float den = empty ? 1.f : l[r];
      bf16* o_row = o + ((static_cast<int64_t>(b) * sq + rows[r]) * nh + h) * HD;
#pragma unroll
      for (int c8 = 0; c8 < HD / 8; ++c8)
        *reinterpret_cast<uint32_t*>(o_row + 8 * c8 + 2 * tg) =
            pack_bf16(acc[4 * c8 + 2 * r] / den, acc[4 * c8 + 2 * r + 1] / den);
      if (tg == 0)
        lse[(static_cast<int64_t>(b) * nh + h) * sq + rows[r]] =
            empty ? kNegInf : m[r] * scale + logf(den);
    }
  }
}

template <int HD>
struct DkvSmem {
  static constexpr int kHalves = HD / 64;
  static constexpr uint32_t kKVHalf = kDkvKeys * kSwizzleRow;
  static constexpr uint32_t kQHalf = kDkvQRows * kSwizzleRow;
  static constexpr uint32_t kQTile = kHalves * kQHalf;
  static constexpr uint32_t kK = 0;
  static constexpr uint32_t kV = kK + kHalves * kKVHalf;
  // stage s: Q at kQ + 2 s kQTile, dO right after it
  static constexpr uint32_t kQ = kV + kHalves * kKVHalf;
  static constexpr uint32_t kLse = kQ + kDkvStages * 2 * kQTile;
  static constexpr uint32_t kDelta = kLse + kDkvStages * kDkvQRows * 4;
  // barriers: K and V, then full and empty for each stage
  static constexpr uint32_t kBars = kDelta + kDkvStages * kDkvQRows * 4;
  static constexpr uint32_t kBytes = kBars + (1 + 2 * kDkvStages) * 8 + 1024;
};

template <int HD>
__global__ void __launch_bounds__(kDkvThreads, 1)
flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                           const __grid_constant__ CUtensorMap k_map,
                           const __grid_constant__ CUtensorMap v_map,
                           const __grid_constant__ CUtensorMap do_map,
                           const uint8_t* __restrict__ mask, const float* __restrict__ lse,
                           const float* __restrict__ delta, bf16* __restrict__ dk,
                           bf16* __restrict__ dv, int sq, int skv, int nh, int n_kv, float scale,
                           int causal) {
  using L = DkvSmem<HD>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t bar_kv = base + L::kBars;
  const uint32_t bar_f = bar_kv + 8, bar_e = bar_f + 8 * kDkvStages;
  float* lse_s = reinterpret_cast<float*>(smem + L::kLse);
  float* delta_s = reinterpret_cast<float*>(smem + L::kDelta);

  // causal: the first key tiles see the most query tiles, and run first
  const int k0 = blockIdx.z * kDkvKeys, g = blockIdx.x, b = blockIdx.y;
  const int rep = nh / n_kv;
  // causal: query tiles wholly before this key tile see none of its keys
  const int q_start = causal ? k0 : 0;
  const int n_qt = q_start < sq ? (sq - q_start + kDkvQRows - 1) / kDkvQRows : 0;
  const int n_tiles = rep * n_qt;  // (query head, query tile) pairs, head-major
  const uint8_t* mask_b = mask == nullptr ? nullptr : mask + static_cast<int64_t>(b) * skv;

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < kDkvStages; ++s) {
      mbar_init(bar_f + 8 * s, 32);  // warp 0: lse and delta, then the copies' bytes
      mbar_init(bar_e + 8 * s, kDkvThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / kWgThreads, tid = threadIdx.x % kWgThreads;
  const int warp = tid / 32, lane = tid % 32;
  const bool stager = threadIdx.x < 32;  // warp 0 keeps the ring filled
  const CUtensorMap* q_tma = &q_map;
  const CUtensorMap* do_tma = &do_map;
  // warp 0: wait until tile jt's stage is free, stage its lse and delta (rows
  // past the sequence: lse = NEG_INF, so p = 0) and start its Q and dO copies
  auto stage_tile = [&](int jt) {
    const int s = jt % kDkvStages;
    const int h = g * rep + jt / n_qt, q0 = q_start + (jt % n_qt) * kDkvQRows;
    mbar_wait(bar_e + 8 * s, ((jt / kDkvStages) & 1) ^ 1);
    const int64_t row_off = (static_cast<int64_t>(b) * nh + h) * sq;
    for (int i = lane; i < kDkvQRows; i += 32) {
      const int qi = q0 + i;
      lse_s[s * kDkvQRows + i] = qi < sq ? lse[row_off + qi] : kNegInf;
      delta_s[s * kDkvQRows + i] = qi < sq ? delta[row_off + qi] : 0.f;
    }
    if (lane == 0) {
      const uint32_t q_s = base + L::kQ + 2 * s * L::kQTile;
      mbar_expect_tx(bar_f + 8 * s, 2 * L::kQTile);
      for (int hf = 0; hf < L::kHalves; ++hf) {
        tma_load_4d(q_s + hf * L::kQHalf, q_tma, 64 * hf, h, q0, b, bar_f + 8 * s);
        tma_load_4d(q_s + L::kQTile + hf * L::kQHalf, do_tma, 64 * hf, h, q0, b, bar_f + 8 * s);
      }
    } else {
      mbar_arrive(bar_f + 8 * s);
    }
  };
  if (stager) {
    if (lane == 0) {
      mbar_expect_tx(bar_kv, 2 * L::kHalves * L::kKVHalf);
      for (int hf = 0; hf < L::kHalves; ++hf) {
        tma_load_4d(base + L::kK + hf * L::kKVHalf, &k_map, 64 * hf, g, k0, b, bar_kv);
        tma_load_4d(base + L::kV + hf * L::kKVHalf, &v_map, 64 * hf, g, k0, b, bar_kv);
      }
    }
    for (int jt = 0; jt < kDkvStages - 1 && jt < n_tiles; ++jt) stage_tile(jt);
  }

  const int gr = lane >> 2, tg = lane & 3;
  const int rk0 = k0 + 64 * wg;  // this warpgroup's first key
  // transposed score tiles: row = key, column = query
  const int keys[2] = {rk0 + 16 * warp + gr, rk0 + 16 * warp + gr + 8};
  const bool key_ok[2] = {key_valid(mask_b, keys[0], skv), key_valid(mask_b, keys[1], skv)};
  const bool keys_ok = key_ok[0] && key_ok[1];
  const float c = scale * kLog2e;
  const uint32_t k_wg = base + L::kK + 64 * wg * kSwizzleRow;
  const uint32_t v_wg = base + L::kV + 64 * wg * kSwizzleRow;
  float dk_acc[HD / 2], dv_acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  mbar_wait(bar_kv, 0);

  for (int j = 0; j < n_tiles; ++j) {
    // refill the stage that tile j - 1 used: warpgroup 0 may run at most
    // one tile ahead of warpgroup 1, warpgroup 1 as far ahead as the ring
    if (stager && j + kDkvStages - 1 < n_tiles) stage_tile(j + kDkvStages - 1);
    const int s = j % kDkvStages, q0 = q_start + (j % n_qt) * kDkvQRows;
    const uint32_t q_s = base + L::kQ + 2 * s * L::kQTile, do_s = q_s + L::kQTile;
    mbar_wait(bar_f + 8 * s, (j / kDkvStages) & 1);
    if (causal && q0 + kDkvQRows <= rk0) {  // every query before every key
      mbar_arrive(bar_e + 8 * s);
      continue;
    }
    float st[kDkvQRows / 2], dpt[kDkvQRows / 2];  // S^T = K Q^T, dP^T = V dO^T
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t off = (kk % 4) * 32;
      wgmma_ss_n64(st, desc_kmajor(k_wg + (kk / 4) * L::kKVHalf + off),
                   desc_kmajor(q_s + (kk / 4) * L::kQHalf + off), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t off = (kk % 4) * 32;
      wgmma_ss_n64(dpt, desc_kmajor(v_wg + (kk / 4) * L::kKVHalf + off),
                   desc_kmajor(do_s + (kk / 4) * L::kQHalf + off), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    settle(st);
    settle(dpt);

    // the causal compare and the key mask only on the diagonal and for
    // masked keys; P^T = 0 where lse == NEG_INF (a fully masked row)
    const bool need = !keys_ok || (causal && q0 < rk0 + 64);
    const float* ls = lse_s + s * kDkvQRows;
    const float* dl = delta_s + s * kDkvQRows;
#pragma unroll
    for (int i = 0; i < kDkvQRows / 2; ++i) {
      const int col = 8 * (i >> 2) + 2 * tg + (i & 1), kr = (i >> 1) & 1;
      const float lq = ls[col];
      bool valid = lq != kNegInf;
      if (need) valid = valid && key_ok[kr] && (!causal || q0 + col >= keys[kr]);
      const float p = valid ? ex2(fmaf(st[i], c, -lq * kLog2e)) : 0.f;
      dpt[i] = p * (dpt[i] - dl[col]) * scale;  // dS^T
      st[i] = p;                                // P^T
    }
    uint32_t pp[kDkvQRows / 4], pd[kDkvQRows / 4];
    pack_a<kDkvQRows / 16>(pp, st);   // P rounded to dO's dtype
    pack_a<kDkvQRows / 16>(pd, dpt);  // dS rounded to Q's dtype
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kDkvQRows / 16; ++kk)
      wgmma_rs_hd<HD>(dv_acc, pp, kk, do_s + kk * 16 * kSwizzleRow, L::kQHalf);
#pragma unroll
    for (int kk = 0; kk < kDkvQRows / 16; ++kk)
      wgmma_rs_hd<HD>(dk_acc, pd, kk, q_s + kk * 16 * kSwizzleRow, L::kQHalf);
    wgmma_commit();
    wgmma_wait_all();
    settle(dv_acc);
    settle(dk_acc);
    settle(pp);
    settle(pd);
    mbar_arrive(bar_e + 8 * s);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (keys[i] >= skv) continue;
    const int64_t row = ((static_cast<int64_t>(b) * skv + keys[i]) * n_kv + g) * HD;
#pragma unroll
    for (int c8 = 0; c8 < HD / 8; ++c8) {
      *reinterpret_cast<uint32_t*>(dk + row + 8 * c8 + 2 * tg) =
          pack_bf16(dk_acc[4 * c8 + 2 * i], dk_acc[4 * c8 + 2 * i + 1]);
      *reinterpret_cast<uint32_t*>(dv + row + 8 * c8 + 2 * tg) =
          pack_bf16(dv_acc[4 * c8 + 2 * i], dv_acc[4 * c8 + 2 * i + 1]);
    }
  }
}

template <int HD>
struct DqSmem {
  static constexpr int kHalves = HD / 64;
  static constexpr uint32_t kQHalf = kDqRows * kSwizzleRow;
  static constexpr uint32_t kQTile = kHalves * kQHalf;
  static constexpr uint32_t kKVHalf = kDqTileKeys * kSwizzleRow;
  static constexpr uint32_t kKVTile = kHalves * kKVHalf;
  static constexpr uint32_t kQ = 0;
  static constexpr uint32_t kDo = kQ + kQTile;
  // stage s: K at kK + 2 s kKVTile, V right after it
  static constexpr uint32_t kK = kDo + kQTile;
  static constexpr uint32_t kMask = kK + kDqStages * 2 * kKVTile;
  static constexpr uint32_t kNeed = kMask + kDqStages * kDqTileKeys;
  // barriers: Q and dO, then full and empty for each stage
  static constexpr uint32_t kBars = kNeed + kDqStages * 4;
  static constexpr uint32_t kBytes = kBars + (1 + 2 * kDqStages) * 8 + 1024;
};

template <int HD>
__global__ void __launch_bounds__(kDqThreads, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                          const __grid_constant__ CUtensorMap k_map,
                          const __grid_constant__ CUtensorMap v_map,
                          const __grid_constant__ CUtensorMap do_map,
                          const uint8_t* __restrict__ mask, const float* __restrict__ lse,
                          const float* __restrict__ delta, bf16* __restrict__ dq, int sq,
                          int skv, int nh, int n_kv, float scale, int causal) {
  using L = DqSmem<HD>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t bar_q = base + L::kBars;
  const uint32_t bar_f = bar_q + 8, bar_e = bar_f + 8 * kDqStages;
  uint8_t* mask_s = smem + L::kMask;
  int* need_s = reinterpret_cast<int*>(smem + L::kNeed);

  // the heaviest causal query tiles first: the last grid axis, reversed
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kDqRows, h = blockIdx.x, b = blockIdx.y;
  const int g = h / (nh / n_kv);
  const int kv_end = causal ? min(skv, q0 + kDqRows) : skv;
  const int n_tiles = (kv_end + kDqTileKeys - 1) / kDqTileKeys;
  const uint8_t* mask_b = mask == nullptr ? nullptr : mask + static_cast<int64_t>(b) * skv;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kDqStages; ++s) {
      mbar_init(bar_f + 8 * s, 32);  // warp 0: mask bytes, then K's and V's copies
      mbar_init(bar_e + 8 * s, kDqThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / kWgThreads, tid = threadIdx.x % kWgThreads;
  const int warp = tid / 32, lane = tid % 32;
  const bool stager = threadIdx.x < 32;  // warp 0 keeps the ring filled
  const CUtensorMap* k_tma = &k_map;
  const CUtensorMap* v_tma = &v_map;
  // warp 0: wait until tile jt's stage is free, stage its mask bytes (and
  // whether any key of it is masked) and start its K and V copies
  auto stage_tile = [&](int jt) {
    const int s = jt % kDqStages, t0 = jt * kDqTileKeys;
    mbar_wait(bar_e + 8 * s, ((jt / kDqStages) & 1) ^ 1);
    int need = 0;
    if (mask_b != nullptr) {
      uint32_t word = 0;
      bool all = true;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int key = t0 + 2 * lane + i;
        const uint32_t mv = key < skv ? mask_b[key] : 1u;  // the ragged edge is tested apart
        word |= mv << (8 * i);
        all = all && mv != 0;
      }
      reinterpret_cast<uint16_t*>(mask_s + s * kDqTileKeys)[lane] = static_cast<uint16_t>(word);
      need = !__all_sync(kFull, all);
    }
    if (lane == 0) {
      need_s[s] = need;
      const uint32_t k_s = base + L::kK + 2 * s * L::kKVTile;
      mbar_expect_tx(bar_f + 8 * s, 2 * L::kKVTile);
      for (int hf = 0; hf < L::kHalves; ++hf) {
        tma_load_4d(k_s + hf * L::kKVHalf, k_tma, 64 * hf, g, t0, b, bar_f + 8 * s);
        tma_load_4d(k_s + L::kKVTile + hf * L::kKVHalf, v_tma, 64 * hf, g, t0, b, bar_f + 8 * s);
      }
    } else {
      mbar_arrive(bar_f + 8 * s);
    }
  };
  if (stager) {
    if (lane == 0) {
      mbar_expect_tx(bar_q, 2 * L::kQTile);
      for (int hf = 0; hf < L::kHalves; ++hf) {
        tma_load_4d(base + L::kQ + hf * L::kQHalf, &q_map, 64 * hf, h, q0, b, bar_q);
        tma_load_4d(base + L::kDo + hf * L::kQHalf, &do_map, 64 * hf, h, q0, b, bar_q);
      }
    }
    for (int jt = 0; jt < kDqStages - 1 && jt < n_tiles; ++jt) stage_tile(jt);
  }

  const int gr = lane >> 2, tg = lane & 3;
  const int r0 = q0 + 64 * wg;  // this warpgroup's first query row
  const int rows[2] = {r0 + 16 * warp + gr, r0 + 16 * warp + gr + 8};
  // lse (in log2 units) and delta of the thread's two rows, read once. A row
  // past the sequence or with no valid key (lse == NEG_INF) gives p = 0.
  const int64_t row_off = (static_cast<int64_t>(b) * nh + h) * sq;
  bool live[2];
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float l = rows[r] < sq ? lse[row_off + rows[r]] : kNegInf;
    live[r] = l != kNegInf;
    lse2[r] = live[r] ? l * kLog2e : 0.f;
    dl[r] = rows[r] < sq ? delta[row_off + rows[r]] : 0.f;
  }
  const float c = scale * kLog2e;  // exp(scale * x - lse) = 2^(c * x - lse2)
  const uint32_t q_wg = base + L::kQ + 64 * wg * kSwizzleRow;
  const uint32_t do_wg = base + L::kDo + 64 * wg * kSwizzleRow;
  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
  mbar_wait(bar_q, 0);

  for (int j = 0; j < n_tiles; ++j) {
    // refill the stage that tile j - 1 used: warpgroup 0 may run at most
    // one tile ahead of warpgroup 1, warpgroup 1 as far ahead as the ring
    if (stager && j + kDqStages - 1 < n_tiles) stage_tile(j + kDqStages - 1);
    const int s = j % kDqStages, t0 = j * kDqTileKeys;
    const uint32_t k_s = base + L::kK + 2 * s * L::kKVTile, v_s = k_s + L::kKVTile;
    mbar_wait(bar_f + 8 * s, (j / kDqStages) & 1);
    if (causal && t0 >= r0 + 64) {  // every key after every query row
      mbar_arrive(bar_e + 8 * s);
      continue;
    }
    float sc[kDqTileKeys / 2], dp[kDqTileKeys / 2];  // S = Q K^T, dP = dO V^T
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t off = (kk % 4) * 32;
      wgmma_ss_n64(sc, desc_kmajor(q_wg + (kk / 4) * L::kQHalf + off),
                   desc_kmajor(k_s + (kk / 4) * L::kKVHalf + off), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t off = (kk % 4) * 32;
      wgmma_ss_n64(dp, desc_kmajor(do_wg + (kk / 4) * L::kQHalf + off),
                   desc_kmajor(v_s + (kk / 4) * L::kKVHalf + off), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    settle(sc);
    settle(dp);

    // the causal compare and the key mask only on the diagonal, the ragged
    // edge and tiles with a masked key
    const bool need = need_s[s] != 0 || t0 + kDqTileKeys > skv ||
                      (causal && t0 + kDqTileKeys - 1 > r0);
    const uint8_t* mk = mask_s + s * kDqTileKeys;
#pragma unroll
    for (int i = 0; i < kDqTileKeys / 2; ++i) {
      const int col = 8 * (i >> 2) + 2 * tg + (i & 1), r = (i >> 1) & 1, key = t0 + col;
      bool valid = live[r];
      if (need)
        valid = valid && key < skv && (!causal || rows[r] >= key) &&
                (mask_b == nullptr || mk[col] != 0);
      const float p = valid ? ex2(fmaf(sc[i], c, -lse2[r])) : 0.f;
      sc[i] = p * (dp[i] - dl[r]) * scale;  // dS
    }
    uint32_t pd[kDqTileKeys / 4];
    pack_a<kDqTileKeys / 16>(pd, sc);  // dS rounded to K's dtype
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kDqTileKeys / 16; ++kk)  // dQ += dS K, K read MN-major
      wgmma_rs_hd<HD>(acc, pd, kk, k_s + kk * 16 * kSwizzleRow, L::kKVHalf);
    wgmma_commit();
    wgmma_wait_all();
    settle(acc);
    settle(pd);
    mbar_arrive(bar_e + 8 * s);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= sq) continue;
    bf16* row = dq + ((static_cast<int64_t>(b) * sq + rows[r]) * nh + h) * HD;
#pragma unroll
    for (int c8 = 0; c8 < HD / 8; ++c8)
      *reinterpret_cast<uint32_t*>(row + 8 * c8 + 2 * tg) =
          pack_bf16(acc[4 * c8 + 2 * r], acc[4 * c8 + 2 * r + 1]);
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

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

// setmaxnreg moves registers between the warpgroups of a block inside the
// pool the block was launched with, which the kernel's register count
// fixes. A pool smaller than the consumers' request would stall them
// forever: refuse to launch such a build. Once per kernel instance.
template <typename Kernel>
cudaError_t check_register_pool(Kernel kernel, bool& done) {
  if (done) return cudaSuccess;
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  if (attr.numRegs < kLaunchRegs) return cudaErrorLaunchOutOfResources;
  done = true;
  return cudaSuccess;
}

static_assert(kWgThreads * (kProducerRegs + 2 * kConsumerRegs) <= kFwdThreads * kLaunchRegs,
              "setmaxnreg requests exceed the block's register pool");
static_assert(kFwdThreads * kLaunchRegs <= 65536, "the launch bound's registers exceed an SM");

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver API function; the library links only
// the runtime, which hands out driver entry points.
EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found{};
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiledFn>(p)
               : nullptr;
  }();
  return fn;
}

// A 4-D TMA map over a bf16 [b, s, heads, hd] tensor, innermost first
// (hd, heads, s, b). A box is 64 columns (128 bytes, one swizzled row) by
// `rows` rows of one head; rows past the sequence's end load as zeros.
cudaError_t tma_map(CUtensorMap* map, const void* ptr, int hd, int heads, int s, int b, int rows) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(s), static_cast<cuuint64_t>(b)};
  const cuuint64_t row_bytes = static_cast<cuuint64_t>(hd) * 2;
  const cuuint64_t strides[3] = {row_bytes, row_bytes * heads, row_bytes * heads * s};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                            strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
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
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  cudaError_t err;
  if (dtype == 0) {
    static bool ready = false;
    constexpr int bytes = fwd_smem_bytes<HD>();
    if ((err = allow_smem(flash_fwd_kernel<HD>, bytes, ready)) != cudaSuccess) return err;
    const dim3 grid((a.sq + kBlock - 1) / kBlock, a.nh, a.b);
    flash_fwd_kernel<HD><<<grid, kThreads, bytes, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        m, static_cast<float*>(o), lse, a.sq, a.skv, a.nh, a.n_kv, a.scale, a.causal);
  } else {
    static bool ready = false, pool = false;
    constexpr int bytes = FwdSmem<HD>::kBytes;
    CUtensorMap q_map, k_map, v_map;
    if ((err = tma_map(&q_map, q, HD, a.nh, a.sq, a.b, kFwdRows)) != cudaSuccess ||
        (err = tma_map(&k_map, k, HD, a.n_kv, a.skv, a.b, kFwdTileKeys)) != cudaSuccess ||
        (err = tma_map(&v_map, v, HD, a.n_kv, a.skv, a.b, kFwdTileKeys)) != cudaSuccess ||
        (err = allow_smem(flash_fwd_wgmma_kernel<HD>, bytes, ready)) != cudaSuccess ||
        (err = check_register_pool(flash_fwd_wgmma_kernel<HD>, pool)) != cudaSuccess)
      return err;
    const dim3 grid(a.nh, a.b, (a.sq + kFwdRows - 1) / kFwdRows);
    flash_fwd_wgmma_kernel<HD><<<grid, kFwdThreads, bytes, stream>>>(
        q_map, k_map, v_map, m, static_cast<bf16*>(o), lse, a.sq, a.skv, a.nh, a.n_kv, a.scale,
        a.causal);
  }
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* mask,
                      const void* dout, const float* lse, const float* delta, void* dq,
                      const Shape& a, int dtype, cudaStream_t stream) {
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  cudaError_t err;
  if (dtype == 0) {
    static bool ready = false;
    constexpr int bytes = dq_smem_bytes<HD>();
    if ((err = allow_smem(flash_bwd_dq_kernel<HD>, bytes, ready)) != cudaSuccess)
      return err;
    const dim3 grid((a.sq + kBlock - 1) / kBlock, a.nh, a.b);
    flash_bwd_dq_kernel<HD><<<grid, kThreads, bytes, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        m, static_cast<const float*>(dout), lse, delta, static_cast<float*>(dq), a.sq, a.skv,
        a.nh, a.n_kv, a.scale, a.causal);
  } else {
    static bool ready = false;
    constexpr int bytes = DqSmem<HD>::kBytes;
    CUtensorMap q_map, k_map, v_map, do_map;
    if ((err = tma_map(&q_map, q, HD, a.nh, a.sq, a.b, kDqRows)) != cudaSuccess ||
        (err = tma_map(&do_map, dout, HD, a.nh, a.sq, a.b, kDqRows)) != cudaSuccess ||
        (err = tma_map(&k_map, k, HD, a.n_kv, a.skv, a.b, kDqTileKeys)) != cudaSuccess ||
        (err = tma_map(&v_map, v, HD, a.n_kv, a.skv, a.b, kDqTileKeys)) != cudaSuccess ||
        (err = allow_smem(flash_bwd_dq_wgmma_kernel<HD>, bytes, ready)) != cudaSuccess)
      return err;
    const dim3 grid(a.nh, a.b, (a.sq + kDqRows - 1) / kDqRows);
    flash_bwd_dq_wgmma_kernel<HD><<<grid, kDqThreads, bytes, stream>>>(
        q_map, k_map, v_map, do_map, m, lse, delta, static_cast<bf16*>(dq), a.sq, a.skv, a.nh,
        a.n_kv, a.scale, a.causal);
  }
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* mask,
                       const void* dout, const float* lse, const float* delta, void* dk,
                       void* dv, const Shape& a, int dtype, cudaStream_t stream) {
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  cudaError_t err;
  if (dtype == 0) {
    static bool ready = false;
    constexpr int bytes = dkv_smem_bytes<HD>();
    if ((err = allow_smem(flash_bwd_dkv_kernel<HD>, bytes, ready)) != cudaSuccess)
      return err;
    const dim3 grid((a.skv + kBlock - 1) / kBlock, a.n_kv, a.b);
    flash_bwd_dkv_kernel<HD><<<grid, kThreads, bytes, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        m, static_cast<const float*>(dout), lse, delta, static_cast<float*>(dk),
        static_cast<float*>(dv), a.sq, a.skv, a.nh, a.n_kv, a.scale, a.causal);
  } else {
    static bool ready = false;
    constexpr int bytes = DkvSmem<HD>::kBytes;
    CUtensorMap q_map, k_map, v_map, do_map;
    if ((err = tma_map(&q_map, q, HD, a.nh, a.sq, a.b, kDkvQRows)) != cudaSuccess ||
        (err = tma_map(&do_map, dout, HD, a.nh, a.sq, a.b, kDkvQRows)) != cudaSuccess ||
        (err = tma_map(&k_map, k, HD, a.n_kv, a.skv, a.b, kDkvKeys)) != cudaSuccess ||
        (err = tma_map(&v_map, v, HD, a.n_kv, a.skv, a.b, kDkvKeys)) != cudaSuccess ||
        (err = allow_smem(flash_bwd_dkv_wgmma_kernel<HD>, bytes, ready)) != cudaSuccess)
      return err;
    const dim3 grid(a.n_kv, a.b, (a.skv + kDkvKeys - 1) / kDkvKeys);
    flash_bwd_dkv_wgmma_kernel<HD><<<grid, kDkvThreads, bytes, stream>>>(
        q_map, k_map, v_map, do_map, m, lse, delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv),
        a.sq, a.skv, a.nh, a.n_kv, a.scale, a.causal);
  }
  return cudaGetLastError();
}

bool valid_shape(const Shape& a, int hd, int dtype) {
  return a.b >= 1 && a.sq >= 1 && a.skv >= 1 && a.n_kv >= 1 && a.nh >= a.n_kv &&
         a.nh % a.n_kv == 0 && (hd == 64 || hd == 128) && (dtype == 0 || dtype == 1) &&
         a.b <= 65535 && a.nh <= 65535;
}

// Resident blocks an SM holds of a kernel launched with `threads` threads
// and `bytes` of dynamic shared memory, by the runtime's occupancy
// calculator for this device.
template <typename Kernel>
cudaError_t occupancy(Kernel kernel, int threads, int bytes, int* blocks) {
  bool ready = false;
  const cudaError_t err = allow_smem(kernel, bytes, ready);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, threads, bytes);
}

template <int HD>
cudaError_t wgmma_blocks_per_sm(int which, int* blocks) {
  switch (which) {
    case 0: return occupancy(flash_fwd_wgmma_kernel<HD>, kFwdThreads, FwdSmem<HD>::kBytes, blocks);
    case 1:
      return occupancy(flash_bwd_dq_wgmma_kernel<HD>, kDqThreads, DqSmem<HD>::kBytes, blocks);
    case 2:
      return occupancy(flash_bwd_dkv_wgmma_kernel<HD>, kDkvThreads, DkvSmem<HD>::kBytes, blocks);
    default: return cudaErrorInvalidValue;
  }
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

// Resident blocks an SM holds of the bf16 kernel `which` (0 forward, 1 dq,
// 2 dk/dv) at head dim hd, with the threads and shared memory it launches with.
extern "C" int flash_attention_blocks_per_sm(int which, int hd, int* blocks) {
  (void)cudaGetLastError();
  if (hd != 64 && hd != 128) return cudaErrorInvalidValue;
  return hd == 64 ? wgmma_blocks_per_sm<64>(which, blocks)
                  : wgmma_blocks_per_sm<128>(which, blocks);
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
