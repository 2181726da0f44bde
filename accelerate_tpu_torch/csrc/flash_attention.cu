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
// Inputs are f32, bf16 or f16 (f16 under fp16 mixed precision: the JAX
// kernels run in q's dtype, so they take all three); one templated source
// path serves both 16-bit types, which differ only in the rounding helpers,
// the wgmma operand type (.bf16 / .f16) and the TMA element type.
// Tensors are read in the model layout [b, s, heads, hd] (contiguous) by
// strides: no transposed or padded copies. Every kernel takes any head dim
// hd that is a multiple of 8 (the Python wrapper zero-pads any other head
// dim to the next multiple of 8 and slices the outputs back). Up to 128
// each family is built at the eight multiples of 16 (HD, hd rounded up to
// 16; the columns between hd and HD load as zeros and are never stored);
// from 136 to 256 bf16 and f16 take the tensor-core instances at HD 256,
// and f32 the wide FMA instances at HD 256; past 256 every dtype takes the
// column-block FMA instance (kCols).
// Pitches and stores use hd.
// The optional key mask is [b, skv] bytes (1 = valid) and applies
// where(valid, s, NEG_INF), equal to the JAX "s + bias" after rounding
// because NEG_INF is the f32 minimum.
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
//    version agree in bf16 and f16: P is rounded to the value dtype before
//    P V, P to dO's dtype before P^T dO, dS to K's / Q's dtype before dS K
//    and dS^T Q. Every accumulator is f32. In f16 a loss-scaled dS past
//    65504 rounds to inf there, as JAX's astype does, so the loss scaler
//    sees the overflow JAX sees.
// The families:
//  * f32 inputs run every product on the FMA units (67 TFLOP/s peak), with
//    no TF32, so they meet the JAX gates (2e-5) against the plain version:
//    64-row tiles, 256 threads form a 16 x 16 grid over a 64 x 64 score
//    tile, tiles staged as f32 with rows padded by one float; expf, logf.
//  * Head dims 136-256 in f32 (C4b): the same FMA kernels with 32-row tiles
//    at HD 256 (a 64-row tile of 256 f32 columns is 64 KB, and dq's and
//    dk/dv's four of them exceed the 227 KB of shared memory).
//  * Head dims past 256, f32, bf16 or f16 (C4c): the wide kernels at kCols,
//    bf16 and f16 widened to f32 as they are staged and rounded where the
//    TPU kernels round. The
//    head dim is cut into column blocks of 256 and a block owns one column
//    block of its output, folded into grid x. S = Q K^T (and dP = dO V^T)
//    need every column: the block stages 256-column chunks of Q and K (dO
//    and V) in turn and adds each chunk's product into the score tile.
//    O = P V, dQ = dS K, dK = dS^T Q and dV = P^T dO need only the block's
//    own column block. Each column block recomputes the same scores, in
//    the same order, so about ceil(hd / 256) times the Q K^T work; lse is
//    written by column block 0. delta (rowsum(dO * O) over the whole head
//    dim) comes from the caller as before.
//  * bf16 and f16 forward (B1), dq (B2) and dk/dv (B3): wgmma fed by a ring
//    of TMA copies with mbarriers, two warpgroups of products (section "bf16
//    forward (B1), dq (B2) and dk/dv (B3) for Hopper"; each kernel is a
//    template over the 16-bit type), up to hd 256.
//    B1 takes 128 query rows a block, with a producer warp in a third
//    warpgroup, and streams K/V tiles of 128 keys through three stages, so
//    the next tiles' loads overlap this tile's products; it applies the
//    causal compare and the key mask only on the tiles that need them (the
//    diagonal, the ragged edge, masked keys) and launches the heaviest
//    causal query tiles first. At hd 136-256 it stages 256 columns in four
//    64-column quarters, drops the producer warpgroup (warp 0 refills the
//    ring, as in B2) and streams 64-key tiles through two stages; P V is
//    one m64n256 wgmma a 16-key step. B3 takes 128 keys a block, loads K and V
//    once and streams tiles of 64 query rows (Q, dO, lse, delta) through
//    three stages; its four products per tile are wgmmas, P^T and dS^T never
//    leave registers, and it masks only the diagonal and masked keys. At hd
//    136-256 two 64 x 256 accumulators (dK and dV) would not fit a thread's
//    255 registers: the block owns 64 keys, warpgroup 0 forms P^T and
//    accumulates dV, warpgroup 1 forms dS^T and accumulates dK, and P^T
//    passes between them through shared memory under two named barriers;
//    Q and dO stream through two stages (DkvTiling). B2
//    takes 128 query rows a block, loads Q and dO once and streams K/V
//    tiles of 64 keys (with their mask bytes) through four stages; S and dP
//    are SS wgmmas, dS stays in registers as the A operand of dS K against
//    the same K tile read MN-major; it masks as B1 does and launches the
//    heaviest causal query tiles first. At hd 136-256 its tiles are 32 keys
//    through three stages (Q and dO take 128 KB), dS K one m64n256 wgmma a
//    16-key step. exp is ex2.approx with
//    scale * log2(e) folded in; lse stays a natural log.

#include <algorithm>
#include <cfloat>
#include <cstdint>
#include <type_traits>

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 64;       // query rows and keys per tile, FMA kernels up to hd 128
constexpr int kWideBlock = 32;   // the same for the wide FMA kernels (hd 136 to 256)
constexpr int kWideHD = 256;     // the one staged width of the wide kernels
constexpr int kThreads = 256;
constexpr int kGrid = 16;        // threads form a kGrid x kGrid square
constexpr float kNegInf = -FLT_MAX;
constexpr unsigned kFull = 0xffffffffu;

using bf16 = __nv_bfloat16;
using f16 = __half;

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

// An f32 value stored as T, and rounded to T's precision (round to nearest
// even, as PyTorch's .to(torch.bfloat16) and .to(torch.float16); an f16
// past 65504 becomes inf, as JAX's astype makes it); identities for f32.
template <typename T>
__device__ __forceinline__ T from_f32(float x) {
  if constexpr (std::is_same_v<T, bf16>) return __float2bfloat16_rn(x);
  else if constexpr (std::is_same_v<T, f16>) return __float2half_rn(x);
  else return x;
}

template <typename T>
__device__ __forceinline__ float to_f32(T x) {
  if constexpr (std::is_same_v<T, bf16>) return __bfloat162float(x);
  else if constexpr (std::is_same_v<T, f16>) return __half2float(x);
  else return x;
}

template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32<T>(from_f32<T>(x));
}

// Stage rows [row0, row0 + BLK) of one head of a [b, s, heads, hd] tensor
// (f32, bf16 or f16) into dst as f32 (HD columns, row stride HD + 1), one
// 16-byte load a thread at a time. `src` points at (b, row 0, head, 0),
// `pitch` = heads * hd; rows >= n_rows and columns >= hd (a multiple of 8)
// are zero.
template <int HD, int BLK, typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          int64_t pitch, int row0, int n_rows, int hd) {
  constexpr int kV = 16 / static_cast<int>(sizeof(T));
  constexpr int kVecs = HD / kV;
  constexpr int kStride = HD + 1;
  for (int e = threadIdx.x; e < BLK * kVecs; e += kThreads) {
    const int r = e / kVecs, c = (e % kVecs) * kV;
    const int row = row0 + r;
    float* d = dst + r * kStride + c;
    if constexpr (std::is_same_v<T, float>) {
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (row < n_rows && c < hd) x = __ldg(reinterpret_cast<const float4*>(src + row * pitch + c));
      d[0] = x.x;
      d[1] = x.y;
      d[2] = x.z;
      d[3] = x.w;
    } else {
      uint4 x = make_uint4(0u, 0u, 0u, 0u);
      if (row < n_rows && c < hd) x = __ldg(reinterpret_cast<const uint4*>(src + row * pitch + c));
      const T* h = reinterpret_cast<const T*>(&x);
#pragma unroll
      for (int i = 0; i < kV; ++i) d[i] = to_f32<T>(h[i]);
    }
  }
}

// acc[i][j] += sum_d a[row i][d] * b[col j][d] over a BLK x BLK tile:
// thread (ty, tx) owns rows ty + 16 i and columns tx + 16 j.
template <int HD, int BLK>
__device__ __forceinline__ void tile_dot(float (&acc)[BLK / kGrid][BLK / kGrid], const float* a,
                                         const float* b, int ty, int tx) {
  constexpr int kStride = HD + 1;
  constexpr int kR = BLK / kGrid;
#pragma unroll 8
  for (int d = 0; d < HD; ++d) {
    float av[kR], bv[kR];
#pragma unroll
    for (int i = 0; i < kR; ++i) av[i] = a[(ty + kGrid * i) * kStride + d];
#pragma unroll
    for (int j = 0; j < kR; ++j) bv[j] = b[(tx + kGrid * j) * kStride + d];
#pragma unroll
    for (int i = 0; i < kR; ++i)
#pragma unroll
      for (int j = 0; j < kR; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// out[i][c] += sum_t p[row i][t] * x[t][tx + 16 c]: a BLK x BLK staged score
// tile times a BLK x HD staged value tile.
template <int HD, int BLK>
__device__ __forceinline__ void tile_pv(float (&out)[BLK / kGrid][HD / kGrid], const float* p,
                                        const float* x, int ty, int tx) {
  constexpr int kStride = HD + 1;
  constexpr int kSStride = BLK + 1;
  constexpr int kD = HD / kGrid;
  constexpr int kR = BLK / kGrid;
#pragma unroll 4
  for (int t = 0; t < BLK; ++t) {
    float xv[kD];
#pragma unroll
    for (int c = 0; c < kD; ++c) xv[c] = x[t * kStride + tx + kGrid * c];
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      const float pv = p[(ty + kGrid * i) * kSStride + t];
#pragma unroll
      for (int c = 0; c < kD; ++c) out[i][c] = fmaf(pv, xv[c], out[i][c]);
    }
  }
}

__device__ __forceinline__ bool key_valid(const uint8_t* __restrict__ mask_b, int key, int skv) {
  return key < skv && (mask_b == nullptr || mask_b[key] != 0);
}

// The FMA kernels, at (HD, BLK, T) = (16..128, 64, f32) for f32 inputs up to
// hd 128, (256, 32, f32) for f32 from 136 to 256 and (256, 32, f32, bf16 or
// f16) in column blocks for every input past 256. Inputs are
// staged as f32, every product runs on the FMA units in f32, and a bf16 or
// f16 instance rounds where the TPU kernels round: P to V's dtype before P V
// (forward), dS to K's dtype before dS K (dq), P to dO's and dS to Q's
// dtype before P^T dO and dS^T Q (dk/dv); outputs are stored in T.
template <int HD, int BLK, typename T, bool kCols>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const uint8_t* __restrict__ mask, T* __restrict__ o, float* __restrict__ lse,
                 int sq, int skv, int nh, int n_kv, int hd, float scale, int causal) {
  constexpr int kStride = HD + 1;
  constexpr int kSStride = BLK + 1;
  constexpr int kD = HD / kGrid;
  constexpr int kR = BLK / kGrid;
  extern __shared__ float smem[];
  float* q_s = smem;
  float* k_s = q_s + BLK * kStride;
  float* v_s = k_s + BLK * kStride;
  float* p_s = v_s + BLK * kStride;

  // kCols: the block owns column block cb (columns c_lo .. c_lo + HD) of O
  const int n_cb = kCols ? (hd + HD - 1) / HD : 1;
  const int cb = kCols ? blockIdx.x % n_cb : 0;
  const int c_lo = cb * HD;
  const int q0 = (kCols ? blockIdx.x / n_cb : blockIdx.x) * BLK, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (nh / n_kv);
  const int ty = threadIdx.x / kGrid, tx = threadIdx.x % kGrid;
  const int64_t q_pitch = static_cast<int64_t>(nh) * hd;
  const int64_t kv_pitch = static_cast<int64_t>(n_kv) * hd;
  const T* q_bh = q + (static_cast<int64_t>(b) * sq * nh + h) * hd;
  const T* k_bg = k + (static_cast<int64_t>(b) * skv * n_kv + g) * hd;
  const T* v_bg = v + (static_cast<int64_t>(b) * skv * n_kv + g) * hd;
  const uint8_t* mask_b = mask == nullptr ? nullptr : mask + static_cast<int64_t>(b) * skv;

  if constexpr (!kCols) load_tile<HD, BLK>(q_s, q_bh, q_pitch, q0, sq, hd);
  float m[kR], l[kR], acc[kR][kD];
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kD; ++c) acc[i][c] = 0.f;
  }

  // causal: key tiles wholly above the diagonal are skipped
  const int kv_end = causal ? min(skv, q0 + BLK) : skv;
  for (int t0 = 0; t0 < kv_end; t0 += BLK) {
    float s[kR][kR] = {};
    if constexpr (kCols) {
      // S needs every column: add it up over the column chunks of Q and K;
      // P V needs only this block's column block of V
      for (int c0 = 0; c0 < hd; c0 += HD) {
        __syncthreads();  // the previous chunk (and tile) is consumed
        load_tile<HD, BLK>(q_s, q_bh + c0, q_pitch, q0, sq, hd - c0);
        load_tile<HD, BLK>(k_s, k_bg + c0, kv_pitch, t0, skv, hd - c0);
        if (c0 == 0) load_tile<HD, BLK>(v_s, v_bg + c_lo, kv_pitch, t0, skv, hd - c_lo);
        __syncthreads();
        tile_dot<HD, BLK>(s, q_s, k_s, ty, tx);
      }
    } else {
      __syncthreads();  // the previous tile is consumed (and q_s written)
      load_tile<HD, BLK>(k_s, k_bg, kv_pitch, t0, skv, hd);
      load_tile<HD, BLK>(v_s, v_bg, kv_pitch, t0, skv, hd);
      __syncthreads();
      tile_dot<HD, BLK>(s, q_s, k_s, ty, tx);
    }
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      const int qi = q0 + ty + kGrid * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kR; ++j) {
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
      for (int j = 0; j < kR; ++j) {
        const float p = m_new == kNegInf ? 0.f : expf(s[i][j] - m_new);
        sum += p;
        p_s[(ty + kGrid * i) * kSStride + tx + kGrid * j] = round_to<T>(p);
      }
      const float alpha = expf(m[i] - m_new);
      l[i] = alpha * l[i] + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kD; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();
    tile_pv<HD, BLK>(acc, p_s, v_s, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int qi = q0 + ty + kGrid * i;
    if (qi >= sq) continue;
    const bool empty = l[i] == 0.f;
    const float den = empty ? 1.f : l[i];
    T* o_row = o + ((static_cast<int64_t>(b) * sq + qi) * nh + h) * hd + c_lo;
#pragma unroll
    for (int c = 0; c < kD; ++c)
      if (c_lo + tx + kGrid * c < hd) o_row[tx + kGrid * c] = from_f32<T>(acc[i][c] / den);
    // every column block computes the same row statistics: block 0 writes them
    if (tx == 0 && cb == 0)
      lse[(static_cast<int64_t>(b) * nh + h) * sq + qi] = empty ? kNegInf : m[i] + logf(den);
  }
}

template <int HD, int BLK, typename T, bool kCols>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const uint8_t* __restrict__ mask, const T* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    T* __restrict__ dq, int sq, int skv, int nh, int n_kv, int hd,
                    float scale, int causal) {
  constexpr int kStride = HD + 1;
  constexpr int kSStride = BLK + 1;
  constexpr int kD = HD / kGrid;
  constexpr int kR = BLK / kGrid;
  extern __shared__ float smem[];
  float* q_s = smem;
  float* do_s = q_s + BLK * kStride;
  float* k_s = do_s + BLK * kStride;
  float* v_s = k_s + BLK * kStride;
  float* ds_s = v_s + BLK * kStride;

  // kCols: the block owns column block cb (columns c_lo .. c_lo + HD) of dQ
  const int n_cb = kCols ? (hd + HD - 1) / HD : 1;
  const int cb = kCols ? blockIdx.x % n_cb : 0;
  const int c_lo = cb * HD;
  const int q0 = (kCols ? blockIdx.x / n_cb : blockIdx.x) * BLK, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (nh / n_kv);
  const int ty = threadIdx.x / kGrid, tx = threadIdx.x % kGrid;
  const int64_t q_pitch = static_cast<int64_t>(nh) * hd;
  const int64_t kv_pitch = static_cast<int64_t>(n_kv) * hd;
  const int64_t q_off = (static_cast<int64_t>(b) * sq * nh + h) * hd;
  const int64_t kv_off = (static_cast<int64_t>(b) * skv * n_kv + g) * hd;
  const int64_t row_off = (static_cast<int64_t>(b) * nh + h) * sq;
  const uint8_t* mask_b = mask == nullptr ? nullptr : mask + static_cast<int64_t>(b) * skv;

  if constexpr (!kCols) {
    load_tile<HD, BLK>(q_s, q + q_off, q_pitch, q0, sq, hd);
    load_tile<HD, BLK>(do_s, dout + q_off, q_pitch, q0, sq, hd);
  }
  float lse_r[kR], delta_r[kR], acc[kR][kD];
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int qi = q0 + ty + kGrid * i;
    lse_r[i] = qi < sq ? lse[row_off + qi] : kNegInf;
    delta_r[i] = qi < sq ? delta[row_off + qi] : 0.f;
#pragma unroll
    for (int c = 0; c < kD; ++c) acc[i][c] = 0.f;
  }

  const int kv_end = causal ? min(skv, q0 + BLK) : skv;
  for (int t0 = 0; t0 < kv_end; t0 += BLK) {
    float s[kR][kR] = {}, dp[kR][kR] = {};
    if constexpr (kCols) {
      // S = Q K^T and dP = dO V^T need every column: add them up over the
      // column chunks; dS K needs only K's column block cb
      for (int c0 = 0; c0 < hd; c0 += HD) {
        __syncthreads();
        load_tile<HD, BLK>(q_s, q + q_off + c0, q_pitch, q0, sq, hd - c0);
        load_tile<HD, BLK>(do_s, dout + q_off + c0, q_pitch, q0, sq, hd - c0);
        load_tile<HD, BLK>(k_s, k + kv_off + c0, kv_pitch, t0, skv, hd - c0);
        load_tile<HD, BLK>(v_s, v + kv_off + c0, kv_pitch, t0, skv, hd - c0);
        __syncthreads();
        tile_dot<HD, BLK>(s, q_s, k_s, ty, tx);
        tile_dot<HD, BLK>(dp, do_s, v_s, ty, tx);
      }
      if (cb != n_cb - 1) {  // k_s holds the last column chunk
        __syncthreads();
        load_tile<HD, BLK>(k_s, k + kv_off + c_lo, kv_pitch, t0, skv, hd - c_lo);
      }
    } else {
      __syncthreads();
      load_tile<HD, BLK>(k_s, k + kv_off, kv_pitch, t0, skv, hd);
      load_tile<HD, BLK>(v_s, v + kv_off, kv_pitch, t0, skv, hd);
      __syncthreads();
      tile_dot<HD, BLK>(s, q_s, k_s, ty, tx);
      tile_dot<HD, BLK>(dp, do_s, v_s, ty, tx);
    }
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      const int qi = q0 + ty + kGrid * i;
#pragma unroll
      for (int j = 0; j < kR; ++j) {
        const int kj = t0 + tx + kGrid * j;
        const bool valid = key_valid(mask_b, kj, skv) && (!causal || qi >= kj);
        const float sc = valid ? s[i][j] * scale : kNegInf;
        // a fully masked row has lse == NEG_INF and must give p = 0
        const float p = lse_r[i] == kNegInf ? 0.f : expf(sc - lse_r[i]);
        const float ds = p * (dp[i][j] - delta_r[i]) * scale;
        ds_s[(ty + kGrid * i) * kSStride + tx + kGrid * j] = round_to<T>(ds);
      }
    }
    __syncthreads();
    tile_pv<HD, BLK>(acc, ds_s, k_s, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int qi = q0 + ty + kGrid * i;
    if (qi >= sq) continue;
    T* row = dq + ((static_cast<int64_t>(b) * sq + qi) * nh + h) * hd + c_lo;
#pragma unroll
    for (int c = 0; c < kD; ++c)
      if (c_lo + tx + kGrid * c < hd) row[tx + kGrid * c] = from_f32<T>(acc[i][c]);
  }
}

template <int HD, int BLK, typename T, bool kCols>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const uint8_t* __restrict__ mask, const T* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     T* __restrict__ dk, T* __restrict__ dv, int sq, int skv, int nh, int n_kv,
                     int hd, float scale, int causal) {
  constexpr int kStride = HD + 1;
  constexpr int kSStride = BLK + 1;
  constexpr int kD = HD / kGrid;
  constexpr int kR = BLK / kGrid;
  extern __shared__ float smem[];
  float* k_s = smem;
  float* v_s = k_s + BLK * kStride;
  float* q_s = v_s + BLK * kStride;
  float* do_s = q_s + BLK * kStride;
  float* p_s = do_s + BLK * kStride;
  float* ds_s = p_s + BLK * kSStride;
  float* lse_s = ds_s + BLK * kSStride;
  float* delta_s = lse_s + BLK;

  // kCols: the block owns column block cb (columns c_lo .. c_lo + HD) of dK, dV
  const int n_cb = kCols ? (hd + HD - 1) / HD : 1;
  const int cb = kCols ? blockIdx.x % n_cb : 0;
  const int c_lo = cb * HD;
  const int k0 = (kCols ? blockIdx.x / n_cb : blockIdx.x) * BLK, g = blockIdx.y, b = blockIdx.z;
  const int rep = nh / n_kv;
  const int ty = threadIdx.x / kGrid, tx = threadIdx.x % kGrid;
  const int64_t q_pitch = static_cast<int64_t>(nh) * hd;
  const int64_t kv_pitch = static_cast<int64_t>(n_kv) * hd;
  const int64_t kv_off = (static_cast<int64_t>(b) * skv * n_kv + g) * hd;
  const uint8_t* mask_b = mask == nullptr ? nullptr : mask + static_cast<int64_t>(b) * skv;

  if constexpr (!kCols) {
    load_tile<HD, BLK>(k_s, k + kv_off, kv_pitch, k0, skv, hd);
    load_tile<HD, BLK>(v_s, v + kv_off, kv_pitch, k0, skv, hd);
  }
  bool key_ok[kR];
  float dk_acc[kR][kD], dv_acc[kR][kD];
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    key_ok[i] = key_valid(mask_b, k0 + ty + kGrid * i, skv);
#pragma unroll
    for (int c = 0; c < kD; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;
  }

  // causal: query tiles wholly before this key tile see none of its keys
  const int q_start = causal ? (k0 / BLK) * BLK : 0;
  for (int r = 0; r < rep; ++r) {
    const int h = g * rep + r;
    const int64_t q_off = (static_cast<int64_t>(b) * sq * nh + h) * hd;
    const int64_t row_off = (static_cast<int64_t>(b) * nh + h) * sq;
    for (int q0 = q_start; q0 < sq; q0 += BLK) {
      // transposed score tiles: row = key (ty + 16 i), column = query (tx + 16 j)
      float s[kR][kR] = {}, dp[kR][kR] = {};
      if constexpr (kCols) {
        // S and dP need every column: add them up over the column chunks;
        // P^T dO and dS^T Q need only column block cb of dO and Q
        for (int c0 = 0; c0 < hd; c0 += HD) {
          __syncthreads();  // the previous chunk (and query tile) is consumed
          load_tile<HD, BLK>(k_s, k + kv_off + c0, kv_pitch, k0, skv, hd - c0);
          load_tile<HD, BLK>(v_s, v + kv_off + c0, kv_pitch, k0, skv, hd - c0);
          load_tile<HD, BLK>(q_s, q + q_off + c0, q_pitch, q0, sq, hd - c0);
          load_tile<HD, BLK>(do_s, dout + q_off + c0, q_pitch, q0, sq, hd - c0);
          if (c0 == 0 && threadIdx.x < BLK) {
            const int qi = q0 + threadIdx.x;
            lse_s[threadIdx.x] = qi < sq ? lse[row_off + qi] : kNegInf;  // padded rows: p = 0
            delta_s[threadIdx.x] = qi < sq ? delta[row_off + qi] : 0.f;
          }
          __syncthreads();
          tile_dot<HD, BLK>(s, k_s, q_s, ty, tx);
          tile_dot<HD, BLK>(dp, v_s, do_s, ty, tx);
        }
        if (cb != n_cb - 1) {  // q_s and do_s hold the last column chunk
          __syncthreads();
          load_tile<HD, BLK>(q_s, q + q_off + c_lo, q_pitch, q0, sq, hd - c_lo);
          load_tile<HD, BLK>(do_s, dout + q_off + c_lo, q_pitch, q0, sq, hd - c_lo);
        }
      } else {
        __syncthreads();  // the previous query tile is consumed
        load_tile<HD, BLK>(q_s, q + q_off, q_pitch, q0, sq, hd);
        load_tile<HD, BLK>(do_s, dout + q_off, q_pitch, q0, sq, hd);
        if (threadIdx.x < BLK) {
          const int qi = q0 + threadIdx.x;
          lse_s[threadIdx.x] = qi < sq ? lse[row_off + qi] : kNegInf;  // padded rows: p = 0
          delta_s[threadIdx.x] = qi < sq ? delta[row_off + qi] : 0.f;
        }
        __syncthreads();
        tile_dot<HD, BLK>(s, k_s, q_s, ty, tx);
        tile_dot<HD, BLK>(dp, v_s, do_s, ty, tx);
      }
#pragma unroll
      for (int i = 0; i < kR; ++i) {
        const int kj = k0 + ty + kGrid * i;
#pragma unroll
        for (int j = 0; j < kR; ++j) {
          const int col = tx + kGrid * j;
          const int qi = q0 + col;
          const bool valid = key_ok[i] && (!causal || qi >= kj);
          const float sc = valid ? s[i][j] * scale : kNegInf;
          const float lq = lse_s[col];
          const float p = lq == kNegInf ? 0.f : expf(sc - lq);
          const float ds = p * (dp[i][j] - delta_s[col]) * scale;
          p_s[(ty + kGrid * i) * kSStride + col] = round_to<T>(p);
          ds_s[(ty + kGrid * i) * kSStride + col] = round_to<T>(ds);
        }
      }
      __syncthreads();
      tile_pv<HD, BLK>(dv_acc, p_s, do_s, ty, tx);
      tile_pv<HD, BLK>(dk_acc, ds_s, q_s, ty, tx);
    }
  }

#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int kj = k0 + ty + kGrid * i;
    if (kj >= skv) continue;
    const int64_t row = ((static_cast<int64_t>(b) * skv + kj) * n_kv + g) * hd + c_lo;
#pragma unroll
    for (int c = 0; c < kD; ++c) {
      if (c_lo + tx + kGrid * c >= hd) continue;
      dk[row + tx + kGrid * c] = from_f32<T>(dk_acc[i][c]);
      dv[row + tx + kGrid * c] = from_f32<T>(dv_acc[i][c]);
    }
  }
}

// ---------------------------------------------------------------------------
// 16-bit helpers shared by the tensor-core kernels
// ---------------------------------------------------------------------------

// two f32 values rounded to T (bf16 or f16), the lower column in the low half
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (std::is_same_v<T, bf16>) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  } else {
    static_assert(std::is_same_v<T, f16>, "pack2 takes bf16 or f16");
    const __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
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
//  * At HDT 256 B1 takes B2's shape too, and both stream narrower key
//    tiles (FwdTiling, DqTiling); B3 splits its warpgroups by role over 64
//    keys (DkvTiling).
//
// Operand tiles live in shared memory exactly as TMA writes them with the
// 128-byte swizzle: rows of 64 bf16 or f16 (128 bytes), a head of 128 split into
// two such halves, each half 1024-byte aligned; a head dim up to 64 is staged
// as one zero-padded half, one past 64 as two, one past 128 as four
// (staged_hd). A wgmma descriptor reads
// them K-major (a 16-wide K step is 32 bytes into the row, walking across
// the halves) or MN-major (a 16-row K step is 2048 bytes on, each next 64
// columns of the MN extent one half-tile on). Tensor maps are 4-D over
// (hd, heads, s, b), so TMA's zero fill stops at each sequence's own end.
//
// Score accumulators stay in registers: the wgmma accumulator layout of a
// 64 x 16 slice is the register A layout of the next wgmma, so P (forward)
// P^T, dS^T (dk/dv) and dS (dq) are rounded to bf16 or f16 where the TPU
// kernels round them and fed to register-A wgmmas against V, dO, Q and K.
// ---------------------------------------------------------------------------

constexpr int kWgThreads = 128;                  // one warpgroup
constexpr int kFwdThreads = 3 * kWgThreads;      // two consumer warpgroups + the producer's
constexpr int kSwizzleRow = 128;                 // bytes of a swizzled row: 64 bf16
constexpr int kFwdRows = 128;                    // query rows of a forward block
constexpr int kFwdTileKeys = 128;                // keys per forward tile to hd 128 (= the plain's)
constexpr int kWideFwdTileKeys = 64;             // the same from hd 136 to 256
constexpr int kDkvKeys = 128;                    // keys of a dk/dv block to hd 128
constexpr int kWideDkvKeys = 64;                 // the same from hd 136 to 256
constexpr int kDkvQRows = 64;                    // query rows per dk/dv tile (the wgmma N)
constexpr int kDkvThreads = 2 * kWgThreads;      // two warpgroups, no producer warpgroup
constexpr int kDqRows = 128;                     // query rows of a dq block
constexpr int kDqTileKeys = 64;                  // keys per dq tile (S's, dP's wgmma N) to hd 128
constexpr int kWideDqTileKeys = 32;              // the same from hd 136 to 256
constexpr int kDqThreads = 2 * kWgThreads;       // two warpgroups, as B3
constexpr int kSmemOptIn = 232448;               // the 227 KB a block may opt into

// B1's and B2's key tiles at a staged width (HDT, below). Up to 128, B1
// keeps a producer warpgroup and streams 128-key tiles through 3 stages; B2
// streams 64-key tiles through 4. At 256 (head dims 136-256) a 64 x 256 f32
// accumulator (O, dQ) is 128 registers a thread, past the 168 a 384-thread
// block leaves (see below), so B1 takes B2's shape: two warpgroups, warp 0
// refilling the ring, 64-key tiles through 2 stages (Q 64 KB, K and V 64 KB
// a stage); B2 takes 32-key tiles through 3 (Q and dO 128 KB, K and V 32 KB
// a stage).
template <int HDT>
struct FwdTiling {
  static constexpr bool kStager = HDT == 256;  // warp 0 stages; no producer warpgroup
  static constexpr int kKeys = HDT == 256 ? kWideFwdTileKeys : kFwdTileKeys;
  static constexpr int kStages = HDT == 256 ? 2 : 3;
  static constexpr int kThreads = kStager ? 2 * kWgThreads : kFwdThreads;
};

template <int HDT>
struct DqTiling {
  static constexpr int kKeys = HDT == 256 ? kWideDqTileKeys : kDqTileKeys;
  static constexpr int kStages = HDT == 256 ? 3 : 4;
};

// B3's block at a staged width. Up to 128 each warpgroup owns 64 of the
// block's 128 keys and accumulates dK and dV for them; 64-row query tiles
// stream through 3 stages. At 256 that design needs two 128-register
// accumulators a thread (over the 255 allowed) and 320 KB of shared memory,
// so the block owns 64 keys and its warpgroups split the roles, not the
// keys (kSplit): warpgroup 0 forms P^T and accumulates dV, warpgroup 1
// forms dS^T and accumulates dK, and P^T (f32) passes from 0 to 1 through
// shared memory. Q and dO stream through 2 stages (K and V 64 KB, Q and dO
// 64 KB a stage, P^T 16 KB).
template <int HDT>
struct DkvTiling {
  static constexpr bool kSplit = HDT == 256;
  static constexpr int kKeys = kSplit ? kWideDkvKeys : kDkvKeys;
  static constexpr int kStages = kSplit ? 2 : 3;
};
// B1's registers a thread after setmaxnreg: 128 x kProducerRegs + 256 x
// kConsumerRegs is the pool of 384 threads at 168 each (the launch bound)
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr int kLaunchRegs = 168;
constexpr float kLog2e = 1.4426950408889634f;

// A head dim is staged as 64-column tiles (one for hd <= 64, two up to 128,
// four up to 256) whose
// columns past the head dim are zero: the TMA box stays 64 columns (one
// 128-byte swizzled row) over a global inner dimension of hd, and TMA fills
// the elements past the tensor's edge with zeros (a second half of hd 80
// holds 16 real columns; at hd 136 the fourth quarter lies wholly past it).
// Zero columns add nothing to Q K^T, dO V^T, dS K or dS^T Q, so the loops
// run as they are; the products over the head dim take HD / 16 K steps, and
// only the first hd columns of O, dQ, dK and dV are stored. Heads narrower
// than the staged width pay it in P V, dS K, P^T dO and dS^T Q (4x at hd 16,
// 1.6x at hd 80, 1.9x at hd 136).
__host__ __device__ constexpr int staged_hd(int hd) {
  return hd <= 64 ? 64 : hd <= 128 ? 128 : 256;
}

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

// Named barrier ID over B3's two warpgroups (0 is __syncthreads): one
// warpgroup arrives without waiting, the other waits for those arrivals.
// What the arriving threads wrote to shared memory before they arrived is
// visible to the waiting ones after the wait.
template <int ID>
__device__ __forceinline__ void named_arrive() {
  asm volatile("bar.arrive %0, %1;\n" ::"n"(ID), "n"(2 * kWgThreads) : "memory");
}

template <int ID>
__device__ __forceinline__ void named_sync() {
  asm volatile("bar.sync %0, %1;\n" ::"n"(ID), "n"(2 * kWgThreads) : "memory");
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

// wgmma m64nNk16, 16-bit operands (T: bf16 or f16, the PTX types .bf16 and
// .f16), f32 accumulators. ss: d = A B (+ d if accumulate), A and B K-major
// in shared memory. rs: d += A B, A in registers (the accumulator layout),
// B MN-major in shared memory. The instruction names its operand type in
// its text, so each wrapper's asm is written once, as a macro over the type
// string, and instantiated for each type.
#define WGMMA_SS_N128_ASM(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {" \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63" \
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), \
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), \
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), \
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), \
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), \
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), \
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), \
        "+f"(d[62]), "+f"(d[63]) \
      : "l"(desc_a), "l"(desc_b), "r"(accumulate))

template <typename T>
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t desc_a, uint64_t desc_b,
                                              int accumulate) {
  if constexpr (std::is_same_v<T, bf16>)
    WGMMA_SS_N128_ASM("bf16");
  else
    WGMMA_SS_N128_ASM("f16");
}

#define WGMMA_SS_N64_ASM(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {" \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31" \
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), \
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), \
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), \
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]) \
      : "l"(desc_a), "l"(desc_b), "r"(accumulate))

template <typename T>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                             int accumulate) {
  if constexpr (std::is_same_v<T, bf16>)
    WGMMA_SS_N64_ASM("bf16");
  else
    WGMMA_SS_N64_ASM("f16");
}

#define WGMMA_SS_N32_ASM(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " {" \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15" \
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), \
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), \
        "+f"(d[14]), "+f"(d[15]) \
      : "l"(desc_a), "l"(desc_b), "r"(accumulate))

template <typename T>
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t desc_a, uint64_t desc_b,
                                             int accumulate) {
  if constexpr (std::is_same_v<T, bf16>)
    WGMMA_SS_N32_ASM("bf16");
  else
    WGMMA_SS_N32_ASM("f16");
}

// the ss wgmma of width N (128, 64 or 32): S and dP over a key tile of N keys
template <typename T, int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t desc_a, uint64_t desc_b,
                                         int accumulate) {
  if constexpr (N == 128)
    wgmma_ss_n128<T>(d, desc_a, desc_b, accumulate);
  else if constexpr (N == 64)
    wgmma_ss_n64<T>(d, desc_a, desc_b, accumulate);
  else
    wgmma_ss_n32<T>(d, desc_a, desc_b, accumulate);
}

#define WGMMA_RS_N128_ASM(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {" \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63" \
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), \
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), \
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), \
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), \
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), \
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), \
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), \
        "+f"(d[62]), "+f"(d[63]) \
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(1))

template <typename T>
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], uint32_t a0, uint32_t a1, uint32_t a2,
                                              uint32_t a3, uint64_t desc_b) {
  if constexpr (std::is_same_v<T, bf16>)
    WGMMA_RS_N128_ASM("bf16");
  else
    WGMMA_RS_N128_ASM("f16");
}

#define WGMMA_RS_N64_ASM(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {" \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31" \
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), \
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), \
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), \
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]) \
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(1))

template <typename T>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], uint32_t a0, uint32_t a1, uint32_t a2,
                                             uint32_t a3, uint64_t desc_b) {
  if constexpr (std::is_same_v<T, bf16>)
    WGMMA_RS_N64_ASM("bf16");
  else
    WGMMA_RS_N64_ASM("f16");
}

#define WGMMA_RS_N256_ASM(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n256k16.f32." TY "." TY " {" \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, " \
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, " \
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, " \
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, " \
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, " \
      "%120, %121, %122, %123, %124, %125, %126, %127" \
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), \
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), \
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), \
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), \
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), \
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), \
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), \
        "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), \
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), \
        "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), \
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), \
        "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), \
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), \
        "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), \
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), \
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), \
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), \
        "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127]) \
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(1))

template <typename T>
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128], uint32_t a0, uint32_t a1,
                                              uint32_t a2, uint32_t a3, uint64_t desc_b) {
  if constexpr (std::is_same_v<T, bf16>)
    WGMMA_RS_N256_ASM("bf16");
  else
    WGMMA_RS_N256_ASM("f16");
}

// d (64 x HD) += A B over 16 K-rows: A is register fragment kk of `a`, B the
// MN-major tile at `b_addr` (K-rows of 128 bytes, 64-column tiles `half`
// bytes apart: two at HD 128, four at 256, one wgmma over all of them)
template <typename T, int HD, int NA>
__device__ __forceinline__ void wgmma_rs_hd(float (&d)[HD / 2], const uint32_t (&a)[NA], int kk,
                                            uint32_t b_addr, uint32_t half) {
  const uint64_t desc = smem_desc(b_addr, half, 1024);
  if constexpr (HD == 256)
    wgmma_rs_n256<T>(d, a[4 * kk], a[4 * kk + 1], a[4 * kk + 2], a[4 * kk + 3], desc);
  else if constexpr (HD == 128)
    wgmma_rs_n128<T>(d, a[4 * kk], a[4 * kk + 1], a[4 * kk + 2], a[4 * kk + 3], desc);
  else
    wgmma_rs_n64<T>(d, a[4 * kk], a[4 * kk + 1], a[4 * kk + 2], a[4 * kk + 3], desc);
}

// Accumulators (64 x 16*KSTEPS, element i of a thread: row +8 if bit 1,
// column 8 * (i / 4) + 2 * (lane % 4) + bit 0) rounded to T (bf16 or f16)
// as the A fragments of the next wgmma, 16 columns per K step (the two
// types share the fragment layout).
template <typename T, int KSTEPS>
__device__ __forceinline__ void pack_a(uint32_t (&a)[4 * KSTEPS], const float (&s)[8 * KSTEPS]) {
#pragma unroll
  for (int i = 0; i < 4 * KSTEPS; ++i) a[i] = pack2<T>(s[2 * i], s[2 * i + 1]);
}

// Warp-wide: the mask bytes of keys t0 .. t0 + KEYS, KEYS / 32 a lane, into
// dst (a key past skv reads as valid: the ragged edge is tested apart), and
// whether any of them is masked.
template <int KEYS>
__device__ __forceinline__ int stage_mask(uint8_t* dst, const uint8_t* __restrict__ mask_b, int t0,
                                          int skv, int lane) {
  constexpr int kPer = KEYS / 32;
  uint32_t word = 0;
  bool all = true;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int key = t0 + kPer * lane + i;
    const uint32_t mv = key < skv ? mask_b[key] : 1u;
    word |= mv << (8 * i);
    all = all && mv != 0;
  }
  if constexpr (kPer == 4)
    reinterpret_cast<uint32_t*>(dst)[lane] = word;
  else if constexpr (kPer == 2)
    reinterpret_cast<uint16_t*>(dst)[lane] = static_cast<uint16_t>(word);
  else
    dst[lane] = static_cast<uint8_t>(word);
  return !__all_sync(kFull, all);
}

template <int HD>
struct FwdSmem {
  using C = FwdTiling<HD>;
  static constexpr int kHalves = HD / 64;
  static constexpr uint32_t kQHalf = kFwdRows * kSwizzleRow;
  static constexpr uint32_t kKVHalf = C::kKeys * kSwizzleRow;
  static constexpr uint32_t kKVStage = kHalves * kKVHalf;
  static constexpr uint32_t kQ = 0;
  static constexpr uint32_t kK = kQ + kHalves * kQHalf;
  static constexpr uint32_t kV = kK + C::kStages * kKVStage;
  // barriers: Q, then K full, V full and empty for each stage
  static constexpr uint32_t kBars = kV + C::kStages * kKVStage;
  static constexpr uint32_t kMask = kBars + (1 + 3 * C::kStages) * 8;
  static constexpr uint32_t kNeed = kMask + C::kStages * C::kKeys;
  static constexpr uint32_t kBytes = kNeed + C::kStages * 4 + 1024;  // + alignment slack
};

template <int HD, typename T>
__global__ void __launch_bounds__(FwdTiling<staged_hd(HD)>::kThreads, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                       const __grid_constant__ CUtensorMap k_map,
                       const __grid_constant__ CUtensorMap v_map,
                       const uint8_t* __restrict__ mask, T* __restrict__ o,
                       float* __restrict__ lse, int sq, int skv, int nh, int n_kv, int hd,
                       float scale, int causal) {
  constexpr int HDT = staged_hd(HD);
  using C = FwdTiling<HDT>;
  using L = FwdSmem<HDT>;
  constexpr int kKeys = C::kKeys, kStages = C::kStages;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // 128-byte swizzle: 1024-byte aligned tiles
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t bar_q = base + L::kBars;
  const uint32_t bar_k = bar_q + 8, bar_v = bar_k + 8 * kStages, bar_e = bar_v + 8 * kStages;
  uint8_t* mask_s = smem + L::kMask;
  int* need_s = reinterpret_cast<int*>(smem + L::kNeed);

  // the heaviest causal query tiles first: the last grid axis, reversed
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kFwdRows, h = blockIdx.x, b = blockIdx.y;
  const int g = h / (nh / n_kv);
  const int kv_end = causal ? min(skv, q0 + kFwdRows) : skv;
  const int n_tiles = (kv_end + kKeys - 1) / kKeys;
  const uint8_t* mask_b = mask == nullptr ? nullptr : mask + static_cast<int64_t>(b) * skv;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_k + 8 * s, 32);  // the staging warp: mask bytes, then K's copies
      mbar_init(bar_v + 8 * s, 1);
      mbar_init(bar_e + 8 * s, 2 * kWgThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const CUtensorMap* k_tma = &k_map;
  const CUtensorMap* v_tma = &v_map;
  auto load_q = [&] {
    mbar_expect_tx(bar_q, L::kHalves * L::kQHalf);
    for (int hf = 0; hf < L::kHalves; ++hf)
      tma_load_4d(base + L::kQ + hf * L::kQHalf, &q_map, 64 * hf, h, q0, b, bar_q);
  };
  // one warp: wait until tile j's stage is free, stage its mask bytes (and
  // whether any key of it is masked) and start its K and V copies
  auto stage_tile = [&](int j, int lane) {
    const int s = j % kStages, t0 = j * kKeys;
    mbar_wait(bar_e + 8 * s, ((j / kStages) & 1) ^ 1);
    const int need =
        mask_b == nullptr ? 0 : stage_mask<kKeys>(mask_s + s * kKeys, mask_b, t0, skv, lane);
    if (lane == 0) {
      need_s[s] = need;
      mbar_expect_tx(bar_k + 8 * s, L::kKVStage);
      for (int hf = 0; hf < L::kHalves; ++hf)
        tma_load_4d(base + L::kK + s * L::kKVStage + hf * L::kKVHalf, k_tma, 64 * hf, g, t0, b,
                    bar_k + 8 * s);
      mbar_expect_tx(bar_v + 8 * s, L::kKVStage);
      for (int hf = 0; hf < L::kHalves; ++hf)
        tma_load_4d(base + L::kV + s * L::kKVStage + hf * L::kKVHalf, v_tma, 64 * hf, g, t0, b,
                    bar_v + 8 * s);
    } else {
      mbar_arrive(bar_k + 8 * s);
    }
  };

  const int wg = threadIdx.x / kWgThreads;
  if constexpr (!C::kStager) {
    if (wg == 2) {
      // producer: one warp issues the copies; the other three leave
      regs_dec<kProducerRegs>();
      if (threadIdx.x % kWgThreads >= 32) return;
      const int lane = threadIdx.x % 32;
      if (lane == 0) load_q();
      for (int j = 0; j < n_tiles; ++j) stage_tile(j, lane);
      return;
    }
    regs_inc<kConsumerRegs>();
  }
  const int tid = threadIdx.x % kWgThreads, warp = tid / 32, lane = tid % 32;
  // at HDT 256 warp 0 also keeps the ring filled: Q and the first tiles now,
  // then at the top of each tile the stage that the previous tile used
  const bool stager = C::kStager && threadIdx.x < 32;
  if (stager) {
    if (lane == 0) load_q();
    for (int j = 0; j < kStages - 1 && j < n_tiles; ++j) stage_tile(j, lane);
  }
  const int gr = lane >> 2, tg = lane & 3;
  const int r0 = q0 + 64 * wg;  // this warpgroup's first query row
  const int rows[2] = {r0 + 16 * warp + gr, r0 + 16 * warp + gr + 8};
  const float c = scale * kLog2e;  // exp(scale * x) = 2^(c * x)
  const uint32_t q_wg = base + L::kQ + 64 * wg * kSwizzleRow;
  float acc[HDT / 2];
#pragma unroll
  for (int i = 0; i < HDT / 2; ++i) acc[i] = 0.f;
  // m is the running max of the raw scores Q K^T (NEG_INF while a row has
  // seen no valid key); l the running sum of p
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  mbar_wait(bar_q, 0);

  for (int j = 0; j < n_tiles; ++j) {
    if (stager && j + kStages - 1 < n_tiles) stage_tile(j + kStages - 1, lane);
    const int s = j % kStages, t0 = j * kKeys;
    const uint32_t phase = (j / kStages) & 1;
    const uint32_t k_s = base + L::kK + s * L::kKVStage, v_s = base + L::kV + s * L::kKVStage;

    float sc[kKeys / 2];  // S = Q K^T, 64 rows x kKeys keys
    mbar_wait(bar_k + 8 * s, phase);
    if constexpr (kKeys < kFwdRows) {
      if (causal && t0 >= r0 + 64) {  // every key after every query row
        mbar_arrive(bar_e + 8 * s);
        continue;
      }
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t off = (kk % 4) * 32;
      wgmma_ss<T, kKeys>(sc, desc_kmajor(q_wg + (kk / 4) * L::kQHalf + off),
                         desc_kmajor(k_s + (kk / 4) * L::kKVHalf + off), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    settle(sc);

    // the causal compare and the key mask, only where a tile needs them
    const bool need = need_s[s] != 0 || t0 + kKeys > skv || (causal && t0 + kKeys - 1 > r0);
    if (need) {
      const uint8_t* mk = mask_s + s * kKeys;
#pragma unroll
      for (int i = 0; i < kKeys / 2; ++i) {
        const int col = 8 * (i >> 2) + 2 * tg + (i & 1), key = t0 + col;
        const bool valid = key < skv && (!causal || rows[(i >> 1) & 1] >= key) &&
                           (mask_b == nullptr || mk[col] != 0);
        if (!valid) sc[i] = kNegInf;
      }
    }

    float mx[2] = {m[0], m[1]}, sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < kKeys / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
    float alpha[2], mc[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = quad_max(mx[r]);
      alpha[r] = ex2((m[r] - mx[r]) * c);  // 0 when m was NEG_INF and mx is not
      mc[r] = mx[r] * c;
    }
#pragma unroll
    for (int i = 0; i < kKeys / 2; ++i) {
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
    for (int i = 0; i < HDT / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];

    uint32_t pa[kKeys / 4];  // P rounded to V's dtype
    pack_a<T, kKeys / 16>(pa, sc);
    mbar_wait(bar_v + 8 * s, phase);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk)
      wgmma_rs_hd<T, HDT>(acc, pa, kk, v_s + kk * 16 * kSwizzleRow, L::kKVHalf);
    wgmma_commit();
    wgmma_wait_all();
    settle(acc);
    settle(pa);
    mbar_arrive(bar_e + 8 * s);
  }

  // the store at hd == HD takes a compile-time pitch and no column test:
  // with the runtime ones, hd 128 ran ~6% slower (the flagship shape,
  // measured on the card)
  const auto store_out = [&](auto exact) {
    const int w = decltype(exact)::value ? HD : hd;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (rows[r] >= sq) continue;
      const bool empty = l[r] == 0.f;
      const float den = empty ? 1.f : l[r];
      T* o_row = o + ((static_cast<int64_t>(b) * sq + rows[r]) * nh + h) * w;
#pragma unroll
      for (int c8 = 0; c8 < HD / 8; ++c8)
        if (c8 < w / 8)
          *reinterpret_cast<uint32_t*>(o_row + 8 * c8 + 2 * tg) =
              pack2<T>(acc[4 * c8 + 2 * r] / den, acc[4 * c8 + 2 * r + 1] / den);
      if (tg == 0)
        lse[(static_cast<int64_t>(b) * nh + h) * sq + rows[r]] =
            empty ? kNegInf : m[r] * scale + logf(den);
    }
  };
  if (hd == HD)
    store_out(std::true_type{});
  else
    store_out(std::false_type{});
}

template <int HD>
struct DkvSmem {
  using C = DkvTiling<HD>;
  static constexpr int kHalves = HD / 64;
  static constexpr uint32_t kKVHalf = C::kKeys * kSwizzleRow;
  static constexpr uint32_t kQHalf = kDkvQRows * kSwizzleRow;
  static constexpr uint32_t kQTile = kHalves * kQHalf;
  static constexpr uint32_t kK = 0;
  static constexpr uint32_t kV = kK + kHalves * kKVHalf;
  // stage s: Q at kQ + 2 s kQTile, dO right after it
  static constexpr uint32_t kQ = kV + kHalves * kKVHalf;
  static constexpr uint32_t kLse = kQ + C::kStages * 2 * kQTile;
  static constexpr uint32_t kDelta = kLse + C::kStages * kDkvQRows * 4;
  // kSplit: P^T of one tile in f32, in the accumulator layout (16-byte
  // chunk i of thread t at (i * 128 + t) * 16)
  static constexpr uint32_t kPt = kDelta + C::kStages * kDkvQRows * 4;
  // barriers: K and V, then full and empty for each stage
  static constexpr uint32_t kBars = kPt + (C::kSplit ? C::kKeys * kDkvQRows * 4 : 0);
  static constexpr uint32_t kBytes = kBars + (1 + 2 * C::kStages) * 8 + 1024;
};

// the named barriers of B3's P^T hand-off at HDT 256
constexpr int kBarPtFull = 1;  // warpgroup 0 has written P^T
constexpr int kBarPtRead = 2;  // warpgroup 1 has read it

template <int HD, typename T>
__global__ void __launch_bounds__(kDkvThreads, 1)
flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                           const __grid_constant__ CUtensorMap k_map,
                           const __grid_constant__ CUtensorMap v_map,
                           const __grid_constant__ CUtensorMap do_map,
                           const uint8_t* __restrict__ mask, const float* __restrict__ lse,
                           const float* __restrict__ delta, T* __restrict__ dk,
                           T* __restrict__ dv, int sq, int skv, int nh, int n_kv, int hd,
                           float scale, int causal) {
  constexpr int HDT = staged_hd(HD);
  using C = DkvTiling<HDT>;
  using L = DkvSmem<HDT>;
  constexpr int kStages = C::kStages;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t bar_kv = base + L::kBars;
  const uint32_t bar_f = bar_kv + 8, bar_e = bar_f + 8 * kStages;
  float* lse_s = reinterpret_cast<float*>(smem + L::kLse);
  float* delta_s = reinterpret_cast<float*>(smem + L::kDelta);

  // causal: the first key tiles see the most query tiles, and run first
  const int k0 = blockIdx.z * C::kKeys, g = blockIdx.x, b = blockIdx.y;
  const int rep = nh / n_kv;
  // causal: query tiles wholly before this key tile see none of its keys
  const int q_start = causal ? k0 : 0;
  const int n_qt = q_start < sq ? (sq - q_start + kDkvQRows - 1) / kDkvQRows : 0;
  const int n_tiles = rep * n_qt;  // (query head, query tile) pairs, head-major
  const uint8_t* mask_b = mask == nullptr ? nullptr : mask + static_cast<int64_t>(b) * skv;

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < kStages; ++s) {
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
    const int s = jt % kStages;
    const int h = g * rep + jt / n_qt, q0 = q_start + (jt % n_qt) * kDkvQRows;
    mbar_wait(bar_e + 8 * s, ((jt / kStages) & 1) ^ 1);
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
    for (int jt = 0; jt < kStages - 1 && jt < n_tiles; ++jt) stage_tile(jt);
  }

  const int gr = lane >> 2, tg = lane & 3;
  // this warpgroup's first key (kSplit: both take the block's 64 keys)
  const int wk = C::kSplit ? 0 : 64 * wg;
  const int rk0 = k0 + wk;
  // transposed score tiles: row = key, column = query
  const int keys[2] = {rk0 + 16 * warp + gr, rk0 + 16 * warp + gr + 8};
  const bool key_ok[2] = {key_valid(mask_b, keys[0], skv), key_valid(mask_b, keys[1], skv)};
  const bool keys_ok = key_ok[0] && key_ok[1];
  const float c = scale * kLog2e;
  const uint32_t k_wg = base + L::kK + wk * kSwizzleRow;
  const uint32_t v_wg = base + L::kV + wk * kSwizzleRow;

  if constexpr (!C::kSplit) {
    float dk_acc[HDT / 2], dv_acc[HDT / 2];
#pragma unroll
    for (int i = 0; i < HDT / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
    mbar_wait(bar_kv, 0);

    for (int j = 0; j < n_tiles; ++j) {
      // refill the stage that tile j - 1 used: warpgroup 0 may run at most
      // one tile ahead of warpgroup 1, warpgroup 1 as far ahead as the ring
      if (stager && j + kStages - 1 < n_tiles) stage_tile(j + kStages - 1);
      const int s = j % kStages, q0 = q_start + (j % n_qt) * kDkvQRows;
      const uint32_t q_s = base + L::kQ + 2 * s * L::kQTile, do_s = q_s + L::kQTile;
      mbar_wait(bar_f + 8 * s, (j / kStages) & 1);
      if (causal && q0 + kDkvQRows <= rk0) {  // every query before every key
        mbar_arrive(bar_e + 8 * s);
        continue;
      }
      float st[kDkvQRows / 2], dpt[kDkvQRows / 2];  // S^T = K Q^T, dP^T = V dO^T
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;
        wgmma_ss_n64<T>(st, desc_kmajor(k_wg + (kk / 4) * L::kKVHalf + off),
                        desc_kmajor(q_s + (kk / 4) * L::kQHalf + off), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;
        wgmma_ss_n64<T>(dpt, desc_kmajor(v_wg + (kk / 4) * L::kKVHalf + off),
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
      pack_a<T, kDkvQRows / 16>(pp, st);   // P rounded to dO's dtype
      pack_a<T, kDkvQRows / 16>(pd, dpt);  // dS rounded to Q's dtype
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kDkvQRows / 16; ++kk)
        wgmma_rs_hd<T, HDT>(dv_acc, pp, kk, do_s + kk * 16 * kSwizzleRow, L::kQHalf);
#pragma unroll
      for (int kk = 0; kk < kDkvQRows / 16; ++kk)
        wgmma_rs_hd<T, HDT>(dk_acc, pd, kk, q_s + kk * 16 * kSwizzleRow, L::kQHalf);
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
      const int64_t row = ((static_cast<int64_t>(b) * skv + keys[i]) * n_kv + g) * hd;
#pragma unroll
      for (int c8 = 0; c8 < HD / 8; ++c8) {
        if (c8 >= hd / 8) continue;
        *reinterpret_cast<uint32_t*>(dk + row + 8 * c8 + 2 * tg) =
            pack2<T>(dk_acc[4 * c8 + 2 * i], dk_acc[4 * c8 + 2 * i + 1]);
        *reinterpret_cast<uint32_t*>(dv + row + 8 * c8 + 2 * tg) =
            pack2<T>(dv_acc[4 * c8 + 2 * i], dv_acc[4 * c8 + 2 * i + 1]);
      }
    }
  } else {
    // Roles: warpgroup 0 computes S^T = K Q^T, forms P^T, hands it to
    // warpgroup 1 and accumulates dV += P^T dO; warpgroup 1 computes dP^T =
    // V dO^T, forms dS^T = P^T (dP^T - delta) * scale from the P^T it is
    // handed and accumulates dK += dS^T Q. Each product runs once, and each
    // thread keeps one 64 x 256 accumulator. Thread t of warpgroup 1 holds
    // the same score entries as thread t of warpgroup 0, so it reads just
    // what that thread wrote.
    const bool dv_role = wg == 0;
    const uint32_t a_wg = dv_role ? k_wg : v_wg;
    float4* pt_s = reinterpret_cast<float4*>(smem + L::kPt) + tid;
    float acc[HDT / 2];  // dV (warpgroup 0) or dK (warpgroup 1)
#pragma unroll
    for (int i = 0; i < HDT / 2; ++i) acc[i] = 0.f;
    bool handed = false;  // warpgroup 0: a P^T is out that warpgroup 1 has yet to read
    mbar_wait(bar_kv, 0);

    for (int j = 0; j < n_tiles; ++j) {
      // refill the stage that tile j - 1 used (2 stages: the warpgroups run
      // in step, tile j's copies landing while tile j - 1 is computed)
      if (stager && j + kStages - 1 < n_tiles) stage_tile(j + kStages - 1);
      const int s = j % kStages, q0 = q_start + (j % n_qt) * kDkvQRows;
      const uint32_t q_s = base + L::kQ + 2 * s * L::kQTile, do_s = q_s + L::kQTile;
      mbar_wait(bar_f + 8 * s, (j / kStages) & 1);
      // no query tile lies wholly before the block's keys (q_start = k0), so
      // both warpgroups take every tile
      float sc[kDkvQRows / 2];  // S^T (warpgroup 0) or dP^T (warpgroup 1)
      const uint32_t b_s = dv_role ? q_s : do_s;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;
        wgmma_ss_n64<T>(sc, desc_kmajor(a_wg + (kk / 4) * L::kKVHalf + off),
                        desc_kmajor(b_s + (kk / 4) * L::kQHalf + off), kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      settle(sc);

      if (dv_role) {
        // the causal compare and the key mask only on the diagonal and for
        // masked keys; P^T = 0 where lse == NEG_INF (a fully masked row)
        const bool need = !keys_ok || (causal && q0 < k0 + C::kKeys);
        const float* ls = lse_s + s * kDkvQRows;
#pragma unroll
        for (int i = 0; i < kDkvQRows / 2; ++i) {
          const int col = 8 * (i >> 2) + 2 * tg + (i & 1), kr = (i >> 1) & 1;
          const float lq = ls[col];
          bool valid = lq != kNegInf;
          if (need) valid = valid && key_ok[kr] && (!causal || q0 + col >= keys[kr]);
          sc[i] = valid ? ex2(fmaf(sc[i], c, -lq * kLog2e)) : 0.f;  // P^T
        }
        if (handed) named_sync<kBarPtRead>();  // the previous P^T has been read
#pragma unroll
        for (int i = 0; i < kDkvQRows / 8; ++i)
          pt_s[i * kWgThreads] = make_float4(sc[4 * i], sc[4 * i + 1], sc[4 * i + 2], sc[4 * i + 3]);
        named_arrive<kBarPtFull>();
        handed = true;
      } else {
        const float* dl = delta_s + s * kDkvQRows;
        named_sync<kBarPtFull>();
#pragma unroll
        for (int i = 0; i < kDkvQRows / 8; ++i) {
          const float4 p = pt_s[i * kWgThreads];
          const float pv[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = 8 * i + 2 * tg + (e & 1);  // element 4 i + e
            sc[4 * i + e] = pv[e] * (sc[4 * i + e] - dl[col]) * scale;  // dS^T
          }
        }
        named_arrive<kBarPtRead>();
      }
      // P rounded to dO's dtype (warpgroup 0), dS to Q's (warpgroup 1)
      uint32_t pa[kDkvQRows / 4];
      pack_a<T, kDkvQRows / 16>(pa, sc);
      const uint32_t rhs = dv_role ? do_s : q_s;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kDkvQRows / 16; ++kk)
        wgmma_rs_hd<T, HDT>(acc, pa, kk, rhs + kk * 16 * kSwizzleRow, L::kQHalf);
      wgmma_commit();
      wgmma_wait_all();
      settle(acc);
      settle(pa);
      mbar_arrive(bar_e + 8 * s);
    }
    // match warpgroup 1's last "read" arrival before the block exits
    if (handed) named_sync<kBarPtRead>();

    T* out = dv_role ? dv : dk;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (keys[i] >= skv) continue;
      T* row = out + ((static_cast<int64_t>(b) * skv + keys[i]) * n_kv + g) * hd;
#pragma unroll
      for (int c8 = 0; c8 < HD / 8; ++c8)
        if (c8 < hd / 8)
          *reinterpret_cast<uint32_t*>(row + 8 * c8 + 2 * tg) =
              pack2<T>(acc[4 * c8 + 2 * i], acc[4 * c8 + 2 * i + 1]);
    }
  }
}

template <int HD>
struct DqSmem {
  using C = DqTiling<HD>;
  static constexpr int kHalves = HD / 64;
  static constexpr uint32_t kQHalf = kDqRows * kSwizzleRow;
  static constexpr uint32_t kQTile = kHalves * kQHalf;
  static constexpr uint32_t kKVHalf = C::kKeys * kSwizzleRow;
  static constexpr uint32_t kKVTile = kHalves * kKVHalf;
  static constexpr uint32_t kQ = 0;
  static constexpr uint32_t kDo = kQ + kQTile;
  // stage s: K at kK + 2 s kKVTile, V right after it
  static constexpr uint32_t kK = kDo + kQTile;
  static constexpr uint32_t kMask = kK + C::kStages * 2 * kKVTile;
  static constexpr uint32_t kNeed = kMask + C::kStages * C::kKeys;
  // barriers (8-byte aligned): Q and dO, then full and empty for each stage
  static constexpr uint32_t kBars = (kNeed + C::kStages * 4 + 7) / 8 * 8;
  static constexpr uint32_t kBytes = kBars + (1 + 2 * C::kStages) * 8 + 1024;
};

template <int HD, typename T>
__global__ void __launch_bounds__(kDqThreads, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                          const __grid_constant__ CUtensorMap k_map,
                          const __grid_constant__ CUtensorMap v_map,
                          const __grid_constant__ CUtensorMap do_map,
                          const uint8_t* __restrict__ mask, const float* __restrict__ lse,
                          const float* __restrict__ delta, T* __restrict__ dq, int sq,
                          int skv, int nh, int n_kv, int hd, float scale, int causal) {
  constexpr int HDT = staged_hd(HD);
  using L = DqSmem<HDT>;
  constexpr int kKeys = DqTiling<HDT>::kKeys, kStages = DqTiling<HDT>::kStages;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t bar_q = base + L::kBars;
  const uint32_t bar_f = bar_q + 8, bar_e = bar_f + 8 * kStages;
  uint8_t* mask_s = smem + L::kMask;
  int* need_s = reinterpret_cast<int*>(smem + L::kNeed);

  // the heaviest causal query tiles first: the last grid axis, reversed
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kDqRows, h = blockIdx.x, b = blockIdx.y;
  const int g = h / (nh / n_kv);
  const int kv_end = causal ? min(skv, q0 + kDqRows) : skv;
  const int n_tiles = (kv_end + kKeys - 1) / kKeys;
  const uint8_t* mask_b = mask == nullptr ? nullptr : mask + static_cast<int64_t>(b) * skv;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
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
    const int s = jt % kStages, t0 = jt * kKeys;
    mbar_wait(bar_e + 8 * s, ((jt / kStages) & 1) ^ 1);
    const int need =
        mask_b == nullptr ? 0 : stage_mask<kKeys>(mask_s + s * kKeys, mask_b, t0, skv, lane);
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
    for (int jt = 0; jt < kStages - 1 && jt < n_tiles; ++jt) stage_tile(jt);
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
  float acc[HDT / 2];
#pragma unroll
  for (int i = 0; i < HDT / 2; ++i) acc[i] = 0.f;
  mbar_wait(bar_q, 0);

  for (int j = 0; j < n_tiles; ++j) {
    // refill the stage that tile j - 1 used: warpgroup 0 may run at most
    // one tile ahead of warpgroup 1, warpgroup 1 as far ahead as the ring
    if (stager && j + kStages - 1 < n_tiles) stage_tile(j + kStages - 1);
    const int s = j % kStages, t0 = j * kKeys;
    const uint32_t k_s = base + L::kK + 2 * s * L::kKVTile, v_s = k_s + L::kKVTile;
    mbar_wait(bar_f + 8 * s, (j / kStages) & 1);
    if (causal && t0 >= r0 + 64) {  // every key after every query row
      mbar_arrive(bar_e + 8 * s);
      continue;
    }
    float sc[kKeys / 2], dp[kKeys / 2];  // S = Q K^T, dP = dO V^T
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t off = (kk % 4) * 32;
      wgmma_ss<T, kKeys>(sc, desc_kmajor(q_wg + (kk / 4) * L::kQHalf + off),
                         desc_kmajor(k_s + (kk / 4) * L::kKVHalf + off), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t off = (kk % 4) * 32;
      wgmma_ss<T, kKeys>(dp, desc_kmajor(do_wg + (kk / 4) * L::kQHalf + off),
                         desc_kmajor(v_s + (kk / 4) * L::kKVHalf + off), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    settle(sc);
    settle(dp);

    // the causal compare and the key mask only on the diagonal, the ragged
    // edge and tiles with a masked key
    const bool need = need_s[s] != 0 || t0 + kKeys > skv ||
                      (causal && t0 + kKeys - 1 > r0);
    const uint8_t* mk = mask_s + s * kKeys;
#pragma unroll
    for (int i = 0; i < kKeys / 2; ++i) {
      const int col = 8 * (i >> 2) + 2 * tg + (i & 1), r = (i >> 1) & 1, key = t0 + col;
      bool valid = live[r];
      if (need)
        valid = valid && key < skv && (!causal || rows[r] >= key) &&
                (mask_b == nullptr || mk[col] != 0);
      const float p = valid ? ex2(fmaf(sc[i], c, -lse2[r])) : 0.f;
      sc[i] = p * (dp[i] - dl[r]) * scale;  // dS
    }
    uint32_t pd[kKeys / 4];
    pack_a<T, kKeys / 16>(pd, sc);  // dS rounded to K's dtype
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk)  // dQ += dS K, K read MN-major
      wgmma_rs_hd<T, HDT>(acc, pd, kk, k_s + kk * 16 * kSwizzleRow, L::kKVHalf);
    wgmma_commit();
    wgmma_wait_all();
    settle(acc);
    settle(pd);
    mbar_arrive(bar_e + 8 * s);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= sq) continue;
    T* row = dq + ((static_cast<int64_t>(b) * sq + rows[r]) * nh + h) * hd;
#pragma unroll
    for (int c8 = 0; c8 < HD / 8; ++c8)
      if (c8 < hd / 8)
        *reinterpret_cast<uint32_t*>(row + 8 * c8 + 2 * tg) =
          pack2<T>(acc[4 * c8 + 2 * r], acc[4 * c8 + 2 * r + 1]);
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// the FMA kernels' shared memory: staged f32 tiles of HD + 1 columns and
// score tiles of BLK + 1
template <int HD, int BLK>
constexpr int fwd_smem_bytes() { return (3 * BLK * (HD + 1) + BLK * (BLK + 1)) * 4; }
template <int HD, int BLK>
constexpr int dq_smem_bytes() { return (4 * BLK * (HD + 1) + BLK * (BLK + 1)) * 4; }
template <int HD, int BLK>
constexpr int dkv_smem_bytes() {
  return (4 * BLK * (HD + 1) + 2 * BLK * (BLK + 1) + 2 * BLK) * 4;
}
static_assert(dkv_smem_bytes<kWideHD, kWideBlock>() <= kSmemOptIn,
              "the wide dk/dv kernel's tiles exceed the 227 KB a block may opt into");

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

// A 4-D TMA map over a bf16 or f16 [b, s, heads, hd] tensor (T), innermost
// first (hd, heads, s, b). A box is 64 columns (128 bytes, one swizzled row) by
// `rows` rows of one head; rows past the sequence's end, and the columns
// past hd, load as zeros. hd * 2 bytes is a multiple of 16 (hd a multiple
// of 8), as TMA needs of every stride.
template <typename T>
cudaError_t tma_map(CUtensorMap* map, const void* ptr, int hd, int heads, int s, int b, int rows) {
  constexpr CUtensorMapDataType kType = std::is_same_v<T, bf16> ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                                                : CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(s), static_cast<cuuint64_t>(b)};
  const cuuint64_t row_bytes = static_cast<cuuint64_t>(hd) * 2;
  const cuuint64_t strides[3] = {row_bytes, row_bytes * heads, row_bytes * heads * s};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, kType, 4, const_cast<void*>(ptr), dims,
                            strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

struct Shape {
  int b, sq, skv, nh, n_kv, hd;
  float scale;
  int causal;
};

// Column blocks of HD a kCols launch folds into grid x (1 otherwise)
template <int HD, bool kCols>
int col_blocks(int hd) { return kCols ? (hd + HD - 1) / HD : 1; }

// The FMA kernels' launches: one block of kThreads per BLK query rows (or,
// for dk/dv, BLK keys), head, batch row and, past kWideHD, column block.
template <int HD, int BLK, typename T, bool kCols = false>
cudaError_t launch_fma_fwd(const void* q, const void* k, const void* v, const uint8_t* m,
                           void* o, float* lse, const Shape& a, cudaStream_t stream) {
  static bool ready = false;
  constexpr int bytes = fwd_smem_bytes<HD, BLK>();
  const cudaError_t err = allow_smem(flash_fwd_kernel<HD, BLK, T, kCols>, bytes, ready);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.sq + BLK - 1) / BLK * col_blocks<HD, kCols>(a.hd), a.nh, a.b);
  flash_fwd_kernel<HD, BLK, T, kCols><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), m,
      static_cast<T*>(o), lse, a.sq, a.skv, a.nh, a.n_kv, a.hd, a.scale, a.causal);
  return cudaGetLastError();
}

template <int HD, int BLK, typename T, bool kCols = false>
cudaError_t launch_fma_dq(const void* q, const void* k, const void* v, const uint8_t* m,
                          const void* dout, const float* lse, const float* delta, void* dq,
                          const Shape& a, cudaStream_t stream) {
  static bool ready = false;
  constexpr int bytes = dq_smem_bytes<HD, BLK>();
  const cudaError_t err = allow_smem(flash_bwd_dq_kernel<HD, BLK, T, kCols>, bytes, ready);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.sq + BLK - 1) / BLK * col_blocks<HD, kCols>(a.hd), a.nh, a.b);
  flash_bwd_dq_kernel<HD, BLK, T, kCols><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), m,
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dq), a.sq, a.skv, a.nh, a.n_kv,
      a.hd, a.scale, a.causal);
  return cudaGetLastError();
}

template <int HD, int BLK, typename T, bool kCols = false>
cudaError_t launch_fma_dkv(const void* q, const void* k, const void* v, const uint8_t* m,
                           const void* dout, const float* lse, const float* delta, void* dk,
                           void* dv, const Shape& a, cudaStream_t stream) {
  static bool ready = false;
  constexpr int bytes = dkv_smem_bytes<HD, BLK>();
  const cudaError_t err = allow_smem(flash_bwd_dkv_kernel<HD, BLK, T, kCols>, bytes, ready);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.skv + BLK - 1) / BLK * col_blocks<HD, kCols>(a.hd), a.n_kv, a.b);
  flash_bwd_dkv_kernel<HD, BLK, T, kCols><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), m,
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), a.sq,
      a.skv, a.nh, a.n_kv, a.hd, a.scale, a.causal);
  return cudaGetLastError();
}

static_assert(FwdSmem<256>::kBytes <= kSmemOptIn && DqSmem<256>::kBytes <= kSmemOptIn &&
                  DkvSmem<256>::kBytes <= kSmemOptIn && DkvSmem<128>::kBytes <= kSmemOptIn,
              "the wgmma kernels' tiles exceed the 227 KB a block may opt into");
static_assert(FwdSmem<256>::kBars % 8 == 0 && DqSmem<256>::kBars % 8 == 0 &&
                  DkvSmem<256>::kBars % 8 == 0 && FwdSmem<128>::kBars % 8 == 0 &&
                  DqSmem<128>::kBars % 8 == 0 && DkvSmem<128>::kBars % 8 == 0,
              "mbarriers must be 8-byte aligned");
static_assert(DkvSmem<256>::kPt % 16 == 0, "B3's P^T exchange is read as float4");

// Up to hd 256: dtypes 1 (bf16) and 2 (f16) take the tensor-core kernels of
// B1-B3, one template instance a type (T)
template <int HD, typename T>
cudaError_t launch_fwd_tc(const void* q, const void* k, const void* v, const uint8_t* m, void* o,
                          float* lse, const Shape& a, cudaStream_t stream) {
  using C = FwdTiling<staged_hd(HD)>;
  static bool ready = false, pool = false;
  constexpr int bytes = FwdSmem<staged_hd(HD)>::kBytes;
  cudaError_t err;
  CUtensorMap q_map, k_map, v_map;
  if ((err = tma_map<T>(&q_map, q, a.hd, a.nh, a.sq, a.b, kFwdRows)) != cudaSuccess ||
      (err = tma_map<T>(&k_map, k, a.hd, a.n_kv, a.skv, a.b, C::kKeys)) != cudaSuccess ||
      (err = tma_map<T>(&v_map, v, a.hd, a.n_kv, a.skv, a.b, C::kKeys)) != cudaSuccess ||
      (err = allow_smem(flash_fwd_wgmma_kernel<HD, T>, bytes, ready)) != cudaSuccess)
    return err;
  // only the producer warpgroup's shape moves registers with setmaxnreg
  if constexpr (!C::kStager)
    if ((err = check_register_pool(flash_fwd_wgmma_kernel<HD, T>, pool)) != cudaSuccess) return err;
  const dim3 grid(a.nh, a.b, (a.sq + kFwdRows - 1) / kFwdRows);
  flash_fwd_wgmma_kernel<HD, T><<<grid, C::kThreads, bytes, stream>>>(
      q_map, k_map, v_map, m, static_cast<T*>(o), lse, a.sq, a.skv, a.nh, a.n_kv, a.hd, a.scale,
      a.causal);
  return cudaGetLastError();
}

template <int HD, typename T>
cudaError_t launch_dq_tc(const void* q, const void* k, const void* v, const uint8_t* m,
                         const void* dout, const float* lse, const float* delta, void* dq,
                         const Shape& a, cudaStream_t stream) {
  static bool ready = false;
  constexpr int bytes = DqSmem<staged_hd(HD)>::kBytes;
  cudaError_t err;
  CUtensorMap q_map, k_map, v_map, do_map;
  if ((err = tma_map<T>(&q_map, q, a.hd, a.nh, a.sq, a.b, kDqRows)) != cudaSuccess ||
      (err = tma_map<T>(&do_map, dout, a.hd, a.nh, a.sq, a.b, kDqRows)) != cudaSuccess ||
      (err = tma_map<T>(&k_map, k, a.hd, a.n_kv, a.skv, a.b, DqTiling<staged_hd(HD)>::kKeys)) !=
          cudaSuccess ||
      (err = tma_map<T>(&v_map, v, a.hd, a.n_kv, a.skv, a.b, DqTiling<staged_hd(HD)>::kKeys)) !=
          cudaSuccess ||
      (err = allow_smem(flash_bwd_dq_wgmma_kernel<HD, T>, bytes, ready)) != cudaSuccess)
    return err;
  const dim3 grid(a.nh, a.b, (a.sq + kDqRows - 1) / kDqRows);
  flash_bwd_dq_wgmma_kernel<HD, T><<<grid, kDqThreads, bytes, stream>>>(
      q_map, k_map, v_map, do_map, m, lse, delta, static_cast<T*>(dq), a.sq, a.skv, a.nh, a.n_kv,
      a.hd, a.scale, a.causal);
  return cudaGetLastError();
}

template <int HD, typename T>
cudaError_t launch_dkv_tc(const void* q, const void* k, const void* v, const uint8_t* m,
                          const void* dout, const float* lse, const float* delta, void* dk,
                          void* dv, const Shape& a, cudaStream_t stream) {
  constexpr int kKeys = DkvTiling<staged_hd(HD)>::kKeys;
  static bool ready = false;
  constexpr int bytes = DkvSmem<staged_hd(HD)>::kBytes;
  cudaError_t err;
  CUtensorMap q_map, k_map, v_map, do_map;
  if ((err = tma_map<T>(&q_map, q, a.hd, a.nh, a.sq, a.b, kDkvQRows)) != cudaSuccess ||
      (err = tma_map<T>(&do_map, dout, a.hd, a.nh, a.sq, a.b, kDkvQRows)) != cudaSuccess ||
      (err = tma_map<T>(&k_map, k, a.hd, a.n_kv, a.skv, a.b, kKeys)) != cudaSuccess ||
      (err = tma_map<T>(&v_map, v, a.hd, a.n_kv, a.skv, a.b, kKeys)) != cudaSuccess ||
      (err = allow_smem(flash_bwd_dkv_wgmma_kernel<HD, T>, bytes, ready)) != cudaSuccess)
    return err;
  const dim3 grid(a.n_kv, a.b, (a.skv + kKeys - 1) / kKeys);
  flash_bwd_dkv_wgmma_kernel<HD, T><<<grid, kDkvThreads, bytes, stream>>>(
      q_map, k_map, v_map, do_map, m, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), a.sq,
      a.skv, a.nh, a.n_kv, a.hd, a.scale, a.causal);
  return cudaGetLastError();
}

template <typename T>
struct Tag {
  using type = T;
};

// fn(Tag<T>{}) with T the storage type of dtype code 0 (f32), 1 (bf16) or
// 2 (f16)
template <typename Fn>
cudaError_t by_dtype(int dtype, Fn&& fn) {
  switch (dtype) {
    case 0: return fn(Tag<float>{});
    case 1: return fn(Tag<bf16>{});
    case 2: return fn(Tag<f16>{});
    default: return cudaErrorInvalidValue;
  }
}

// Up to hd 128 at HD (hd rounded up to 16): f32 on the FMA units, bf16 and
// f16 on the tensor cores
template <int HD>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, const uint8_t* m, void* o,
                       float* lse, const Shape& a, int dtype, cudaStream_t stream) {
  return by_dtype(dtype, [&](auto tag) {
    using T = typename decltype(tag)::type;
    if constexpr (std::is_same_v<T, float>)
      return launch_fma_fwd<HD, kBlock, float>(q, k, v, m, o, lse, a, stream);
    else
      return launch_fwd_tc<HD, T>(q, k, v, m, o, lse, a, stream);
  });
}

template <int HD>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const uint8_t* m,
                      const void* dout, const float* lse, const float* delta, void* dq,
                      const Shape& a, int dtype, cudaStream_t stream) {
  return by_dtype(dtype, [&](auto tag) {
    using T = typename decltype(tag)::type;
    if constexpr (std::is_same_v<T, float>)
      return launch_fma_dq<HD, kBlock, float>(q, k, v, m, dout, lse, delta, dq, a, stream);
    else
      return launch_dq_tc<HD, T>(q, k, v, m, dout, lse, delta, dq, a, stream);
  });
}

template <int HD>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const uint8_t* m,
                       const void* dout, const float* lse, const float* delta, void* dk,
                       void* dv, const Shape& a, int dtype, cudaStream_t stream) {
  return by_dtype(dtype, [&](auto tag) {
    using T = typename decltype(tag)::type;
    if constexpr (std::is_same_v<T, float>)
      return launch_fma_dkv<HD, kBlock, float>(q, k, v, m, dout, lse, delta, dk, dv, a, stream);
    else
      return launch_dkv_tc<HD, T>(q, k, v, m, dout, lse, delta, dk, dv, a, stream);
  });
}

// the head dims the kernels take: any multiple of 8 (the wrapper zero-pads
// any other head dim to the next multiple of 8)
bool valid_head_dim(int hd) { return hd >= 8 && hd % 8 == 0; }

// Grid y and z hold heads and batch rows (at most 65535 each); past kWideHD
// grid x holds row tiles times column blocks (at most 2^31 - 1)
bool valid_shape(const Shape& a, int dtype) {
  const int64_t cols = (a.hd + kWideHD - 1) / kWideHD;
  const int64_t tiles = (std::max(a.sq, a.skv) + kWideBlock - 1) / kWideBlock;
  return a.b >= 1 && a.sq >= 1 && a.skv >= 1 && a.n_kv >= 1 && a.nh >= a.n_kv &&
         a.nh % a.n_kv == 0 && valid_head_dim(a.hd) && dtype >= 0 && dtype <= 2 &&
         a.b <= 65535 && a.nh <= 65535 && tiles * cols <= INT32_MAX;
}

// fn(std::integral_constant<int, HD>) with HD = hd rounded up to 16: one
// instance of every kernel at each multiple of 16 from 16 to 128 (a head
// dim past 128 is dispatched before this)
template <typename Fn>
cudaError_t by_head_dim(int hd, Fn&& fn) {
  switch ((hd + 15) / 16) {
    case 1: return fn(std::integral_constant<int, 16>{});
    case 2: return fn(std::integral_constant<int, 32>{});
    case 3: return fn(std::integral_constant<int, 48>{});
    case 4: return fn(std::integral_constant<int, 64>{});
    case 5: return fn(std::integral_constant<int, 80>{});
    case 6: return fn(std::integral_constant<int, 96>{});
    case 7: return fn(std::integral_constant<int, 112>{});
    case 8: return fn(std::integral_constant<int, 128>{});
    default: return cudaErrorInvalidValue;
  }
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
    case 0:
      return occupancy(flash_fwd_wgmma_kernel<HD, bf16>, FwdTiling<staged_hd(HD)>::kThreads,
                       FwdSmem<staged_hd(HD)>::kBytes, blocks);
    case 1:
      return occupancy(flash_bwd_dq_wgmma_kernel<HD, bf16>, kDqThreads,
                       DqSmem<staged_hd(HD)>::kBytes, blocks);
    case 2:
      return occupancy(flash_bwd_dkv_wgmma_kernel<HD, bf16>, kDkvThreads,
                       DkvSmem<staged_hd(HD)>::kBytes, blocks);
  }
  return cudaErrorInvalidValue;
}

// the column-block FMA kernels past hd 256
cudaError_t cols_blocks_per_sm(int which, int* blocks) {
  switch (which) {
    case 0:
      return occupancy(flash_fwd_kernel<kWideHD, kWideBlock, bf16, true>, kThreads,
                       fwd_smem_bytes<kWideHD, kWideBlock>(), blocks);
    case 1:
      return occupancy(flash_bwd_dq_kernel<kWideHD, kWideBlock, bf16, true>, kThreads,
                       dq_smem_bytes<kWideHD, kWideBlock>(), blocks);
    case 2:
      return occupancy(flash_bwd_dkv_kernel<kWideHD, kWideBlock, bf16, true>, kThreads,
                       dkv_smem_bytes<kWideHD, kWideBlock>(), blocks);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype codes shared with the Python wrapper: 0 = f32, 1 = bf16, 2 = f16 (q,
// k, v, o, dO and the gradients all share it). mask is null or [b, skv]
// bytes. From hd 136 to 256, bf16 and f16 take the tensor-core instances at
// HD 256 and f32 the wide FMA instances; past 256 every dtype takes the
// column-block FMA instance.

extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, const void* mask,
                                   void* o, void* lse, int b, int sq, int skv, int nh, int n_kv,
                                   int hd, float scale, int causal, int dtype, void* stream) {
  (void)cudaGetLastError();  // report this launch's error, not a stale one
  const Shape a{b, sq, skv, nh, n_kv, hd, scale, causal};
  if (!valid_shape(a, dtype)) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  if (hd > 128)
    return by_dtype(dtype, [&](auto tag) {
      using T = typename decltype(tag)::type;
      if (hd > kWideHD)
        return launch_fma_fwd<kWideHD, kWideBlock, T, true>(q, k, v, m, o, l, a, st);
      if constexpr (std::is_same_v<T, float>)
        return launch_fma_fwd<kWideHD, kWideBlock, T>(q, k, v, m, o, l, a, st);
      else
        return launch_fwd_tc<kWideHD, T>(q, k, v, m, o, l, a, st);
    });
  return by_head_dim(hd, [&](auto c) {
    return launch_fwd<decltype(c)::value>(q, k, v, m, o, l, a, dtype, st);
  });
}

extern "C" int flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                                      const void* mask, const void* dout, const void* lse,
                                      const void* delta, void* dq, int b, int sq, int skv,
                                      int nh, int n_kv, int hd, float scale, int causal,
                                      int dtype, void* stream) {
  (void)cudaGetLastError();
  const Shape a{b, sq, skv, nh, n_kv, hd, scale, causal};
  if (!valid_shape(a, dtype)) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* d = static_cast<const float*>(delta);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  if (hd > 128)
    return by_dtype(dtype, [&](auto tag) {
      using T = typename decltype(tag)::type;
      if (hd > kWideHD)
        return launch_fma_dq<kWideHD, kWideBlock, T, true>(q, k, v, m, dout, l, d, dq, a, st);
      if constexpr (std::is_same_v<T, float>)
        return launch_fma_dq<kWideHD, kWideBlock, T>(q, k, v, m, dout, l, d, dq, a, st);
      else
        return launch_dq_tc<kWideHD, T>(q, k, v, m, dout, l, d, dq, a, st);
    });
  return by_head_dim(hd, [&](auto c) {
    return launch_dq<decltype(c)::value>(q, k, v, m, dout, l, d, dq, a, dtype, st);
  });
}

extern "C" int flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                       const void* mask, const void* dout, const void* lse,
                                       const void* delta, void* dk, void* dv, int b, int sq,
                                       int skv, int nh, int n_kv, int hd, float scale,
                                       int causal, int dtype, void* stream) {
  (void)cudaGetLastError();
  const Shape a{b, sq, skv, nh, n_kv, hd, scale, causal};
  if (!valid_shape(a, dtype)) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* d = static_cast<const float*>(delta);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  if (hd > 128)
    return by_dtype(dtype, [&](auto tag) {
      using T = typename decltype(tag)::type;
      if (hd > kWideHD)
        return launch_fma_dkv<kWideHD, kWideBlock, T, true>(q, k, v, m, dout, l, d, dk, dv, a, st);
      if constexpr (std::is_same_v<T, float>)
        return launch_fma_dkv<kWideHD, kWideBlock, T>(q, k, v, m, dout, l, d, dk, dv, a, st);
      else
        return launch_dkv_tc<kWideHD, T>(q, k, v, m, dout, l, d, dk, dv, a, st);
    });
  return by_head_dim(hd, [&](auto c) {
    return launch_dkv<decltype(c)::value>(q, k, v, m, dout, l, d, dk, dv, a, dtype, st);
  });
}

// Resident blocks an SM holds of the bf16 kernel `which` (0 forward, 1 dq,
// 2 dk/dv) at head dim hd, with the threads and shared memory it launches
// with: a wgmma kernel up to hd 256 (at 256 from 136 on), the column-block
// FMA instances past 256.
extern "C" int flash_attention_blocks_per_sm(int which, int hd, int* blocks) {
  (void)cudaGetLastError();
  if (!valid_head_dim(hd)) return cudaErrorInvalidValue;
  if (hd > kWideHD) return cols_blocks_per_sm(which, blocks);
  if (hd > 128) return wgmma_blocks_per_sm<kWideHD>(which, blocks);
  return by_head_dim(hd, [&](auto c) {
    return wgmma_blocks_per_sm<decltype(c)::value>(which, blocks);
  });
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
