// Paged attention over a block-table KV pool, for Hopper (sm_90a).
//
// Replaces the TPU kernel accelerate_tpu/ops/paged_attention.py:_pallas_kernel
// (line 159, launched by _paged_attention_pallas). It computes the same
// function: attention of q [b, s, nh, hd] against each row's block-paged
// span of the pools [nb, bs, n_kv, hd], read through block_tables [b, mb].
// Query j of row b attends logical positions <= idx[b] + j. GQA by grouped
// heads (q head h reads kv head h / rep, no KV repeat). int8 / fp8-e4m3
// pools carry per-(position, kv-head) f32 scales. Scores, softmax and the
// accumulator are f32; one divide by max(l, 1e-30) at the end (a row with no
// valid position gives 0), stored in q's dtype.
//
// What bounds it: bytes. A launch must read the valid K/V prefix of every
// row once (plus q, scales and the table) and write the output. At decode a
// kv head has one query row, so the work is 4 * hd flops per 2 * hd * 2
// bytes of bf16 K/V: one flop a byte against the card's ~295 at bf16. The
// bound is the valid K/V bytes over 3.35 TB/s, and the design is about
// keeping enough of those bytes in flight on every SM from the first
// microsecond of the launch to the last.
//
// Design:
//  * A split plan sized to the card, from shapes only. One thread block owns
//    (split, kv head n, a tile of kRows = 16 of the rep * s query rows that
//    share that kv head, row b). The wrapper picks the number of splits from
//    b, n_kv, the row tiles, the table width and the SM count (about one
//    wave of the two blocks an SM holds: each block's fixed latency, idx ->
//    table -> first tile, is paid once a wave), never from idx or the tables,
//    so a captured CUDA graph stays valid. On the device each row's valid prefix
//    (idx[b] + s keys) is cut evenly, in 16-key units, into min(splits,
//    64-key tiles of the prefix) splits, so every launched split in use has
//    keys to read and the splits of a row differ by at most 16 keys. A row
//    with one split in use writes its output directly; otherwise each split
//    writes an f32 partial (m, l, acc) and a second small kernel merges the
//    row's partials in split order: deterministic, no float atomics. (A
//    version where the row's last split merged them after taking an integer
//    ticket saved the launch but lost device time at every timed shape, most
//    at the prefill chunk, whose 16-row tiles leave one block a long serial
//    merge; PERF.md has the numbers.)
//  * Every warp busy. The four warps divide the keys of each staged 64-key
//    tile (16 each), each keeping its own online-softmax state for all 16
//    rows of the tile; they merge through shared memory, in warp order, at
//    the end of the split. At decode (one real row) all four warps stream
//    keys.
//  * Asynchronous staging in the pool's own dtype. At block start the
//    split's block-table entries are read once into shared memory; no
//    per-key dependent table read is left. K and V rows (and, for int8/fp8,
//    their scales) stream through a kStages = 3 ring of cp.async 16-byte
//    copies (4 bytes for a scale), in the storage dtype, 16-byte chunks
//    XOR-swizzled by row so ldmatrix and the FMA path read without bank
//    conflicts; keys past the split's end are zero-filled by the copy. A
//    page is bs rows of n_kv * hd elements, so one kv head's rows are
//    strided: cp.async takes every bs and every pool dtype with one code
//    path, where a TMA box per page would need a tensor map per pool and a
//    box per page. Any block_size works and a tile may straddle pages.
//    Masking is by logical position, so the null block 0 that pads the
//    tables is never attended.
//  * Tensor cores for bf16 queries. Q.K^T and P.V run on mma.sync.m16n8k16
//    (bf16 in, f32 accumulate): the 16-row query tile is one M tile (padded
//    with zero rows at decode, where the work is bytes-bound and the waste
//    costs nothing), K fragments come by ldmatrix and V fragments by
//    ldmatrix.trans from the ring. int8 and fp8 values are exact in bf16, so
//    a quantized pool is widened to bf16 on the fragment load and its scales
//    are applied in f32: the K scale on the score, the V scale on p before it
//    is rounded to bf16. Softmax in base 2 with scale * log2(e) folded in.
//    f32 queries keep f32 arithmetic on the FMA units (a lane owns a key for
//    scores, hd / 32 output dims for P.V; at hd 16 lanes 0..15 own one dim
//    and the others idle in P.V), with the same staging and warp split, expf
//    and IEEE divide, so f32 pools meet 1e-5 against the plain PyTorch
//    version.
//  * Any head dim from 1. The kernel is built at five staged widths,
//    16, 32, 64, 128 and 256, and a head dim runs at the first one that
//    holds it: a staged row is whole 16-byte chunks, the columns past the
//    head dim are zero-filled (so they add nothing to Q.K^T, and the output
//    columns they make are never stored), and the pools, q and the output
//    are addressed at the real pitch: the pool is never padded. A pool row
//    whose byte length is a multiple of 16 is copied 16 bytes at a time; one
//    of a multiple of 8 (a 1-byte row of hd = 8 mod 16, a bf16 row of hd = 4
//    mod 8) 8 bytes at a time; any other (an odd bf16 hd, a 1-byte hd off a
//    multiple of 8) element by element with plain loads, which a stage's
//    barrier orders like the copies. The narrowest staged row, an int8 or
//    fp8 row of 16 dims, is one chunk: the swizzle then has nothing to
//    permute, and 128 threads stage a 64-key tile one key a thread. At 256
//    the bf16 path reads the query fragments from shared memory at each
//    step (in registers they and O would take 192 a thread), a block holds
//    one SM, and an f32 pool's 64-key stage is 128 KB, so that pool stages
//    one tile at a time instead of a three-stage ring.
//  * Past 256 (C4c, kCols): column blocks of 256. A block also owns one
//    column block cb of the output (folded into grid x). The scores need
//    every column, so for each 64-key tile the block stages the query's and
//    K's 256-column chunks in turn (one stage, no ring) and each warp adds
//    each chunk's product into its scores; V is staged once a tile, at
//    column block cb. Every column block computes the same scores in the
//    same order, so its (m, l) are bit-equal and column block 0 writes them;
//    the merge kernel merges each column block's partials (grid y). The pool
//    stays at the real head dim: K and V rows are read at the real pitch.

#include <algorithm>
#include <cfloat>
#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 16;                       // query rows per block: one mma M tile
constexpr int kWarpKeys = 16;                   // keys a warp takes from each stage
constexpr int kStageKeys = kWarps * kWarpKeys;  // keys per ring stage (a "tile")
constexpr int kMaxSplitKeys = 4096;             // the wrapper keeps a split under this
constexpr int kMaxSmem = 232448;                // 227 KB, the most a block may opt into
constexpr unsigned kFull = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return static_cast<float>(x); }
__device__ __forceinline__ float to_f32(__nv_fp8_e4m3 x) { return static_cast<float>(x); }

__device__ __forceinline__ void store_as(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, or 16 zero bytes when !valid (nothing is read)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

// 8 bytes global -> shared, or 8 zero bytes when !valid
__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 8 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t& r0, uint32_t& r1, uint32_t& r2,
                                        uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t& r0, uint32_t& r1,
                                              uint32_t& r2, uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}

// c += a (16 x 16, row-major) * b (16 x 8, column-major), bf16 in, f32 out
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A [rows][HD] tile of pool rows in shared memory, in the storage dtype (HD
// the staged width):
// 16-byte chunks XOR-swizzled by row (the 8 rows an ldmatrix reads, or the
// keys the FMA lanes read, fall in distinct banks).
template <int HD, typename KT>
struct Tile {
  static constexpr int kRowBytes = HD * static_cast<int>(sizeof(KT));
  static constexpr int kChunks = kRowBytes / 16;
  static_assert(HD % 16 == 0 && kRowBytes % 16 == 0,
                "a row is whole 16-byte chunks: one cp.async each, one k16 mma step each 16 dims");
  static_assert((kChunks & (kChunks - 1)) == 0 && kThreads % kChunks == 0,
                "the swizzle XORs within a power-of-two chunk count, and the block stages whole "
                "keys a pass");
  static constexpr int kVec = 16 / static_cast<int>(sizeof(KT));  // elements per chunk
  static constexpr int kSwz = (kChunks < 8 ? kChunks : 8) - 1;
  __device__ static __forceinline__ int off(int r, int d) {  // byte offset of element (r, d)
    const int byte = d * static_cast<int>(sizeof(KT));
    return r * kRowBytes + ((((byte >> 4) ^ (r & kSwz))) << 4) + (byte & 15);
  }
};

template <typename KT>
__device__ __forceinline__ float2 lds2(const char* p) {  // elements d, d + 1 (d even)
  if constexpr (std::is_same_v<KT, float>) {
    return *reinterpret_cast<const float2*>(p);
  } else if constexpr (std::is_same_v<KT, __nv_bfloat16>) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  } else {
    const KT* e = reinterpret_cast<const KT*>(p);
    return make_float2(to_f32(e[0]), to_f32(e[1]));
  }
}

template <typename KT>
__device__ __forceinline__ float lds1(const char* p) {
  return to_f32(*reinterpret_cast<const KT*>(p));
}

// Shared memory of one block, in bytes: the ring (reused by the warps'
// merge), the scales' ring, the query tile, the FMA path's p, the table.
// All of it dynamic: the opt-in takes the whole 227 KB.
template <int HD, typename QT, typename KT, bool kQuant, bool kCols = false>
struct Smem {
  static constexpr bool kMma = std::is_same_v<QT, __nv_bfloat16>;
  static constexpr int kStageBytes = 2 * kStageKeys * Tile<HD, KT>::kRowBytes;  // K rows, V rows
  // ring depth: three stages, or one where a stage alone is 128 KB (an f32
  // pool at HD 256) or the head dim is walked in column chunks
  static constexpr int kStages = kCols || kStageBytes > 65536 ? 1 : 3;
  static constexpr int kMerge = (kWarps * kRows * HD + 2 * kWarps * kRows) * 4;
  // the warps' merge reuses the ring (a one-stage ring of narrow rows is
  // smaller than the merge; a ring never is otherwise)
  static_assert(kCols || kMerge <= kStages * kStageBytes, "the warps' merge reuses the ring");
  static constexpr int kRing = std::max(kStages * kStageBytes, kMerge);
  static constexpr int kScales = kQuant ? kStages * 2 * kStageKeys * 4 : 0;
  static constexpr int kQRow = HD + 16 / static_cast<int>(sizeof(QT));  // padded rows
  static constexpr int kQ = kRows * kQRow * static_cast<int>(sizeof(QT));
  static constexpr int kPRow = kWarpKeys + 2;  // p of the warp's keys, then alpha
  static constexpr int kP = kMma ? 0 : kWarps * kRows * kPRow * 4;
  static constexpr int kScaleOff = kRing;
  static constexpr int kQOff = kScaleOff + kScales;
  static constexpr int kPOff = kQOff + kQ;
  static constexpr int kTableOff = kPOff + kP;
  static int bytes(int table_cap) { return kTableOff + table_cap * 4; }
};

// e^x, or 2^x where scores are in log2 units (the tensor-core path)
template <bool kLog2>
__device__ __forceinline__ float ex(float x) {
  return kLog2 ? exp2f(x) : expf(x);
}

// The row [b, qj, head] of q and of the output that query row `row`
// (qj * rep + the head's index in its group) of kv head n stands for
__device__ __forceinline__ int64_t out_row_of(int b, int row, int rep, int n, int s, int nh) {
  const int qj = row / rep, head = n * rep + row % rep;
  return (static_cast<int64_t>(b) * s + qj) * nh + head;
}

// The split's key range [lo, hi) of a row whose valid prefix is kv_end
// keys, and how many of the launch's splits that row uses.
__device__ __forceinline__ void split_range(int kv_end, int splits, int split, int& used, int& lo,
                                            int& hi) {
  kv_end = max(kv_end, 0);
  const int units = (kv_end + kWarpKeys - 1) / kWarpKeys;
  const int tiles = (kv_end + kStageKeys - 1) / kStageKeys;
  used = max(1, min(splits, tiles));
  lo = split * units / used * kWarpKeys;
  hi = min((split + 1) * units / used * kWarpKeys, kv_end);
}

// One warp's share of a block on the tensor cores (bf16 queries): the 16-row
// query tile as A fragments in registers, O [16 x HD] as mma accumulators,
// m and l for rows g and g + 8 of the thread's quad.
template <int HD, typename KT, bool kQuant>
struct MmaWarp {
  using T = Tile<HD, KT>;
  static constexpr int kQRow = HD + 8;
  // up to HD 128 the query tile's A fragments live in registers; past it
  // they are read from the staged tile at each step
  static constexpr bool kQRegs = HD <= 128;
  uint32_t qa[kQRegs ? HD / 16 : 1][4];
  const __nv_bfloat16* q_s;
  float o[HD / 8][4];
  float m[2], l[2];
  int qpos[2];
  float qk_scale;  // 1 / sqrt(hd) in log2 units

  // A fragment ks (16 dims) of the query tile, from shared memory
  __device__ __forceinline__ void q_frag(uint32_t (&a)[4], int ks, int lane) const {
    const int g = lane / 4, t = lane % 4;
    const __nv_bfloat16* r0 = q_s + g * kQRow + 16 * ks + 2 * t;
    const __nv_bfloat16* r8 = r0 + 8 * kQRow;
    a[0] = *reinterpret_cast<const uint32_t*>(r0);
    a[1] = *reinterpret_cast<const uint32_t*>(r8);
    a[2] = *reinterpret_cast<const uint32_t*>(r0 + 8);
    a[3] = *reinterpret_cast<const uint32_t*>(r8 + 8);
  }

  __device__ __forceinline__ void init(const char* q_smem, float*, int lane, int row0, int rows,
                                       int rep, int start, int hd) {
    const int g = lane / 4;
    qk_scale = kLog2e / sqrtf(static_cast<float>(hd));
    q_s = reinterpret_cast<const __nv_bfloat16*>(q_smem);
    if constexpr (kQRegs) {
#pragma unroll
      for (int ks = 0; ks < HD / 16; ++ks) q_frag(qa[ks], ks, lane);
    }
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int row = row0 + g + 8 * rr;
      qpos[rr] = row < rows ? start + row / rep : -1;
      m[rr] = -FLT_MAX;
      l[rr] = 0.f;
    }
#pragma unroll
    for (int nt = 0; nt < HD / 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) o[nt][i] = 0.f;
  }

  // the score fragments of the warp's 16 keys: sc[j][2 rr + e] is row
  // g + 8 rr, key 8 j + 2 t + e
  using Scores = float[2][4];

  __device__ __forceinline__ static void zero(Scores& sc) {
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) sc[j][i] = 0.f;
  }

  // keys wkey .. wkey + 15 of the stage (K rows kt, V rows vt, scales
  // ks_s / vs_s), at logical positions pos0 .. pos0 + 15
  __device__ __forceinline__ void tile(const char* kt, const char* vt, const float* ks_s,
                                       const float* vs_s, int wkey, int pos0, int k_hi,
                                       int lane) {
    Scores sc;
    zero(sc);
    scores(sc, kt, wkey, lane);
    finish(sc, vt, ks_s, vs_s, wkey, pos0, k_hi, lane);
  }

  // sc += the staged query columns . the staged K columns (HD of them)
  __device__ __forceinline__ void scores(Scores& sc, const char* kt, int wkey, int lane) const {
    const int g = lane / 4, t = lane % 4;
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks) {
      uint32_t kb[2][2];
      if constexpr (std::is_same_v<KT, __nv_bfloat16>) {
        const int mat = lane / 8;
        const int r = wkey + (mat / 2) * 8 + lane % 8;
        ldsm_x4(smem_u32(kt + T::off(r, 16 * ks + 8 * (mat % 2))), kb[0][0], kb[0][1], kb[1][0],
                kb[1][1]);
      } else {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int r = wkey + 8 * j + g;
          const float2 x0 = lds2<KT>(kt + T::off(r, 16 * ks + 2 * t));
          const float2 x1 = lds2<KT>(kt + T::off(r, 16 * ks + 8 + 2 * t));
          kb[j][0] = pack_bf16(x0.x, x0.y);
          kb[j][1] = pack_bf16(x1.x, x1.y);
        }
      }
      if constexpr (kQRegs) {
        mma_bf16(sc[0], qa[ks], kb[0]);
        mma_bf16(sc[1], qa[ks], kb[1]);
      } else {
        uint32_t a[4];
        q_frag(a, ks, lane);
        mma_bf16(sc[0], a, kb[0]);
        mma_bf16(sc[1], a, kb[1]);
      }
    }
  }

  // the online softmax of the warp's keys and P . V (V rows vt)
  __device__ __forceinline__ void finish(Scores& sc, const char* vt, const float* ks_s,
                                         const float* vs_s, int wkey, int pos0, int k_hi,
                                         int lane) {
    const int g = lane / 4, t = lane % 4;
    // scores to log2 units
    float mx[2] = {-FLT_MAX, -FLT_MAX};
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kl = 8 * j + 2 * t + e;
        const int p = pos0 + kl;
        const float f = kQuant ? qk_scale * ks_s[wkey + kl] : qk_scale;
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          float& v = sc[j][2 * rr + e];
          v = (p < k_hi && p <= qpos[rr]) ? v * f : -FLT_MAX;
          mx[rr] = fmaxf(mx[rr], v);
        }
      }
    float alpha[2], psum[2] = {0.f, 0.f};
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(kFull, mx[rr], 1));
      mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(kFull, mx[rr], 2));
      const float m_new = fmaxf(m[rr], mx[rr]);
      alpha[rr] = exp2f(m[rr] - m_new);
      m[rr] = m_new;
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int p = pos0 + 8 * j + 2 * t + e;
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          // while every position so far is masked, m == -FLT_MAX: the
          // explicit mask keeps those keys at p = 0
          float& v = sc[j][2 * rr + e];
          v = (p < k_hi && p <= qpos[rr]) ? exp2f(v - m[rr]) : 0.f;
          psum[rr] += v;
        }
      }
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) l[rr] = l[rr] * alpha[rr] + psum[rr];
#pragma unroll
    for (int nt = 0; nt < HD / 8; ++nt) {
      o[nt][0] *= alpha[0];
      o[nt][1] *= alpha[0];
      o[nt][2] *= alpha[1];
      o[nt][3] *= alpha[1];
    }

    // P as the A fragment of P.V (a V scale multiplies its key's column)
    float vs[2][2] = {{1.f, 1.f}, {1.f, 1.f}};
    if constexpr (kQuant) {
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) vs[j][e] = vs_s[wkey + 8 * j + 2 * t + e];
    }
    const uint32_t pa[4] = {pack_bf16(sc[0][0] * vs[0][0], sc[0][1] * vs[0][1]),
                            pack_bf16(sc[0][2] * vs[0][0], sc[0][3] * vs[0][1]),
                            pack_bf16(sc[1][0] * vs[1][0], sc[1][1] * vs[1][1]),
                            pack_bf16(sc[1][2] * vs[1][0], sc[1][3] * vs[1][1])};
#pragma unroll
    for (int np = 0; np < HD / 16; ++np) {
      uint32_t vb[2][2];
      if constexpr (std::is_same_v<KT, __nv_bfloat16>) {
        const int mat = lane / 8;
        const int r = wkey + (mat % 2) * 8 + lane % 8;
        ldsm_x4_trans(smem_u32(vt + T::off(r, 16 * np + 8 * (mat / 2))), vb[0][0], vb[0][1],
                      vb[1][0], vb[1][1]);
      } else {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int d = 16 * np + 8 * h + g;
          const int r = wkey + 2 * t;
          vb[h][0] = pack_bf16(lds1<KT>(vt + T::off(r, d)), lds1<KT>(vt + T::off(r + 1, d)));
          vb[h][1] = pack_bf16(lds1<KT>(vt + T::off(r + 8, d)), lds1<KT>(vt + T::off(r + 9, d)));
        }
      }
      mma_bf16(o[2 * np], pa, vb[0]);
      mma_bf16(o[2 * np + 1], pa, vb[1]);
    }
  }

  // the warp's (m, l, O) for the block's merge: mo [warp][row][HD]
  __device__ __forceinline__ void store(float* mo, float* mm, float* ml, int warp, int lane) {
    const int g = lane / 4, t = lane % 4;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      l[rr] += __shfl_xor_sync(kFull, l[rr], 1);
      l[rr] += __shfl_xor_sync(kFull, l[rr], 2);
      const int row = warp * kRows + g + 8 * rr;
#pragma unroll
      for (int nt = 0; nt < HD / 8; ++nt)
        *reinterpret_cast<float2*>(mo + row * HD + 8 * nt + 2 * t) =
            make_float2(o[nt][2 * rr], o[nt][2 * rr + 1]);
      if (t == 0) {
        mm[row] = m[rr];
        ml[row] = l[rr];
      }
    }
  }
};

// One warp's share on the FMA units (f32 queries): for scores a lane owns
// key lane % 16 and rows 8 * (lane / 16) .. + 7; for P.V a lane owns output
// dims lane + 32 c of all 16 rows, reading p through shared memory.
template <int HD, typename KT, bool kQuant>
struct FmaWarp {
  using T = Tile<HD, KT>;
  static constexpr int kQRow = HD + 4;
  static constexpr int kDims = (HD + 31) / 32;      // output dims a lane owns in P.V
  static constexpr bool kPartial = HD % 32 != 0;    // hd 16: lanes 16..31 own none
  static constexpr int kPRow = kWarpKeys + 2;
  static_assert(HD % 4 == 0, "scores read q and K four dims at a time");
  const float* q_s;
  float* p_s;  // this warp's [kRows][kPRow]: p by key, then the row's alpha
  float acc[kRows][kDims];
  float m[8], l[8];
  int qpos[8];
  int rows_here;

  __device__ __forceinline__ void init(const char* q_smem, float* p_smem, int lane, int row0,
                                       int rows, int rep, int start, int) {
    const int warp = threadIdx.x / 32, half = lane / 16;
    q_s = reinterpret_cast<const float*>(q_smem);
    p_s = p_smem + warp * kRows * kPRow;
    rows_here = min(kRows, rows - row0);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = row0 + 8 * half + i;
      qpos[i] = row < rows ? start + row / rep : -1;
      m[i] = -FLT_MAX;
      l[i] = 0.f;
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int c = 0; c < kDims; ++c) acc[r][c] = 0.f;
  }

  // the lane's key's scores with the 8 rows of its half-warp
  using Scores = float[8];

  __device__ __forceinline__ static void zero(Scores& s) {
#pragma unroll
    for (int i = 0; i < 8; ++i) s[i] = 0.f;
  }

  __device__ __forceinline__ void tile(const char* kt, const char* vt, const float* ks_s,
                                       const float* vs_s, int wkey, int pos0, int k_hi,
                                       int lane) {
    Scores s;
    zero(s);
    scores(s, kt, wkey, lane);
    finish(s, vt, ks_s, vs_s, wkey, pos0, k_hi, lane);
  }

  // s += the staged query columns . the staged K columns (HD of them)
  __device__ __forceinline__ void scores(Scores& s, const char* kt, int wkey, int lane) const {
    const int kk = lane % 16, half = lane / 16;
    const int key = wkey + kk;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      const float2 k01 = lds2<KT>(kt + T::off(key, d));
      const float2 k23 = lds2<KT>(kt + T::off(key, d + 2));
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 qv = *reinterpret_cast<const float4*>(q_s + (8 * half + i) * kQRow + d);
        s[i] = fmaf(qv.x, k01.x, s[i]);
        s[i] = fmaf(qv.y, k01.y, s[i]);
        s[i] = fmaf(qv.z, k23.x, s[i]);
        s[i] = fmaf(qv.w, k23.y, s[i]);
      }
    }
  }

  // the online softmax of the lane's key and P . V (V rows vt)
  __device__ __forceinline__ void finish(Scores& s, const char* vt, const float* ks_s,
                                         const float* vs_s, int wkey, int pos0, int k_hi,
                                         int lane) {
    const int kk = lane % 16, half = lane / 16;
    const int key = wkey + kk, p = pos0 + kk;
    const float f = kQuant ? ks_s[key] : 1.f;  // x * 1.f is exact
    const float vsc = kQuant ? vs_s[key] : 1.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const bool ok = p < k_hi && p <= qpos[i];
      const float v = ok ? s[i] * f : -FLT_MAX;
      float mx = v;
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
      const float m_new = fmaxf(m[i], mx);
      // while every position so far is masked, m_new == -FLT_MAX: the
      // explicit mask keeps those keys at p = 0
      const float pv = ok ? expf(v - m_new) : 0.f;
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + pv;
      m[i] = m_new;
      p_s[(8 * half + i) * kPRow + kk] = pv * vsc;
      if (kk == 0) p_s[(8 * half + i) * kPRow + kWarpKeys] = alpha;
    }
    __syncwarp();
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r >= rows_here) continue;  // warp-uniform
      const float alpha = p_s[r * kPRow + kWarpKeys];
#pragma unroll
      for (int c = 0; c < kDims; ++c) acc[r][c] *= alpha;
    }
    for (int j = 0; j < kWarpKeys; ++j) {
      float vv[kDims];
#pragma unroll
      for (int c = 0; c < kDims; ++c)
        vv[c] = (!kPartial || lane + 32 * c < HD) ? lds1<KT>(vt + T::off(wkey + j, lane + 32 * c))
                                                  : 0.f;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (r >= rows_here) continue;
        const float pv = p_s[r * kPRow + j];
#pragma unroll
        for (int c = 0; c < kDims; ++c) acc[r][c] = fmaf(pv, vv[c], acc[r][c]);
      }
    }
    __syncwarp();  // p_s is rewritten by the next tile
  }

  __device__ __forceinline__ void store(float* mo, float* mm, float* ml, int warp, int lane) {
    const int kk = lane % 16, half = lane / 16;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) l[i] += __shfl_xor_sync(kFull, l[i], o);
      if (kk == 0) {
        mm[warp * kRows + 8 * half + i] = m[i];
        ml[warp * kRows + 8 * half + i] = l[i];
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int c = 0; c < kDims; ++c)
        if (!kPartial || lane + 32 * c < HD) mo[(warp * kRows + r) * HD + lane + 32 * c] = acc[r][c];
  }
};

// Two blocks an SM: what the bf16 ring allows, and it lets ptxas give a
// thread more than the 168 registers it aims at for three blocks. At HD 256
// one block an SM: its ring alone is most of the SM's shared memory.
template <int HD, typename QT, typename KT, bool kQuant, bool kCols>
__global__ void __launch_bounds__(kThreads, HD > 128 ? 1 : 2)
paged_attention_kernel(const QT* __restrict__ q, const KT* __restrict__ k_pages,
                       const KT* __restrict__ v_pages, const float* __restrict__ k_scale,
                       const float* __restrict__ v_scale, const int* __restrict__ block_tables,
                       const int* __restrict__ idx, QT* __restrict__ out,
                       float* __restrict__ part_acc, float* __restrict__ part_ml, int s, int nh,
                       int n_kv, int hd, int nb, int bs, int mb, int splits) {
  using S = Smem<HD, QT, KT, kQuant, kCols>;
  using T = Tile<HD, KT>;
  constexpr int kStages = S::kStages;
  using Warp = std::conditional_t<S::kMma, MmaWarp<HD, KT, kQuant>, FmaWarp<HD, KT, kQuant>>;
  static_assert(!kCols || !S::kMma || !MmaWarp<HD, KT, kQuant>::kQRegs,
                "a column chunk's query fragments are read from the staged tile");
  extern __shared__ __align__(128) char smem[];
  float* scale_s = reinterpret_cast<float*>(smem + S::kScaleOff);
  QT* q_s = reinterpret_cast<QT*>(smem + S::kQOff);
  int* tab_s = reinterpret_cast<int*>(smem + S::kTableOff);

  // kCols: the block owns column block cb (columns c_lo .. c_lo + HD) of
  // the output, folded into grid x
  const int n_cb = kCols ? (hd + HD - 1) / HD : 1;
  const int split = kCols ? blockIdx.x / n_cb : blockIdx.x;
  const int cb = kCols ? blockIdx.x % n_cb : 0;
  const int c_lo = cb * HD;
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
  int used, k_lo, k_hi;
  split_range(min(start + s, mb * bs), splits, split, used, k_lo, k_hi);
  if (split >= used) return;  // this row uses fewer splits than the launch has

  // the split's block-table entries, read once
  const int page_lo = k_lo / bs;
  const int pages = k_hi > k_lo ? (k_hi - 1) / bs - page_lo + 1 : 0;
  const int* table = block_tables + static_cast<int64_t>(b) * mb + page_lo;
  for (int i = tid; i < pages; i += kThreads) tab_s[i] = min(max(table[i], 0), nb - 1);

  // the query tile's columns c0 .. c0 + HD (rows past rep * s and columns
  // past hd are zero)
  auto load_q = [&](int c0) {
    const int q_hd = hd - c0;
    if constexpr (S::kMma) {
      constexpr int kV = 8;  // bf16: a 16-byte load where hd is a multiple of 8
      if (hd % kV == 0) {
        for (int e = tid; e < kRows * HD / kV; e += kThreads) {
          const int r = e / (HD / kV), c = e % (HD / kV);
          const int row = row0 + r;
          uint4 v = make_uint4(0u, 0u, 0u, 0u);
          if (row < rows && c * kV < q_hd)
            v = *reinterpret_cast<const uint4*>(q + out_row_of(b, row, rep, n, s, nh) * hd + c0 +
                                                c * kV);
          *reinterpret_cast<uint4*>(q_s + r * S::kQRow + c * kV) = v;
        }
      } else {  // element by element, as raw 16-bit words
        const uint16_t* qw = reinterpret_cast<const uint16_t*>(q);
        uint16_t* qs = reinterpret_cast<uint16_t*>(q_s);
        for (int e = tid; e < kRows * HD; e += kThreads) {
          const int r = e / HD, d = e % HD;
          const int row = row0 + r;
          qs[r * S::kQRow + d] =
              row < rows && d < q_hd ? qw[out_row_of(b, row, rep, n, s, nh) * hd + c0 + d] : 0;
        }
      }
    } else {
      // scaled once by 1/sqrt(hd), as the plain version folds it into q
      const float root = sqrtf(static_cast<float>(hd));
      for (int e = tid; e < kRows * HD; e += kThreads) {
        const int r = e / HD, d = e % HD;
        const int row = row0 + r;
        float x = 0.f;
        if (row < rows && d < q_hd)
          x = to_f32(q[out_row_of(b, row, rep, n, s, nh) * hd + c0 + d]) / root;
        q_s[r * S::kQRow + d] = x;
      }
    }
  };
  if constexpr (!kCols) load_q(0);
  __syncthreads();  // tab_s and q_s are written

  const int n_tiles = (k_hi - k_lo + kStageKeys - 1) / kStageKeys;
  // a pool row that is not whole 16-byte chunks goes as 8-byte copies, or,
  // not whole 8-byte ones either, element by element (block-uniform)
  const int row_bytes = hd * static_cast<int>(sizeof(KT));
  const bool narrow = row_bytes % 16 != 0;
  const bool scalar = row_bytes % 8 != 0;
  // KT's bytes as one unsigned word, for the element path
  using W = std::conditional_t<sizeof(KT) == 4, uint32_t,
                               std::conditional_t<sizeof(KT) == 2, uint16_t, uint8_t>>;
  // stage t's K rows at columns kc .. kc + HD and V rows at vc .. vc + HD
  // (kCols: K for one column chunk, V, once a tile, for column block cb),
  // with the scales where with_scales
  auto load_cols = [&](int t, int kc, int vc, bool with_v, bool with_scales) {
    char* kdst = smem + (t % kStages) * S::kStageBytes;
    char* vdst = kdst + kStageKeys * T::kRowBytes;
    const int k0 = k_lo + t * kStageKeys;
    const int c = tid % T::kChunks;
    const int e0 = c * T::kVec;  // the chunk's first element of the row
    if (scalar) {
      for (int key = tid / T::kChunks; key < kStageKeys; key += kThreads / T::kChunks) {
        const int p = k0 + key;
        const bool valid = p < k_hi;
        int64_t off = 0;
        if (valid)
          off = ((static_cast<int64_t>(tab_s[p / bs - page_lo]) * bs + p % bs) * n_kv + n) * hd;
        const W* kw = reinterpret_cast<const W*>(k_pages) + off + kc;
        const W* vw = reinterpret_cast<const W*>(v_pages) + off + vc;
        const int so = T::off(key, e0);
#pragma unroll
        for (int i = 0; i < T::kVec; ++i) {
          const bool k_ok = valid && kc + e0 + i < hd;
          *reinterpret_cast<W*>(kdst + so + i * sizeof(KT)) = k_ok ? kw[e0 + i] : W(0);
          const bool v_ok = valid && vc + e0 + i < hd;
          if (with_v) *reinterpret_cast<W*>(vdst + so + i * sizeof(KT)) = v_ok ? vw[e0 + i] : W(0);
        }
      }
    } else {
      for (int key = tid / T::kChunks; key < kStageKeys; key += kThreads / T::kChunks) {
        const int p = k0 + key;
        const bool valid = p < k_hi;
        int64_t off = 0;
        if (valid)
          off = ((static_cast<int64_t>(tab_s[p / bs - page_lo]) * bs + p % bs) * n_kv + n) * hd;
        const int so = T::off(key, e0);
        if (narrow) {
          constexpr int kHalf = 8 / static_cast<int>(sizeof(KT));  // elements in 8 bytes
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int e = e0 + kHalf * h;
            cp_async8(smem_u32(kdst + so + 8 * h), k_pages + off + kc + e, valid && kc + e < hd);
            if (with_v)
              cp_async8(smem_u32(vdst + so + 8 * h), v_pages + off + vc + e, valid && vc + e < hd);
          }
        } else {
          cp_async16(smem_u32(kdst + so), k_pages + off + kc + e0, valid && kc + e0 < hd);
          if (with_v)
            cp_async16(smem_u32(vdst + so), v_pages + off + vc + e0, valid && vc + e0 < hd);
        }
      }
    }
    if constexpr (kQuant) {
      if (with_scales && tid < kStageKeys) {
        float* sc = scale_s + (t % kStages) * 2 * kStageKeys;
        const int p = k0 + tid;
        const bool valid = p < k_hi;
        int64_t row = 0;
        if (valid) row = (static_cast<int64_t>(tab_s[p / bs - page_lo]) * bs + p % bs) * n_kv + n;
        cp_async4(smem_u32(sc + tid), k_scale + row, valid);
        cp_async4(smem_u32(sc + kStageKeys + tid), v_scale + row, valid);
      }
    }
  };
  auto load_stage = [&](int t) { load_cols(t, 0, 0, true, true); };

#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < n_tiles) load_stage(t);
    cp_async_commit();
  }

  Warp w;
  w.init(reinterpret_cast<const char*>(q_s), reinterpret_cast<float*>(smem + S::kPOff), lane,
         row0, rows, rep, start, hd);
  const int last_pos = start + (min(row0 + kRows, rows) - 1) / rep;  // the tile's last query
  for (int t = 0; t < n_tiles; ++t) {
    if constexpr (kCols) {
      // the scores need every column: stage the query's and K's column
      // chunks in turn, adding each chunk's product into the scores; V is
      // staged once, at column block cb, with the first chunk
      const char* kt = smem;
      const float* sc = scale_s;
      const int wkey = warp * kWarpKeys;
      const int pos0 = k_lo + t * kStageKeys + wkey;
      const bool live = pos0 < k_hi && pos0 <= last_pos;  // warp-uniform
      typename Warp::Scores acc_s;
      Warp::zero(acc_s);
      for (int c0 = 0; c0 < hd; c0 += HD) {
        __syncthreads();  // the previous chunk (and tile) is consumed
        load_q(c0);
        load_cols(t, c0, c_lo, c0 == 0, c0 == 0);
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();  // every thread's copies and stores have landed
        if (live) w.scores(acc_s, kt, wkey, lane);
      }
      if (live)
        w.finish(acc_s, kt + kStageKeys * T::kRowBytes, sc, sc + kStageKeys, wkey, pos0, k_hi,
                 lane);
      continue;
    }
    if constexpr (kStages == 1) {
      __syncthreads();  // tile t - 1 is consumed
      load_stage(t);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();  // tile t has landed, every thread's copies and stores
    } else {
      cp_async_wait<kStages - 2>();  // this thread's copies of tile t have landed
      __syncthreads();               // everyone's have, and tile t - 1's slot is consumed
      if (t + kStages - 1 < n_tiles) load_stage(t + kStages - 1);
      cp_async_commit();
    }
    const int slot = t % kStages;
    const char* kt = smem + slot * S::kStageBytes;
    const float* sc = scale_s + slot * 2 * kStageKeys;
    const int wkey = warp * kWarpKeys;
    const int pos0 = k_lo + t * kStageKeys + wkey;
    if (pos0 < k_hi && pos0 <= last_pos)  // warp-uniform: the warp's keys are not all masked
      w.tile(kt, kt + kStageKeys * T::kRowBytes, sc, sc + kStageKeys, wkey, pos0, k_hi, lane);
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: the warps' states go there

  float* mo = reinterpret_cast<float*>(smem);
  float* mm = mo + kWarps * kRows * HD;
  float* ml = mm + kWarps * kRows;
  w.store(mo, mm, ml, warp, lane);
  __syncthreads();

  // merge the warps in warp order; one split in use writes the output (the
  // first hd columns, or column block cb's)
  const int rows_here = min(kRows, rows - row0);
  const int cols = kCols ? min(HD, hd - c_lo) : hd;
  for (int e = tid; e < rows_here * cols; e += kThreads) {
    const int r = e / cols, d = e % cols;
    float m_all = -FLT_MAX;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) m_all = fmaxf(m_all, mm[i * kRows + r]);
    float l_all = 0.f, o = 0.f;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) {
      const float f = ex<S::kMma>(mm[i * kRows + r] - m_all);
      l_all = fmaf(ml[i * kRows + r], f, l_all);
      o = fmaf(mo[(i * kRows + r) * HD + d], f, o);
    }
    const int64_t out_row = out_row_of(b, row0 + r, rep, n, s, nh);
    if (used == 1) {
      store_as(out + out_row * hd + c_lo + d, o / fmaxf(l_all, 1e-30f));
    } else {
      const int64_t part = out_row * splits + split;
      part_acc[part * hd + c_lo + d] = o;
      // every column block computes the same (m, l): block 0 writes them
      if (d == 0 && cb == 0) {
        part_ml[2 * part] = m_all;
        part_ml[2 * part + 1] = l_all;
      }
    }
  }
}

// Merge the splits of each query row, in split order: one block per (b, qj,
// head) and, past HD, column block (grid y), one thread per output dim (HD,
// the staged width, threads; those past hd leave). Only the splits the row
// used are read; a row that used one split was written by the split kernel.
template <int HD, typename QT, bool kCols>
__global__ void __launch_bounds__(HD)
combine_splits_kernel(const float* __restrict__ part_acc, const float* __restrict__ part_ml,
                      const int* __restrict__ idx, QT* __restrict__ out, int s, int nh, int hd,
                      int bs, int mb, int splits) {
  const int64_t out_row = blockIdx.x;
  const int b = static_cast<int>(out_row / (static_cast<int64_t>(s) * nh));
  const int d = (kCols ? blockIdx.y * HD : 0) + threadIdx.x;
  if (d >= hd) return;
  int used, lo, hi;
  split_range(min(idx[b] + s, mb * bs), splits, 0, used, lo, hi);
  if (used == 1) return;
  const float* ml = part_ml + 2 * out_row * splits;
  const float* pa = part_acc + out_row * splits * hd;
  float m_all = -FLT_MAX;
  for (int j = 0; j < used; ++j) m_all = fmaxf(m_all, ml[2 * j]);
  float l_all = 0.f, o = 0.f;
  for (int j = 0; j < used; ++j) {
    // the tensor-core path (bf16 queries) keeps m in log2 units
    const float w = ex<std::is_same_v<QT, __nv_bfloat16>>(ml[2 * j] - m_all);
    l_all = fmaf(ml[2 * j + 1], w, l_all);
    o = fmaf(pa[j * hd + d], w, o);
  }
  store_as(out + out_row * hd + d, o / fmaxf(l_all, 1e-30f));
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
  int b, s, nh, n_kv, hd, nb, bs, mb, splits;
};

// Block-table entries a split can stage: its keys are at most
// max(one tile, ceil(ceil(span / 16) / splits) 16-key units), and a range of
// K keys touches at most ceil(K / bs) + 1 pages.
int table_cap(int span, int bs, int mb, int splits) {
  const int units = (span + kWarpKeys - 1) / kWarpKeys;
  const int keys = std::max(kStageKeys, (units + splits - 1) / splits * kWarpKeys);
  return std::min(mb, (keys + bs - 1) / bs + 1);
}

// Above 48 KB a kernel needs an opt-in for dynamic shared memory; once per
// kernel instance and process.
template <int HD, typename QT, typename KT, bool kQuant, bool kCols>
cudaError_t opt_in() {
  static bool done = false;
  if (done) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(paged_attention_kernel<HD, QT, KT, kQuant, kCols>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               kMaxSmem);
  done = err == cudaSuccess;
  return err;
}

template <int HD, typename QT, typename KT, bool kQuant, bool kCols>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const int bytes =
      Smem<HD, QT, KT, kQuant, kCols>::bytes(table_cap(a.mb * a.bs, a.bs, a.mb, a.splits));
  if (bytes > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = opt_in<HD, QT, KT, kQuant, kCols>();
  if (err != cudaSuccess) return err;
  const int rows = (a.nh / a.n_kv) * a.s;
  const int n_cb = kCols ? (a.hd + HD - 1) / HD : 1;
  const dim3 grid(a.splits * n_cb, a.n_kv * ((rows + kRows - 1) / kRows), a.b);
  paged_attention_kernel<HD, QT, KT, kQuant, kCols><<<grid, kThreads, bytes, stream>>>(
      static_cast<const QT*>(a.q), static_cast<const KT*>(a.k_pages),
      static_cast<const KT*>(a.v_pages), static_cast<const float*>(a.k_scale),
      static_cast<const float*>(a.v_scale), static_cast<const int*>(a.block_tables),
      static_cast<const int*>(a.idx), static_cast<QT*>(a.out), a.part_acc, a.part_ml, a.s,
      a.nh, a.n_kv, a.hd, a.nb, a.bs, a.mb, a.splits);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.splits == 1) return err;
  combine_splits_kernel<HD, QT, kCols><<<dim3(a.b * a.s * a.nh, n_cb), HD, 0, stream>>>(
      a.part_acc, a.part_ml, static_cast<const int*>(a.idx), static_cast<QT*>(a.out), a.s,
      a.nh, a.hd, a.bs, a.mb, a.splits);
  return cudaGetLastError();
}

// dtype codes shared with the Python wrapper: q 0 = f32, 1 = bf16;
// pools 0 = f32, 1 = bf16, 2 = int8, 3 = fp8 e4m3 (2 and 3 carry scales)
template <int HD, typename QT, bool kCols>
cudaError_t by_pool(const Args& a, int kv_dtype, cudaStream_t stream) {
  switch (kv_dtype) {
    case 0: return launch<HD, QT, float, false, kCols>(a, stream);
    case 1: return launch<HD, QT, __nv_bfloat16, false, kCols>(a, stream);
    case 2: return launch<HD, QT, int8_t, true, kCols>(a, stream);
    case 3: return launch<HD, QT, __nv_fp8_e4m3, true, kCols>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <int HD, bool kCols = false>
cudaError_t by_query(const Args& a, int q_dtype, int kv_dtype, cudaStream_t stream) {
  switch (q_dtype) {
    case 0: return by_pool<HD, float, kCols>(a, kv_dtype, stream);
    case 1: return by_pool<HD, __nv_bfloat16, kCols>(a, kv_dtype, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// part_acc [b, s, nh, splits, hd] and part_ml [b, s, nh, splits, 2] (f32)
// are scratch the wrapper allocates when splits > 1, else null. splits is
// the wrapper's plan: at least ceil(mb * bs / 4096), at most the
// table's 64-key tiles. hd is any head dim from 1 (past 256 grid x holds
// splits times ceil(hd / 256) blocks, at most 2^31 - 1).
extern "C" int paged_attention_forward(const void* q, const void* k_pages, const void* v_pages,
                                       const void* k_scale, const void* v_scale,
                                       const void* block_tables, const void* idx, void* out,
                                       void* part_acc, void* part_ml, int b, int s, int nh,
                                       int n_kv, int hd, int nb, int bs, int mb, int splits,
                                       int q_dtype, int kv_dtype, void* stream) {
  (void)cudaGetLastError();  // report this launch's error, not a stale one
  const int64_t span = static_cast<int64_t>(mb) * bs;
  if (b < 1 || s < 1 || n_kv < 1 || nh % n_kv != 0 || nb < 1 || bs < 1 || mb < 1 ||
      span > (int64_t{1} << 30) || splits < 1 || hd < 1 ||
      static_cast<int64_t>(splits) * ((hd + 255) / 256) > INT32_MAX ||
      splits > (span + kStageKeys - 1) / kStageKeys ||
      splits < (span + kMaxSplitKeys - 1) / kMaxSplitKeys ||
      (splits > 1 && (part_acc == nullptr || part_ml == nullptr)))
    return cudaErrorInvalidValue;
  const Args a{q, k_pages, v_pages, k_scale, v_scale, block_tables, idx, out,
               static_cast<float*>(part_acc), static_cast<float*>(part_ml),
               b, s, nh, n_kv, hd, nb, bs, mb, splits};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  // the first staged width that holds hd
  if (hd <= 16) return by_query<16>(a, q_dtype, kv_dtype, st);
  if (hd <= 32) return by_query<32>(a, q_dtype, kv_dtype, st);
  if (hd <= 64) return by_query<64>(a, q_dtype, kv_dtype, st);
  if (hd <= 128) return by_query<128>(a, q_dtype, kv_dtype, st);
  if (hd <= 256) return by_query<256>(a, q_dtype, kv_dtype, st);
  return by_query<256, true>(a, q_dtype, kv_dtype, st);  // column blocks of 256
}

// Resident blocks an SM holds of the split kernel and of the combine kernel
// at head dim 128 or 256 with bf16 queries and a bf16 pool (the decode of 8
// slots at context 1024: a 64-entry table of 16-key pages in 2 splits), by
// the runtime's occupancy calculator for this device, and the split
// kernel's dynamic shared memory there.
template <int HD, bool kCols = false>
cudaError_t blocks_per_sm(int* split, int* combine, int* smem_bytes) {
  using S = Smem<HD, __nv_bfloat16, __nv_bfloat16, false, kCols>;
  cudaError_t err = opt_in<HD, __nv_bfloat16, __nv_bfloat16, false, kCols>();
  if (err != cudaSuccess) return err;
  *smem_bytes = S::bytes(table_cap(64 * 16, 16, 64, 2));
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      split, paged_attention_kernel<HD, __nv_bfloat16, __nv_bfloat16, false, kCols>, kThreads,
      *smem_bytes);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      combine, combine_splits_kernel<HD, __nv_bfloat16, kCols>, HD, 0);
}

// hd 128, 256 or, for the column-block instance, any hd past 256
extern "C" int paged_attention_blocks_per_sm(int hd, int* split, int* combine, int* smem_bytes) {
  (void)cudaGetLastError();
  if (hd == 128) return blocks_per_sm<128>(split, combine, smem_bytes);
  if (hd == 256) return blocks_per_sm<256>(split, combine, smem_bytes);
  if (hd > 256) return blocks_per_sm<256, true>(split, combine, smem_bytes);
  return cudaErrorInvalidValue;
}

extern "C" const char* paged_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
