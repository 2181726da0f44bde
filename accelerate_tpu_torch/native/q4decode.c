/* Native 4-bit -> int8 codebook decoder for the offload streaming path
 * (a copy of the JAX package's native/q4decode.c).
 *
 * The role the reference delegates to bitsandbytes' dequant kernels is
 * played here by an AVX2 pshufb decode on the host: _mm256_shuffle_epi8 IS
 * a 16-entry LUT applied to 32 nibbles per instruction, so decoding a
 * packed plane to int8 codes runs at memory speed, into the pinned staging
 * buffer the host-to-device copy reads. The scalar loop keeps every other
 * arch correct.
 */
#include <stddef.h>
#include <stdint.h>

#if defined(__AVX2__)
#include <immintrin.h>
#endif

void q4_decode_codes(const uint8_t *packed, int8_t *out, size_t n,
                     const int8_t *lut) {
  size_t i = 0;
#if defined(__AVX2__)
  const __m256i lutv =
      _mm256_broadcastsi128_si256(_mm_loadu_si128((const __m128i *)lut));
  const __m256i maskf = _mm256_set1_epi8(0x0F);
  for (; i + 32 <= n; i += 32) {
    __m256i b = _mm256_loadu_si256((const __m256i *)(packed + i));
    __m256i lo = _mm256_and_si256(b, maskf);
    __m256i hi = _mm256_and_si256(_mm256_srli_epi16(b, 4), maskf);
    __m256i vlo = _mm256_shuffle_epi8(lutv, lo);
    __m256i vhi = _mm256_shuffle_epi8(lutv, hi);
    /* interleave (hi, lo) pairs in byte order; unpack* works per 128-bit
     * lane, the permutes restore sequential order across lanes */
    __m256i first = _mm256_unpacklo_epi8(vhi, vlo);
    __m256i second = _mm256_unpackhi_epi8(vhi, vlo);
    __m256i out0 = _mm256_permute2x128_si256(first, second, 0x20);
    __m256i out1 = _mm256_permute2x128_si256(first, second, 0x31);
    _mm256_storeu_si256((__m256i *)(out + 2 * i), out0);
    _mm256_storeu_si256((__m256i *)(out + 2 * i + 32), out1);
  }
#endif
  for (; i < n; i++) {
    uint8_t b = packed[i];
    out[2 * i] = lut[b >> 4];
    out[2 * i + 1] = lut[b & 0x0F];
  }
}
