// CRC32C (Castagnoli) for the TFRecord codec: the port's own copy of
// ray_tpu's src/util/crc32c.cc, built by ray_tpu_torch/_private/build.py
// at first use and loaded by ray_tpu_torch/data/tfrecord.py, whose Python
// loop is its plain version. Uses the SSE4.2 CRC32 instruction when the
// CPU has it (that instruction IS the Castagnoli polynomial), else a
// slicing-by-8 software path: either way orders of magnitude over a
// Python loop, which caps TFRecord IO at single-digit MB/s.

#include <cstddef>
#include <cstdint>

#if defined(__x86_64__) || defined(_M_X64)
#include <cpuid.h>
#include <nmmintrin.h>
static bool has_sse42() {
  unsigned eax, ebx, ecx, edx;
  if (!__get_cpuid(1, &eax, &ebx, &ecx, &edx)) return false;
  return (ecx & bit_SSE4_2) != 0;
}
static uint32_t crc_hw(uint32_t crc, const uint8_t* p, size_t n) {
  uint64_t c = crc;
  while (n >= 8) {
    c = _mm_crc32_u64(c, *reinterpret_cast<const uint64_t*>(p));
    p += 8;
    n -= 8;
  }
  uint32_t c32 = (uint32_t)c;
  while (n--) c32 = _mm_crc32_u8(c32, *p++);
  return c32;
}
#else
static bool has_sse42() { return false; }
static uint32_t crc_hw(uint32_t crc, const uint8_t*, size_t) {
  return crc;
}
#endif

static uint32_t g_table[8][256];
static bool g_table_ready = false;

static void init_table() {
  const uint32_t poly = 0x82F63B78u;
  for (uint32_t n = 0; n < 256; n++) {
    uint32_t c = n;
    for (int k = 0; k < 8; k++) c = (c & 1) ? (c >> 1) ^ poly : c >> 1;
    g_table[0][n] = c;
  }
  for (int k = 1; k < 8; k++)
    for (uint32_t n = 0; n < 256; n++)
      g_table[k][n] = g_table[0][g_table[k - 1][n] & 0xFF] ^
                      (g_table[k - 1][n] >> 8);
  g_table_ready = true;
}

static uint32_t crc_sw(uint32_t crc, const uint8_t* p, size_t n) {
  if (!g_table_ready) init_table();
  while (n >= 8) {
    uint32_t lo = crc ^ (p[0] | p[1] << 8 | p[2] << 16 |
                         (uint32_t)p[3] << 24);
    uint32_t hi = p[4] | p[5] << 8 | p[6] << 16 | (uint32_t)p[7] << 24;
    crc = g_table[7][lo & 0xFF] ^ g_table[6][(lo >> 8) & 0xFF] ^
          g_table[5][(lo >> 16) & 0xFF] ^ g_table[4][lo >> 24] ^
          g_table[3][hi & 0xFF] ^ g_table[2][(hi >> 8) & 0xFF] ^
          g_table[1][(hi >> 16) & 0xFF] ^ g_table[0][hi >> 24];
    p += 8;
    n -= 8;
  }
  while (n--) crc = g_table[0][(crc ^ *p++) & 0xFF] ^ (crc >> 8);
  return crc;
}

extern "C" uint32_t crc32c(const uint8_t* data, uint64_t n) {
  static const bool hw = has_sse42();
  uint32_t crc = 0xFFFFFFFFu;
  crc = hw ? crc_hw(crc, data, (size_t)n) : crc_sw(crc, data, (size_t)n);
  return crc ^ 0xFFFFFFFFu;
}
