// CRC-32C (Castagnoli, reflected polynomial 0x82F63B78) for the port's
// snapshot reader: the chunk checksum the JAX package's native IO plane
// writes ("algo": "crc32c", grit_tpu/device/snapshot.py:_chunk_crc).
//
// Built at first use by grit_tpu_torch/checksum.py with the host compiler
// (cc -O3 -msse4.2 -fPIC -shared) and called through ctypes, which
// releases the GIL for the call.
//
// Two paths, chosen once from cpuid:
// - hardware: SSE4.2's crc32 instruction, 8 bytes at a time (single
//   byte steps up to an 8-byte boundary and for the tail). One
//   dependency chain: about 8 bytes every 3 cycles.
// - table: slicing-by-8, eight 256-entry tables built on first use,
//   where cpuid lacks SSE4.2 (or the target is not x86-64).
// Both take and return the finished CRC (zlib.crc32's convention), so a
// buffer can be checksummed piece by piece: crc = grit_crc32c(crc, ...).

#include <stddef.h>
#include <stdint.h>
#include <string.h>

#if defined(__x86_64__) && defined(__SSE4_2__)
#include <nmmintrin.h>
#define GRIT_HAVE_SSE42 1
#else
#define GRIT_HAVE_SSE42 0
#endif

static uint32_t table[8][256];
static int table_ready = 0;

static void build_table(void) {
    for (uint32_t n = 0; n < 256; n++) {
        uint32_t c = n;
        for (int k = 0; k < 8; k++)
            c = (c & 1) ? (c >> 1) ^ 0x82F63B78u : c >> 1;
        table[0][n] = c;
    }
    for (uint32_t n = 0; n < 256; n++) {
        uint32_t c = table[0][n];
        for (int k = 1; k < 8; k++) {
            c = table[0][c & 0xFF] ^ (c >> 8);
            table[k][n] = c;
        }
    }
    __atomic_store_n(&table_ready, 1, __ATOMIC_RELEASE);
}

static uint32_t crc_table(uint32_t c, const uint8_t *p, size_t n) {
    // Concurrent first calls may both build: the tables come out the same.
    if (!__atomic_load_n(&table_ready, __ATOMIC_ACQUIRE)) build_table();
    while (n && ((uintptr_t)p & 7)) {
        c = table[0][(c ^ *p++) & 0xFF] ^ (c >> 8);
        n--;
    }
    while (n >= 8) {
        uint64_t w;
        memcpy(&w, p, 8);
        w ^= c;
        c = table[7][w & 0xFF] ^ table[6][(w >> 8) & 0xFF] ^
            table[5][(w >> 16) & 0xFF] ^ table[4][(w >> 24) & 0xFF] ^
            table[3][(w >> 32) & 0xFF] ^ table[2][(w >> 40) & 0xFF] ^
            table[1][(w >> 48) & 0xFF] ^ table[0][w >> 56];
        p += 8;
        n -= 8;
    }
    while (n--) c = table[0][(c ^ *p++) & 0xFF] ^ (c >> 8);
    return c;
}

#if GRIT_HAVE_SSE42
static uint32_t crc_hw(uint32_t c, const uint8_t *p, size_t n) {
    while (n && ((uintptr_t)p & 7)) {
        c = _mm_crc32_u8(c, *p++);
        n--;
    }
    uint64_t c64 = c;
    while (n >= 8) {
        uint64_t w;
        memcpy(&w, p, 8);
        c64 = _mm_crc32_u64(c64, w);
        p += 8;
        n -= 8;
    }
    c = (uint32_t)c64;
    while (n--) c = _mm_crc32_u8(c, *p++);
    return c;
}
#endif

// 1 when the hardware path runs, 0 for the table path.
int grit_crc32c_hw(void) {
#if GRIT_HAVE_SSE42
    static int hw = -1;
    if (hw < 0) {
        __builtin_cpu_init();
        hw = __builtin_cpu_supports("sse4.2") ? 1 : 0;
    }
    return hw;
#else
    return 0;
#endif
}

// 1 when the table path is forced (a test of the table path on a host
// that has SSE4.2), 0 for cpuid's choice.
static int force_table = 0;

void grit_crc32c_force_table(int on) { force_table = on; }

uint32_t grit_crc32c(uint32_t crc, const void *buf, size_t n) {
    const uint8_t *p = (const uint8_t *)buf;
    uint32_t c = ~crc;
#if GRIT_HAVE_SSE42
    if (!force_table && grit_crc32c_hw()) return ~crc_hw(c, p, n);
#endif
    return ~crc_table(c, p, n);
}
