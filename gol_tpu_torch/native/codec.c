/* Native text-grid <-> bitpacked-words codec.
 *
 * The reference's I/O layer is native C in all six programs (fgetc parse
 * loops, src/game.c:149-166; MPI-IO byte windows, src/game_mpi_collective.c:
 * 174-196). This is the PyTorch port's copy of gol_tpu/native/codec.c, shaped
 * for the bitpacked engine: text bytes ('0'/'1' cells, '\n' row terminators)
 * convert straight to/from uint32 cell words (bit j of word w = column
 * w*32+j), skipping the 8x larger uint8 cell intermediate entirely.
 *
 * Only the byte '1' is a live cell (the text_grid contract: anything else is
 * dead); unpacking emits '0' + bit. Single-threaded per call: ctypes
 * releases the GIL, and the Python packed-I/O layer fans row chunks out
 * over a thread pool.
 *
 * Row addressing uses a byte stride so callers can map the
 * height x (width+1) file layout directly (the '+1' newline column of
 * src/game_mpi_collective.c:180-186).
 *
 * Hot loops use the 64-bit SWAR lane tricks (little-endian only; the scalar
 * fallback keeps big-endian correct):
 *  - pack: lanes are compared against '1' exactly (SWAR equality via xor +
 *    borrow — non-'0'/'1' bytes must read as dead), then a movemask multiply
 *    gathers the 8 lane bits into the top byte.
 *  - unpack: a bit-spread multiply fans 8 bits into 8 byte lanes, normalized
 *    to 0/1 and OR'd with 0x3030..30.
 */

#include <stdint.h>
#include <string.h>

#if defined(__BYTE_ORDER__) && __BYTE_ORDER__ == __ORDER_LITTLE_ENDIAN__
#define GOL_LE 1
#else
#define GOL_LE 0
#endif

static const uint64_t SPREAD = 0x8040201008040201ULL; /* lane i keeps bit i */
static const uint64_t GATHER = 0x0102040810204080ULL; /* lane i -> out bit i */
static const uint64_t ONES = 0x0101010101010101ULL;

/* 8 text bytes -> 8 cell bits (bit i = byte i == '1'). */
static inline uint32_t pack8(const uint8_t *p) {
  uint64_t v;
  memcpy(&v, p, 8);
  /* SWAR equality with '1': lanes equal to '1' zero out under xor, then the
   * borrow trick turns zero-lanes into 1 and everything else into 0. */
  uint64_t x = v ^ (ONES * '1');
  uint64_t eq = (~((x | ((x | (ONES << 7)) - ONES)) >> 7)) & ONES;
  return (uint32_t)((eq * GATHER) >> 56);
}

/* byte value -> its 8 ASCII cells, precomputed (2 KB, L1-resident). */
static uint64_t UNPACK_LUT[256];

__attribute__((constructor)) static void gol_init_lut(void) {
  for (int b = 0; b < 256; ++b) {
    uint64_t spread = ((uint64_t)b * ONES) & SPREAD;
    /* lanes hold 0 or 1<<i; +0x7f pushes any nonzero lane's high bit up. */
    uint64_t norm = ((spread + 0x7f7f7f7f7f7f7f7fULL) >> 7) & ONES;
    UNPACK_LUT[b] = norm | (ONES * '0');
  }
}

/* 8 cell bits -> 8 ASCII bytes at p. */
static inline void unpack8(uint32_t bits, uint8_t *p) {
  memcpy(p, &UNPACK_LUT[bits & 0xffu], 8);
}

/* text (rows x >=width chars at `stride` bytes apart) -> words (rows x
 * width/32). width must be a multiple of 32. */
void gol_pack_text(const uint8_t *text, int64_t stride, uint32_t *words,
                   int64_t rows, int64_t width) {
  const int64_t row_words = width / 32;
  for (int64_t r = 0; r < rows; ++r) {
    const uint8_t *src = text + r * stride;
    uint32_t *dst = words + r * row_words;
    for (int64_t w = 0; w < row_words; ++w) {
      const uint8_t *chunk = src + w * 32;
#if GOL_LE
      dst[w] = pack8(chunk) | (pack8(chunk + 8) << 8) |
               (pack8(chunk + 16) << 16) | (pack8(chunk + 24) << 24);
#else
      uint32_t acc = 0;
      for (int b = 0; b < 32; ++b) {
        acc |= (uint32_t)(chunk[b] == '1') << b;
      }
      dst[w] = acc;
#endif
    }
  }
}

/* words (rows x width/32) -> text rows at `stride` bytes apart; writes the
 * '\n' terminator after each row iff newline != 0 (east-edge shards own the
 * newline column, src/game_mpi_collective.c:382-393). */
void gol_unpack_text(const uint32_t *words, int64_t stride, uint8_t *text,
                     int64_t rows, int64_t width, int newline) {
  const int64_t row_words = width / 32;
  for (int64_t r = 0; r < rows; ++r) {
    const uint32_t *src = words + r * row_words;
    uint8_t *dst = text + r * stride;
    for (int64_t w = 0; w < row_words; ++w) {
      uint32_t acc = src[w];
      uint8_t *chunk = dst + w * 32;
#if GOL_LE
      unpack8(acc, chunk);
      unpack8(acc >> 8, chunk + 8);
      unpack8(acc >> 16, chunk + 16);
      unpack8(acc >> 24, chunk + 24);
#else
      for (int b = 0; b < 32; ++b) {
        chunk[b] = (uint8_t)('0' + ((acc >> b) & 1u));
      }
#endif
    }
    if (newline) {
      dst[width] = '\n';
    }
  }
}
