/* Blosc-1 frames with the LZ4 block codec: the chunk codec of the port's
 * zarr word store (gol_tpu_torch/io/ts_store.py).
 *
 * The JAX package stores bitpacked words through TensorStore's zarr
 * driver: a zarr v2 array whose chunk files are each one blosc-1 frame,
 * compressed with {"id": "blosc", "cname": "lz4", "clevel": 5,
 * "shuffle": -1} (byte shuffle for the 4-byte words). The port reads and
 * writes that format itself, with no TensorStore and no c-blosc.
 *
 * A frame (c-blosc 1.x; integers little-endian):
 *   byte 0  format version, 2
 *   byte 1  codec version, 1 for LZ4
 *   byte 2  flags: 0x01 byte shuffle, 0x02 memcpyed (the raw bytes follow
 *           the header), 0x04 bitshuffle, 0x08 delta, 0x10 blocks not
 *           split; bits 5-7 the codec format (1: LZ4, which lz4 and lz4hc
 *           both write; 0 blosclz, 2 snappy, 3 zlib, 4 zstd)
 *   byte 3  typesize
 *   4-7     nbytes, the raw size; 8-11 blocksize; 12-15 cbytes, the frame's
 * Unless memcpyed, an int32 offset per block follows, then the blocks. A
 * block is `typesize` streams when split (flag 0x10 clear, and not the
 * short last block), else one; a stream is an int32 size and that many
 * bytes: an LZ4 block, or the raw bytes when the size equals the stream's
 * raw size. A shuffled block is unshuffled once its streams are decoded.
 *
 * Decoding checks every offset and size against cbytes and nbytes: a torn
 * or corrupt frame returns an error code and never reads or writes out of
 * bounds. Encoding is a greedy hash-table LZ4 matcher that keeps LZ4's
 * end-of-block rules (the last 5 bytes are literals, no match starts in
 * the last 12), with c-blosc's block size for clevel 5, its split rule,
 * and its fallback to a memcpyed frame when compression does not shrink
 * the chunk. The bytes need not equal c-blosc's; the words they decode to
 * do, and c-blosc reads them.
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#if defined(__BYTE_ORDER__) && __BYTE_ORDER__ == __ORDER_LITTLE_ENDIAN__
#define GOL_LE 1
#else
#define GOL_LE 0
#endif

enum {
  HEADER = 16,
  F_SHUFFLE = 0x01,
  F_MEMCPYED = 0x02,
  F_BITSHUFFLE = 0x04,
  F_DELTA = 0x08,
  F_NOSPLIT = 0x10,
  LZ4_FORMAT = 1,
  MAX_SPLITS = 16,
  MIN_BUFFERSIZE = 128,
  /* LZ4's block rules and the matcher's table */
  MINMATCH = 4,
  MFLIMIT = 12,
  LASTLITERALS = 5,
  MAX_DISTANCE = 65535,
  HASH_LOG = 14,
  SKIP_TRIGGER = 6,
};

/* Error codes (gol_tpu_torch/native/blosc.py names them). */
enum {
  E_TRUNCATED = -1,  /* shorter than its header, or cbytes != its length */
  E_VERSION = -2,    /* format version is not 2 */
  E_BITSHUFFLE = -3, /* flag 0x04 */
  E_DELTA = -4,      /* flag 0x08 */
  E_CODEC = -5,      /* not LZ4 */
  E_NBYTES = -6,     /* nbytes differs from the chunk's size */
  E_BLOCKSIZE = -7,  /* blocksize or typesize does not fit the frame */
  E_OFFSETS = -8,    /* a block offset outside the frame */
  E_STREAM = -9,     /* a stream size outside the frame */
  E_LZ4 = -10,       /* a corrupt LZ4 stream */
  E_NOMEM = -11,
  E_ARGS = -12,      /* the caller's sizes */
};

static inline uint32_t rd32(const uint8_t *p) {
  return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
         ((uint32_t)p[3] << 24);
}

static inline void wr32(uint8_t *p, uint32_t v) {
  p[0] = (uint8_t)v;
  p[1] = (uint8_t)(v >> 8);
  p[2] = (uint8_t)(v >> 16);
  p[3] = (uint8_t)(v >> 24);
}

/* ---- LZ4 block format ------------------------------------------------ */

/* Decode one LZ4 block of n bytes into exactly `cap` bytes at dst; the
 * bytes written, or -1 on any malformed or out-of-bounds sequence. */
static int64_t lz4_decode(const uint8_t *src, int64_t n, uint8_t *dst,
                          int64_t cap) {
  const uint8_t *ip = src, *const iend = src + n;
  uint8_t *op = dst, *const oend = dst + cap;
  for (;;) {
    if (ip >= iend) return -1;
    const unsigned token = *ip++;
    int64_t lit = token >> 4;
    if (lit == 15) {
      unsigned b;
      do {
        if (ip >= iend) return -1;
        b = *ip++;
        lit += b;
      } while (b == 255);
    }
    if (lit > iend - ip || lit > oend - op) return -1;
    memcpy(op, ip, (size_t)lit);
    op += lit;
    ip += lit;
    if (ip == iend) break; /* the last sequence holds literals only */
    if (iend - ip < 2) return -1;
    const int64_t off = (int64_t)ip[0] | ((int64_t)ip[1] << 8);
    ip += 2;
    if (off == 0 || off > op - dst) return -1;
    int64_t len = token & 15;
    if (len == 15) {
      unsigned b;
      do {
        if (ip >= iend) return -1;
        b = *ip++;
        len += b;
      } while (b == 255);
    }
    len += MINMATCH;
    if (len > oend - op) return -1;
    const uint8_t *match = op - off;
    if (off >= len) {
      memcpy(op, match, (size_t)len);
      op += len;
    } else {
      /* Overlapping: the output repeats with period off, so copy the
       * growing prefix [match, op) forward, doubling each round. */
      while (len > 0) {
        int64_t k = op - match;
        if (k > len) k = len;
        memcpy(op, match, (size_t)k);
        op += k;
        len -= k;
      }
    }
  }
  return op - dst;
}

static inline uint32_t hash4(const uint8_t *p) {
  uint32_t v;
  memcpy(&v, p, 4);
  return (v * 2654435761u) >> (32 - HASH_LOG);
}

static inline int same4(const uint8_t *a, const uint8_t *b) {
  return memcmp(a, b, 4) == 0;
}

/* Bytes `src[ip..)` and `src[ref..)` have in common, up to `limit - ip`. */
static inline int64_t common(const uint8_t *src, int64_t ip, int64_t ref,
                             int64_t limit) {
  int64_t len = 0;
  while (ip + len + 8 <= limit) {
    uint64_t a, b;
    memcpy(&a, src + ip + len, 8);
    memcpy(&b, src + ref + len, 8);
    const uint64_t x = a ^ b;
    if (x) {
#if GOL_LE
      return len + (__builtin_ctzll(x) >> 3);
#else
      return len + (__builtin_clzll(x) >> 3);
#endif
    }
    len += 8;
  }
  while (ip + len < limit && src[ip + len] == src[ref + len]) ++len;
  return len;
}

static inline uint8_t *put_length(uint8_t *op, int64_t v) {
  while (v >= 255) {
    *op++ = 255;
    v -= 255;
  }
  *op++ = (uint8_t)v;
  return op;
}

/* Bytes one sequence takes: token, literal length, literals, and with a
 * match its offset and match length. */
static inline int64_t sequence_bytes(int64_t lit, int64_t match_len) {
  int64_t n = 1 + lit + (lit >= 15 ? (lit - 15) / 255 + 1 : 0);
  if (match_len >= 0) {
    const int64_t m = match_len - MINMATCH;
    n += 2 + (m >= 15 ? (m - 15) / 255 + 1 : 0);
  }
  return n;
}

static uint8_t *emit(uint8_t *op, const uint8_t *lits, int64_t lit,
                     int64_t off, int64_t match_len) {
  uint8_t *token = op++;
  *token = (uint8_t)((lit >= 15 ? 15 : lit) << 4);
  if (lit >= 15) op = put_length(op, lit - 15);
  memcpy(op, lits, (size_t)lit);
  op += lit;
  if (match_len >= 0) {
    *op++ = (uint8_t)off;
    *op++ = (uint8_t)(off >> 8);
    const int64_t m = match_len - MINMATCH;
    *token |= (uint8_t)(m >= 15 ? 15 : m);
    if (m >= 15) op = put_length(op, m - 15);
  }
  return op;
}

/* Compress n bytes into at most `cap` bytes at dst: the compressed size, or
 * -1 when it would not fit. Greedy: the first 4-byte match a position's
 * hash finds is extended both ways and taken; positions without a match
 * are skipped at a growing stride (LZ4's acceleration), so incompressible
 * input costs little. */
static int64_t lz4_encode(const uint8_t *src, int64_t n, uint8_t *dst,
                          int64_t cap) {
  uint8_t *op = dst, *const oend = dst + cap;
  int64_t anchor = 0;
  if (n > MFLIMIT) {
    uint32_t table[1 << HASH_LOG];
    memset(table, 0, sizeof table); /* position 0: a real candidate */
    const int64_t mflimit = n - MFLIMIT;          /* a match starts <= this */
    const int64_t matchlimit = n - LASTLITERALS;  /* and ends <= this */
    int64_t ip = 1;
    for (;;) {
      int64_t ref;
      uint32_t attempts = 1u << SKIP_TRIGGER;
      for (;;) {
        if (ip > mflimit) goto last;
        const uint32_t h = hash4(src + ip);
        ref = table[h];
        table[h] = (uint32_t)ip;
        if (ref < ip && ip - ref <= MAX_DISTANCE && same4(src + ref, src + ip))
          break;
        ip += attempts++ >> SKIP_TRIGGER;
      }
      while (ip > anchor && ref > 0 && src[ip - 1] == src[ref - 1]) {
        --ip;
        --ref;
      }
      const int64_t len =
          MINMATCH + common(src, ip + MINMATCH, ref + MINMATCH, matchlimit);
      const int64_t lit = ip - anchor;
      if (sequence_bytes(lit, len) > oend - op) return -1;
      op = emit(op, src + anchor, lit, ip - ref, len);
      ip += len;
      anchor = ip;
      if (ip > mflimit) break;
      table[hash4(src + ip - 2)] = (uint32_t)(ip - 2);
    }
  }
last:;
  const int64_t lit = n - anchor;
  if (sequence_bytes(lit, -1) > oend - op) return -1;
  op = emit(op, src + anchor, lit, 0, -1);
  return op - dst;
}

/* ---- byte shuffle ---------------------------------------------------- */

/* Byte j of every element into plane j; trailing bytes are copied. */
static void shuffle(int64_t typesize, int64_t n, const uint8_t *src,
                    uint8_t *dst) {
  const int64_t q = n / typesize;
  if (typesize == 4) {
    for (int64_t i = 0; i < q; ++i) {
      dst[i] = src[4 * i];
      dst[q + i] = src[4 * i + 1];
      dst[2 * q + i] = src[4 * i + 2];
      dst[3 * q + i] = src[4 * i + 3];
    }
  } else {
    for (int64_t j = 0; j < typesize; ++j)
      for (int64_t i = 0; i < q; ++i) dst[j * q + i] = src[i * typesize + j];
  }
  memcpy(dst + q * typesize, src + q * typesize, (size_t)(n - q * typesize));
}

static void unshuffle(int64_t typesize, int64_t n, const uint8_t *src,
                      uint8_t *dst) {
  const int64_t q = n / typesize;
  if (typesize == 4) {
    for (int64_t i = 0; i < q; ++i) {
      dst[4 * i] = src[i];
      dst[4 * i + 1] = src[q + i];
      dst[4 * i + 2] = src[2 * q + i];
      dst[4 * i + 3] = src[3 * q + i];
    }
  } else {
    for (int64_t j = 0; j < typesize; ++j)
      for (int64_t i = 0; i < q; ++i) dst[i * typesize + j] = src[j * q + i];
  }
  memcpy(dst + q * typesize, src + q * typesize, (size_t)(n - q * typesize));
}

/* ---- frames ---------------------------------------------------------- */

/* c-blosc 1.x's block size for clevel 5 and a splitting codec (LZ4):
 * 128 KiB of elements for buffers of at least 32 KiB, times the typesize
 * when split, clamped to [64 KiB, 1 MiB] and to the buffer, and a
 * multiple of the typesize. */
static int64_t blocksize_for(int64_t nbytes, int64_t typesize) {
  if (nbytes < typesize) return 1;
  int64_t bs = nbytes;
  if (nbytes >= 32 * 1024) bs = 32 * 1024 * 4;
  if (typesize <= MAX_SPLITS && bs / typesize >= MIN_BUFFERSIZE) {
    if (bs > (1 << 18)) bs = 1 << 18;
    bs *= typesize;
    if (bs < (1 << 16)) bs = 1 << 16;
    if (bs > (1 << 20)) bs = 1 << 20;
  }
  if (bs > nbytes) bs = nbytes;
  if (bs > typesize) bs = bs / typesize * typesize;
  return bs;
}

static int64_t memcpyed(const uint8_t *src, int64_t nbytes, uint8_t *dst,
                        uint8_t flags) {
  dst[2] = (uint8_t)(flags | F_MEMCPYED);
  wr32(dst + 12, (uint32_t)(nbytes + HEADER));
  memcpy(dst + HEADER, src, (size_t)nbytes);
  return nbytes + HEADER;
}

/* One chunk of nbytes at src -> a frame at dst (room for nbytes + 16):
 * the frame's size, or a negative error code. */
int64_t gol_blosc_encode(const uint8_t *src, int64_t nbytes, int64_t typesize,
                         uint8_t *dst, int64_t dstcap) {
  if (nbytes < 0 || nbytes > INT32_MAX - HEADER || typesize < 1 ||
      typesize > 255 || dstcap < nbytes + HEADER)
    return E_ARGS;
  const int64_t blocksize = blocksize_for(nbytes, typesize);
  const int split = typesize <= MAX_SPLITS && blocksize / typesize >= MIN_BUFFERSIZE;
  const int doshuffle = typesize > 1;
  uint8_t flags = (uint8_t)((LZ4_FORMAT << 5) | (doshuffle ? F_SHUFFLE : 0) |
                            (split ? 0 : F_NOSPLIT));
  dst[0] = 2;
  dst[1] = 1;
  dst[2] = flags;
  dst[3] = (uint8_t)typesize;
  wr32(dst + 4, (uint32_t)nbytes);
  wr32(dst + 8, (uint32_t)blocksize);
  if (nbytes < MIN_BUFFERSIZE) return memcpyed(src, nbytes, dst, flags);

  const int64_t nblocks = nbytes / blocksize + (nbytes % blocksize != 0);
  const int64_t leftover = nbytes % blocksize;
  const int64_t limit = nbytes + HEADER; /* a frame must come in under it */
  int64_t pos = HEADER + 4 * nblocks;
  if (pos >= limit) return memcpyed(src, nbytes, dst, flags);
  uint8_t *tmp = doshuffle ? malloc((size_t)blocksize) : NULL;
  if (doshuffle && tmp == NULL) return E_NOMEM;
  for (int64_t j = 0; j < nblocks; ++j) {
    const int short_block = leftover && j == nblocks - 1;
    const int64_t bsize = short_block ? leftover : blocksize;
    const uint8_t *in = src + j * blocksize;
    if (doshuffle) {
      shuffle(typesize, bsize, in, tmp);
      in = tmp;
    }
    wr32(dst + HEADER + 4 * j, (uint32_t)pos);
    const int64_t nsplits = split && !short_block ? typesize : 1;
    const int64_t neblock = bsize / nsplits;
    for (int64_t s = 0; s < nsplits; ++s) {
      if (limit - pos < 4) goto fallback;
      const int64_t room = limit - pos - 4;
      /* A stream compressed to neblock bytes would read as stored. */
      int64_t c = lz4_encode(in + s * neblock, neblock, dst + pos + 4,
                             room < neblock - 1 ? room : neblock - 1);
      if (c < 0) {
        if (neblock > room) goto fallback;
        memcpy(dst + pos + 4, in + s * neblock, (size_t)neblock);
        c = neblock;
      }
      wr32(dst + pos, (uint32_t)c);
      pos += 4 + c;
    }
  }
  free(tmp);
  if (pos >= limit) return memcpyed(src, nbytes, dst, flags);
  wr32(dst + 12, (uint32_t)pos);
  return pos;
fallback:
  free(tmp);
  return memcpyed(src, nbytes, dst, flags);
}

/* A frame of srclen bytes -> exactly dstlen raw bytes at dst: 0, or a
 * negative error code. */
int gol_blosc_decode(const uint8_t *src, int64_t srclen, uint8_t *dst,
                     int64_t dstlen) {
  if (srclen < HEADER) return E_TRUNCATED;
  const unsigned version = src[0], codec_version = src[1], flags = src[2];
  const int64_t typesize = src[3];
  const int64_t nbytes = rd32(src + 4), blocksize = rd32(src + 8),
                cbytes = rd32(src + 12);
  if (version != 2) return E_VERSION;
  if (cbytes != srclen) return E_TRUNCATED;
  if (nbytes != dstlen) return E_NBYTES;
  if (flags & F_BITSHUFFLE) return E_BITSHUFFLE;
  if (flags & F_DELTA) return E_DELTA;
  if (flags & F_MEMCPYED) {
    if (cbytes != nbytes + HEADER) return E_TRUNCATED;
    memcpy(dst, src + HEADER, (size_t)nbytes);
    return 0;
  }
  if ((flags >> 5) != LZ4_FORMAT || codec_version != 1) return E_CODEC;
  if (nbytes == 0) return cbytes == HEADER ? 0 : E_TRUNCATED;
  if (typesize < 1 || blocksize < 1) return E_BLOCKSIZE;
  const int64_t nblocks = nbytes / blocksize + (nbytes % blocksize != 0);
  const int64_t leftover = nbytes % blocksize;
  const int64_t first = HEADER + 4 * nblocks; /* where block data may start */
  if (first > cbytes) return E_OFFSETS;
  const int doshuffle = (flags & F_SHUFFLE) && typesize > 1;
  const int64_t most = blocksize < nbytes ? blocksize : nbytes;
  uint8_t *tmp = doshuffle ? malloc((size_t)most) : NULL;
  if (doshuffle && tmp == NULL) return E_NOMEM;
  int err = 0;
  for (int64_t j = 0; j < nblocks && !err; ++j) {
    const int short_block = leftover && j == nblocks - 1;
    const int64_t bsize = short_block ? leftover : blocksize;
    int64_t pos = rd32(src + HEADER + 4 * j);
    if (pos < first || pos >= cbytes) {
      err = E_OFFSETS;
      break;
    }
    const int64_t nsplits = !(flags & F_NOSPLIT) && !short_block ? typesize : 1;
    if (bsize % nsplits) {
      err = E_BLOCKSIZE;
      break;
    }
    const int64_t neblock = bsize / nsplits;
    uint8_t *out = doshuffle ? tmp : dst + j * blocksize;
    for (int64_t s = 0; s < nsplits; ++s) {
      if (cbytes - pos < 4) {
        err = E_STREAM;
        break;
      }
      const int64_t csize = (int32_t)rd32(src + pos);
      pos += 4;
      if (csize <= 0 || csize > cbytes - pos) {
        err = E_STREAM;
        break;
      }
      if (csize == neblock) {
        memcpy(out + s * neblock, src + pos, (size_t)neblock);
      } else if (lz4_decode(src + pos, csize, out + s * neblock, neblock) !=
                 neblock) {
        err = E_LZ4;
        break;
      }
      pos += csize;
    }
    if (!err && doshuffle) unshuffle(typesize, bsize, tmp, dst + j * blocksize);
  }
  free(tmp);
  return err;
}
