/* TIFF LZW encoding (TIFF 6.0, section 13), for writing test sources.
 *
 * Codes are written most significant bit first, from 9 bits wide; the
 * width grows where the next entry would not fit it (at 512, 1024 and 2048
 * entries, one code before GIF's LZW), and a Clear code (256) restarts the
 * table at 4094 entries, as libtiff's encoder does. The string table is a
 * hash from (prefix code, next byte) to code.
 *
 * With compat set, the pre-1991 form that libtiff still reads
 * (LZWDecodeCompat): codes least significant bit first, the width growing
 * one code later (at 513, 1025 and 2049). */

#include <stddef.h>
#include <stdint.h>
#include <string.h>

#define HSIZE 9001 /* a prime above 2 * 4096 */

typedef struct {
  uint8_t* out;
  size_t pos;
  uint32_t acc;
  int nacc, compat;
} Bits;

static void put(Bits* b, int code, int width) {
  if (b->compat) {
    b->acc |= (uint32_t)code << b->nacc;
    b->nacc += width;
    while (b->nacc >= 8) {
      b->out[b->pos++] = (uint8_t)b->acc;
      b->acc >>= 8;
      b->nacc -= 8;
    }
    return;
  }
  b->acc = (b->acc << width) | (uint32_t)code;
  b->nacc += width;
  while (b->nacc >= 8) {
    b->out[b->pos++] = (uint8_t)(b->acc >> (b->nacc - 8));
    b->nacc -= 8;
  }
}

static void flush(Bits* b) {
  if (b->nacc)
    b->out[b->pos++] =
        (uint8_t)(b->compat ? b->acc : b->acc << (8 - b->nacc));
}

/* After an entry is added: a Clear code where the table is full, else one
 * bit more where the next entry would not fit the width. */
static void grow(Bits* b, int* next, int* width, int32_t* key) {
  if (*next == 4094) {
    put(b, 256, *width);
    if (key) memset(key, -1, HSIZE * sizeof(int32_t));
    *next = 258;
    *width = 9;
  } else if (*next > (1 << *width) - 1 + b->compat) {
    (*width)++;
  }
}

/* Encode n bytes of in into out, which must hold 2 * n + 16 bytes; returns
 * the bytes written. */
size_t lzw_encode(const uint8_t* in, size_t n, uint8_t* out, int compat) {
  static int32_t key[HSIZE];
  static int16_t val[HSIZE];
  Bits b = {out, 0, 0, 0, compat != 0};
  int width = 9, next = 258;
  memset(key, -1, sizeof key);
  put(&b, 256, width);
  if (n > 0) {
    int w = in[0];
    for (size_t i = 1; i < n; i++) {
      int c = in[i];
      int32_t k = (w << 8) | c;
      size_t h = (size_t)k % HSIZE;
      while (key[h] != -1 && key[h] != k) h = (h + 1) % HSIZE;
      if (key[h] == k) {
        w = val[h];
        continue;
      }
      put(&b, w, width);
      key[h] = k;
      val[h] = (int16_t)next++;
      grow(&b, &next, &width, key);
      w = c;
    }
    put(&b, w, width);
    next++;
    grow(&b, &next, &width, NULL);
  }
  put(&b, 257, width);
  flush(&b);
  return b.pos;
}
