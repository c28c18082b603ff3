// JPEG 2000 tier-1 on the host: the MQ arithmetic decoder and the three
// coding passes of a code-block (ISO/IEC 15444-1 Annex C and D), as
// OpenJPEG 2.5's t1.c and mqc.c, the decoder inside cv2.imread, run them
// for code-block style 0 (no bypass, reset, termination, vertically causal
// contexts or segmentation symbols; j2k_decode.h refuses the others):
//   * the MQ decoder reads the code-block's bytes (every layer's chunk,
//     concatenated) with two 0xFF bytes appended, so that a pass read past
//     the end of its data reads 1s (INITDEC, BYTEIN, DECODE, RENORMD);
//   * each bit-plane has a significance propagation pass, a magnitude
//     refinement pass and a cleanup pass (run-length mode on a full stripe
//     column of four with no significant neighbour), the first one a
//     cleanup only; contexts of Tables D.1-D.4, the HL band's zero-coding
//     context with the horizontal and vertical counts swapped;
//   * values are kept, as t1.c keeps them, in halves: a coefficient that
//     turns significant at bit-plane p is (1.5) 2^(p+1), each refinement
//     moves it by 2^p, so that a code-block whose last layer stops above
//     bit-plane 0 reconstructs each coefficient at the midpoint of what
//     its decoded bits leave open.
// j2k_decode.h turns these values into coefficients (halved for the 5/3
// wavelet, times the band's half step for the 9/7 one).

#pragma once

#include <stddef.h>
#include <stdint.h>
#include <string.h>

#include <vector>

namespace j2k_t1 {

// The MQ coder's 47 states (Table C.2): Qe, next state after an MPS and
// after an LPS, and whether an LPS switches the MPS.
static const uint16_t kQe[47] = {
    0x5601, 0x3401, 0x1801, 0x0ac1, 0x0521, 0x0221, 0x5601, 0x5401, 0x4801,
    0x3801, 0x3001, 0x2401, 0x1c01, 0x1601, 0x5601, 0x5401, 0x5101, 0x4801,
    0x3801, 0x3401, 0x3001, 0x2801, 0x2401, 0x2201, 0x1c01, 0x1801, 0x1601,
    0x1401, 0x1201, 0x1101, 0x0ac1, 0x09c1, 0x08a1, 0x0521, 0x0441, 0x02a1,
    0x0221, 0x0141, 0x0111, 0x0085, 0x0049, 0x0025, 0x0015, 0x0009, 0x0005,
    0x0001, 0x5601};
static const uint8_t kNmps[47] = {
    1,  2,  3,  4,  5,  38, 7,  8,  9,  10, 11, 12, 13, 29, 15, 16,
    17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32,
    33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 45, 46};
static const uint8_t kNlps[47] = {
    1,  6,  9,  12, 29, 33, 6,  14, 14, 14, 17, 18, 20, 21, 14, 14,
    15, 16, 17, 18, 19, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29,
    30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 46};
static const uint8_t kSwitch[47] = {1, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0,
                                    0, 0, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                                    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                                    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0};

// contexts: 0-8 zero coding, 9-13 sign, 14-16 refinement, run length,
// uniform
enum { kCtxSc = 9, kCtxMag = 14, kCtxRl = 17, kCtxUni = 18, kCtxs = 19 };

struct Mq {
  const uint8_t* bp;
  uint32_t a, c;
  int ct;
  uint8_t st[kCtxs], mps[kCtxs];

  // data: len bytes followed by two 0xFF bytes
  void init(const uint8_t* data) {
    memset(st, 0, sizeof st);
    memset(mps, 0, sizeof mps);
    st[0] = 4;
    st[kCtxRl] = 3;
    st[kCtxUni] = 46;
    bp = data;
    c = (uint32_t)*bp << 16;
    bytein();
    c <<= 7;
    ct -= 7;
    a = 0x8000;
  }

  inline void bytein() {
    const uint32_t next = bp[1];
    if (*bp == 0xff) {
      if (next > 0x8f) {
        c += 0xff00;
        ct = 8;
      } else {
        bp++;
        c += next << 9;
        ct = 7;
      }
    } else {
      bp++;
      c += next << 8;
      ct = 8;
    }
  }

  inline void renorm() {
    do {
      if (ct == 0) bytein();
      a <<= 1;
      c <<= 1;
      ct--;
    } while (a < 0x8000);
  }

  inline int decode(int cx) {
    const int s = st[cx];
    const uint32_t qe = kQe[s];
    int d;
    a -= qe;
    if ((c >> 16) < qe) {
      if (a < qe) {
        d = mps[cx];
        st[cx] = kNmps[s];
      } else {
        d = 1 - mps[cx];
        if (kSwitch[s]) mps[cx] ^= 1;
        st[cx] = kNlps[s];
      }
      a = qe;
      renorm();
    } else {
      c -= qe << 16;
      if ((a & 0x8000) == 0) {
        if (a < qe) {
          d = 1 - mps[cx];
          if (kSwitch[s]) mps[cx] ^= 1;
          st[cx] = kNlps[s];
        } else {
          d = mps[cx];
          st[cx] = kNmps[s];
        }
        renorm();
      } else {
        d = mps[cx];
      }
    }
    return d;
  }
};

enum { kSig = 1, kNeg = 2, kPi = 4, kMu = 8 };

// One code-block's decoder; its buffers are reused from block to block.
struct Decoder {
  int w = 0, h = 0, stride = 0, band = 0;
  std::vector<uint8_t> flags;  // (h + 2) x (w + 2), a border of zeros
  std::vector<int32_t> data;   // h x w, in halves
  Mq mq;

  inline uint8_t* fl(int x, int y) { return &flags[(y + 1) * stride + x + 1]; }

  inline int zc_context(const uint8_t* f) const {
    const int s = stride;
    int hh = (f[-1] & kSig) + (f[1] & kSig);
    int vv = (f[-s] & kSig) + (f[s] & kSig);
    const int dd = (f[-s - 1] & kSig) + (f[-s + 1] & kSig) +
                   (f[s - 1] & kSig) + (f[s + 1] & kSig);
    if (band == 3) {
      const int hv = hh + vv;
      if (dd >= 3) return 8;
      if (dd == 2) return hv >= 1 ? 7 : 6;
      if (dd == 1) return hv >= 2 ? 5 : hv == 1 ? 4 : 3;
      return hv >= 2 ? 2 : hv == 1 ? 1 : 0;
    }
    if (band == 1) {  // HL: vertical neighbours first
      const int t = hh;
      hh = vv;
      vv = t;
    }
    if (hh == 2) return 8;
    if (hh == 1) return vv >= 1 ? 7 : dd >= 1 ? 6 : 5;
    if (vv == 2) return 4;
    if (vv == 1) return 3;
    return dd >= 2 ? 2 : dd;
  }

  static inline int contribution(uint8_t g) {
    return (g & kSig) ? ((g & kNeg) ? -1 : 1) : 0;
  }

  // the sign's context and the bit it is XORed with (Table D.3)
  inline int sign(const uint8_t* f) {
    const int s = stride;
    int hc = contribution(f[-1]) + contribution(f[1]);
    int vc = contribution(f[-s]) + contribution(f[s]);
    hc = hc < -1 ? -1 : hc > 1 ? 1 : hc;
    vc = vc < -1 ? -1 : vc > 1 ? 1 : vc;
    int x = 0;
    if (hc < 0 || (hc == 0 && vc < 0)) {
      hc = -hc;
      vc = -vc;
      x = 1;
    }
    const int cx = hc == 0 ? kCtxSc + vc : kCtxSc + 3 + vc;
    return mq.decode(cx) ^ x;
  }

  static inline bool any_sig(const uint8_t* f, int s) {
    return ((f[-1] | f[1] | f[-s] | f[s] | f[-s - 1] | f[-s + 1] |
             f[s - 1] | f[s + 1]) & kSig) != 0;
  }

  inline void turn_significant(uint8_t* f, int32_t* d, int32_t oph) {
    const int neg = sign(f);
    *d = neg ? -oph : oph;
    *f |= kSig | (neg ? kNeg : 0);
  }

  void sigpass(int bpp1) {
    const int32_t oph = (1 << bpp1) | ((1 << bpp1) >> 1);
    for (int k = 0; k < h; k += 4)
      for (int x = 0; x < w; x++)
        for (int y = k; y < k + 4 && y < h; y++) {
          uint8_t* f = fl(x, y);
          if ((*f & (kSig | kPi)) || !any_sig(f, stride)) continue;
          if (mq.decode(zc_context(f)))
            turn_significant(f, &data[(size_t)y * w + x], oph);
          *f |= kPi;
        }
  }

  void refpass(int bpp1) {
    const int32_t poshalf = (1 << bpp1) >> 1;
    for (int k = 0; k < h; k += 4)
      for (int x = 0; x < w; x++)
        for (int y = k; y < k + 4 && y < h; y++) {
          uint8_t* f = fl(x, y);
          if ((*f & (kSig | kPi)) != kSig) continue;
          const int cx = (*f & kMu) ? kCtxMag + 2
                         : any_sig(f, stride) ? kCtxMag + 1 : kCtxMag;
          const int v = mq.decode(cx);
          int32_t& d = data[(size_t)y * w + x];
          d += (v ^ (d < 0)) ? poshalf : -poshalf;
          *f |= kMu;
        }
  }

  inline void clean_step(int x, int y, int32_t oph) {
    uint8_t* f = fl(x, y);
    if (!(*f & (kSig | kPi)) && mq.decode(zc_context(f)))
      turn_significant(f, &data[(size_t)y * w + x], oph);
  }

  void clnpass(int bpp1) {
    const int32_t oph = (1 << bpp1) | ((1 << bpp1) >> 1);
    for (int k = 0; k < h; k += 4)
      for (int x = 0; x < w; x++) {
        int y0 = k;
        if (k + 3 < h) {
          bool quiet = true;
          for (int y = k; y < k + 4 && quiet; y++) {
            const uint8_t* f = fl(x, y);
            quiet = !(*f & (kSig | kPi)) && !any_sig(f, stride);
          }
          if (quiet) {
            if (!mq.decode(kCtxRl)) {
              continue;  // no PI flag to clear: none was coded
            }
            int run = mq.decode(kCtxUni) << 1;
            run |= mq.decode(kCtxUni);
            turn_significant(fl(x, k + run), &data[(size_t)(k + run) * w + x],
                             oph);
            y0 = k + run + 1;
          }
        }
        for (int y = y0; y < k + 4 && y < h; y++) clean_step(x, y, oph);
        for (int y = k; y < k + 4 && y < h; y++) *fl(x, y) &= ~kPi;
      }
  }

  // Decode `passes` coding passes of a w x h code-block of `band` (0 LL,
  // 1 HL, 2 LH, 3 HH) whose first cleanup is at bit-plane numbps - 1,
  // from `bytes` (their length, then two 0xFF). Leaves `data` in halves.
  void decode(const uint8_t* bytes, int w_, int h_, int band_, int numbps,
              int passes) {
    w = w_;
    h = h_;
    band = band_;
    stride = w + 2;
    flags.assign((size_t)(h + 2) * stride, 0);
    data.assign((size_t)w * h, 0);
    if (passes <= 0 || numbps <= 0) return;
    mq.init(bytes);
    int bpp1 = numbps, type = 2;
    for (int p = 0; p < passes && bpp1 >= 1; p++) {
      if (type == 0)
        sigpass(bpp1);
      else if (type == 1)
        refpass(bpp1);
      else
        clnpass(bpp1);
      if (++type == 3) {
        type = 0;
        bpp1--;
      }
    }
  }
};

}  // namespace j2k_t1
