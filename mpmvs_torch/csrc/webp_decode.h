// The host half of the card's lossy WebP reads: the RIFF container's VP8
// frame parsed and entropy-decoded as RFC 6386 (the normative VP8
// decoder) and libwebp (dec/vp8_dec.c, tree_dec.c, quant_dec.c), the
// decoder inside cv2.imread, read it, into what vp8_reconstruct_kernel
// (vp8_recon.h) and vp8_loop_filter_kernel (vp8_filter.h) take:
//   * the frame header (section 9): size, colour space and clamping bits,
//     segmentation (quantizer and filter level per segment, absolute or
//     delta, the segment map's tree probabilities), the filter type, level
//     and sharpness with the mode and reference deltas, the token
//     partitions (MB row y reads partition y mod n), the quantizer indices
//     and deltas, the coefficient probability updates and the skip
//     probability;
//   * per macroblock (MB), from the first partition: its segment, its skip
//     flag, the 16x16 luma mode or the 16 sub-block modes (each read with
//     the modes above and to its left as context, section 11.3), the
//     chroma mode; from its token partition, unless skipped, the
//     coefficient tokens of its 25 blocks (section 13) with the non-zero
//     contexts of the blocks above and to the left;
//   * per segment the dequantization factors (section 14.1, quant_dec.c's
//     VP8ParseQuant: y2 DC x 2, y2 AC x 155 / 100 at least 8, uv DC index
//     at most 117, i.e. a factor of at most 132) and the loop filter's
//     limits (frame_dec.c's PrecomputeFilterStrengths: the level with the
//     deltas, the interior limit by sharpness, the high-edge-variance
//     threshold 2 at level 40, 1 at 15, else 0). libwebp filters nothing
//     when the frame's level is 0, whatever the segments' levels.
// The boolean decoder reads past the end of a partition as zeros (libwebp
// too, for the bytes its reader looks ahead); a partition that needs more
// than 2 such bytes is corrupt. The RIFF container is checked in
// mpmvs_torch/io/images.py before this runs, and a lossy first frame of
// an animated file is handed here as a still file of its VP8 chunk; here
// the VP8 chunk is found (a VP8L frame goes to webp_lossless.h).
//
// Errors are 5001-5007 (images.py names each).

#pragma once

#include <stddef.h>
#include <stdint.h>
#include <string.h>

#include "vp8_recon.h"

namespace webp_decode {

enum Err {
  kOk = 0,
  kTruncated = 5001,     // the data ends inside a header or partition
  kMalformed = 5002,     // not RIFF/WEBP, or a chunk out of bounds
  kLossless = 5003,      // a VP8L frame
  kAnimated = 5004,      // ANIM/ANMF chunks
  kNoFrame = 5005,       // no VP8 chunk
  kBadFrame = 5006,      // not a shown key frame, bad start code, 0 size
  kCorrupt = 5007,       // a partition read well past its end
};

// RFC 6386 section 13 (libwebp's tree_dec.c): the coefficients' default
// probabilities, their update probabilities, and the sub-block modes'
// probabilities by the modes above and to the left (libwebp's order of the
// modes, vp8_recon.h).
static const uint8_t kCoeffsProba0[4][8][3][11] = {
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    253, 136, 254, 255, 228, 219, 128, 128, 128, 128, 128,
    189, 129, 242, 255, 227, 213, 255, 219, 128, 128, 128,
    106, 126, 227, 252, 214, 209, 255, 255, 128, 128, 128,
    1, 98, 248, 255, 236, 226, 255, 255, 128, 128, 128,
    181, 133, 238, 254, 221, 234, 255, 154, 128, 128, 128,
    78, 134, 202, 247, 198, 180, 255, 219, 128, 128, 128,
    1, 185, 249, 255, 243, 255, 128, 128, 128, 128, 128,
    184, 150, 247, 255, 236, 224, 128, 128, 128, 128, 128,
    77, 110, 216, 255, 236, 230, 128, 128, 128, 128, 128,
    1, 101, 251, 255, 241, 255, 128, 128, 128, 128, 128,
    170, 139, 241, 252, 236, 209, 255, 255, 128, 128, 128,
    37, 116, 196, 243, 228, 255, 255, 255, 128, 128, 128,
    1, 204, 254, 255, 245, 255, 128, 128, 128, 128, 128,
    207, 160, 250, 255, 238, 128, 128, 128, 128, 128, 128,
    102, 103, 231, 255, 211, 171, 128, 128, 128, 128, 128,
    1, 152, 252, 255, 240, 255, 128, 128, 128, 128, 128,
    177, 135, 243, 255, 234, 225, 128, 128, 128, 128, 128,
    80, 129, 211, 255, 194, 224, 128, 128, 128, 128, 128,
    1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    246, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    198, 35, 237, 223, 193, 187, 162, 160, 145, 155, 62,
    131, 45, 198, 221, 172, 176, 220, 157, 252, 221, 1,
    68, 47, 146, 208, 149, 167, 221, 162, 255, 223, 128,
    1, 149, 241, 255, 221, 224, 255, 255, 128, 128, 128,
    184, 141, 234, 253, 222, 220, 255, 199, 128, 128, 128,
    81, 99, 181, 242, 176, 190, 249, 202, 255, 255, 128,
    1, 129, 232, 253, 214, 197, 242, 196, 255, 255, 128,
    99, 121, 210, 250, 201, 198, 255, 202, 128, 128, 128,
    23, 91, 163, 242, 170, 187, 247, 210, 255, 255, 128,
    1, 200, 246, 255, 234, 255, 128, 128, 128, 128, 128,
    109, 178, 241, 255, 231, 245, 255, 255, 128, 128, 128,
    44, 130, 201, 253, 205, 192, 255, 255, 128, 128, 128,
    1, 132, 239, 251, 219, 209, 255, 165, 128, 128, 128,
    94, 136, 225, 251, 218, 190, 255, 255, 128, 128, 128,
    22, 100, 174, 245, 186, 161, 255, 199, 128, 128, 128,
    1, 182, 249, 255, 232, 235, 128, 128, 128, 128, 128,
    124, 143, 241, 255, 227, 234, 128, 128, 128, 128, 128,
    35, 77, 181, 251, 193, 211, 255, 205, 128, 128, 128,
    1, 157, 247, 255, 236, 231, 255, 255, 128, 128, 128,
    121, 141, 235, 255, 225, 227, 255, 255, 128, 128, 128,
    45, 99, 188, 251, 195, 217, 255, 224, 128, 128, 128,
    1, 1, 251, 255, 213, 255, 128, 128, 128, 128, 128,
    203, 1, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    137, 1, 177, 255, 224, 255, 128, 128, 128, 128, 128,
    253, 9, 248, 251, 207, 208, 255, 192, 128, 128, 128,
    175, 13, 224, 243, 193, 185, 249, 198, 255, 255, 128,
    73, 17, 171, 221, 161, 179, 236, 167, 255, 234, 128,
    1, 95, 247, 253, 212, 183, 255, 255, 128, 128, 128,
    239, 90, 244, 250, 211, 209, 255, 255, 128, 128, 128,
    155, 77, 195, 248, 188, 195, 255, 255, 128, 128, 128,
    1, 24, 239, 251, 218, 219, 255, 205, 128, 128, 128,
    201, 51, 219, 255, 196, 186, 128, 128, 128, 128, 128,
    69, 46, 190, 239, 201, 218, 255, 228, 128, 128, 128,
    1, 191, 251, 255, 255, 128, 128, 128, 128, 128, 128,
    223, 165, 249, 255, 213, 255, 128, 128, 128, 128, 128,
    141, 124, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    1, 16, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    190, 36, 230, 255, 236, 255, 128, 128, 128, 128, 128,
    149, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    1, 226, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    247, 192, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    240, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    1, 134, 252, 255, 255, 128, 128, 128, 128, 128, 128,
    213, 62, 250, 255, 255, 128, 128, 128, 128, 128, 128,
    55, 93, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    202, 24, 213, 235, 186, 191, 220, 160, 240, 175, 255,
    126, 38, 182, 232, 169, 184, 228, 174, 255, 187, 128,
    61, 46, 138, 219, 151, 178, 240, 170, 255, 216, 128,
    1, 112, 230, 250, 199, 191, 247, 159, 255, 255, 128,
    166, 109, 228, 252, 211, 215, 255, 174, 128, 128, 128,
    39, 77, 162, 232, 172, 180, 245, 178, 255, 255, 128,
    1, 52, 220, 246, 198, 199, 249, 220, 255, 255, 128,
    124, 74, 191, 243, 183, 193, 250, 221, 255, 255, 128,
    24, 71, 130, 219, 154, 170, 243, 182, 255, 255, 128,
    1, 182, 225, 249, 219, 240, 255, 224, 128, 128, 128,
    149, 150, 226, 252, 216, 205, 255, 171, 128, 128, 128,
    28, 108, 170, 242, 183, 194, 254, 223, 255, 255, 128,
    1, 81, 230, 252, 204, 203, 255, 192, 128, 128, 128,
    123, 102, 209, 247, 188, 196, 255, 233, 128, 128, 128,
    20, 95, 153, 243, 164, 173, 255, 203, 128, 128, 128,
    1, 222, 248, 255, 216, 213, 128, 128, 128, 128, 128,
    168, 175, 246, 252, 235, 205, 255, 255, 128, 128, 128,
    47, 116, 215, 255, 211, 212, 255, 255, 128, 128, 128,
    1, 121, 236, 253, 212, 214, 255, 255, 128, 128, 128,
    141, 84, 213, 252, 201, 202, 255, 219, 128, 128, 128,
    42, 80, 160, 240, 162, 185, 255, 205, 128, 128, 128,
    1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    244, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    238, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
};

static const uint8_t kCoeffsUpdateProba[4][8][3][11] = {
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    176, 246, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 241, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 244, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    234, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 246, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    239, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 254, 255, 255, 255, 255, 255, 255,
    250, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    217, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    225, 252, 241, 253, 255, 255, 254, 255, 255, 255, 255,
    234, 250, 241, 250, 253, 255, 253, 254, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    238, 253, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    247, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    186, 251, 250, 255, 255, 255, 255, 255, 255, 255, 255,
    234, 251, 244, 254, 255, 255, 255, 255, 255, 255, 255,
    251, 251, 243, 253, 254, 255, 254, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    236, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 253, 253, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 254, 252, 254, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 249, 253, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    246, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 254, 251, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    245, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
};

static const uint8_t kBModesProba[10][10][9] = {
    231, 120, 48, 89, 115, 113, 120, 152, 112,
    152, 179, 64, 126, 170, 118, 46, 70, 95,
    175, 69, 143, 80, 85, 82, 72, 155, 103,
    56, 58, 10, 171, 218, 189, 17, 13, 152,
    114, 26, 17, 163, 44, 195, 21, 10, 173,
    121, 24, 80, 195, 26, 62, 44, 64, 85,
    144, 71, 10, 38, 171, 213, 144, 34, 26,
    170, 46, 55, 19, 136, 160, 33, 206, 71,
    63, 20, 8, 114, 114, 208, 12, 9, 226,
    81, 40, 11, 96, 182, 84, 29, 16, 36,
    134, 183, 89, 137, 98, 101, 106, 165, 148,
    72, 187, 100, 130, 157, 111, 32, 75, 80,
    66, 102, 167, 99, 74, 62, 40, 234, 128,
    41, 53, 9, 178, 241, 141, 26, 8, 107,
    74, 43, 26, 146, 73, 166, 49, 23, 157,
    65, 38, 105, 160, 51, 52, 31, 115, 128,
    104, 79, 12, 27, 217, 255, 87, 17, 7,
    87, 68, 71, 44, 114, 51, 15, 186, 23,
    47, 41, 14, 110, 182, 183, 21, 17, 194,
    66, 45, 25, 102, 197, 189, 23, 18, 22,
    88, 88, 147, 150, 42, 46, 45, 196, 205,
    43, 97, 183, 117, 85, 38, 35, 179, 61,
    39, 53, 200, 87, 26, 21, 43, 232, 171,
    56, 34, 51, 104, 114, 102, 29, 93, 77,
    39, 28, 85, 171, 58, 165, 90, 98, 64,
    34, 22, 116, 206, 23, 34, 43, 166, 73,
    107, 54, 32, 26, 51, 1, 81, 43, 31,
    68, 25, 106, 22, 64, 171, 36, 225, 114,
    34, 19, 21, 102, 132, 188, 16, 76, 124,
    62, 18, 78, 95, 85, 57, 50, 48, 51,
    193, 101, 35, 159, 215, 111, 89, 46, 111,
    60, 148, 31, 172, 219, 228, 21, 18, 111,
    112, 113, 77, 85, 179, 255, 38, 120, 114,
    40, 42, 1, 196, 245, 209, 10, 25, 109,
    88, 43, 29, 140, 166, 213, 37, 43, 154,
    61, 63, 30, 155, 67, 45, 68, 1, 209,
    100, 80, 8, 43, 154, 1, 51, 26, 71,
    142, 78, 78, 16, 255, 128, 34, 197, 171,
    41, 40, 5, 102, 211, 183, 4, 1, 221,
    51, 50, 17, 168, 209, 192, 23, 25, 82,
    138, 31, 36, 171, 27, 166, 38, 44, 229,
    67, 87, 58, 169, 82, 115, 26, 59, 179,
    63, 59, 90, 180, 59, 166, 93, 73, 154,
    40, 40, 21, 116, 143, 209, 34, 39, 175,
    47, 15, 16, 183, 34, 223, 49, 45, 183,
    46, 17, 33, 183, 6, 98, 15, 32, 183,
    57, 46, 22, 24, 128, 1, 54, 17, 37,
    65, 32, 73, 115, 28, 128, 23, 128, 205,
    40, 3, 9, 115, 51, 192, 18, 6, 223,
    87, 37, 9, 115, 59, 77, 64, 21, 47,
    104, 55, 44, 218, 9, 54, 53, 130, 226,
    64, 90, 70, 205, 40, 41, 23, 26, 57,
    54, 57, 112, 184, 5, 41, 38, 166, 213,
    30, 34, 26, 133, 152, 116, 10, 32, 134,
    39, 19, 53, 221, 26, 114, 32, 73, 255,
    31, 9, 65, 234, 2, 15, 1, 118, 73,
    75, 32, 12, 51, 192, 255, 160, 43, 51,
    88, 31, 35, 67, 102, 85, 55, 186, 85,
    56, 21, 23, 111, 59, 205, 45, 37, 192,
    55, 38, 70, 124, 73, 102, 1, 34, 98,
    125, 98, 42, 88, 104, 85, 117, 175, 82,
    95, 84, 53, 89, 128, 100, 113, 101, 45,
    75, 79, 123, 47, 51, 128, 81, 171, 1,
    57, 17, 5, 71, 102, 57, 53, 41, 49,
    38, 33, 13, 121, 57, 73, 26, 1, 85,
    41, 10, 67, 138, 77, 110, 90, 47, 114,
    115, 21, 2, 10, 102, 255, 166, 23, 6,
    101, 29, 16, 10, 85, 128, 101, 196, 26,
    57, 18, 10, 102, 102, 213, 34, 20, 43,
    117, 20, 15, 36, 163, 128, 68, 1, 26,
    102, 61, 71, 37, 34, 53, 31, 243, 192,
    69, 60, 71, 38, 73, 119, 28, 222, 37,
    68, 45, 128, 34, 1, 47, 11, 245, 171,
    62, 17, 19, 70, 146, 85, 55, 62, 70,
    37, 43, 37, 154, 100, 163, 85, 160, 1,
    63, 9, 92, 136, 28, 64, 32, 201, 85,
    75, 15, 9, 9, 64, 255, 184, 119, 16,
    86, 6, 28, 5, 64, 255, 25, 248, 1,
    56, 8, 17, 132, 137, 255, 55, 116, 128,
    58, 15, 20, 82, 135, 57, 26, 121, 40,
    164, 50, 31, 137, 154, 133, 25, 35, 218,
    51, 103, 44, 131, 131, 123, 31, 6, 158,
    86, 40, 64, 135, 148, 224, 45, 183, 128,
    22, 26, 17, 131, 240, 154, 14, 1, 209,
    45, 16, 21, 91, 64, 222, 7, 1, 197,
    56, 21, 39, 155, 60, 138, 23, 102, 213,
    83, 12, 13, 54, 192, 255, 68, 47, 28,
    85, 26, 85, 85, 128, 128, 32, 146, 171,
    18, 11, 7, 63, 144, 171, 4, 4, 246,
    35, 27, 10, 146, 174, 171, 12, 26, 128,
    190, 80, 35, 99, 180, 80, 126, 54, 45,
    85, 126, 47, 87, 176, 51, 41, 20, 32,
    101, 75, 128, 139, 118, 146, 116, 128, 85,
    56, 41, 15, 176, 236, 85, 37, 9, 62,
    71, 30, 17, 119, 118, 255, 17, 18, 138,
    101, 38, 60, 138, 55, 70, 43, 26, 142,
    146, 36, 19, 30, 171, 255, 97, 27, 20,
    138, 45, 61, 62, 219, 1, 81, 188, 64,
    32, 41, 20, 117, 151, 142, 20, 21, 163,
    112, 19, 12, 61, 195, 128, 48, 4, 24,
};

static const uint8_t kDcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17,
    18, 19, 20, 20, 21, 21, 22, 22, 23, 23, 24, 25, 25, 26, 27, 28,
    29, 30, 31, 32, 33, 34, 35, 36, 37, 37, 38, 39, 40, 41, 42, 43,
    44, 45, 46, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58,
    59, 60, 61, 62, 63, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 74,
    75, 76, 76, 77, 78, 79, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89,
    91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108, 110, 112, 114, 116, 118,
    122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151, 154, 157,
};

static const uint16_t kAcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19,
    20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35,
    36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51,
    52, 53, 54, 55, 56, 57, 58, 60, 62, 64, 66, 68, 70, 72, 74, 76,
    78, 80, 82, 84, 86, 88, 90, 92, 94, 96, 98, 100, 102, 104, 106, 108,
    110, 112, 114, 116, 119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149, 152,
    155, 158, 161, 164, 167, 170, 173, 177, 181, 185, 189, 193, 197, 201, 205, 209,
    213, 217, 221, 225, 229, 234, 239, 245, 249, 254, 259, 264, 269, 274, 279, 284,
};

// section 14.1: the dequantization factors by quantizer index
// (kDcTable, kAcTable above)

static const uint8_t kZigzag[16] = {0, 1,  4,  8,  5, 2,  3,  6,
                                    9, 12, 13, 10, 7, 11, 14, 15};
static const uint8_t kBands[17] = {0, 1, 2, 3, 6, 4, 5, 6, 6,
                                   6, 6, 6, 6, 6, 6, 7, 0};
static const uint8_t kCat3[] = {173, 148, 140, 0};
static const uint8_t kCat4[] = {176, 155, 140, 135, 0};
static const uint8_t kCat5[] = {180, 157, 141, 134, 130, 0};
static const uint8_t kCat6[] = {254, 254, 243, 230, 196, 177,
                                153, 140, 133, 130, 129, 0};
static const uint8_t* const kCat3456[] = {kCat3, kCat4, kCat5, kCat6};
// the sub-block mode tree (section 11.2), libwebp's kYModesIntra4
static const int8_t kYModesIntra4[18] = {
    -vp8::kDC, 1, -vp8::kTM, 2, -vp8::kVE, 3, 4, 6, -vp8::kHE, 5,
    -vp8::kRD, -vp8::kVR, -vp8::kLD, 7, -vp8::kVL, 8, -vp8::kHD, -vp8::kHU};

// RFC 6386 section 7.3's boolean decoder; bytes past the end read as 0.
struct BoolDecoder {
  const uint8_t* p;
  const uint8_t* end;
  uint32_t value, range;
  int bit_count, over;

  void init(const uint8_t* start, size_t n) {
    p = start;
    end = start + n;
    over = 0;
    value = next() << 8;
    value |= next();
    range = 255;
    bit_count = 0;
  }
  uint32_t next() {
    if (p < end) return *p++;
    over++;
    return 0;
  }
  int get(int prob) {
    const uint32_t split = 1 + (((range - 1) * (uint32_t)prob) >> 8);
    const uint32_t big = split << 8;
    int bit;
    if (value >= big) {
      bit = 1;
      range -= split;
      value -= big;
    } else {
      bit = 0;
      range = split;
    }
    // the RFC's shifts one bit at a time, a byte read at each 8th, at once
    const int shift = __builtin_clz(range) - 24;
    if (shift > 0) {
      range <<= shift;
      value <<= shift;
      bit_count += shift;
      if (bit_count >= 8) {
        bit_count -= 8;
        value |= next() << bit_count;
      }
    }
    return bit;
  }
  int literal(int bits) {
    int v = 0;
    while (bits-- > 0) v = (v << 1) | get(128);
    return v;
  }
  int signed_literal(int bits) {
    const int v = literal(bits);
    return get(128) ? -v : v;
  }
};

// What the frame header says (webp_host_header's info, in this order).
struct Header {
  int width, height, mb_w, mb_h;
  int filter_type;  // 0 none, 1 simple, 2 normal (libwebp's filter_type_)
  int level, sharpness, partitions;
  int use_segment, update_map, absolute_delta, use_skip_proba;
  int base_q, colorspace, clamp_type, simple;
};

struct Frame {
  Header h;
  int quantizer[4], filter_strength[4];
  int ref_lf_delta[4], mode_lf_delta[4], use_lf_delta;
  uint8_t segment_proba[3];
  int skip_p;
  uint8_t proba[4][8][3][11];
  int dq[4][6];
  int filter[4][2][3];
  BoolDecoder br;  // the first partition, after the header
  BoolDecoder parts[8];
};

static inline int clip(int v, int m) { return v < 0 ? 0 : v > m ? m : v; }

// The payload of the 'VP8 ' chunk of a RIFF/WEBP file (simple or extended
// format).
static int find_vp8(const uint8_t* d, size_t n, const uint8_t** vp8,
                    size_t* len) {
  if (n < 12 || memcmp(d, "RIFF", 4) || memcmp(d + 8, "WEBP", 4))
    return kMalformed;
  size_t pos = 12;
  while (pos + 8 <= n) {
    const uint8_t* c = d + pos;
    const size_t size = c[4] | (c[5] << 8) | (c[6] << 16) | ((size_t)c[7] << 24);
    if (!memcmp(c, "VP8L", 4)) return kLossless;
    if (!memcmp(c, "ANIM", 4) || !memcmp(c, "ANMF", 4)) return kAnimated;
    if (size > n - pos - 8) return kTruncated;
    if (!memcmp(c, "VP8 ", 4)) {
      *vp8 = c + 8;
      *len = size;
      return kOk;
    }
    pos += 8 + size + (size & 1);
  }
  return kNoFrame;
}

// Sections 9.1-9.11 of a key frame's VP8 data, up to the first MB.
static int parse_header(const uint8_t* d, size_t n, Frame* f) {
  memset(f, 0, sizeof(*f));
  Header& h = f->h;
  if (n < 10) return kTruncated;
  const uint32_t bits = d[0] | (d[1] << 8) | (d[2] << 16);
  const int key_frame = !(bits & 1), profile = (bits >> 1) & 7;
  const int show = (bits >> 4) & 1;
  const uint32_t first_len = bits >> 5;
  if (!key_frame || profile > 3 || !show) return kBadFrame;
  if (d[3] != 0x9d || d[4] != 0x01 || d[5] != 0x2a) return kBadFrame;
  h.width = ((d[7] << 8) | d[6]) & 0x3fff;  // the scale bits are ignored
  h.height = ((d[9] << 8) | d[8]) & 0x3fff;
  if (h.width == 0 || h.height == 0) return kBadFrame;
  h.mb_w = (h.width + 15) >> 4;
  h.mb_h = (h.height + 15) >> 4;
  d += 10;
  n -= 10;
  if (first_len > n) return kTruncated;
  BoolDecoder& br = f->br;
  br.init(d, first_len);
  h.colorspace = br.get(128);
  h.clamp_type = br.get(128);
  // segmentation (9.3)
  h.use_segment = br.get(128);
  if (h.use_segment) {
    h.update_map = br.get(128);
    if (br.get(128)) {  // the segments' data
      h.absolute_delta = br.get(128);
      for (int s = 0; s < 4; s++)
        f->quantizer[s] = br.get(128) ? br.signed_literal(7) : 0;
      for (int s = 0; s < 4; s++)
        f->filter_strength[s] = br.get(128) ? br.signed_literal(6) : 0;
    }
    if (h.update_map)
      for (int s = 0; s < 3; s++)
        f->segment_proba[s] = br.get(128) ? (uint8_t)br.literal(8) : 255;
  }
  // the loop filter (9.6)
  h.simple = br.get(128);
  h.level = br.literal(6);
  h.sharpness = br.literal(3);
  f->use_lf_delta = br.get(128);
  if (f->use_lf_delta && br.get(128)) {
    for (int i = 0; i < 4; i++)
      if (br.get(128)) f->ref_lf_delta[i] = br.signed_literal(6);
    for (int i = 0; i < 4; i++)
      if (br.get(128)) f->mode_lf_delta[i] = br.signed_literal(6);
  }
  h.filter_type = h.level == 0 ? 0 : h.simple ? 1 : 2;
  // the token partitions (9.5): 3-byte sizes of all but the last
  h.partitions = 1 << br.literal(2);
  {
    const uint8_t* buf = d + first_len;
    size_t left = n - first_len;
    const size_t last = h.partitions - 1;
    if (left < 3 * last) return kTruncated;
    const uint8_t* sz = buf;
    const uint8_t* start = buf + 3 * last;
    left -= 3 * last;
    for (size_t p = 0; p < last; p++) {
      size_t psize = sz[0] | (sz[1] << 8) | (sz[2] << 16);
      if (psize > left) psize = left;
      f->parts[p].init(start, psize);
      start += psize;
      left -= psize;
      sz += 3;
    }
    if (left == 0) return kTruncated;  // libwebp: the last one is empty
    f->parts[last].init(start, left);
  }
  // the quantizers (9.6, 14.1)
  h.base_q = br.literal(7);
  const int dqy1_dc = br.get(128) ? br.signed_literal(4) : 0;
  const int dqy2_dc = br.get(128) ? br.signed_literal(4) : 0;
  const int dqy2_ac = br.get(128) ? br.signed_literal(4) : 0;
  const int dquv_dc = br.get(128) ? br.signed_literal(4) : 0;
  const int dquv_ac = br.get(128) ? br.signed_literal(4) : 0;
  for (int s = 0; s < 4; s++) {
    int q = h.base_q;
    if (h.use_segment) {
      q = f->quantizer[s] + (h.absolute_delta ? 0 : h.base_q);
    } else if (s > 0) {
      memcpy(f->dq[s], f->dq[0], sizeof(f->dq[0]));
      continue;
    }
    int* m = f->dq[s];
    m[0] = kDcTable[clip(q + dqy1_dc, 127)];
    m[1] = kAcTable[clip(q, 127)];
    m[2] = kDcTable[clip(q + dqy2_dc, 127)] * 2;
    // x * 155 / 100 as libwebp computes it, (x * 101581) >> 16
    m[3] = (kAcTable[clip(q + dqy2_ac, 127)] * 101581) >> 16;
    if (m[3] < 8) m[3] = 8;
    m[4] = kDcTable[clip(q + dquv_dc, 117)];
    m[5] = kAcTable[clip(q + dquv_ac, 127)];
  }
  br.get(128);  // refresh_entropy_probs: one frame, ignored
  // the coefficient probabilities (13.4) and the skip probability (9.11)
  for (int t = 0; t < 4; t++)
    for (int b = 0; b < 8; b++)
      for (int c = 0; c < 3; c++)
        for (int p = 0; p < 11; p++)
          f->proba[t][b][c][p] = br.get(kCoeffsUpdateProba[t][b][c][p])
                                     ? (uint8_t)br.literal(8)
                                     : kCoeffsProba0[t][b][c][p];
  h.use_skip_proba = br.get(128);
  if (h.use_skip_proba) f->skip_p = br.literal(8);
  // the filter's limits per segment and form (PrecomputeFilterStrengths)
  for (int s = 0; s < 4; s++) {
    int base = h.level;
    if (h.use_segment)
      base = f->filter_strength[s] + (h.absolute_delta ? 0 : h.level);
    for (int i4x4 = 0; i4x4 <= 1; i4x4++) {
      int level = base;
      if (f->use_lf_delta) {
        level += f->ref_lf_delta[0];
        if (i4x4) level += f->mode_lf_delta[0];
      }
      level = clip(level, 63);
      int* fl = f->filter[s][i4x4];
      fl[0] = fl[1] = fl[2] = 0;
      if (level > 0 && h.filter_type > 0) {
        int ilevel = level;
        if (h.sharpness > 0) {
          ilevel >>= h.sharpness > 4 ? 2 : 1;
          if (ilevel > 9 - h.sharpness) ilevel = 9 - h.sharpness;
        }
        if (ilevel < 1) ilevel = 1;
        fl[0] = 2 * level + ilevel;
        fl[1] = ilevel;
        fl[2] = level >= 40 ? 2 : level >= 15 ? 1 : 0;
      }
    }
  }
  return br.over > 2 ? kCorrupt : kOk;
}

// libwebp's GetLargeValue: a token's value from DCT_CAT1 up.
static int large_value(BoolDecoder& br, const uint8_t* p) {
  int v;
  if (!br.get(p[3])) {
    v = !br.get(p[4]) ? 2 : 3 + br.get(p[5]);
  } else if (!br.get(p[6])) {
    if (!br.get(p[7])) {
      v = 5 + br.get(159);
    } else {
      v = 7 + 2 * br.get(165);
      v += br.get(145);
    }
  } else {
    const int bit1 = br.get(p[8]);
    const int bit0 = br.get(p[9 + bit1]);
    const int cat = 2 * bit1 + bit0;
    v = 0;
    for (const uint8_t* tab = kCat3456[cat]; *tab; ++tab)
      v += v + br.get(*tab);
    v += 3 + (8 << cat);
  }
  return v;
}

// libwebp's GetCoeffs: the tokens of one block of type t from position n
// with context ctx, as signed levels at their natural positions in out.
// Returns the position after the last token read (16 at most).
static int get_coeffs(BoolDecoder& br, const uint8_t (*band)[3][11], int ctx,
                      int n, int16_t* out) {
  const uint8_t* p = band[kBands[n]][ctx];
  for (; n < 16; ++n) {
    if (!br.get(p[0])) return n;  // end of block
    while (!br.get(p[1])) {       // zeros
      if (++n == 16) return 16;
      p = band[kBands[n]][0];
    }
    int v;
    if (!br.get(p[2])) {
      v = 1;
      p = band[kBands[n + 1]][1];
    } else {
      v = large_value(br, p);
      p = band[kBands[n + 1]][2];
    }
    out[kZigzag[n]] = (int16_t)(br.get(128) ? -v : v);
  }
  return 16;
}

// The contexts carried across MBs: the modes and non-zero flags of the
// blocks above (a row of MBs) and to the left.
struct Contexts {
  uint8_t* intra_t;  // 4 per MB column
  uint8_t* nz_t;     // 9 per MB column: 4 Y, 2 U, 2 V, Y2
  uint8_t intra_l[4];
  uint8_t nz_l[9];
};

// The modes of MB (mbx) of the current row, from the first partition
// (libwebp's ParseIntraMode). Fills flags and the sub-block modes.
static void parse_modes(Frame* f, Contexts& cx, int mbx, vp8::Record& rec,
                        int* skip) {
  BoolDecoder& br = f->br;
  int segment = 0;
  if (f->h.update_map)
    segment = !br.get(f->segment_proba[0]) ? br.get(f->segment_proba[1])
                                           : br.get(f->segment_proba[2]) + 2;
  *skip = f->h.use_skip_proba ? br.get(f->skip_p) : 0;
  uint8_t* top = cx.intra_t + 4 * mbx;
  uint8_t* left = cx.intra_l;
  const int i4x4 = !br.get(145);
  rec.flags = i4x4 | (segment << vp8::kSegmentShift);
  rec.modes_lo = rec.modes_hi = 0;
  if (!i4x4) {
    const int ymode = br.get(156) ? (br.get(128) ? vp8::kTM : vp8::kHE)
                                  : (br.get(163) ? vp8::kVE : vp8::kDC);
    rec.flags |= ymode << vp8::kYModeShift;
    memset(top, ymode, 4);
    memset(left, ymode, 4);
  } else {
    for (int y = 0; y < 4; y++) {
      int ymode = left[y];
      for (int x = 0; x < 4; x++) {
        const uint8_t* prob = kBModesProba[top[x]][ymode];
        int i = kYModesIntra4[br.get(prob[0])];
        while (i > 0) i = kYModesIntra4[2 * i + br.get(prob[i])];
        ymode = -i;
        top[x] = (uint8_t)ymode;
        const int n = 4 * y + x;
        (n < 8 ? rec.modes_lo : rec.modes_hi) |= ymode << (4 * (n & 7));
      }
      left[y] = (uint8_t)ymode;
    }
  }
  const int uvmode = !br.get(142) ? vp8::kDC
                     : !br.get(114) ? vp8::kVE
                     : br.get(183) ? vp8::kTM : vp8::kHE;
  rec.flags |= uvmode << vp8::kUVModeShift;
}

// The coefficients of one MB from its token partition (libwebp's
// ParseResiduals), as levels in coef (25 x 16, zeroed); sets rec.nz to
// libwebp's non-zero codes, a bit a block (a token past its first
// position, or a non-zero dequantized DC: for a 16x16 MB the WHT's).
static void parse_residuals(Frame* f, Contexts& cx, BoolDecoder& br,
                            int mbx, vp8::Record& rec, int16_t* coef) {
  uint8_t* tnz = cx.nz_t + 9 * mbx;
  uint8_t* lnz = cx.nz_l;
  const int seg = (rec.flags >> vp8::kSegmentShift) & 3;
  const int* dq = f->dq[seg];
  const int i4x4 = rec.flags & vp8::kI4x4;
  int16_t dc[16] = {0};
  int first = 0;
  const uint8_t (*ac)[3][11] = f->proba[3];
  if (!i4x4) {
    const int ctx = tnz[8] + lnz[8];
    const int nz = get_coeffs(br, f->proba[1], ctx, 0, coef);
    tnz[8] = lnz[8] = nz > 0;
    int16_t y2[16];
    for (int k = 0; k < 16; k++)
      y2[k] = (int16_t)(coef[k] * (k == 0 ? dq[2] : dq[3]));
    vp8::iwht(y2, dc);
    first = 1;
    ac = f->proba[0];
  }
  int32_t bits = 0;
  for (int y = 0; y < 4; y++) {
    for (int x = 0; x < 4; x++) {
      const int ctx = lnz[y] + tnz[x];
      int16_t* out = coef + 16 * (1 + 4 * y + x);
      const int nz = get_coeffs(br, ac, ctx, first, out);
      lnz[y] = tnz[x] = nz > first;
      const int dc_nz = first ? dc[4 * y + x] != 0
                              : (int16_t)(out[0] * dq[0]) != 0;
      if (nz > 1 || dc_nz) bits |= 1 << (4 * y + x);
    }
  }
  for (int ch = 0; ch < 2; ch++) {
    for (int y = 0; y < 2; y++) {
      for (int x = 0; x < 2; x++) {
        const int ctx = lnz[4 + 2 * ch + y] + tnz[4 + 2 * ch + x];
        int16_t* out = coef + 16 * (17 + 4 * ch + 2 * y + x);
        const int nz = get_coeffs(br, f->proba[2], ctx, 0, out);
        lnz[4 + 2 * ch + y] = tnz[4 + 2 * ch + x] = nz > 0;
        if (nz > 1 || (int16_t)(out[0] * dq[4]) != 0)
          bits |= 1 << (16 + 4 * ch + 2 * y + x);
      }
    }
  }
  rec.nz = bits;
}

// Every MB's record and coefficients, in raster order (libwebp's
// ParseFrame: a row's modes, then its tokens, MB by MB).
static int decode_frame(Frame* f, vp8::Record* records, int16_t* coefs) {
  const int mb_w = f->h.mb_w, mb_h = f->h.mb_h;
  uint8_t* top = new uint8_t[13 * (size_t)mb_w];
  Contexts cx;
  cx.intra_t = top;
  cx.nz_t = top + 4 * (size_t)mb_w;
  memset(cx.intra_t, vp8::kDC, 4 * (size_t)mb_w);
  memset(cx.nz_t, 0, 9 * (size_t)mb_w);
  int err = kOk;
  for (int mby = 0; mby < mb_h && err == kOk; mby++) {
    memset(cx.intra_l, vp8::kDC, 4);
    memset(cx.nz_l, 0, 9);
    BoolDecoder& tokens = f->parts[mby & (f->h.partitions - 1)];
    for (int mbx = 0; mbx < mb_w; mbx++) {
      const size_t i = (size_t)mby * mb_w + mbx;
      vp8::Record& rec = records[i];
      int skip;
      parse_modes(f, cx, mbx, rec, &skip);
      if (!skip) {
        parse_residuals(f, cx, tokens, mbx, rec, coefs + vp8::kCoefsPerMB * i);
      } else {
        memset(cx.nz_t + 9 * mbx, 0, 8);
        memset(cx.nz_l, 0, 8);
        if (!(rec.flags & vp8::kI4x4)) cx.nz_t[9 * mbx + 8] = cx.nz_l[8] = 0;
        rec.nz = 0;
      }
      // inner edges: sub-block modes, or any coefficients (libwebp's
      // f_inner_ |= !skip, skip being "no non-zero codes")
      if ((rec.flags & vp8::kI4x4) || rec.nz) rec.flags |= vp8::kInner;
    }
    if (tokens.over > 2 || f->br.over > 2) err = kCorrupt;
  }
  delete[] top;
  return err;
}

}  // namespace webp_decode

// The frame header of a WebP file's VP8 chunk: info receives
// 16 ints (webp_decode::Header's fields in order).
extern "C" int webp_host_header(const unsigned char* data, size_t length,
                                int* info) {
  const uint8_t* vp8;
  size_t len;
  int err = webp_decode::find_vp8(data, length, &vp8, &len);
  if (err) return err;
  webp_decode::Frame* f = new webp_decode::Frame();
  err = webp_decode::parse_header(vp8, len, f);
  if (!err) memcpy(info, &f->h, sizeof(f->h));
  delete f;
  return err;
}

// Decode a WebP file's VP8 frame on the host: records (mb_w * mb_h x 4
// int32), coefs (mb_w * mb_h x 25 x 16 int16, zeroed by the caller) and
// params (49 ints: vp8_recon.h's Params).
extern "C" int webp_host_decode(const unsigned char* data, size_t length,
                                int* records, short* coefs, int* params) {
  const uint8_t* vp8;
  size_t len;
  int err = webp_decode::find_vp8(data, length, &vp8, &len);
  if (err) return err;
  webp_decode::Frame* f = new webp_decode::Frame();
  err = webp_decode::parse_header(vp8, len, f);
  if (!err) {
    memcpy(params, f->dq, sizeof(f->dq));
    memcpy(params + 24, f->filter, sizeof(f->filter));
    params[48] = f->h.filter_type;
    err = webp_decode::decode_frame(f, (vp8::Record*)records, coefs);
  }
  delete f;
  return err;
}
