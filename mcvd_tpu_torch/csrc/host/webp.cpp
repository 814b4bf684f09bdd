// A decoder of lossy WebP (a RIFF file holding one VP8 key frame, simple or
// in a VP8X container whose ALPH chunk is skipped) that gives libwebp's RGB
// output bit for bit, as PIL's `Image.open(...).convert("RGB")` reads it:
// convert("RGB") drops alpha, and libwebp's RGB does not depend on it.
//
// The stream is RFC 6386's: the boolean entropy decoder; the frame header
// (segments with their quantizer and filter-level updates, the loop filter's
// type, level, sharpness and reference/mode deltas, the token partitions);
// the default coefficient probabilities and their updates; the key-frame
// intra modes (16x16, 4x4 with its ten modes in context of the neighbours',
// chroma) and the residual tokens in four block types; dequantisation, the
// inverse WHT of the 16x16 DCs and the inverse DCT. Prediction, the
// reconstruction buffer's edges (127 above the picture, 129 left of it, the
// above-right samples of a macroblock's right column), the simple and normal
// loop filters and the RGB output follow libwebp's C code (dsp/dec.c,
// dec/frame_dec.c, dsp/upsampling.c): its "fancy" chroma upsampler and its
// 14-bit YUV->RGB (yuv.h's MultHi constants). The tables below are RFC 6386's
// (coefficient probabilities and their update probabilities, the key-frame
// 4x4 mode probabilities in libwebp's mode order, the DC and AC quantizer
// steps). Lossless (VP8L) and animated files are refused with their own codes.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

const uint8_t kCoeffsProba0[1056] = {
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
const uint8_t kCoeffsUpdateProba[1056] = {
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
const uint8_t kBModesProba[900] = {
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
const uint8_t kDcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17,
    18, 19, 20, 20, 21, 21, 22, 22, 23, 23, 24, 25, 25, 26, 27, 28,
    29, 30, 31, 32, 33, 34, 35, 36, 37, 37, 38, 39, 40, 41, 42, 43,
    44, 45, 46, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58,
    59, 60, 61, 62, 63, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 74,
    75, 76, 76, 77, 78, 79, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89,
    91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108, 110, 112, 114, 116, 118,
    122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151, 154, 157,
};
const uint16_t kAcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19,
    20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35,
    36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51,
    52, 53, 54, 55, 56, 57, 58, 60, 62, 64, 66, 68, 70, 72, 74, 76,
    78, 80, 82, 84, 86, 88, 90, 92, 94, 96, 98, 100, 102, 104, 106, 108,
    110, 112, 114, 116, 119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149, 152,
    155, 158, 161, 164, 167, 170, 173, 177, 181, 185, 189, 193, 197, 201, 205, 209,
    213, 217, 221, 225, 229, 234, 239, 245, 249, 254, 259, 264, 269, 274, 279, 284,
};

const uint8_t kBands[17] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0};
const uint8_t kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};
const uint8_t kCat3[] = {173, 148, 140, 0};
const uint8_t kCat4[] = {176, 155, 140, 135, 0};
const uint8_t kCat5[] = {180, 157, 141, 134, 130, 0};
const uint8_t kCat6[] = {254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129, 0};
const uint8_t* const kCat3456[] = {kCat3, kCat4, kCat5, kCat6};

// libwebp's intra modes: B_DC_PRED, B_TM_PRED, B_VE_PRED, B_HE_PRED,
// B_RD_PRED, B_VR_PRED, B_LD_PRED, B_VL_PRED, B_HD_PRED, B_HU_PRED; the 16x16
// and chroma modes DC, TM, V, H are the first four, and 4, 5, 6 are DC
// without top, without left, without either.
enum { B_DC, B_TM, B_VE, B_HE, B_RD, B_VR, B_LD, B_VL, B_HD, B_HU };
enum { DC_NOTOP = 4, DC_NOLEFT = 5, DC_NOTOPLEFT = 6 };
const int8_t kYModesIntra4[18] = {-B_DC, 1, -B_TM, 2, -B_VE, 3, 4, 6, -B_HE, 5,
                                  -B_RD, -B_VR, -B_LD, 7, -B_VL, 8, -B_HD, -B_HU};

// RFC 6386's boolean decoder (libwebp's keeps range - 1 and many bits at
// once; the bits are the same).
struct BoolDec {
  const uint8_t* p = nullptr;
  const uint8_t* end = nullptr;
  uint32_t value = 0;
  uint32_t range = 255;
  int bit_count = 0;

  int next() { return p < end ? *p++ : 0; }
  void init(const uint8_t* b, size_t n) {
    p = b;
    end = b + n;
    value = uint32_t(next()) << 8;
    value |= uint32_t(next());
    range = 255;
    bit_count = 0;
  }
  int get(int prob) {
    const uint32_t split = 1 + (((range - 1) * uint32_t(prob)) >> 8);
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
    while (range < 128) {
      value <<= 1;
      range <<= 1;
      if (++bit_count == 8) {
        bit_count = 0;
        value |= uint32_t(next());
      }
    }
    return bit;
  }
  int literal(int bits) {
    int v = 0;
    while (bits-- > 0) v = (v << 1) | get(128);
    return v;
  }
  int signed_value(int bits) {
    const int v = literal(bits);
    return get(128) ? -v : v;
  }
};

constexpr int BPS = 32;
constexpr int Y_OFF = BPS * 1 + 8;
constexpr int U_OFF = Y_OFF + BPS * 16 + BPS;
constexpr int V_OFF = U_OFF + 16;
constexpr int YUV_SIZE = BPS * 17 + BPS * 9;

inline uint8_t clip8(int v) { return uint8_t(v < 0 ? 0 : v > 255 ? 255 : v); }
inline int sclip1(int v) { return v < -128 ? -128 : v > 127 ? 127 : v; }
inline int sclip2(int v) { return v < -16 ? -16 : v > 15 ? 15 : v; }

// ---- transforms (libwebp dsp/dec.c) ----
inline int mul1(int a) { return ((a * 20091) >> 16) + a; }
inline int mul2(int a) { return (a * 35468) >> 16; }

void transform_one(const int16_t* in, uint8_t* dst) {
  int C[16], *tmp = C;
  for (int i = 0; i < 4; ++i) {
    const int a = in[0] + in[8];
    const int b = in[0] - in[8];
    const int c = mul2(in[4]) - mul1(in[12]);
    const int d = mul1(in[4]) + mul2(in[12]);
    tmp[0] = a + d;
    tmp[1] = b + c;
    tmp[2] = b - c;
    tmp[3] = a - d;
    tmp += 4;
    in++;
  }
  tmp = C;
  for (int i = 0; i < 4; ++i) {
    const int dc = tmp[0] + 4;
    const int a = dc + tmp[8];
    const int b = dc - tmp[8];
    const int c = mul2(tmp[4]) - mul1(tmp[12]);
    const int d = mul1(tmp[4]) + mul2(tmp[12]);
    dst[0] = clip8(dst[0] + ((a + d) >> 3));
    dst[1] = clip8(dst[1] + ((b + c) >> 3));
    dst[2] = clip8(dst[2] + ((b - c) >> 3));
    dst[3] = clip8(dst[3] + ((a - d) >> 3));
    tmp++;
    dst += BPS;
  }
}

void transform_wht(const int16_t* in, int16_t* out) {
  int tmp[16];
  for (int i = 0; i < 4; ++i) {
    const int a0 = in[0 + i] + in[12 + i];
    const int a1 = in[4 + i] + in[8 + i];
    const int a2 = in[4 + i] - in[8 + i];
    const int a3 = in[0 + i] - in[12 + i];
    tmp[0 + i] = a0 + a1;
    tmp[8 + i] = a0 - a1;
    tmp[4 + i] = a3 + a2;
    tmp[12 + i] = a3 - a2;
  }
  for (int i = 0; i < 4; ++i) {
    const int dc = tmp[0 + i * 4] + 3;
    const int a0 = dc + tmp[3 + i * 4];
    const int a1 = tmp[1 + i * 4] + tmp[2 + i * 4];
    const int a2 = tmp[1 + i * 4] - tmp[2 + i * 4];
    const int a3 = dc - tmp[3 + i * 4];
    out[0] = int16_t((a0 + a1) >> 3);
    out[16] = int16_t((a3 + a2) >> 3);
    out[32] = int16_t((a0 - a1) >> 3);
    out[48] = int16_t((a3 - a2) >> 3);
    out += 64;
  }
}

inline bool any_nonzero(const int16_t* c) {
  for (int i = 0; i < 16; ++i)
    if (c[i]) return true;
  return false;
}

// ---- intra predictors (libwebp dsp/dec.c) ----
#define DST(x, y) dst[(x) + (y) * BPS]
#define AVG3(a, b, c) (uint8_t)(((a) + 2 * (b) + (c) + 2) >> 2)
#define AVG2(a, b) (((a) + (b) + 1) >> 1)

void true_motion(uint8_t* dst, int size) {
  const uint8_t* top = dst - BPS;
  const int tl = top[-1];
  for (int y = 0; y < size; ++y) {
    const int l = dst[-1];
    for (int x = 0; x < size; ++x) dst[x] = clip8(top[x] + l - tl);
    dst += BPS;
  }
}

void fill(uint8_t* dst, int v, int size) {
  for (int j = 0; j < size; ++j) memset(dst + j * BPS, v, size);
}

void pred16(uint8_t* dst, int mode) {
  int DC;
  switch (mode) {
    case B_DC:
      DC = 16;
      for (int j = 0; j < 16; ++j) DC += dst[-1 + j * BPS] + dst[j - BPS];
      fill(dst, DC >> 5, 16);
      break;
    case B_TM: true_motion(dst, 16); break;
    case B_VE:
      for (int j = 0; j < 16; ++j) memcpy(dst + j * BPS, dst - BPS, 16);
      break;
    case B_HE:
      for (int j = 0; j < 16; ++j) memset(dst + j * BPS, dst[j * BPS - 1], 16);
      break;
    case DC_NOTOP:
      DC = 8;
      for (int j = 0; j < 16; ++j) DC += dst[-1 + j * BPS];
      fill(dst, DC >> 4, 16);
      break;
    case DC_NOLEFT:
      DC = 8;
      for (int i = 0; i < 16; ++i) DC += dst[i - BPS];
      fill(dst, DC >> 4, 16);
      break;
    default: fill(dst, 0x80, 16); break;
  }
}

void pred8uv(uint8_t* dst, int mode) {
  int dc0;
  switch (mode) {
    case B_DC:
      dc0 = 8;
      for (int i = 0; i < 8; ++i) dc0 += dst[i - BPS] + dst[-1 + i * BPS];
      fill(dst, dc0 >> 4, 8);
      break;
    case B_TM: true_motion(dst, 8); break;
    case B_VE:
      for (int j = 0; j < 8; ++j) memcpy(dst + j * BPS, dst - BPS, 8);
      break;
    case B_HE:
      for (int j = 0; j < 8; ++j) memset(dst + j * BPS, dst[j * BPS - 1], 8);
      break;
    case DC_NOTOP:
      dc0 = 4;
      for (int i = 0; i < 8; ++i) dc0 += dst[-1 + i * BPS];
      fill(dst, dc0 >> 3, 8);
      break;
    case DC_NOLEFT:
      dc0 = 4;
      for (int i = 0; i < 8; ++i) dc0 += dst[i - BPS];
      fill(dst, dc0 >> 3, 8);
      break;
    default: fill(dst, 0x80, 8); break;
  }
}

void pred4(uint8_t* dst, int mode) {
  const uint8_t* top = dst - BPS;
  switch (mode) {
    case B_DC: {
      uint32_t dc = 4;
      for (int i = 0; i < 4; ++i) dc += dst[i - BPS] + dst[-1 + i * BPS];
      fill(dst, int(dc >> 3), 4);
      break;
    }
    case B_TM: true_motion(dst, 4); break;
    case B_VE: {
      const uint8_t vals[4] = {AVG3(top[-1], top[0], top[1]), AVG3(top[0], top[1], top[2]),
                               AVG3(top[1], top[2], top[3]), AVG3(top[2], top[3], top[4])};
      for (int i = 0; i < 4; ++i) memcpy(dst + i * BPS, vals, 4);
      break;
    }
    case B_HE: {
      const int A = dst[-1 - BPS], B = dst[-1], C = dst[-1 + BPS], D = dst[-1 + 2 * BPS],
                E = dst[-1 + 3 * BPS];
      memset(dst + 0 * BPS, AVG3(A, B, C), 4);
      memset(dst + 1 * BPS, AVG3(B, C, D), 4);
      memset(dst + 2 * BPS, AVG3(C, D, E), 4);
      memset(dst + 3 * BPS, AVG3(D, E, E), 4);
      break;
    }
    case B_RD: {
      const int I = dst[-1 + 0 * BPS], J = dst[-1 + 1 * BPS], K = dst[-1 + 2 * BPS],
                L = dst[-1 + 3 * BPS], X = dst[-1 - BPS], A = dst[0 - BPS], B = dst[1 - BPS],
                C = dst[2 - BPS], D = dst[3 - BPS];
      DST(0, 3) = AVG3(J, K, L);
      DST(1, 3) = DST(0, 2) = AVG3(I, J, K);
      DST(2, 3) = DST(1, 2) = DST(0, 1) = AVG3(X, I, J);
      DST(3, 3) = DST(2, 2) = DST(1, 1) = DST(0, 0) = AVG3(A, X, I);
      DST(3, 2) = DST(2, 1) = DST(1, 0) = AVG3(B, A, X);
      DST(3, 1) = DST(2, 0) = AVG3(C, B, A);
      DST(3, 0) = AVG3(D, C, B);
      break;
    }
    case B_LD: {
      const int A = dst[0 - BPS], B = dst[1 - BPS], C = dst[2 - BPS], D = dst[3 - BPS],
                E = dst[4 - BPS], F = dst[5 - BPS], G = dst[6 - BPS], H = dst[7 - BPS];
      DST(0, 0) = AVG3(A, B, C);
      DST(1, 0) = DST(0, 1) = AVG3(B, C, D);
      DST(2, 0) = DST(1, 1) = DST(0, 2) = AVG3(C, D, E);
      DST(3, 0) = DST(2, 1) = DST(1, 2) = DST(0, 3) = AVG3(D, E, F);
      DST(3, 1) = DST(2, 2) = DST(1, 3) = AVG3(E, F, G);
      DST(3, 2) = DST(2, 3) = AVG3(F, G, H);
      DST(3, 3) = AVG3(G, H, H);
      break;
    }
    case B_VR: {
      const int I = dst[-1 + 0 * BPS], J = dst[-1 + 1 * BPS], K = dst[-1 + 2 * BPS],
                X = dst[-1 - BPS], A = dst[0 - BPS], B = dst[1 - BPS], C = dst[2 - BPS],
                D = dst[3 - BPS];
      DST(0, 0) = DST(1, 2) = AVG2(X, A);
      DST(1, 0) = DST(2, 2) = AVG2(A, B);
      DST(2, 0) = DST(3, 2) = AVG2(B, C);
      DST(3, 0) = AVG2(C, D);
      DST(0, 3) = AVG3(K, J, I);
      DST(0, 2) = AVG3(J, I, X);
      DST(0, 1) = DST(1, 3) = AVG3(I, X, A);
      DST(1, 1) = DST(2, 3) = AVG3(X, A, B);
      DST(2, 1) = DST(3, 3) = AVG3(A, B, C);
      DST(3, 1) = AVG3(B, C, D);
      break;
    }
    case B_VL: {
      const int A = dst[0 - BPS], B = dst[1 - BPS], C = dst[2 - BPS], D = dst[3 - BPS],
                E = dst[4 - BPS], F = dst[5 - BPS], G = dst[6 - BPS], H = dst[7 - BPS];
      DST(0, 0) = AVG2(A, B);
      DST(1, 0) = DST(0, 2) = AVG2(B, C);
      DST(2, 0) = DST(1, 2) = AVG2(C, D);
      DST(3, 0) = DST(2, 2) = AVG2(D, E);
      DST(0, 1) = AVG3(A, B, C);
      DST(1, 1) = DST(0, 3) = AVG3(B, C, D);
      DST(2, 1) = DST(1, 3) = AVG3(C, D, E);
      DST(3, 1) = DST(2, 3) = AVG3(D, E, F);
      DST(3, 2) = AVG3(E, F, G);
      DST(3, 3) = AVG3(F, G, H);
      break;
    }
    case B_HU: {
      const int I = dst[-1 + 0 * BPS], J = dst[-1 + 1 * BPS], K = dst[-1 + 2 * BPS],
                L = dst[-1 + 3 * BPS];
      DST(0, 0) = AVG2(I, J);
      DST(2, 0) = DST(0, 1) = AVG2(J, K);
      DST(2, 1) = DST(0, 2) = AVG2(K, L);
      DST(1, 0) = AVG3(I, J, K);
      DST(3, 0) = DST(1, 1) = AVG3(J, K, L);
      DST(3, 1) = DST(1, 2) = AVG3(K, L, L);
      DST(3, 2) = DST(2, 2) = DST(0, 3) = DST(1, 3) = DST(2, 3) = DST(3, 3) = L;
      break;
    }
    default: {   // B_HD
      const int I = dst[-1 + 0 * BPS], J = dst[-1 + 1 * BPS], K = dst[-1 + 2 * BPS],
                L = dst[-1 + 3 * BPS], X = dst[-1 - BPS], A = dst[0 - BPS], B = dst[1 - BPS],
                C = dst[2 - BPS];
      DST(0, 0) = DST(2, 1) = AVG2(I, X);
      DST(0, 1) = DST(2, 2) = AVG2(J, I);
      DST(0, 2) = DST(2, 3) = AVG2(K, J);
      DST(0, 3) = AVG2(L, K);
      DST(3, 0) = AVG3(A, B, C);
      DST(2, 0) = AVG3(X, A, B);
      DST(1, 0) = DST(3, 1) = AVG3(I, X, A);
      DST(1, 1) = DST(3, 2) = AVG3(J, I, X);
      DST(1, 2) = DST(3, 3) = AVG3(K, J, I);
      DST(1, 3) = AVG3(L, K, J);
      break;
    }
  }
}
#undef DST
#undef AVG3
#undef AVG2

// ---- loop filter (libwebp dsp/dec.c) ----
inline void do_filter2(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0) + sclip1(p1 - q1);
  const int a1 = sclip2((a + 4) >> 3);
  const int a2 = sclip2((a + 3) >> 3);
  p[-step] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
}
inline void do_filter4(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0);
  const int a1 = sclip2((a + 4) >> 3);
  const int a2 = sclip2((a + 3) >> 3);
  const int a3 = (a1 + 1) >> 1;
  p[-2 * step] = clip8(p1 + a3);
  p[-step] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
  p[step] = clip8(q1 - a3);
}
inline void do_filter6(uint8_t* p, int step) {
  const int p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  const int q0 = p[0], q1 = p[step], q2 = p[2 * step];
  const int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
  const int a1 = (27 * a + 63) >> 7;
  const int a2 = (18 * a + 63) >> 7;
  const int a3 = (9 * a + 63) >> 7;
  p[-3 * step] = clip8(p2 + a3);
  p[-2 * step] = clip8(p1 + a2);
  p[-step] = clip8(p0 + a1);
  p[0] = clip8(q0 - a1);
  p[step] = clip8(q1 - a2);
  p[2 * step] = clip8(q2 - a3);
}
inline bool hev(const uint8_t* p, int step, int thresh) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return abs(p1 - p0) > thresh || abs(q1 - q0) > thresh;
}
inline bool needs_filter(const uint8_t* p, int step, int t) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return 4 * abs(p0 - q0) + abs(p1 - q1) <= t;
}
inline bool needs_filter2(const uint8_t* p, int step, int t, int it) {
  const int p3 = p[-4 * step], p2 = p[-3 * step], p1 = p[-2 * step];
  const int p0 = p[-step], q0 = p[0];
  const int q1 = p[step], q2 = p[2 * step], q3 = p[3 * step];
  if (4 * abs(p0 - q0) + abs(p1 - q1) > t) return false;
  return abs(p3 - p2) <= it && abs(p2 - p1) <= it && abs(p1 - p0) <= it &&
         abs(q3 - q2) <= it && abs(q2 - q1) <= it && abs(q1 - q0) <= it;
}
void simple_filter(uint8_t* p, int step, int vstep, int thresh) {   // 16 positions
  const int thresh2 = 2 * thresh + 1;
  for (int i = 0; i < 16; ++i)
    if (needs_filter(p + i * vstep, step, thresh2)) do_filter2(p + i * vstep, step);
}
void filter_loop(uint8_t* p, int hstride, int vstride, int size, int thresh, int ithresh,
                 int hev_thresh, bool mb_edge) {
  const int thresh2 = 2 * thresh + 1;
  while (size-- > 0) {
    if (needs_filter2(p, hstride, thresh2, ithresh)) {
      if (hev(p, hstride, hev_thresh)) do_filter2(p, hstride);
      else if (mb_edge) do_filter6(p, hstride);
      else do_filter4(p, hstride);
    }
    p += vstride;
  }
}

// ---- the decoder ----
struct FInfo {
  int limit, ilevel, inner, hev_thresh;
};

struct MB {
  uint8_t segment, skip, is_i4x4, uvmode;
  uint8_t imodes[16];
};

struct Decoder {
  int width, height, mb_w, mb_h;
  BoolDec br;
  BoolDec parts[8];
  int num_parts;
  // segment header
  int use_segment = 0, update_map = 0, absolute_delta = 1;
  int quantizer[4] = {0, 0, 0, 0}, filter_strength[4] = {0, 0, 0, 0};
  uint8_t seg_probs[3] = {255, 255, 255};
  // filter header
  int simple = 0, level = 0, sharpness = 0, use_lf_delta = 0;
  int ref_lf_delta[4] = {0, 0, 0, 0}, mode_lf_delta[4] = {0, 0, 0, 0};
  int filter_type = 0;
  // quantizers per segment: y1 (dc, ac), y2, uv
  int y1[4][2], y2[4][2], uv[4][2];
  uint8_t proba[4][8][3][11];
  int use_skip = 0, skip_p = 0;
  FInfo fstrengths[4][2];
};

int get_large_value(BoolDec& br, const uint8_t* p) {
  int v;
  if (!br.get(p[3])) {
    if (!br.get(p[4])) v = 2;
    else v = 3 + br.get(p[5]);
  } else {
    if (!br.get(p[6])) {
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
      for (const uint8_t* tab = kCat3456[cat]; *tab; ++tab) v += v + br.get(*tab);
      v += 3 + (8 << cat);
    }
  }
  return v;
}

// libwebp's GetCoeffs: returns the position after the last coefficient read
int get_coeffs(BoolDec& br, uint8_t (*band)[3][11], int ctx, const int* dq, int n,
               int16_t* out) {
  const uint8_t* p = band[kBands[n]][ctx];
  for (; n < 16; ++n) {
    if (!br.get(p[0])) return n;
    while (!br.get(p[1])) {
      ++n;
      p = band[kBands[n]][0];
      if (n == 16) return 16;
    }
    int v;
    const int nb = kBands[n + 1];
    if (!br.get(p[2])) {
      v = 1;
      p = band[nb][1];
    } else {
      v = get_large_value(br, p);
      p = band[nb][2];
    }
    out[kZigzag[n]] = int16_t((br.get(128) ? -v : v) * dq[n > 0]);
  }
  return 16;
}

inline int clipq(int v, int m) { return v < 0 ? 0 : v > m ? m : v; }

int parse_header(Decoder& d, const uint8_t* buf, size_t size) {
  if (size < 10) return -1;
  const uint32_t bits = buf[0] | (buf[1] << 8) | (buf[2] << 16);
  const int key_frame = !(bits & 1);
  const int profile = (bits >> 1) & 7;
  const uint32_t part_len = bits >> 5;
  if (!key_frame || profile > 3) return -4;
  if (buf[3] != 0x9d || buf[4] != 0x01 || buf[5] != 0x2a) return -1;
  d.width = ((buf[7] << 8) | buf[6]) & 0x3fff;
  d.height = ((buf[9] << 8) | buf[8]) & 0x3fff;
  if (d.width == 0 || d.height == 0) return -1;
  d.mb_w = (d.width + 15) >> 4;
  d.mb_h = (d.height + 15) >> 4;
  buf += 10;
  size -= 10;
  if (part_len > size) return -1;
  BoolDec& br = d.br;
  br.init(buf, part_len);
  buf += part_len;
  size -= part_len;
  br.get(128);   // colour space
  br.get(128);   // clamping type
  d.use_segment = br.get(128);
  if (d.use_segment) {
    d.update_map = br.get(128);
    if (br.get(128)) {
      d.absolute_delta = br.get(128);
      for (int s = 0; s < 4; ++s) d.quantizer[s] = br.get(128) ? br.signed_value(7) : 0;
      for (int s = 0; s < 4; ++s) d.filter_strength[s] = br.get(128) ? br.signed_value(6) : 0;
    }
    if (d.update_map)
      for (int s = 0; s < 3; ++s) d.seg_probs[s] = uint8_t(br.get(128) ? br.literal(8) : 255);
  }
  d.simple = br.get(128);
  d.level = br.literal(6);
  d.sharpness = br.literal(3);
  d.use_lf_delta = br.get(128);
  if (d.use_lf_delta && br.get(128)) {
    for (int i = 0; i < 4; ++i)
      if (br.get(128)) d.ref_lf_delta[i] = br.signed_value(6);
    for (int i = 0; i < 4; ++i)
      if (br.get(128)) d.mode_lf_delta[i] = br.signed_value(6);
  }
  d.filter_type = d.level == 0 ? 0 : d.simple ? 1 : 2;
  // token partitions
  d.num_parts = 1 << br.literal(2);
  const size_t last = d.num_parts - 1;
  if (size < 3 * last) return -1;
  const uint8_t* sz = buf;
  const uint8_t* part_start = buf + 3 * last;
  size_t left = size - 3 * last;
  for (size_t p = 0; p < last; ++p) {
    size_t psize = sz[0] | (sz[1] << 8) | (sz[2] << 16);
    if (psize > left) psize = left;
    d.parts[p].init(part_start, psize);
    part_start += psize;
    left -= psize;
    sz += 3;
  }
  d.parts[last].init(part_start, left);
  // quantizers
  const int base_q0 = br.literal(7);
  const int dqy1_dc = br.get(128) ? br.signed_value(4) : 0;
  const int dqy2_dc = br.get(128) ? br.signed_value(4) : 0;
  const int dqy2_ac = br.get(128) ? br.signed_value(4) : 0;
  const int dquv_dc = br.get(128) ? br.signed_value(4) : 0;
  const int dquv_ac = br.get(128) ? br.signed_value(4) : 0;
  for (int i = 0; i < 4; ++i) {
    int q;
    if (d.use_segment) {
      q = d.quantizer[i];
      if (!d.absolute_delta) q += base_q0;
    } else {
      if (i > 0) {
        memcpy(d.y1[i], d.y1[0], sizeof(d.y1[0]));
        memcpy(d.y2[i], d.y2[0], sizeof(d.y2[0]));
        memcpy(d.uv[i], d.uv[0], sizeof(d.uv[0]));
        continue;
      }
      q = base_q0;
    }
    d.y1[i][0] = kDcTable[clipq(q + dqy1_dc, 127)];
    d.y1[i][1] = kAcTable[clipq(q, 127)];
    d.y2[i][0] = kDcTable[clipq(q + dqy2_dc, 127)] * 2;
    d.y2[i][1] = (kAcTable[clipq(q + dqy2_ac, 127)] * 101581) >> 16;
    if (d.y2[i][1] < 8) d.y2[i][1] = 8;
    d.uv[i][0] = kDcTable[clipq(q + dquv_dc, 117)];
    d.uv[i][1] = kAcTable[clipq(q + dquv_ac, 127)];
  }
  br.get(128);   // refresh entropy probabilities: a key frame's are its own
  for (int t = 0; t < 4; ++t)
    for (int b = 0; b < 8; ++b)
      for (int c = 0; c < 3; ++c)
        for (int p = 0; p < 11; ++p) {
          const int k = ((t * 8 + b) * 3 + c) * 11 + p;
          d.proba[t][b][c][p] =
              uint8_t(br.get(kCoeffsUpdateProba[k]) ? br.literal(8) : kCoeffsProba0[k]);
        }
  d.use_skip = br.get(128);
  if (d.use_skip) d.skip_p = br.literal(8);
  // filter strengths per segment and 4x4-ness
  if (d.filter_type > 0) {
    for (int s = 0; s < 4; ++s) {
      int base_level;
      if (d.use_segment) {
        base_level = d.filter_strength[s];
        if (!d.absolute_delta) base_level += d.level;
      } else {
        base_level = d.level;
      }
      for (int i4x4 = 0; i4x4 <= 1; ++i4x4) {
        FInfo& info = d.fstrengths[s][i4x4];
        int level = base_level;
        if (d.use_lf_delta) {
          level += d.ref_lf_delta[0];
          if (i4x4) level += d.mode_lf_delta[0];
        }
        level = level < 0 ? 0 : level > 63 ? 63 : level;
        if (level > 0) {
          int ilevel = level;
          if (d.sharpness > 0) {
            ilevel >>= d.sharpness > 4 ? 2 : 1;
            if (ilevel > 9 - d.sharpness) ilevel = 9 - d.sharpness;
          }
          if (ilevel < 1) ilevel = 1;
          info.ilevel = ilevel;
          info.limit = 2 * level + ilevel;
          info.hev_thresh = level >= 40 ? 2 : level >= 15 ? 1 : 0;
        } else {
          info.limit = 0;
        }
        info.inner = i4x4;
      }
    }
  }
  return 0;
}

inline void yuv_to_rgb(int y, int u, int v, uint8_t* rgb) {
  auto mult_hi = [](int a, int c) { return (a * c) >> 8; };
  auto clip = [](int x) { return (x & ~16383) == 0 ? x >> 6 : x < 0 ? 0 : 255; };
  rgb[0] = uint8_t(clip(mult_hi(y, 19077) + mult_hi(v, 26149) - 14234));
  rgb[1] = uint8_t(clip(mult_hi(y, 19077) - mult_hi(u, 6419) - mult_hi(v, 13320) + 8708));
  rgb[2] = uint8_t(clip(mult_hi(y, 19077) + mult_hi(u, 33050) - 17685));
}

// libwebp's UpsampleRgbLinePair (dsp/upsampling.c), u and v computed apart
void upsample_pair(const uint8_t* top_y, const uint8_t* bottom_y, const uint8_t* top_u,
                   const uint8_t* top_v, const uint8_t* cur_u, const uint8_t* cur_v,
                   uint8_t* top_dst, uint8_t* bottom_dst, int len) {
  const int last_pair = (len - 1) >> 1;
  int tl_u = top_u[0], tl_v = top_v[0], l_u = cur_u[0], l_v = cur_v[0];
  yuv_to_rgb(top_y[0], (3 * tl_u + l_u + 2) >> 2, (3 * tl_v + l_v + 2) >> 2, top_dst);
  if (bottom_y)
    yuv_to_rgb(bottom_y[0], (3 * l_u + tl_u + 2) >> 2, (3 * l_v + tl_v + 2) >> 2, bottom_dst);
  for (int x = 1; x <= last_pair; ++x) {
    const int t_u = top_u[x], t_v = top_v[x], u = cur_u[x], v = cur_v[x];
    const int avg_u = tl_u + t_u + l_u + u + 8, avg_v = tl_v + t_v + l_v + v + 8;
    const int d12_u = (avg_u + 2 * (t_u + l_u)) >> 3, d12_v = (avg_v + 2 * (t_v + l_v)) >> 3;
    const int d03_u = (avg_u + 2 * (tl_u + u)) >> 3, d03_v = (avg_v + 2 * (tl_v + v)) >> 3;
    yuv_to_rgb(top_y[2 * x - 1], (d12_u + tl_u) >> 1, (d12_v + tl_v) >> 1,
               top_dst + (2 * x - 1) * 3);
    yuv_to_rgb(top_y[2 * x], (d03_u + t_u) >> 1, (d03_v + t_v) >> 1, top_dst + 2 * x * 3);
    if (bottom_y) {
      yuv_to_rgb(bottom_y[2 * x - 1], (d03_u + l_u) >> 1, (d03_v + l_v) >> 1,
                 bottom_dst + (2 * x - 1) * 3);
      yuv_to_rgb(bottom_y[2 * x], (d12_u + u) >> 1, (d12_v + v) >> 1, bottom_dst + 2 * x * 3);
    }
    tl_u = t_u;
    tl_v = t_v;
    l_u = u;
    l_v = v;
  }
  if (!(len & 1)) {
    yuv_to_rgb(top_y[len - 1], (3 * tl_u + l_u + 2) >> 2, (3 * tl_v + l_v + 2) >> 2,
               top_dst + (len - 1) * 3);
    if (bottom_y)
      yuv_to_rgb(bottom_y[len - 1], (3 * l_u + tl_u + 2) >> 2, (3 * l_v + tl_v + 2) >> 2,
                 bottom_dst + (len - 1) * 3);
  }
}

int decode_vp8(const uint8_t* buf, size_t size, uint8_t* out, int64_t cap, int32_t* info) {
  Decoder* dp = new Decoder();
  Decoder& d = *dp;
  int e = parse_header(d, buf, size);
  if (e) {
    delete dp;
    return e;
  }
  if (info) {
    info[0] = d.width;
    info[1] = d.height;
  }
  if (!out) {
    delete dp;
    return 0;
  }
  if (cap < int64_t(d.width) * d.height * 3) {
    delete dp;
    return -1;
  }
  const int mb_w = d.mb_w, mb_h = d.mb_h;
  const int ys = mb_w * 16, uvs = mb_w * 8;
  std::vector<uint8_t> Y(size_t(ys) * mb_h * 16), U(size_t(uvs) * mb_h * 8),
      V(size_t(uvs) * mb_h * 8);
  std::vector<FInfo> finfo(size_t(mb_w) * mb_h);
  std::vector<uint8_t> intra_t(4 * mb_w, B_DC);
  std::vector<uint8_t> top_nz(9 * mb_w, 0);   // 4 y, 2 u, 2 v, dc
  std::vector<uint8_t> top_y(16 * mb_w), top_u(8 * mb_w), top_v(8 * mb_w);
  uint8_t yuv_b[YUV_SIZE + 32];
  memset(yuv_b, 0, sizeof(yuv_b));
  uint8_t* const y_dst = yuv_b + Y_OFF;
  uint8_t* const u_dst = yuv_b + U_OFF;
  uint8_t* const v_dst = yuv_b + V_OFF;
  std::vector<MB> mbs(mb_w);
  alignas(16) int16_t coeffs[384];
  BoolDec& br = d.br;

  for (int mb_y = 0; mb_y < mb_h; ++mb_y) {
    // intra modes of the row (first partition)
    uint8_t intra_l[4] = {B_DC, B_DC, B_DC, B_DC};
    for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
      MB& b = mbs[mb_x];
      uint8_t* top = &intra_t[4 * mb_x];
      if (d.update_map) {
        b.segment = uint8_t(!br.get(d.seg_probs[0]) ? br.get(d.seg_probs[1])
                                                     : br.get(d.seg_probs[2]) + 2);
      } else {
        b.segment = 0;
      }
      b.skip = d.use_skip ? uint8_t(br.get(d.skip_p)) : 0;
      b.is_i4x4 = !br.get(145);
      if (!b.is_i4x4) {
        const int ymode = br.get(156) ? (br.get(128) ? B_TM : B_HE) : (br.get(163) ? B_VE : B_DC);
        b.imodes[0] = uint8_t(ymode);
        memset(top, ymode, 4);
        memset(intra_l, ymode, 4);
      } else {
        uint8_t* modes = b.imodes;
        for (int y = 0; y < 4; ++y) {
          int ymode = intra_l[y];
          for (int x = 0; x < 4; ++x) {
            const uint8_t* prob = kBModesProba + (top[x] * 10 + ymode) * 9;
            int i = kYModesIntra4[br.get(prob[0])];
            while (i > 0) i = kYModesIntra4[2 * i + br.get(prob[i])];
            ymode = -i;
            top[x] = uint8_t(ymode);
          }
          memcpy(modes, top, 4);
          modes += 4;
          intra_l[y] = uint8_t(ymode);
        }
      }
      b.uvmode = uint8_t(!br.get(142) ? B_DC : !br.get(114) ? B_VE : br.get(183) ? B_TM : B_HE);
    }
    // residuals and reconstruction
    BoolDec& tbr = d.parts[mb_y & (d.num_parts - 1)];
    uint8_t left_nz[9] = {0, 0, 0, 0, 0, 0, 0, 0, 0};
    for (int j = 0; j < 16; ++j) y_dst[j * BPS - 1] = 129;
    for (int j = 0; j < 8; ++j) {
      u_dst[j * BPS - 1] = 129;
      v_dst[j * BPS - 1] = 129;
    }
    if (mb_y > 0) {
      y_dst[-1 - BPS] = u_dst[-1 - BPS] = v_dst[-1 - BPS] = 129;
    } else {
      memset(y_dst - BPS - 1, 127, 16 + 4 + 1);
      memset(u_dst - BPS - 1, 127, 8 + 1);
      memset(v_dst - BPS - 1, 127, 8 + 1);
    }
    for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
      MB& b = mbs[mb_x];
      uint8_t* tnz = &top_nz[9 * mb_x];
      const int seg = b.segment;
      bool skip = b.skip;
      memset(coeffs, 0, sizeof(coeffs));
      if (!skip) {
        int first;
        uint8_t(*ac_band)[3][11];
        if (!b.is_i4x4) {
          int16_t dc[16] = {0};
          const int ctx = tnz[8] + left_nz[8];
          const int nz = get_coeffs(tbr, d.proba[1], ctx, d.y2[seg], 0, dc);
          tnz[8] = left_nz[8] = nz > 0;
          if (nz > 1) {
            transform_wht(dc, coeffs);
          } else {
            const int dc0 = (dc[0] + 3) >> 3;
            for (int i = 0; i < 256; i += 16) coeffs[i] = int16_t(dc0);
          }
          first = 1;
          ac_band = d.proba[0];
        } else {
          first = 0;
          ac_band = d.proba[3];
        }
        bool any = false;
        for (int y = 0; y < 4; ++y)
          for (int x = 0; x < 4; ++x) {
            int16_t* dst = coeffs + (y * 4 + x) * 16;
            const int ctx = left_nz[y] + tnz[x];
            const int nz = get_coeffs(tbr, ac_band, ctx, d.y1[seg], first, dst);
            const int l = nz > first;
            tnz[x] = left_nz[y] = uint8_t(l);
            any |= nz > 3 || nz > 1 || dst[0] != 0;
          }
        for (int ch = 0; ch < 2; ++ch)
          for (int y = 0; y < 2; ++y)
            for (int x = 0; x < 2; ++x) {
              int16_t* dst = coeffs + 256 + ch * 64 + (y * 2 + x) * 16;
              const int ctx = left_nz[4 + 2 * ch + y] + tnz[4 + 2 * ch + x];
              const int nz = get_coeffs(tbr, d.proba[2], ctx, d.uv[seg], 0, dst);
              const int l = nz > 0;
              tnz[4 + 2 * ch + x] = left_nz[4 + 2 * ch + y] = uint8_t(l);
              any |= nz > 3 || nz > 1 || dst[0] != 0;
            }
        skip = !any;
      } else {
        for (int i = 0; i < 8; ++i) tnz[i] = left_nz[i] = 0;
        if (!b.is_i4x4) tnz[8] = left_nz[8] = 0;
      }
      if (d.filter_type > 0) {
        FInfo fi = d.fstrengths[seg][b.is_i4x4];
        fi.inner |= !skip;
        finfo[size_t(mb_y) * mb_w + mb_x] = fi;
      }
      // reconstruct (libwebp's ReconstructRow)
      if (mb_x > 0) {
        for (int j = -1; j < 16; ++j) memcpy(&y_dst[j * BPS - 4], &y_dst[j * BPS + 12], 4);
        for (int j = -1; j < 8; ++j) {
          memcpy(&u_dst[j * BPS - 4], &u_dst[j * BPS + 4], 4);
          memcpy(&v_dst[j * BPS - 4], &v_dst[j * BPS + 4], 4);
        }
      }
      if (mb_y > 0) {
        memcpy(y_dst - BPS, &top_y[16 * mb_x], 16);
        memcpy(u_dst - BPS, &top_u[8 * mb_x], 8);
        memcpy(v_dst - BPS, &top_v[8 * mb_x], 8);
      }
      if (b.is_i4x4) {
        uint8_t* top_right = y_dst - BPS + 16;
        if (mb_y > 0) {
          if (mb_x >= mb_w - 1) memset(top_right, top_y[16 * mb_x + 15], 4);
          else memcpy(top_right, &top_y[16 * (mb_x + 1)], 4);
        }
        for (int k = 1; k <= 3; ++k) memcpy(top_right + 4 * k * BPS, top_right, 4);
        for (int n = 0; n < 16; ++n) {
          uint8_t* dst = y_dst + (n & 3) * 4 + (n >> 2) * 4 * BPS;
          pred4(dst, b.imodes[n]);
          if (any_nonzero(coeffs + n * 16)) transform_one(coeffs + n * 16, dst);
        }
      } else {
        int mode = b.imodes[0];
        if (mode == B_DC) mode = mb_x == 0 ? (mb_y == 0 ? DC_NOTOPLEFT : DC_NOLEFT)
                                          : (mb_y == 0 ? DC_NOTOP : B_DC);
        pred16(y_dst, mode);
        for (int n = 0; n < 16; ++n)
          if (any_nonzero(coeffs + n * 16))
            transform_one(coeffs + n * 16, y_dst + (n & 3) * 4 + (n >> 2) * 4 * BPS);
      }
      {
        int mode = b.uvmode;
        if (mode == B_DC) mode = mb_x == 0 ? (mb_y == 0 ? DC_NOTOPLEFT : DC_NOLEFT)
                                          : (mb_y == 0 ? DC_NOTOP : B_DC);
        pred8uv(u_dst, mode);
        pred8uv(v_dst, mode);
        for (int n = 0; n < 4; ++n) {
          const int off = (n & 1) * 4 + (n >> 1) * 4 * BPS;
          if (any_nonzero(coeffs + 256 + n * 16)) transform_one(coeffs + 256 + n * 16, u_dst + off);
          if (any_nonzero(coeffs + 320 + n * 16)) transform_one(coeffs + 320 + n * 16, v_dst + off);
        }
      }
      if (mb_y < mb_h - 1) {
        memcpy(&top_y[16 * mb_x], y_dst + 15 * BPS, 16);
        memcpy(&top_u[8 * mb_x], u_dst + 7 * BPS, 8);
        memcpy(&top_v[8 * mb_x], v_dst + 7 * BPS, 8);
      }
      for (int j = 0; j < 16; ++j)
        memcpy(&Y[size_t(mb_y * 16 + j) * ys + mb_x * 16], y_dst + j * BPS, 16);
      for (int j = 0; j < 8; ++j) {
        memcpy(&U[size_t(mb_y * 8 + j) * uvs + mb_x * 8], u_dst + j * BPS, 8);
        memcpy(&V[size_t(mb_y * 8 + j) * uvs + mb_x * 8], v_dst + j * BPS, 8);
      }
    }
  }
  // loop filter, macroblock by macroblock in raster order (libwebp's DoFilter)
  if (d.filter_type > 0) {
    for (int mb_y = 0; mb_y < mb_h; ++mb_y)
      for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
        const FInfo& fi = finfo[size_t(mb_y) * mb_w + mb_x];
        const int limit = fi.limit;
        if (limit == 0) continue;
        uint8_t* yp = &Y[size_t(mb_y * 16) * ys + mb_x * 16];
        if (d.filter_type == 1) {
          if (mb_x > 0) simple_filter(yp, 1, ys, limit + 4);
          if (fi.inner)
            for (int k = 1; k <= 3; ++k) simple_filter(yp + 4 * k, 1, ys, limit);
          if (mb_y > 0) simple_filter(yp, ys, 1, limit + 4);
          if (fi.inner)
            for (int k = 1; k <= 3; ++k) simple_filter(yp + 4 * k * ys, ys, 1, limit);
        } else {
          uint8_t* up = &U[size_t(mb_y * 8) * uvs + mb_x * 8];
          uint8_t* vp = &V[size_t(mb_y * 8) * uvs + mb_x * 8];
          const int il = fi.ilevel, hv = fi.hev_thresh;
          if (mb_x > 0) {
            filter_loop(yp, 1, ys, 16, limit + 4, il, hv, true);
            filter_loop(up, 1, uvs, 8, limit + 4, il, hv, true);
            filter_loop(vp, 1, uvs, 8, limit + 4, il, hv, true);
          }
          if (fi.inner) {
            for (int k = 1; k <= 3; ++k) filter_loop(yp + 4 * k, 1, ys, 16, limit, il, hv, false);
            filter_loop(up + 4, 1, uvs, 8, limit, il, hv, false);
            filter_loop(vp + 4, 1, uvs, 8, limit, il, hv, false);
          }
          if (mb_y > 0) {
            filter_loop(yp, ys, 1, 16, limit + 4, il, hv, true);
            filter_loop(up, uvs, 1, 8, limit + 4, il, hv, true);
            filter_loop(vp, uvs, 1, 8, limit + 4, il, hv, true);
          }
          if (fi.inner) {
            for (int k = 1; k <= 3; ++k)
              filter_loop(yp + 4 * k * ys, ys, 1, 16, limit, il, hv, false);
            filter_loop(up + 4 * uvs, uvs, 1, 8, limit, il, hv, false);
            filter_loop(vp + 4 * uvs, uvs, 1, 8, limit, il, hv, false);
          }
        }
      }
  }
  // fancy upsampling to RGB (libwebp's EmitFancyRGB over the whole picture)
  const int W = d.width, H = d.height;
  const size_t stride = size_t(W) * 3;
  upsample_pair(&Y[0], nullptr, &U[0], &V[0], &U[0], &V[0], out, nullptr, W);
  int y = 0;
  for (; y + 2 < H; y += 2) {
    const int r = y / 2;
    upsample_pair(&Y[size_t(y + 1) * ys], &Y[size_t(y + 2) * ys], &U[size_t(r) * uvs],
                  &V[size_t(r) * uvs], &U[size_t(r + 1) * uvs], &V[size_t(r + 1) * uvs],
                  out + (y + 1) * stride, out + (y + 2) * stride, W);
  }
  if (!(H & 1)) {
    const int r = (H - 1) / 2;
    upsample_pair(&Y[size_t(H - 1) * ys], nullptr, &U[size_t(r) * uvs], &V[size_t(r) * uvs],
                  &U[size_t(r) * uvs], &V[size_t(r) * uvs], out + (H - 1) * stride, nullptr, W);
  }
  delete dp;
  return 0;
}

inline uint32_t le32(const uint8_t* p) { return p[0] | (p[1] << 8) | (p[2] << 16) | (uint32_t(p[3]) << 24); }

// The VP8 chunk of a RIFF WebP file, or a code < 0.
int find_vp8(const uint8_t* data, int64_t n, const uint8_t** vp8, size_t* vp8_size) {
  if (n < 20 || memcmp(data, "RIFF", 4) || memcmp(data + 8, "WEBP", 4)) return -1;
  int64_t riff_end = 8 + int64_t(le32(data + 4));
  if (riff_end > n) riff_end = n;
  int64_t pos = 12;
  while (pos + 8 <= riff_end) {
    const uint8_t* c = data + pos;
    const int64_t sz = le32(c + 4);
    if (pos + 8 + sz > riff_end) return -1;
    if (!memcmp(c, "VP8 ", 4)) {
      *vp8 = c + 8;
      *vp8_size = size_t(sz);
      return 0;
    }
    if (!memcmp(c, "VP8L", 4)) return -2;
    if (!memcmp(c, "ANIM", 4) || !memcmp(c, "ANMF", 4)) return -3;
    if (!memcmp(c, "VP8X", 4) && sz >= 1 && (c[8] & 0x02)) return -3;
    pos += 8 + sz + (sz & 1);
  }
  return -1;
}

}  // namespace

extern "C" {

// info[0..1] = width, height. Returns 0, or -1 corrupt, -2 lossless (VP8L),
// -3 animated, -4 a VP8 stream that is not a key frame.
int32_t webp_info(const uint8_t* data, int64_t n, int32_t* info) {
  const uint8_t* vp8;
  size_t size;
  int e = find_vp8(data, n, &vp8, &size);
  if (e) return e;
  return decode_vp8(vp8, size, nullptr, 0, info);
}

// Decodes into `out`, (height, width, 3) uint8 RGB: libwebp's RGB output,
// with any alpha dropped as Pillow's convert("RGB") drops it.
int32_t webp_decode(const uint8_t* data, int64_t n, uint8_t* out, int64_t cap) {
  const uint8_t* vp8;
  size_t size;
  int e = find_vp8(data, n, &vp8, &size);
  if (e) return e;
  return decode_vp8(vp8, size, out, cap, nullptr);
}

}  // extern "C"
