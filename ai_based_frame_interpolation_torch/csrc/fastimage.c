/* Host-side byte shuffles of the video stream, for ops/native.py.
 *
 * The device does the math; the host assembles what goes to it and what
 * comes back. Each function is one pass over uint8 frames:
 *
 *   bgr_to_gray_u8  BT.601 integer luma of decoder BGR pixels
 *   bgr_to_rgb_u8   the channel swap for an RGB model
 *   pack_pairs_u8   frames[0..n-1] -> the batches f[i] and f[i+1]
 *   interleave_u8   originals and each pair's in-betweens -> the output
 *                   stream in playback order (2x/4x assembly)
 *
 * Built by ops/_build.py with the host C compiler and called through
 * ctypes; ops/native.py checks every shape before it passes a pointer. */

#include <stdint.h>
#include <string.h>

/* y = (77 r + 150 g + 29 b + 128) >> 8 */
void bgr_to_gray_u8(const uint8_t *bgr, uint8_t *gray, int64_t npix) {
    for (int64_t i = 0; i < npix; ++i) {
        const uint32_t b = bgr[3 * i], g = bgr[3 * i + 1], r = bgr[3 * i + 2];
        gray[i] = (uint8_t)((77 * r + 150 * g + 29 * b + 128) >> 8);
    }
}

void bgr_to_rgb_u8(const uint8_t *bgr, uint8_t *rgb, int64_t npix) {
    for (int64_t i = 0; i < npix; ++i) {
        rgb[3 * i] = bgr[3 * i + 2];
        rgb[3 * i + 1] = bgr[3 * i + 1];
        rgb[3 * i + 2] = bgr[3 * i];
    }
}

/* frames: n_frames frames of frame_bytes each; out1 receives frames
 * 0..n-2, out2 frames 1..n-1. */
void pack_pairs_u8(const uint8_t *frames, uint8_t *out1, uint8_t *out2,
                   int64_t n_frames, int64_t frame_bytes) {
    const int64_t n_pairs = n_frames - 1;
    if (n_pairs <= 0) return;
    memcpy(out1, frames, (size_t)(n_pairs * frame_bytes));
    memcpy(out2, frames + frame_bytes, (size_t)(n_pairs * frame_bytes));
}

/* originals: n_pairs + 1 frames; mids: n_pairs x k frames. out receives
 * n_pairs * (k + 1) + 1 frames: orig[0], mids[0][0..k-1], orig[1], ...,
 * orig[n_pairs]. */
void interleave_u8(const uint8_t *originals, const uint8_t *mids,
                   uint8_t *out, int64_t n_pairs, int64_t k,
                   int64_t frame_bytes) {
    uint8_t *dst = out;
    for (int64_t p = 0; p < n_pairs; ++p) {
        memcpy(dst, originals + p * frame_bytes, (size_t)frame_bytes);
        dst += frame_bytes;
        memcpy(dst, mids + p * k * frame_bytes, (size_t)(k * frame_bytes));
        dst += k * frame_bytes;
    }
    memcpy(dst, originals + n_pairs * frame_bytes, (size_t)frame_bytes);
}
