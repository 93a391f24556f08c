/* PNG scanline unfiltering on the host, for ops/png.py.
 *
 * A PNG image is h scanlines, each a filter byte (0 None, 1 Sub, 2 Up,
 * 3 Average, 4 Paeth) followed by `stride` bytes. Each byte is predicted
 * from the unfiltered byte `bpp` to its left (a), the one above (b) and the
 * one above-left (c), all 0 outside the image; the file stores the byte
 * minus its prediction, mod 256. Average and Paeth depend on the byte to
 * the left after unfiltering, so a row is one pass from left to right.
 *
 * Built by ops/_build.py with the host C compiler and called through
 * ctypes. */

#include <stdint.h>

/* The Paeth predictor: of a, b and c, the one nearest a + b - c (ties to
 * a, then b). The distances |p - a| = |b - c|, |p - b| = |a - c| and
 * |p - c| = |a + b - 2c| are written so that the selects compile to
 * conditional moves: the branches would be unpredictable on image data. */
static inline int paeth(int a, int b, int c) {
    int pa = b - c, pb = a - c, pc = a + b - 2 * c;
    pa = pa < 0 ? -pa : pa;
    pb = pb < 0 ? -pb : pb;
    pc = pc < 0 ? -pc : pc;
    int bc = pb <= pc ? b : c;
    return (pa <= pb) & (pa <= pc) ? a : bc;
}

/* data: h * (stride + 1) bytes of filtered scanlines; out: h * stride
 * bytes. Returns 0, or 1 + the index of the first row whose filter byte is
 * not 0-4 (rows before it are unfiltered). */
long long png_unfilter(const uint8_t *data, uint8_t *out, long long h,
                       long long stride, int bpp) {
    for (long long y = 0; y < h; ++y) {
        const uint8_t *raw = data + y * (stride + 1) + 1;
        uint8_t *cur = out + y * stride;
        const uint8_t *up = y ? cur - stride : 0;
        long long i;
        switch (raw[-1]) {
        case 0:
            for (i = 0; i < stride; ++i) cur[i] = raw[i];
            break;
        case 1:
            for (i = 0; i < stride; ++i)
                cur[i] = (uint8_t)(raw[i] + (i >= bpp ? cur[i - bpp] : 0));
            break;
        case 2:
            for (i = 0; i < stride; ++i)
                cur[i] = (uint8_t)(raw[i] + (up ? up[i] : 0));
            break;
        case 3:
            for (i = 0; i < stride; ++i) {
                int a = i >= bpp ? cur[i - bpp] : 0;
                int b = up ? up[i] : 0;
                cur[i] = (uint8_t)(raw[i] + ((a + b) >> 1));
            }
            break;
        case 4:
            for (i = 0; i < stride; ++i) {
                int a = i >= bpp ? cur[i - bpp] : 0;
                int b = up ? up[i] : 0;
                int c = up && i >= bpp ? up[i - bpp] : 0;
                cur[i] = (uint8_t)(raw[i] + paeth(a, b, c));
            }
            break;
        default:
            return y + 1;
        }
    }
    return 0;
}
