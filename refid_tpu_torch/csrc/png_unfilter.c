/* PNG row unfiltering on the host (filters 0-4 of the PNG specification,
 * section 9), for refid_tpu_torch/data/img_util.py.
 *
 * One call undoes the filters of one image, or of one Adam7 pass: `raw`
 * holds `height` rows of 1 filter-type byte and `stride` bytes each, `out`
 * receives `height` rows of `stride` bytes.  `bpp` is the distance, in
 * bytes, to the corresponding byte of the pixel to the left: max(1, bits
 * per pixel / 8).  Rows are sequential (each reads the row above, already
 * unfiltered); within a row, Sub, Average and Paeth are sequential too.
 *
 * Returns 0, or 1 + the row index of the first row whose filter type is
 * not 0-4 (nothing past that row is written).
 *
 * Built by refid_tpu_torch/ops/build.py with the host C compiler
 * (-O3 -shared -fPIC) and called through ctypes.
 */
#include <stddef.h>
#include <stdint.h>
#include <string.h>

/* The Paeth predictor in libpng's form: |p - a| = |b - c|, |p - b| = |a - c|,
 * |p - c| = |a + b - 2c|, ties to a, then b; selects, not branches (the
 * choice is data-dependent and mispredicts on photographs). */
static inline int paeth(int a, int b, int c) {
    int pa = b - c, pb = a - c;
    int pc = pa + pb;
    pa = pa < 0 ? -pa : pa;
    pb = pb < 0 ? -pb : pb;
    pc = pc < 0 ? -pc : pc;
    const int near = pb < pa ? pb : pa;
    const int pred = pb < pa ? b : a;
    return pc < near ? c : pred;
}

int64_t refid_png_unfilter(const uint8_t *raw, int64_t height, int64_t stride, int64_t bpp,
                           uint8_t *out) {
    const uint8_t *prev = NULL;     /* the row above; NULL reads as zeros */
    for (int64_t r = 0; r < height; ++r) {
        const uint8_t kind = raw[r * (stride + 1)];
        const uint8_t *in = raw + r * (stride + 1) + 1;
        uint8_t *cur = out + r * stride;
        int64_t i;
        switch (kind) {
        case 0:
            memcpy(cur, in, (size_t)stride);
            break;
        case 1:     /* Sub */
            for (i = 0; i < bpp && i < stride; ++i) cur[i] = in[i];
            for (; i < stride; ++i) cur[i] = (uint8_t)(in[i] + cur[i - bpp]);
            break;
        case 2:     /* Up */
            if (prev)
                for (i = 0; i < stride; ++i) cur[i] = (uint8_t)(in[i] + prev[i]);
            else
                memcpy(cur, in, (size_t)stride);
            break;
        case 3:     /* Average */
            if (prev) {
                for (i = 0; i < bpp && i < stride; ++i) cur[i] = (uint8_t)(in[i] + (prev[i] >> 1));
                for (; i < stride; ++i)
                    cur[i] = (uint8_t)(in[i] + ((cur[i - bpp] + prev[i]) >> 1));
            } else {
                for (i = 0; i < bpp && i < stride; ++i) cur[i] = in[i];
                for (; i < stride; ++i) cur[i] = (uint8_t)(in[i] + (cur[i - bpp] >> 1));
            }
            break;
        case 4:     /* Paeth; on the first row it reduces to Sub */
            if (prev) {
                for (i = 0; i < bpp && i < stride; ++i) cur[i] = (uint8_t)(in[i] + prev[i]);
                for (; i < stride; ++i)
                    cur[i] = (uint8_t)(in[i] + paeth(cur[i - bpp], prev[i], prev[i - bpp]));
            } else {
                for (i = 0; i < bpp && i < stride; ++i) cur[i] = in[i];
                for (; i < stride; ++i) cur[i] = (uint8_t)(in[i] + cur[i - bpp]);
            }
            break;
        default:
            return r + 1;
        }
        prev = cur;
    }
    return 0;
}
