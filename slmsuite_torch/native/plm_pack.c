/*
 * Fused PLM electrode packing for the TI PLM write path.
 *
 * A PLM frame write maps each 8-bit gray pixel through a gray->4-bit
 * memory-code LUT, then spreads the 4 code bits onto a 2x2 electrode
 * block of the (2H, 2W) video bitmap, honoring the model's bit layout
 * and scan flips. The numpy implementation (texasinstruments.py
 * _electrode_map) takes ~6 array passes (LUT gather, four strided
 * writes, flips, contiguity copy); at video rates (the DLPC900 replays
 * bitplanes at up to 5.7 kHz) this is the host-side hot loop. This
 * kernel does everything in one pass over the input, writing each
 * output byte exactly once.
 */

#include <stdint.h>
#include <stddef.h>

/*
 * display : (h, w) uint8 gray codes (already phase2gray'd)
 * out     : (2h, 2w) uint8 binary bitmap (0/255), caller-allocated
 * lut     : 256-entry gray -> 4-bit memory code table
 * layout  : 4 entries, bit index for electrode (dy, dx) = layout[dy*2+dx]
 * flip_y, flip_x : mirror the packed bitmap (model data_flip)
 */
void plm_electrode_map(
    const uint8_t *display, uint8_t *out, size_t h, size_t w,
    const uint8_t *lut, const uint8_t *layout, int flip_y, int flip_x)
{
    const size_t W2 = 2 * w;
    const size_t H2 = 2 * h;
    size_t y, x;
    int dy, dx;

    for (y = 0; y < h; y++) {
        const uint8_t *row = display + y * w;
        for (x = 0; x < w; x++) {
            const uint8_t code = lut[row[x]];
            for (dy = 0; dy < 2; dy++) {
                for (dx = 0; dx < 2; dx++) {
                    const uint8_t bit = layout[dy * 2 + dx];
                    size_t oy = 2 * y + (size_t)dy;
                    size_t ox = 2 * x + (size_t)dx;
                    if (flip_y) oy = H2 - 1 - oy;
                    if (flip_x) ox = W2 - 1 - ox;
                    out[oy * W2 + ox] =
                        (uint8_t)(((code >> bit) & 1u) * 255u);
                }
            }
        }
    }
}

/*
 * Pack 8 binary bitmaps' LSBs into one uint8 frame: bitmap k's LSB
 * becomes bit k (the DLPC900 bitplane packing). maps points at 8
 * contiguous (n)-element planes.
 */
void plm_bitpack8(const uint8_t *maps, uint8_t *out, size_t n)
{
    size_t i;
    int k;

    for (i = 0; i < n; i++) {
        uint8_t acc = 0;
        for (k = 0; k < 8; k++)
            acc |= (uint8_t)((maps[(size_t)k * n + i] & 1u) << k);
        out[i] = acc;
    }
}
