/*
 * Single-pass phase -> grayscale conversion for the SLM write path.
 *
 * The numpy implementation (slm.py _phase2gray, mirroring the reference)
 * makes ~4 passes over the frame (scale, shift, rint, cast, modulo); at
 * SLM frame rates (60-500 Hz) on megapixel displays this is the host-side
 * hot loop. This C kernel fuses everything into one pass per pixel.
 *
 * Semantics match SLM._phase2gray for the phase_scaling == 1 fast path:
 *   display = (round(-phase * bitresolution / 2pi) - 1) mod bitresolution
 * with the same all-negative-shift trick so float->int rounding is
 * consistent. The general phase_scaling path stays in numpy (rare).
 */

#include <math.h>
#include <stdint.h>
#include <stddef.h>

/* phase (float64, n elements) -> uint8 display; bitresolution power of 2. */
void phase2gray_u8(
    const double *phase, uint8_t *display, size_t n,
    int bitresolution)
{
    const double factor = -((double)bitresolution) / (2.0 * M_PI);
    const unsigned int mask = (unsigned int)(bitresolution - 1);
    size_t i;

    for (i = 0; i < n; i++) {
        double scaled = phase[i] * factor;
        /* Shift far negative so the cast below is floor-consistent with
         * numpy's rint + unsafe cast on negative values. */
        long long v = (long long)llrint(scaled) - 1;
        display[i] = (uint8_t)(((unsigned long long)(v + ((long long)bitresolution << 20))) & mask);
    }
}

/* Same for uint16 displays (bitdepth > 8). */
void phase2gray_u16(
    const double *phase, uint16_t *display, size_t n,
    int bitresolution)
{
    const double factor = -((double)bitresolution) / (2.0 * M_PI);
    const unsigned int mask = (unsigned int)(bitresolution - 1);
    size_t i;

    for (i = 0; i < n; i++) {
        double scaled = phase[i] * factor;
        long long v = (long long)llrint(scaled) - 1;
        display[i] = (uint16_t)(((unsigned long long)(v + ((long long)bitresolution << 20))) & mask);
    }
}

/* float32 phase variant (holograms are float32). */
void phase2gray_f32_u8(
    const float *phase, uint8_t *display, size_t n,
    int bitresolution)
{
    const float factor = -((float)bitresolution) / (float)(2.0 * M_PI);
    const unsigned int mask = (unsigned int)(bitresolution - 1);
    size_t i;

    for (i = 0; i < n; i++) {
        long long v = (long long)llrintf(phase[i] * factor) - 1;
        display[i] = (uint8_t)(((unsigned long long)(v + ((long long)bitresolution << 20))) & mask);
    }
}
