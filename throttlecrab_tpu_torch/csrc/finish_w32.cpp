// The compact="w32" output's host unpack (tpu/kernel.py finish_w32) in
// one pass, built by native.py with g++ at first use:
//   g++ -O3 -std=c++17 -shared -fPIC -o libtkfinish.so finish_w32.cpp
// Word i's fields go to out[i] (allowed, bit 0), out[n + i] (remaining),
// out[2n + i] (reset seconds) and out[3n + i] (retry seconds), the four
// planes of an i32 (4, n) buffer.  The fields' maxima (kernel.py
// W32_*_MAX, each 2^b - 1) are passed in, so the widths live in one
// place; the fields follow one another from bit 1 up.  The caller
// releases the GIL (ctypes), so finish workers run side by side.

#include <stdint.h>

extern "C" void tk_finish_w32(const int32_t* words, int64_t n,
                              uint32_t rem_max, uint32_t reset_max,
                              uint32_t retry_max, int32_t* out) {
    const int reset_at = 1 + __builtin_popcount(rem_max);
    const int retry_at = reset_at + __builtin_popcount(reset_max);
    int32_t* __restrict allowed = out;
    int32_t* __restrict remaining = out + n;
    int32_t* __restrict reset = out + 2 * n;
    int32_t* __restrict retry = out + 3 * n;
    for (int64_t i = 0; i < n; i++) {
        const uint32_t u = static_cast<uint32_t>(words[i]);
        allowed[i] = static_cast<int32_t>(u & 1u);
        remaining[i] = static_cast<int32_t>((u >> 1) & rem_max);
        reset[i] = static_cast<int32_t>((u >> reset_at) & reset_max);
        retry[i] = static_cast<int32_t>((u >> retry_at) & retry_max);
    }
}
