// Host codecs of the port's native library (its own copy of the JAX
// package's native/rle.cpp): COCO's compressed RLE (column-major run
// lengths, 6-bit characters, runs from the third on coded as the delta to
// the run two before) and the legacy +1 IoU matrix.
//
// C interface (ctypes, vps_torch/native/__init__.py):
//   int rle_decode(const char* s, int h, int w, uint8_t* out);
//   int rle_encode(const uint8_t* mask, int h, int w, char* out, int cap);
//   void bbox_overlaps(const float* a, int na, const float* b, int nb,
//                      float* out);
//
// Built by vps_torch/native/__init__.py with g++ -O3 -shared -fPIC at first
// use, into vps_torch/_build/.

#include <cstdint>
#include <cstring>
#include <vector>
#include <algorithm>

extern "C" {

// Decode the char-compressed RLE string into an h*w uint8 mask
// (column-major runs, starting with zeros). Returns 0 on success.
int rle_decode(const char* s, int h, int w, uint8_t* out) {
    std::vector<long> cnts;
    long x;
    int more, k;
    size_t p = 0, slen = strlen(s);
    while (p < slen) {
        x = 0;
        k = 0;
        more = 1;
        while (more) {
            char c = s[p] - 48;
            x |= (long)(c & 0x1f) << (5 * k);
            more = c & 0x20;
            p++;
            k++;
            if (!more && (c & 0x10)) x |= -1L << (5 * k);
        }
        if (cnts.size() > 2) x += cnts[cnts.size() - 2];
        cnts.push_back(x);
    }
    long total = (long)h * w;
    long pos = 0;
    uint8_t v = 0;
    for (size_t i = 0; i < cnts.size(); i++) {
        long n = cnts[i];
        if (pos + n > total) n = total - pos;
        if (n > 0) memset(out + pos, v, n);
        pos += n;
        v = 1 - v;
    }
    return pos <= total ? 0 : 1;
}

// Encode an h*w uint8 mask (column-major interpretation: caller passes the
// mask already in Fortran order, i.e. out[i] walks down columns) into the
// char-compressed RLE string. Returns the string length, or -1 if cap is
// too small.
int rle_encode(const uint8_t* mask, int h, int w, char* out, int cap) {
    long total = (long)h * w;
    std::vector<long> cnts;
    uint8_t prev = 0;
    long run = 0;
    for (long i = 0; i < total; i++) {
        uint8_t v = mask[i] ? 1 : 0;
        if (v != prev) {
            cnts.push_back(run);
            run = 0;
            prev = v;
        }
        run++;
    }
    cnts.push_back(run);
    int pos = 0;
    for (size_t i = 0; i < cnts.size(); i++) {
        long x = cnts[i];
        if (i > 2) x -= cnts[i - 2];
        int more = 1;
        while (more) {
            char c = x & 0x1f;
            x >>= 5;
            more = (c & 0x10) ? (x != -1) : (x != 0);
            if (more) c |= 0x20;
            c += 48;
            if (pos >= cap) return -1;
            out[pos++] = c;
        }
    }
    if (pos >= cap) return -1;
    out[pos] = '\0';
    return pos;
}

// Legacy +1 IoU matrix (reference upsnet bbox.pyx semantics).
void bbox_overlaps(const float* a, int na, const float* b, int nb, float* out) {
    for (int j = 0; j < nb; j++) {
        float bw = b[j * 4 + 2] - b[j * 4 + 0] + 1.0f;
        float bh = b[j * 4 + 3] - b[j * 4 + 1] + 1.0f;
        float barea = bw * bh;
        for (int i = 0; i < na; i++) {
            float iw = std::min(a[i * 4 + 2], b[j * 4 + 2]) -
                       std::max(a[i * 4 + 0], b[j * 4 + 0]) + 1.0f;
            float res = 0.0f;
            if (iw > 0) {
                float ih = std::min(a[i * 4 + 3], b[j * 4 + 3]) -
                           std::max(a[i * 4 + 1], b[j * 4 + 1]) + 1.0f;
                if (ih > 0) {
                    float aarea = (a[i * 4 + 2] - a[i * 4 + 0] + 1.0f) *
                                  (a[i * 4 + 3] - a[i * 4 + 1] + 1.0f);
                    float ua = aarea + barea - iw * ih;
                    res = iw * ih / ua;
                }
            }
            out[(long)i * nb + j] = res;
        }
    }
}

}  // extern "C"
