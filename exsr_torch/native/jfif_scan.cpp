// Baseline-JPEG entropy-coded scan decoder: the bit-serial loop of
// exsr_torch/jpeg/jfif.py::_decode_scan in C++ (the port's copy of
// exsr/native/jfif_scan.cpp).  It runs the Python reader's algorithm
// byte for byte, ~2 orders of magnitude faster.
//
// Semantics mirror the Python _BitReader/_Huffman pair exactly:
//   * MSB-first 32-bit window, 0xFF00 byte unstuffing;
//   * RST markers and EOI/segment starts feed zero padding into the
//     window during fill (the caller resynchronizes at restart
//     intervals);
//   * canonical Huffman per T.81 annex C with incremental decode;
//   * DIFF/magnitude extension per T.81 F.2.2.1.
//
// Host code with a plain C interface, loaded with ctypes
// (exsr_torch/native/jfif_native.py).

#include <cstdint>
#include <cstring>

namespace {

const int ZIGZAG[64] = {
    0,  1,  8, 16,  9,  2,  3, 10,
    17, 24, 32, 25, 18, 11,  4,  5,
    12, 19, 26, 33, 40, 48, 41, 34,
    27, 20, 13,  6,  7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36,
    29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46,
    53, 60, 61, 54, 47, 55, 62, 63};

struct BitReader {
    const uint8_t* data;
    int64_t len;
    int64_t pos;
    uint32_t bits = 0;
    int nbits = 0;

    void fill() {
        while (nbits <= 24) {
            if (pos >= len) {
                bits <<= 8;
                nbits += 8;
                continue;
            }
            uint8_t b = data[pos];
            if (b == 0xFF) {
                uint8_t nxt = (pos + 1 < len) ? data[pos + 1] : 0;
                if (nxt == 0x00) {
                    pos += 2;           // unstuffed 0xFF data byte
                } else {                // RSTn / EOI / next segment:
                    bits <<= 8;         // zero padding, do not consume
                    nbits += 8;
                    continue;
                }
            } else {
                pos += 1;
            }
            bits = (bits << 8) | b;
            nbits += 8;
        }
    }

    inline uint32_t take(int n) {
        if (n == 0) return 0;
        if (nbits < n) fill();
        uint32_t v = (bits >> (nbits - n)) & ((1u << n) - 1u);
        nbits -= n;
        return v;
    }

    // skip to just past the next RSTn marker; false when none remains
    bool align_restart() {
        bits = 0;
        nbits = 0;
        while (pos < len - 1) {
            if (data[pos] == 0xFF && data[pos + 1] >= 0xD0 &&
                data[pos + 1] <= 0xD7) {
                pos += 2;
                return true;
            }
            pos += 1;
        }
        return false;
    }
};

struct Huffman {
    int32_t mincode[17];
    int32_t maxcode[17];
    int32_t valptr[17];
    const uint8_t* symbols;

    void build(const uint8_t* counts, const uint8_t* syms) {
        symbols = syms;
        int code = 0, k = 0;
        for (int length = 1; length <= 16; ++length) {
            int n = counts[length - 1];
            if (n) {
                valptr[length] = k;
                mincode[length] = code;
                code += n;
                k += n;
                maxcode[length] = code - 1;
            } else {
                maxcode[length] = -1;
            }
            code <<= 1;
        }
    }

    // returns the symbol, or -1 on an invalid code
    inline int decode(BitReader& br) const {
        int code = 0;
        for (int length = 1; length <= 16; ++length) {
            code = (code << 1) | static_cast<int>(br.take(1));
            int mx = maxcode[length];
            if (mx != -1 && code <= mx)
                return symbols[valptr[length] + code - mincode[length]];
        }
        return -1;
    }
};

inline int32_t extend(uint32_t v, int t) {
    if (t == 0) return 0;
    int32_t iv = static_cast<int32_t>(v);
    return (iv >= (1 << (t - 1))) ? iv : iv - (1 << t) + 1;
}

}  // namespace

extern "C" int exsr_jfif_decode_scan(
    const uint8_t* data, int64_t data_len, int64_t pos, int n_comp,
    const int32_t* comp_h, const int32_t* comp_v,
    const uint8_t* dc_counts,    // n_comp x 16
    const uint8_t* dc_symbols,   // n_comp x 256
    const uint8_t* ac_counts, const uint8_t* ac_symbols,
    int32_t mcus_x, int32_t mcus_y, int32_t restart_interval,
    int32_t** planes             // n_comp buffers [bh, bw, 64], zeroed
) {
    if (n_comp < 1 || n_comp > 8) return 1;  // fixed-size table bound
    BitReader br{data, data_len, pos};
    Huffman dc_t[8], ac_t[8];
    for (int c = 0; c < n_comp; ++c) {
        dc_t[c].build(dc_counts + 16 * c, dc_symbols + 256 * c);
        ac_t[c].build(ac_counts + 16 * c, ac_symbols + 256 * c);
    }
    int32_t preds[8] = {0};
    int64_t mcu_index = 0;
    for (int my = 0; my < mcus_y; ++my) {
        for (int mx = 0; mx < mcus_x; ++mx) {
            if (restart_interval && mcu_index &&
                mcu_index % restart_interval == 0) {
                if (!br.align_restart()) return 3;
                std::memset(preds, 0, sizeof(preds));
            }
            ++mcu_index;
            for (int ci = 0; ci < n_comp; ++ci) {
                const int ch = comp_h[ci], cv = comp_v[ci];
                const int64_t bw = static_cast<int64_t>(mcus_x) * ch;
                for (int by = 0; by < cv; ++by) {
                    for (int bx = 0; bx < ch; ++bx) {
                        const int64_t row =
                            static_cast<int64_t>(my) * cv + by;
                        const int64_t col =
                            static_cast<int64_t>(mx) * ch + bx;
                        int32_t* blk = planes[ci] + (row * bw + col) * 64;
                        int t = dc_t[ci].decode(br);
                        // t > 16 would make take()'s shifts UB; the DC
                        // category is bounded by T.81 F.1.2.1.2
                        if (t < 0 || t > 16) return 1;
                        preds[ci] += extend(br.take(t), t);
                        blk[0] = preds[ci];  // ZIGZAG[0] == 0
                        int k = 1;
                        while (k < 64) {
                            int rs = ac_t[ci].decode(br);
                            if (rs < 0) return 1;
                            int r = rs >> 4, sz = rs & 0xF;
                            if (sz == 0) {
                                if (r == 15) { k += 16; continue; }
                                break;  // EOB
                            }
                            k += r;
                            if (k > 63) return 2;
                            blk[ZIGZAG[k]] = extend(br.take(sz), sz);
                            ++k;
                        }
                    }
                }
            }
        }
    }
    return 0;
}
