// Native payload assembler: splice device-packed residual sections together
// with per-channel parameter headers into framed SRLA blocks (sync, size,
// Fletcher-16), in one pass over all blocks.
//
// Original implementation for srla_tpu; format per srla_tpu/format.py.

#include <cstdint>
#include <cstring>

namespace {

struct BitWriter {
    uint8_t *p;
    uint64_t stage;
    int count;  // bits pending in stage (from MSB)

    void init(uint8_t *dst) { p = dst; stage = 0; count = 0; }
    inline void flush_words() {
        while (count >= 8) {
            *p++ = (uint8_t)(stage >> 56);
            stage <<= 8;
            count -= 8;
        }
    }
    inline void put(uint32_t val, int nbits) {
        if (!nbits) return;
        stage |= ((uint64_t)val & ((nbits >= 32) ? 0xFFFFFFFFull
                                                 : ((1ull << nbits) - 1)))
                 << (64 - count - nbits);
        count += nbits;
        if (count >= 32) flush_words();
    }
    // Append nbits from src (bit 0 = MSB of src[0]).
    void append_bits(const uint8_t *src, long nbits) {
        long full = nbits / 32;
        for (long i = 0; i < full; i++) {
            uint32_t w = ((uint32_t)src[4 * i] << 24)
                         | ((uint32_t)src[4 * i + 1] << 16)
                         | ((uint32_t)src[4 * i + 2] << 8)
                         | (uint32_t)src[4 * i + 3];
            put(w, 32);
        }
        int rem = (int)(nbits - full * 32);
        if (rem) {
            uint32_t w = 0;
            for (int b = 0; b < (rem + 7) / 8; b++)
                w |= (uint32_t)src[4 * full + b] << (24 - 8 * b);
            put(w >> (32 - rem), rem);
        }
    }
    long finish(uint8_t *base) {
        while (count > 0) {
            *p++ = (uint8_t)(stage >> 56);
            stage <<= 8;
            count -= 8;
        }
        return (long)(p - base);
    }
};

inline uint32_t zigzag(int32_t v) {
    return ((uint32_t)(v >> 31)) ^ ((uint32_t)v << 1);
}

uint16_t fletcher16(const uint8_t *data, long size) {
    uint32_t c0 = 0, c1 = 0;
    while (size > 0) {
        long blk = size < 5802 ? size : 5802;
        size -= blk;
        while (blk--) {
            c0 += *data++;
            c1 += c0;
        }
        c0 = (c0 + (c0 / 255)) & 0xFF;
        c1 = (c1 + (c1 / 255)) & 0xFF;
    }
    return (uint16_t)((c1 << 8) | c0);
}

}  // namespace

extern "C" {

// Assemble B framed COMPRESS blocks. Per block: 11-byte header + payload of
// [method|preemph fields|LPC params+Huffman coefs|LTP flags|sections].
// Returns total bytes written, or -1. out_sizes[b] = framed size, or 0 when
// the compressed payload reached raw size (caller emits a raw block).
long srla_assemble_blocks(
    long B, int C, int bps, int n, int maxorder,
    const int32_t *method,
    const int32_t *pre_prev, const int32_t *pre_coef,
    const int32_t *orders, const int32_t *rshifts,
    const int32_t *coefs,
    const uint32_t *pcodes, const uint8_t *plens,
    const uint32_t *scodes, const uint8_t *slens,
    const uint8_t *sections, const long *sec_off_bytes, const long *sec_bits,
    uint8_t *out, long out_cap, long *out_sizes,
    int ltp_order, const int32_t *ltp_periods, const int32_t *ltp_coefs) {
    uint8_t *w = out;
    const long raw_bits = (long)bps * n * C;
    for (long b = 0; b < B; b++) {
        uint8_t *blk = w;
        // Pre-check an upper bound of this block's framed size BEFORE any
        // write: plain-coded coefficients bound the Huffman section (use_sum
        // is only chosen when no longer than plain), so a capacity
        // under-estimate fails cleanly instead of overrunning the buffer.
        long bound_bits = 2 + (long)C * (bps + 1 + 5) + 7;
        for (int c = 0; c < C; c++) {
            const int o = orders[b * C + c];
            const int32_t *cf = coefs + ((long)b * C + c) * maxorder;
            bound_bits += 8 + 4 + 1;
            for (int i = 0; i < o; i++) bound_bits += plens[zigzag(cf[i])];
            bound_bits += 1;
            if (ltp_periods && ltp_periods[b * C + c])
                bound_bits += 1 + 8 + 6 * (long)ltp_order;
            bound_bits += sec_bits[b * C + c];
        }
        if ((blk - out) + 11 + bound_bits / 8 + 1 > out_cap) return -1;
        // Header written after payload (size/checksum fixups).
        uint8_t *pl = blk + 11;
        BitWriter bw;
        bw.init(pl);
        bw.put((uint32_t)method[b], 2);
        for (int c = 0; c < C; c++) {
            bw.put(zigzag(pre_prev[b * C + c]), bps + 1);
            bw.put(zigzag(pre_coef[b * C + c]), 5);
        }
        for (int c = 0; c < C; c++) {
            int o = orders[b * C + c];
            bw.put((uint32_t)o, 8);
            bw.put((uint32_t)rshifts[b * C + c], 4);
            const int32_t *cf = coefs + ((long)b * C + c) * maxorder;
            // use_sum: starts set, cleared on overflow or when not shorter
            // (order-1 keeps it; identical cost either way).
            long plain_cost = 0;
            for (int i = 0; i < o; i++) plain_cost += plens[zigzag(cf[i])];
            int use_sum = o > 0;
            long sum_cost = o > 0 ? plens[zigzag(cf[0])] : 0;
            for (int i = 1; i < o && use_sum; i++) {
                uint32_t uv = zigzag(cf[i] + cf[i - 1]);
                if (uv >= 256) { use_sum = 0; break; }
                sum_cost += slens[uv];
                if (sum_cost >= plain_cost) use_sum = 0;
            }
            if (o == 1) use_sum = 1;
            bw.put((uint32_t)use_sum, 1);
            if (o > 0) {
                if (use_sum) {
                    uint32_t uv = zigzag(cf[0]);
                    bw.put(pcodes[uv], plens[uv]);
                    for (int i = 1; i < o; i++) {
                        uint32_t sv = zigzag(cf[i] + cf[i - 1]);
                        bw.put(scodes[sv], slens[sv]);
                    }
                } else {
                    for (int i = 0; i < o; i++) {
                        uint32_t uv = zigzag(cf[i]);
                        bw.put(pcodes[uv], plens[uv]);
                    }
                }
            }
        }
        for (int c = 0; c < C; c++) {
            const int per = ltp_periods ? ltp_periods[b * C + c] : 0;
            bw.put(per ? 1u : 0u, 1);
            if (per) {
                bw.put((uint32_t)((ltp_order - 1) / 2), 1);
                bw.put((uint32_t)(per - 8), 8);  // LTP_MIN_PERIOD
                const int32_t *lc =
                    ltp_coefs + ((long)b * C + c) * ltp_order;
                for (int i = 0; i < ltp_order; i++)
                    bw.put(zigzag(lc[i]), 6);    // LTP_COEFFICIENT_BITWIDTH
            }
        }
        for (int c = 0; c < C; c++) {
            long k = b * C + c;
            bw.append_bits(sections + sec_off_bytes[k], sec_bits[k]);
        }
        long payload = bw.finish(pl);
        if (8 * payload >= raw_bits) {
            out_sizes[b] = 0;  // raw fallback, host emits it
            continue;
        }
        // Block header: sync, size, checksum, type, num_samples.
        blk[0] = 0xFF; blk[1] = 0xFF;
        uint32_t size32 = (uint32_t)(payload + 5);
        blk[2] = (uint8_t)(size32 >> 24); blk[3] = (uint8_t)(size32 >> 16);
        blk[4] = (uint8_t)(size32 >> 8); blk[5] = (uint8_t)size32;
        blk[8] = 0;  // COMPRESS
        blk[9] = (uint8_t)(n >> 8); blk[10] = (uint8_t)n;
        uint16_t ck = fletcher16(blk + 8, payload + 3);
        blk[6] = (uint8_t)(ck >> 8); blk[7] = (uint8_t)ck;
        out_sizes[b] = 11 + payload;
        w = pl + payload;
        if (w - out > out_cap) return -1;
    }
    return (long)(w - out);
}

// Standalone checksum entry point (reference srla_utility.c:36-60) for the
// host framing path (the vectorized-numpy form is a per-block cost that
// adds up at corpus scale).
uint16_t srla_fletcher16(const uint8_t *data, long size) {
    return fletcher16(data, size);
}

}  // extern "C"
