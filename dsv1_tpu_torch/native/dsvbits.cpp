// dsvbits — native bit-serial runtime of dsv1_tpu_torch (the port's own
// copy of dsv1_tpu/native/dsvbits.cpp, built into its own library).
//
// The DSV1 bitstream interleaves self-delimiting exp-Golomb codes, so the
// *decode* side of entropy coding is inherently serial per stream. This
// module implements that serial work (HZCC symbol parsing, ZBRLE, motion
// substream decode with the raster MV predictor) plus MSB-first bit packing,
// behind a plain C ABI consumed via ctypes. Everything per-coefficient
// (quant/dequant/scatter) stays on the device; only the byte-level walk is
// here.
//
// Format references (behavioral, not copied): reference bs.c:49-267
// (bit I/O + UEG/SEG/NEG + ZBRLE), hzcc.c:295-435 (decode-side run
// semantics incl. the buffer-overrun guard), dsv.c:189-231 (MV prediction),
// dsv_decoder.c:73-145 (motion/stability substream layout).

#include <cstdint>
#include <cstring>

namespace {

struct BitReader {
    const uint8_t* buf;
    uint32_t len;     // hard length in bytes (never read past)
    uint32_t pos = 0; // bit position

    BitReader(const uint8_t* b, uint32_t l) : buf(b), len(l) {}

    inline uint32_t byte_pos() const { return pos >> 3; }

    inline int bit() {
        uint32_t byte = pos >> 3;
        if (byte >= len) { pos++; return 0; }
        int b = (buf[byte] >> (7 - (pos & 7))) & 1;
        pos++;
        return b;
    }

    inline uint32_t bits(int n) {
        uint32_t v = 0;
        for (int i = 0; i < n; i++) v = (v << 1) | (uint32_t)bit();
        return v;
    }

    inline void align() { pos = (pos + 7) & ~7u; }

    inline uint32_t ueg() {
        uint32_t v = 1;
        while (!bit()) {
            v = (v << 1) | (uint32_t)bit();
            if (v > (1u << 30)) break; // corrupt-stream backstop
        }
        return v - 1;
    }

    inline int32_t seg() {
        int32_t v = (int32_t)ueg();
        if (v && bit()) return -v;
        return v;
    }

    inline int32_t neg() {
        int32_t v = (int32_t)ueg() + 1;
        if (v && bit()) return -v;
        return v;
    }
};

struct BitWriter {
    uint8_t* buf;
    uint32_t cap;     // capacity in bytes
    uint32_t pos = 0; // bit position

    BitWriter(uint8_t* b, uint32_t c) : buf(b), cap(c) {}

    inline void put_bits(uint64_t v, int n) {
        if (n <= 0) return;
        uint32_t end = pos + (uint32_t)n;
        if (((end + 7) >> 3) > cap) { pos = cap * 8 + 1; return; } // sticky
        uint32_t b = pos >> 3, o = pos & 7;
        if (n < 64) v &= (1ull << n) - 1;
        // o + n <= 7 + 64 bits land in <= 9 bytes; OR them in MSB-first
        unsigned __int128 x = (unsigned __int128)v << (128 - o - n);
        int m = (int)((o + (uint32_t)n + 7) >> 3);
        for (int i = 0; i < m; i++)
            buf[b + i] |= (uint8_t)(x >> (120 - 8 * i));
        pos = end;
    }

    inline void align() { pos = (pos + 7) & ~7u; }
};

} // namespace

extern "C" {

// Parse an HZCC coefficient section. `buf` points at the section start
// (a byte-aligned 32-bit big-endian run count), `hardlen` bounds reads,
// `planelen` is the plane byte budget used by the decoder's overrun guard.
// Outputs up to max_syms (run, value) pairs. Returns the number of values
// emitted; *consumed_bits receives the final (aligned) bit position.
int32_t dsv1n_parse_hzcc(const uint8_t* buf, uint32_t hardlen,
                         uint32_t planelen, int32_t max_syms,
                         uint32_t* runs_out, int32_t* vals_out,
                         uint32_t* nruns_out, uint32_t* endpos_bits) {
    BitReader r(buf, hardlen);
    uint32_t nruns = r.bits(32);
    r.align();
    *nruns_out = nruns;
    int32_t lim = (int32_t)nruns;
    if (lim > max_syms) lim = max_syms;
    int32_t n = 0;
    if (lim > 0) {
        // stream: r0, (r1 v0), (r2 v1), ..., v_{last}
        runs_out[0] = r.ueg();
        n = lim;
        for (int32_t i = 1; i < lim; i++) {
            runs_out[i] = r.ueg();
            vals_out[i - 1] = r.neg();
            if (r.byte_pos() >= planelen) { n = i - 1; break; } // guard
        }
        if (n == lim) {
            vals_out[lim - 1] = r.neg();
            if (r.byte_pos() >= planelen) n = lim - 1;
        }
    }
    r.align();
    *endpos_bits = r.pos;
    return n;
}

// Decode `n` ZBRLE flags.
void dsv1n_zbrle_decode(const uint8_t* buf, uint32_t len, int32_t n,
                        uint8_t* out) {
    BitReader r(buf, len);
    uint32_t nz = 0;
    for (int32_t i = 0; i < n; i++) {
        if (nz == 0) nz = r.ueg();
        else nz--;
        out[i] = (nz == 0) ? 1 : 0;
    }
}

// Decode `n` UEG values (used for substream lengths etc.).
void dsv1n_parse_ueg(const uint8_t* buf, uint32_t len, int32_t n,
                     uint32_t* out) {
    BitReader r(buf, len);
    for (int32_t i = 0; i < n; i++) out[i] = r.ueg();
}

// Parse one complete picture packet (dsv_dec picture path,
// dsv_decoder.c:286-412): header fields, stability ZBRLE, motion
// substreams with the raster MV predictor, and the three HZCC plane
// sections as (dc, runs, vals) symbol lists. One call per packet —
// replaces a per-field host bit walk.
//
// hdr_out[8]: fno, blk_w, blk_h, quant, nbh, nbv, has_ref, plen_err
// pmeta[9]:   (dc, count, plen) per plane
// runs/vals:  3 planes back to back, max_syms[c] entries each
// Returns 0 on success, -1 on malformed block dims.
int32_t dsv1n_parse_picture(
    const uint8_t* pkt, int64_t pkt_len, int32_t w, int32_t h,
    int32_t qp_bits, int32_t min_blk, int32_t max_blk,
    int32_t* hdr_out, uint8_t* stable, uint8_t* modes,
    int16_t* mvx, int16_t* mvy, uint8_t* submask,
    const int32_t* max_syms, uint32_t* runs, int32_t* vals,
    int32_t* pmeta);

static inline int32_t mv_pred_1(int32_t left, int32_t top, int32_t topleft) {
    int32_t dif = left + top - topleft;
    int32_t dl = dif - left; if (dl < 0) dl = -dl;
    int32_t dt = dif - top;  if (dt < 0) dt = -dt;
    return (dl < dt) ? left : top;
}

// Full motion-data decode: ZBRLE block modes, SEG MV residuals with the
// raster-order left/top/topleft predictor, and intra sub-block masks.
void dsv1n_decode_motion(const uint8_t* mode_buf, uint32_t mode_len,
                         const uint8_t* mvx_buf, uint32_t mvx_len,
                         const uint8_t* mvy_buf, uint32_t mvy_len,
                         const uint8_t* sbim_buf, uint32_t sbim_len,
                         int32_t nbh, int32_t nbv,
                         uint8_t* modes, int16_t* mvx, int16_t* mvy,
                         uint8_t* submask) {
    BitReader rm(mode_buf, mode_len);
    BitReader rx(mvx_buf, mvx_len);
    BitReader ry(mvy_buf, mvy_len);
    BitReader rs(sbim_buf, sbim_len);
    uint32_t nz = 0;
    for (int32_t j = 0; j < nbv; j++) {
        for (int32_t i = 0; i < nbh; i++) {
            int32_t idx = i + j * nbh;
            if (nz == 0) nz = rm.ueg(); else nz--;
            int mode = (nz == 0) ? 1 : 0;
            modes[idx] = (uint8_t)mode;
            if (mode == 0) { // inter: predict from decoded neighbours
                int32_t lx = 0, ly = 0, tx = 0, ty = 0, tlx = 0, tly = 0;
                if (i > 0 && modes[idx - 1] == 0) { lx = mvx[idx - 1]; ly = mvy[idx - 1]; }
                if (j > 0 && modes[idx - nbh] == 0) { tx = mvx[idx - nbh]; ty = mvy[idx - nbh]; }
                if (i > 0 && j > 0 && modes[idx - nbh - 1] == 0) {
                    tlx = mvx[idx - nbh - 1]; tly = mvy[idx - nbh - 1];
                }
                mvx[idx] = (int16_t)(rx.seg() + mv_pred_1(lx, tx, tlx));
                mvy[idx] = (int16_t)(ry.seg() + mv_pred_1(ly, ty, tly));
                submask[idx] = 0;
            } else {
                mvx[idx] = 0; mvy[idx] = 0;
                submask[idx] = rs.bit() ? 0xF : (uint8_t)rs.bits(4);
            }
        }
    }
}

// Encode motion data into four substreams (inverse of the above); returns
// byte lengths via *_len. Buffers must be pre-zeroed and large enough.
void dsv1n_encode_motion(const uint8_t* modes, const int16_t* mvx,
                         const int16_t* mvy, const uint8_t* submask,
                         int32_t nbh, int32_t nbv,
                         uint8_t* mode_buf, uint32_t* mode_len,
                         uint8_t* mvx_buf, uint32_t* mvx_len,
                         uint8_t* mvy_buf, uint32_t* mvy_len,
                         uint8_t* sbim_buf, uint32_t* sbim_len,
                         uint32_t bufcap) {
    BitWriter wx(mvx_buf, bufcap), wy(mvy_buf, bufcap), ws(sbim_buf, bufcap);
    BitWriter wm(mode_buf, bufcap);
    uint32_t nz = 0;
    auto put_ueg = [](BitWriter& w, uint32_t v) {
        // compose the interleaved code (0,b_{k-1})...(0,b_0)1 into one
        // (code, 2k+1 <= 63 bit) word and write it in a single call
        uint32_t vp = v + 1;
        int k = 0; while ((vp >> (k + 1)) != 0) k++;
        uint64_t c = 0;
        for (int i = k - 1; i >= 0; i--) c = (c << 2) | ((vp >> i) & 1);
        w.put_bits((c << 1) | 1, 2 * k + 1);
    };
    auto put_seg = [&put_ueg](BitWriter& w, int32_t v) {
        uint32_t a = (uint32_t)(v < 0 ? -v : v);
        put_ueg(w, a);
        if (a) w.put_bits(v < 0 ? 1 : 0, 1);
    };
    for (int32_t j = 0; j < nbv; j++) {
        for (int32_t i = 0; i < nbh; i++) {
            int32_t idx = i + j * nbh;
            if (modes[idx]) { put_ueg(wm, nz); nz = 0; } else nz++;
            if (modes[idx] == 0) {
                int32_t lx = 0, ly = 0, tx = 0, ty = 0, tlx = 0, tly = 0;
                if (i > 0 && modes[idx - 1] == 0) { lx = mvx[idx - 1]; ly = mvy[idx - 1]; }
                if (j > 0 && modes[idx - nbh] == 0) { tx = mvx[idx - nbh]; ty = mvy[idx - nbh]; }
                if (i > 0 && j > 0 && modes[idx - nbh - 1] == 0) {
                    tlx = mvx[idx - nbh - 1]; tly = mvy[idx - nbh - 1];
                }
                put_seg(wx, mvx[idx] - mv_pred_1(lx, tx, tlx));
                put_seg(wy, mvy[idx] - mv_pred_1(ly, ty, tly));
            } else {
                if (submask[idx] == 0xF) ws.put_bits(1, 1);
                else { ws.put_bits(0, 1); ws.put_bits(submask[idx], 4); }
            }
        }
    }
    put_ueg(wm, nz); // ZBRLE trailing run
    wm.align(); wx.align(); wy.align(); ws.align();
    *mode_len = wm.pos >> 3; *mvx_len = wx.pos >> 3;
    *mvy_len = wy.pos >> 3; *sbim_len = ws.pos >> 3;
}

// Append n (code, bitlen) symbols MSB-first at *bitpos in out (pre-zeroed).
void dsv1n_pack_symbols(const uint64_t* codes, const int32_t* lens, int32_t n,
                        uint8_t* out, uint32_t outcap, uint32_t* bitpos) {
    BitWriter w(out, outcap);
    w.pos = *bitpos;
    for (int32_t i = 0; i < n; i++) w.put_bits(codes[i], lens[i]);
    *bitpos = w.pos;
}

namespace {

inline void put_ueg_w(BitWriter& w, uint32_t v) {
    // composed interleaved exp-Golomb, one put_bits call (see put_ueg)
    uint32_t vp = v + 1;
    int k = 0; while ((vp >> (k + 1)) != 0) k++;
    uint64_t c = 0;
    for (int i = k - 1; i >= 0; i--) c = (c << 2) | ((vp >> i) & 1);
    w.put_bits((c << 1) | 1, 2 * k + 1);
}

inline void put_seg_w(BitWriter& w, int32_t v) {
    uint32_t a = (uint32_t)(v < 0 ? -v : v);
    put_ueg_w(w, a);
    if (a) w.put_bits(v < 0 ? 1 : 0, 1);
}

inline void put_neg_w(BitWriter& w, int32_t v) {
    uint32_t a = (uint32_t)(v < 0 ? -v : v);
    put_ueg_w(w, a - 1);
    w.put_bits(v < 0 ? 1 : 0, 1);
}

// Aligned byte append (bs.c:37-46 semantics).
inline void put_bytes_w(BitWriter& w, const uint8_t* p, uint32_t n) {
    uint32_t bp = w.pos >> 3;
    if (bp + n > w.cap) { w.pos = w.cap * 8 + 1; return; }
    memcpy(w.buf + bp, p, n);
    w.pos += n * 8;
}

inline void patch_u32(uint8_t* buf, uint32_t byteoff, uint32_t v) {
    buf[byteoff] = (uint8_t)(v >> 24);
    buf[byteoff + 1] = (uint8_t)(v >> 16);
    buf[byteoff + 2] = (uint8_t)(v >> 8);
    buf[byteoff + 3] = (uint8_t)v;
}

// One plane section (dsv_encode_plane wire layout, hzcc.c:449-496):
// [u32 len][SEG dc][pad][u32 nruns][pad][r0 (r1 v0) ... v_last][pad]
// [u8 0x55][pad]; len covers from its own offset to EOP inclusive, -4.
inline void put_plane_w(BitWriter& w, const uint32_t* runs,
                        const int32_t* vals, int32_t n, int32_t dc) {
    w.align();
    uint32_t startp = w.pos >> 3;
    w.put_bits(0, 32); // length placeholder
    put_seg_w(w, dc);
    w.align();
    w.put_bits((uint32_t)n, 32);
    w.align();
    if (n > 0) {
        put_ueg_w(w, runs[0]);
        for (int32_t i = 1; i < n; i++) {
            put_ueg_w(w, runs[i]);
            put_neg_w(w, vals[i - 1]);
        }
        put_neg_w(w, vals[n - 1]);
    }
    w.align();
    w.put_bits(0x55, 8); // EOP sentinel
    w.align();
    if (w.pos <= w.cap * 8)
        patch_u32(w.buf, startp, (w.pos >> 3) - startp - 4);
}

// Shared picture-packet prologue: header through the 11-bit quant field.
inline void put_picture_head_w(BitWriter& w, const uint8_t* fourcc,
                               uint8_t version, uint8_t pkt_type,
                               uint32_t fnum, int32_t blk_w, int32_t blk_h,
                               int32_t nbh, int32_t nbv,
                               const uint8_t* stable, int has_ref,
                               const uint8_t* modes, const int16_t* mvx,
                               const int16_t* mvy, const uint8_t* submask,
                               int32_t quant, int32_t qp_bits,
                               uint8_t* scratch, uint32_t scap,
                               uint8_t* mscratch, uint32_t mcap) {
    for (int i = 0; i < 4; i++) w.put_bits(fourcc[i], 8);
    w.put_bits(version, 8);
    w.put_bits(pkt_type, 8);
    w.put_bits(0, 32); // prev link (patched by caller)
    w.put_bits(0, 32); // next link (patched by caller)
    w.align();
    w.put_bits(fnum, 32);
    w.align();
    put_ueg_w(w, (uint32_t)(blk_w >> 2));
    put_ueg_w(w, (uint32_t)(blk_h >> 2));
    w.align();
    int32_t nblk = nbh * nbv;
    {
        memset(scratch, 0, scap);
        BitWriter sw(scratch, scap);
        uint32_t nz = 0;
        for (int32_t i = 0; i < nblk; i++) {
            if (stable[i] & 1) { put_ueg_w(sw, nz); nz = 0; } else nz++;
        }
        put_ueg_w(sw, nz);
        sw.align();
        uint32_t slen = sw.pos >> 3;
        put_ueg_w(w, slen);
        w.align();
        put_bytes_w(w, scratch, slen);
    }
    if (has_ref) {
        memset(mscratch, 0, 4 * mcap);
        uint32_t mlens[4];
        dsv1n_encode_motion(modes, mvx, mvy, submask, nbh, nbv,
                            mscratch, &mlens[0], mscratch + mcap, &mlens[1],
                            mscratch + 2 * mcap, &mlens[2],
                            mscratch + 3 * mcap, &mlens[3], mcap);
        w.align();
        for (int s = 0; s < 4; s++) {
            w.align();
            put_ueg_w(w, mlens[s]);
            w.align();
            put_bytes_w(w, mscratch + s * mcap, mlens[s]);
        }
    }
    w.align();
    w.put_bits((uint32_t)quant, qp_bits);
    return;
}

} // namespace

// Assemble one complete picture packet (encode_picture wire layout,
// dsv_encoder.c:463-536): header, frame number, block dims, ZBRLE
// stability flags, 4 motion substreams (P only), 11-bit quant, and the
// three coefficient plane sections. Returns the packet byte length, or
// -1 if outcap was too small (caller re-tries with a larger buffer).
int32_t dsv1n_pack_picture(
    const uint8_t* fourcc, uint8_t version, uint8_t pkt_type,
    uint32_t fnum, int32_t blk_w, int32_t blk_h, int32_t nbh, int32_t nbv,
    const uint8_t* stable, int32_t has_ref,
    const uint8_t* modes, const int16_t* mvx, const int16_t* mvy,
    const uint8_t* submask, int32_t quant, int32_t qp_bits,
    const uint32_t* runs0, const int32_t* vals0, int32_t n0, int32_t dc0,
    const uint32_t* runs1, const int32_t* vals1, int32_t n1, int32_t dc1,
    const uint32_t* runs2, const int32_t* vals2, int32_t n2, int32_t dc2,
    uint8_t* out, uint32_t outcap) {
    memset(out, 0, outcap);
    BitWriter w(out, outcap);
    int32_t nblk = nbh * nbv;
    uint32_t scap = (uint32_t)(nblk + 64);
    uint32_t mcap = (uint32_t)(nblk * 16 + 64);
    uint8_t* scratch = new uint8_t[scap];
    uint8_t* mscratch = new uint8_t[4 * mcap];
    put_picture_head_w(w, fourcc, version, pkt_type, fnum, blk_w, blk_h,
                       nbh, nbv, stable, has_ref, modes, mvx, mvy,
                       submask, quant, qp_bits, scratch, scap,
                       mscratch, mcap);
    delete[] scratch;
    delete[] mscratch;
    put_plane_w(w, runs0, vals0, n0, dc0);
    put_plane_w(w, runs1, vals1, n1, dc1);
    put_plane_w(w, runs2, vals2, n2, dc2);
    w.align();
    if (w.pos > w.cap * 8) return -1;
    return (int32_t)(w.pos >> 3);
}

namespace {

// Dense int8 plane (with sorted exception overrides, e.g. large LL values)
// -> one plane section, extracting the zero-run symbol stream in the same
// pass that writes it (run i+1 precedes value i on the wire, hzcc.c:176-283).
inline void put_plane_dense8_w(BitWriter& w, const int8_t* q, int32_t n,
                               const int32_t* epos, const int32_t* evals,
                               int32_t K, int32_t dc) {
    w.align();
    uint32_t startp = w.pos >> 3;
    w.put_bits(0, 32); // length placeholder
    put_seg_w(w, dc);
    w.align();
    uint32_t nruns_bit = w.pos;
    w.put_bits(0, 32); // nruns placeholder (patched below)
    w.align();
    int32_t run = 0, nruns = 0, prevval = 0, ei = 0;
    bool have_prev = false;
    for (int32_t i = 0; i < n; i++) {
        int32_t v = q[i];
        if (ei < K && epos[ei] == i) v = evals[ei++];
        if (v != 0) {
            put_ueg_w(w, (uint32_t)run);
            if (have_prev) put_neg_w(w, prevval);
            prevval = v;
            have_prev = true;
            nruns++;
            run = 0;
        } else {
            run++;
        }
    }
    if (have_prev) put_neg_w(w, prevval);
    w.align();
    if ((nruns_bit >> 3) + 4 <= w.cap) {
        uint8_t* p = w.buf + (nruns_bit >> 3);
        p[0] = (uint8_t)(nruns >> 24); p[1] = (uint8_t)(nruns >> 16);
        p[2] = (uint8_t)(nruns >> 8);  p[3] = (uint8_t)nruns;
    }
    w.put_bits(0x55, 8);
    w.align();
    if (w.pos <= w.cap * 8)
        patch_u32(w.buf, startp, (w.pos >> 3) - startp - 4);
}

// Sparse (run, value) list in 16-bit storage -> one plane section.
inline void put_plane_sparse16_w(BitWriter& w, const uint16_t* runs,
                                 const int16_t* vals, int32_t n, int32_t dc) {
    w.align();
    uint32_t startp = w.pos >> 3;
    w.put_bits(0, 32);
    put_seg_w(w, dc);
    w.align();
    w.put_bits((uint32_t)n, 32);
    w.align();
    if (n > 0) {
        put_ueg_w(w, runs[0]);
        for (int32_t i = 1; i < n; i++) {
            put_ueg_w(w, runs[i]);
            put_neg_w(w, vals[i - 1]);
        }
        put_neg_w(w, vals[n - 1]);
    }
    w.align();
    w.put_bits(0x55, 8);
    w.align();
    if (w.pos <= w.cap * 8)
        patch_u32(w.buf, startp, (w.pos >> 3) - startp - 4);
}

} // namespace

int32_t dsv1n_parse_picture(
    const uint8_t* pkt, int64_t pkt_len, int32_t w, int32_t h,
    int32_t qp_bits, int32_t min_blk, int32_t max_blk,
    int32_t* hdr_out, uint8_t* stable, uint8_t* modes,
    int16_t* mvx, int16_t* mvy, uint8_t* submask,
    const int32_t* max_syms, uint32_t* runs, int32_t* vals,
    int32_t* pmeta) {
    BitReader r(pkt, (uint32_t)pkt_len);
    int pkt_type = pkt[5];
    int has_ref = pkt_type & 1;
    r.pos = 14 * 8;
    uint32_t fno = r.bits(32);
    r.align();
    int32_t blk_w = (int32_t)r.ueg() << 2;
    int32_t blk_h = (int32_t)r.ueg() << 2;
    if (blk_w < min_blk || blk_w > max_blk
        || blk_h < min_blk || blk_h > max_blk)
        return -1;
    int32_t nbh = (w + blk_w - 1) / blk_w;
    int32_t nbv = (h + blk_h - 1) / blk_h;
    int32_t nblk = nbh * nbv;
    r.align();

    // stability flags (decode_stability_blocks, dsv_decoder.c:127-145)
    uint32_t slen = r.ueg();
    r.align();
    {
        uint32_t off = r.byte_pos();
        uint32_t avail = off < pkt_len ? (uint32_t)(pkt_len - off) : 0;
        dsv1n_zbrle_decode(pkt + off, slen < avail ? slen : avail, nblk,
                           stable);
        r.pos += slen * 8;
    }

    memset(modes, 0, (size_t)nblk);
    memset(mvx, 0, (size_t)nblk * 2);
    memset(mvy, 0, (size_t)nblk * 2);
    memset(submask, 0, (size_t)nblk);
    if (has_ref) {
        // 4 length-prefixed motion substreams (dsv_decoder.c:73-124)
        const uint8_t* sb[4];
        uint32_t sl[4];
        r.align();
        for (int s = 0; s < 4; s++) {
            uint32_t ln = r.ueg();
            r.align();
            uint32_t off = r.byte_pos();
            uint32_t avail = off < pkt_len ? (uint32_t)(pkt_len - off) : 0;
            sb[s] = pkt + off;
            sl[s] = ln < avail ? ln : avail;
            r.pos += ln * 8;
            r.align();
        }
        dsv1n_decode_motion(sb[0], sl[0], sb[1], sl[1], sb[2], sl[2],
                            sb[3], sl[3], nbh, nbv, modes, mvx, mvy,
                            submask);
        for (int32_t i = 0; i < nblk; i++)
            if (modes[i]) stable[i] |= 2; // intra bit (hzcc stability use)
    }

    r.align();
    int32_t quant = (int32_t)r.bits(qp_bits);

    int32_t plen_err = 0;
    int32_t roff = 0;
    for (int c = 0; c < 3; c++) {
        r.align();
        int64_t plen = (int64_t)r.bits(32);
        r.align();
        uint32_t off = r.byte_pos();
        int64_t avail = off < pkt_len ? pkt_len - off : 0;
        if (plen <= 0 || plen > avail + 4) plen_err = 1;
        // plane section: SEG raw DC, align, HZCC symbols
        // hard read bound is the rest of the packet (like the host-side
        // parse); plen only drives the decoder's overrun guard
        BitReader pr(pkt + off, (uint32_t)avail);
        int32_t dc = pr.seg();
        pr.align();
        uint32_t hoff = pr.byte_pos();
        uint32_t nruns_u = 0, endbits = 0;
        int64_t pbudget = plen > hoff ? plen - hoff : 0;
        int32_t n = dsv1n_parse_hzcc(
            pkt + off + hoff, (uint32_t)(avail > hoff ? avail - hoff : 0),
            (uint32_t)pbudget, max_syms[c],
            runs + roff, vals + roff, &nruns_u, &endbits);
        pmeta[c * 3] = dc;
        pmeta[c * 3 + 1] = n;
        pmeta[c * 3 + 2] = (int32_t)plen;
        roff += max_syms[c];
        r.pos += (uint32_t)plen * 8;
    }
    hdr_out[0] = (int32_t)fno;
    hdr_out[1] = blk_w;
    hdr_out[2] = blk_h;
    hdr_out[3] = quant;
    hdr_out[4] = nbh;
    hdr_out[5] = nbv;
    hdr_out[6] = has_ref;
    hdr_out[7] = plen_err;
    return 0;
}

// Extract the (zero-run, value) symbol stream from a dense int8
// quantized plane with sorted exception overrides (the device-side
// intra compaction layout). Returns the symbol count (bounded by cap).
int32_t dsv1n_runs_from_dense8(const int8_t* q, int32_t n,
                               const int32_t* epos, const int32_t* evals,
                               int32_t K, uint32_t* runs_out,
                               int32_t* vals_out, int32_t cap) {
    int32_t run = 0, m = 0, ei = 0;
    for (int32_t i = 0; i < n; i++) {
        int32_t v = q[i];
        if (ei < K && epos[ei] == i) v = evals[ei++];
        if (v != 0) {
            if (m >= cap) return -1;
            runs_out[m] = (uint32_t)run;
            vals_out[m] = v;
            m++;
            run = 0;
        } else {
            run++;
        }
    }
    return m;
}

// Assemble a whole chunk of GOP-parallel encoder output — C gops x G
// frames — into a contiguous packet byte stream in one call: metadata
// packet per GOP start (dsv_encoder.c:624-652), picture packets with
// stability ZBRLE / motion substreams / three plane sections, and the
// prev/next link-offset chain (dsv_encoder.c:170-192). The GOP-start
// intra frame arrives as dense int8 planes plus a sorted LL exception
// list; P frames as capped sparse (run, value) lists — exactly the
// device-side compaction layout (parallel/gop.py).
//
// Returns bytes written, or -1 if outcap was insufficient (caller
// retries with a doubled buffer). *prev_link_io carries the picture
// link chain across chunks.
int32_t dsv1n_pack_chunk(
    const uint8_t* fourcc, uint8_t version,
    int32_t blk_w, int32_t blk_h, int32_t nbh, int32_t nbv,
    const int32_t* quants, // [C, G]: per-frame quants (col 0 = I frame)
    int32_t qp_bits,
    const uint8_t* meta_pkt, int32_t meta_len,
    int32_t C, int32_t G, int64_t g0, int64_t ngops, int64_t nframes,
    int64_t fnum_base, // global frame-number offset (multi-host shards)
    int32_t pt_ref, // is_ref bit of the picture packet type (0 for gop0)
    // I-frame fields (one per gop row)
    const int8_t* const* iq8,    // [3] -> [C, iN[c]] dense quantized planes
    const int32_t* const* ipos,  // [3] -> [C, iK[c]] sorted exception pos
    const int32_t* const* ivals, // [3] -> [C, iK[c]] exception values
    const int32_t* iN, const int32_t* iK,
    const int32_t* idc,          // [C, 3]
    const uint8_t* istable,      // [C, nblk]
    // P-frame fields ([C, G-1, ...])
    const uint16_t* const* pruns, // [3] -> [C, G-1, pK[c]]
    const int16_t* const* pvals,  // [3] -> [C, G-1, pK[c]]
    const int32_t* const* pcnt,   // [3] -> [C, G-1]
    const int32_t* pK,
    const int32_t* pdc,           // [C, G-1, 3]
    const uint8_t* phasref,       // [C, G-1]
    const uint8_t* pmode,         // [C, G-1, nblk]
    const int16_t* pmvx, const int16_t* pmvy,
    const uint8_t* psub,          // [C, G-1, nblk]
    const uint8_t* pstable,       // [C, G-1, nblk]
    int64_t* prev_link_io,
    uint8_t* out, int64_t outcap) {
    int32_t nblk = nbh * nbv;
    uint32_t scap = (uint32_t)(nblk + 64);
    uint32_t mcap = (uint32_t)(nblk * 16 + 64);
    uint8_t* scratch = new uint8_t[scap];
    uint8_t* mscratch = new uint8_t[4 * mcap];
    int64_t off = 0;
    int64_t prev_link = *prev_link_io;
    int32_t GP = G - 1;
    bool overflow = false;

    for (int32_t g = 0; g < C && !overflow; g++) {
        int64_t gabs = g0 + g;
        if (gabs >= ngops) break;
        // metadata re-emit at GOP start (prev link stays 0)
        if (off + meta_len > outcap) { overflow = true; break; }
        memcpy(out + off, meta_pkt, (size_t)meta_len);
        off += meta_len;
        for (int32_t i = 0; i < G; i++) {
            int64_t fnum = gabs * (int64_t)G + i;
            if (fnum >= nframes) break;
            int has_ref = i == 0 ? 0 : (int)phasref[g * GP + (i - 1)];
            uint8_t pt = (uint8_t)(0x04 | ((pt_ref ? 1 : 0) << 1)
                                   | (has_ref ? 1 : 0));
            if (outcap - off < 64) { overflow = true; break; }
            BitWriter w(out + off, (uint32_t)((outcap - off) < 0x70000000
                                              ? (outcap - off) : 0x70000000));
            // PRECONDITION: `out` must arrive zero-initialized (the ctypes
            // wrapper allocates np.zeros) — BitWriter ORs bits into the
            // buffer and this function does NOT memset its output, unlike
            // dsv1n_pack_picture. The 64-byte memset is defense for the
            // fixed-layout header region only.
            memset(out + off, 0, 64);
            if (i == 0) {
                const int8_t* q[3]; const int32_t *ep[3], *ev[3];
                for (int c = 0; c < 3; c++) {
                    q[c] = iq8[c] + (int64_t)g * iN[c];
                    ep[c] = ipos[c] + (int64_t)g * iK[c];
                    ev[c] = ivals[c] + (int64_t)g * iK[c];
                }
                put_picture_head_w(w, fourcc, version, pt,
                                   (uint32_t)(fnum_base + fnum),
                                   blk_w, blk_h, nbh, nbv,
                                   istable + (int64_t)g * nblk, 0,
                                   nullptr, nullptr, nullptr, nullptr,
                                   quants[g * G], qp_bits, scratch, scap,
                                   mscratch, mcap);
                for (int c = 0; c < 3; c++)
                    put_plane_dense8_w(w, q[c], iN[c], ep[c], ev[c], iK[c],
                                       idc[g * 3 + c]);
            } else {
                int64_t fi = (int64_t)g * GP + (i - 1);
                put_picture_head_w(w, fourcc, version, pt,
                                   (uint32_t)(fnum_base + fnum),
                                   blk_w, blk_h, nbh, nbv,
                                   pstable + fi * nblk, has_ref,
                                   pmode + fi * nblk, pmvx + fi * nblk,
                                   pmvy + fi * nblk, psub + fi * nblk,
                                   quants[g * G + i], qp_bits, scratch, scap,
                                   mscratch, mcap);
                for (int c = 0; c < 3; c++)
                    put_plane_sparse16_w(w, pruns[c] + fi * pK[c],
                                         pvals[c] + fi * pK[c],
                                         pcnt[c][fi], pdc[fi * 3 + c]);
            }
            w.align();
            if (w.pos > w.cap * 8) { overflow = true; break; }
            int64_t plen = w.pos >> 3;
            patch_u32(out + off, 6, (uint32_t)prev_link);   // prev link
            patch_u32(out + off, 10, (uint32_t)plen);       // next link
            prev_link = plen;
            off += plen;
        }
    }
    delete[] scratch;
    delete[] mscratch;
    if (overflow) return -1;
    *prev_link_io = prev_link;
    return (int32_t)off;
}

} // extern "C"
