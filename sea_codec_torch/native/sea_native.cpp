// sea_native: clean-room scalar C++ implementation of the SEA codec, the
// PyTorch port's host codec.
//
// Role in sea_codec_torch (its CUDA kernels are the primary path):
//   1. The host VBR row pack: batch.serialize_full_chunks packs full VBR
//      chunks' scale factors, 2-bit relative sizes and variable-width
//      residuals through sea_native_pack_rows (rows shard over a few host
//      threads), as the JAX package's serializer does. The encoders pack
//      the rows of chunks on a card there (csrc/serialize_vbr.cu).
//   2. The CLI's host backend: `seaconv --backend native` encodes and
//      decodes through sea_native_encode / sea_native_decode on the host,
//      with no card.
//   3. An independent check: written separately from the same format
//      semantics (SURVEY.md), it agrees bit for bit with the port's kernels
//      and with the JAX package on random inputs.
//
// This file is a copy of sea_codec_tpu/native/sea_native.cpp, identical
// below this comment: the port imports nothing of the JAX package.
//
// Semantics notes (matching the reference implementation, by behavior):
//   - All "i32" arithmetic wraps; C++ signed overflow is UB, so products and
//     sums that can overflow are computed through uint32_t casts.
//   - f32 table generation matches the reference: powf-based scale factors
//     truncated to i32, dequant curve 0.5 + k*floor(step) with endpoint
//     overrides, round-half-away, reciprocal trunc(65536.f / sf).
//   - Residual sizes are capped at 8 in the VBR chooser (the reference
//     panics at target 8.0; see models/vbr.py for the rationale).
//
// Build: sea_codec_torch/native/binding.py runs the host C++ compiler (g++,
// then c++, then clang++) with -O2 -shared -fPIC -std=c++17 into the build
// cache (utils/cache.py: SEA_TORCH_CACHE, else build/sea_codec_torch/), as
// sea_native-<source hash>.so; no external dependencies, no CUDA.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <numeric>
#include <vector>

namespace {

constexpr int LMS_LEN = 4;

inline int32_t wrap_add(int32_t a, int32_t b) {
    return (int32_t)((uint32_t)a + (uint32_t)b);
}
inline int32_t wrap_mul(int32_t a, int32_t b) {
    return (int32_t)((uint32_t)a * (uint32_t)b);
}

inline int16_t clamp_i16(int32_t v) {
    if (v > 32767) return 32767;
    if (v < -32768) return -32768;
    return (int16_t)v;
}

// ----- tables ---------------------------------------------------------------

const float IDEAL_POW_FACTOR[8] = {12.0f, 11.65f, 11.20f, 10.58f, 9.64f, 8.75f, 7.66f, 6.63f};

struct Tables {
    // -1 = unbuilt sentinel: build_tables(sfb) can never alias the unbuilt
    // state (sfb is validated 1..8 before every build, but keep the guard).
    int sfb = -1;
    // per residual size 1..8 (index 0 unused)
    std::vector<int32_t> scale_factors[9];
    std::vector<int32_t> reciprocals[9];
    std::vector<std::vector<int32_t>> dqt[9];  // [sf][code]
};

void fill_zigzag(uint8_t* t, int items) {
    int midpoint = items / 2;
    int x = items / 2 - 1;
    t[0] = (uint8_t)x;
    for (int i = 1; i + 1 < midpoint + 1 && i < midpoint; i += 2) {
        t[i] = (uint8_t)x;
        t[i + 1] = (uint8_t)x;
        x -= 2;
    }
    x = 0;
    for (int i = midpoint; i < items - 1; i += 2) {
        t[i] = (uint8_t)x;
        t[i + 1] = (uint8_t)x;
        x += 2;
    }
    t[items - 1] = (uint8_t)(x - 2);
    if (items == 9) {  // residual size 2 special case
        t[2] = 1;
        t[6] = 0;
    }
}

struct QuantTab {
    uint8_t tab[5 + 9 + 17 + 33 + 65 + 129 + 257 + 513];
    int offsets[9];
    QuantTab() {
        int off = 0;
        for (int shift = 2; shift <= 9; shift++) {
            offsets[shift - 1] = off;
            int items = (1 << shift) + 1;
            fill_zigzag(tab + off, items);
            off += items;
        }
    }
};
const QuantTab QT;

void build_tables(Tables& t, int sfb) {
    if (t.sfb == sfb) return;
    t.sfb = sfb;
    int n_sf = 1 << sfb;
    for (int rb = 1; rb <= 8; rb++) {
        float pf = IDEAL_POW_FACTOR[rb - 1] / (float)sfb;
        auto& sf = t.scale_factors[rb];
        auto& rec = t.reciprocals[rb];
        sf.assign(n_sf, 0);
        rec.assign(n_sf, 0);
        for (int i = 1; i <= n_sf; i++) {
            sf[i - 1] = (int32_t)powf((float)i, pf);
            rec[i - 1] = (int32_t)(65536.0f / (float)sf[i - 1]);
        }
        // dequant curve
        int steps = 1 << (rb - 1);
        std::vector<float> curve(steps, 0.f);
        if (rb == 1) {
            curve[0] = 2.0f;
        } else if (rb == 2) {
            curve[0] = 1.115f;
            curve[1] = 4.0f;
        } else {
            float start = 0.75f;
            float end = (float)((1 << rb) - 1);
            float step = (end - start) / (float)(steps - 1);
            float stepf = floorf(step);
            for (int i = 1; i < steps; i++) curve[i] = 0.5f + (float)i * stepf;
            curve[0] = start;
            curve[steps - 1] = end;
        }
        auto& d = t.dqt[rb];
        d.assign(n_sf, std::vector<int32_t>(2 * steps, 0));
        for (int s = 0; s < n_sf; s++) {
            for (int k = 0; k < steps; k++) {
                int32_t val = (int32_t)roundf((float)sf[s] * curve[k]);
                d[s][2 * k] = val;
                d[s][2 * k + 1] = -val;
            }
        }
    }
}

// ----- LMS ------------------------------------------------------------------

struct Lms {
    int32_t history[LMS_LEN] = {0, 0, 0, 0};
    int32_t weights[LMS_LEN] = {0, 0, 0, 0};
    void init_encoder() {
        history[0] = history[1] = history[2] = history[3] = 0;
        weights[0] = weights[1] = 0;
        weights[2] = -(1 << 13);
        weights[3] = 1 << 14;
    }
    int32_t predict() const {
        int32_t p = 0;
        for (int i = 0; i < LMS_LEN; i++) p = wrap_add(p, wrap_mul(weights[i], history[i]));
        return p >> 13;
    }
    void update(int16_t sample, int32_t dequantized) {
        int32_t delta = dequantized >> 4;
        for (int i = 0; i < LMS_LEN; i++)
            weights[i] = wrap_add(weights[i], history[i] < 0 ? -delta : delta);
        for (int i = 0; i < LMS_LEN - 1; i++) history[i] = history[i + 1];
        history[LMS_LEN - 1] = sample;
    }
    uint64_t weights_penalty() const {
        int64_t sum = 0;
        for (int i = 0; i < LMS_LEN; i++)
            sum += (int64_t)weights[i] * (int64_t)weights[i];
        int64_t p = (sum >> 18) - 0x8ff;
        if (p < 0) p = 0;
        return (uint64_t)p * (uint64_t)p;
    }
};

// ----- bit packing ----------------------------------------------------------

struct BitPacker {
    uint32_t accum = 0, stored = 0;
    std::vector<uint8_t> out;
    void push(uint32_t v, uint32_t bits) {
        accum = (accum << bits) | (v & ((1u << bits) - 1));
        stored += bits;
        if (stored >= 8) {
            out.push_back((uint8_t)(accum >> (stored - 8)));
            stored -= 8;
            accum &= (1u << stored) - 1;
        }
    }
    void finish() {
        if (stored > 0) {
            out.push_back((uint8_t)(accum << (8 - stored)));
            stored = 0;
            accum = 0;
        }
    }
};

struct BitUnpacker {
    const uint8_t* data;
    size_t len, pos = 0;
    uint32_t carry = 0, stored = 0;
    BitUnpacker(const uint8_t* d, size_t l) : data(d), len(l) {}
    // extract items of `bits` width until `count` items produced
    bool next(uint32_t bits, uint8_t* out) {
        while (stored < bits) {
            if (pos >= len) return false;
            carry = (carry << 8) | data[pos++];
            stored += 8;
        }
        *out = (uint8_t)((carry >> (stored - bits)) & ((1u << bits) - 1));
        stored -= bits;
        carry &= (1u << stored) - 1;
        return true;
    }
};

// ----- fixed-point division -------------------------------------------------

inline int32_t sea_div(int32_t v, int32_t reciprocal) {
    int64_t n = ((int64_t)v * (int64_t)reciprocal + (1 << 15)) >> 16;
    int64_t sv = v > 0 ? 1 : (v < 0 ? -1 : 0);
    int64_t sn = n > 0 ? 1 : (n < 0 ? -1 : 0);
    return (int32_t)(n + (sv - sn));
}

// ----- encoder core ---------------------------------------------------------

struct EncoderState {
    int channels;
    int sfb;
    std::vector<Lms> lms;
    std::vector<int32_t> prev_sf;
    Tables tables;
};

uint64_t calculate_residuals(const EncoderState& st, const int32_t* dqt_row,
                             const int16_t* samples, size_t n_frames, size_t stride,
                             int32_t scalefactor, Lms& lms, uint64_t best_rank,
                             int rs, const int32_t* recips, uint8_t* out_codes) {
    uint64_t rank = 0;
    int32_t clamp_limit = 1 << rs;
    int qt_off = QT.offsets[rs] + clamp_limit;
    for (size_t i = 0; i < n_frames; i++) {
        int32_t sample = samples[i * stride];
        int32_t predicted = lms.predict();
        int32_t residual = sample - predicted;
        int32_t scaled = sea_div(residual, recips[scalefactor]);
        int32_t clamped = std::min(std::max(scaled, -clamp_limit), clamp_limit);
        uint8_t q = QT.tab[qt_off + clamped];
        int32_t dq = dqt_row[q];
        int16_t recon = clamp_i16(wrap_add(predicted, dq));
        int64_t err = (int64_t)sample - (int64_t)recon;
        rank += (uint64_t)(err * err) + lms.weights_penalty();
        if (rank > best_rank) break;
        lms.update(recon, dq);
        out_codes[i] = q;
    }
    return rank;
}

void search_window(EncoderState& st, const int16_t* samples, size_t n_frames,
                   int channel, int rs, uint8_t* out_sf, uint8_t* out_codes,
                   uint64_t* out_rank) {
    int n_sf = 1 << st.sfb;
    const auto& dqt = st.tables.dqt[rs];
    const auto& recips = st.tables.reciprocals[rs];
    uint64_t best_rank = UINT64_MAX;
    Lms best_lms;
    int32_t best_sf = 0;
    std::vector<uint8_t> cur(n_frames), best(n_frames);
    for (int i = 0; i < n_sf; i++) {
        int32_t sf = (i + st.prev_sf[channel]) % n_sf;
        Lms lms = st.lms[channel];
        uint64_t rank =
            calculate_residuals(st, dqt[sf].data(), samples + channel, n_frames,
                                st.channels, sf, lms, best_rank, rs, recips.data(), cur.data());
        if (rank < best_rank) {
            best_rank = rank;
            best = cur;
            best_lms = lms;
            best_sf = sf;
        }
    }
    st.prev_sf[channel] = best_sf;
    st.lms[channel] = best_lms;
    *out_sf = (uint8_t)best_sf;
    *out_rank = best_rank;
    for (size_t i = 0; i < n_frames; i++) out_codes[i * st.channels + channel] = best[i];
}

// encode one chunk's worth of samples; returns per-window sf, codes, ranks
void encode_windows(EncoderState& st, const int16_t* samples, size_t n_frames,
                    const uint8_t* rs_per_window_channel,  // [n_windows][channels]
                    size_t sff, std::vector<uint8_t>& sf_out,
                    std::vector<uint8_t>& codes_out, std::vector<uint64_t>& ranks_out) {
    size_t n_windows = (n_frames + sff - 1) / sff;
    sf_out.assign(n_windows * st.channels, 0);
    codes_out.assign(n_frames * st.channels, 0);
    ranks_out.assign(n_windows * st.channels, 0);
    for (size_t w = 0; w < n_windows; w++) {
        size_t start = w * sff;
        size_t wf = std::min(sff, n_frames - start);
        for (int ch = 0; ch < st.channels; ch++) {
            search_window(st, samples + start * st.channels, wf, ch,
                          rs_per_window_channel[w * st.channels + ch],
                          &sf_out[w * st.channels + ch],
                          &codes_out[start * st.channels], &ranks_out[w * st.channels + ch]);
        }
    }
}

// ----- VBR size selection ---------------------------------------------------

const float TARGET_DIST[6] = {0.00f, 0.00f, 0.95f, 0.05f, 0.00f, 0.00f};

float normalized_vbr_bitrate(float residual_bits, int fpc, int sfb, int sff) {
    float v = residual_bits;
    v -= (float)(LMS_LEN * 16 * 2) / (float)fpc;
    v -= (float)sfb / (float)sff;
    v -= 2.0f / (float)sff;
    float base = floorf(residual_bits);
    float nb = TARGET_DIST[1] * (base - 1.0f) + TARGET_DIST[2] * base +
               TARGET_DIST[3] * (base + 1.0f) + TARGET_DIST[4] * (base + 2.0f);
    v -= (nb - base);
    return v;
}

void interpolate_distribution(size_t items, float target, size_t res[4]) {
    float frac = target - truncf(target);
    float om = 1.0f - frac;
    float pct[4];
    for (int i = 0; i < 4; i++) pct[i] = TARGET_DIST[i] * frac + TARGET_DIST[i + 1] * om;
    res[0] = res[1] = res[2] = res[3] = 0;
    size_t sum = 0;
    while (sum < items) {
        size_t remaining = items - sum;
        for (int i = 0; i < 4; i++) {
            size_t value = (size_t)((float)remaining * pct[i]);
            sum += value;
            res[i] += value;
        }
        if (items - sum == remaining) {
            sum += remaining;
            res[1] += remaining;
        }
    }
}

std::vector<uint8_t> choose_residual_sizes(size_t input_len, size_t sff, float target,
                                           const std::vector<uint64_t>& errors) {
    size_t sortable = input_len / sff;
    std::vector<uint32_t> idx(sortable);
    std::iota(idx.begin(), idx.end(), 0);
    std::stable_sort(idx.begin(), idx.end(),
                     [&](uint32_t a, uint32_t b) { return errors[a] < errors[b]; });
    size_t dist[4];
    interpolate_distribution(sortable, target, dist);
    uint8_t base = target <= 0.f ? 0 : (target >= 255.f ? 255 : (uint8_t)target);
    std::vector<uint8_t> sizes(errors.size(), base);
    for (size_t i = 0; i < dist[0]; i++) sizes[idx[i]] = base - 1;
    for (size_t i = sortable - dist[3] - dist[2]; i < sortable - dist[3]; i++)
        sizes[idx[i]] = base + 1;
    for (size_t i = sortable - dist[3]; i < sortable; i++) sizes[idx[i]] = base + 2;
    for (auto& s : sizes) s = std::min<uint8_t>(std::max<uint8_t>(s, 1), 8);
    return sizes;
}

// ----- container ------------------------------------------------------------

void put_u16(std::vector<uint8_t>& o, uint16_t v) {
    o.push_back(v & 0xFF);
    o.push_back(v >> 8);
}
void put_u32(std::vector<uint8_t>& o, uint32_t v) {
    for (int i = 0; i < 4; i++) o.push_back((v >> (8 * i)) & 0xFF);
}

struct Settings {
    int sfb = 4;
    int sff = 20;
    float residual_bits = 3.0f;
    int fpc = 5120;
    int vbr = 0;
};

void serialize_chunk(std::vector<uint8_t>& out, const EncoderState& st,
                     const std::vector<Lms>& entry_lms, const Settings& cfg,
                     size_t n_frames, const std::vector<uint8_t>& sf,
                     const std::vector<uint8_t>& codes,
                     const std::vector<uint8_t>& vbr_sizes) {
    out.push_back(cfg.vbr ? 0x02 : 0x01);
    int residual_size = (int)floorf(cfg.residual_bits);
    if (cfg.vbr) {
        // anchor the delta base so 2-bit deltas stay in 0..3 (the reference
        // writes corrupt streams for high-overhead configs; see models/vbr.py)
        float target = normalized_vbr_bitrate(cfg.residual_bits, cfg.fpc, cfg.sfb, cfg.sff);
        int base = target <= 0.f ? 0 : (target >= 255.f ? 255 : (int)target);
        if (residual_size > base + 1) residual_size = base + 1;
    }
    out.push_back((uint8_t)((cfg.sfb << 4) | residual_size));
    out.push_back((uint8_t)cfg.sff);
    out.push_back(0x5A);
    for (const auto& l : entry_lms) {
        for (int i = 0; i < LMS_LEN; i++) {
            int16_t h = (int16_t)l.history[i];
            out.push_back(h & 0xFF);
            out.push_back((h >> 8) & 0xFF);
        }
        for (int i = 0; i < LMS_LEN; i++) {
            int16_t w = (int16_t)l.weights[i];
            out.push_back(w & 0xFF);
            out.push_back((w >> 8) & 0xFF);
        }
    }
    BitPacker p;
    for (uint8_t v : sf) p.push(v, cfg.sfb);
    p.finish();
    out.insert(out.end(), p.out.begin(), p.out.end());
    if (cfg.vbr) {
        BitPacker vp;
        for (uint8_t v : vbr_sizes) vp.push((uint32_t)(v - residual_size + 1), 2);
        vp.finish();
        out.insert(out.end(), vp.out.begin(), vp.out.end());
        BitPacker rp;
        size_t n_windows = vbr_sizes.size() / st.channels;
        for (size_t f = 0; f < n_frames; f++) {
            size_t w = f / cfg.sff;
            for (int ch = 0; ch < st.channels; ch++)
                rp.push(codes[f * st.channels + ch], vbr_sizes[w * st.channels + ch]);
        }
        rp.finish();
        out.insert(out.end(), rp.out.begin(), rp.out.end());
    } else {
        BitPacker rp;
        for (uint8_t v : codes) rp.push(v, residual_size);
        rp.finish();
        out.insert(out.end(), rp.out.begin(), rp.out.end());
    }
}

}  // namespace

// ----- public C ABI ---------------------------------------------------------

extern "C" {

// Encode interleaved i16 samples into a .sea byte stream. Returns 0 on
// success; the output buffer is malloc'd and must be freed with
// sea_native_free.
int sea_native_encode(const int16_t* samples, uint64_t n_samples, uint32_t channels,
                      uint32_t sample_rate, int sfb, int sff, float residual_bits,
                      int fpc, int vbr, const char* metadata, uint32_t metadata_len,
                      uint8_t** out, uint64_t* out_len) {
    if (channels == 0 || channels > 255 || sff <= 0 || fpc <= 0 || fpc % sff != 0)
        return 1;
    Settings cfg{sfb, sff, residual_bits, fpc, vbr};
    EncoderState st;
    st.channels = (int)channels;
    st.sfb = sfb;
    st.lms.assign(channels, Lms());
    for (auto& l : st.lms) l.init_encoder();
    st.prev_sf.assign(channels, 0);
    build_tables(st.tables, sfb);

    uint64_t total_frames = n_samples / channels;
    std::vector<uint8_t> body;
    uint16_t chunk_size = 0;

    int residual_size = (int)floorf(residual_bits);
    float vbr_target = normalized_vbr_bitrate(residual_bits, fpc, sfb, sff);
    // trunc-to-u8 with saturation (Rust `f32 as u8` semantics)
    uint8_t vbr_base = vbr_target <= 0.f ? 0 : (vbr_target >= 255.f ? 255 : (uint8_t)vbr_target);

    for (uint64_t start = 0; start < total_frames; start += fpc) {
        size_t n_frames = (size_t)std::min<uint64_t>(fpc, total_frames - start);
        const int16_t* chunk_samples = samples + start * channels;
        size_t n_windows = (n_frames + sff - 1) / sff;
        std::vector<Lms> entry_lms = st.lms;
        std::vector<uint8_t> sf, codes, vbr_sizes;
        std::vector<uint64_t> ranks;
        if (vbr) {
            // pass 1: analyze at base+1, restore LMS (keep prev_sf)
            std::vector<Lms> saved = st.lms;
            std::vector<uint8_t> rs1(n_windows * channels, vbr_base + 1);
            encode_windows(st, chunk_samples, n_frames, rs1.data(), sff, sf, codes, ranks);
            st.lms = saved;
            vbr_sizes = choose_residual_sizes(n_frames * channels, sff, vbr_target, ranks);
            encode_windows(st, chunk_samples, n_frames, vbr_sizes.data(), sff, sf, codes, ranks);
        } else {
            std::vector<uint8_t> rs(n_windows * channels, (uint8_t)residual_size);
            encode_windows(st, chunk_samples, n_frames, rs.data(), sff, sf, codes, ranks);
        }
        std::vector<uint8_t> chunk;
        serialize_chunk(chunk, st, entry_lms, cfg, n_frames, sf, codes, vbr_sizes);
        if (chunk.size() > 0xFFFF) return 3;  // u16 chunk_size overflow
        if (chunk_size == 0) chunk_size = (uint16_t)chunk.size();
        body.insert(body.end(), chunk.begin(), chunk.end());
    }

    std::vector<uint8_t> header;
    header.push_back('s');
    header.push_back('e');
    header.push_back('a');
    header.push_back('c');
    header.push_back(1);
    header.push_back((uint8_t)channels);
    put_u16(header, chunk_size);
    put_u16(header, (uint16_t)fpc);
    put_u32(header, sample_rate);
    put_u32(header, (uint32_t)total_frames);
    put_u32(header, metadata_len);
    for (uint32_t i = 0; i < metadata_len; i++) header.push_back((uint8_t)metadata[i]);

    *out_len = header.size() + body.size();
    *out = (uint8_t*)malloc(*out_len);
    memcpy(*out, header.data(), header.size());
    memcpy(*out + header.size(), body.data(), body.size());
    return 0;
}

// Decode a .sea byte stream. Returns 0 on success. With out == NULL, only
// header info is reported (probe). Output must hold total_frames * channels
// int16 values.
int sea_native_decode(const uint8_t* data, uint64_t len, int16_t* out,
                      uint32_t* out_channels, uint32_t* out_rate,
                      uint64_t* out_total_frames) {
    if (len < 22 || memcmp(data, "seac", 4) != 0 || data[4] != 1) return 1;
    uint32_t channels = data[5];
    uint16_t chunk_size = (uint16_t)(data[6] | (data[7] << 8));
    uint16_t fpc = (uint16_t)(data[8] | (data[9] << 8));
    uint32_t rate = data[10] | (data[11] << 8) | (data[12] << 16) | ((uint32_t)data[13] << 24);
    uint32_t total_frames =
        data[14] | (data[15] << 8) | (data[16] << 16) | ((uint32_t)data[17] << 24);
    uint32_t metadata_len =
        data[18] | (data[19] << 8) | (data[20] << 16) | ((uint32_t)data[21] << 24);
    if (channels == 0 || chunk_size < 16 || fpc == 0 || rate == 0) return 1;
    *out_channels = channels;
    *out_rate = rate;
    size_t pos = 22 + (size_t)metadata_len;
    if (pos > len) return 1;  // metadata_len past EOF: (len - pos) would wrap
    uint64_t frames_avail = total_frames;
    if (total_frames == 0) {
        // streaming: count whole chunks (frame count unknowable from header)
        frames_avail = ((len - pos) / chunk_size) * fpc;
    }
    // a corrupt total_frames can exceed what the bytes can possibly hold;
    // clamp so the caller's probe-sized output buffer stays plausible
    uint64_t max_frames =
        ((len - pos + chunk_size - 1) / chunk_size) * (uint64_t)fpc;
    if (frames_avail > max_frames) frames_avail = max_frames;
    *out_total_frames = frames_avail;
    if (out == nullptr) return 0;

    Tables tables;
    uint64_t frames_done = 0;
    while (frames_done < frames_avail && pos < len) {
        size_t avail = std::min<size_t>(chunk_size, len - pos);
        const uint8_t* c = data + pos;
        size_t n_frames = (size_t)std::min<uint64_t>(fpc, frames_avail - frames_done);
        if (avail < 4) return 2;
        int chunk_type = c[0];
        int sfb = c[1] >> 4;
        int residual_size = c[1] & 0x0F;
        int sff = c[2];
        if ((chunk_type != 1 && chunk_type != 2) || residual_size < 1 || residual_size > 8 ||
            sfb < 1 || sfb > 8 || sff == 0)
            return 2;
        build_tables(tables, sfb);
        size_t cpos = 4;
        std::vector<Lms> lms(channels);
        if (avail < cpos + channels * 16) return 2;
        for (uint32_t ch = 0; ch < channels; ch++) {
            for (int i = 0; i < LMS_LEN; i++) {
                lms[ch].history[i] = (int16_t)(c[cpos] | (c[cpos + 1] << 8));
                cpos += 2;
            }
            for (int i = 0; i < LMS_LEN; i++) {
                lms[ch].weights[i] = (int16_t)(c[cpos] | (c[cpos + 1] << 8));
                cpos += 2;
            }
        }
        size_t n_windows = (n_frames + sff - 1) / sff;
        size_t sf_items = n_windows * channels;
        size_t sf_bytes = (sf_items * sfb + 7) / 8;
        if (avail < cpos + sf_bytes) return 2;
        std::vector<uint8_t> sf(sf_items);
        {
            BitUnpacker u(c + cpos, sf_bytes);
            for (size_t i = 0; i < sf_items; i++)
                if (!u.next(sfb, &sf[i])) return 2;
            cpos += sf_bytes;
        }
        std::vector<uint8_t> sizes;
        if (chunk_type == 2) {
            size_t vbr_bytes = (sf_items * 2 + 7) / 8;
            if (avail < cpos + vbr_bytes) return 2;
            sizes.resize(sf_items);
            BitUnpacker u(c + cpos, vbr_bytes);
            for (size_t i = 0; i < sf_items; i++) {
                uint8_t v;
                if (!u.next(2, &v)) return 2;
                sizes[i] = (uint8_t)(v + residual_size - 1);
                if (sizes[i] < 1 || sizes[i] > 8) return 2;
            }
            cpos += vbr_bytes;
        }
        BitUnpacker u(c + cpos, avail - cpos);
        for (size_t f = 0; f < n_frames; f++) {
            size_t w = f / sff;
            for (uint32_t ch = 0; ch < channels; ch++) {
                int rs = chunk_type == 2 ? sizes[w * channels + ch] : residual_size;
                uint8_t q;
                if (!u.next((uint32_t)rs, &q)) return 2;
                int32_t predicted = lms[ch].predict();
                int32_t dq = tables.dqt[rs][sf[w * channels + ch]][q];
                int16_t recon = clamp_i16(wrap_add(predicted, dq));
                out[(frames_done + f) * channels + ch] = recon;
                lms[ch].update(recon, dq);
            }
        }
        frames_done += n_frames;
        pos += chunk_size;
    }
    return frames_done == frames_avail ? 0 : 2;
}

void sea_native_free(void* p) { free(p); }

// Table dumps for cross-validation against the Python/JAX table generation.
void sea_native_dump_dqt(int sfb, int rb, int32_t* out /* [2^sfb][2^rb] */) {
    Tables t;
    build_tables(t, sfb);
    int n_sf = 1 << sfb;
    int n_code = 1 << rb;
    for (int s = 0; s < n_sf; s++)
        for (int q = 0; q < n_code; q++) out[s * n_code + q] = t.dqt[rb][s][q];
}

void sea_native_dump_reciprocals(int sfb, int rb, int32_t* out /* [2^sfb] */) {
    Tables t;
    build_tables(t, sfb);
    for (int s = 0; s < (1 << sfb); s++) out[s] = t.reciprocals[rb][s];
}

// Row-batched MSB-first bitpacking for the Python batch serializer: the VBR
// residual section has data-dependent per-item widths, which neither the
// device serializer (static layouts only) nor vectorized numpy handles well.
// widths == NULL packs every item at const_width bits. Rows are independent;
// the ctypes call releases the GIL, so the Python side shards rows across
// threads. Output rows are row_bytes apart, final partial byte left-aligned.
void sea_native_pack_rows(const uint8_t* values, const uint8_t* widths,
                          int const_width, long n_rows, long count,
                          long row_bytes, uint8_t* out) {
    for (long r = 0; r < n_rows; r++) {
        const uint8_t* v = values + r * count;
        const uint8_t* w = widths ? widths + r * count : nullptr;
        uint8_t* o = out + r * row_bytes;
        uint32_t acc = 0;
        int stored = 0;
        long pos = 0;
        for (long i = 0; i < count; i++) {
            int width = w ? w[i] : const_width;
            acc = (acc << width) | (uint32_t)(v[i] & ((1u << width) - 1u));
            stored += width;
            while (stored >= 8) {
                o[pos++] = (uint8_t)(acc >> (stored - 8));
                stored -= 8;
            }
            acc &= (1u << stored) - 1u;
        }
        if (stored > 0) o[pos++] = (uint8_t)(acc << (8 - stored));
        while (pos < row_bytes) o[pos++] = 0;
    }
}

}  // extern "C"
