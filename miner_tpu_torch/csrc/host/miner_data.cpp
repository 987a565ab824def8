// miner_data: the port's host data plane, compiled by g++ (no card needed).
//
// The per-epoch negative sampling / candidate shuffling (reference semantics:
// src/entities.py:256-315) and the UnBERT sequence packer (reference:
// src/entities.py:617-669) are per-sample Python loops in the reference; at
// MIND scale (millions of behaviors lines, 5x oversampling) they dominate
// host time.  These C++ implementations are exposed through a C ABI and
// loaded via ctypes (miner_tpu_torch/data/native.py); the numpy
// implementations in miner_tpu_torch/data/ remain the behavioral reference
// and the fallback.
//
// This file is the port's own copy of the JAX package's native/miner_data.cpp:
// the same C ABI (version 2) and the same draws, so that both packages sample
// the same epochs from the same seed.
//
// Determinism: sampling uses a splitmix64-seeded xoshiro256** stream keyed by
// (seed, epoch, event) so results are reproducible and order-independent
// (each event's draw is independent of batch/shard order). The stream is
// deliberately NOT numpy's PCG64 — the numpy fallback keeps the same
// invariants (tests/test_torch_native.py), not the same draws.
//
// Build: g++ -O3 -shared -fPIC -std=c++17, at first use, into
// miner_tpu_torch/build/ (miner_tpu_torch/data/native.py).

#include <cstdint>
#include <cstring>
#include <algorithm>

namespace {

struct Rng {
    uint64_t s[4];

    static uint64_t splitmix(uint64_t& x) {
        x += 0x9E3779B97f4A7C15ULL;
        uint64_t z = x;
        z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ULL;
        z = (z ^ (z >> 27)) * 0x94D049BB133111EBULL;
        return z ^ (z >> 31);
    }

    explicit Rng(uint64_t seed) {
        uint64_t x = seed;
        for (auto& v : s) v = splitmix(x);
    }

    static uint64_t rotl(uint64_t x, int k) { return (x << k) | (x >> (64 - k)); }

    uint64_t next() {
        const uint64_t result = rotl(s[1] * 5, 7) * 9;
        const uint64_t t = s[1] << 17;
        s[2] ^= s[0];
        s[3] ^= s[1];
        s[1] ^= s[2];
        s[0] ^= s[3];
        s[2] ^= t;
        s[3] = rotl(s[3], 45);
        return result;
    }

    // uniform integer in [0, n) without modulo bias (Lemire)
    uint64_t below(uint64_t n) {
        if (n == 0) return 0;
        __uint128_t m = (__uint128_t)next() * n;
        uint64_t lo = (uint64_t)m;
        if (lo < n) {
            uint64_t t = (-n) % n;
            while (lo < t) {
                m = (__uint128_t)next() * n;
                lo = (uint64_t)m;
            }
        }
        return (uint64_t)(m >> 64);
    }
};

// Fisher-Yates partial shuffle / reservoir-free sample without replacement.
template <typename T>
void sample_without_replacement(Rng& rng, const T* src, int n, int k, T* out) {
    // k <= n expected; use index swapping on a small stack buffer when
    // possible, else a simple selection loop (n is the per-impression
    // negative count — small).
    int idx[512];
    int m = n < 512 ? n : 512;
    for (int i = 0; i < m; ++i) idx[i] = i;
    if (n <= 512) {
        for (int i = 0; i < k; ++i) {
            int j = i + (int)rng.below((uint64_t)(n - i));
            std::swap(idx[i], idx[j]);
            out[i] = src[idx[i]];
        }
    } else {
        // rejection sampling for pathological negative counts
        for (int i = 0; i < k; ++i) {
            bool dup;
            T cand;
            do {
                cand = src[rng.below((uint64_t)n)];
                dup = false;
                for (int j = 0; j < i; ++j)
                    if (out[j] == cand) { dup = true; break; }
            } while (dup);
            out[i] = cand;
        }
    }
}

}  // namespace

extern "C" {

// Bumped on any C-ABI change; the Python loader rebuilds a stale .so whose
// version symbol is missing or mismatched
// (miner_tpu_torch/data/native.py).
int32_t miner_data_abi_version() { return 2; }

// mode: 0 = base (one positive, random augmentation variant),
//       1 = hard (1..min(V,npratio)-1 augmented positives first).
// cand_out: (E, C) int32 global indices; label_out: (E, C) float32.
void miner_sample_epoch(
    uint64_t seed, uint64_t epoch, int mode,
    int64_t num_events, int C, int V, int64_t N,
    const int32_t* pos_row,
    const int32_t* neg_flat, const int32_t* neg_offsets,
    int32_t* cand_out, float* label_out) {
    const int npratio = C - 1;
    for (int64_t e = 0; e < num_events; ++e) {
        Rng rng(seed * 0x9E3779B97f4A7C15ULL ^ (epoch + 1) * 0xD1B54A32D192ED03ULL ^
                (uint64_t)(e + 1) * 0x8CB92BA72F3D8DD7ULL);
        const int32_t* negs = neg_flat + neg_offsets[e];
        const int n_neg = neg_offsets[e + 1] - neg_offsets[e];
        const int64_t pos = pos_row[e];

        int32_t row[512];
        float lab[512];
        for (int c = 0; c < C; ++c) { row[c] = 0; lab[c] = 0.f; }

        int n_pos_slots = 1;
        if (mode == 1 && V > 1) {
            int cap = std::min(V, npratio);
            int num_pick = cap > 1 ? 1 + (int)rng.below((uint64_t)(cap - 1)) : 1;
            // distinct sorted variants
            int variants[64];
            int vv[64];
            for (int i = 0; i < V; ++i) vv[i] = i;
            for (int i = 0; i < num_pick; ++i) {
                int j = i + (int)rng.below((uint64_t)(V - i));
                std::swap(vv[i], vv[j]);
                variants[i] = vv[i];
            }
            std::sort(variants, variants + num_pick);
            for (int i = 0; i < num_pick; ++i)
                row[i] = (int32_t)(variants[i] * N + pos);
            n_pos_slots = num_pick;
        } else {
            int variant = V > 1 ? (int)rng.below((uint64_t)V) : 0;
            row[0] = (int32_t)(variant * N + pos);
        }
        lab[0] = 1.f;

        const int need = C - n_pos_slots;
        if (n_neg >= need) {
            sample_without_replacement(rng, negs, n_neg, need, row + n_pos_slots);
        } else {
            for (int i = 0; i < n_neg; ++i) row[n_pos_slots + i] = negs[i];
            // remaining slots stay 0 (pad news)
        }

        // joint shuffle of (row, lab)
        for (int i = C - 1; i > 0; --i) {
            int j = (int)rng.below((uint64_t)(i + 1));
            std::swap(row[i], row[j]);
            std::swap(lab[i], lab[j]);
        }
        std::memcpy(cand_out + e * C, row, C * sizeof(int32_t));
        std::memcpy(label_out + e * C, lab, C * sizeof(float));
    }
}

// UnBERT cross-encoder packing (reference: src/entities.py:617-669).
// tokens: (R, Lt) int32 padded titles; lens: (R,) int32 actual title length
// already capped at news_max_len. For each of B rows: candidate cand_rows[b]
// plus hist_rows[b*H .. b*H+H-1] packed into seq_max_len ids.
// legacy: 1 = the reference's pads-first history layout — pad rows (r == 0)
// are packed as real 2-token sentences instead of terminating the scan
// (reference: src/reader.py:154 prepends pads; src/entities.py:627-632
// iterates clicked_news[:hist_max_len] unconditionally).
void miner_pack_unbert(
    int64_t B, int H,
    const int32_t* tokens, const int32_t* lens, int64_t Lt,
    const int32_t* cand_rows, const int32_t* hist_rows,
    int seq_max_len, int news_max_len, int hist_max_len,
    int cls_id, int sep_id, int pad_id, int legacy,
    int32_t* input_ids, int32_t* input_mask, int32_t* segment_ids,
    int32_t* news_segment_ids, int32_t* sentence_ids, int32_t* sentence_mask,
    int32_t* sentence_segment_ids) {
    const int S = 3 + hist_max_len;
    for (int64_t b = 0; b < B; ++b) {
        int32_t* ids = input_ids + b * seq_max_len;
        int32_t* msk = input_mask + b * seq_max_len;
        int32_t* seg = segment_ids + b * seq_max_len;
        int32_t* nseg = news_segment_ids + b * seq_max_len;
        for (int i = 0; i < seq_max_len; ++i) {
            ids[i] = pad_id; msk[i] = 0; seg[i] = 0; nseg[i] = 0;
        }

        const int32_t cand = cand_rows[b];
        const int cand_len = lens[cand];
        const int tmp_hist_len = seq_max_len - cand_len - 3;

        int p = 0;
        ids[p++] = cls_id;
        for (int i = 0; i < cand_len; ++i) { nseg[p] = 1; ids[p++] = tokens[cand * Lt + i]; }
        ids[p++] = sep_id;
        const int hist_start = p;

        int n_sent = 3;
        int written = 0;
        const int n_hist = H < hist_max_len ? H : hist_max_len;
        for (int i = 0; i < n_hist; ++i) {
            const int32_t r = hist_rows[b * H + i];
            if (r == 0 && !legacy) break;  // pad news ends a clicks-first row
            const int l = lens[r];
            for (int t = 0; t < l && written < tmp_hist_len; ++t) {
                nseg[p] = i + 2;
                ids[p++] = tokens[r * Lt + t];
                ++written;
            }
            ++n_sent;
        }
        ids[p++] = sep_id;
        for (int i = 0; i < p; ++i) msk[i] = 1;
        for (int i = hist_start; i < p; ++i) seg[i] = 1;
        // specials keep news segment 0; candidate was marked 1 above;
        // final [SEP] already 0.
        nseg[p - 1] = 0;

        int32_t* sid = sentence_ids + b * S;
        int32_t* smk = sentence_mask + b * S;
        int32_t* sseg = sentence_segment_ids + b * S;
        for (int i = 0; i < S; ++i) { sid[i] = 0; smk[i] = 0; sseg[i] = 0; }
        const int ns = n_sent < S ? n_sent : S;
        for (int i = 0; i < ns; ++i) { sid[i] = i; smk[i] = 1; sseg[i] = i >= 3 ? 1 : 0; }
    }
}

}  // extern "C"
