// ScoringResultAvro block encoder: score/label/weight/uid columns -> the
// exact Avro binary record stream io/model_io.save_scored_items writes.
//
// Scoring output is the one remaining per-record Python hot path at the
// 20M-row scale target (photon-avro-schemas ScoringResultAvro;
// avro/data/ScoreProcessingUtils.scala is the reference writer). Record
// layout encoded here, field by field (union branch order [null, X]):
//
//   uid:             varint branch (0 null / 1) [+ len + bytes]
//   label:           varint branch [+ f64 LE]
//   modelId:         len + bytes              (constant per file)
//   predictionScore: f64 LE
//   weight:          varint branch [+ f64 LE]
//   metadataMap:     varint branch 0 (null)
//
// The caller allocates an upper-bound buffer; the function returns bytes
// written (or -1 on overflow/bad args). Container framing (header, block
// counts, deflate, sync markers) stays in Python — zlib there runs at C
// speed already.

#include <cstdint>
#include <cstring>

namespace {

inline int64_t zigzag(int64_t n) {
    return (n << 1) ^ (n >> 63);
}

inline bool put_varlong(uint8_t*& p, const uint8_t* end, int64_t value) {
    uint64_t v = static_cast<uint64_t>(zigzag(value));
    while (true) {
        if (p >= end) return false;
        uint8_t b = v & 0x7F;
        v >>= 7;
        if (v) {
            *p++ = b | 0x80;
        } else {
            *p++ = b;
            return true;
        }
    }
}

inline bool put_double(uint8_t*& p, const uint8_t* end, double v) {
    if (p + 8 > end) return false;
    std::memcpy(p, &v, 8);
    p += 8;
    return true;
}

}  // namespace

extern "C" {

// Returns bytes written, or -1 on bad arguments / overflow of `capacity`.
// labels/weights/uid_* may be null (their unions encode the null branch).
// uid_offsets is u32[n+1] into uid_arena.
int64_t photon_encode_scores(
    int64_t n,
    const double* scores,
    const double* labels,
    const double* weights,
    const uint8_t* uid_arena,
    const uint32_t* uid_offsets,
    const uint8_t* model_id,
    int64_t model_id_len,
    uint8_t* out,
    int64_t capacity) {
    if (n < 0 || !scores || !model_id || !out || capacity <= 0) return -1;
    if ((uid_arena == nullptr) != (uid_offsets == nullptr)) return -1;
    uint8_t* p = out;
    const uint8_t* end = out + capacity;
    for (int64_t i = 0; i < n; ++i) {
        // uid
        if (uid_arena) {
            const uint32_t lo = uid_offsets[i];
            const uint32_t hi = uid_offsets[i + 1];
            if (!put_varlong(p, end, 1)) return -1;
            if (!put_varlong(p, end, static_cast<int64_t>(hi - lo)))
                return -1;
            if (p + (hi - lo) > end) return -1;
            std::memcpy(p, uid_arena + lo, hi - lo);
            p += hi - lo;
        } else {
            if (!put_varlong(p, end, 0)) return -1;
        }
        // label
        if (labels) {
            if (!put_varlong(p, end, 1)) return -1;
            if (!put_double(p, end, labels[i])) return -1;
        } else {
            if (!put_varlong(p, end, 0)) return -1;
        }
        // modelId (non-union string)
        if (!put_varlong(p, end, model_id_len)) return -1;
        if (p + model_id_len > end) return -1;
        std::memcpy(p, model_id, model_id_len);
        p += model_id_len;
        // predictionScore
        if (!put_double(p, end, scores[i])) return -1;
        // weight
        if (weights) {
            if (!put_varlong(p, end, 1)) return -1;
            if (!put_double(p, end, weights[i])) return -1;
        } else {
            if (!put_varlong(p, end, 0)) return -1;
        }
        // metadataMap: null branch
        if (!put_varlong(p, end, 0)) return -1;
    }
    return p - out;
}

}  // extern "C"
