// Columnar Avro block decoder: decoded container blocks -> flat columns.
//
// Host-side ingestion of the reference's Avro training data
// (photon-avro-schemas/*.avsc via io/avro.py). The Python
// decoder builds a dict per record and a dict per feature — at 20M-row
// scale that is minutes of pure interpreter dispatch. This decoder walks
// the SAME binary stream driven by a tiny field "program" compiled from
// the schema on the Python side, and emits columns:
//
//   scalar fields  -> f64 value column + u8 null mask
//   string fields  -> byte arena + u32 offsets (+ null mask)
//   map<string,_>  -> per-row lengths + INTERNED key/value codes +
//                     unique-string tables
//   array<record>  -> per-row lengths + per-subfield columns (strings
//                     interned: i32 codes + unique table)
//   array<prim>    -> per-row lengths + f64 values
//
// Interning matters: feature names/terms and metadata keys repeat a few
// thousand distinct values across hundreds of millions of entries, so the
// Python side only ever decodes the UNIQUE table and treats entries as
// integer categories.
//
// Two passes over the (already decompressed) block bytes: pass 1 sizes
// every arena/column/unique table so the caller allocates exact numpy
// buffers, pass 2 fills them (the intern maps replay identically).
//
// Program: flat i64 array
//   [n_fields, field_op...]
//   field_op := OP, NULLABLE(null branch index or -1), n_sub, sub_ops...
//   sub_ops  := OP, NULLABLE
// OPs: 1=long/int 2=float 3=double 4=boolean 5=string 6=skip-null
//      7=map<string,string> 8=array<record> 9=array<double>
//      10=array<float> 11=array<long> 12=bytes(skip) 13=enum(as long)

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct Cursor {
    const uint8_t* p;
    const uint8_t* end;
    bool ok = true;

    int64_t read_long() {
        uint64_t acc = 0;
        int shift = 0;
        while (p < end) {
            uint8_t b = *p++;
            acc |= static_cast<uint64_t>(b & 0x7F) << shift;
            if (!(b & 0x80)) {
                return static_cast<int64_t>(acc >> 1) ^
                       -static_cast<int64_t>(acc & 1);
            }
            shift += 7;
            if (shift > 63) break;
        }
        ok = false;
        return 0;
    }
    double read_double() {
        if (p + 8 > end) { ok = false; return 0.0; }
        double v;
        std::memcpy(&v, p, 8);
        p += 8;
        return v;
    }
    double read_float() {
        if (p + 4 > end) { ok = false; return 0.0; }
        float v;
        std::memcpy(&v, p, 4);
        p += 4;
        return v;
    }
    int64_t read_boolean() {
        if (p >= end) { ok = false; return 0; }
        return *p++ != 0;
    }
    const uint8_t* read_bytes(int64_t* len) {
        *len = read_long();
        // compare against the remaining span, never p + *len: a corrupt
        // huge length would overflow the pointer (UB) and could pass
        if (*len < 0 || *len > end - p) { ok = false; *len = 0; return p; }
        const uint8_t* s = p;
        p += *len;
        return s;
    }
    void skip_bytes() {
        int64_t n;
        read_bytes(&n);
    }
};

enum Op : int64_t {
    OP_LONG = 1, OP_FLOAT = 2, OP_DOUBLE = 3, OP_BOOL = 4, OP_STRING = 5,
    OP_NULL = 6, OP_MAP_SS = 7, OP_ARR_REC = 8, OP_ARR_DOUBLE = 9,
    OP_ARR_FLOAT = 10, OP_ARR_LONG = 11, OP_BYTES_SKIP = 12, OP_ENUM = 13,
    // branch-tagged scalar union (e.g. the yahoo fixture's response:
    // ["double","float","int","long","boolean","string"]); the branch ops
    // ride in subs, a string branch parses numerically like Python's
    // float(str) would
    OP_UNION_PRIM = 14,
};

// Deterministic string interner: codes assigned in first-appearance order,
// so pass 1 (count) and pass 2 (fill) produce identical tables.
struct Intern {
    std::unordered_map<std::string, int32_t> map;
    uint8_t* uniq_arena = nullptr;    // pass 2
    uint32_t* uniq_offsets = nullptr; // pass 2, [n_uniq+1], [0] preset 0
    int64_t uniq_bytes = 0;

    int32_t put(const uint8_t* s, int64_t len) {
        std::string key(len > 0 ? reinterpret_cast<const char*>(s)
                                : "",
                        static_cast<size_t>(len > 0 ? len : 0));
        auto it = map.find(key);
        if (it != map.end()) return it->second;
        int32_t code = static_cast<int32_t>(map.size());
        map.emplace(std::move(key), code);
        if (uniq_arena) {
            if (len > 0)
                std::memcpy(uniq_arena + uniq_bytes, s, len);
            if (uniq_offsets)
                uniq_offsets[code + 1] =
                    static_cast<uint32_t>(uniq_bytes + (len > 0 ? len : 0));
        }
        uniq_bytes += (len > 0 ? len : 0);
        return code;
    }
};

struct FieldOut {
    double* values = nullptr;
    uint8_t* nulls = nullptr;
    uint8_t* arena = nullptr;      // top-level string payload
    uint32_t* offsets = nullptr;
    int32_t* lengths = nullptr;    // map/array entries per row
    int32_t* key_codes = nullptr;  // map keys (interned)
    int32_t* val_codes = nullptr;  // map values (interned)
    Intern key_intern;
    Intern val_intern;
    std::vector<FieldOut> subs;    // array<record> sub-fields
    int32_t* codes = nullptr;      // interned sub-string codes
    Intern intern;                 // sub-string interner
    int64_t count = 0;
    int64_t arena_bytes = 0;
};

struct Field {
    int64_t op;
    int64_t null_branch;
    std::vector<Field> subs;
};

bool parse_program(const int64_t* prog, int64_t prog_len,
                   std::vector<Field>* fields) {
    int64_t i = 0;
    if (prog_len < 1) return false;
    int64_t n = prog[i++];
    for (int64_t f = 0; f < n; ++f) {
        if (i + 3 > prog_len) return false;
        Field fld;
        fld.op = prog[i++];
        fld.null_branch = prog[i++];
        int64_t nsub = prog[i++];
        for (int64_t s = 0; s < nsub; ++s) {
            if (i + 2 > prog_len) return false;
            Field sub;
            sub.op = prog[i++];
            sub.null_branch = prog[i++];
            fld.subs.push_back(sub);
        }
        fields->push_back(fld);
    }
    return i == prog_len;
}

// Top-level scalar (row-indexed; strings arena-based, not interned —
// uids are near-unique so interning would only add hash cost).
bool do_scalar(Cursor& cur, const Field& f, FieldOut& out, int64_t row,
               int pass) {
    bool is_null = false;
    if (f.null_branch >= 0) {
        is_null = (cur.read_long() == f.null_branch);
    }
    if (pass == 1 && out.nulls) out.nulls[row] = is_null ? 1 : 0;
    if (is_null) {
        if (pass == 1 && out.values) out.values[row] = 0.0;
        if (pass == 1 && out.offsets)
            out.offsets[row + 1] = out.offsets[row];
        return cur.ok;
    }
    switch (f.op) {
        case OP_LONG:
        case OP_ENUM: {
            int64_t v = cur.read_long();
            if (pass == 1 && out.values)
                out.values[row] = static_cast<double>(v);
            break;
        }
        case OP_FLOAT: {
            double v = cur.read_float();
            if (pass == 1 && out.values) out.values[row] = v;
            break;
        }
        case OP_DOUBLE: {
            double v = cur.read_double();
            if (pass == 1 && out.values) out.values[row] = v;
            break;
        }
        case OP_BOOL: {
            int64_t v = cur.read_boolean();
            if (pass == 1 && out.values)
                out.values[row] = static_cast<double>(v);
            break;
        }
        case OP_STRING: {
            int64_t len;
            const uint8_t* s = cur.read_bytes(&len);
            if (pass == 0) {
                out.arena_bytes += len;
            } else if (out.arena && out.offsets) {
                uint32_t start = out.offsets[row];
                std::memcpy(out.arena + start, s, len);
                out.offsets[row + 1] = start + static_cast<uint32_t>(len);
            }
            break;
        }
        case OP_BYTES_SKIP:
            cur.skip_bytes();
            break;
        case OP_NULL:
            break;
        case OP_UNION_PRIM: {
            int64_t branch = cur.read_long();
            if (branch < 0 ||
                branch >= static_cast<int64_t>(f.subs.size()))
                return false;
            const int64_t bop = f.subs[branch].op;
            double v = 0.0;
            bool null_v = false;
            switch (bop) {
                case OP_LONG:
                    v = static_cast<double>(cur.read_long());
                    break;
                case OP_FLOAT:
                    v = cur.read_float();
                    break;
                case OP_DOUBLE:
                    v = cur.read_double();
                    break;
                case OP_BOOL:
                    v = static_cast<double>(cur.read_boolean());
                    break;
                case OP_STRING: {
                    int64_t len;
                    const uint8_t* s = cur.read_bytes(&len);
                    std::string tmp(reinterpret_cast<const char*>(s),
                                    static_cast<size_t>(len));
                    char* endp = nullptr;
                    v = std::strtod(tmp.c_str(), &endp);
                    // Python float() strictness: the WHOLE string must
                    // parse (trailing whitespace tolerated); a partial
                    // parse fails the decode, which the caller turns into
                    // an interpreted-path fallback
                    while (endp && *endp == ' ') ++endp;
                    if (endp == tmp.c_str() || (endp && *endp != '\0'))
                        return false;
                    break;
                }
                case OP_NULL:
                    null_v = true;
                    break;
                default:
                    return false;
            }
            if (pass == 1) {
                if (out.values) out.values[row] = null_v ? 0.0 : v;
                if (out.nulls) out.nulls[row] = null_v ? 1 : 0;
            }
            break;
        }
        default:
            return false;
    }
    return cur.ok;
}

// Sub-field inside array<record> items (entry-indexed; strings interned).
bool do_sub(Cursor& cur, const Field& f, FieldOut& out, int64_t entry,
            int pass) {
    bool is_null = false;
    if (f.null_branch >= 0) {
        is_null = (cur.read_long() == f.null_branch);
    }
    if (is_null) {
        // intern the empty string ONLY for string subs, and in BOTH
        // passes: pass-asymmetric interning would size the unique table
        // smaller than fill writes it (heap overflow)
        if (f.op == OP_STRING) {
            int32_t code = out.intern.put(nullptr, 0);
            if (pass == 1 && out.codes) out.codes[entry] = code;
        } else if (pass == 1 && out.values) {
            out.values[entry] = 0.0;
        }
        return cur.ok;
    }
    switch (f.op) {
        case OP_LONG:
        case OP_ENUM: {
            int64_t v = cur.read_long();
            if (pass == 1 && out.values)
                out.values[entry] = static_cast<double>(v);
            break;
        }
        case OP_FLOAT: {
            double v = cur.read_float();
            if (pass == 1 && out.values) out.values[entry] = v;
            break;
        }
        case OP_DOUBLE: {
            double v = cur.read_double();
            if (pass == 1 && out.values) out.values[entry] = v;
            break;
        }
        case OP_BOOL: {
            int64_t v = cur.read_boolean();
            if (pass == 1 && out.values)
                out.values[entry] = static_cast<double>(v);
            break;
        }
        case OP_STRING: {
            int64_t len;
            const uint8_t* s = cur.read_bytes(&len);
            int32_t code = out.intern.put(s, len);
            if (pass == 1 && out.codes) out.codes[entry] = code;
            break;
        }
        case OP_BYTES_SKIP:
            cur.skip_bytes();
            break;
        case OP_NULL:
            break;
        default:
            return false;
    }
    return cur.ok;
}

bool do_blocked(Cursor& cur, const Field& f, FieldOut& out, int64_t row,
                int pass) {
    int64_t total = 0;
    int64_t entry_base = out.count;
    while (true) {
        int64_t count = cur.read_long();
        if (!cur.ok) return false;
        if (count == 0) break;
        if (count < 0) {
            cur.read_long();  // block byte size, unused
            count = -count;
        }
        for (int64_t k = 0; k < count; ++k) {
            int64_t entry = entry_base + total;
            switch (f.op) {
                case OP_MAP_SS: {
                    int64_t klen;
                    const uint8_t* ks = cur.read_bytes(&klen);
                    int64_t vlen;
                    const uint8_t* vs = cur.read_bytes(&vlen);
                    int32_t kc = out.key_intern.put(ks, klen);
                    int32_t vc = out.val_intern.put(vs, vlen);
                    if (pass == 1) {
                        if (out.key_codes) out.key_codes[entry] = kc;
                        if (out.val_codes) out.val_codes[entry] = vc;
                    }
                    break;
                }
                case OP_ARR_REC: {
                    for (size_t s = 0; s < f.subs.size(); ++s) {
                        if (!do_sub(cur, f.subs[s], out.subs[s], entry,
                                    pass))
                            return false;
                    }
                    break;
                }
                case OP_ARR_DOUBLE: {
                    double v = cur.read_double();
                    if (pass == 1 && out.values) out.values[entry] = v;
                    break;
                }
                case OP_ARR_FLOAT: {
                    double v = cur.read_float();
                    if (pass == 1 && out.values) out.values[entry] = v;
                    break;
                }
                case OP_ARR_LONG: {
                    int64_t v = cur.read_long();
                    if (pass == 1 && out.values)
                        out.values[entry] = static_cast<double>(v);
                    break;
                }
                default:
                    return false;
            }
            ++total;
            if (!cur.ok) return false;
        }
    }
    out.count = entry_base + total;
    if (out.lengths) out.lengths[row] = static_cast<int32_t>(total);
    return cur.ok;
}

bool do_field(Cursor& cur, const Field& f, FieldOut& out, int64_t row,
              int pass) {
    switch (f.op) {
        case OP_MAP_SS:
        case OP_ARR_REC:
        case OP_ARR_DOUBLE:
        case OP_ARR_FLOAT:
        case OP_ARR_LONG: {
            bool is_null = false;
            if (f.null_branch >= 0) {
                is_null = (cur.read_long() == f.null_branch);
            }
            if (is_null) {
                if (out.lengths) out.lengths[row] = 0;
                return cur.ok;
            }
            return do_blocked(cur, f, out, row, pass);
        }
        default:
            return do_scalar(cur, f, out, row, pass);
    }
}

struct Shape {
    std::vector<Field> fields;
};

bool run_pass(const uint8_t* data, int64_t size, int64_t n_records,
              const Shape& shape, std::vector<FieldOut>& outs, int pass) {
    Cursor cur{data, data + size};
    for (auto& o : outs) o.count = 0;
    for (int64_t row = 0; row < n_records; ++row) {
        for (size_t i = 0; i < shape.fields.size(); ++i) {
            if (!do_field(cur, shape.fields[i], outs[i], row, pass))
                return false;
        }
    }
    return cur.ok && cur.p == cur.end;
}

constexpr int64_t kSizeMain = 7;  // count, arena, kuniq, kbytes, vuniq,
                                  // vbytes, (reserved)
constexpr int64_t kSizeSub = 2;   // nuniq, bytes
constexpr int64_t kPtrMain = 9;   // values nulls arena offsets lengths
                                  // key_codes kuniq_arena/offs pair,
                                  // val_codes ... see fill()
constexpr int64_t kPtrSub = 4;    // values codes uniq_arena uniq_offsets

}  // namespace

extern "C" {

// Pass 1. sizes_out per field: [count, arena_bytes, key_nuniq, key_bytes,
// val_nuniq, val_bytes, 0] then per sub: [nuniq, uniq_bytes]; field stride
// = 7 + 2 * max_subs.
int photon_avro_count(
    const uint8_t* data, int64_t size, int64_t n_records,
    const int64_t* prog, int64_t prog_len,
    int64_t max_subs,
    int64_t* sizes_out) {
    Shape shape;
    if (!parse_program(prog, prog_len, &shape.fields)) return 2;
    std::vector<FieldOut> outs(shape.fields.size());
    for (size_t i = 0; i < shape.fields.size(); ++i)
        outs[i].subs.resize(shape.fields[i].subs.size());
    if (!run_pass(data, size, n_records, shape, outs, 0)) return 1;
    const int64_t stride = kSizeMain + kSizeSub * max_subs;
    for (size_t i = 0; i < outs.size(); ++i) {
        int64_t* row = sizes_out + i * stride;
        row[0] = outs[i].count;
        row[1] = outs[i].arena_bytes;
        row[2] = static_cast<int64_t>(outs[i].key_intern.map.size());
        row[3] = outs[i].key_intern.uniq_bytes;
        row[4] = static_cast<int64_t>(outs[i].val_intern.map.size());
        row[5] = outs[i].val_intern.uniq_bytes;
        row[6] = 0;
        // only array<record> fields have per-sub OUTPUT columns; a scalar
        // union's subs are branch descriptors with no size entries (and
        // may outnumber max_subs)
        if (shape.fields[i].op == OP_ARR_REC) {
            for (size_t s = 0; s < outs[i].subs.size(); ++s) {
                row[kSizeMain + kSizeSub * s] = static_cast<int64_t>(
                    outs[i].subs[s].intern.map.size());
                row[kSizeMain + kSizeSub * s + 1] =
                    outs[i].subs[s].intern.uniq_bytes;
            }
        }
    }
    return 0;
}

// Pass 2. ptrs per field (stride 9 + 4 * max_subs), any may be null:
//   0 values f64*     1 nulls u8*      2 arena u8*      3 offsets u32*
//   4 lengths i32*    5 key_codes i32* 6 key_uniq pair (arena, offsets)
//   -> slots 6,7 = key uniq arena/offsets; 8 = val_codes; then per sub
//   4 slots: values, codes, uniq_arena, uniq_offsets. Val uniq arena and
//   offsets ride in the FIRST sub slot pair when op is map (maps have no
//   subs), i.e. slots 9,10.
int photon_avro_fill(
    const uint8_t* data, int64_t size, int64_t n_records,
    const int64_t* prog, int64_t prog_len,
    int64_t max_subs,
    void** ptrs) {
    Shape shape;
    if (!parse_program(prog, prog_len, &shape.fields)) return 2;
    const int64_t stride = kPtrMain + kPtrSub * max_subs;
    std::vector<FieldOut> outs(shape.fields.size());
    for (size_t i = 0; i < shape.fields.size(); ++i) {
        void** row = ptrs + i * stride;
        FieldOut& o = outs[i];
        o.values = static_cast<double*>(row[0]);
        o.nulls = static_cast<uint8_t*>(row[1]);
        o.arena = static_cast<uint8_t*>(row[2]);
        o.offsets = static_cast<uint32_t*>(row[3]);
        o.lengths = static_cast<int32_t*>(row[4]);
        o.key_codes = static_cast<int32_t*>(row[5]);
        o.key_intern.uniq_arena = static_cast<uint8_t*>(row[6]);
        o.key_intern.uniq_offsets = static_cast<uint32_t*>(row[7]);
        o.val_codes = static_cast<int32_t*>(row[8]);
        if (shape.fields[i].op == OP_MAP_SS && max_subs > 0) {
            o.val_intern.uniq_arena =
                static_cast<uint8_t*>(row[kPtrMain]);
            o.val_intern.uniq_offsets =
                static_cast<uint32_t*>(row[kPtrMain + 1]);
        }
        o.subs.resize(shape.fields[i].subs.size());
        if (shape.fields[i].op == OP_ARR_REC) {
            for (size_t s = 0; s < o.subs.size(); ++s) {
                void** srow = row + kPtrMain + kPtrSub * s;
                o.subs[s].values = static_cast<double*>(srow[0]);
                o.subs[s].codes = static_cast<int32_t*>(srow[1]);
                o.subs[s].intern.uniq_arena =
                    static_cast<uint8_t*>(srow[2]);
                o.subs[s].intern.uniq_offsets =
                    static_cast<uint32_t*>(srow[3]);
                if (o.subs[s].intern.uniq_offsets)
                    o.subs[s].intern.uniq_offsets[0] = 0;
            }
        }
        if (o.offsets) o.offsets[0] = 0;
        if (o.key_intern.uniq_offsets) o.key_intern.uniq_offsets[0] = 0;
        if (o.val_intern.uniq_offsets) o.val_intern.uniq_offsets[0] = 0;
    }
    if (!run_pass(data, size, n_records, shape, outs, 1)) return 1;
    return 0;
}

}  // extern "C"
