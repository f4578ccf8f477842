// Native LibSVM parser: text -> CSR arrays, multithreaded.
//
// The PyTorch port's own copy of the JAX package's LibSVM parser, built by
// io/native_loader.py into the port's host library. It replaces the
// reference's host-side ingestion hot path (reference: photon-ml/src/main/
// scala/com/linkedin/photon/ml/io/LibSVMInputDataFormat.scala:31-77, a
// per-line Spark map): mmap'd input, per-thread chunking at line
// boundaries, two-phase (count, then fill) CSR construction with no
// reallocation.
//
// C ABI (used from Python via ctypes, io/native_loader.py):
//   photon_libsvm_open(path, out_rows, out_nnz) -> handle (NULL on error)
//       mmaps the file and runs the parallel count pass ONCE; the handle
//       carries the mapping and per-chunk row/nnz offsets so the fill pass
//       reuses them (no re-scan, no count/fill file-change race).
//   photon_libsvm_fill(handle, zero_based, labels[rows], indptr[rows+1],
//                      indices[nnz], values[nnz], out_max_index) -> 0/err
//   photon_libsvm_close(handle)
//
// Semantics mirror the Python reference loop in io/data_format.py
// load_libsvm exactly:
//   - the first whitespace-delimited token is the label and must parse
//     fully as a number (a label like "1:2" is an error, not a feature);
//   - every remaining token must be exactly "<int>:<float>" — a token
//     without a colon, or with trailing junk, is an error (Python's
//     item.split(":") unpack/float would raise there too);
//   - labels are returned raw (binarization happens in Python).

#include <cctype>
#include <cerrno>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct Mapped {
    const char* data = nullptr;
    size_t size = 0;
    int fd = -1;

    bool open_file(const char* path) {
        fd = ::open(path, O_RDONLY);
        if (fd < 0) return false;
        struct stat st;
        if (fstat(fd, &st) != 0) { ::close(fd); fd = -1; return false; }
        size = static_cast<size_t>(st.st_size);
        if (size == 0) { data = nullptr; return true; }
        void* p = mmap(nullptr, size, PROT_READ, MAP_PRIVATE, fd, 0);
        if (p == MAP_FAILED) { ::close(fd); fd = -1; return false; }
        data = static_cast<const char*>(p);
        return true;
    }

    ~Mapped() {
        if (data) munmap(const_cast<char*>(data), size);
        if (fd >= 0) ::close(fd);
    }
};

// In-line whitespace (everything isspace() treats as space except '\n',
// which is the record separator).
inline bool is_ws(char c) {
    return c == ' ' || c == '\t' || c == '\r' || c == '\v' || c == '\f';
}

inline const char* skip_ws(const char* p, const char* end) {
    while (p < end && is_ws(*p)) ++p;
    return p;
}

inline const char* token_end(const char* p, const char* end) {
    while (p < end && !is_ws(*p)) ++p;
    return p;
}

// A chunk is a [begin, end) byte range; normally into the mmap, but the
// final unterminated line (if any) lives in a NUL-terminated copy — the
// libc number parsers are unbounded, and an mmap whose size is an exact
// page multiple has no readable byte past the end.
struct Chunk {
    const char* begin;
    const char* end;
};

// Split [0, newline_region) into per-thread ranges aligned to line starts.
std::vector<Chunk> chunk_lines(const char* data, size_t size,
                               unsigned threads) {
    std::vector<Chunk> out;
    if (size == 0) return out;
    size_t per = size / threads;
    size_t start = 0;
    for (unsigned t = 0; t < threads && start < size; ++t) {
        size_t end = (t + 1 == threads) ? size
                                        : std::min(size, start + per);
        while (end < size && data[end - 1] != '\n') ++end;
        out.push_back(Chunk{data + start, data + end});
        start = end;
    }
    return out;
}

struct LineStats {
    int64_t rows = 0;
    int64_t nnz = 0;
};

// Count rows and feature tokens in one chunk (phase 1). Counts EVERY
// post-label token as a potential feature — the fill pass errors out on
// malformed tokens, so over-counting only ever over-allocates.
void count_chunk(Chunk chunk, LineStats* stats) {
    const char* p = chunk.begin;
    const char* end = chunk.end;
    while (p < end) {
        const char* line_end = static_cast<const char*>(
            memchr(p, '\n', static_cast<size_t>(end - p)));
        if (!line_end) line_end = end;
        const char* q = skip_ws(p, line_end);
        if (q < line_end) {
            ++stats->rows;
            const char* r = token_end(q, line_end);  // skip label token
            while (true) {
                r = skip_ws(r, line_end);
                if (r >= line_end) break;
                r = token_end(r, line_end);
                ++stats->nnz;
            }
        }
        p = line_end + 1;
    }
}

struct ParserState {
    Mapped m;
    std::string tail;  // final line without trailing newline, NUL-safe copy
    std::vector<Chunk> chunks;
    std::vector<LineStats> stats;
    int64_t rows = 0;
    int64_t nnz = 0;
};

struct FillCtx {
    const ParserState* st;
    size_t chunk;
    int zero_based;
    double* labels;
    int64_t* indptr;
    int32_t* indices;
    double* values;
    int64_t row_offset;
    int64_t nnz_offset;
    int64_t max_index = -1;
    int error = 0;
};

void fill_chunk(FillCtx* ctx) {
    const char* p = ctx->st->chunks[ctx->chunk].begin;
    const char* end = ctx->st->chunks[ctx->chunk].end;
    int64_t row = ctx->row_offset;
    int64_t k = ctx->nnz_offset;
    while (p < end) {
        const char* line_end = static_cast<const char*>(
            memchr(p, '\n', static_cast<size_t>(end - p)));
        if (!line_end) line_end = end;
        const char* q = skip_ws(p, line_end);
        if (q < line_end) {
            // Label: the WHOLE first token must parse as a number — keeps
            // the nnz accounting aligned with count_chunk and matches the
            // Python float(ts[0]).
            const char* label_end = token_end(q, line_end);
            char* after = nullptr;
            double label = strtod(q, &after);
            if (after != label_end) { ctx->error = -2; return; }
            ctx->labels[row] = label;
            ctx->indptr[row] = k;
            const char* r = label_end;
            while (true) {
                r = skip_ws(r, line_end);
                if (r >= line_end) break;
                const char* tok = r;
                const char* tok_e = token_end(r, line_end);
                r = tok_e;
                const char* colon = static_cast<const char*>(
                    memchr(tok, ':', static_cast<size_t>(tok_e - tok)));
                if (!colon) { ctx->error = -7; return; }  // "abc"
                if (colon == tok) { ctx->error = -3; return; }  // ":5"
                errno = 0;
                long idx = strtol(tok, &after, 10);
                if (after != colon) { ctx->error = -3; return; }
                // Reject indices that would wrap in the int32 indices
                // array (strtol saturates with ERANGE on long overflow).
                if (errno == ERANGE || idx > INT32_MAX) {
                    ctx->error = -8;
                    return;
                }
                if (!ctx->zero_based) --idx;
                if (idx < 0) { ctx->error = -4; return; }
                double v = strtod(colon + 1, &after);
                // Whole remainder must be the value ("1:2:3" is an error,
                // as Python's 2-way split unpack would raise).
                if (after != tok_e || after == colon + 1) {
                    ctx->error = -5;
                    return;
                }
                ctx->indices[k] = static_cast<int32_t>(idx);
                ctx->values[k] = v;
                if (idx > ctx->max_index) ctx->max_index = idx;
                ++k;
            }
            ++row;
        }
        p = line_end + 1;
    }
}

unsigned n_threads(size_t size) {
    unsigned hw = std::thread::hardware_concurrency();
    if (hw == 0) hw = 4;
    // Small files: one thread avoids churn.
    if (size < (1u << 20)) return 1;
    return hw;
}

}  // namespace

extern "C" {

void* photon_libsvm_open(const char* path, int64_t* out_rows,
                         int64_t* out_nnz) {
    auto* st = new ParserState();
    if (!st->m.open_file(path)) { delete st; return nullptr; }
    // Carve off the final unterminated line into a NUL-terminated copy.
    size_t region = st->m.size;
    while (region > 0 && st->m.data[region - 1] != '\n') --region;
    if (region < st->m.size)
        st->tail.assign(st->m.data + region, st->m.size - region);
    unsigned threads = n_threads(region);
    st->chunks = chunk_lines(st->m.data, region, threads);
    if (!st->tail.empty())
        st->chunks.push_back(Chunk{st->tail.data(),
                                   st->tail.data() + st->tail.size()});
    st->stats.resize(st->chunks.size());
    std::vector<std::thread> pool;
    for (size_t i = 0; i < st->chunks.size(); ++i)
        pool.emplace_back(count_chunk, st->chunks[i], &st->stats[i]);
    for (auto& t : pool) t.join();
    for (auto& s : st->stats) { st->rows += s.rows; st->nnz += s.nnz; }
    *out_rows = st->rows;
    *out_nnz = st->nnz;
    return st;
}

int photon_libsvm_fill(void* handle, int zero_based, double* labels,
                       int64_t* indptr, int32_t* indices, double* values,
                       int64_t* out_max_index) {
    auto* st = static_cast<ParserState*>(handle);
    if (!st) return -1;
    std::vector<FillCtx> ctxs(st->chunks.size());
    int64_t row_off = 0, nnz_off = 0;
    for (size_t i = 0; i < st->chunks.size(); ++i) {
        ctxs[i] = FillCtx{st, i, zero_based, labels, indptr, indices,
                          values, row_off, nnz_off};
        row_off += st->stats[i].rows;
        nnz_off += st->stats[i].nnz;
    }
    std::vector<std::thread> pool;
    for (auto& c : ctxs) pool.emplace_back(fill_chunk, &c);
    for (auto& t : pool) t.join();
    int64_t max_index = -1;
    for (auto& c : ctxs) {
        if (c.error) return c.error;
        if (c.max_index > max_index) max_index = c.max_index;
    }
    indptr[st->rows] = st->nnz;
    *out_max_index = max_index;
    return 0;
}

void photon_libsvm_close(void* handle) {
    delete static_cast<ParserState*>(handle);
}

}  // extern "C"
