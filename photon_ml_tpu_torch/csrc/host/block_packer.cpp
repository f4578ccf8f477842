// Entity-block packer: CSR rows -> padded per-entity dense blocks.
//
// The port's own copy of the JAX package's entity-block packer, built
// into the host library by photon_ml_tpu_torch/io/native_loader.py.
// Host-side ingestion hot path of the GAME random-effect dataset build
// (photon_ml_tpu_torch/game/dataset.py build_random_effect_dataset and
// its streamed form). The numpy
// formulation materializes several nnz-length int64 temporaries (composite
// keys, searchsorted positions, validity masks) — ~2.5 GB of traffic at
// 10M rows x 8 nnz. This routine streams the CSR arrays once: for every
// stored element it binary-searches the owning entity's sorted reduced
// feature table (d_red entries, L1-resident) and writes the value directly
// into its [n_out, d_red] destination row. Features absent from the
// entity's table are skipped, matching the reference's projected-space
// semantics (RandomEffectDataSet.scala:169-206 + LocalDataSet projection).
//
// The same entry serves the active block fill (out rows = entity*n_max +
// slot) and the passive sample-major fill (out rows = 0..P-1): the caller
// provides the flat output row per CSR row and the table row per CSR row.
//
// Single-threaded: the loop is memory-bound on the CSR stream.

#include <cstdint>
#include <cstring>

extern "C" {

// Returns 0 on success, 1 on bad arguments. `out` must be zero-initialized
// [n_out, d_red] float32 row-major; writes are last-write-wins per (row,
// reduced column), which is exact because canonical CSR has unique columns
// per row.
int photon_pack_projected_rows(
    int64_t n_rows,
    const int64_t* indptr,    // [n_rows + 1]
    const int32_t* indices,   // [indptr[n_rows]] raw column of each nnz
    const float* data,        // [indptr[n_rows]]
    const int64_t* table_of,  // [n_rows] row into raw_indices per CSR row
    const int64_t* out_row_of,// [n_rows] flat output row per CSR row
    const int32_t* raw_indices, // [n_tables, d_red], ascending per row
                                // (pad sentinel >= any real column)
    int64_t n_tables,
    int64_t d_red,
    int64_t n_out,
    float* out)
{
    if (n_rows < 0 || d_red <= 0 || !indptr || !indices || !data ||
        !table_of || !out_row_of || !raw_indices || !out) {
        return 1;
    }
    for (int64_t r = 0; r < n_rows; ++r) {
        const int64_t t = table_of[r];
        const int64_t o = out_row_of[r];
        if (t < 0 || t >= n_tables || o < 0 || o >= n_out) return 1;
        const int32_t* table = raw_indices + t * d_red;
        float* dst = out + o * d_red;
        const int64_t end = indptr[r + 1];
        for (int64_t k = indptr[r]; k < end; ++k) {
            const int32_t col = indices[k];
            // lower_bound over the entity's sorted reduced table
            int64_t lo = 0, hi = d_red;
            while (lo < hi) {
                const int64_t mid = (lo + hi) >> 1;
                if (table[mid] < col) lo = mid + 1; else hi = mid;
            }
            if (lo < d_red && table[lo] == col) {
                dst[lo] = data[k];
            }
        }
    }
    return 0;
}

// ELL pack: CSR rows -> fixed-width [n, k] index/value planes (the
// photon_ml_tpu_torch/data/batch.py ell_from_csr hot loop without the two
// nnz-length fancy-index scatters). Rows longer than k are an error (the
// caller sizes k = max row length, padded).
int photon_pack_ell(
    int64_t n_rows,
    const int64_t* indptr,   // [n_rows + 1]
    const int32_t* indices,  // [nnz]
    const float* data,       // [nnz]
    int64_t k,
    int32_t* out_idx,        // [n_rows * k], zero-initialized
    float* out_val)          // [n_rows * k], zero-initialized
{
    if (n_rows < 0 || k <= 0 || !indptr || !indices || !data ||
        !out_idx || !out_val) {
        return 1;
    }
    for (int64_t r = 0; r < n_rows; ++r) {
        const int64_t start = indptr[r];
        const int64_t len = indptr[r + 1] - start;
        if (len < 0 || len > k) return 1;
        int32_t* di = out_idx + r * k;
        float* dv = out_val + r * k;
        std::memcpy(di, indices + start,
                    static_cast<size_t>(len) * sizeof(int32_t));
        std::memcpy(dv, data + start,
                    static_cast<size_t>(len) * sizeof(float));
    }
    return 0;
}

}  // extern "C"
