// Binning keys: the duplicate grid of both Gaussian populations, with the
// exact ellipse/tile test, in one launch.
//
// Replaces the Pallas TPU kernel easy_gaussian_splatting_tpu/ops/pallas/
// binkeys.py::binkeys (body _kernel), which the JAX package calls once per
// population. Plain PyTorch version and wrapper:
// easy_gaussian_splatting_torch/ops/kernels/binkeys.py.
//
// For Gaussian row i and cell j < m of its clamped w x h tile window
// (jy = j / w, jx = j % w), the cell is live when j < count and the
// Gaussian's contributing ellipse {sigma <= s_max} meets the tile's pixel
// rectangle (box-constrained minimum of the quadratic: 0 when the mean is
// inside, else the least of four clamped 1D edge minima). A cell's sort key
// is (tile << rank_bits) | rank, its flat id orig * m + j; a cell whose key
// is dead has tile num_tiles and flat id `sentinel_flat`.
// - Population a, every row i: its first n_keys cells, keys live where the
//   row's `pop` is 1 (0: dead; 2: the row belongs to the tail, whose slot
//   writes its count). counts[i] is its live cells among them.
// - The tail (population b), slot s of `tail`: row tail[s] (an id of n or
//   more is an empty slot: row n - 1, keys dead), all m cells, keys live
//   where the slot is not empty; it writes counts[tail[s]], the row's live
//   cells among all m.
// Keys and flats go straight into the sort domain: population a's
// [n_keys, n] cell-major, then the tail's [m, n_tail].
//
// What bounds it on an H100: memory, and the instructions of the test. Each
// row reads 52 bytes and writes 12 * n_keys + 4; the exact test is ~75 f32
// operations per tested cell, four of them IEEE divisions, which at 1-4
// cells per Gaussian costs about as many issue slots as the bytes take.
// Written as one population per launch, a few rows set the pace: a row of
// the tail looped to m cells in population a to count them (about a
// quarter of the warps held one at 1% overflow), each cell paid an integer
// division, and the second population's launch, its gathers and the
// selection of the counts cost ~10 small launches more. The design: one
// thread per row or slot, the tail's blocks first (they have 4x the cells,
// so they start while population a's fill the card), a row of the tail
// tests no cell in population a, an empty slot none, and the window walks
// its cells with an incremented column and row. Inputs structure-of-arrays
// ([6, n] f32 and [7, n] i32) and outputs cell-major, so every load and
// store of population a's warps is one contiguous line. The library is
// built with --fmad=false and the test is written in the expression order
// of the PyTorch version, so the float comparison s_min <= s_max rounds
// identically and keys match it bit for bit. Measured on an H100 80GB HBM3
// at 700 W (chip_smoke.py phase 12): 0.045 ms on the device for the served
// 800x800 frame of a 1M-Gaussian scene, 0.86x the two launches it replaced
// (0.052 ms), against a bound of 0.033 ms set by bytes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float sig(float a, float b, float cc, float dx, float dy) {
    return 0.5f * a * dx * dx + 0.5f * cc * dy * dy + b * dx * dy;
}

__device__ __forceinline__ float clampf(float v, float lo, float hi) {
    return fminf(fmaxf(v, lo), hi);
}

struct Row {
    float mx, my, a, b, cc, s_max;
    int tx0, ty0, w, count, rank, orig;
};

__device__ __forceinline__ Row load_row(const float* fgeo, const int* igeo, int n, int i)
{
    Row r;
    r.mx = fgeo[i];
    r.my = fgeo[n + i];
    r.a = fgeo[2 * n + i];
    r.b = fgeo[3 * n + i];
    r.cc = fgeo[4 * n + i];
    r.s_max = fgeo[5 * n + i];
    r.tx0 = igeo[i];
    r.ty0 = igeo[n + i];
    r.w = igeo[2 * n + i];
    r.count = igeo[3 * n + i];
    r.rank = igeo[4 * n + i];
    r.orig = igeo[5 * n + i];
    return r;
}

struct Grid {
    int m, ts, tiles_x, num_tiles, rank_bits, sentinel_flat;
};

// The row's first n_cells cells into keys / flats (cell j at j * stride):
// cells j < min(count, tested) take the exact test, the rest are not live;
// keys are live where a cell is and `live_keys`. Returns the live cells.
__device__ __forceinline__ int row_cells(
    const Row& r, bool live_keys, int n_cells, int tested, const Grid& g,
    long long* keys, int* flats, size_t stride)
{
    const float a_safe = fmaxf(r.a, 1e-12f);
    const float c_safe = fmaxf(r.cc, 1e-12f);
    const int w_safe = max(r.w, 1);
    const float tsf = (float)g.ts;
    const long long dead_key = ((long long)g.num_tiles << g.rank_bits) | r.rank;
    const int n_tested = min(r.count, tested);
    int cnt = 0, jx = 0, jy = 0;
    for (int j = 0; j < n_cells; ++j) {
        bool live = false;
        if (j < n_tested) {
            const float x0 = (float)((r.tx0 + jx) * g.ts) - r.mx;
            const float y0 = (float)((r.ty0 + jy) * g.ts) - r.my;
            const float x1 = x0 + tsf;
            const float y1 = y0 + tsf;
            const float ex0 = sig(r.a, r.b, r.cc, x0, clampf(-r.b * x0 / c_safe, y0, y1));
            const float ex1 = sig(r.a, r.b, r.cc, x1, clampf(-r.b * x1 / c_safe, y0, y1));
            const float ey0 = sig(r.a, r.b, r.cc, clampf(-r.b * y0 / a_safe, x0, x1), y0);
            const float ey1 = sig(r.a, r.b, r.cc, clampf(-r.b * y1 / a_safe, x0, x1), y1);
            const float s_edge = fminf(fminf(ex0, ex1), fminf(ey0, ey1));
            const bool inside = (x0 <= 0.0f) && (0.0f <= x1) && (y0 <= 0.0f) && (0.0f <= y1);
            const float s_min = inside ? 0.0f : s_edge;
            live = s_min <= r.s_max;
        }
        cnt += live;
        const bool key_live = live && live_keys;
        const int tile = (r.ty0 + jy) * g.tiles_x + r.tx0 + jx;
        keys[j * stride] = key_live ? (((long long)tile << g.rank_bits) | r.rank) : dead_key;
        flats[j * stride] = key_live ? r.orig * g.m + j : g.sentinel_flat;
        if (++jx == w_safe) {  // j / w_safe and j % w_safe, without a division
            jx = 0;
            ++jy;
        }
    }
    return cnt;
}

__global__ void __launch_bounds__(THREADS) binkeys_kernel(
    const float* __restrict__ fgeo,      // [6, n]: mx, my, a, b, c, s_max
    const int* __restrict__ igeo,        // [7, n]: tx0, ty0, w, count, rank, orig, pop
    int n, int n_keys, const Grid g,
    const long long* __restrict__ tail,  // [n_tail] row ids; n or more: empty slot
    int n_tail, int tail_blocks,
    long long* __restrict__ keys,        // [n_keys * n + m * n_tail]
    int* __restrict__ flats,             // [n_keys * n + m * n_tail]
    int* __restrict__ counts)            // [n]
{
    if ((int)blockIdx.x < tail_blocks) {
        const int s = blockIdx.x * THREADS + threadIdx.x;
        if (s >= n_tail) return;
        const long long id = tail[s];
        const bool slot = id < n;
        const int row = slot ? (int)id : n - 1;
        const int cnt = row_cells(load_row(fgeo, igeo, n, row), slot, g.m, slot ? g.m : 0, g,
                                  keys + (size_t)n_keys * n + s, flats + (size_t)n_keys * n + s,
                                  (size_t)n_tail);
        if (slot) counts[row] = cnt;
        return;
    }
    const int i = (blockIdx.x - tail_blocks) * THREADS + threadIdx.x;
    if (i >= n) return;
    const int pop = igeo[6 * n + i];
    const int cnt = row_cells(load_row(fgeo, igeo, n, i), pop == 1, n_keys, pop == 2 ? 0 : n_keys,
                              g, keys + i, flats + i, (size_t)n);
    if (pop != 2) counts[i] = cnt;
}

}  // namespace

extern "C" int egs_binkeys(
    const float* fgeo, const int* igeo, int n, int n_keys, int m, int ts,
    int tiles_x, int num_tiles, int rank_bits, int sentinel_flat,
    const long long* tail, int n_tail, long long* keys, int* flats, int* counts,
    int device, void* stream)
{
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    const Grid g = {m, ts, tiles_x, num_tiles, rank_bits, sentinel_flat};
    const int tail_blocks = (n_tail + THREADS - 1) / THREADS;
    const int blocks = tail_blocks + (n + THREADS - 1) / THREADS;
    binkeys_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        fgeo, igeo, n, n_keys, g, tail, n_tail, tail_blocks, keys, flats, counts);
    return (int)cudaGetLastError();
}
