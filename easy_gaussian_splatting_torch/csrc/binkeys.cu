// Binning keys: the duplicate grid of one Gaussian population, with the
// exact ellipse/tile test.
//
// Replaces the Pallas TPU kernel easy_gaussian_splatting_tpu/ops/pallas/
// binkeys.py::binkeys (body _kernel). Plain PyTorch version and wrapper:
// easy_gaussian_splatting_torch/ops/kernels/binkeys.py.
//
// For Gaussian row i and cell j < m of its clamped w x h tile window
// (jy = j / w, jx = j % w), the cell is live when j < count and the
// Gaussian's contributing ellipse {sigma <= s_max} meets the tile's pixel
// rectangle (box-constrained minimum of the quadratic: 0 when the mean is
// inside, else the least of four clamped 1D edge minima). For j < n_keys it
// writes the sort key (tile << rank_bits) | rank (sentinel tile num_tiles)
// and the flat id orig * m + j (sentinel `sentinel_flat`); over all j it
// counts the live cells with j < n_keys (count_small) and j < m
// (count_full). Key rows are live only where `livebase` is set
// (population membership); the counts ignore it.
//
// What bounds it on an H100: memory. Each row reads 52 bytes and writes
// 12 * n_keys + 8; the exact test is ~75 f32 operations per tested window
// cell, a few operations per byte moved at 1-4 cells per Gaussian, far
// below the ~20 operations per byte where the f32 units (67 TFLOP/s) would
// take over from HBM (3.35 TB/s). Design: one thread per Gaussian, inputs structure-of-arrays
// ([6, n] f32 and [7, n] i32) and outputs cell-major ([n_keys, n]), so
// every load and store of a warp is one contiguous 128-byte line. Window
// arithmetic is integer (the TPU kernel encoded integers in f32). The
// library is built with --fmad=false and the test is written in the
// expression order of the PyTorch version, so the float comparison
// s_min <= s_max rounds identically and keys match it bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float sig(float a, float b, float cc, float dx, float dy) {
    return 0.5f * a * dx * dx + 0.5f * cc * dy * dy + b * dx * dy;
}

__device__ __forceinline__ float clampf(float v, float lo, float hi) {
    return fminf(fmaxf(v, lo), hi);
}

__global__ void binkeys_kernel(
    const float* __restrict__ fgeo,  // [6, n]: mx, my, a, b, c, s_max
    const int* __restrict__ igeo,    // [7, n]: tx0, ty0, w, count, rank, orig, livebase
    int n, int n_keys, int m, int ts, int tiles_x, int num_tiles,
    int rank_bits, int sentinel_flat,
    long long* __restrict__ keys,    // [n_keys, n]
    int* __restrict__ flats,         // [n_keys, n]
    int* __restrict__ count_small,   // [n]
    int* __restrict__ count_full)    // [n]
{
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const float mx = fgeo[i];
    const float my = fgeo[n + i];
    const float a = fgeo[2 * n + i];
    const float b = fgeo[3 * n + i];
    const float cc = fgeo[4 * n + i];
    const float s_max = fgeo[5 * n + i];
    const int tx0 = igeo[i];
    const int ty0 = igeo[n + i];
    const int w = igeo[2 * n + i];
    const int count = igeo[3 * n + i];
    const int rank = igeo[4 * n + i];
    const int orig = igeo[5 * n + i];
    const bool livebase = igeo[6 * n + i] != 0;

    const float a_safe = fmaxf(a, 1e-12f);
    const float c_safe = fmaxf(cc, 1e-12f);
    const int w_safe = max(w, 1);
    const float tsf = (float)ts;
    const long long sentinel_key = ((long long)num_tiles << rank_bits) | rank;

    int cnt_small = 0, cnt_full = 0;
    const int j_end = max(min(count, m), n_keys);
    for (int j = 0; j < j_end; ++j) {
        const int jy = j / w_safe;
        const int jx = j - jy * w_safe;
        bool live = false;
        if (j < count) {
            const float x0 = (float)((tx0 + jx) * ts) - mx;
            const float y0 = (float)((ty0 + jy) * ts) - my;
            const float x1 = x0 + tsf;
            const float y1 = y0 + tsf;
            const float ex0 = sig(a, b, cc, x0, clampf(-b * x0 / c_safe, y0, y1));
            const float ex1 = sig(a, b, cc, x1, clampf(-b * x1 / c_safe, y0, y1));
            const float ey0 = sig(a, b, cc, clampf(-b * y0 / a_safe, x0, x1), y0);
            const float ey1 = sig(a, b, cc, clampf(-b * y1 / a_safe, x0, x1), y1);
            const float s_edge = fminf(fminf(ex0, ex1), fminf(ey0, ey1));
            const bool inside = (x0 <= 0.0f) && (0.0f <= x1) && (y0 <= 0.0f) && (0.0f <= y1);
            const float s_min = inside ? 0.0f : s_edge;
            live = s_min <= s_max;
        }
        cnt_full += live;
        if (j < n_keys) {
            cnt_small += live;
            const bool key_live = live && livebase;
            const int tile = (ty0 + jy) * tiles_x + tx0 + jx;
            const size_t o = (size_t)j * n + i;
            keys[o] = key_live ? (((long long)tile << rank_bits) | rank) : sentinel_key;
            flats[o] = key_live ? orig * m + j : sentinel_flat;
        }
    }
    count_small[i] = cnt_small;
    count_full[i] = cnt_full;
}

}  // namespace

extern "C" int egs_binkeys(
    const float* fgeo, const int* igeo, int n, int n_keys, int m, int ts,
    int tiles_x, int num_tiles, int rank_bits, int sentinel_flat,
    long long* keys, int* flats, int* count_small, int* count_full,
    int device, void* stream)
{
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    const int threads = 256;
    const int blocks = (n + threads - 1) / threads;
    binkeys_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        fgeo, igeo, n, n_keys, m, ts, tiles_x, num_tiles, rank_bits,
        sentinel_flat, keys, flats, count_small, count_full);
    return (int)cudaGetLastError();
}
