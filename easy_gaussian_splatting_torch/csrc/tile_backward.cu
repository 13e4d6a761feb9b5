// Tiled backward compositing: one image tile's depth-ordered intersection
// list, back to front, for every pixel of the tile; per intersection, the
// gradient of the loss with respect to its screen mean, conic, opacity and
// colour, summed over the tile's pixels.
//
// Replaces the Pallas TPU kernel easy_gaussian_splatting_tpu/ops/pallas/
// tile_raster.py::tiled_backward (body _bwd_kernel). Plain PyTorch version
// and wrapper: easy_gaussian_splatting_torch/ops/kernels/tile_raster.py.
//
// Tile t owns intersections [offsets[t], offsets[t+1]) of feats [I, 16]
// (rows of rasterize_tiled.pack_features). Pixel p starts from the forward's
// final transmittance T = T_fin and the suffix term S = g_T * T_fin, and
// walks back from the tile's horizon min(max_p last_p + 1, end). An
// intersection at or before last_p that the forward's eligibility test
// (tile_eligibility.cuh, shared by both kernels and rounded the same way
// whatever their build flags) accepts was composited, so for it:
//   T_g = T / (1 - alpha)            transmittance in front of it
//   v_alpha = (g . c) T_g - S / (1 - alpha)
//   v_sigma = -alpha_raw v_alpha     (alpha_raw = exp(-max(s2, nlo)))
//   S += (g . c) alpha T_g,  T = T_g
// and, with dx = mx - px, dy = my - py in tile-local coordinates,
//   v_mx = v_sigma (a dx + b dy), v_my = v_sigma (b dx + c dy),
//   v_a = v_sigma dx^2 / 2, v_b = v_sigma dx dy, v_c = v_sigma dy^2 / 2,
//   v_opac = alpha_raw v_alpha / opacity, v_rgb = alpha T_g g,
//   v_absx = |v_mx|, v_absy = |v_my|   (per pixel, before the sum).
// Output row gpos, columns 0-10 in the order of the JAX kernel's decoded
// rows: v_mx, v_my, v_a, v_b, v_c, v_opac, v_r, v_g, v_b, v_absx, v_absy.
// Columns 11-15 and rows no tile walks are left as the caller's zeros.
//
// What bounds it on an H100: the least time for the work is set by its
// bytes (64 read per live intersection and 64 written per row, ~0.09 ms at
// 1M Gaussians and 800x800; its ~20 operations per (pixel, intersection) pair walked
// and ~50 per pair composited take about two thirds of that at 67 TFLOP/s
// f32). The kernel's own time goes to the walk and the reductions: every
// pixel of a tile steps through every intersection up to the tile's
// horizon, and each intersection some pixel of a warp composites costs
// that warp 55 shuffle-adds, so it runs well above that bound.
// Design: one block per tile and one thread per pixel, as in the forward.
// The tile's features are staged back to front through shared memory in
// batches of 32 rows. Each thread walks the batch sequentially (T and S
// carry from one intersection to the next, so no scan is needed), reduces
// the 11 values of each intersection across its warp with xor shuffles
// (skipped, with zeros, when no pixel of the warp touches it), and lane 0
// parks the warp's partial sums in shared memory; after the batch, one
// thread per (intersection, column) adds the warps' partials in warp order
// and writes the row. Each row belongs to exactly one tile, so exactly one
// block writes it: no atomics, and the result does not depend on
// scheduling.

#include <cuda_runtime.h>

#include "tile_eligibility.cuh"

namespace {

constexpr int BATCH = 32;           // intersections staged per pass
constexpr int NF4 = 4;              // float4 per feature row (16 floats)
constexpr int NG = 11;              // live gradient columns
constexpr int OUT_COLS = 16;        // gradient row width
constexpr int MAX_WARPS = 32;       // 1024 threads
constexpr unsigned FULL = 0xffffffffu;

__global__ void __launch_bounds__(1024) tile_backward_kernel(
    const float4* __restrict__ feats,   // [I, 16] as [I, 4] float4
    const int* __restrict__ offsets,    // [T + 1]
    const float* __restrict__ basis,    // [P, 8]
    int P,
    const float* __restrict__ g_img,    // [T, P, 3]
    const float* __restrict__ g_t,      // [T, P]
    const float* __restrict__ t_fin,    // [T, P]
    const int* __restrict__ last,       // [T, P]
    float* __restrict__ grads)          // [I, 16], zero-initialised
{
    __shared__ float4 rows[BATCH * NF4];
    __shared__ float part[MAX_WARPS][BATCH][NG];
    __shared__ int horizon;

    const int t = blockIdx.x;
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int nwarps = blockDim.x >> 5;
    const bool active = tid < P;
    const int start = offsets[t];
    const int end = offsets[t + 1];

    int my_last = -1;
    float T = 1.0f, S = 0.0f, gr = 0.0f, gg = 0.0f, gb = 0.0f;
    float b0 = 0.0f, b1 = 0.0f, b2 = 0.0f, b3 = 0.0f, b4 = 0.0f, b5 = 0.0f, b6 = 0.0f;
    if (active) {
        const size_t o = (size_t)t * P + tid;
        my_last = last[o];
        T = t_fin[o];
        S = g_t[o] * T;
        gr = g_img[o * 3 + 0];
        gg = g_img[o * 3 + 1];
        gb = g_img[o * 3 + 2];
        const float* bp = basis + (size_t)tid * 8;
        b0 = bp[0]; b1 = bp[1]; b2 = bp[2]; b3 = bp[3];
        b4 = bp[4]; b5 = bp[5]; b6 = bp[6];
    }
    // b3, b4 are the tile-local pixel centre (px, py)
    const float px = b3, py = b4;

    if (tid == 0) horizon = -1;
    __syncthreads();
    if (my_last >= 0) atomicMax(&horizon, my_last);
    __syncthreads();
    const int stop = min(horizon + 1, end);

    for (int hi = stop; hi > start; hi -= BATCH) {
        const int base = max(start, hi - BATCH);
        const int n = hi - base;
        const float4* src = feats + (size_t)base * NF4;
        for (int k = tid; k < n * NF4; k += blockDim.x) rows[k] = src[k];
        __syncthreads();

        for (int i = n - 1; i >= 0; --i) {
            float v[NG];
#pragma unroll
            for (int c = 0; c < NG; ++c) v[c] = 0.0f;
            bool hit = false;
            if (active && base + i <= my_last) {
                const float4 f0 = rows[i * NF4];
                const float4 f1 = rows[i * NF4 + 1];
                const float s2 = egs_tile::sigma2(f0, f1, b0, b1, b2, b3, b4, b5, b6);
                float alpha_raw, alpha;
                if (egs_tile::eligible(s2, f1.z, &alpha_raw, &alpha)) {
                    hit = true;
                    const float4 f2 = rows[i * NF4 + 2];  // r, g, b, conic a
                    const float4 f3 = rows[i * NF4 + 3];  // conic b, c, my, pad
                    const float om = 1.0f - alpha;
                    const float t_g = T / om;
                    const float dotc = gr * f2.x + gg * f2.y + gb * f2.z;
                    const float w = alpha * t_g;
                    const float v_alpha = dotc * t_g - S / om;
                    S += dotc * w;
                    T = t_g;
                    const float nvs = alpha_raw * v_alpha;  // -v_sigma
                    const float v_sigma = -nvs;
                    const float dx = f1.w - px;
                    const float dy = f3.z - py;
                    const float gx = v_sigma * (f2.w * dx + f3.x * dy);
                    const float gy = v_sigma * (f3.x * dx + f3.y * dy);
                    v[0] = gx;
                    v[1] = gy;
                    v[2] = 0.5f * v_sigma * dx * dx;
                    v[3] = v_sigma * dx * dy;
                    v[4] = 0.5f * v_sigma * dy * dy;
                    v[5] = nvs;  // times 1 / opacity after the sum
                    v[6] = w * gr;
                    v[7] = w * gg;
                    v[8] = w * gb;
                    v[9] = fabsf(gx);
                    v[10] = fabsf(gy);
                }
            }
            if (__any_sync(FULL, hit)) {
#pragma unroll
                for (int c = 0; c < NG; ++c) {
#pragma unroll
                    for (int off = 16; off > 0; off >>= 1)
                        v[c] += __shfl_xor_sync(FULL, v[c], off);
                }
            }
            if (lane == 0) {
#pragma unroll
                for (int c = 0; c < NG; ++c) part[warp][i][c] = v[c];
            }
        }
        __syncthreads();

        for (int k = tid; k < n * NG; k += blockDim.x) {
            const int i = k / NG;
            const int c = k - i * NG;
            float s = 0.0f;
            for (int w = 0; w < nwarps; ++w) s += part[w][i][c];
            if (c == 5) s *= expf(rows[i * NF4 + 1].z);  // 1 / opacity
            grads[(size_t)(base + i) * OUT_COLS + c] = s;
        }
        // no thread still reads this batch's rows or partials
        __syncthreads();
    }
}

}  // namespace

extern "C" int egs_tile_backward(
    const float* feats, const int* offsets, const float* basis, int num_tiles,
    int P, const float* g_img, const float* g_t, const float* t_fin,
    const int* last, float* grads, int device, void* stream)
{
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    const int threads = (P + 31) / 32 * 32;
    tile_backward_kernel<<<num_tiles, threads, 0, (cudaStream_t)stream>>>(
        reinterpret_cast<const float4*>(feats), offsets, basis, P, g_img, g_t,
        t_fin, last, grads);
    return (int)cudaGetLastError();
}
