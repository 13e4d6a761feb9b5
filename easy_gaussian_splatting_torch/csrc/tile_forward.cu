// Tiled forward compositing: one image tile's depth-ordered intersection
// list, front to back, for every pixel of the tile.
//
// Replaces the Pallas TPU kernel easy_gaussian_splatting_tpu/ops/pallas/
// tile_raster.py::tiled_forward (body _fwd_kernel). Plain PyTorch version
// and wrapper: easy_gaussian_splatting_torch/ops/kernels/tile_raster.py.
//
// Tile t owns intersections [offsets[t], offsets[t+1]) of feats [I, 16]
// (rows of rasterize_tiled.pack_features). For pixel p with basis row
// (px^2, py^2, px*py, px, py, 1, 1, 0), s2 = feats[0:7] . basis[0:7] is the
// tile-local sigma plus nlo = -log(opacity) (feats column 6), and
// alpha = min(exp(-max(s2, nlo)), 0.999). An intersection is eligible when
// s2 >= nlo - SIGMA_EPS and alpha >= 1/255 (tile_eligibility.cuh, shared
// with the backward, which replays it). Each pixel composites eligible
// intersections in order, T_next = T * (1 - alpha); the first one that
// would push T below 1e-4 is skipped and the pixel stops. Outputs: rgb
// [T, P, 3], final T [T, P], and the global index of the last composited
// intersection [T, P] (-1 if none), which the backward pass needs.
//
// What bounds it on an H100: f32 arithmetic. Every (pixel, intersection)
// pair the walk reaches costs ~20 f32 operations (the 7-term polynomial,
// exp, the eligibility tests) against 64 bytes per intersection read once
// per tile, i.e. ~300 operations per byte, well past the ~20 operations per
// byte where HBM (3.35 TB/s) stops being the limit at 67 TFLOP/s f32.
// Design: one block per tile and one thread per pixel (tile_size <= 32, so
// P <= 1024 threads); the tile's features pass through shared memory in
// batches of 256 rows (16 KB, read as float4 by the whole block) and every
// thread reads each row by broadcast, so device memory is touched once per
// intersection; each pixel keeps T, rgb and its last index in registers
// and walks sequentially, which needs no scan; the block leaves the tile as
// soon as every pixel has stopped (__syncthreads_count).

#include <cuda_runtime.h>

#include "tile_eligibility.cuh"

namespace {

constexpr int BATCH = 256;          // intersections staged per pass
constexpr int NF4 = 4;              // float4 per feature row (16 floats)
constexpr float T_EPS = 1e-4f;

__global__ void __launch_bounds__(1024) tile_forward_kernel(
    const float4* __restrict__ feats,   // [I, 16] as [I, 4] float4
    const int* __restrict__ offsets,    // [T + 1]
    const float* __restrict__ basis,    // [P, 8]
    int P,
    float* __restrict__ rgb,            // [T, P, 3]
    float* __restrict__ t_final,        // [T, P]
    int* __restrict__ last)             // [T, P]
{
    __shared__ float4 rows[BATCH * NF4];
    const int t = blockIdx.x;
    const int p = threadIdx.x;
    const int start = offsets[t];
    const int end = offsets[t + 1];

    const float* bp = basis + (size_t)p * 8;
    const float b0 = bp[0], b1 = bp[1], b2 = bp[2], b3 = bp[3];
    const float b4 = bp[4], b5 = bp[5], b6 = bp[6];

    float T = 1.0f, cr = 0.0f, cg = 0.0f, cb = 0.0f;
    int last_idx = -1;
    bool done = false;

    for (int base = start; base < end; base += BATCH) {
        // barrier: no thread still reads the previous batch; and the
        // whole block leaves once every pixel has stopped
        if (__syncthreads_count(!done) == 0) break;
        const int n = min(BATCH, end - base);
        const float4* src = feats + (size_t)base * NF4;
        for (int k = p; k < n * NF4; k += blockDim.x) rows[k] = src[k];
        __syncthreads();
        if (done) continue;
        for (int i = 0; i < n; ++i) {
            const float4 f0 = rows[i * NF4];
            const float4 f1 = rows[i * NF4 + 1];
            const float s2 = egs_tile::sigma2(f0, f1, b0, b1, b2, b3, b4, b5, b6);
            float alpha_raw, alpha;
            if (egs_tile::eligible(s2, f1.z, &alpha_raw, &alpha)) {
                const float t_next = T * (1.0f - alpha);
                if (t_next < T_EPS) {
                    done = true;
                    break;
                }
                const float4 col = rows[i * NF4 + 2];
                const float w = alpha * T;
                cr += w * col.x;
                cg += w * col.y;
                cb += w * col.z;
                T = t_next;
                last_idx = base + i;
            }
        }
    }
    const size_t o = (size_t)t * P + p;
    rgb[o * 3 + 0] = cr;
    rgb[o * 3 + 1] = cg;
    rgb[o * 3 + 2] = cb;
    t_final[o] = T;
    last[o] = last_idx;
}

}  // namespace

extern "C" int egs_tile_forward(
    const float* feats, const int* offsets, const float* basis, int num_tiles,
    int P, float* rgb, float* t_final, int* last, int device, void* stream)
{
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    tile_forward_kernel<<<num_tiles, P, 0, (cudaStream_t)stream>>>(
        reinterpret_cast<const float4*>(feats), offsets, basis, P, rgb,
        t_final, last);
    return (int)cudaGetLastError();
}
