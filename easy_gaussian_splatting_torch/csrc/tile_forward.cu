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
// What bounds it on an H100: the instructions of the pairs it evaluates.
// Its bound is small: the ~30 f32 operations of each composited (pixel,
// intersection) pair, and 64 bytes of each row some pixel of its tile
// reaches (0.020 ms on the served 800x800 frame of a 1M-Gaussian scene, by
// operations; 0.031 ms on a train step after an opacity reset, by bytes).
// But most pairs a pixel walks before it stops are Gaussians of the tile's
// list that do not reach it: the one-thread-per-pixel walk this replaced
// paid the 13-term polynomial and the exp for every one of them (5.4x the
// composited pairs on that frame, 21x after the reset). The design:
// - 64 pixels per warp, two per lane, as 8x8 blocks of the tile (when its
//   side is a multiple of 8, else 64 consecutive pixels): a square meets
//   fewer ellipses than a 32-pixel line, and the two pixels of a lane share
//   each row's shared-memory loads;
// - the backward's cull (tile_cull.cuh), its costly part shared: the block
//   computes each staged row's box once (the bounding box of the pixels
//   that can find the row eligible, under the tile's bound on |px| and
//   |py|: two IEEE divisions and square roots among ~30 rounded operations),
//   and the lanes of a warp test 32 rows at a time, one each, against the
//   warp's pixel rectangle; the warp walks the rows a ballot keeps, front
//   to back; a pixel skips the exp of a row whose s2 is beyond S2_REACH. A
//   dropped row is eligible for no pixel of the warp, and each pixel's
//   arithmetic is the one-thread-per-pixel walk's, operation for operation
//   (its rounding fixed with __fmul_rn, __fsub_rn and __fmaf_rn), so rgb, T
//   and last are that walk's, bit for bit;
// - a warp leaves the walk once all 64 of its pixels have stopped, and the
//   block stops staging once every warp has left;
// - 128-row batches, the next one copied into a second buffer with
//   cp.async while the warps walk the current one; 512 threads for a 32x32
//   tile, two blocks to an SM (at most 64 registers a thread).
// Measured on an H100 80GB HBM3 at 700 W (chip_smoke.py phase 12): 0.29 ms
// on the served frame (0.59x the one-thread-per-pixel walk's 0.49 ms), 0.64
// ms after the reset (0.33x its 1.96 ms). What is left is issue: ~80 warp
// instructions for each kept (warp, row) pair (two pixels' polynomial, exp
// and stop test, and the loop's bit work), about half the time, and warps
// that wait at a batch's barrier for the slowest warp of their tile.

#include <cuda_runtime.h>

#include "tile_cull.cuh"
#include "tile_eligibility.cuh"

namespace {

using namespace egs_tile;

constexpr int BATCH = 128;          // intersections staged per pass
constexpr int MAX_THREADS = 512;    // 1024 pixels
constexpr int MAX_WARPS = MAX_THREADS / 32;
constexpr int MIN_BLOCKS = 2;       // per SM: at most 64 registers a thread
constexpr float T_EPS = 1e-4f;

struct Pixel {
    float T, cr, cg, cb;
    float b0, b1, b2, b3, b4, b5, b6;   // basis row; b3, b4 = (px, py)
    int last;                           // -1: composited nothing
    bool walking;                       // a pixel of the tile that has not stopped
};

__device__ __forceinline__ Pixel load_pixel(const float* basis, int p, int P)
{
    Pixel px = {1.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, -1, p < P};
    if (p < P) {
        const float* bp = basis + (size_t)p * 8;
        px.b0 = bp[0]; px.b1 = bp[1]; px.b2 = bp[2]; px.b3 = bp[3];
        px.b4 = bp[4]; px.b5 = bp[5]; px.b6 = bp[6];
    }
    return px;
}

// One pixel's step over feature row r (global index gpos; f0, f1 its first
// two float4). s2 beyond `reach` is not eligible.
__device__ __forceinline__ void step(
    const float4 f0, const float4 f1, const float4* r, int gpos, float reach, Pixel& p)
{
    const float s2 = egs_tile::sigma2(f0, f1, p.b0, p.b1, p.b2, p.b3, p.b4, p.b5, p.b6);
    if (s2 > reach) return;  // not eligible, without the exp
    float alpha_raw, alpha;
    if (!egs_tile::eligible(s2, f1.z, &alpha_raw, &alpha)) return;
    const float t_next = __fmul_rn(p.T, __fsub_rn(1.0f, alpha));
    if (t_next < T_EPS) {
        p.walking = false;
        return;
    }
    const float4 col = r[2];
    const float w = __fmul_rn(alpha, p.T);
    p.cr = __fmaf_rn(w, col.x, p.cr);
    p.cg = __fmaf_rn(w, col.y, p.cg);
    p.cb = __fmaf_rn(w, col.z, p.cb);
    p.T = t_next;
    p.last = gpos;
}

__device__ __forceinline__ void store_pixel(
    const Pixel& px, int t, int p, int P, float* rgb, float* t_final, int* last)
{
    if (p >= P) return;
    const size_t o = (size_t)t * P + p;
    rgb[o * 3 + 0] = px.cr;
    rgb[o * 3 + 1] = px.cg;
    rgb[o * 3 + 2] = px.cb;
    t_final[o] = px.T;
    last[o] = px.last;
}

__global__ void __launch_bounds__(MAX_THREADS, MIN_BLOCKS) tile_forward_kernel(
    const float4* __restrict__ feats,   // [I, 16] as [I, 4] float4
    const int* __restrict__ offsets,    // [T + 1]
    const float* __restrict__ basis,    // [P, 8]
    int P, int side8, const Cull cull_k,
    float* __restrict__ rgb,            // [T, P, 3]
    float* __restrict__ t_final,        // [T, P]
    int* __restrict__ last)             // [T, P]
{
    __shared__ float4 staged[2][BATCH * NF4];
    __shared__ float4 boxes[BATCH];  // each staged row's Box (mx, my, ex, ey)
    __shared__ float2 bounds[MAX_WARPS];
    const int t = blockIdx.x;
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int start = offsets[t];
    const int end = offsets[t + 1];

    const int ia = pixel_of(warp, lane, 0, side8);
    const int ib = pixel_of(warp, lane, 1, side8);
    Pixel pa = load_pixel(basis, ia, P);
    Pixel pb = load_pixel(basis, ib, P);
    // the warp's pixel rectangle; no cull if a basis row is not plain
    Rect rect;
    const bool cull = warp_rect(pa, ia < P, pb, ib < P, &rect);
    bool walking = true;  // the warp's: some pixel of it has not stopped
    // the largest |px| and |py| of the tile: one box of each row serves
    // every warp
    if (lane == 0) bounds[warp] = make_float2(rect.X, rect.Y);
    __syncthreads();
    float tile_x = 0.0f, tile_y = 0.0f;
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) {
        tile_x = fmaxf(tile_x, bounds[w].x);
        tile_y = fmaxf(tile_y, bounds[w].y);
    }

    int buf = 0;
    if (start < end) stage(staged[0], feats + (size_t)start * NF4, min(BATCH, end - start));
    for (int base = start; base < end; base += BATCH) {
        // the block leaves once every warp has; and no thread still reads
        // the buffer the next batch goes into
        if (!__syncthreads_or(walking)) break;
        const int next = base + BATCH;
        if (next < end) {  // the next batch, while this one is walked
            stage(staged[buf ^ 1], feats + (size_t)next * NF4, min(BATCH, end - next));
            wait_staged<1>();
        } else {
            wait_staged<0>();
        }
        __syncthreads();
        const float4* rows = staged[buf];
        const int n = min(BATCH, end - base);
        // each row's box, once for the block (a row that fails a premise of
        // the bound gets an infinite one: kept everywhere)
        const float inf = __int_as_float(0x7f800000);
        for (int k = tid; k < n; k += blockDim.x) {
            Box b;
            boxes[k] = reach_box(rows + k * NF4, tile_x, tile_y, cull_k, &b)
                ? make_float4(b.mx, b.my, b.ex, b.ey) : make_float4(0.0f, 0.0f, inf, inf);
        }
        __syncthreads();
        for (int i0 = 0; walking && i0 < n; i0 += 32) {
            const int i = i0 + lane;
            bool keep = i < n;
            if (keep && cull) {
                const float4 b = boxes[i];
                keep = !misses(Box{b.x, b.y, b.z, b.w}, rect);
            }
            unsigned todo = __ballot_sync(FULL, keep);
            while (todo) {  // front to back
                const int bit = __ffs(todo) - 1;
                todo &= todo - 1;
                const float4* r = rows + (i0 + bit) * NF4;
                const float4 f0 = r[0];
                const float4 f1 = r[1];
                if (pa.walking) step(f0, f1, r, base + i0 + bit, cull_k.reach, pa);
                if (pb.walking) step(f0, f1, r, base + i0 + bit, cull_k.reach, pb);
                if (!__any_sync(FULL, pa.walking || pb.walking)) {
                    walking = false;
                    break;
                }
            }
        }
        buf ^= 1;
    }
    wait_staged<0>();  // a batch staged before the block left
    store_pixel(pa, t, ia, P, rgb, t_final, last);
    store_pixel(pb, t, ib, P, rgb, t_final, last);
}

}  // namespace

extern "C" int egs_tile_forward(
    const float* feats, const int* offsets, const float* basis, int num_tiles,
    int P, int side8, const float* cull, float* rgb, float* t_final, int* last,
    int device, void* stream)
{
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    // side8: the tile's side when the tile is a square of it and it is a
    // multiple of 8 (warps of 8x8 pixels), else 0
    if (side8 && (side8 % 8 || side8 * side8 != P)) return (int)cudaErrorInvalidValue;
    // cull: the six constants of Cull, in its order (host memory)
    const Cull cull_k = {cull[0], cull[1], cull[2], cull[3], cull[4], cull[5]};
    const int warps = (P + WARP_PIXELS - 1) / WARP_PIXELS;
    tile_forward_kernel<<<num_tiles, warps * 32, 0, (cudaStream_t)stream>>>(
        reinterpret_cast<const float4*>(feats), offsets, basis, P, side8, cull_k, rgb,
        t_final, last);
    return (int)cudaGetLastError();
}
