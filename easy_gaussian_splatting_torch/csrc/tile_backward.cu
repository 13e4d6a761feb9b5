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
// walks back from its warp's horizon. An intersection at or before last_p
// that the forward's eligibility test (tile_eligibility.cuh, shared by both
// kernels and rounded the same way whatever their build flags) accepts was
// composited, so for it:
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
// The kernel writes every row of grads: zeros in columns 11-15, in the rows
// past a tile's horizon and in the rows no tile owns.
//
// What bounds it on an H100: its bytes (64 read per live intersection and
// 64 written per row, ~0.09 ms at 1M Gaussians and 800x800, ~0.08 ms after
// an opacity reset); the ~70 f32 operations of each (pixel, intersection)
// pair a pixel composites (the eligibility test, the gradient, the sums)
// take about a third of that at 67 TFLOP/s on the first train step and
// nearly all of it after a reset. A pair that is not composited adds
// nothing, yet most pairs up to a pixel's last contributor are not (78% on
// the first train step of a 1M-Gaussian scene, 95% after a reset): they are
// Gaussians of the tile's list that do not reach the pixel, and walking
// them is what the per-tile design spent its time on. The design:
// - 64 pixels per warp, two per lane (an 8x8 block of the tile when its
//   side is a multiple of 8, else 64 consecutive pixels): each lane adds its
//   two pixels' values before the warp's sum, so one warp sum covers 64
//   pixels, and the two pixels' walks share the row's shared-memory loads;
// - a per-warp horizon: each warp walks down from the largest last_p of its
//   64 pixels (__reduce_max_sync), not from the tile's, and skips every
//   batch above it; the block stages rows only up to the largest of these;
// - a per-warp cull (tile_cull.cuh, shared with the forward kernel): the
//   lanes test 32 rows at a time, one each, for
//   whether the Gaussian can reach the warp's pixel rectangle at all (the
//   bounding box of its ellipse s2 <= 5.6, widened by a bound on the
//   polynomial's rounding; beyond 5.6 exp(-s2) < 1/255 whatever the
//   rounding of exp, so no pixel there is eligible), and the warp walks only
//   the rows a ballot keeps; a pixel skips the exp of a row whose s2 is
//   beyond 5.6 the same way;
// - a cheaper warp sum: the 11 values of an intersection (16 slots) are
//   reduce-scattered across the lanes, 8 + 4 + 2 + 1 shuffles and one more
//   for the two half-warps, 16 in all against 55 with one butterfly per
//   column; lane L ends with slot L % 16, and lanes 0-10 park the warp's
//   sums in shared memory (nothing, and no shuffle, when no lane composited
//   the intersection; a per-warp bit mask says which rows hold sums);
// - batches of 128 rows, the next one copied into a second buffer with
//   cp.async while the warps walk the current one; the warps' partials sit
//   in dynamic shared memory (16 x 128 x 11 floats, 88 KB, two blocks to an
//   SM) and are summed once per batch by the whole block, in warp order;
//   the summing threads write whole rows, columns 11-15 as zeros.
// One block per tile. Each row belongs to exactly one tile, so exactly one
// block writes it: no atomics, and every sum is taken in a fixed order, so
// two launches on the same inputs give the same bits. Measured on an H100
// 80GB HBM3 at 700 W (chip_smoke.py phases 10 and 12): ~0.47 ms on the
// first train step of a 1M-Gaussian 800x800 scene (5.4x its 0.087 ms
// bound; 1.26 ms for the per-tile walk with one butterfly per column it
// replaced) and ~1.72 ms after an opacity reset (22x its 0.077 ms bound;
// 6.5 ms before), where the cull leaves 18% of the rows at the warps'
// horizons to walk and 88% of those have a composited pixel.

#include <cuda_runtime.h>

#include "tile_cull.cuh"
#include "tile_eligibility.cuh"

namespace {

using namespace egs_tile;

constexpr int BATCH = 128;          // intersections staged per pass
constexpr int CHUNKS = BATCH / 32;  // rows of a batch a warp's ballot covers, 32 each
constexpr int NG = 11;              // live gradient columns
constexpr int OUT_COLS = 16;        // gradient row width
constexpr int MAX_THREADS = 512;    // 1024 pixels
constexpr int MIN_BLOCKS = 2;       // per SM: at most 64 registers a thread

// One step of the reduce-scatter: a lane keeps slots [0, H) of the half of
// v[0..2H) that its partner (lane ^ H) does not keep, summed with the
// partner's copy (the upper lane keeps the upper half).
template <int H>
__device__ __forceinline__ void scatter_step(float (&v)[16], int lane)
{
    const bool upper = lane & H;
#pragma unroll
    for (int k = 0; k < H; ++k) {
        const float mine = upper ? v[k + H] : v[k];
        const float give = upper ? v[k] : v[k + H];
        v[k] = mine + __shfl_xor_sync(FULL, give, H);
    }
}

// Sum v[0..15] over the warp's lanes: returns, in lane L, the warp's sum of
// slot L % 16, added in a fixed order (each step a template, so that every
// index is a constant and v stays in registers).
__device__ __forceinline__ float reduce_scatter(float (&v)[16], int lane)
{
    scatter_step<8>(v, lane);
    scatter_step<4>(v, lane);
    scatter_step<2>(v, lane);
    scatter_step<1>(v, lane);
    return v[0] + __shfl_xor_sync(FULL, v[0], 16);
}

struct Pixel {
    float T, S, gr, gg, gb;
    float b0, b1, b2, b3, b4, b5, b6;   // basis row; b3, b4 = (px, py)
    int last;                           // -1: composited nothing (or no pixel)
};

__device__ __forceinline__ Pixel load_pixel(
    int t, int p, int P, const float* basis, const float* g_img, const float* g_t,
    const float* t_fin, const int* last)
{
    Pixel px = {1.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, -1};
    if (p < P) {
        const size_t o = (size_t)t * P + p;
        px.last = last[o];
        px.T = t_fin[o];
        px.S = g_t[o] * px.T;
        px.gr = g_img[o * 3 + 0];
        px.gg = g_img[o * 3 + 1];
        px.gb = g_img[o * 3 + 2];
        const float* bp = basis + (size_t)p * 8;
        px.b0 = bp[0]; px.b1 = bp[1]; px.b2 = bp[2]; px.b3 = bp[3];
        px.b4 = bp[4]; px.b5 = bp[5]; px.b6 = bp[6];
    }
    return px;
}

// One pixel's step back over feature row r (f0, f1 its first two float4):
// when the pixel composited the row, add its 11 values to v[0..10], carry
// T and S, and return true. s2 beyond `reach` is not eligible.
__device__ __forceinline__ bool step_back(
    const float4 f0, const float4 f1, const float4* r, float reach, Pixel& p, float* v)
{
    const float s2 = egs_tile::sigma2(f0, f1, p.b0, p.b1, p.b2, p.b3, p.b4, p.b5, p.b6);
    if (s2 > reach) return false;  // not eligible, without the exp
    float alpha_raw, alpha;
    if (!egs_tile::eligible(s2, f1.z, &alpha_raw, &alpha)) return false;
    const float4 f2 = r[2];  // r, g, b, conic a
    const float4 f3 = r[3];  // conic b, c, my, pad
    const float om = 1.0f - alpha;
    const float t_g = p.T / om;
    const float dotc = p.gr * f2.x + p.gg * f2.y + p.gb * f2.z;
    const float w = alpha * t_g;
    const float v_alpha = dotc * t_g - p.S / om;
    p.S += dotc * w;
    p.T = t_g;
    const float nvs = alpha_raw * v_alpha;  // -v_sigma
    const float v_sigma = -nvs;
    const float dx = f1.w - p.b3;
    const float dy = f3.z - p.b4;
    const float gx = v_sigma * (f2.w * dx + f3.x * dy);
    const float gy = v_sigma * (f3.x * dx + f3.y * dy);
    v[0] += gx;
    v[1] += gy;
    v[2] += 0.5f * v_sigma * dx * dx;
    v[3] += v_sigma * dx * dy;
    v[4] += 0.5f * v_sigma * dy * dy;
    v[5] += nvs;  // times 1 / opacity after the sum
    v[6] += w * p.gr;
    v[7] += w * p.gg;
    v[8] += w * p.gb;
    v[9] += fabsf(gx);
    v[10] += fabsf(gy);
    return true;
}

// Both pixels of a lane over feature row r (global index gpos), into v[0..10].
__device__ __forceinline__ bool step_row(
    const float4* r, int gpos, float reach, Pixel& a, Pixel& b, float* v)
{
    const float4 f0 = r[0];
    const float4 f1 = r[1];
    bool hit = false;
    if (gpos <= a.last) hit = step_back(f0, f1, r, reach, a, v);
    if (gpos <= b.last) hit |= step_back(f0, f1, r, reach, b, v);
    return hit;
}

__global__ void __launch_bounds__(MAX_THREADS, MIN_BLOCKS) tile_backward_kernel(
    const float4* __restrict__ feats,   // [I, 16] as [I, 4] float4
    const int* __restrict__ offsets,    // [T + 1]
    const float* __restrict__ basis,    // [P, 8]
    int P, int side8, int num_rows, const Cull cull_k,
    const float* __restrict__ g_img,    // [T, P, 3]
    const float* __restrict__ g_t,      // [T, P]
    const float* __restrict__ t_fin,    // [T, P]
    const int* __restrict__ last,       // [T, P]
    float* __restrict__ grads)          // [I, 16]
{
    extern __shared__ float4 smem[];
    const int nwarps = blockDim.x >> 5;
    float4* staged = smem;                                           // [2][BATCH * NF4]
    float* part = reinterpret_cast<float*>(smem + 2 * BATCH * NF4);  // [nwarps][BATCH * NG]
    unsigned* hits = reinterpret_cast<unsigned*>(part + nwarps * BATCH * NG);  // [nwarps][CHUNKS]
    int* horizon = reinterpret_cast<int*>(hits + nwarps * CHUNKS);   // [nwarps]

    const int t = blockIdx.x;
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int start = offsets[t];
    const int end = offsets[t + 1];
    float4* out4 = reinterpret_cast<float4*>(grads);
    const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);

    // rows no tile owns, [0, offsets[0]) and [offsets[T], I), shared out
    // over the blocks
    {
        const long long lo = (long long)offsets[0] * NF4;
        const long long hi = (long long)offsets[gridDim.x] * NF4;
        const long long n_out = lo + (long long)num_rows * NF4 - hi;
        for (long long j = (long long)t * blockDim.x + tid; j < n_out;
             j += (long long)gridDim.x * blockDim.x)
            out4[j < lo ? j : hi + (j - lo)] = zero;
    }

    const int ia = pixel_of(warp, lane, 0, side8);
    const int ib = pixel_of(warp, lane, 1, side8);
    Pixel pa = load_pixel(t, ia, P, basis, g_img, g_t, t_fin, last);
    Pixel pb = load_pixel(t, ib, P, basis, g_img, g_t, t_fin, last);
    const int warp_last = __reduce_max_sync(FULL, max(pa.last, pb.last));
    if (lane == 0) horizon[warp] = warp_last;

    // the warp's pixel rectangle; no cull if a basis row is not plain
    Rect rect;
    const bool cull = warp_rect(pa, ia < P, pb, ib < P, &rect);
    __syncthreads();
    int tile_last = -1;
    for (int w = 0; w < nwarps; ++w) tile_last = max(tile_last, horizon[w]);
    const int stop = max(start, min(tile_last + 1, end));

    // rows past the tile's horizon
    for (long long k = (long long)stop * NF4 + tid; k < (long long)end * NF4; k += blockDim.x)
        out4[k] = zero;

    float* my_part = part + warp * (BATCH * NG);
    unsigned* my_hits = hits + warp * CHUNKS;
    int buf = 0;
    if (stop > start) {
        const int base = max(start, stop - BATCH);
        stage(staged, feats + (size_t)base * NF4, stop - base);
    }
    for (int hi = stop; hi > start; hi -= BATCH) {
        const int base = max(start, hi - BATCH);
        const int n = hi - base;
        if (base > start) {  // the next batch, while this one is walked
            const int nb = max(start, base - BATCH);
            stage(staged + (buf ^ 1) * BATCH * NF4, feats + (size_t)nb * NF4, base - nb);
            wait_staged<1>();
        } else {
            wait_staged<0>();
        }
        __syncthreads();
        const float4* rows = staged + buf * BATCH * NF4;

        // the warp's rows of this batch, [0, top), from the top, 32 at a time
        const int top = min(hi, warp_last + 1) - base;
        for (int j = CHUNKS - 1; j >= 0; --j) {
            const int i0 = 32 * j;
            unsigned walk = 0;
            if (i0 < top) {
                const int i = i0 + lane;
                bool keep = i < top;
                if (keep && cull) keep = !out_of_reach(rows + i * NF4, rect, cull_k);
                walk = __ballot_sync(FULL, keep);
            }
            unsigned hit_rows = 0;
            while (walk) {
                const int bit = 31 - __clz(walk);
                walk &= ~(1u << bit);
                const int i = i0 + bit;
                float v[16];
#pragma unroll
                for (int c = 0; c < 16; ++c) v[c] = 0.0f;
                const bool hit = step_row(rows + i * NF4, base + i, cull_k.reach, pa, pb, v);
                if (__any_sync(FULL, hit)) {
                    const float s = reduce_scatter(v, lane);
                    if (lane < NG) my_part[i * NG + lane] = s;
                    hit_rows |= 1u << bit;
                }
            }
            if (lane == 0) my_hits[j] = hit_rows;
        }
        __syncthreads();

        // per row and column, the warps' partials in warp order; thread k
        // writes column k % 16 of row k / 16
        for (int k = tid; k < n * OUT_COLS; k += blockDim.x) {
            const int i = k >> 4;
            const int c = k & (OUT_COLS - 1);
            float s = 0.0f;
            if (c < NG) {
                const unsigned bit = 1u << (i & 31);
                for (int w = 0; w < nwarps; ++w)
                    if (hits[w * CHUNKS + (i >> 5)] & bit) s += part[w * (BATCH * NG) + i * NG + c];
                if (c == 5) s *= expf(rows[i * NF4 + 1].z);  // 1 / opacity
            }
            grads[(size_t)(base + i) * OUT_COLS + c] = s;
        }
        buf ^= 1;
        // no thread still reads this batch's rows or partials
        __syncthreads();
    }
}

}  // namespace

extern "C" int egs_tile_backward(
    const float* feats, const int* offsets, const float* basis, int num_tiles,
    int P, int side8, int num_rows, const float* cull, const float* g_img, const float* g_t,
    const float* t_fin, const int* last, float* grads, int device, void* stream)
{
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    // side8: the tile's side when the tile is a square of it and it is a
    // multiple of 8 (warps of 8x8 pixels), else 0
    if (side8 && (side8 % 8 || side8 * side8 != P)) return (int)cudaErrorInvalidValue;
    // cull: the six constants of Cull, in its order (host memory)
    const Cull cull_k = {cull[0], cull[1], cull[2], cull[3], cull[4], cull[5]};
    const int warps = (P + WARP_PIXELS - 1) / WARP_PIXELS;
    const size_t smem = 2 * BATCH * NF4 * sizeof(float4)
        + (size_t)warps * (BATCH * NG * sizeof(float) + CHUNKS * sizeof(unsigned) + sizeof(int));
    err = cudaFuncSetAttribute(tile_backward_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    tile_backward_kernel<<<num_tiles, warps * 32, smem, (cudaStream_t)stream>>>(
        reinterpret_cast<const float4*>(feats), offsets, basis, P, side8, num_rows, cull_k, g_img,
        g_t, t_fin, last, grads);
    return (int)cudaGetLastError();
}
