// The per-warp cull of tiled compositing and what it needs, shared by
// tile_forward.cu and tile_backward.cu: one copy, so that both kernels drop
// exactly the rows that its plain twin, warp_reach_plain in
// ops/kernels/tile_raster.py, drops.
//
// Both kernels give each warp 64 pixels, two per lane: an 8x8 block of the
// tile when its side is a multiple of 8, else 64 consecutive pixels (the
// layout of tile_raster.py::warp_pixels). The lanes test 32 staged feature
// rows at a time, one each, for whether the row's Gaussian can reach the
// warp's pixel rectangle at all; a row it cannot reach is eligible for no
// pixel of the warp, so dropping it changes no output bit. The test is a
// row's box (reach_box, the costly part) and a rectangle test (misses):
// the backward computes the box in each warp, with the warp's bound on the
// pixels' coordinates (out_of_reach); the forward once per block, with the
// tile's. The rows pass through shared memory in batches copied with
// cp.async.

#pragma once

#include <cuda_runtime.h>

namespace egs_tile {

constexpr int NF4 = 4;              // float4 per feature row (16 floats)
constexpr int WARP_PIXELS = 64;     // two pixels per lane
constexpr unsigned FULL = 0xffffffffu;

// The cull's constants, passed in by the wrappers, which define them
// (ops/kernels/tile_raster.py: S2_REACH and CULL_*) for both kernels and
// for the plain twin: s2 beyond `reach` is not eligible for any rounding of
// exp; the allowances for the polynomial's coefficients against its conic
// and mean (pack_features rounds them within a few ulp) and for the
// rounding of the polynomial and of the cull's own arithmetic, relative to
// the sum of the terms' magnitudes; the ellipse's extent is scaled by
// ext_scale (1 + ext_slack) and widened by ext_slack; it is computed only
// where det / (a c) > det_min.
struct Cull {
    float reach, coef_tol, s2_slack, ext_scale, ext_slack, det_min;
};

// the cull's arithmetic, each operation rounded on its own as the plain
// twin's is (never contracted into an FMA, whatever the build flags)
__device__ __forceinline__ float mul(float x, float y) { return __fmul_rn(x, y); }
__device__ __forceinline__ float add(float x, float y) { return __fadd_rn(x, y); }
__device__ __forceinline__ float sub(float x, float y) { return __fsub_rn(x, y); }

__device__ __forceinline__ void cp_async16(float4* dst, const float4* src)
{
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

// copy n feature rows into shared memory asynchronously, as one commit group
__device__ __forceinline__ void stage(float4* dst, const float4* src, int n)
{
    for (int k = threadIdx.x; k < n * NF4; k += blockDim.x) cp_async16(dst + k, src + k);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wait_staged()
{
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Pixel k (0 or 1) of lane `lane` in warp `warp`: an 8x8 block of the tile
// when its side is a multiple of 8 (`side8`, else 0), else 64 consecutive
// pixels.
__device__ __forceinline__ int pixel_of(int warp, int lane, int k, int side8)
{
    if (side8) {
        const int blocks_x = side8 >> 3;
        const int x = (warp % blocks_x) * 8 + (lane & 7);
        const int y = (warp / blocks_x) * 8 + (lane >> 3) + 4 * k;
        return y * side8 + x;
    }
    return warp * WARP_PIXELS + 32 * k + lane;
}

// The pixel centres of a warp: their bounding box and the largest |px|, |py|.
struct Rect {
    float x0, x1, y0, y1, X, Y;
};

__device__ __forceinline__ float warp_min(float v)
{
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v = fminf(v, __shfl_xor_sync(FULL, v, off));
    return v;
}

__device__ __forceinline__ float warp_max(float v)
{
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, off));
    return v;
}

// True when a pixel's basis row (fields b0-b6) is (px^2, py^2, px py, px,
// py, 1, 1), which the cull's bound assumes (tile_pixel_basis makes every
// row so).
template <class Px>
__device__ __forceinline__ bool plain_basis(const Px& p)
{
    return p.b0 == __fmul_rn(p.b3, p.b3) && p.b1 == __fmul_rn(p.b4, p.b4)
        && p.b2 == __fmul_rn(p.b3, p.b4) && p.b5 == 1.0f && p.b6 == 1.0f;
}

// The warp's pixel rectangle from each lane's two pixels (`va`, `vb`: the
// pixel lies in the tile); returns whether the cull may run, which needs
// every basis row of the warp to be plain.
template <class Px>
__device__ __forceinline__ bool warp_rect(const Px& pa, bool va, const Px& pb, bool vb, Rect* rect)
{
    const float inf = __int_as_float(0x7f800000);
    rect->x0 = warp_min(fminf(va ? pa.b3 : inf, vb ? pb.b3 : inf));
    rect->x1 = warp_max(fmaxf(va ? pa.b3 : -inf, vb ? pb.b3 : -inf));
    rect->y0 = warp_min(fminf(va ? pa.b4 : inf, vb ? pb.b4 : inf));
    rect->y1 = warp_max(fmaxf(va ? pa.b4 : -inf, vb ? pb.b4 : -inf));
    rect->X = fmaxf(fabsf(rect->x0), fabsf(rect->x1));
    rect->Y = fmaxf(fabsf(rect->y0), fabsf(rect->y1));
    return __all_sync(FULL, (!va || plain_basis(pa)) && (!vb || plain_basis(pb)));
}

// Where feature row r can be eligible: every pixel with s2 <= reach, |px|
// <= X and |py| <= Y lies within ex of mx and ey of my (none when ex < 0).
struct Box {
    float mx, my, ex, ey;
};

// The row's box for pixels with |px| <= X, |py| <= Y: the row's polynomial
// is the quadratic form of its conic (a, b, c) and mean (mx, my) within
// coef_tol, so s2 - nlo at such a pixel differs from the form by at most
// s2_slack times the sum of the terms' magnitudes; a pixel with s2 <= reach
// then lies in the ellipse form <= reach + slack - nlo, whose bounding box
// it is. Returns false, and no box, for a row that fails a premise (a conic
// that is not positive definite, a polynomial that is not its form, a
// value that is not finite): such a row is kept everywhere. Every operation
// is the plain twin's (warp_reach_plain), in its order and rounding, so both
// drop the same rows.
__device__ __forceinline__ bool reach_box(const float4* r, float X, float Y, const Cull& k, Box* box)
{
    const float4 f0 = r[0], f1 = r[1], f2 = r[2], f3 = r[3];
    const float a = f2.w, b = f3.x, c = f3.y, mx = f1.w, my = f3.z, nlo = f1.z;
    const float amx = mul(a, mx), bmy = mul(b, my), cmy = mul(c, my), bmx = mul(b, mx);
    const float fq = add(add(mul(mul(0.5f, amx), mx), mul(mul(0.5f, cmy), my)), mul(bmx, my));
    const float fm = add(add(mul(0.5f, fabsf(mul(amx, mx))), mul(0.5f, fabsf(mul(cmy, my)))),
                         fabsf(mul(bmx, my)));
    const bool form = f0.x == mul(0.5f, a) && f0.y == mul(0.5f, c) && f0.z == b
        && fabsf(add(f0.w, add(amx, bmy))) <= mul(k.coef_tol, add(fabsf(amx), fabsf(bmy)))
        && fabsf(add(f1.x, add(cmy, bmx))) <= mul(k.coef_tol, add(fabsf(cmy), fabsf(bmx)))
        && fabsf(sub(f1.y, fq)) <= mul(k.coef_tol, fm);
    const float det = sub(mul(a, c), mul(b, b));
    if (!(form && a > 0.0f && c > 0.0f && det > mul(mul(k.det_min, a), c))) return false;
    const float ux = add(X, fabsf(mx)), uy = add(Y, fabsf(my));
    const float mag = add(add(add(mul(mul(mul(0.5f, a), ux), ux), mul(mul(mul(0.5f, c), uy), uy)),
                              mul(mul(fabsf(b), ux), uy)),
                          fabsf(nlo));
    const float reach = sub(add(k.reach, mul(k.s2_slack, mag)), nlo);  // largest form a kept pixel has
    box->mx = mx;
    box->my = my;
    if (reach <= 0.0f) {
        box->ex = box->ey = -1.0f;
        return true;
    }
    box->ex = add(mul(__fsqrt_rn(__fdiv_rn(mul(mul(2.0f, reach), c), det)), k.ext_scale),
                  k.ext_slack);
    box->ey = add(mul(__fsqrt_rn(__fdiv_rn(mul(mul(2.0f, reach), a), det)), k.ext_scale),
                  k.ext_slack);
    return true;
}

// True when the box misses the rectangle q: no pixel of q can find the row
// eligible.
__device__ __forceinline__ bool misses(const Box& b, const Rect& q)
{
    return b.ex < 0.0f || fmaxf(sub(q.x0, b.mx), sub(b.mx, q.x1)) > b.ex
        || fmaxf(sub(q.y0, b.my), sub(b.my, q.y1)) > b.ey;
}

// True when no pixel of the warp's rectangle q can find feature row r
// eligible (rows that fail a premise are kept).
__device__ __forceinline__ bool out_of_reach(const float4* r, const Rect& q, const Cull& k)
{
    Box b;
    return reach_box(r, q.X, q.Y, k, &b) && misses(b, q);
}

}  // namespace egs_tile
