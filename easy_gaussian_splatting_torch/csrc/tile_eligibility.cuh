// The eligibility test of tiled compositing, shared by tile_forward.cu and
// tile_backward.cu. The backward replays the forward's decisions from the
// same features, so both kernels must round this test identically; the
// plain versions (ops/kernels/tile_raster.py::_sigma2) sum the same terms in
// the same order.
//
// For pixel basis b = (px^2, py^2, px*py, px, py, 1, 1) and feature row f,
// s2 = f[0:7] . b is the tile-local sigma plus nlo = -log(opacity) (f[6]).
// Each product and each partial sum is rounded on its own (__fmul_rn and
// __fadd_rn are never contracted into an FMA), so the result does not
// depend on the kernels' build flags; the rest of each kernel is free to
// contract.

#pragma once

#include <cuda_runtime.h>

namespace egs_tile {

constexpr float ALPHA_CLAMP = 0.999f;
constexpr float ALPHA_THRESH = 1.0f / 255.0f;
// slack on the polynomial's sigma >= 0 test (its expansion carries ~1e-4
// cancellation error near a Gaussian's centre)
constexpr float SIGMA_EPS = 1e-3f;

__device__ __forceinline__ float sigma2(
    const float4 f0, const float4 f1, float b0, float b1, float b2, float b3,
    float b4, float b5, float b6)
{
    float s = __fmul_rn(f0.x, b0);
    s = __fadd_rn(s, __fmul_rn(f0.y, b1));
    s = __fadd_rn(s, __fmul_rn(f0.z, b2));
    s = __fadd_rn(s, __fmul_rn(f0.w, b3));
    s = __fadd_rn(s, __fmul_rn(f1.x, b4));
    s = __fadd_rn(s, __fmul_rn(f1.y, b5));
    return __fadd_rn(s, __fmul_rn(f1.z, b6));
}

// alpha_raw = exp(-max(s2, nlo)), alpha = min(alpha_raw, ALPHA_CLAMP); the
// intersection is composited when s2 >= nlo - SIGMA_EPS and alpha >=
// ALPHA_THRESH
__device__ __forceinline__ bool eligible(
    float s2, float nlo, float* alpha_raw, float* alpha)
{
    *alpha_raw = expf(-fmaxf(s2, nlo));
    *alpha = fminf(*alpha_raw, ALPHA_CLAMP);
    return s2 >= nlo - SIGMA_EPS && *alpha >= ALPHA_THRESH;
}

}  // namespace egs_tile
