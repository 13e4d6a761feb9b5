// The view-dependent colour of every Gaussian slot, and its gradient: real
// spherical harmonics of degree 0..3 evaluated along the unit direction
// from the camera centre (-R^T t of the world->camera matrix) to the mean,
// the norm bounded below by 1e-8, then max(raw + 0.5, 0).
//
// Replaces no Pallas kernel: the JAX package computes the colour with jnp
// ops (easy_gaussian_splatting_tpu/models/render.py, the direction, and
// ops/sh.py::eval_sh_color_flat), which XLA fuses on the TPU. As eager
// PyTorch ops the same composition is some fifty full-width ops forward
// and their autograd chain backward, where each of the 15 column slices
// sh_rest[:, j:j+3] writes a zero-filled full-width gradient and the 15
// are summed; on an H100 that chain took 22.5 ms of a 54 ms train step at
// 3,145,728 slots. Plain PyTorch version and wrapper:
// easy_gaussian_splatting_torch/ops/kernels/sh_color.py.
//
// What bounds it on an H100: device memory. At degree 3 a row reads 204 B
// (means 12, sh_0 12, sh_rest 180) and writes its colour, 12 B, forward;
// the backward reads the colour's gradient and the same 204 B and writes
// the gradients of the three, 204 B: 216 and 420 B a row, 0.68 and 1.32 GB
// at 3,145,728 rows, 0.20 and 0.39 ms at 3.35 TB/s; measured on an H100
// 80GB HBM3 at 700 W, 0.240 and 0.449 ms.
// Design: a block of 128 threads takes 128 consecutive rows, one thread a
// row. The block stages its rows' inputs in shared memory with 16-byte
// loads, neighbouring threads on neighbouring addresses (the coefficients
// of 128 rows at degree 3 are 23,040 contiguous bytes), each thread then
// works on its own row there (a row stride of an odd number of floats, so
// the 32 threads of a warp hit 32 banks), writes its results back over
// its own inputs, and the block stores them with 16-byte stores. Nothing
// between the two kernels goes to device memory: the backward recomputes
// the direction, the basis and the raw colour instead of reading them
// back, and writes sh_rest's gradient once, zeros above the degree. The
// degree is a template parameter; a degree below the stored coefficients'
// reads only the coefficients it uses.
//
// Rounding: the camera centre, the basis and the raw colour are rounded op
// by op in the order ops/sh.py computes them (intrinsics, so no FMA
// contraction), so with equal directions the colours, the clamp's ties and
// the gradients of sh_0 and sh_rest equal the plain version's bit for bit;
// the norm and the direction's gradient round in their own order.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 128;     // rows (and threads) a block
constexpr int MAX_REST = 15;  // rest coefficients a row holds at most (degree 3)

constexpr float C0 = 0.28209479177387814f;
constexpr float C1 = 0.4886025119029199f;
constexpr float C2_0 = 1.0925484305920792f;
constexpr float C2_1 = -1.0925484305920792f;
constexpr float C2_2 = 0.31539156525252005f;
constexpr float C2_3 = -1.0925484305920792f;
constexpr float C2_4 = 0.5462742152960396f;
constexpr float C3_0 = -0.5900435899266435f;
constexpr float C3_1 = 2.890611442640554f;
constexpr float C3_2 = -0.4570457994644658f;
constexpr float C3_3 = 0.3731763325901154f;
constexpr float C3_4 = -0.4570457994644658f;
constexpr float C3_5 = 1.445305721320277f;
constexpr float C3_6 = -0.5900435899266435f;
constexpr float NORM_EPS = 1e-8f;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

__device__ __forceinline__ bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

// rest coefficients used at degree DEG, and their row stride in shared
// memory: 3 floats each, made odd so a warp's rows fall in 32 banks
template <int DEG>
struct Rest {
    static constexpr int USED = (DEG + 1) * (DEG + 1) - 1;
    static constexpr int STRIDE = (3 * USED) | 1;
    static constexpr int SMEM = USED > 0 ? TILE * STRIDE : 1;
};

// dst[0, count) = src[0, count) by the block: float4 where src is 16-byte
// aligned (dst always is), the ragged end a float at a time
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ src, int count)
{
    int done = 0;
    if (aligned16(src)) {
        const int n4 = count >> 2;
        const float4* s4 = reinterpret_cast<const float4*>(src);
        float4* d4 = reinterpret_cast<float4*>(dst);
#pragma unroll 4
        for (int i = threadIdx.x; i < n4; i += TILE) d4[i] = __ldg(s4 + i);
        done = n4 << 2;
    }
    for (int i = done + threadIdx.x; i < count; i += TILE) dst[i] = __ldg(src + i);
}

// dst[0, count) = src[0, count) by the block, the other way round
__device__ __forceinline__ void store_tile(float* __restrict__ dst, const float* src, int count)
{
    int done = 0;
    if (aligned16(dst)) {
        const int n4 = count >> 2;
        const float4* s4 = reinterpret_cast<const float4*>(src);
        float4* d4 = reinterpret_cast<float4*>(dst);
#pragma unroll 4
        for (int i = threadIdx.x; i < n4; i += TILE) d4[i] = s4[i];
        done = n4 << 2;
    }
    for (int i = done + threadIdx.x; i < count; i += TILE) dst[i] = src[i];
}

// the used coefficients of `rows` rows of sh_rest (n_rest coefficients a
// row) from row0, into shared memory at Rest<DEG>::STRIDE floats a row:
// one contiguous copy where the used coefficients are the whole row and
// its layout is shared memory's, else float by float
template <int DEG>
__device__ __forceinline__ void load_rest(
    float* s_rest, const float* __restrict__ rest, int n_rest, long long row0, int rows)
{
    constexpr int U3 = 3 * Rest<DEG>::USED, S = Rest<DEG>::STRIDE;
    const float* src = rest + row0 * 3 * n_rest;
    if (U3 == S && 3 * n_rest == U3) {
        load_tile(s_rest, src, rows * U3);
        return;
    }
    for (int i = threadIdx.x; i < rows * U3; i += TILE) {
        const int r = i / U3, c = i - r * U3;
        s_rest[r * S + c] = __ldg(src + (long long)r * 3 * n_rest + c);
    }
}

// sh_rest's gradient of `rows` rows from row0, n_rest coefficients a row:
// the used ones from shared memory, zeros above the degree
template <int DEG>
__device__ __forceinline__ void store_rest(
    float* __restrict__ d_rest, const float* s_rest, int n_rest, long long row0, int rows)
{
    constexpr int U3 = 3 * Rest<DEG>::USED, S = Rest<DEG>::STRIDE;
    float* dst = d_rest + row0 * 3 * n_rest;
    if (U3 == S && 3 * n_rest == U3) {
        store_tile(dst, s_rest, rows * U3);
        return;
    }
    const int w = 3 * n_rest;
    for (int i = threadIdx.x; i < rows * w; i += TILE) {
        const int r = i / w, c = i - r * w;
        dst[i] = c < U3 ? s_rest[r * S + c] : 0.0f;
    }
}

// the unit direction from the camera centre of w2c [4, 4] (row-major) to
// `mean`, as models/render.py computes it; also the offset d and its norm
struct Dir {
    float d[3], n, m, u[3];  // offset, its norm, max(norm, 1e-8), d / m
};

__device__ __forceinline__ Dir direction(const float* __restrict__ w2c, const float* mean)
{
    Dir r;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
        // cam_j = -(R[0][j] t0 + R[1][j] t1 + R[2][j] t2)
        const float cam = -add(add(mul(__ldg(w2c + j), __ldg(w2c + 3)),
                                   mul(__ldg(w2c + 4 + j), __ldg(w2c + 7))),
                               mul(__ldg(w2c + 8 + j), __ldg(w2c + 11)));
        r.d[j] = sub(mean[j], cam);
    }
    r.n = sqrtf(fmaf(r.d[2], r.d[2], fmaf(r.d[1], r.d[1], r.d[0] * r.d[0])));
    r.m = r.n < NORM_EPS ? NORM_EPS : r.n;  // torch.maximum: a NaN stays
#pragma unroll
    for (int j = 0; j < 3; ++j) r.u[j] = __fdiv_rn(r.d[j], r.m);
    return r;
}

// B[k], the multiplier of rest coefficient k - 1 (k = 1..USED), rounded op
// by op as ops/sh.py::eval_sh_flat rounds it; the subtracted degree-1
// terms are negated (a - b and a + (-b) round alike)
template <int DEG>
__device__ __forceinline__ void basis(const float* u, float* B)
{
    const float x = u[0], y = u[1], z = u[2];
    if constexpr (DEG >= 1) {
        B[1] = -mul(C1, y);
        B[2] = mul(C1, z);
        B[3] = -mul(C1, x);
    }
    if constexpr (DEG >= 2) {
        const float xx = mul(x, x), yy = mul(y, y), zz = mul(z, z);
        const float xy = mul(x, y), yz = mul(y, z), xz = mul(x, z);
        B[4] = mul(C2_0, xy);
        B[5] = mul(C2_1, yz);
        B[6] = mul(C2_2, sub(sub(mul(2.0f, zz), xx), yy));
        B[7] = mul(C2_3, xz);
        B[8] = mul(C2_4, sub(xx, yy));
        if constexpr (DEG >= 3) {
            B[9] = mul(mul(C3_0, y), sub(mul(3.0f, xx), yy));
            B[10] = mul(mul(C3_1, xy), z);
            B[11] = mul(mul(C3_2, y), sub(sub(mul(4.0f, zz), xx), yy));
            B[12] = mul(mul(C3_3, z), sub(sub(mul(2.0f, zz), mul(3.0f, xx)), mul(3.0f, yy)));
            B[13] = mul(mul(C3_4, x), sub(sub(mul(4.0f, zz), xx), yy));
            B[14] = mul(mul(C3_5, z), sub(xx, yy));
            B[15] = mul(mul(C3_6, x), sub(xx, mul(3.0f, yy)));
        }
    }
}

// the raw colour C0 sh_0 + sum_k B[k] rest[k-1], added in k order
template <int DEG>
__device__ __forceinline__ void raw_color(const float* sh0, const float* rest, const float* B,
                                          float* raw)
{
#pragma unroll
    for (int c = 0; c < 3; ++c) raw[c] = mul(C0, sh0[c]);
#pragma unroll
    for (int k = 1; k <= Rest<DEG>::USED; ++k)
#pragma unroll
        for (int c = 0; c < 3; ++c) raw[c] = add(raw[c], mul(B[k], rest[3 * (k - 1) + c]));
}

// sum_k s[k] * dB[k]/du: the gradient of the raw colour's dot with the
// upstream gradient, with s[k] = that gradient's dot with rest[k-1]
template <int DEG>
__device__ __forceinline__ void basis_grad(const float* u, const float* s, float* g)
{
    const float x = u[0], y = u[1], z = u[2];
    g[0] = g[1] = g[2] = 0.0f;
    if constexpr (DEG >= 1) {
        g[1] -= C1 * s[1];
        g[2] += C1 * s[2];
        g[0] -= C1 * s[3];
    }
    if constexpr (DEG >= 2) {
        g[0] += C2_0 * y * s[4];
        g[1] += C2_0 * x * s[4];
        g[1] += C2_1 * z * s[5];
        g[2] += C2_1 * y * s[5];
        g[0] -= 2.0f * C2_2 * x * s[6];
        g[1] -= 2.0f * C2_2 * y * s[6];
        g[2] += 4.0f * C2_2 * z * s[6];
        g[0] += C2_3 * z * s[7];
        g[2] += C2_3 * x * s[7];
        g[0] += 2.0f * C2_4 * x * s[8];
        g[1] -= 2.0f * C2_4 * y * s[8];
    }
    if constexpr (DEG >= 3) {
        const float xx = x * x, yy = y * y, zz = z * z;
        g[0] += C3_0 * 6.0f * x * y * s[9];
        g[1] += C3_0 * 3.0f * (xx - yy) * s[9];
        g[0] += C3_1 * y * z * s[10];
        g[1] += C3_1 * x * z * s[10];
        g[2] += C3_1 * x * y * s[10];
        g[0] -= C3_2 * 2.0f * x * y * s[11];
        g[1] += C3_2 * (4.0f * zz - xx - 3.0f * yy) * s[11];
        g[2] += C3_2 * 8.0f * y * z * s[11];
        g[0] -= C3_3 * 6.0f * x * z * s[12];
        g[1] -= C3_3 * 6.0f * y * z * s[12];
        g[2] += C3_3 * (6.0f * zz - 3.0f * xx - 3.0f * yy) * s[12];
        g[0] += C3_4 * (4.0f * zz - 3.0f * xx - yy) * s[13];
        g[1] -= C3_4 * 2.0f * x * y * s[13];
        g[2] += C3_4 * 8.0f * x * z * s[13];
        g[0] += C3_5 * 2.0f * x * z * s[14];
        g[1] -= C3_5 * 2.0f * y * z * s[14];
        g[2] += C3_5 * (xx - yy) * s[14];
        g[0] += C3_6 * 3.0f * (xx - yy) * s[15];
        g[1] -= C3_6 * 6.0f * x * y * s[15];
    }
}

template <int DEG>
__global__ void __launch_bounds__(TILE) sh_color_forward_kernel(
    const float* __restrict__ means,  // [n, 3]
    const float* __restrict__ sh0,    // [n, 3]
    const float* __restrict__ rest,   // [n, n_rest * 3]
    int n_rest,
    const float* __restrict__ w2c,    // [4, 4]
    long long n,
    float* __restrict__ color)        // [n, 3]
{
    __shared__ __align__(16) float s_rest[Rest<DEG>::SMEM];
    __shared__ __align__(16) float s_mean[TILE * 3];  // then the colours
    __shared__ __align__(16) float s_sh0[TILE * 3];
    const long long row0 = (long long)blockIdx.x * TILE;
    const int rows = (int)min((long long)TILE, n - row0);
    load_tile(s_mean, means + row0 * 3, rows * 3);
    load_tile(s_sh0, sh0 + row0 * 3, rows * 3);
    if constexpr (Rest<DEG>::USED > 0) load_rest<DEG>(s_rest, rest, n_rest, row0, rows);
    __syncthreads();
    const int t = threadIdx.x;
    if (t < rows) {
        float B[Rest<DEG>::USED + 1];
        if constexpr (DEG > 0) basis<DEG>(direction(w2c, s_mean + 3 * t).u, B);
        float raw[3];
        raw_color<DEG>(s_sh0 + 3 * t, s_rest + t * Rest<DEG>::STRIDE, B, raw);
#pragma unroll
        for (int c = 0; c < 3; ++c) {
            const float v = add(raw[c], 0.5f);
            s_mean[3 * t + c] = v < 0.0f ? 0.0f : v;  // torch.maximum: a NaN stays
        }
    }
    __syncthreads();
    store_tile(color + row0 * 3, s_mean, rows * 3);
}

template <int DEG>
__global__ void __launch_bounds__(TILE) sh_color_backward_kernel(
    const float* __restrict__ grad,   // [n, 3] the colours' gradient
    const float* __restrict__ means,  // [n, 3]
    const float* __restrict__ sh0,    // [n, 3]
    const float* __restrict__ rest,   // [n, n_rest * 3]
    int n_rest,
    const float* __restrict__ w2c,    // [4, 4]
    long long n,
    float* __restrict__ d_means,      // [n, 3] (degree 0: nullptr, no direction)
    float* __restrict__ d_sh0,        // [n, 3]
    float* __restrict__ d_rest)       // [n, n_rest * 3]
{
    constexpr int U = Rest<DEG>::USED, S = Rest<DEG>::STRIDE;
    __shared__ __align__(16) float s_rest[Rest<DEG>::SMEM];  // then its gradient
    __shared__ __align__(16) float s_mean[TILE * 3];          // then its gradient
    __shared__ __align__(16) float s_sh0[TILE * 3];           // then its gradient
    __shared__ __align__(16) float s_grad[TILE * 3];
    const long long row0 = (long long)blockIdx.x * TILE;
    const int rows = (int)min((long long)TILE, n - row0);
    load_tile(s_grad, grad + row0 * 3, rows * 3);
    load_tile(s_sh0, sh0 + row0 * 3, rows * 3);
    if constexpr (DEG > 0) {
        load_tile(s_mean, means + row0 * 3, rows * 3);
        load_rest<DEG>(s_rest, rest, n_rest, row0, rows);
    }
    __syncthreads();
    const int t = threadIdx.x;
    if (t < rows) {
        float* my_rest = s_rest + t * S;
        float B[U + 1];
        Dir dir;
        if constexpr (DEG > 0) {
            dir = direction(w2c, s_mean + 3 * t);
            basis<DEG>(dir.u, B);
        }
        // the clamp's gradient as jnp.maximum (and ops/clip.py) gives it:
        // 0 below, half at a tie, all of it above
        float raw[3], g[3];
        raw_color<DEG>(s_sh0 + 3 * t, my_rest, B, raw);
#pragma unroll
        for (int c = 0; c < 3; ++c) {
            const float v = add(raw[c], 0.5f), up = s_grad[3 * t + c];
            g[c] = v < 0.0f ? 0.0f : (v == 0.0f ? 0.5f * up : up);
            s_sh0[3 * t + c] = mul(g[c], C0);
        }
        if constexpr (DEG > 0) {
            float s[U + 1];
#pragma unroll
            for (int k = 1; k <= U; ++k) {
                float* r = my_rest + 3 * (k - 1);
                s[k] = g[0] * r[0] + g[1] * r[1] + g[2] * r[2];
#pragma unroll
                for (int c = 0; c < 3; ++c) r[c] = mul(g[c], B[k]);
            }
            float gu[3];
            basis_grad<DEG>(dir.u, s, gu);
            // u = d / max(|d|, 1e-8): the numerator's gradient, then the
            // bound's through the norm (half at a tie, none below it or at
            // a zero offset)
            const float dot = gu[0] * dir.d[0] + gu[1] * dir.d[1] + gu[2] * dir.d[2];
            const float w = dir.n < NORM_EPS ? 0.0f : (dir.n == NORM_EPS ? 0.5f : 1.0f);
            const float gn = w == 0.0f ? 0.0f : -w * dot / (dir.m * dir.m * dir.n);
#pragma unroll
            for (int j = 0; j < 3; ++j) s_mean[3 * t + j] = gu[j] / dir.m + gn * dir.d[j];
        }
    }
    __syncthreads();
    store_tile(d_sh0 + row0 * 3, s_sh0, rows * 3);
    if constexpr (DEG > 0) store_tile(d_means + row0 * 3, s_mean, rows * 3);
    store_rest<DEG>(d_rest, s_rest, n_rest, row0, rows);
}

long long blocks_of(long long n) { return (n + TILE - 1) / TILE; }

template <int DEG>
cudaError_t forward(const float* means, const float* sh0, const float* rest, int n_rest,
                    const float* w2c, long long n, float* color, cudaStream_t s)
{
    sh_color_forward_kernel<DEG><<<(unsigned)blocks_of(n), TILE, 0, s>>>(
        means, sh0, rest, n_rest, w2c, n, color);
    return cudaGetLastError();
}

template <int DEG>
cudaError_t backward(const float* grad, const float* means, const float* sh0, const float* rest,
                     int n_rest, const float* w2c, long long n, float* d_means, float* d_sh0,
                     float* d_rest, cudaStream_t s)
{
    sh_color_backward_kernel<DEG><<<(unsigned)blocks_of(n), TILE, 0, s>>>(
        grad, means, sh0, rest, n_rest, w2c, n, d_means, d_sh0, d_rest);
    return cudaGetLastError();
}

}  // namespace

// colors [n, 3] of n rows at SH degree `degree` (0..3, at most the degree
// n_rest coefficients hold, n_rest <= 15); every array f32 and contiguous
extern "C" int egs_sh_color_forward(
    const float* means, const float* sh0, const float* rest, int n_rest, const float* w2c,
    long long n, int degree, float* color, int device, void* stream)
{
    if (degree < 0 || degree > 3 || n_rest > MAX_REST || (degree + 1) * (degree + 1) - 1 > n_rest)
        return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (n == 0) return 0;
    cudaStream_t s = (cudaStream_t)stream;
    switch (degree) {
        case 0: return (int)forward<0>(means, sh0, rest, n_rest, w2c, n, color, s);
        case 1: return (int)forward<1>(means, sh0, rest, n_rest, w2c, n, color, s);
        case 2: return (int)forward<2>(means, sh0, rest, n_rest, w2c, n, color, s);
        default: return (int)forward<3>(means, sh0, rest, n_rest, w2c, n, color, s);
    }
}

// the gradients of means (degree > 0 only), sh_0 and sh_rest (zeros above
// the degree) from the colours' gradient `grad` [n, 3]
extern "C" int egs_sh_color_backward(
    const float* grad, const float* means, const float* sh0, const float* rest, int n_rest,
    const float* w2c, long long n, int degree, float* d_means, float* d_sh0, float* d_rest,
    int device, void* stream)
{
    if (degree < 0 || degree > 3 || n_rest > MAX_REST || (degree + 1) * (degree + 1) - 1 > n_rest
        || (degree > 0 && d_means == nullptr))
        return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (n == 0) return 0;
    cudaStream_t s = (cudaStream_t)stream;
    switch (degree) {
        case 0: return (int)backward<0>(grad, means, sh0, rest, n_rest, w2c, n, d_means, d_sh0,
                                        d_rest, s);
        case 1: return (int)backward<1>(grad, means, sh0, rest, n_rest, w2c, n, d_means, d_sh0,
                                        d_rest, s);
        case 2: return (int)backward<2>(grad, means, sh0, rest, n_rest, w2c, n, d_means, d_sh0,
                                        d_rest, s);
        default: return (int)backward<3>(grad, means, sh0, rest, n_rest, w2c, n, d_means, d_sh0,
                                         d_rest, s);
    }
}
