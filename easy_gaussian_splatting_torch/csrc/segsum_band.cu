// Segmented suffix sums over group-sorted rows: out[i] = sum of rows[j]
// for j in [i, i + look) while g[j] == g[i], so each group's total lands on
// its first row.
//
// Replaces the Pallas TPU kernel easy_gaussian_splatting_tpu/ops/pallas/
// segments.py::segsum_band (body _segsum_band_kernel). Plain PyTorch
// version and wrapper: easy_gaussian_splatting_torch/ops/kernels/
// segments.py.
//
// rows [n, 16] f32 are the tiled backward's per-intersection gradient rows
// gathered into ascending flat-id order, g [n] i32 their non-decreasing
// group ids (the Gaussian index; each dead row has an id of its own past
// the live ones). Group ids are compared as integers. A group longer than
// `look` rows gets a sum over its first `look` rows from each row; the
// training path never makes one (max_tiles^2 <= look).
//
// What bounds it on an H100: device memory. Every row is read about once
// per row of its group (groups average ~2 rows and hold at most
// max_tiles^2 = 16 on the training path) and written once, 64 bytes each
// way, against one add per float read.
// Design: one thread per (row, float4 column block), four threads per
// 64-byte row, so a warp reads eight whole rows with 16-byte loads and
// neighbouring warps share the lookahead rows in L1/L2. Each thread sums
// forward from its row while the id matches, in row order, so the result
// does not depend on scheduling.

#include <cuda_runtime.h>

namespace {

constexpr int NF4 = 4;  // float4 per 16-float row

__global__ void segsum_band_kernel(
    const float4* __restrict__ rows,  // [n, 16] as [n, 4] float4
    const int* __restrict__ g,        // [n]
    long long n, int look,
    float4* __restrict__ out)         // [n, 16]
{
    const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (idx >= n * NF4) return;
    const long long i = idx / NF4;
    const int q = (int)(idx - i * NF4);
    const int gi = g[i];
    float4 acc = rows[idx];
    const long long j_end = min(n, i + look);
    for (long long j = i + 1; j < j_end && g[j] == gi; ++j) {
        const float4 r = rows[j * NF4 + q];
        acc.x += r.x;
        acc.y += r.y;
        acc.z += r.z;
        acc.w += r.w;
    }
    out[idx] = acc;
}

}  // namespace

extern "C" int egs_segsum_band(
    const float* rows, const int* g, long long n, int look, float* out,
    int device, void* stream)
{
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    const int threads = 256;
    const long long blocks = (n * NF4 + threads - 1) / threads;
    segsum_band_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        reinterpret_cast<const float4*>(rows), g, n, look,
        reinterpret_cast<float4*>(out));
    return (int)cudaGetLastError();
}
