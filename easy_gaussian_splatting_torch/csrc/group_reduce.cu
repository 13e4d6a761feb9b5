// Fixed-stride group sums: out[g] = sum of x[g*b + k] for k in [0, b), added
// in row order.
//
// Replaces the Pallas TPU kernel easy_gaussian_splatting_tpu/ops/pallas/
// group_reduce.py::group_reduce (body _kernel). Plain PyTorch version and
// wrapper: easy_gaussian_splatting_torch/ops/kernels/group_reduce.py.
//
// x [G*b, 16] f32 are the tiled backward's gradient rows gathered into the
// dense duplicate grid, where each Gaussian's rows sit at a fixed stride
// (the `dense` backward reduction); out [G, 16] f32. The TPU kernel reduced
// bf16 hi/lo rows of 128 lanes in VMEM blocks; the port's rows are the
// decoded f32 values, 16 columns of which 11 are live.
//
// What bounds it on an H100: device memory. Every input byte is read once
// and every output byte written once, against one add per float read.
// Design: one thread per (group, float4 column block), four threads per
// 64-byte row, each summing its group's b rows with 16-byte loads, in row
// order (the result does not depend on scheduling, and the plain version,
// which adds the same rows in the same order, agrees bit for bit).

#include <cuda_runtime.h>

namespace {

constexpr int NF4 = 4;  // float4 per 16-float row

__global__ void group_reduce_kernel(
    const float4* __restrict__ x,  // [G*b, 16] as [G*b, 4] float4
    long long groups, int b,
    float4* __restrict__ out)      // [G, 16]
{
    const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (idx >= groups * NF4) return;
    const long long g = idx / NF4;
    const int q = (int)(idx - g * NF4);
    const float4* src = x + g * b * NF4 + q;
    float4 acc = src[0];
    for (int k = 1; k < b; ++k) {
        const float4 r = src[(long long)k * NF4];
        acc.x += r.x;
        acc.y += r.y;
        acc.z += r.z;
        acc.w += r.w;
    }
    out[idx] = acc;
}

}  // namespace

extern "C" int egs_group_reduce(
    const float* x, long long groups, int b, float* out, int device, void* stream)
{
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    const int threads = 256;
    const long long blocks = (groups * NF4 + threads - 1) / threads;
    group_reduce_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        reinterpret_cast<const float4*>(x), groups, b, reinterpret_cast<float4*>(out));
    return (int)cudaGetLastError();
}
