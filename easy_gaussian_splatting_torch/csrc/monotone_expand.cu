// Expansion of compacted rows to one row per group: out[c] = present[c] ?
// compact[min(rank[c], n_in - 1)] : 0.
//
// Replaces the Pallas TPU kernel easy_gaussian_splatting_tpu/ops/pallas/
// segments.py::monotone_expand (body _expand_kernel). Plain PyTorch version
// and wrapper: easy_gaussian_splatting_torch/ops/kernels/segments.py.
//
// compact [n_in, 16] f32 are segsum_compact's group sums, rank [C] i32 each
// Gaussian's index among the present ones (monotone, stride <= 1), present
// [C] bool. The TPU had no gather, so its kernel built each 512-row output
// block as a one-hot matmul against a 520-row input window, padded C to 512
// rows, compared ranks as f32 and had to mask the window's rows past n_in
// (0 * garbage would poison the matmul). Here each output row reads its one
// input row directly: any C, integer ranks, and no row past n_in is read
// (the clamp makes the kernel agree bit for bit with the plain version).
//
// What bounds it on an H100: device memory. Each present output row reads
// one 64-byte input row; every output row, its rank and its flag are
// written or read once; no arithmetic.
// Design: one thread per (output row, float4 column block), four threads
// per 64-byte row with 16-byte loads and stores. Neighbouring rows read
// neighbouring input rows (the rank is monotone), so the reads coalesce.

#include <cuda_runtime.h>

namespace {

constexpr int NF4 = 4;  // float4 per 16-float row

__global__ void monotone_expand_kernel(
    const float4* __restrict__ compact,     // [n_in, 16] as [n_in, 4] float4
    const int* __restrict__ rank,           // [C]
    const unsigned char* __restrict__ present,  // [C] bool
    long long c, long long n_in,
    float4* __restrict__ out)               // [C, 16]
{
    const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (idx >= c * NF4) return;
    const long long i = idx / NF4;
    const int q = (int)(idx - i * NF4);
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (present[i]) {
        const long long r = min((long long)rank[i], n_in - 1);
        v = compact[r * NF4 + q];
    }
    out[idx] = v;
}

}  // namespace

extern "C" int egs_monotone_expand(
    const float* compact, const int* rank, const unsigned char* present,
    long long c, long long n_in, float* out, int device, void* stream)
{
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    const int threads = 256;
    const long long blocks = (c * NF4 + threads - 1) / threads;
    monotone_expand_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        reinterpret_cast<const float4*>(compact), rank, present, c, n_in,
        reinterpret_cast<float4*>(out));
    return (int)cudaGetLastError();
}
