// Compacted per-group sums over group-sorted rows: out[k] = sum of the rows
// of the k-th group (groups in ascending id order), for k < max_groups.
//
// Replaces the Pallas TPU kernel easy_gaussian_splatting_tpu/ops/pallas/
// segments.py::segsum_compact (body _segsum_kernel). Plain PyTorch version
// and wrapper: easy_gaussian_splatting_torch/ops/kernels/segments.py.
//
// rows [n, 16] f32 are the tiled backward's gradient rows gathered into
// ascending flat-id order, g [n] i32 their non-decreasing group ids
// (compared as integers), slot [n] i32 the index of each row's group: the
// inclusive cumulative sum of the group-start flags, less one, computed by
// the wrapper. Groups at or past max_groups are not written; output rows
// past the number of groups are left as they were.
//
// The TPU kernel walked 512-row blocks in sequence, carrying each block's
// head-group suffix into the next and merging boundary rows through
// 8-aligned read-modify-write windows. Blocks here run in parallel and in
// no order, so nothing carries: the thread at each group's first row sums
// the whole group. That is right for any group length (a long group is
// walked serially). The training path keeps groups short: each dead row
// gets a group id of its own, so no thread walks the dead tail.
//
// What bounds it on an H100: device memory. Every row is read once (by the
// threads of its group's first row) and every present group written once,
// 64 bytes each, against one add per float read.
// Design: one thread per (row, float4 column block), four threads per
// 64-byte row with 16-byte loads; threads not at a group start exit after
// reading two ids. Each sum runs in row order, with no atomics, so the
// result does not depend on scheduling.

#include <cuda_runtime.h>

namespace {

constexpr int NF4 = 4;  // float4 per 16-float row

__global__ void segsum_compact_kernel(
    const float4* __restrict__ rows,  // [n, 16] as [n, 4] float4
    const int* __restrict__ g,        // [n]
    const int* __restrict__ slot,     // [n]
    long long n, long long max_groups,
    float4* __restrict__ out)         // [max_groups, 16]
{
    const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (idx >= n * NF4) return;
    const long long i = idx / NF4;
    const int q = (int)(idx - i * NF4);
    const int gi = g[i];
    if (i > 0 && g[i - 1] == gi) return;  // not the group's first row
    const long long k = slot[i];
    if (k >= max_groups) return;
    float4 acc = rows[idx];
    for (long long j = i + 1; j < n && g[j] == gi; ++j) {
        const float4 r = rows[j * NF4 + q];
        acc.x += r.x;
        acc.y += r.y;
        acc.z += r.z;
        acc.w += r.w;
    }
    out[k * NF4 + q] = acc;
}

}  // namespace

extern "C" int egs_segsum_compact(
    const float* rows, const int* g, const int* slot, long long n,
    long long max_groups, float* out, int device, void* stream)
{
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    const int threads = 256;
    const long long blocks = (n * NF4 + threads - 1) / threads;
    segsum_compact_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        reinterpret_cast<const float4*>(rows), g, slot, n, max_groups,
        reinterpret_cast<float4*>(out));
    return (int)cudaGetLastError();
}
