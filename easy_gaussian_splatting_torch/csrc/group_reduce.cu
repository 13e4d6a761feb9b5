// Fixed-stride group sums: out[g] = sum of x[g*b + k] for k in [0, b), added
// in row order; optionally followed, in the same launch, by a tail
// population of groups of another size, their sums after the others.
//
// Replaces the Pallas TPU kernel easy_gaussian_splatting_tpu/ops/pallas/
// group_reduce.py::group_reduce (body _kernel). Plain PyTorch version and
// wrapper: easy_gaussian_splatting_torch/ops/kernels/group_reduce.py.
//
// x [G*b + G2*b2, 16] f32 are the tiled backward's gradient rows gathered
// into the dense duplicate grid, where each Gaussian's rows sit at a fixed
// stride (the `dense` backward reduction: b = b_small rows per Gaussian,
// then b2 = M rows per overflow slot); out [G + G2, 16] f32. The TPU kernel
// reduced bf16 hi/lo rows of 128 lanes in VMEM blocks, one call per
// population; the port's rows are the decoded f32 values, 16 columns of
// which 11 are live.
//
// What bounds it on an H100: device memory. Every input byte is read once
// and every output byte written once, against one add per float read; the
// train step's populations (6,291,456 rows in groups of 4, 253,952 rows in
// groups of 16) move 0.52 GB, 0.155 ms at 3.35 TB/s.
// Design: one thread per (group, float4 column block), four threads per
// 64-byte row, so each load instruction of a warp reads eight whole rows.
// The group size is a template parameter for the sizes the training path
// gives it (2, 4, 9 and 16 for the head, 16 for the tail; any other size
// takes predicated chunks of 16 rows), and a thread starts all its loads
// before its first add, where a runtime loop bound let each add wait on
// its load before the next load started. Both populations share one
// launch: the small one (under a quarter of a wave of the card) rides in
// the large one's tail instead of paying a launch and a ramp of its own.
// The adds stay in row order, so the result does not depend on scheduling
// and the plain version, which adds the same rows in the same order,
// agrees bit for bit. Measured on an H100 80GB HBM3 at 700 W
// (chip_smoke.py phase 11): ~0.176 ms a step for both populations, against
// ~0.179 ms for the library's two sums `view(G, b, 16).sum(1)` and
// ~0.187 ms for the two launches of a runtime-bound loop it replaced.

#include <cuda_runtime.h>

namespace {

constexpr int NF4 = 4;    // float4 per 16-float row
constexpr int CHUNK = 16; // rows loaded before their adds, any group size

__device__ __forceinline__ void add(float4& acc, const float4 r)
{
    acc.x += r.x;
    acc.y += r.y;
    acc.z += r.z;
    acc.w += r.w;
}

// acc += rows src[0], src[NF4], ..., src[(N-1)*NF4], all loaded first and
// then added in row order
template <int N>
__device__ __forceinline__ void accumulate(float4& acc, const float4* __restrict__ src)
{
    float4 r[N];
#pragma unroll
    for (int k = 0; k < N; ++k) r[k] = __ldg(src + k * NF4);
#pragma unroll
    for (int k = 0; k < N; ++k) add(acc, r[k]);
}

// sum of the `rows` rows src[0], src[NF4], ..., in row order; B > 0: rows
// == B, B == 0: any rows, loaded CHUNK at a time
template <int B>
__device__ __forceinline__ float4 group_sum(const float4* __restrict__ src, int rows)
{
    float4 acc = __ldg(src);
    if constexpr (B > 1) {
        accumulate<B - 1>(acc, src + NF4);
    } else if constexpr (B == 0) {
        for (int k = 1; k < rows; k += CHUNK) {
            const int n = min(CHUNK, rows - k);
            float4 r[CHUNK];
#pragma unroll
            for (int j = 0; j < CHUNK; ++j)
                if (j < n) r[j] = __ldg(src + (long long)(k + j) * NF4);
#pragma unroll
            for (int j = 0; j < CHUNK; ++j)
                if (j < n) add(acc, r[j]);
        }
    }
    return acc;
}

// `groups` groups of B rows (of b rows when B == 0), then `tail_groups`
// groups of TB rows (of tail_b rows when TB == 0); one output row per
// group, in order
template <int B, int TB>
__global__ void group_reduce_kernel(
    const float4* __restrict__ x,  // [groups*b + tail_groups*tail_b, 16] as float4
    long long groups, int b, long long tail_groups, int tail_b,
    float4* __restrict__ out)      // [groups + tail_groups, 16] as float4
{
    const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    const long long head = groups * NF4;
    if (idx < head) {
        const long long g = idx / NF4;
        const int q = (int)(idx - g * NF4);
        const int rows = B > 0 ? B : b;
        out[idx] = group_sum<B>(x + g * rows * NF4 + q, rows);
    } else if (idx < head + tail_groups * NF4) {
        const long long g = (idx - head) / NF4;
        const int q = (int)(idx - head - g * NF4);
        const int rows = TB > 0 ? TB : tail_b;
        out[idx] = group_sum<TB>(x + (groups * b + g * rows) * NF4 + q, rows);
    }
}

template <int B, int TB>
cudaError_t launch(
    const float* x, long long groups, int b, long long tail_groups, int tail_b, float* out,
    cudaStream_t stream)
{
    const int threads = 256;
    const long long blocks = ((groups + tail_groups) * NF4 + threads - 1) / threads;
    group_reduce_kernel<B, TB><<<(unsigned)blocks, threads, 0, stream>>>(
        reinterpret_cast<const float4*>(x), groups, b, tail_groups, tail_b,
        reinterpret_cast<float4*>(out));
    return cudaGetLastError();
}

// a tail of groups of M = 16 rows (population B of the default max_tiles
// 4) has its own instantiation, any other the chunked loop
template <int B>
cudaError_t launch_head(
    const float* x, long long groups, int b, long long tail_groups, int tail_b, float* out,
    cudaStream_t stream)
{
    return tail_b == 16 ? launch<B, 16>(x, groups, b, tail_groups, tail_b, out, stream)
                        : launch<B, 0>(x, groups, b, tail_groups, tail_b, out, stream);
}

}  // namespace

// the instantiation for group size b: the sizes the training path gives
// the head (population A's budgets, rasterize_tiled.BUDGET_CANDIDATES 2, 4
// and 9, and M = 16, the one-population grid's of the default max_tiles 4)
// have their own, any other size the chunked loop
extern "C" int egs_group_reduce(
    const float* x, long long groups, int b, long long tail_groups, int tail_b, float* out,
    int device, void* stream)
{
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    cudaStream_t s = (cudaStream_t)stream;
    const long long g = groups, tg = tail_groups;
    switch (b) {
        case 2: return (int)launch_head<2>(x, g, b, tg, tail_b, out, s);
        case 4: return (int)launch_head<4>(x, g, b, tg, tail_b, out, s);
        case 9: return (int)launch_head<9>(x, g, b, tg, tail_b, out, s);
        case 16: return (int)launch_head<16>(x, g, b, tg, tail_b, out, s);
        default: return (int)launch_head<0>(x, g, b, tg, tail_b, out, s);
    }
}
