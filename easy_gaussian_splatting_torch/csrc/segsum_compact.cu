// Compacted per-group sums over group-sorted rows: out[k] = sum of the rows
// of the k-th group (groups in ascending id order), for k < max_groups.
//
// Replaces the Pallas TPU kernel easy_gaussian_splatting_tpu/ops/pallas/
// segments.py::segsum_compact (body _segsum_kernel). Plain PyTorch version
// and wrapper: easy_gaussian_splatting_torch/ops/kernels/segments.py.
//
// rows [n, 16] f32 are the tiled backward's gradient rows gathered into
// ascending flat-id order, g [n] i32 their non-decreasing group ids
// (compared as integers). A group's slot k is the number of group starts
// before it. Groups at or past max_groups are not written; output rows past
// the number of groups are left as they were.
//
// The TPU kernel walked 512-row blocks in sequence, carrying each block's
// head-group suffix into the next and merging boundary rows through
// 8-aligned read-modify-write windows. Blocks here run in parallel and in
// no order, so nothing carries from one block to the next.
//
// What bounds it on an H100: device memory. Every row and id is read once
// and every written group's sum written once, 64 bytes each, against one
// add per float read (n = 2.36M rows: 238 MB, 0.071 ms at 3.35 TB/s).
// Design, one launch (after one memset of the status words):
// - each block owns a span of SPAN rows. It starts a cp.async copy of the
//   span's rows (16-byte loads, neighbouring threads on neighbouring
//   addresses) into shared memory at once, so the bytes are in flight
//   while it works out where its groups go;
// - it loads the span's ids and the one before, flags the group starts
//   and takes a block-wide exclusive scan of the flags: each start's index
//   among the span's starts;
// - a block takes its span from a ticket (one atomicAdd), not from
//   blockIdx: the spans are handed out in the order the blocks start, so
//   every span a block waits on belongs to a block that is already running;
// - its global base, the number of starts in all earlier spans, comes from
//   a single-pass decoupled look-back: the block publishes its own count in
//   its status word (flag AGGREGATE), then warp 0 reads 32 predecessors'
//   words at a time back to the nearest one holding an inclusive prefix
//   (flag PREFIX), sums, and publishes its own inclusive prefix. The flag
//   and the count share one 64-bit word, so a reader never sees one
//   without the other;
// - each group starting in the span is summed from shared memory by four
//   threads, one float4 column each, its rows added one after the other in
//   row order; the block's last group, if it runs past the span's end, is
//   finished by the same threads from device memory. Neighbouring groups'
//   sums go to neighbouring output rows, so the stores coalesce.
// No atomics touch the sums, so two launches give the same bits; the sums
// equal the CPU plain version's (index_add_ in row order) bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int NF4 = 4;       // float4 per 16-float row
constexpr int SPAN = 512;    // rows a block owns
constexpr int THREADS = 256;  // two rows' flags a thread
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned long long AGGREGATE = 1ull;  // the block's own count
constexpr unsigned long long PREFIX = 2ull;     // starts up to the block's end

__device__ __forceinline__ void cp_async16(float4* dst, const float4* src)
{
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void store_status(unsigned long long* p, unsigned long long flag,
                                             long long count)
{
    *(volatile unsigned long long*)p = (flag << 32) | (unsigned long long)(unsigned)count;
}

__device__ __forceinline__ unsigned long long load_status(const unsigned long long* p)
{
    return *(const volatile unsigned long long*)p;
}

__device__ __forceinline__ void add4(float4& acc, const float4 x)
{
    acc.x += x.x;
    acc.y += x.y;
    acc.z += x.z;
    acc.w += x.w;
}

__global__ void __launch_bounds__(THREADS) segsum_compact_kernel(
    const float4* __restrict__ rows,  // [n, 16] as [n, 4] float4
    const int* __restrict__ g,        // [n]
    long long n, long long max_groups,
    unsigned long long* __restrict__ status,  // [gridDim.x + 1], zeroed: words, ticket
    float4* __restrict__ out)         // [max_groups, 16]
{
    __shared__ __align__(16) float4 s_rows[SPAN * NF4];
    __shared__ int s_ids[SPAN + 1];    // the id before the span, then the span's
    __shared__ int s_start[SPAN + 1];  // local row of each start, then len
    __shared__ int s_warp[WARPS];
    __shared__ long long s_base;
    __shared__ long long s_ticket;

    if (threadIdx.x == 0) s_ticket = (long long)atomicAdd(status + gridDim.x, 1ull);
    __syncthreads();
    const long long b = s_ticket;
    const long long span0 = b * SPAN;
    const int len = (int)min((long long)SPAN, n - span0);
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

    // the span's rows, in flight while the slots are worked out
    const float4* src = rows + span0 * NF4;
    for (int i = tid; i < len * NF4; i += THREADS) cp_async16(s_rows + i, src + i);
    asm volatile("cp.async.commit_group;\n" ::: "memory");

    for (int i = tid; i < len; i += THREADS) s_ids[1 + i] = g[span0 + i];
    if (tid == 0) s_ids[0] = b > 0 ? g[span0 - 1] : 0;
    __syncthreads();

    // group-start flags of local rows 2 tid and 2 tid + 1, and their scan
    const int r0 = 2 * tid, r1 = r0 + 1;
    const int f0 = r0 < len && ((b == 0 && r0 == 0) || s_ids[r0 + 1] != s_ids[r0]);
    const int f1 = r1 < len && s_ids[r1 + 1] != s_ids[r1];
    const int v = f0 + f1;
    int incl = v;
    for (int o = 1; o < 32; o <<= 1) {
        const int t = __shfl_up_sync(FULL, incl, o);
        if (lane >= o) incl += t;
    }
    if (lane == 31) s_warp[warp] = incl;
    __syncthreads();
    if (warp == 0) {
        int w = lane < WARPS ? s_warp[lane] : 0;
        for (int o = 1; o < WARPS; o <<= 1) {
            const int t = __shfl_up_sync(FULL, w, o);
            if (lane >= o) w += t;
        }
        if (lane < WARPS) s_warp[lane] = w;
    }
    __syncthreads();
    const int excl = (warp > 0 ? s_warp[warp - 1] : 0) + incl - v;
    const int count = s_warp[WARPS - 1];
    if (f0) s_start[excl] = r0;
    if (f1) s_start[excl + f0] = r1;
    if (tid == 0) s_start[count] = len;

    // the span's base: decoupled look-back over the earlier blocks
    if (warp == 0) {
        long long prefix = 0;
        if (b > 0) {
            if (lane == 0) store_status(status + b, AGGREGATE, count);
            for (long long top = b - 1;; top -= 32) {
                const long long idx = top - lane;
                unsigned long long w;
                do {
                    w = idx >= 0 ? load_status(status + idx) : PREFIX << 32;
                } while (__any_sync(FULL, (w >> 32) == 0));
                const unsigned pm = __ballot_sync(FULL, (w >> 32) == PREFIX);
                const int stop = pm ? __ffs(pm) - 1 : 31;
                long long val = lane <= stop ? (long long)(w & 0xffffffffull) : 0;
                for (int o = 16; o > 0; o >>= 1) val += __shfl_xor_sync(FULL, val, o);
                prefix += val;
                if (pm) break;
            }
        }
        if (lane == 0) {
            store_status(status + b, PREFIX, prefix + count);
            s_base = prefix;
        }
    }
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();

    // each group starting in the span: four threads, one float4 column each
    const int q = tid & (NF4 - 1);
    const long long base = s_base;
    for (int k = tid / NF4; k < count && base + k < max_groups; k += THREADS / NF4) {
        const int s = s_start[k], e = s_start[k + 1];
        float4 acc = s_rows[s * NF4 + q];
        for (int r = s + 1; r < e; ++r) add4(acc, s_rows[r * NF4 + q]);
        if (k == count - 1) {  // the last group may run past the span's end
            const int gid = s_ids[s + 1];
            for (long long j = span0 + len; j < n && g[j] == gid; ++j) add4(acc, rows[j * NF4 + q]);
        }
        out[(base + k) * NF4 + q] = acc;
    }
}

}  // namespace

extern "C" int egs_segsum_compact(
    const float* rows, const int* g, long long n, long long max_groups,
    unsigned long long* status, float* out, int device, void* stream)
{
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    const long long blocks = (n + SPAN - 1) / SPAN;
    err = cudaMemsetAsync(status, 0, (blocks + 1) * sizeof(unsigned long long),
                          (cudaStream_t)stream);
    if (err != cudaSuccess) return (int)err;
    segsum_compact_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
        reinterpret_cast<const float4*>(rows), g, n, max_groups, status,
        reinterpret_cast<float4*>(out));
    return (int)cudaGetLastError();
}

extern "C" long long egs_segsum_compact_span() { return SPAN; }
