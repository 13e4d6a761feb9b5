// One grouped Adam step over the six parameter groups of the train state,
// in one launch: for each value of a group that is not skipped,
//
//   mu1 = 0.9 mu + 0.1 g,  nu1 = 0.999 nu + (0.001 g) g,
//   p1  = p - lr (mu1 / (1 - 0.9^t)) / (sqrt(nu1 / (1 - 0.999^t)) + 1e-8),
//
// with t the group's step count plus one, its learning rate `lr` and its
// skip flag read from the device or given by value.
//
// Replaces no Pallas kernel: the JAX package leaves Adam to XLA, which
// fuses the update of each group into one pass on the TPU. As eager
// PyTorch ops (easy_gaussian_splatting_torch/ops/kernels/adam.py::
// adam_plain) the same update is some 20 full-width passes a group, three
// of them `torch.where`s on the skip flag that write every output a second
// time: about 42 floats read or written a value, 168 B. Plain version and
// wrapper: easy_gaussian_splatting_torch/ops/kernels/adam.py.
//
// What bounds it on an H100: device memory. A value reads p, g, mu and nu
// and writes p, mu and nu, 28 B; at 3,145,728 slots of 59 values (degree 3)
// that is 5.20 GB a step, 1.55 ms at 3.35 TB/s. Nothing is read twice, so
// the kernel is a stream: each block takes 4,096 consecutive values of one
// group (groups map to blocks through the block offsets the wrapper puts in
// the table), each thread four 16-byte loads of each input issued before
// any arithmetic, and the group's ragged end a float at a time. Plain loads
// and stores: on an H100 80GB HBM3 at 700 W the streaming hints (__ldcs,
// __stcs) took 1.748 ms at 3,145,728 slots against 1.726 without, and 256
// threads of four float4s 1.726 against 1.727-1.762 for 128 x 8, 512 x 2
// and 1024 x 1. A thread reads its group's flag, learning rate and step
// count once. A skipped group run in place writes nothing; out of place, it
// copies its inputs (torch.where's result). The step counts are read, never
// written: the other blocks still read them; the wrapper advances them
// after the launch.
//
// Rounding: op by op in the plain version's order with IEEE intrinsics (no
// contraction, true division and square root), the constants the float32
// casts of the doubles PyTorch casts, and the bias corrections from powf
// as torch.pow computes them, so the results equal the plain version's on
// the card bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_GROUPS = 6;
constexpr int THREADS = 256;
constexpr int ITEMS = 4;  // float4s a thread
constexpr long long BLOCK_VALUES = (long long)THREADS * ITEMS * 4;

constexpr float BETA1 = (float)0.9;
constexpr float ONE_MINUS_BETA1 = (float)(1.0 - 0.9);
constexpr float BETA2 = (float)0.999;
constexpr float ONE_MINUS_BETA2 = (float)(1.0 - 0.999);
constexpr float EPS = (float)1e-8;

}  // namespace

// one group's descriptor; ops/kernels/adam.py::_Group mirrors it field by field
struct EgsAdamGroup {
    const float* p;
    const float* g;
    const float* mu;
    const float* nu;
    float* p_out;   // the outputs: p, mu and nu themselves in place
    float* mu_out;
    float* nu_out;
    const float* lr;              // the 0-d learning rate on the device, or null: lr_value
    const unsigned char* skip;    // the 0-d bool skip flag on the device, or null: no skip
    const int* step;              // the group's 0-d int32 step count
    long long n;                  // values
    long long block0;             // the group's first block
    float lr_value;
    int pad;
};

namespace {

struct Table {
    EgsAdamGroup g[MAX_GROUPS];
    int count;
};

__device__ __forceinline__ bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

// 1 - beta^t in float32 for t = step + 1, as torch.pow and the rsub do
__device__ __forceinline__ void bias_corrections(int step, float& bc1, float& bc2)
{
    const float t = (float)(step + 1);
    bc1 = __fsub_rn(1.0f, powf(BETA1, t));
    bc2 = __fsub_rn(1.0f, powf(BETA2, t));
}

__device__ __forceinline__ void update(float& p, float g, float& m, float& v, float bc1, float bc2,
                                       float lr)
{
    m = __fadd_rn(__fmul_rn(BETA1, m), __fmul_rn(ONE_MINUS_BETA1, g));
    v = __fadd_rn(__fmul_rn(BETA2, v), __fmul_rn(__fmul_rn(ONE_MINUS_BETA2, g), g));
    const float m_hat = __fdiv_rn(m, bc1);
    const float v_hat = __fdiv_rn(v, bc2);
    p = __fsub_rn(p, __fdiv_rn(__fmul_rn(lr, m_hat), __fadd_rn(__fsqrt_rn(v_hat), EPS)));
}

__device__ __forceinline__ void update4(float4& p, const float4& g, float4& m, float4& v,
                                        float bc1, float bc2, float lr)
{
    update(p.x, g.x, m.x, v.x, bc1, bc2, lr);
    update(p.y, g.y, m.y, v.y, bc1, bc2, lr);
    update(p.z, g.z, m.z, v.z, bc1, bc2, lr);
    update(p.w, g.w, m.w, v.w, bc1, bc2, lr);
}

__global__ void __launch_bounds__(THREADS) adam_kernel(const Table t)
{
    // the block's group: the last whose first block is at or before it
    const long long b = blockIdx.x;
    EgsAdamGroup G = t.g[0];
#pragma unroll
    for (int i = 1; i < MAX_GROUPS; ++i)
        if (i < t.count && b >= t.g[i].block0) G = t.g[i];
    const long long first = (b - G.block0) * BLOCK_VALUES;
    const long long end = first + BLOCK_VALUES < G.n ? first + BLOCK_VALUES : G.n;
    const int tid = threadIdx.x;

    if (G.skip != nullptr && *G.skip) {
        if (G.p_out == G.p) return;  // in place: the buffers keep their bits
        for (long long i = first + tid; i < end; i += THREADS) {
            G.p_out[i] = G.p[i];
            G.mu_out[i] = G.mu[i];
            G.nu_out[i] = G.nu[i];
        }
        return;
    }
    float bc1, bc2;
    bias_corrections(*G.step, bc1, bc2);
    const float lr = G.lr != nullptr ? *G.lr : G.lr_value;

    const bool vec = aligned16(G.p) && aligned16(G.g) && aligned16(G.mu) && aligned16(G.nu)
                     && aligned16(G.p_out) && aligned16(G.mu_out) && aligned16(G.nu_out);
    long long tail = first;  // the first value left to the scalar loop
    if (vec) {
        const long long n4 = G.n >> 2, first4 = first >> 2;
        const float4* p4 = reinterpret_cast<const float4*>(G.p);
        const float4* g4 = reinterpret_cast<const float4*>(G.g);
        const float4* m4 = reinterpret_cast<const float4*>(G.mu);
        const float4* v4 = reinterpret_cast<const float4*>(G.nu);
        float4 p[ITEMS], g[ITEMS], m[ITEMS], v[ITEMS];
#pragma unroll
        for (int k = 0; k < ITEMS; ++k) {
            const long long j = first4 + k * THREADS + tid;
            if (j < n4) {
                p[k] = p4[j];
                g[k] = g4[j];
                m[k] = m4[j];
                v[k] = v4[j];
            }
        }
#pragma unroll
        for (int k = 0; k < ITEMS; ++k) {
            const long long j = first4 + k * THREADS + tid;
            if (j < n4) {
                update4(p[k], g[k], m[k], v[k], bc1, bc2, lr);
                reinterpret_cast<float4*>(G.p_out)[j] = p[k];
                reinterpret_cast<float4*>(G.mu_out)[j] = m[k];
                reinterpret_cast<float4*>(G.nu_out)[j] = v[k];
            }
        }
        tail = n4 << 2 > first ? n4 << 2 : first;
    }
    for (long long i = tail + tid; i < end; i += THREADS) {
        float p = G.p[i], m = G.mu[i], v = G.nu[i];
        update(p, G.g[i], m, v, bc1, bc2, lr);
        G.p_out[i] = p;
        G.mu_out[i] = m;
        G.nu_out[i] = v;
    }
}

}  // namespace

// one Adam step over `count` groups (at most 6) in one launch of `blocks`
// blocks: each group ceil(n / 4096) of them from its block0
extern "C" int egs_adam_step(const EgsAdamGroup* groups, int count, long long blocks, int device,
                             void* stream)
{
    if (count < 1 || count > MAX_GROUPS || blocks < 1 || blocks > 0x7fffffffLL)
        return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    Table t = {};
    for (int i = 0; i < count; ++i) t.g[i] = groups[i];
    t.count = count;
    adam_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(t);
    return (int)cudaGetLastError();
}
