// Per-tile banded resample at data-dependent window starts (K3), for
// Hopper, sm_90a.
//
//   y[s, t*tile + p] = sum_{w < w_band} x[s, starts[t] + w] * m_t[t, w, p]
//
// Replaces the TPU kernel go_audio_resampler_tpu/ops/pallas_fused.py::
// general_resample_pallas (body _general_kernel).  It computes the same
// function; it does not copy that kernel's structure.  The TPU kernel's
// scalar-prefetched starts, 128-lane aligned DMA with its on-chip roll,
// stream-tile padding of x and 128-row padding of each matrix were
// constraints of the TPU and are gone: each block reads its tile's start
// from the device array itself, reads the window of x in place, masks the
// ragged stream, column and tap edges itself, and clamps a window sample
// outside [0, n) to the nearest end, as the JAX package's clipped gather
// does (callers pad x so that no window leaves it).
//
// The general (non-exact-rational) and cubic one-shot paths walk the
// input only quasi-periodically, so each tile of ``tile`` outputs has its
// own banded matrix m_t[t] [w_band, tile] and its own window start.  Per
// tile the work is the product X_t [S, w_band] @ m_t[t] with
// X_t[s, w] = x[s, starts[t] + w].
//
// Bound on this card: every matrix is used for one tile only, so the
// kernel reads n_tiles * w_band * tile floats of matrices against
// S * (n + n_tiles*tile) floats of signal.  At the one-shot's stream counts
// (tens of streams) the matrices dominate the bytes (162 MB of 209 MB for
// 64 streams x 2 s at 44.1k -> 48.001k HIGH), and the useful work, 2*S
// flops per non-zero (44% of M there), is under the float32 ridge of
// ~20 flops per byte: memory binds.
//
// Design, for that bound: a shared-memory tiled SGEMM per tile.  A block
// owns 64 streams, 128 columns of one tile's matrix, and runs over its
// taps 16 at a time, double buffered.  The grid's fastest axis is the
// stream block, so the blocks that share one matrix tile run side by side
// and every matrix tile comes from memory about once per launch, the rest
// from L2.  256 threads each hold a 4x8 tile of accumulators.  Each output
// is one fixed-order chain of fmaf over w = 0, 1, ...  Offsets are 64-bit.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;                  // 16 x 16
constexpr int kBM = 64;                        // streams per block
constexpr int kBN = 128;                       // tile columns per block
constexpr int kBK = 16;                        // taps per shared-memory stage
constexpr int kTM = 4;                         // streams per thread
constexpr int kTN = 8;                         // columns per thread, stride 16
constexpr int kAPitch = kBM + 4;               // transposed x tile row pitch
constexpr int kALoads = kBM * kBK / kThreads;  // 4
constexpr int kBLoads = kBK * kBN / kThreads;  // 8

static_assert(kBM == 16 * kTM && kBN == 16 * kTN, "thread tile");
static_assert(kBM * kBK % kThreads == 0 && kBK * kBN % kThreads == 0,
              "stage loads");

__global__ void __launch_bounds__(kThreads)
general_resample_kernel(const float* __restrict__ x, long long ld,
                        long long n, const void* __restrict__ starts,
                        int starts_are_64bit, const float* __restrict__ m_t,
                        int m_rows, float* __restrict__ y, long long ldy,
                        int n_streams, int n_stream_blocks, int w_band,
                        int tile)
{
    __shared__ __align__(16) float As[2][kBK][kAPitch];   // x: [tap][stream]
    __shared__ __align__(16) float Bs[2][kBK][kBN];       // m: [tap][column]

    const int tid = threadIdx.x;
    const int tx = tid % 16;                   // column group
    const int ty = tid / 16;                   // stream group
    const long long t = (long long)blockIdx.x / n_stream_blocks;
    const int s0 = (int)((long long)blockIdx.x - t * n_stream_blocks) * kBM;
    const int c0 = blockIdx.y * kBN;
    const long long start = starts_are_64bit
        ? __ldg(static_cast<const long long*>(starts) + t)
        : (long long)__ldg(static_cast<const int*>(starts) + t);
    const float* m = m_t + t * m_rows * (long long)tile;

    float a_buf[kALoads];
    float b_buf[kBLoads];
    auto load_stage = [&](int k0) {
#pragma unroll
        for (int i = 0; i < kALoads; ++i) {
            const int e = tid + kThreads * i;
            const int s = s0 + e / kBK;
            const int k = k0 + e % kBK;
            const long long idx = min(max(start + k, 0LL), n - 1);
            a_buf[i] = (s < n_streams && k < w_band)
                ? __ldg(x + (long long)s * ld + idx) : 0.0f;
        }
#pragma unroll
        for (int i = 0; i < kBLoads; ++i) {
            const int e = tid + kThreads * i;
            const int k = k0 + e / kBN;
            const int c = c0 + e % kBN;
            b_buf[i] = (k < w_band && c < tile)
                ? __ldg(m + (long long)k * tile + c) : 0.0f;
        }
    };
    auto store_stage = [&](int buf) {
#pragma unroll
        for (int i = 0; i < kALoads; ++i) {
            const int e = tid + kThreads * i;
            As[buf][e % kBK][e / kBK] = a_buf[i];
        }
#pragma unroll
        for (int i = 0; i < kBLoads; ++i) {
            const int e = tid + kThreads * i;
            Bs[buf][e / kBN][e % kBN] = b_buf[i];
        }
    };

    float acc[kTM][kTN];
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j)
            acc[i][j] = 0.0f;

    const int n_stages = (w_band + kBK - 1) / kBK;
    load_stage(0);
    store_stage(0);
    __syncthreads();
    for (int c = 0; c < n_stages; ++c) {
        const int buf = c & 1;
        const bool more = c + 1 < n_stages;
        if (more)
            load_stage((c + 1) * kBK);         // in flight during the FMAs
#pragma unroll
        for (int kk = 0; kk < kBK; ++kk) {
            const float4 v =
                *reinterpret_cast<const float4*>(&As[buf][kk][ty * kTM]);
            const float a[kTM] = {v.x, v.y, v.z, v.w};
            float b[kTN];
#pragma unroll
            for (int j = 0; j < kTN; ++j)
                b[j] = Bs[buf][kk][tx + 16 * j];
#pragma unroll
            for (int i = 0; i < kTM; ++i)
#pragma unroll
                for (int j = 0; j < kTN; ++j)
                    acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
        }
        if (more)
            store_stage(buf ^ 1);
        __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < kTM; ++i) {
        const int s = s0 + ty * kTM + i;
        if (s >= n_streams)
            continue;
        float* y_row = y + (long long)s * ldy + t * tile;
#pragma unroll
        for (int j = 0; j < kTN; ++j) {
            const int c = c0 + tx + 16 * j;
            if (c < tile)
                y_row[c] = acc[i][j];
        }
    }
}

}  // namespace

// y [S, n_tiles*tile] from x [S, n] (row stride ld), starts [n_tiles]
// (int32, or int64 when starts_are_64bit) and m_t [n_tiles, m_rows, tile]
// with m_rows >= w_band; all on the device, float32 but for starts.
// Launches on ``stream`` and returns the cudaError_t of the launch (0 on
// success).
extern "C" int general_resample_launch(const float* x, long long ld,
                                       long long n, const void* starts,
                                       int starts_are_64bit, const float* m_t,
                                       int m_rows, float* y,
                                       long long n_tiles, int n_streams,
                                       int w_band, int tile, void* stream)
{
    if (n_tiles <= 0 || n_streams <= 0 || n <= 0 || ld < n || w_band <= 0
            || m_rows < w_band || tile <= 0)
        return (int)cudaErrorInvalidValue;
    const long long n_sb = (n_streams + kBM - 1) / kBM;
    const long long gx = n_tiles * n_sb;
    const long long gy = (tile + kBN - 1) / kBN;
    if (gx > 2147483647LL || gy > 65535)
        return (int)cudaErrorInvalidValue;
    dim3 grid((unsigned)gx, (unsigned)gy);
    general_resample_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        x, ld, n, starts, starts_are_64bit, m_t, m_rows, y, n_tiles * tile,
        n_streams, (int)n_sb, w_band, tile);
    return (int)cudaGetLastError();
}
