// Fused banded resample (K1) for Hopper, sm_90a.
//
//   y[s, m*P2 + r] = sum_{w < Wx} x[s, m*Ipx + w] * R_t[w, r]
//
// Replaces the TPU kernel go_audio_resampler_tpu/ops/pallas_fused.py::
// fused_resample_pallas.  It computes the same function; it does not copy
// that kernel's structure.  The TPU kernel's 128-lane alignment roll, its
// Wx padding to a multiple of 128 and its stream-tile padding of x were
// constraints of the TPU and are gone: this kernel reads x in place, masks
// the ragged stream, frame, tap and column edges itself and needs no pad on
// the host.
//
// Seen as a matrix product, the frames form an implicit matrix
// A[M = S*n_frames, Wx] with A[s*n_frames + f, w] = x[s, f*Ipx + w]: row m
// is a window that starts f*Ipx samples into stream s.  y, read as
// [M, P2] row-major, is A @ R_t.  No frame is ever written to memory.
//
// Bound on this card.  Per frame the product costs 2*Wx*P2 flops
// (109,760 for 44.1k->48k HIGH, Wx = 343, P2 = 160) against about 8.4 bytes
// of memory traffic per input sample (4 read, 4*P2/Ipx written), i.e.
// ~89 flops per byte.  The H100 does ~20 float32 flops per byte of HBM
// bandwidth outside the tensor cores, so the kernel is bound by float32
// FMAs, not by memory.  R_t is banded (about 57% of its entries are
// non-zero for that plan); this kernel does the dense product.
//
// Design, for that bound: a plain shared-memory tiled SGEMM over the
// implicit A.  A block owns 128 consecutive rows of A (several streams'
// frames, or a run of frames of one stream) and 160 columns; 256 threads
// each hold an 8x10 tile of accumulators in registers, so every float
// read from shared memory feeds several FMAs.  Taps go through shared
// memory 16 at a time, double buffered: the global loads of the next
// stage are in flight while the current one is multiplied.  The windows
// overlap (Wx > Ipx), so A's rows re-read the same samples; those re-reads
// hit L1/L2, and R_t (220 KB) stays resident in L2.  Shared memory per
// block is fixed (37 KB) whatever Ipx and Wx are, so superframed periods
// take the same path.  Each output is one fixed-order chain of fmaf over
// w = 0, 1, ..., so an output's bits do not depend on how the stream was
// cut into launches.  Offsets are 64-bit.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;                  // 16 x 16
constexpr int kBM = 128;                       // rows of A per block
constexpr int kBN = 160;                       // output columns per block
constexpr int kBK = 16;                        // taps per shared-memory stage
constexpr int kTM = 8;                         // rows per thread
constexpr int kTN = 10;                        // columns per thread (5 pairs)
constexpr int kAPitch = kBM + 4;               // transposed A tile row pitch
constexpr int kALoads = kBM * kBK / kThreads;  // 8
constexpr int kBLoads = kBK * kBN / kThreads;  // 10

static_assert(kBM == 16 * kTM && kBN == 16 * kTN, "thread tile");
static_assert(kThreads % kBK == 0 && kThreads / kBK * kALoads == kBM, "A loads");

__global__ void __launch_bounds__(kThreads)
fused_resample_kernel(const float* __restrict__ data, long long ld,
                      const float* __restrict__ r_t, float* __restrict__ y,
                      long long n_rows, int n_frames, int ipx, int wx, int p2)
{
    __shared__ __align__(16) float As[2][kBK][kAPitch];   // [tap][row]
    __shared__ __align__(16) float Bs[2][kBK][kBN];       // [tap][column]

    const int tid = threadIdx.x;
    const int tx = tid % 16;                   // column group
    const int ty = tid / 16;                   // row group
    const long long m0 = (long long)blockIdx.x * kBM;
    const int n0 = blockIdx.y * kBN;

    // A loader: this thread loads tap a_k of rows a_r + 16*i.
    const int a_k = tid % kBK;
    const int a_r = tid / kBK;
    const float* a_row[kALoads];
    bool a_ok[kALoads];
#pragma unroll
    for (int i = 0; i < kALoads; ++i) {
        const long long m = m0 + a_r + 16 * i;
        a_ok[i] = m < n_rows;
        const long long s = a_ok[i] ? m / n_frames : 0;
        const long long f = a_ok[i] ? m - s * n_frames : 0;
        a_row[i] = data + s * ld + f * ipx;
    }

    float a_buf[kALoads];
    float b_buf[kBLoads];
    auto load_stage = [&](int k0) {
        const int k = k0 + a_k;
#pragma unroll
        for (int i = 0; i < kALoads; ++i)
            a_buf[i] = (a_ok[i] && k < wx) ? __ldg(a_row[i] + k) : 0.0f;
#pragma unroll
        for (int i = 0; i < kBLoads; ++i) {
            const int e = tid + kThreads * i;
            const int kg = k0 + e / kBN;
            const int ng = n0 + e % kBN;
            b_buf[i] = (kg < wx && ng < p2)
                ? __ldg(r_t + (long long)kg * p2 + ng) : 0.0f;
        }
    };
    auto store_stage = [&](int buf) {
#pragma unroll
        for (int i = 0; i < kALoads; ++i)
            As[buf][a_k][a_r + 16 * i] = a_buf[i];
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

    const int n_stages = (wx + kBK - 1) / kBK;
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
            const float4 a_lo =
                *reinterpret_cast<const float4*>(&As[buf][kk][ty * kTM]);
            const float4 a_hi =
                *reinterpret_cast<const float4*>(&As[buf][kk][ty * kTM + 4]);
            const float a[kTM] = {a_lo.x, a_lo.y, a_lo.z, a_lo.w,
                                  a_hi.x, a_hi.y, a_hi.z, a_hi.w};
            float2 b[kTN / 2];
#pragma unroll
            for (int j = 0; j < kTN / 2; ++j)
                b[j] = *reinterpret_cast<const float2*>(
                    &Bs[buf][kk][32 * j + 2 * tx]);
#pragma unroll
            for (int i = 0; i < kTM; ++i)
#pragma unroll
                for (int j = 0; j < kTN / 2; ++j) {
                    acc[i][2 * j] = fmaf(a[i], b[j].x, acc[i][2 * j]);
                    acc[i][2 * j + 1] = fmaf(a[i], b[j].y, acc[i][2 * j + 1]);
                }
        }
        if (more)
            store_stage(buf ^ 1);
        __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < kTM; ++i) {
        const long long m = m0 + ty * kTM + i;
        if (m >= n_rows)
            continue;
        float* y_row = y + m * p2;
#pragma unroll
        for (int j = 0; j < kTN / 2; ++j) {
            const int n = n0 + 32 * j + 2 * tx;
            if (n < p2)
                y_row[n] = acc[i][2 * j];
            if (n + 1 < p2)
                y_row[n + 1] = acc[i][2 * j + 1];
        }
    }
}

}  // namespace

// y [S*n_frames, P2] (row-major, i.e. [S, n_frames*P2]) from data
// [S, >= (n_frames-1)*ipx + wx] with row stride ld, and r_t [wx, p2]; all
// float32 on the device.  n_rows = S*n_frames.  Launches on ``stream`` and
// returns the cudaError_t of the launch (0 on success).
extern "C" int fused_resample_launch(const float* data, long long ld,
                                     const float* r_t, float* y,
                                     long long n_rows, int n_frames, int ipx,
                                     int wx, int p2, void* stream)
{
    if (n_rows <= 0 || n_frames <= 0 || ipx <= 0 || wx <= 0 || p2 <= 0)
        return (int)cudaErrorInvalidValue;
    const long long gx = (n_rows + kBM - 1) / kBM;
    const long long gy = (p2 + kBN - 1) / kBN;
    if (gx > 2147483647LL || gy > 65535)
        return (int)cudaErrorInvalidValue;
    dim3 grid((unsigned)gx, (unsigned)gy);
    fused_resample_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        data, ld, r_t, y, n_rows, n_frames, ipx, wx, p2);
    return (int)cudaGetLastError();
}
