// Fused banded resample, time-major (K2), for Hopper, sm_90a.
//
//   yT[m*P2 + r, s] = sum_{w < Wx} R[r, w] * xT[m*Ipx + w, s]
//
// Replaces the TPU kernel go_audio_resampler_tpu/ops/pallas_fused.py::
// fused_resample_tmajor (body _tmajor_kernel).  It computes the same
// function; it does not copy that kernel's structure.  The TPU kernel's
// 8-row aligned slab fetch with its sublane roll, its Wx padding to a
// multiple of 128, its stream-tile padding and its kf-frame grouping were
// constraints of the TPU's memory system and are gone: this kernel reads
// each frame's slab xT[m*Ipx : m*Ipx + Wx, :] in place and masks the ragged
// stream, row and tap edges itself.  Nothing is padded on the host.
//
// Stored time-major, frame m's window is a contiguous slab of Wx rows of
// S streams, and the frame's output is the product R [P2, Wx] @ slab
// [Wx, S], written to rows m*P2 .. m*P2 + P2 - 1 of yT.  A launch is a batch
// of such products, one per frame, all with the same R.
//
// Bound on this card: the same work as K1 (fused_resample.cu), 2*Wx*P2
// flops per frame and stream against ~8.4 bytes of memory traffic per
// input sample for 44.1k->48k HIGH, so float32 FMAs bind, not memory.
//
// Design, for that bound: a shared-memory tiled SGEMM per frame.  A block
// owns one frame, 160 rows of R (all outputs of a CD->DAT period) and 128
// streams; 256 threads each hold a 10x8 tile of accumulators in registers.
// Taps go through shared memory 16 at a time, double buffered, so the
// global loads of the next stage are in flight while the current one is
// multiplied.  The slab rows are read coalesced along the stream axis; the
// overlap between neighbouring frames' slabs (Wx > Ipx) is re-read through
// L2, where frames of one stream block run side by side (the frame is the
// fastest grid axis).  R stays resident in L2.  Each output is one
// fixed-order chain of fmaf over w = 0, 1, ..., the same chain K1 runs, so
// on the same data K2's output equals K1's bit for bit, and an output's bits
// do not depend on how the stream was cut into launches.  Offsets are
// 64-bit.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;                  // 16 x 16
constexpr int kBM = 160;                       // rows of R per block
constexpr int kBN = 128;                       // streams per block
constexpr int kBK = 16;                        // taps per shared-memory stage
constexpr int kTM = 10;                        // rows per thread
constexpr int kTN = 8;                         // streams per thread, stride 16
constexpr int kAPitch = kBM + 4;               // transposed R tile row pitch
constexpr int kALoads = kBM * kBK / kThreads;  // 10
constexpr int kBLoads = kBK * kBN / kThreads;  // 8

static_assert(kBM == 16 * kTM && kBN == 16 * kTN, "thread tile");
static_assert(kBM * kBK % kThreads == 0 && kBK * kBN % kThreads == 0,
              "stage loads");

__global__ void __launch_bounds__(kThreads)
fused_resample_tmajor_kernel(const float* __restrict__ xt, long long ld,
                             const float* __restrict__ r,
                             float* __restrict__ yt, int n_streams, int ipx,
                             int wx, int p2)
{
    __shared__ __align__(16) float As[2][kBK][kAPitch];   // R: [tap][row]
    __shared__ __align__(16) float Bs[2][kBK][kBN];       // x: [tap][stream]

    const int tid = threadIdx.x;
    const int tx = tid % 16;                   // stream group
    const int ty = tid / 16;                   // row group
    const long long frame = blockIdx.x;
    const int r0 = blockIdx.y * kBM;
    const int s0 = blockIdx.z * kBN;
    const float* slab = xt + frame * ipx * ld + s0;   // row 0 of the window

    float a_buf[kALoads];
    float b_buf[kBLoads];
    auto load_stage = [&](int k0) {
#pragma unroll
        for (int i = 0; i < kALoads; ++i) {
            const int e = tid + kThreads * i;
            const int row = r0 + e / kBK;
            const int k = k0 + e % kBK;
            a_buf[i] = (row < p2 && k < wx)
                ? __ldg(r + (long long)row * wx + k) : 0.0f;
        }
#pragma unroll
        for (int i = 0; i < kBLoads; ++i) {
            const int e = tid + kThreads * i;
            const int k = k0 + e / kBN;
            const int s = e % kBN;
            b_buf[i] = (k < wx && s0 + s < n_streams)
                ? __ldg(slab + (long long)k * ld + s) : 0.0f;
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
            float a[kTM];
#pragma unroll
            for (int i = 0; i < kTM / 2; ++i) {
                const float2 v = *reinterpret_cast<const float2*>(
                    &As[buf][kk][ty * kTM + 2 * i]);
                a[2 * i] = v.x;
                a[2 * i + 1] = v.y;
            }
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
        const int row = r0 + ty * kTM + i;
        if (row >= p2)
            continue;
        float* y_row = yt + (frame * p2 + row) * (long long)n_streams;
#pragma unroll
        for (int j = 0; j < kTN; ++j) {
            const int s = s0 + tx + 16 * j;
            if (s < n_streams)
                y_row[s] = acc[i][j];
        }
    }
}

}  // namespace

// yT [n_frames*P2, S] (row-major) from xT [>= (n_frames-1)*ipx + wx, S]
// with row stride ld, and r [p2, wx]; all float32 on the device.  Launches
// on ``stream`` and returns the cudaError_t of the launch (0 on success).
extern "C" int fused_resample_tmajor_launch(const float* xt, long long ld,
                                            const float* r, float* yt,
                                            long long n_frames, int n_streams,
                                            int ipx, int wx, int p2,
                                            void* stream)
{
    if (n_frames <= 0 || n_streams <= 0 || ld < n_streams || ipx <= 0
            || wx <= 0 || p2 <= 0)
        return (int)cudaErrorInvalidValue;
    const long long gy = (p2 + kBM - 1) / kBM;
    const long long gz = (n_streams + kBN - 1) / kBN;
    if (n_frames > 2147483647LL || gy > 65535 || gz > 65535)
        return (int)cudaErrorInvalidValue;
    dim3 grid((unsigned)n_frames, (unsigned)gy, (unsigned)gz);
    fused_resample_tmajor_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        xt, ld, r, yt, n_streams, ipx, wx, p2);
    return (int)cudaGetLastError();
}
