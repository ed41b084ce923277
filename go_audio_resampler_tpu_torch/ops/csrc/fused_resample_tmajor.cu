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
// Stored time-major, frame m's window is a contiguous slab of Wx rows of S
// streams.  Read with the streams as rows, the slab is K1's signal operand
// for the frame (A[s, w] = xT[m*Ipx + w, s]), so this kernel runs K1's
// tile product (banded_mma.cuh) on it and stores the tile transposed.
//
// Bounds on this card: the same work as K1 (fused_resample.cu).  At
// 44.1k->48k HIGH, 1024 streams x 16 frames: 0.0154 ms as float32 FMAs,
// 0.0063 ms as three TF32 tensor-core passes, bound by its 21.1 MB; at
// 48k->16k HIGH, 256 streams x 2 frames: 0.0106 ms and 0.0043 ms, bound by
// the operations.
//
// Design, for those bounds: K1's tile product at the same tier (3xTF32,
// or bf16 passes at 'high' and 'default'), the same wgmma over
// the band of R's non-zero taps of 80 output columns, with the same block
// shapes, the same cluster split of long bands and the same four-stage
// cp.async ring.  A block owns 256 or 128 streams of one frame.  The slab
// is staged tap by tap, each tap's streams in 16-byte copies where the
// rows are aligned, into a tap-major tile whose fragment reads are free of
// bank conflicts; the output tile goes through shared memory and leaves
// in runs of consecutive streams.  Every output is computed from the same
// values, in the same k-steps and order, as K1's, so on the same data K2
// equals K1 bit for bit, and an output's bits do not depend on the
// launch.  Offsets are 64-bit.  Measured on an H100 (PERF.md): 0.033 ms
// at the main shape and 0.028 ms at the decimation shape, bound by the
// block's loads and the work around them, not by the tensor cores.

#include "banded_mma.cuh"

namespace {

using namespace banded;

template <int WG, int T>
__global__ void __launch_bounds__(Tile<WG>::kThreads,
                                  Tile<WG>::kBlocksPerSM)
fused_resample_tmajor_kernel(const float* __restrict__ xt, long long ld,
                             const float4* __restrict__ packed,
                             const int2* __restrict__ bands,
                             float* __restrict__ yt, int n_streams, int ipx,
                             int wx, int p2, int split, int vec)
{
    constexpr int kBM = Tile<WG>::kBM, kThreads = Tile<WG>::kThreads;
    constexpr int kAPitchTap = Tile<WG>::kAPitchTap;
    extern __shared__ __align__(16) float smem[];

    const int tid = threadIdx.x;
    const long long tile_m = blockIdx.x / split;
    const int rank = blockIdx.x % split;
    const long long n_sb = (n_streams + kBM - 1) / kBM;
    const long long frame = tile_m / n_sb;
    const int s0 = (int)(tile_m - frame * n_sb) * kBM;
    const float* slab = xt + frame * ipx * ld + s0;   // tap 0 of the window

    // Taps [k0, k0 + n_taps) of the block's streams, one tap's streams
    // after another; taps at or past wx, and streams past S, are zero.
    auto load_a = [&](float* as, int k0, int n_taps) {
        const int n_valid = min(n_taps, wx - k0);
        if (vec) {
            for (int i = tid; i < kBK * kBM / 4; i += kThreads) {
                const int c = i / (kBM / 4), r = (i % (kBM / 4)) * 4;
                const int n = c < n_valid ? min(n_streams - s0 - r, 4) : 0;
                cp_async16(as + c * kAPitchTap + r,
                           n > 0 ? slab + (long long)(k0 + c) * ld + r : xt,
                           n > 0 ? 4 * n : 0);
            }
        } else {
            for (int i = tid; i < kBK * kBM; i += kThreads) {
                const int c = i / kBM, r = i % kBM;
                const bool ok = c < n_valid && s0 + r < n_streams;
                cp_async4(as + c * kAPitchTap + r,
                          ok ? slab + (long long)(k0 + c) * ld + r : xt,
                          ok ? 4 : 0);
            }
        }
    };

    Acc acc;
    tile_product<WG, T>(TapMajorA<WG>{}, load_a, packed, bands,
                        (wx + 7) / 8, (p2 + 7) / 8, blockIdx.y, rank, split,
                        smem, acc);

    const int n0 = blockIdx.y * kBN;
    epilogue<WG>(smem, acc, split, false, [&](int r, int c, float v) {
        if (s0 + r < n_streams && n0 + c < p2)
            yt[(frame * p2 + n0 + c) * n_streams + s0 + r] = v;
    });
}

// Devices that allowed each variant's ring memory ([tier][short, tall]).
bool k2_smem_allowed[3][2][64];

template <int WG, int T, class... Args>
int launch_k2(long long n_frames, int n_streams, int p2, int split,
              void* stream, Args... args)
{
    constexpr int kBM = Tile<WG>::kBM;
    return (int)launch<WG>(fused_resample_tmajor_kernel<WG, T>,
                           k2_smem_allowed[T][WG == kTallWarpgroups],
                           n_frames * ((n_streams + kBM - 1) / kBM), p2,
                           split, stream, args...);
}

// The block shape from the operator's split, as K1 chooses it.
template <int T, class... Args>
int launch_tier(long long n_frames, int n_streams, int p2, int split,
                void* stream, Args... args)
{
    if (split == 1)
        return launch_k2<kTallWarpgroups, T>(n_frames, n_streams, p2, split,
                                             stream, args...);
    return launch_k2<kShortWarpgroups, T>(n_frames, n_streams, p2, split,
                                          stream, args...);
}

}  // namespace

// yT [n_frames*P2, S] (row-major) from xT [>= (n_frames-1)*ipx + wx, S]
// with row stride ld, and R prepared by ops/banded.py at ``tier`` (0
// highest, 1 high, 2 default; packed limbs, int32 band table [ceil(p2/8),
// 2], split); all on the device.  Launches on ``stream`` and returns the
// cudaError_t of the launch (0 on success).
extern "C" int fused_resample_tmajor_launch(const float* xt, long long ld,
                                            const void* packed,
                                            const int* bands, float* yt,
                                            long long n_frames,
                                            int n_streams, int ipx, int wx,
                                            int p2, int split, int tier,
                                            void* stream)
{
    if (n_frames <= 0 || n_streams <= 0 || ld < n_streams || ipx <= 0
            || wx <= 0 || p2 <= 0)
        return (int)cudaErrorInvalidValue;
    const int vec = ((uintptr_t)xt % 16 == 0 && ld % 4 == 0) ? 1 : 0;
    const float4* b = (const float4*)packed;
    const int2* bt = (const int2*)bands;
    switch (tier) {
    case kHighest:
        return launch_tier<kHighest>(n_frames, n_streams, p2, split, stream,
                                     xt, ld, b, bt, yt, n_streams, ipx, wx,
                                     p2, split, vec);
    case kHigh:
        return launch_tier<kHigh>(n_frames, n_streams, p2, split, stream, xt,
                                  ld, b, bt, yt, n_streams, ipx, wx, p2,
                                  split, vec);
    case kDefault:
        return launch_tier<kDefault>(n_frames, n_streams, p2, split, stream,
                                     xt, ld, b, bt, yt, n_streams, ipx, wx,
                                     p2, split, vec);
    default:
        return (int)cudaErrorInvalidValue;
    }
}
