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
// Bounds on this card (H100 SXM: 67 TFLOP/s float32 FMA, 495 TFLOP/s
// TF32 tensor cores, 3.35 TB/s).  Counting the non-zeros of R, 44.1k->48k
// HIGH (R_t [343, 160] over Ipx 147, 1024 streams x 16 frames) is 1.03
// GFLOP and 21.1 MB: 0.0154 ms as float32 FMAs, 0.0063 ms as three TF32
// tensor-core passes, where the bytes bind.  48k->16k HIGH (R_t
// [2882, 512] over 1536, 256 streams x 2 frames) is 0.707 GFLOP and 11.5
// MB: 0.0106 ms as FMAs, 0.0043 ms as three TF32 passes, bound by the
// operations.
//
// At the bf16 tiers (ops/precision.py) the same operations are three bf16
// passes ('high') or one ('default') at 989 TFLOP/s, and R's limbs are 2
// bytes each: at both shapes the bytes then bind (chip_smoke.py prints
// each bound).
//
// Design, for those bounds (banded_mma.cuh holds the shared part):
// three TF32 passes on the tensor cores (wgmma, float32 accumulation)
// instead of float32 FMAs, at float32 accuracy, or the tier's bf16
// passes, one k16 wgmma a stage; each block walks only the
// band of R's non-zero taps of its 80 output columns (R is 57% non-zero at
// 44.1k->48k and 47% at 48k->16k), each 8-column block of B zero outside
// its own band; a four-stage cp.async ring of 2 k-steps.  Block shape from
// the operator: 256 rows where one block walks a band (the main shape:
// 128 blocks, one an SM), 128 rows with the long bands split across
// clusters of 8 (the decimation shape: 224 blocks, two an SM).  The rows
// of a block are windows of frames of one or more streams, each staged
// from x in place: in 16-byte chunks from the 16-byte boundary below the
// window's tap (x aligned), the fragments reading past the skew; else 4
// bytes at a time.  Offsets are 64-bit.  Measured on an H100 (PERF.md):
// 0.036 ms at the main shape and 0.030 ms at the decimation shape, bound
// by the block's loads from L2 and the work around them, not by the
// tensor cores.

#include "banded_mma.cuh"

namespace {

using namespace banded;

template <int WG, int T>
__global__ void __launch_bounds__(Tile<WG>::kThreads,
                                  Tile<WG>::kBlocksPerSM)
fused_resample_kernel(const float* __restrict__ data, long long ld,
                      const float4* __restrict__ packed,
                      const int2* __restrict__ bands, float* __restrict__ y,
                      long long n_rows, int n_frames, int ipx, int wx,
                      int p2, int split, int vec)
{
    constexpr int kBM = Tile<WG>::kBM, kThreads = Tile<WG>::kThreads;
    extern __shared__ __align__(16) float smem[];
    __shared__ long long row_off[kBM];         // window start, -1 past M
    __shared__ int row_skew[kBM];              // its offset in a chunk

    const int tid = threadIdx.x;
    const long long m0 = (long long)(blockIdx.x / split) * kBM;
    const int rank = blockIdx.x % split;
    if (tid < kBM) {
        const long long m = m0 + tid;
        long long off = -1;
        if (m < n_rows) {
            const long long s = m / n_frames;
            off = s * ld + (m - s * n_frames) * ipx;
        }
        row_off[tid] = off;
        row_skew[tid] = vec && off >= 0 ? (int)(off & 3) : 0;
    }
    __syncthreads();
    RowMajorA afrag;
    afrag.skew[0] = row_skew[frag_row()];
    afrag.skew[1] = row_skew[frag_row() + 8];

    // Taps [k0, k0 + n_taps) of every row; taps at or past wx, and rows
    // past M, are zero.  With vec (x 16-byte aligned) a row goes in
    // kAChunks aligned chunks that start row_skew floats before tap k0.
    auto load_a = [&](float* as, int k0, int n_taps) {
        const int n_valid = min(n_taps, wx - k0);
        if (vec) {
            for (int i = tid; i < kBM * kAChunks; i += kThreads) {
                const int r = i / kAChunks, c = i % kAChunks;
                const long long off = row_off[r];
                const int skew = row_skew[r];
                const int n = off >= 0 ? min(skew + n_valid - 4 * c, 4) : 0;
                cp_async16(as + r * kAPitchRow + 4 * c,
                           n > 0 ? data + off + k0 - skew + 4 * c : data,
                           n > 0 ? 4 * n : 0);
            }
        } else {
            for (int i = tid; i < kBM * kBK; i += kThreads) {
                const int r = i / kBK, c = i % kBK;
                const long long off = row_off[r];
                const bool ok = off >= 0 && c < n_valid;
                cp_async4(as + r * kAPitchRow + c,
                          ok ? data + off + k0 + c : data, ok ? 4 : 0);
            }
        }
    };

    Acc acc;
    tile_product<WG, T>(afrag, load_a, packed, bands, (wx + 7) / 8,
                        (p2 + 7) / 8, blockIdx.y, rank, split, smem, acc);

    const int n0 = blockIdx.y * kBN;
    epilogue<WG>(smem, acc, split, true, [&](int r, int c, float v) {
        const long long m = m0 + r;
        if (m < n_rows && n0 + c < p2)
            y[m * p2 + n0 + c] = v;
    });
}

// Devices that allowed each variant's ring memory ([tier][short, tall]).
bool k1_smem_allowed[3][2][64];

template <int WG, int T, class... Args>
int launch_k1(long long n_rows, int p2, int split, void* stream,
              Args... args)
{
    constexpr int kBM = Tile<WG>::kBM;
    return (int)launch<WG>(fused_resample_kernel<WG, T>,
                           k1_smem_allowed[T][WG == kTallWarpgroups],
                           (n_rows + kBM - 1) / kBM, p2, split, stream,
                           args...);
}

// The block shape from the operator's split: tall where one block walks
// a band, short in clusters.
template <int T, class... Args>
int launch_tier(long long n_rows, int p2, int split, void* stream,
                Args... args)
{
    if (split == 1)
        return launch_k1<kTallWarpgroups, T>(n_rows, p2, split, stream,
                                             args...);
    return launch_k1<kShortWarpgroups, T>(n_rows, p2, split, stream,
                                          args...);
}

}  // namespace

// y [S*n_frames, P2] (row-major, i.e. [S, n_frames*P2]) from data
// [S, >= (n_frames-1)*ipx + wx] with row stride ld, and R prepared by
// ops/banded.py at ``tier`` (Tier: 0 highest, 1 high, 2 default; packed
// limbs, int32 band table [ceil(p2/8), 2], split); all on the device.
// n_rows = S*n_frames.  Launches on ``stream`` and returns the
// cudaError_t of the launch (0 on success).
extern "C" int fused_resample_launch(const float* data, long long ld,
                                     const void* packed, const int* bands,
                                     float* y, long long n_rows,
                                     int n_frames, int ipx, int wx, int p2,
                                     int split, int tier, void* stream)
{
    if (n_rows <= 0 || n_frames <= 0 || ipx <= 0 || wx <= 0 || p2 <= 0
            || ld <= 0)
        return (int)cudaErrorInvalidValue;
    const int vec = (uintptr_t)data % 16 == 0 ? 1 : 0;
    const float4* b = (const float4*)packed;
    const int2* bt = (const int2*)bands;
    switch (tier) {
    case kHighest:
        return launch_tier<kHighest>(n_rows, p2, split, stream, data, ld, b,
                                     bt, y, n_rows, n_frames, ipx, wx, p2,
                                     split, vec);
    case kHigh:
        return launch_tier<kHigh>(n_rows, p2, split, stream, data, ld, b, bt,
                                  y, n_rows, n_frames, ipx, wx, p2, split,
                                  vec);
    case kDefault:
        return launch_tier<kDefault>(n_rows, p2, split, stream, data, ld, b,
                                     bt, y, n_rows, n_frames, ipx, wx, p2,
                                     split, vec);
    default:
        return (int)cudaErrorInvalidValue;
    }
}
