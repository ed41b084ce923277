// Fused banded resample (K1) for Hopper, sm_90a.
//
//   y[s, m*P2 + r] = sum_{w < Wx} v[s, m*Ipx + w] * R_t[w, r]
//
// Replaces the TPU kernel go_audio_resampler_tpu/ops/pallas_fused.py::
// fused_resample_pallas.  It computes the same function; it does not copy
// that kernel's structure.  The TPU kernel's 128-lane alignment roll, its
// Wx padding to a multiple of 128 and its stream-tile padding of x were
// constraints of the TPU and are gone: this kernel reads its rows in place,
// masks the ragged stream, frame, tap and column edges itself and needs no
// pad on the host.
//
// What it reads.  Row s is a virtual row
//
//   v[s] = head[s, :C]  ++  data[s, :n]  ++  zeros
//
// read where its pieces lie: a streaming step's carry (the head) and its
// block (the data), or a one-shot input (the data) with the zeros of its
// flush tail, or of a left context given as a head of zeros (no head
// tensor), which no one writes to memory.  With no head and data as wide
// as the frames need (C = 0, n >= (n_frames-1)*Ipx + Wx), v is the data.
//
// Seen as a matrix product, the frames form an implicit matrix
// A[M = S*n_frames, Wx] with A[s*n_frames + f, w] = v[s, f*Ipx + w]: row m
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
// operations.  Reading a head and a zero tail in place changes neither
// count: every tap of v is read once, from wherever it lies.
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
// in 16-byte chunks from the 16-byte boundary below the window's tap in
// the data (the skew, from the row's absolute address, so that data at
// any 4-byte offset keeps 16-byte copies), the fragments reading past the
// skew.  Only the first ceil(C/Ipx) frames of a stream reach into the
// head: a chunk wholly inside it goes in one 16-byte copy where the head
// lies at the data's skew (the streaming step lays its carry out so),
// else (and across the head's end) 4 bytes at a time; a head of zeros is
// a zero fill.  Taps past the data are zero-filled by the copy's source
// size, as taps past Wx are.  A row's offset and bounds are one 16-byte
// load a chunk; offsets are 64-bit.  A call with no head and data as
// wide as the frames runs the same loop.
// Measured on an H100 (PERF.md): 0.034 ms at the main shape and 0.029 ms
// at the decimation shape, bound by the block's loads from L2 and the work
// around them, not by the tensor cores.

#include "banded_mma.cuh"

namespace {

using namespace banded;

// A row, read in one 16-byte load a chunk: the data offset of its window's
// tap 0, and the taps that read the head (below `head`) and zeros (from
// `end`).
struct __align__(16) Row {
    long long off;
    int head, end;
};

template <int WG, int T>
__global__ void __launch_bounds__(Tile<WG>::kThreads,
                                  Tile<WG>::kBlocksPerSM)
fused_resample_kernel(const float* __restrict__ data, long long ld,
                      const float* __restrict__ head, long long ldh,
                      int n_head, long long body_end,
                      const float4* __restrict__ packed,
                      const int2* __restrict__ bands, float* __restrict__ y,
                      long long n_rows, int n_frames, int ipx, int wx,
                      int p2, int split)
{
    constexpr int kBM = Tile<WG>::kBM, kThreads = Tile<WG>::kThreads;
    extern __shared__ __align__(16) float smem[];
    __shared__ int row_skew[kBM];              // tap 0's offset in a chunk
    __shared__ Row row_at[kBM];
    __shared__ long long row_hoff[kBM];        // head offset of tap 0
    // The data's address in floats, mod 4: a row's skew is this plus its
    // offset, mod 4.
    const int base4 = (int)(((uintptr_t)data >> 2) & 3);

    const int tid = threadIdx.x;
    const long long m0 = (long long)(blockIdx.x / split) * kBM;
    const int rank = blockIdx.x % split;
    if (tid < kBM) {
        const long long m = m0 + tid;
        // Tap w of the window is v[s, f*ipx + w]: the head's below C, the
        // data's below C + n.  A chunk starts at most 3 taps before tap 0,
        // so an end of -4 (rows past M, or whose window starts 4 or more
        // taps past the data) reads nothing.
        long long off = 0, hoff = 0;
        int in_head = -3, end = -4;
        if (m < n_rows) {
            const long long s = m / n_frames;
            const long long at = (m - s * n_frames) * ipx;
            off = s * ld + at - n_head;
            hoff = s * ldh + at;
            in_head = (int)max(-3LL, min(n_head - at, (long long)wx));
            end = (int)max(-4LL, min(body_end - at, (long long)wx));
        }
        row_skew[tid] = (base4 + (int)off) & 3;
        row_at[tid] = Row{off, in_head, end};
        row_hoff[tid] = hoff;
    }
    __syncthreads();
    RowMajorA afrag;
    afrag.skew[0] = row_skew[frag_row()];
    afrag.skew[1] = row_skew[frag_row() + 8];

    // Taps [k0, k0 + n_taps) of every row in kAChunks chunks of 16 bytes
    // that start row_skew floats before tap k0; taps at or past wx, past
    // the data, and rows past M, are zero.
    auto load_a = [&](float* as, int k0, int n_taps) {
        const int stop = k0 + n_taps;
        for (int i = tid; i < kBM * kAChunks; i += kThreads) {
            const int r = i / kAChunks, c = i % kAChunks;
            float* dst = as + r * kAPitchRow + 4 * c;
            const Row row = row_at[r];
            const int t = k0 - ((base4 + (int)row.off) & 3) + 4 * c;
            const int lim = min(row.end, stop);    // t: the chunk's first tap
            const int n = min(lim - t, 4);         // taps to copy
            if (t >= row.head) {
                // In the data (16-byte aligned there), or past it.
                cp_async16(dst, n > 0 ? (const void*)(data + row.off + t)
                                      : (const void*)packed,
                           n > 0 ? 4 * n : 0);
                continue;
            }
            // Reaches into the head.  Wholly inside it: zeros for a head of
            // zeros, else one 16-byte copy where the head lies at the
            // data's skew (the streaming step lays its carry out so).
            const float* src = head != nullptr && t >= 0
                ? head + row_hoff[r] + t : nullptr;
            if (t >= 0 && t + 4 <= row.head
                    && (src == nullptr || n <= 0
                        || ((uintptr_t)src & 15) == 0)) {
                const bool any = src != nullptr && n > 0;
                cp_async16(dst, any ? (const void*)src : (const void*)packed,
                           any ? 4 * n : 0);
                continue;
            }
            // Across the head's end, before the window, or a head off the
            // data's skew: tap by tap.  Taps below 0 are not read.
            for (int j = 0; j < 4; ++j) {
                const int q = t + j;
                const bool from_head = q < row.head;
                const bool ok = q >= 0 && q < lim
                    && (!from_head || head != nullptr);
                const float* from = data;
                if (ok)
                    from = from_head ? head + row_hoff[r] + q
                                     : data + row.off + q;
                cp_async4(dst + j, from, ok ? 4 : 0);
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

// y [S*n_frames, P2] (row-major, i.e. [S, n_frames*P2]) from the virtual
// rows head[s, :n_head] ++ data[s, :n_data] ++ zeros, with row strides
// ldh and ld (head may be null: n_head zeros), and R prepared by
// ops/banded.py at ``tier`` (Tier: 0 highest, 1 high, 2 default; packed
// limbs, int32 band table [ceil(p2/8), 2], split); all on the device.
// n_rows = S*n_frames.  Launches on ``stream`` and returns the
// cudaError_t of the launch (0 on success).
extern "C" int fused_resample_launch(const float* data, long long ld,
                                     const float* head, long long ldh,
                                     int n_head, long long n_data,
                                     const void* packed, const int* bands,
                                     float* y, long long n_rows,
                                     int n_frames, int ipx, int wx, int p2,
                                     int split, int tier, void* stream)
{
    if (n_rows <= 0 || n_frames <= 0 || ipx <= 0 || wx <= 0 || p2 <= 0
            || ld < 0 || ldh < 0 || n_head < 0 || n_data < 0)
        return (int)cudaErrorInvalidValue;
    const float4* b = (const float4*)packed;
    const int2* bt = (const int2*)bands;
    const long long body_end = n_head + n_data;
    switch (tier) {
    case kHighest:
        return launch_tier<kHighest>(n_rows, p2, split, stream,
                                     data, ld, head, ldh, n_head, body_end,
                                     b, bt, y, n_rows, n_frames, ipx, wx, p2,
                                     split);
    case kHigh:
        return launch_tier<kHigh>(n_rows, p2, split, stream, data,
                                  ld, head, ldh, n_head, body_end, b, bt, y,
                                  n_rows, n_frames, ipx, wx, p2, split);
    case kDefault:
        return launch_tier<kDefault>(n_rows, p2, split, stream,
                                     data, ld, head, ldh, n_head, body_end,
                                     b, bt, y, n_rows, n_frames, ipx, wx, p2,
                                     split);
    default:
        return (int)cudaErrorInvalidValue;
    }
}
