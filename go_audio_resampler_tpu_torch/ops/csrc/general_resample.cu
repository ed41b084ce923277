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
// input only quasi-periodically, so each tile of `tile` outputs has its
// own banded matrix m_t[t] [w_band, tile] and its own window start.
//
// Bound on this card (H100 SXM: 3.35 TB/s, 495 TFLOP/s TF32): every
// matrix is used for one tile only, so M is the dominant stream of bytes
// at the one-shot's tens of streams; at 64 streams one float32 FMA pass
// over M is 32 flops per byte of M, above the float32 ridge (~20), but
// three TF32 tensor-core passes are below the tensor cores' (~148).  On
// the tensor cores the kernel is bound by its bytes, and M's bytes are
// its non-zeros: 44% of the dense matrix at 44.1k -> 48.001k HIGH, 1.7%
// at the cubic (QUICK) walk.
//
// Design, for that bound:
// - M is read once, as float32, and only within its band: for each tile
//   and block of 8 output columns, the k-steps (8 taps each) that hold the
//   block's non-zeros (ops/general.py::band_table, built once with M).  A
//   block stages its part of M with 16-byte cp.async rows along p, only
//   the chunks inside each 8-column block's band, in a ring of kStages
//   stages; the A fragments outside a band are zero in registers.  No TF32
//   limbs of M are stored in device memory: each thread splits its
//   fragments on chip (banded::split_tf32).
// - Operands as wgmma takes them: the tile's matrix is the register
//   operand A (the m64 rows are 64 columns p, one warpgroup's), the window
//   of x is B in shared memory, [k = w, n = 64 streams]: each stream's taps
//   are contiguous in x, so B is K-major, as tf32 wgmma requires, without
//   a transpose.  The window goes in one bulk copy a stream from the
//   16-byte boundary below the stage's first tap (4-byte copies, clamped
//   to [0, n), at the edges or for unaligned rows); one pass over shared
//   memory a stage, shared by the block's warpgroups and done one stage
//   ahead, removes the skew and writes B's hi and lo limbs in the 8 x 4
//   core-matrix layout of banded::b_desc.  One mbarrier a ring slot counts
//   both kinds of copy.
// - Each warpgroup issues wgmma.m64n64k8 only over the k-steps of its own
//   64 columns' band (59% of dense at the general shape, 28% at the cubic).
//   A block is one or two warpgroups, chosen from M on the host
//   (ops/general.py::block_warpgroups): two share each stage of the window
//   where neighbouring columns' bands overlap (the general walk: 2 blocks
//   an SM, 4 k-steps a stage); one where narrow bands drift apart along
//   the tile (the cubic walk: a 128-column block would idle each
//   warpgroup over half its stages; 4 blocks an SM, 2 k-steps a stage).
// - Arithmetic as K1's (banded_mma.cuh): three TF32 passes a k-step, small
//   terms first (lo*hi, hi*lo, hi*hi); each stage's tensor-core sum starts
//   from zero and is added to a float32 accumulator.  Stages lie on a grid
//   of KS k-steps counted from tap 0, and a warpgroup's k-steps are its
//   columns' bands, so an output's arithmetic depends on M and the block
//   width alone: its bits do not depend on S, on the tiles of a launch or
//   on the grid.  A stage's products are issued before the next stage is
//   copied and converted, and waited for after.
// - At the bf16 tiers (ops/precision.py; banded_mma.cuh) M splits to bf16
//   limbs in registers and the window's limbs are written as bf16 core
//   matrices of 8 streams x 8 taps: a one-warpgroup stage is one
//   wgmma.m64n64k16.bf16 step, a two-warpgroup stage two; three products a
//   step at 'high', one at 'default'.  M's bytes are read as at 'highest',
//   so the bound stays M's bytes.
// - Each thread stores its accumulators to y[s, t*tile + p] directly: 8
//   consecutive p of 4 streams a warp store, whole 32-byte sectors.
// Measured on an H100 (PERF.md): 0.114 ms at the general shape and 0.044
// ms at the cubic one, 31% and 33% of their bounds; the tensor cores'
// product and the per-stage work around it (copies, conversion, barrier)
// share the time, not the memory's bandwidth.
// Offsets are 64-bit.

#include "banded_mma.cuh"

#include <limits.h>

namespace {

constexpr int kBS = 64;                        // streams a block: wgmma N
constexpr int kSB = kBS / 8;                   // n8 blocks of streams
constexpr int kStages = 3;                     // ring of M and the window
constexpr int kLimbFloats = kSB * 64;          // one k-step's limb of B

// A block's shape: WG warpgroups of 64 columns p each, KS k-steps a stage.
template <int WG, int KS>
struct Shape {
    static constexpr int kThreads = 128 * WG;
    static constexpr int kBlocksPerSM = 4 / WG;
    static constexpr int kBP = 64 * WG;        // columns p a block
    static constexpr int kNB = kBP / 8;        // band entries a block
    static constexpr int kBK = 8 * KS;         // taps a stage
    static constexpr int kMPitch = kBP + 8;    // M [tap][p]: A reads free of
                                               // bank conflicts
    static constexpr int kXChunks = kBK / 4 + 1;  // 16-byte chunks a stream
    static constexpr int kXPitch = 4 * kXChunks;  // raw window [stream][..]
    static constexpr int kBFloats = KS * 2 * kLimbFloats;  // B, 2 slots
    static constexpr int kMFloats = kBK * kMPitch;
    static constexpr int kXFloats = kBS * kXPitch;
    static constexpr int kStageFloats = kMFloats + kXFloats;
    static constexpr int kSmemBytes = (2 * kBFloats + kStages * kStageFloats)
        * 4;
    static_assert(kBFloats % 32 == 0 && kMFloats % 4 == 0
                  && kXFloats % 4 == 0,
                  "128-byte aligned B, 16-byte aligned M and window rows");
    static_assert(kBlocksPerSM * (kSmemBytes + 2048) <= 228 * 1024,
                  "kBlocksPerSM blocks an SM");
    static_assert(kThreads == 8 * (kBP / 4) && kThreads % kBS == 0,
                  "a thread copies one chunk of M a k-step");
};

using Acc = float[kBS / 2];

// d (+)= a * B over 64 columns p x 64 streams x 8 taps, TF32 in, float32
// accumulate; a warpgroup's asynchronous product, A from registers (each
// warp 16 columns in the m16n8k8 fragment layout), B from shared memory.
#define K3_D8(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), \
    "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), \
    "+f"(d[i + 7])
__device__ __forceinline__ void wgmma_n64(Acc& d, const uint32_t (&a)[4],
                                          uint64_t desc, int accumulate)
{
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, "
        "%27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : K3_D8(0), K3_D8(8), K3_D8(16), K3_D8(24)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
          "r"(accumulate)
        : "memory");
}

// The same product over 16 taps, bf16 in (two a register, m16n8k16
// fragment layout), B K-major (not transposed).
__device__ __forceinline__ void wgmma_n64_bf16(Acc& d, const uint32_t (&a)[4],
                                               uint64_t desc, int accumulate)
{
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, "
        "%27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
        "}\n"
        : K3_D8(0), K3_D8(8), K3_D8(16), K3_D8(24)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
          "r"(accumulate)
        : "memory");
}
#undef K3_D8

__device__ __forceinline__ void wgmma_commit()
{
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all()
{
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

__device__ __forceinline__ bool inside(int2 band, int ks)
{
    return band.x <= ks && ks < band.y;
}

// The ring's mbarriers: each phase completes when every thread's cp.async
// of the stage has landed (one arrival a thread) and the bytes of its bulk
// copies have.
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count)
{
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                 :: "r"(banded::smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes)
{
    asm volatile("mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;\n"
                 :: "r"(banded::smem_addr(bar)), "r"(bytes) : "memory");
}

// This thread's arrival, once all its earlier cp.async have landed.
__device__ __forceinline__ void mbar_arrive_cp_async(uint64_t* bar)
{
    asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
                 :: "r"(banded::smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity)
{
    asm volatile("{\n.reg .pred p;\nK3_WAIT:\n"
                 "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
                 "@!p bra K3_WAIT;\n}\n"
                 :: "r"(banded::smem_addr(bar)), "r"(parity) : "memory");
}

// `bytes` (a multiple of 16) from global to shared memory in one bulk
// copy, counted on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          int bytes, uint64_t* bar)
{
    asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx"
                 "::bytes [%0], [%1], %2, [%3];\n"
                 :: "r"(banded::smem_addr(dst)), "l"(src), "r"(bytes),
                    "r"(banded::smem_addr(bar)) : "memory");
}

template <int WG, int KS, int T>
__global__ void __launch_bounds__(Shape<WG, KS>::kThreads,
                                  Shape<WG, KS>::kBlocksPerSM)
general_resample_kernel(const float* __restrict__ x, long long ld,
                        long long n, const void* __restrict__ starts,
                        int starts_are_64bit, const float* __restrict__ m_t,
                        int m_rows, const int2* __restrict__ bands,
                        float* __restrict__ y, long long ldy, int n_streams,
                        int n_stream_blocks, int n_col_blocks, int w_band,
                        int tile, int vec_x, int vec_m)
{
    using S = Shape<WG, KS>;
    constexpr int kWarpgroups = WG, kKS = KS, kThreads = S::kThreads;
    constexpr int kBP = S::kBP, kNB = S::kNB, kBK = S::kBK;
    constexpr int kMPitch = S::kMPitch, kXChunks = S::kXChunks;
    constexpr int kXPitch = S::kXPitch, kBFloats = S::kBFloats;
    constexpr int kMFloats = S::kMFloats, kStageFloats = S::kStageFloats;
    extern __shared__ __align__(128) float smem[];
    __shared__ int2 sband[kNB];                // each 8 columns' k-steps
    __shared__ int2 swg[kWarpgroups];          // each warpgroup's union
    __shared__ __align__(8) uint64_t ring_bar[kStages];

    const int tid = threadIdx.x;
    const int wg = tid >> 7;
    // Blocks of one tile (its column blocks, then its stream blocks) are
    // adjacent in the grid, so that they share the window in L2.
    const int per_tile = n_col_blocks * n_stream_blocks;
    const long long t = (long long)blockIdx.x / per_tile;
    const int in_tile = (int)((long long)blockIdx.x - t * per_tile);
    const int s0 = in_tile / n_col_blocks * kBS;
    const int p0 = in_tile % n_col_blocks * kBP;
    const int nb_total = (tile + 7) / 8;
    const int ks_total = (w_band + 7) / 8;
    const long long start = starts_are_64bit
        ? __ldg(static_cast<const long long*>(starts) + t)
        : (long long)__ldg(static_cast<const int*>(starts) + t);
    const float* m = m_t + t * m_rows * (long long)tile;

    if (tid < kNB) {
        const int nb = p0 / 8 + tid;
        int2 b = nb < nb_total ? bands[t * nb_total + nb] : make_int2(0, 0);
        b.y = min(b.y, ks_total);              // taps past w_band are not
        if (b.y <= b.x)                        // read
            b = make_int2(0, 0);
        sband[tid] = b;
    }
    __syncthreads();
    if (tid < kWarpgroups) {
        int lo = INT_MAX, hi = 0;
        for (int j = tid * 8; j < (tid + 1) * 8; ++j)
            if (sband[j].y > sband[j].x) {
                lo = min(lo, sband[j].x);
                hi = max(hi, sband[j].y);
            }
        swg[tid] = hi > 0 ? make_int2(lo, hi) : make_int2(0, 0);
    }
    if (tid == 0) {
        for (int i = 0; i < kStages; ++i)
            mbar_init(&ring_bar[i], kThreads);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    int lo = INT_MAX, hi = 0;
#pragma unroll
    for (int j = 0; j < kWarpgroups; ++j)
        if (swg[j].y > swg[j].x) {
            lo = min(lo, swg[j].x);
            hi = max(hi, swg[j].y);
        }
    const int2 mine = swg[wg];
    // Stages on the grid of kKS k-steps from tap 0, over the block's union.
    const int st_begin = hi > 0 ? lo / kKS : 0;
    const int n_st = hi > 0 ? (hi + kKS - 1) / kKS - st_begin : 0;

    // Stage st's B has two slots (it is converted one stage ahead); its M
    // rows and raw window have ring slot `slot` of kStages (loaded
    // kStages - 1 stages ahead).
    auto b_at = [&](int st) { return smem + (st & 1) * kBFloats; };
    auto ring_at = [&](int slot) {
        return smem + 2 * kBFloats + slot * kStageFloats;
    };

    // Each thread's share of a stage's copies of M, the same in every
    // stage: the 16-byte chunk (4 columns) mc of tap row mj of each k-step,
    // where that k-step is in its 8 columns' band.  Nothing else of M is
    // read.  A thread converts the window's taps of stream xs.  The
    // window goes in one bulk copy a stream (16-byte aligned rows, the
    // stage's taps and the skew inside x), else in 4-byte copies clamped to
    // [0, n).
    auto window_is_bulk = [&](long long a) {
        return vec_x && a >= 0 && (a & ~3LL) + 4 * kXChunks <= n;
    };
    const int mc = tid % (kBP / 4), mj = tid / (kBP / 4);
    const int2 m_band = sband[mc / 2];
    const bool m_col = p0 + 4 * mc < tile;
    const float* m_src = m + (long long)mj * tile + p0 + 4 * mc;
    const int xs = tid % kBS, xc = tid / kBS;

    auto load_stage = [&](int st, int slot) {
        float* ms = ring_at(slot);
        float* xw = ms + kMFloats;
        uint64_t* bar = &ring_bar[slot];
        const int ks0 = (st_begin + st) * kKS;
        const long long a = start + ks0 * 8;
        if (window_is_bulk(a)) {
            if (tid < kBS && s0 + tid < n_streams) {
                mbar_expect_tx(bar, 16 * kXChunks);
                bulk_copy(xw + tid * kXPitch,
                          x + (long long)(s0 + tid) * ld + (a & ~3LL),
                          16 * kXChunks, bar);
            }
        } else {
            for (int i = tid; i < kBS * kBK; i += kThreads) {
                const int s = i / kBK, k = i % kBK;
                const long long idx = min(max(a + k, 0LL), n - 1);
                const bool ok = s0 + s < n_streams;
                banded::cp_async4(xw + s * kXPitch + k,
                                  ok ? x + (long long)(s0 + s) * ld + idx : x,
                                  ok ? 4 : 0);
            }
        }
        if (vec_m) {
#pragma unroll
            for (int kk = 0; kk < kKS; ++kk) {
                const int ks = ks0 + kk;
                if (!inside(m_band, ks))
                    continue;
                const bool ok = m_col && ks * 8 + mj < w_band;
                banded::cp_async16(ms + (kk * 8 + mj) * kMPitch + 4 * mc,
                                   ok ? m_src + (long long)ks * 8 * tile : m,
                                   ok ? 16 : 0);
            }
        } else {
            for (int i = tid; i < kBK * kBP; i += kThreads) {
                const int k = i / kBP, c = i % kBP;
                if (!inside(sband[c / 8], ks0 + k / 8))
                    continue;
                const bool ok = ks0 * 8 + k < w_band && p0 + c < tile;
                banded::cp_async4(ms + k * kMPitch + c,
                                  ok ? m + (long long)(ks0 * 8 + k) * tile
                                      + p0 + c : m, ok ? 4 : 0);
            }
        }
        mbar_arrive_cp_async(bar);
    };

    // The window's taps of stage st as B.  kHighest: TF32 hi and lo limbs,
    // for each k-step kk and limb L the kSB n8 blocks of 8 streams x 2 tap
    // halves x 4 taps ([kk][L][n8 block][half][stream][tap]); a thread
    // converts 4 taps q of stream xs at a time.  bf16 tiers: for each k16
    // step j the same layout of 8 taps a half ([j][L][n8 block][half]
    // [stream][tap]; no lo limb at kDefault); a thread converts 8 taps q.
    auto convert = [&](int st, int slot) {
        const float* xw = ring_at(slot) + kMFloats + xs * kXPitch;
        const int k0 = (st_begin + st) * kKS * 8;
        const long long a = start + k0;
        const int skew = window_is_bulk(a) ? (int)(a & 3) : 0;
        uint4* b4 = reinterpret_cast<uint4*>(b_at(st));
        if constexpr (T != banded::kHighest) {
            const float4* w4 = reinterpret_cast<const float4*>(xw);
            for (int q = xc; q < kBK / 8; q += kThreads / kBS) {
                const float4 u = w4[2 * q], w = w4[2 * q + 1];
                const float4 z = w4[2 * q + 2];
                const float e[12] = {u.x, u.y, u.z, u.w, w.x, w.y, w.z, w.w,
                                     z.x, z.y, z.z, z.w};
                float v[8];
#pragma unroll
                for (int c = 0; c < 8; ++c) {
                    const float at = skew == 0 ? e[c] : skew == 1 ? e[c + 1]
                        : skew == 2 ? e[c + 2] : e[c + 3];
                    v[c] = k0 + 8 * q + c < w_band ? at : 0.0f;
                }
                uint32_t h[4], l[4];
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    banded::split_bf16(v[2 * j], v[2 * j + 1], h[j], l[j]);
                const int at = (q / 2 * 2 * kSB + xs / 8) * 16 + q % 2 * 8
                    + xs % 8;
                b4[at] = make_uint4(h[0], h[1], h[2], h[3]);
                if constexpr (T == banded::kHigh)
                    b4[at + kSB * 16] = make_uint4(l[0], l[1], l[2], l[3]);
            }
        } else {
            for (int q = xc; q < kBK / 4; q += kThreads / kBS) {
                uint32_t h[4], l[4];
                const float4 u = reinterpret_cast<const float4*>(xw)[q];
                const float4 w = reinterpret_cast<const float4*>(xw)[q + 1];
                const float e[8] = {u.x, u.y, u.z, u.w,
                                    w.x, w.y, w.z, w.w};
                float v[4];
                if (skew == 0) {
                    v[0] = e[0]; v[1] = e[1]; v[2] = e[2]; v[3] = e[3];
                } else if (skew == 1) {
                    v[0] = e[1]; v[1] = e[2]; v[2] = e[3]; v[3] = e[4];
                } else if (skew == 2) {
                    v[0] = e[2]; v[1] = e[3]; v[2] = e[4]; v[3] = e[5];
                } else {
                    v[0] = e[3]; v[1] = e[4]; v[2] = e[5]; v[3] = e[6];
                }
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    banded::split_tf32(
                        k0 + 4 * q + j < w_band ? v[j] : 0.0f, h[j], l[j]);
                const int at = (q / 2 * 2 * kSB + xs / 8) * 16 + q % 2 * 8
                    + xs % 8;
                b4[at] = make_uint4(h[0], h[1], h[2], h[3]);
                b4[at + kSB * 16] = make_uint4(l[0], l[1], l[2], l[3]);
            }
        }
    };

    Acc acc, part;
#pragma unroll
    for (int i = 0; i < kBS / 2; ++i) {
        acc[i] = 0.0f;
        part[i] = 0.0f;
    }
    const int warp = (tid >> 5) & 3, g = (tid & 31) >> 2, tq = tid & 3;
    const int row = wg * 64 + warp * 16 + g;   // this thread's column p
    // The bands of its two columns' 8-column blocks (row, row + 8).
    const int2 a_band0 = sband[row / 8], a_band1 = sband[row / 8 + 1];
    // A's register steps a stage: kKS TF32 k8 steps, or kKS / 2 bf16 k16.
    constexpr int kRegSteps = T == banded::kHighest ? kKS : kKS / 2;
    uint32_t ahi[kRegSteps][4], alo[kRegSteps][4];

    // This warpgroup's k-steps of stage st (M at ring slot `slot`): A's
    // fragments split into limbs (zero outside their 8 columns' band),
    // then three wgmma a k-step into `part`, which starts from the first
    // product.  Returns whether the warpgroup issued any (uniform).
    auto product_issue = [&](int st, int slot) {
        const int ks0 = (st_begin + st) * kKS;
        if (mine.y <= ks0 || mine.x >= ks0 + kKS)
            return false;
        const float* bs = b_at(st);
        const float* ms = ring_at(slot);
        if constexpr (T != banded::kHighest) {
            // Step j: 8-tap k-steps u0 and u0 + 1; registers 0..3 are
            // columns row, row + 8 at taps 2tq, 2tq + 1 (u0), then the
            // same at taps 2tq + 8, 2tq + 9 (u0 + 1).
#pragma unroll
            for (int j = 0; j < kRegSteps; ++j) {
                const int u0 = ks0 + 2 * j;
                const bool in00 = inside(a_band0, u0);
                const bool in10 = inside(a_band1, u0);
                const bool in01 = inside(a_band0, u0 + 1);
                const bool in11 = inside(a_band1, u0 + 1);
                const float* r = ms + (j * 16 + 2 * tq) * kMPitch + row;
                banded::split_bf16(in00 ? r[0] : 0.0f,
                                   in00 ? r[kMPitch] : 0.0f, ahi[j][0],
                                   alo[j][0]);
                banded::split_bf16(in10 ? r[8] : 0.0f,
                                   in10 ? r[kMPitch + 8] : 0.0f, ahi[j][1],
                                   alo[j][1]);
                banded::split_bf16(in01 ? r[8 * kMPitch] : 0.0f,
                                   in01 ? r[9 * kMPitch] : 0.0f, ahi[j][2],
                                   alo[j][2]);
                banded::split_bf16(in11 ? r[8 * kMPitch + 8] : 0.0f,
                                   in11 ? r[9 * kMPitch + 8] : 0.0f,
                                   ahi[j][3], alo[j][3]);
            }
#pragma unroll
            for (int i = 0; i < kBS / 2; ++i)
                banded::pin(part[i]);
            banded::wgmma_fence();
            int accumulate = 0;
#pragma unroll
            for (int j = 0; j < kRegSteps; ++j) {
                const int u0 = ks0 + 2 * j;
                if (inside(mine, u0) || inside(mine, u0 + 1)) {
                    const float* bhi = bs + j * 2 * kLimbFloats;
                    const float* blo = bhi + kLimbFloats;
                    if constexpr (T == banded::kHigh) {
                        wgmma_n64_bf16(part, alo[j], banded::b_desc(bhi),
                                       accumulate);
                        wgmma_n64_bf16(part, ahi[j], banded::b_desc(blo), 1);
                        wgmma_n64_bf16(part, ahi[j], banded::b_desc(bhi), 1);
                    } else {
                        wgmma_n64_bf16(part, ahi[j], banded::b_desc(bhi),
                                       accumulate);
                    }
                    accumulate = 1;
                }
            }
            wgmma_commit();
        } else {
#pragma unroll
            for (int kk = 0; kk < kKS; ++kk) {
                const bool in0 = inside(a_band0, ks0 + kk);
                const bool in1 = inside(a_band1, ks0 + kk);
                const float* r = ms + (kk * 8 + tq) * kMPitch + row;
                banded::split_tf32(in0 ? r[0] : 0.0f, ahi[kk][0],
                                   alo[kk][0]);
                banded::split_tf32(in1 ? r[8] : 0.0f, ahi[kk][1],
                                   alo[kk][1]);
                banded::split_tf32(in0 ? r[4 * kMPitch] : 0.0f, ahi[kk][2],
                                   alo[kk][2]);
                banded::split_tf32(in1 ? r[4 * kMPitch + 8] : 0.0f,
                                   ahi[kk][3], alo[kk][3]);
            }
#pragma unroll
            for (int i = 0; i < kBS / 2; ++i)
                banded::pin(part[i]);
            banded::wgmma_fence();
            int accumulate = 0;
#pragma unroll
            for (int kk = 0; kk < kKS; ++kk) {
                if (inside(mine, ks0 + kk)) {
                    const float* bhi = bs + kk * 2 * kLimbFloats;
                    const float* blo = bhi + kLimbFloats;
                    wgmma_n64(part, alo[kk], banded::b_desc(bhi),
                              accumulate);
                    wgmma_n64(part, ahi[kk], banded::b_desc(blo), 1);
                    wgmma_n64(part, ahi[kk], banded::b_desc(bhi), 1);
                    accumulate = 1;
                }
            }
            wgmma_commit();
        }
        return true;
    };

    // Waits for the products and adds the stage's sum to acc in float32.
    auto product_finish = [&]() {
        wgmma_wait_all();
#pragma unroll
        for (int kk = 0; kk < kRegSteps; ++kk)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                banded::pin(ahi[kk][i]);
                if constexpr (T != banded::kDefault)
                    banded::pin(alo[kk][i]);
            }
#pragma unroll
        for (int i = 0; i < kBS / 2; ++i) {
            banded::pin(part[i]);
            acc[i] += part[i];
        }
    };

    // The ring.  One barrier a stage: stage st's products are issued,
    // then stage st + kStages - 1 is loaded into the slot stage st - 1 left
    // and stage st + 1, once landed, is converted into the B slot stage
    // st - 1 left, while the tensor cores work; then the products are
    // waited for.  Stage st is use st / kStages of its slot.
#pragma unroll
    for (int st = 0; st < kStages - 1; ++st)
        if (st < n_st)
            load_stage(st, st);
    if (n_st > 0) {
        mbar_wait(&ring_bar[0], 0);
        convert(0, 0);
    }
    int cur = 0;                               // ring slot of stage st
    for (int st = 0; st < n_st; ++st) {
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        __syncthreads();                       // B of stage st is written,
                                               // stage st - 1 consumed
        const int nxt = cur + 1 == kStages ? 0 : cur + 1;
        const int prv = cur == 0 ? kStages - 1 : cur - 1;
        const bool issued = product_issue(st, cur);
        if (st + kStages - 1 < n_st)
            load_stage(st + kStages - 1, prv);
        if (st + 1 < n_st) {
            mbar_wait(&ring_bar[nxt], (st + 1) / kStages & 1);
            convert(st + 1, nxt);
        }
        if (issued)
            product_finish();
        cur = nxt;
    }
#pragma unroll
    for (int j = 0; j < kSB; ++j) {
        const int c = j * 8 + 2 * tq;
        float* y0 = y + t * tile + p0 + (long long)(s0 + c) * ldy + row;
        if (p0 + row < tile) {
            if (s0 + c < n_streams) y0[0] = acc[4 * j];
            if (s0 + c + 1 < n_streams) y0[ldy] = acc[4 * j + 1];
        }
        if (p0 + row + 8 < tile) {
            if (s0 + c < n_streams) y0[8] = acc[4 * j + 2];
            if (s0 + c + 1 < n_streams) y0[ldy + 8] = acc[4 * j + 3];
        }
    }
}

// The k-steps a stage of each block shape.
constexpr int kStageKsteps1 = 2;
constexpr int kStageKsteps2 = 4;

// Devices that allowed each variant's ring memory ([tier][one warpgroup,
// two]).
bool k3_smem_allowed[3][2][64];

template <int WG, int KS, int T>
int launch_k3(const float* x, long long ld, long long n, const void* starts,
              int starts_are_64bit, const float* m_t, int m_rows,
              const int* bands, float* y, long long n_tiles, int n_streams,
              int w_band, int tile, void* stream)
{
    using S = Shape<WG, KS>;
    const long long n_sb = (n_streams + kBS - 1) / kBS;
    const long long n_cb = (tile + S::kBP - 1) / S::kBP;
    const long long gx = n_tiles * n_sb * n_cb;
    if (n_sb * n_cb > 2147483647LL || gx > 2147483647LL)
        return (int)cudaErrorInvalidValue;
    // The ring's shared memory is above the 48 KB default: allowed once
    // per device.
    int device = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err != cudaSuccess)
        return (int)err;
    bool* allowed = k3_smem_allowed[T][WG - 1];
    if (device < 0 || device >= 64 || !allowed[device]) {
        err = cudaFuncSetAttribute(general_resample_kernel<WG, KS, T>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   S::kSmemBytes);
        if (err != cudaSuccess)
            return (int)err;
        if (device >= 0 && device < 64)
            allowed[device] = true;
    }
    const int vec_x = ((uintptr_t)x % 16 == 0 && ld % 4 == 0) ? 1 : 0;
    const int vec_m = ((uintptr_t)m_t % 16 == 0 && tile % 4 == 0) ? 1 : 0;
    general_resample_kernel<WG, KS, T>
        <<<(unsigned)gx, S::kThreads, S::kSmemBytes, (cudaStream_t)stream>>>(
            x, ld, n, starts, starts_are_64bit, m_t, m_rows,
            (const int2*)bands, y, n_tiles * tile, n_streams, (int)n_sb,
            (int)n_cb, w_band, tile, vec_x, vec_m);
    return (int)cudaGetLastError();
}

// The block shape (1 or 2 warpgroups) at tier T.
template <int T>
int launch_tier(const float* x, long long ld, long long n,
                const void* starts, int starts_are_64bit, const float* m_t,
                int m_rows, const int* bands, float* y, long long n_tiles,
                int n_streams, int w_band, int tile, int warpgroups,
                void* stream)
{
    return warpgroups == 1
        ? launch_k3<1, kStageKsteps1, T>(x, ld, n, starts, starts_are_64bit,
                                         m_t, m_rows, bands, y, n_tiles,
                                         n_streams, w_band, tile, stream)
        : launch_k3<2, kStageKsteps2, T>(x, ld, n, starts, starts_are_64bit,
                                         m_t, m_rows, bands, y, n_tiles,
                                         n_streams, w_band, tile, stream);
}

}  // namespace

// y [S, n_tiles*tile] from x [S, n] (row stride ld), starts [n_tiles]
// (int32, or int64 when starts_are_64bit), m_t [n_tiles, m_rows, tile]
// with m_rows >= w_band, and M's int32 band table [n_tiles,
// ceil(tile/8), 2] (ops/general.py::band_table); all on the device,
// float32 but for starts and bands.  `warpgroups` (1 or 2) is the block
// shape chosen from M (ops/general.py::block_warpgroups); ``tier`` the
// product's tier (0 highest, 1 high, 2 default).  Launches on ``stream``
// and returns the cudaError_t of the launch (0 on success).
extern "C" int general_resample_launch(const float* x, long long ld,
                                       long long n, const void* starts,
                                       int starts_are_64bit, const float* m_t,
                                       int m_rows, const int* bands,
                                       float* y, long long n_tiles,
                                       int n_streams, int w_band, int tile,
                                       int warpgroups, int tier,
                                       void* stream)
{
    if (n_tiles <= 0 || n_streams <= 0 || n <= 0 || ld < n || w_band <= 0
            || m_rows < w_band || tile <= 0
            || (warpgroups != 1 && warpgroups != 2))
        return (int)cudaErrorInvalidValue;
    switch (tier) {
    case banded::kHighest:
        return launch_tier<banded::kHighest>(
            x, ld, n, starts, starts_are_64bit, m_t, m_rows, bands, y,
            n_tiles, n_streams, w_band, tile, warpgroups, stream);
    case banded::kHigh:
        return launch_tier<banded::kHigh>(
            x, ld, n, starts, starts_are_64bit, m_t, m_rows, bands, y,
            n_tiles, n_streams, w_band, tile, warpgroups, stream);
    case banded::kDefault:
        return launch_tier<banded::kDefault>(
            x, ld, n, starts, starts_are_64bit, m_t, m_rows, bands, y,
            n_tiles, n_streams, w_band, tile, warpgroups, stream);
    default:
        return (int)cudaErrorInvalidValue;
    }
}
