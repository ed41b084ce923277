// The tile product that K1 (fused_resample.cu) and K2
// (fused_resample_tmajor.cu) share: a block of 256 or 128 signal rows
// (Tile<WG>::kBM) times kBN = 80 output columns of the periodic banded
// operator R, on Hopper's tensor cores (wgmma) with float32 accumulation,
// at one of three precision tiers (Tier, ops/precision.py).
//
// Operands.  A is the signal: A[row, w] is tap w of the row's window (K1
// stages it row by row, K2 tap by tap; the fragments read the same values),
// held in registers in wgmma's fragment layout, each of the block's
// warpgroups 64 rows.  B is R, prepared once with the operator by
// ops/banded.py at the tier: its limbs as K-major core matrices of 8
// columns x 16 bytes, the layout wgmma reads from shared memory (tf32
// wgmma takes no transposed operand; R is laid out so on the host), and
// for each 8-column block the range of 8-tap k-steps that holds its
// non-zero taps (its band).  A block walks the union of its columns'
// bands; B is zero where an 8-column block's own band ends.
//
// Arithmetic.  A stage is kBK = 16 taps.  kHighest: per 8-tap k-step,
// three wgmma.m64n80k8.tf32 into one float32 accumulator, small terms
// first: acc += a_lo*b_hi; acc += a_hi*b_lo; acc += a_hi*b_hi.  The
// signal's limbs are formed in registers: hi is x rounded to TF32 (to
// nearest, ties away, as cvt.rna.tf32.f32 does), lo = x - hi exactly.
// One TF32 pass alone misses float32 accuracy by far (about 1e-3 on
// unit-scale audio); the three passes keep it.  kHigh: the stage is one
// wgmma.m64n80k16.bf16 step, the same three products of bf16 limbs (hi =
// cvt.rn.bf16x2.f32 of x, lo of x - hi), as the JAX package's mxu_dot
// splits them; kDefault: one product of the hi limbs, the TPU's one bf16
// pass.  The tensor cores' own accumulation runs over one stage at a
// time, from zero, and each stage's sum is added to the block's float32
// accumulator: truncation in the tensor cores' adder then does not grow
// with the band's length (over the decimation operator's 1,450-tap bands,
// one chain lost an order of magnitude of accuracy).
//
// Launch independence.  An output's k-steps, their grouping into stages,
// the bands and the split of a band across a cluster depend on the
// operator alone, so an output's bits do not depend on the number of rows,
// the launch or the output's place in the grid; and since K1 and K2 feed
// the same values through this routine, K2's output equals K1's bit for
// bit, at each tier.
//
// Cluster split.  Where a band is long (the decimation operator: 2,882
// taps, ~1,550 per block of columns), `split` blocks of a thread-block
// cluster walk consecutive parts of it, and their partial tiles are summed
// through distributed shared memory in cluster-rank order: no atomics, no
// workspace in device memory.  The parts are whole 8-tap k-steps; a bf16
// stage that holds only one zeroes the other half of A and B.
//
// Staging.  A ring of kStages stages in shared memory, each kKS k-steps of
// A and B, filled with cp.async (16 bytes where the signal is aligned, 4
// bytes otherwise; ragged edges zero-filled by the copy's source size).
// 16 warps an SM, 128 registers a thread, in either block shape (Tile).
//
// Measured on an H100 (see PERF.md): the tensor cores are not what binds.
// A block's loads from L2 (its rows' taps and R's limbs, 20-30 KB a stage)
// and the work around them take most of its time; the tall block halves
// the loads of B per row.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace banded {

namespace cg = cooperative_groups;

constexpr int kBN = 80;                        // output columns a block
constexpr int kNB = kBN / 8;                   // n8 blocks (band entries)
constexpr int kKS = 2;                         // k-steps per stage
constexpr int kBK = 8 * kKS;                   // taps per stage
constexpr int kStages = 4;
constexpr int kAChunks = kBK / 4 + 1;          // 16-byte chunks of a row
constexpr int kAPitchRow = 4 * kAChunks;       // row-major A [rows][..]
constexpr int kBChunks = kKS * kNB * 32;       // 16-byte chunks of B a stage
constexpr int kCPitch = kBN + 1;               // epilogue tile [rows][..]
constexpr int kMaxSplit = 8;                   // largest cluster

// The matmul tier of the product (ops/precision.py TIER_CODES).
enum Tier : int { kHighest = 0, kHigh = 1, kDefault = 2 };

// What a tier reads of B: bf16 or TF32 limbs, how many, and the 16-byte
// chunks of BandedOperator.packed per (8-column block, 8-tap k-step).
template <int T>
struct TierB {
    static constexpr bool kBf16 = T != kHighest;
    static constexpr int kLimbs = T == kDefault ? 1 : 2;
    static constexpr int kUnitChunks = kBf16 ? 8 * kLimbs : 32;
    static_assert(T == kHighest || T == kHigh || T == kDefault, "tier");
};

// Two block shapes, chosen from the operator alone: where one block walks
// a column tile's whole band (split 1), four warpgroups (256 rows, one
// block an SM) share each stage of B; where the band is split across a
// cluster, two (128 rows, two blocks an SM) keep enough blocks in flight.
constexpr int kTallWarpgroups = 4;
constexpr int kShortWarpgroups = 2;

template <int WG>
struct Tile {
    static constexpr int kThreads = 128 * WG;
    static constexpr int kBM = 64 * WG;        // signal rows a block
    static constexpr int kBlocksPerSM = WG == kShortWarpgroups ? 2 : 1;
    static constexpr int kAPitchTap = kBM + 8; // tap-major A [kBK][..]
    static constexpr int kAFloats = kBM * kAPitchRow > kBK * kAPitchTap
        ? kBM * kAPitchRow : kBK * kAPitchTap;
    static constexpr int kStageFloats = kAFloats + 4 * kBChunks;
    static constexpr int kSmemBytes = kStages * kStageFloats * 4;
    static_assert(kBM * kCPitch <= kStages * kStageFloats, "epilogue fits");
    static_assert(kAFloats % 32 == 0 && kStageFloats % 32 == 0,
                  "128-byte aligned B tiles");
};

__device__ __forceinline__ unsigned smem_addr(const void* p)
{
    return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Copies `bytes` (0 or 4) to shared memory and zero-fills the rest.
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int bytes)
{
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(smem_addr(dst)), "l"(src), "r"(bytes) : "memory");
}

// Copies `bytes` (0..16) to shared memory and zero-fills the rest of 16.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes)
{
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smem_addr(dst)), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit()
{
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait()
{
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// x = hi + lo exactly, hi the TF32 rounding of x (to nearest, ties away
// from zero: cvt.rna.tf32.f32 on finite values, in two integer
// operations); the tensor cores read lo's top 19 bits.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo)
{
    hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
    lo = __float_as_uint(x - __uint_as_float(hi));
}

// Two floats as bf16x2 (x0 in the low half), each rounded to nearest,
// ties to even.
__device__ __forceinline__ uint32_t bf16x2(float x0, float x1)
{
    uint32_t d;
    asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(d) : "f"(x1), "f"(x0));
    return d;
}

// (x0, x1) as bf16x2 limbs: hi their bf16 rounding, lo that of x - hi
// (exact in float32), as the JAX package's mxu_dot splits an operand.
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo)
{
    hi = bf16x2(x0, x1);
    lo = bf16x2(x0 - __uint_as_float(hi << 16),
                x1 - __uint_as_float(hi & 0xffff0000u));
}

// Shared-memory descriptor of one k-step's B limb: kBN columns x 8 taps,
// K-major without swizzle, as kNB x 2 core matrices of 8 columns x 16
// bytes (4 TF32 or 8 bf16 taps; 128 bytes each): the two tap halves 128
// bytes apart (leading offset), the 8-column blocks 256 bytes apart
// (stride offset).
__device__ __forceinline__ uint64_t b_desc(const void* tile)
{
    return (uint64_t)((smem_addr(tile) >> 4) & 0x3fff)
        | ((uint64_t)(128 >> 4) << 16) | ((uint64_t)(256 >> 4) << 32);
}

// d (+)= a * B over 64 rows x 80 columns x 8 taps, TF32 in, float32
// accumulate; a warpgroup's asynchronous product (wgmma), A from
// registers (each warp its 16 rows in the m16n8k8 fragment layout).
#define BANDED_D8(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), \
    "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), \
    "+f"(d[i + 7])
static_assert(kBN == 80, "wgmma_tf32 is written for m64n80k8");
__device__ __forceinline__ void wgmma_tf32(float (&d)[kBN / 2],
                                           const uint32_t (&a)[4],
                                           uint64_t desc, int accumulate)
{
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n80k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, "
        "%27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39}, "
        "{%40, %41, %42, %43}, %44, p, 1, 1;\n}\n"
        : BANDED_D8(0), BANDED_D8(8), BANDED_D8(16), BANDED_D8(24),
          BANDED_D8(32)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
          "r"(accumulate)
        : "memory");
}

// d (+)= a * B over 64 rows x 80 columns x 16 taps, bf16 in, float32
// accumulate; A from registers (each warp its 16 rows, two bf16 a
// register, in the m16n8k16 fragment layout), B K-major (not transposed).
__device__ __forceinline__ void wgmma_bf16(float (&d)[kBN / 2],
                                           const uint32_t (&a)[4],
                                           uint64_t desc, int accumulate)
{
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, "
        "%27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39}, "
        "{%40, %41, %42, %43}, %44, p, 1, 1, 0;\n}\n"
        : BANDED_D8(0), BANDED_D8(8), BANDED_D8(16), BANDED_D8(24),
          BANDED_D8(32)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
          "r"(accumulate)
        : "memory");
}
#undef BANDED_D8

__device__ __forceinline__ void wgmma_fence()
{
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit_and_wait()
{
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving a register across this point.
__device__ __forceinline__ void pin(float& x)
{
    asm volatile("" : "+f"(x) :: "memory");
}

__device__ __forceinline__ void pin(uint32_t& x)
{
    asm volatile("" : "+r"(x) :: "memory");
}

using Acc = float[kBN / 2];

// Where a stage keeps tap k of row `row` of A.  Row-major (K1): each row
// starts `skew` floats into its slot, the offset of its window in the
// 16-byte chunks it was copied in (h: the thread's row g or g + 8).
// Tap-major (K2): rows are consecutive in a tap's line.
struct RowMajorA {
    int skew[2];
    __device__ __forceinline__ float at(const float* as, int h, int row,
                                        int k) const
    {
        return as[row * kAPitchRow + skew[h] + k];
    }
};

template <int WG>
struct TapMajorA {
    __device__ __forceinline__ float at(const float* as, int, int row,
                                        int k) const
    {
        return as[k * Tile<WG>::kAPitchTap + row];
    }
};

// The first row of this thread's A fragment in the block: warpgroup wg
// has rows 64*wg .. +63, its warp w rows 16*w .. +15, lane group g rows
// g and g + 8.
__device__ __forceinline__ int frag_row()
{
    const int warp = threadIdx.x >> 5;
    return (warp >> 2) * 64 + (warp & 3) * 16 + ((threadIdx.x & 31) >> 2);
}

// The stage's k-steps at tier T into `part`, which starts from the
// stage's first product (no accumulate), pass order small terms first;
// then `part` is added to acc in float32.  kHighest: three TF32 wgmma per
// 8-tap k-step.  kHigh and kDefault: the stage's 16 taps as one bf16
// k16 step (A past the stage's k-steps and B outside the bands are zero),
// three products or one.  B's limbs: hi at bs, lo kNB*64 floats on.
template <int T, class AFrag>
__device__ __forceinline__ void stage_product(const AFrag& afrag,
                                              const float* as,
                                              const float* bs, int n_ks,
                                              Acc& part, Acc& acc)
{
    const int r = frag_row(), t = threadIdx.x & 3;
    if constexpr (T == kHighest) {
        uint32_t ahi[kKS][4], alo[kKS][4];
#pragma unroll
        for (int kk = 0; kk < kKS; ++kk) {
            const int k = kk * 8 + t;
            split_tf32(afrag.at(as, 0, r, k), ahi[kk][0], alo[kk][0]);
            split_tf32(afrag.at(as, 1, r + 8, k), ahi[kk][1], alo[kk][1]);
            split_tf32(afrag.at(as, 0, r, k + 4), ahi[kk][2], alo[kk][2]);
            split_tf32(afrag.at(as, 1, r + 8, k + 4), ahi[kk][3],
                       alo[kk][3]);
        }
#pragma unroll
        for (int i = 0; i < kBN / 2; ++i)
            pin(part[i]);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kKS; ++kk) {
            if (kk < n_ks) {
                const float* hi = bs + (kk * 2) * kNB * 64;   // 64 floats
                const float* lo = hi + kNB * 64;              // an n8 block
                wgmma_tf32(part, alo[kk], b_desc(hi), kk > 0);
                wgmma_tf32(part, ahi[kk], b_desc(lo), 1);
                wgmma_tf32(part, ahi[kk], b_desc(hi), 1);
            }
        }
        wgmma_commit_and_wait();
#pragma unroll
        for (int kk = 0; kk < kKS; ++kk)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                pin(ahi[kk][i]);
                pin(alo[kk][i]);
            }
    } else {
        static_assert(kBK == 16, "a bf16 stage is one k16 step");
        const float* hi = bs;                           // 64 floats an n8
        const float* lo = bs + kNB * 64;                // block a limb
        // Registers 0..3: rows r, r + 8 at taps 2t, 2t + 1, then the same
        // rows at taps 2t + 8, 2t + 9.
        const int k = 2 * t;
        uint32_t ahi[4], alo[4];
        split_bf16(afrag.at(as, 0, r, k), afrag.at(as, 0, r, k + 1), ahi[0],
                   alo[0]);
        split_bf16(afrag.at(as, 1, r + 8, k), afrag.at(as, 1, r + 8, k + 1),
                   ahi[1], alo[1]);
        split_bf16(afrag.at(as, 0, r, k + 8), afrag.at(as, 0, r, k + 9),
                   ahi[2], alo[2]);
        split_bf16(afrag.at(as, 1, r + 8, k + 8),
                   afrag.at(as, 1, r + 8, k + 9), ahi[3], alo[3]);
#pragma unroll
        for (int i = 0; i < kBN / 2; ++i)
            pin(part[i]);
        wgmma_fence();
        if constexpr (T == kHigh) {
            wgmma_bf16(part, alo, b_desc(hi), 0);
            wgmma_bf16(part, ahi, b_desc(lo), 1);
            wgmma_bf16(part, ahi, b_desc(hi), 1);
        } else {
            wgmma_bf16(part, ahi, b_desc(hi), 0);
        }
        wgmma_commit_and_wait();
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            pin(ahi[i]);
            if constexpr (T == kHigh)
                pin(alo[i]);
        }
    }
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) {
        pin(part[i]);
        acc[i] += part[i];
    }
}

// The block's part of column tile `tile_n`: the k-steps of the union of
// its n8 blocks' bands, cut into `split` consecutive parts of which this
// block walks part `rank`; B is zero where an n8 block's own band ends.
// load_a(as, k0, n_taps) stages taps [k0, k0 + n_taps) of the block's rows
// with cp.async (zero fill past the signal's edges).  `packed` is
// BandedOperator.packed at tier T: for each (n8 block, k-step), kHighest
// 32 chunks of 16 bytes, [limb][tap half][column][4 taps]; kHigh and
// kDefault 8 per limb, [limb][column][8 taps].  A stage of B in shared
// memory: kHighest [k-step][limb][n8 block][half][column], bf16
// [limb][n8 block][k-step][column] (the k-steps are the k16 step's two
// halves).  `bands` is its per-n8-block table.  Each stage's products
// start from zero and are added to acc in float32, so that the tensor
// cores' accumulation never runs over more than one stage.
template <int WG, int T, class AFrag, class LoadA>
__device__ __forceinline__ void tile_product(
    const AFrag& afrag, LoadA load_a, const float4* __restrict__ packed,
    const int2* __restrict__ bands, int ks_total, int nb_total, int tile_n,
    int rank, int split, float* smem, Acc& acc)
{
    constexpr int kThreads = Tile<WG>::kThreads;
    constexpr int kAFloats = Tile<WG>::kAFloats;
    constexpr int kStageFloats = Tile<WG>::kStageFloats;
    constexpr int kUnit = TierB<T>::kUnitChunks;
    constexpr int kStageChunks = kKS * kNB * kUnit;
    static_assert(kStageChunks <= kBChunks, "B fits its stage");
    __shared__ int2 sband[kNB];
    const int tid = threadIdx.x;
    const int nb0 = tile_n * kNB;
    if (tid < kNB)
        sband[tid] = nb0 + tid < nb_total ? bands[nb0 + tid]
                                          : make_int2(0, 0);
    __syncthreads();
    int lo = 0x7fffffff, hi = 0;
#pragma unroll
    for (int j = 0; j < kNB; ++j)
        if (sband[j].y > sband[j].x) {
            lo = min(lo, sband[j].x);
            hi = max(hi, sband[j].y);
        }
    if (hi == 0)
        lo = 0;
    const int ks_begin = lo + (hi - lo) * rank / split;
    const int ks_end = lo + (hi - lo) * (rank + 1) / split;
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i)
        acc[i] = 0.0f;
    Acc part;
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i)
        part[i] = 0.0f;

    const int n_ks = ks_end - ks_begin;
    const int n_st = (n_ks + kKS - 1) / kKS;
    auto load_stage = [&](int st) {
        float* as = smem + (st % kStages) * kStageFloats;
        float4* bs = reinterpret_cast<float4*>(as + kAFloats);
        const int ks0 = ks_begin + st * kKS;
        const int ks_lim = min(kKS, ks_end - ks0);
        load_a(as, ks0 * 8, ks_lim * 8);
        for (int i = tid; i < kStageChunks; i += kThreads) {
            const int kk = i / (kNB * kUnit);
            const int nbl = (i / kUnit) % kNB;
            const int c = i % kUnit;           // [limb][half][column] (TF32)
            const int2 b = sband[nbl];         // or [limb][column] (bf16)
            const int ks = ks0 + kk;
            const float4* src = packed + ((long long)(nb0 + nbl) * ks_total
                                          + ks) * kUnit + c;
            if constexpr (TierB<T>::kBf16) {
                // Zeros outside the band and past the stage's k-steps.
                const bool ok = kk < ks_lim && b.x <= ks && ks < b.y;
                cp_async16(bs + (((c / 8) * kNB + nbl) * kKS + kk) * 8
                           + c % 8, ok ? src : packed, ok ? 16 : 0);
            } else {
                const bool ok = b.x <= ks && ks < b.y;
                if (kk < ks_lim)               // zeros outside the band
                    cp_async16(bs + ((kk * 2 + c / 16) * kNB + nbl) * 16
                               + c % 16, ok ? src : packed, ok ? 16 : 0);
            }
        }
    };

#pragma unroll
    for (int st = 0; st < kStages - 1; ++st) {
        if (st < n_st)
            load_stage(st);
        cp_async_commit();
    }
    for (int st = 0; st < n_st; ++st) {
        cp_async_wait<kStages - 2>();          // stage st has landed
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        __syncthreads();                       // and stage st-1 is consumed
        if (st + kStages - 1 < n_st)
            load_stage(st + kStages - 1);
        cp_async_commit();
        const float* as = smem + (st % kStages) * kStageFloats;
        stage_product<T>(afrag, as, as + kAFloats,
                         min(kKS, n_ks - st * kKS), part, acc);
    }
    cp_async_wait<0>();
    __syncthreads();                           // the ring is free again
}

// Sums the cluster's partial tiles in rank order and hands each output to
// store(row, col, value); each rank reduces and stores kBM/split of the
// rows.  The partials are read from the peers along rows (consecutive
// columns: few distributed-shared-memory transactions), a thread's
// partials all loaded before they are summed.  With col_fastest (K1's
// row-major output) the sums are stored as they are formed; else (K2's
// transposed output) they go back to this block's tile first and leave
// with consecutive threads on consecutive rows.
template <int WG, class Store>
__device__ __forceinline__ void epilogue(float* smem, const Acc& acc,
                                         int split, bool col_fastest,
                                         Store store)
{
    constexpr int kThreads = Tile<WG>::kThreads, kBM = Tile<WG>::kBM;
    const int tid = threadIdx.x, t = tid & 3;
    const int r = frag_row();
    float* cs = smem;
#pragma unroll
    for (int j = 0; j < kNB; ++j) {
        const int c = j * 8 + 2 * t;
        cs[r * kCPitch + c] = acc[4 * j];
        cs[r * kCPitch + c + 1] = acc[4 * j + 1];
        cs[(r + 8) * kCPitch + c] = acc[4 * j + 2];
        cs[(r + 8) * kCPitch + c + 1] = acc[4 * j + 3];
    }
    cg::cluster_group cluster = cg::this_cluster();
    if (split > 1)
        cluster.sync();                        // every partial is written
    else
        __syncthreads();
    const int rows = kBM / split;
    const int r0 = (split > 1 ? (int)cluster.block_rank() : 0) * rows;
    if (split > 1) {
        for (int i = tid; i < rows * kBN; i += kThreads) {
            const int rr = r0 + i / kBN, c = i % kBN;
            float* at = cs + rr * kCPitch + c;
            float p[kMaxSplit];
#pragma unroll
            for (int q = 0; q < kMaxSplit; ++q)
                if (q < split)
                    p[q] = *cluster.map_shared_rank(at, q);
            float v = p[0];
#pragma unroll
            for (int q = 1; q < kMaxSplit; ++q)
                if (q < split)
                    v += p[q];
            if (col_fastest)
                store(rr, c, v);
            else
                *at = v;                       // only this rank reads it
        }
    }
    if (split == 1 || !col_fastest) {
        __syncthreads();
        for (int i = tid; i < rows * kBN; i += kThreads) {
            const int rr = r0 + (col_fastest ? i / kBN : i % rows);
            const int c = col_fastest ? i % kBN : i / rows;
            store(rr, c, cs[rr * kCPitch + c]);
        }
    }
    if (split > 1)
        cluster.sync();                        // peers' reads are done
}

// Launches `kernel` on a grid of (row tiles * split, column tiles) blocks
// in clusters of (split, 1, 1), with the ring's dynamic shared memory.
// `allowed` is the kernel's own per-device record of that allowance (a
// variable with internal linkage in the kernel's source, so that no two
// libraries share it).
template <int WG, class Kernel, class... Args>
inline cudaError_t launch(Kernel kernel, bool (&allowed)[64],
                          long long row_tiles, int p2, int split,
                          void* stream, Args... args)
{
    constexpr int kThreads = Tile<WG>::kThreads;
    constexpr int kSmemBytes = Tile<WG>::kSmemBytes;
    const long long gx = row_tiles * split;
    const long long gy = (p2 + kBN - 1) / kBN;
    if (gx <= 0 || gx > 2147483647LL || gy > 65535
            || !(split == 1 || split == 2 || split == 4 || split == kMaxSplit))
        return cudaErrorInvalidValue;
    // The ring's shared memory is above the 48 KB default: allowed once
    // per device.
    int device = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err != cudaSuccess)
        return err;
    if (device < 0 || device >= 64 || !allowed[device]) {
        err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
        if (err != cudaSuccess)
            return err;
        if (device >= 0 && device < 64)
            allowed[device] = true;
    }
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)gx, (unsigned)gy, 1);
    cfg.blockDim = dim3(kThreads, 1, 1);
    cfg.dynamicSmemBytes = kSmemBytes;
    cfg.stream = (cudaStream_t)stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned)split;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, kernel, args...);
    if (err != cudaSuccess)
        return err;
    return cudaGetLastError();
}

}  // namespace banded
