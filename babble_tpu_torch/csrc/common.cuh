// Shared helpers for the port's CUDA kernels. Each kernel source is built
// by nvcc into its own shared library with a plain C interface
// (babble_tpu_torch/tpu/_ext.py loads them with ctypes). Every entry point
// launches on the caller's stream, allocates nothing, does not synchronise,
// and returns cudaGetLastError() so the Python wrapper can raise.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define BABBLE_MAX_INT32 2147483647
#define BABBLE_MIN_INT32 (-2147483647 - 1)
#define BABBLE_FULL_MASK 0xffffffffu

// One definition per shared library: each source includes this header once
// and each library is loaded on its own (RTLD_LOCAL).
extern "C" const char* babble_cuda_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

static inline unsigned babble_blocks(long long work, int threads) {
    return static_cast<unsigned>((work + threads - 1) / threads);
}

// Block count for a grid-stride loop: enough blocks to fill every SM of
// an H100 (132) several times over, never more than the work needs.
static inline unsigned babble_stride_blocks(long long work, int threads) {
    unsigned b = babble_blocks(work, threads);
    return b < 132u * 32u ? b : 132u * 32u;
}

// Return the launch error, if any, from the enclosing entry point.
#define BABBLE_CHECK_LAUNCH()                                   \
    do {                                                        \
        cudaError_t babble_err_ = cudaGetLastError();           \
        if (babble_err_ != cudaSuccess) return (int)babble_err_; \
    } while (0)

#define BABBLE_CHECK(call)                                      \
    do {                                                        \
        cudaError_t babble_err_ = (call);                       \
        if (babble_err_ != cudaSuccess) return (int)babble_err_; \
    } while (0)

// Allow a shared-memory launch above the default 48 KB.
template <typename Kernel>
static inline cudaError_t babble_allow_smem(Kernel kernel, size_t smem) {
    if (smem <= 48 * 1024) return cudaSuccess;
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

__device__ __forceinline__ int babble_clamp(int x, int lo, int hi) {
    return x < lo ? lo : (x > hi ? hi : x);
}

// *last_level = the last row of an (l_lv, n_lvl) level table that holds an
// event (>= 0), left as it is when none does (the caller sets -1 first).
// Rows past it are all padding. Grid-stride, one atomic per warp.
__global__ void babble_last_level(const int32_t* __restrict__ levels,
                                  int32_t* last_level, long long total, int n_lvl) {
    long long stride = (long long)gridDim.x * blockDim.x;
    int best = -1;
    for (long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         k < total; k += stride) {
        if (levels[k] >= 0) best = max(best, (int)(k / n_lvl));
    }
    best = __reduce_max_sync(BABBLE_FULL_MASK, best);
    if ((threadIdx.x & 31) == 0 && best >= 0) atomicMax(last_level, best);
}

// Whether one event strongly sees a supermajority of a round's witnesses,
// decided by a whole warp:
//   |{w < n : present(w) and |{q < n : la_e[q] >= fd_rows[w * n + q]}| >= sm}| >= sm,
// the same on every lane. la_e (n,) lies in shared memory; present(w)
// reads the caller's validity table. Lanes run over q (coalesced rows)
// and count with ballots; BABBLE_WG witnesses' loads are issued before
// their ballots. The walk stops once the verdict is known (sm witnesses
// seen, or too few left to reach sm): the callers need the verdict only.
// A coordinate past n or an absent witness compares against MAX_INT32,
// which no real lastAncestors entry reaches.
#define BABBLE_WG 8
template <typename Present>
__device__ __forceinline__ bool babble_warp_sees_majority(const int32_t* la_e,
                                                          const int32_t* fd_rows, int n,
                                                          int super_majority, Present present) {
    const int lane = threadIdx.x & 31;
    int seen = 0;  // warp-uniform
    for (int w0 = 0; w0 < n; w0 += BABBLE_WG) {
        if (seen >= super_majority || seen + (n - w0) < super_majority) break;
        int cnt[BABBLE_WG];
        bool ok[BABBLE_WG];
#pragma unroll
        for (int u = 0; u < BABBLE_WG; ++u) {
            cnt[u] = 0;
            ok[u] = w0 + u < n && present(w0 + u);
        }
        for (int q0 = 0; q0 < n; q0 += 32) {
            const int q = q0 + lane;
            const int la_q = q < n ? la_e[q] : 0;
            int v[BABBLE_WG];
#pragma unroll
            for (int u = 0; u < BABBLE_WG; ++u) {
                v[u] = (ok[u] && q < n) ? fd_rows[(long long)(w0 + u) * n + q]
                                        : BABBLE_MAX_INT32;
            }
#pragma unroll
            for (int u = 0; u < BABBLE_WG; ++u) {
                cnt[u] += __popc(__ballot_sync(BABBLE_FULL_MASK, la_q >= v[u]));
            }
        }
#pragma unroll
        for (int u = 0; u < BABBLE_WG; ++u) seen += ok[u] && cnt[u] >= super_majority;
    }
    return seen >= super_majority;
}

// Every block of a co-resident grid (a cooperative launch) waits here
// until all have arrived. `count` only grows: the k-th barrier of a launch
// waits for k * gridDim.x arrivals, so a block that runs ahead to the next
// barrier cannot release a slow one early. The fences order each block's
// global writes before its arrival and the others' reads after it.
__device__ __forceinline__ void babble_grid_sync(unsigned int* count, unsigned int& target) {
    __syncthreads();
    target += gridDim.x;
    if (threadIdx.x == 0) {
        __threadfence();
        atomicAdd(count, 1u);
        while (*(volatile unsigned int*)count < target) {
        }
        __threadfence();
    }
    __syncthreads();
}

// The same barrier on a word that lives across launches and needs no
// reset: block 0 adds 2^31 - (gridDim.x - 1) and every other block 1, so
// the word's top bit flips once all have arrived and its low bits come
// back as they were (0, where the word was zeroed once when allocated).
// Takes a one-dimensional co-resident grid.
__device__ __forceinline__ void babble_grid_flip_sync(unsigned int* word) {
    __syncthreads();
    if (threadIdx.x == 0) {
        const unsigned int add = blockIdx.x == 0 ? 0x80000000u - (gridDim.x - 1) : 1u;
        __threadfence();
        const unsigned int old = atomicAdd(word, add);
        while (((old ^ *(volatile unsigned int*)word) & 0x80000000u) == 0) {
        }
        __threadfence();
    }
    __syncthreads();
}

// The least la entry in column c over the witnesses whose bits are set in
// words [k_lo, k_hi) of fw and in `mask` (witness 32 k + b for bit b of
// word k), MAX_INT32 where none is: every thread of a warp walks the same
// bits, so each load is coalesced over c, with up to eight loads of a word
// in flight. row(w) points at witness w's la row (K12: its row of la_w,
// every bit; K4 and B23: the clamped event row of la its witness table
// names, a warp every fourth bit). Carrying a batch across words measured
// slower for both (PERF.md).
template <typename Row>
__device__ __forceinline__ int babble_famous_min(const uint32_t* fw, int k_lo, int k_hi, int c,
                                                 unsigned mask, Row row) {
    int m = BABBLE_MAX_INT32;
    for (int k = k_lo; k < k_hi; ++k) {
        unsigned bits = fw[k] & mask;
        while (bits) {
            int v[8];
#pragma unroll
            for (int u = 0; u < 8; ++u) {
                v[u] = BABBLE_MAX_INT32;
                if (bits) {
                    const int w = 32 * k + __ffs(bits) - 1;
                    bits &= bits - 1;
                    v[u] = row(w)[c];
                }
            }
#pragma unroll
            for (int u = 0; u < 8; ++u) m = min(m, v[u]);
        }
    }
    return m;
}

// Asynchronous copies from global to shared memory (cp.async, sm_80 and
// up): 16 bytes through L2 only, or 4 bytes; commit and wait by group.
__device__ __forceinline__ void babble_cp_async16(void* smem, const void* gmem) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void babble_cp_async4(void* smem, const void* gmem) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void babble_cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void babble_cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Stage columns [col0, col0 + COLS) of ROWS int32 rows into a shared tile
// of row stride LD words (a multiple of 4), asynchronously: row r starts
// at rows(r) (null: the whole row is `fill`),
// columns at or past ncols get `fill`. 16-byte copies where `aligned16`
// (every row pointer 16-byte aligned, col0 a multiple of 4), else 4-byte
// copies. Every thread of the block takes part; the caller commits and
// waits.
template <int ROWS, int COLS, int LD, typename RowPtr>
__device__ __forceinline__ void babble_stage_async(int32_t* tile, RowPtr rows, int col0,
                                                   int ncols, int32_t fill, bool aligned16) {
    static_assert(COLS % 4 == 0 && LD % 4 == 0, "16-byte groups");
    for (int k = threadIdx.x; k < ROWS * (COLS / 4); k += blockDim.x) {
        const int r = k / (COLS / 4), c = (k % (COLS / 4)) * 4;
        const int32_t* src = rows(r);
        int32_t* dst = tile + r * LD + c;
        const int q = col0 + c;
        if (src != nullptr && aligned16 && q + 4 <= ncols) {
            babble_cp_async16(dst, src + q);
            continue;
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
            if (src != nullptr && q + u < ncols) babble_cp_async4(dst + u, src + q + u);
            else dst[u] = fill;
        }
    }
}

// The compare-count tile: for BM rows a_m and BN rows b_w of n int32
// coordinates each, every thread of a block of (BM / TM) x (BN / TN)
// threads counts
//   cnt[i][j] = |{q < n : a_m[q] >= b_w[q]}|,  m = ty + i * (BM / TM),
//                                              w = tx + j * (BN / TN),
// with ty = threadIdx.x / (BN / TN) and tx = threadIdx.x % (BN / TN): a
// register micro-tile of TM x TN pairs, GEMM-shaped, so that one 16-byte
// shared load of a row feeds TN (or TM) x 4 compares. The coordinate axis
// passes through shared memory BABBLE_CT_BK words at a time in a ring of
// STAGES tiles filled by cp.async (the next chunks in flight while this
// one is counted). a_rows / b_rows: shared arrays of row pointers; a null
// row, and the columns past n, hold MIN_INT32 in a and MAX_INT32 in b,
// which never compare true. Rows of a warp's pairs are strided (not
// blocked), so that the lanes of a quarter warp read eight rows in eight
// bank groups: the tile's row stride is an odd number of 16-byte units.
// smem: babble_count_tile_words<BM, BN, STAGES>() int32 words; every thread
// of the block calls this, and the tile is free again when it returns.
#define BABBLE_CT_BK 32
#define BABBLE_CT_LD 36
template <int BM, int BN, int STAGES>
__host__ __device__ constexpr int babble_count_tile_words() {
    return STAGES * (BM + BN) * BABBLE_CT_LD;
}

template <int BM, int BN, int TM, int TN, int STAGES>
__device__ __forceinline__ void babble_count_ge_tile(int32_t* smem, int n,
                                                     const int32_t* const* a_rows,
                                                     const int32_t* const* b_rows,
                                                     bool aligned16, int (&cnt)[TM][TN]) {
    constexpr int LD = BABBLE_CT_LD, BK = BABBLE_CT_BK;
    constexpr int TX = BN / TN, TY = BM / TM;
    constexpr int STAGE = (BM + BN) * LD;
    const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) cnt[i][j] = 0;
    const int chunks = (n + BK - 1) / BK;
    auto load = [&](int c) {
        int32_t* st = smem + (c % STAGES) * STAGE;
        babble_stage_async<BM, BK, LD>(st, [&](int r) { return a_rows[r]; }, c * BK, n,
                                       BABBLE_MIN_INT32, aligned16);
        babble_stage_async<BN, BK, LD>(st + BM * LD, [&](int r) { return b_rows[r]; }, c * BK,
                                       n, BABBLE_MAX_INT32, aligned16);
    };
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
        if (s < chunks) load(s);
        babble_cp_async_commit();
    }
    for (int c = 0; c < chunks; ++c) {
        babble_cp_async_wait<STAGES - 2>();
        __syncthreads();
        if (c + STAGES - 1 < chunks) load(c + STAGES - 1);
        babble_cp_async_commit();
        const int32_t* a = smem + (c % STAGES) * STAGE;
        const int32_t* b = a + BM * LD;
#pragma unroll
        for (int k = 0; k < BK; k += 4) {
            int4 av[TM], bv[TN];
#pragma unroll
            for (int i = 0; i < TM; ++i)
                av[i] = *reinterpret_cast<const int4*>(a + (ty + i * TY) * LD + k);
#pragma unroll
            for (int j = 0; j < TN; ++j)
                bv[j] = *reinterpret_cast<const int4*>(b + (tx + j * TX) * LD + k);
#pragma unroll
            for (int i = 0; i < TM; ++i)
#pragma unroll
                for (int j = 0; j < TN; ++j)
                    cnt[i][j] += (av[i].x >= bv[j].x) + (av[i].y >= bv[j].y)
                                 + (av[i].z >= bv[j].z) + (av[i].w >= bv[j].w);
        }
    }
    babble_cp_async_wait<0>();
    __syncthreads();
}

// The cooperative level walks (divide_rounds.cu dr_grid, step_levels.cu
// sl_grid, train_levels.cu tl_grid) share one work item: BABBLE_LT lanes
// of a level x BABBLE_WT witnesses, a BABBLE_TM x BABBLE_TN register tile
// per thread, the coordinate ring BABBLE_STAGES deep.
#define BABBLE_LT 8
#define BABBLE_WT 32
#define BABBLE_TM 2
#define BABBLE_TN 1
#define BABBLE_STAGES 4
#define BABBLE_LEVEL_THREADS ((BABBLE_LT / BABBLE_TM) * (BABBLE_WT / BABBLE_TN))

// Bytes of the work item's shared ring.
static inline size_t babble_level_item_smem() {
    return babble_count_tile_words<BABBLE_LT, BABBLE_WT, BABBLE_STAGES>() * sizeof(int32_t);
}

// The count phase of one work item of a cooperative level walk: the
// item's BABBLE_LT lanes against witness tile wt. On entry thread t <
// BABBLE_LT has set a_lane[t] (the lane's la row), s_pr[t] (its parent
// round) and s_todo[t] (whether it still counts) in shared memory, and the
// block has synced. For each distinct parent round p among the lanes still
// to count, one pass counts their la rows against the rows wrow(p, w) of
// the tile's witnesses (null: no witness) through the compare-count tile,
// and adds each lane's verdicts (count >= super_majority) into
// c_seen[t]. Every thread of the block calls this; the tile and the
// shared arrays are free again when it returns.
template <typename WRow>
__device__ __forceinline__ void babble_level_item(int32_t* tile, int n, int wt, bool aligned16,
                                                  int super_majority,
                                                  const int32_t* const* a_lane,
                                                  const int* s_pr, int* s_todo,
                                                  int32_t* c_seen, WRow wrow) {
    __shared__ const int32_t* a_pass[BABBLE_LT];  // this pass's lanes' la rows, else null
    __shared__ const int32_t* b_rows[BABBLE_WT];  // the pass's witnesses' rows
    __shared__ int s_add[BABBLE_LT];
    __shared__ int s_p;
    constexpr int TX = BABBLE_WT / BABBLE_TN, TY = BABBLE_LT / BABBLE_TM;
    static_assert(TX == 32, "a warp owns whole lane rows of the tile");
    const int lane = threadIdx.x & 31, ty = threadIdx.x / TX;
    while (true) {
        if (threadIdx.x == 0) {
            int p = -1;
            for (int t = 0; t < BABBLE_LT; ++t) {
                if (s_todo[t]) {
                    p = s_pr[t];
                    break;
                }
            }
            s_p = p;
        }
        __syncthreads();
        const int p = s_p;
        if (p < 0) break;  // block-uniform
        if (threadIdx.x < BABBLE_LT) {
            const bool mine = s_todo[threadIdx.x] && s_pr[threadIdx.x] == p;
            a_pass[threadIdx.x] = mine ? a_lane[threadIdx.x] : nullptr;
            s_add[threadIdx.x] = 0;
        }
        const int32_t* b = nullptr;
        if (threadIdx.x < BABBLE_WT) {
            const int w = wt * BABBLE_WT + threadIdx.x;
            b = w < n ? wrow(p, w) : nullptr;
            b_rows[threadIdx.x] = b;
        }
        const int any_b = __syncthreads_or(b != nullptr);
        if (threadIdx.x < BABBLE_LT && s_todo[threadIdx.x] && s_pr[threadIdx.x] == p) {
            s_todo[threadIdx.x] = 0;  // read again only after the next barrier
        }
        if (any_b) {
            int cnt[BABBLE_TM][BABBLE_TN];
            babble_count_ge_tile<BABBLE_LT, BABBLE_WT, BABBLE_TM, BABBLE_TN, BABBLE_STAGES>(
                tile, n, a_pass, b_rows, aligned16, cnt);
#pragma unroll
            for (int m = 0; m < BABBLE_TM; ++m) {
                const int r = ty + m * TY;
                const unsigned v = __ballot_sync(
                    BABBLE_FULL_MASK, a_pass[r] != nullptr && b_rows[lane] != nullptr
                                          && cnt[m][0] >= super_majority);
                if (lane == 0) s_add[r] = __popc(v);
            }
            __syncthreads();
            if (threadIdx.x < BABBLE_LT && s_add[threadIdx.x] > 0) {
                atomicAdd(c_seen + threadIdx.x, s_add[threadIdx.x]);
            }
        }
        __syncthreads();  // the pass's rows are rewritten next
    }
}

// The block count of a cooperative launch of `kernel`: as many blocks as
// the card holds at once (a grid barrier needs every block running), at
// most `items`. cudaErrorCooperativeLaunchTooLarge where not one block fits.
template <typename Kernel>
static inline cudaError_t babble_coop_blocks(Kernel kernel, int threads, size_t smem,
                                             int device, long long items, int* blocks) {
    int per_sm = 0, sms = 0;
    cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                                    smem);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    long long g = (long long)per_sm * sms;
    if (g > items) g = items;
    if (g < 1) return cudaErrorCooperativeLaunchTooLarge;
    *blocks = (int)g;
    return cudaSuccess;
}

// Whether every row a compare-count tile stages from `base` (rows of n
// int32 words) starts on 16 bytes, so that cp.async may copy 16 at a time.
__host__ __device__ __forceinline__ bool babble_rows_aligned16(const void* base, int n) {
    return (n & 3) == 0 && (reinterpret_cast<uintptr_t>(base) & 15) == 0;
}

// The max of int32 values kept in an unsigned word that starts at 0 (a
// zeroed scratch): atomicMax on v ^ 2^31 orders as the signed values, and
// 0 stands for MIN_INT32.
__device__ __forceinline__ unsigned babble_max_key(int v) {
    return static_cast<unsigned>(v) ^ 0x80000000u;
}
__device__ __forceinline__ int babble_max_of_key(unsigned k) {
    return static_cast<int>(k ^ 0x80000000u);
}

// The end of a cooperative walk whose every block has added its share
// into global accumulators (each thread that added fenced first): true in
// the one block that arrives last at `ticket` (a word that starts at 0),
// after which that block reads every block's share.
__device__ __forceinline__ bool babble_last_block(unsigned int* ticket) {
    __shared__ int s_last;
    __syncthreads();
    if (threadIdx.x == 0) {
        __threadfence();
        s_last = atomicAdd(ticket, 1u) == gridDim.x - 1;
    }
    __syncthreads();
    if (s_last) __threadfence();
    return s_last;
}

// ---------------------------------------------------------------------------
// The staged level walk of the narrow level scans (divide_rounds.cu
// dr_staged, lamport_scan.cu lam_staged): one block walks every level of a
// level table whose cells (level, lane) a parallel prep launch has packed
// into records: everything the walk reads that does not depend on its
// carry, level after level, `level_words` int32 words a level (a multiple
// of 4). Warp 0 is the producer: its first lane copies the records of
// `chunk` levels at a time into a ring of `stages` slots in shared memory with a
// bulk copy (cp.async.bulk, its bytes counted on the slot's `full`
// mbarrier), up to `stages` chunks ahead, and waits on the slot's `empty`
// mbarrier (one arrival per consumer warp) before it refills it. Warps 1
// .. `warps` consume the levels in order out of the ring, so they never
// wait on device memory for a record; each level is a read phase (every
// lane's new values from the carry as it stood), a sync, a write phase and
// a sync, among the consumer warps only: __syncwarp where one warp holds
// the level, else a named barrier (barrier.sync 1) that the producer and the
// block's spare warps stay out of. A consumer may overwrite a field of its
// lane's record in the slot to carry a value from the read phase to the
// write phase; it fences those generic writes against the next bulk copy
// into the slot (fence.proxy.async) before its warp releases the slot.
// Where `slots` is null (a level too wide for the ring) the consumers read
// and write the records in place in the device table and nothing is
// copied.
// ---------------------------------------------------------------------------

__device__ __forceinline__ unsigned babble_smem_u32(const void* p) {
    return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void babble_mbar_init(uint64_t* bar, unsigned count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(babble_smem_u32(bar)),
                 "r"(count)
                 : "memory");
}
__device__ __forceinline__ void babble_mbar_init_fence() {
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void babble_mbar_arrive(uint64_t* bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(babble_smem_u32(bar))
                 : "memory");
}
__device__ __forceinline__ void babble_mbar_expect_tx(uint64_t* bar, unsigned bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                     babble_smem_u32(bar)),
                 "r"(bytes)
                 : "memory");
}
// Wait until the phase of parity `parity` of the mbarrier has completed.
__device__ __forceinline__ void babble_mbar_wait(uint64_t* bar, unsigned parity) {
    const unsigned a = babble_smem_u32(bar);
    unsigned done = 0;
    while (!done) {
        asm volatile(
            "{\n"
            ".reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n"
            "}\n"
            : "=r"(done)
            : "r"(a), "r"(parity)
            : "memory");
    }
}
// One bulk copy of `bytes` (a multiple of 16, both addresses 16-byte
// aligned) from device to shared memory, completing on `bar`.
__device__ __forceinline__ void babble_bulk_load(void* smem, const void* gmem, unsigned bytes,
                                                 uint64_t* bar) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
        "[%3];\n" ::"r"(babble_smem_u32(smem)),
        "l"(gmem), "r"(bytes), "r"(babble_smem_u32(bar))
        : "memory");
}
__device__ __forceinline__ void babble_fence_proxy_async() {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// The consumer warps' sync between the phases of a level.
__device__ __forceinline__ void babble_consumer_sync(int warps) {
    if (warps == 1) {
        __syncwarp();
        return;
    }
    asm volatile("barrier.sync 1, %0;\n" ::"r"(warps * 32) : "memory");
}

// A carry whose first `chip` entries lie in shared memory (`s`) and the
// rest in device memory (`g`, the output itself, read and written by this
// block alone). Each access selects between a shared-memory and a device
// load (not between pointers), so that the compiler keeps the shared one
// a shared-memory instruction.
struct BabbleSplit {
    int32_t* s;
    int32_t* g;
    int chip;
    __device__ __forceinline__ int ld(int i) const { return i < chip ? s[i] : g[i]; }
    __device__ __forceinline__ void st(int i, int v) const {
        if (i < chip) s[i] = v;
        else g[i] = v;
    }
    // carry[i] for an in-grid parent (i >= 0), else `ext`
    __device__ __forceinline__ int parent(int i, int ext) const {
        const int v = ld(max(i, 0));
        return i >= 0 ? v : ext;
    }
    // the same through one generic load (K8's level has nothing else to
    // overlap with its two carry reads)
    __device__ __forceinline__ int parent_generic(int i, int ext) const {
        const int k = max(i, 0);
        const int v = *(k < chip ? s + k : g + k);
        return i >= 0 ? v : ext;
    }
};

struct BabbleRing {
    int32_t* slots;   // stages x chunk levels of records in shared memory; null: in place
    uint64_t* full;   // per slot: its bytes have landed
    uint64_t* empty;  // per slot: every consumer warp is done with it
    int32_t* table;   // the packed level table in device memory
    int stages, chunk, level_words, levels;  // levels: the last level holding an event + 1
};

// Dynamic shared memory bytes of the ring and its mbarriers.
__host__ __device__ __forceinline__ long long babble_ring_bytes(int stages, int chunk,
                                                                int level_words, int staged) {
    return 16LL * stages + (staged ? 4LL * stages * chunk * level_words : 0);
}

// Carve the ring out of the front of `smem`; returns the next free word.
__device__ __forceinline__ int32_t* babble_ring_carve(BabbleRing& r, unsigned char* smem,
                                                      int staged) {
    r.full = reinterpret_cast<uint64_t*>(smem);
    r.empty = r.full + r.stages;
    int32_t* p = reinterpret_cast<int32_t*>(r.empty + r.stages);
    r.slots = staged ? p : nullptr;
    return staged ? p + (long long)r.stages * r.chunk * r.level_words : p;
}

// Thread 0 initialises the mbarriers; the caller syncs the block after.
__device__ __forceinline__ void babble_ring_init(const BabbleRing& r, int warps) {
    if (threadIdx.x != 0 || r.slots == nullptr) return;
    for (int s = 0; s < r.stages; ++s) {
        babble_mbar_init(r.full + s, 1);
        babble_mbar_init(r.empty + s, warps);
    }
    babble_mbar_init_fence();
}

// The producer: the whole of warp 0, lane 0 issuing (the warp stays
// converged, so that it meets the block's closing __syncthreads whole).
__device__ __forceinline__ void babble_ring_produce(const BabbleRing& r) {
    if (r.slots == nullptr) return;
    const int chunks = (r.levels + r.chunk - 1) / r.chunk;
    const long long slot_words = (long long)r.chunk * r.level_words;
    for (int k = 0; k < chunks; ++k) {
        const int s = k % r.stages;
        if (k >= r.stages) babble_mbar_wait(r.empty + s, ((k / r.stages) - 1) & 1);
        if ((threadIdx.x & 31) == 0) {
            const int nl = min(r.chunk, r.levels - k * r.chunk);
            const unsigned bytes = (unsigned)nl * (unsigned)r.level_words * 4u;
            babble_mbar_expect_tx(r.full + s, bytes);
            babble_bulk_load(r.slots + s * slot_words, r.table + k * slot_words, bytes,
                             r.full + s);
        }
        __syncwarp();
    }
}

// The consumers: every thread of warps 1 .. warps calls chunk(records,
// first level, levels) for each chunk of levels in order, with the same
// control flow (the chunk function syncs the consumers after each level).
// STAGED: the records stream through the ring (r.slots), so that the
// compiler sees them in shared memory; else they are read in place.
template <bool STAGED, typename Chunk>
__device__ __forceinline__ void babble_ring_consume(const BabbleRing& r, Chunk chunk) {
    const int chunks = (r.levels + r.chunk - 1) / r.chunk;
    const long long slot_words = (long long)r.chunk * r.level_words;
    for (int k = 0; k < chunks; ++k) {
        const int s = k % r.stages;
        int32_t* base;
        if (STAGED) {
            babble_mbar_wait(r.full + s, (k / r.stages) & 1);
            base = r.slots + s * slot_words;
        } else {
            base = r.table + k * slot_words;
        }
        chunk(base, k * r.chunk, min(r.chunk, r.levels - k * r.chunk));
        if (STAGED) {
            babble_fence_proxy_async();
            __syncwarp();
            if ((threadIdx.x & 31) == 0) babble_mbar_arrive(r.empty + s);
        }
    }
}

// The lamport recurrence's record of a cell whose row is `row` (-1:
// padding): {row, s, o, x}, the new lamport number being
//   max(s >= 0 ? carry[s] : MIN, o >= 0 ? carry[o] : MIN, x) + 1
// with int32 wrap-around. s, o: the in-grid parents clamped to e - 1, else
// -1, x the largest external parent lamport (MIN where both parents lie in
// the grid); a pin p != MIN gives s = o = -1 and x = p - 1, so that the
// value is p. These are the reference's values exactly: max(sp_lt, op_lt)
// + 1, or the pin.
__device__ __forceinline__ int4 babble_lamport_record(int row, const int32_t* sp,
                                                      const int32_t* op, const int32_t* esp,
                                                      const int32_t* eop, const int32_t* pin,
                                                      int e) {
    if (row < 0) return make_int4(-1, -1, -1, 0);
    const int r = min(row, e - 1);
    const int pn = pin[r];
    if (pn != BABBLE_MIN_INT32) return make_int4(row, -1, -1, pn - 1);
    const int s = sp[r], o = op[r];
    int x = BABBLE_MIN_INT32;
    if (s < 0) x = max(x, esp[r]);
    if (o < 0) x = max(x, eop[r]);
    return make_int4(row, s >= 0 ? min(s, e - 1) : -1, o >= 0 ? min(o, e - 1) : -1, x);
}

// The lamport walk (K8, and the lamport half of K5's walk): `warps`
// consumer warps, a thread per lane of the level, the carry (E int32, from
// `init`) in shared memory for its first `chip` rows. ONE: every lane has
// its own thread (n_lvl <= 32 warps), and a level is straight-line code,
// the next level's record loaded while this one waits on its carry; else
// a wider level takes several passes, a pass's values held in the lanes'
// records.
struct BabbleLamWalk {
    const int32_t* last_level;
    int32_t* table;  // (levels, n_lvl) records of babble_lamport_record
    int32_t* lam;    // (E,) the output, the carry's rows from `chip` on
    int n_lvl, init, warps, chunk, stages, staged, chip;
};

__host__ __device__ __forceinline__ long long babble_lamport_walk_bytes(const BabbleLamWalk& a) {
    return babble_ring_bytes(a.stages, a.chunk, 4 * a.n_lvl, a.staged) + 4LL * a.chip;
}

template <bool ONE>
__device__ __forceinline__ void babble_lamport_walk(const BabbleLamWalk& a, unsigned char* smem) {
    BabbleRing ring{nullptr, nullptr, nullptr, a.table, a.stages, a.chunk, 4 * a.n_lvl,
                    *a.last_level + 1};
    int32_t* s_lam = babble_ring_carve(ring, smem, a.staged);
    const BabbleSplit lam{s_lam, a.lam, a.chip};
    for (int k = threadIdx.x; k < a.chip; k += blockDim.x) s_lam[k] = a.init;
    babble_ring_init(ring, a.warps);
    __syncthreads();
    const int warp = threadIdx.x >> 5;
    if (warp == 0) {
        babble_ring_produce(ring);
    } else if (warp <= a.warps) {
        const int t = threadIdx.x - 32, nt = a.warps * 32, n_lvl = a.n_lvl;
        auto levels = [&](int32_t* base, int, int nl) {
            if (ONE) {
                const int4* rec = reinterpret_cast<const int4*>(base) + t;
                const bool act = t < n_lvl;
                int4 next = act ? rec[0] : make_int4(-1, -1, -1, 0);
                for (int j = 0; j < nl; ++j) {
                    const int4 r = next;
                    if (act && j + 1 < nl) next = rec[(j + 1) * n_lvl];
                    // read phase: the value from the carry as it stood
                    const int v =
                        (int)((unsigned)max(max(lam.parent_generic(r.y, BABBLE_MIN_INT32),
                                                lam.parent_generic(r.z, BABBLE_MIN_INT32)),
                                            r.w) + 1u);
                    babble_consumer_sync(a.warps);
                    if (r.x >= 0) lam.st(r.x, v);  // padding lanes write nothing
                    babble_consumer_sync(a.warps);
                }
                return;
            }
            const int passes = (n_lvl + nt - 1) / nt;
            for (int j = 0; j < nl; ++j) {
                int32_t* rec = base + (long long)j * 4 * n_lvl;
                for (int p = 0; p < passes; ++p) {
                    const int i = t + p * nt;
                    if (i >= n_lvl) break;
                    const int4 r = reinterpret_cast<const int4*>(rec)[i];
                    if (r.x < 0) continue;
                    rec[4 * i + 3] = (int)((unsigned)max(max(lam.parent(r.y, BABBLE_MIN_INT32),
                                                             lam.parent(r.z, BABBLE_MIN_INT32)),
                                                         r.w) + 1u);
                }
                babble_consumer_sync(a.warps);
                for (int p = 0; p < passes; ++p) {
                    const int i = t + p * nt;
                    if (i >= n_lvl) break;
                    if (rec[4 * i] >= 0) lam.st(rec[4 * i], rec[4 * i + 3]);
                }
                babble_consumer_sync(a.warps);
            }
        };
        if (a.staged) babble_ring_consume<true>(ring, levels);
        else babble_ring_consume<false>(ring, levels);
    }
    __syncthreads();
    for (int k = threadIdx.x; k < a.chip; k += blockDim.x) a.lam[k] = s_lam[k];
}
