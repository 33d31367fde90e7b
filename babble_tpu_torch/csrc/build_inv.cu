// build_inv: the frontier walk's threshold tables.
//
// Replaces babble_tpu/tpu/frontier.py:116 build_inv (a JAX scatter-min
// into value slots, then a log-step suffix_min over the value axis).
//
//   INV[c, p, v] = first chain-c index i whose p-coordinate
//                  min(la[rows_by[c, i], p], L-1) >= v,  L = "never";
//   padded chain slots (rows_by < 0) and absent coordinates (la < 0)
//   contribute nothing (the reference's dropped slot v = L); a row past E
//   is clamped to E - 1, as the reference's gather clamps.
//
// The same integers by a running maximum, exact on any input: with M[c, i,
// p] the maximum over i' <= i of the clamped coordinate (-1 for a padded
// slot or an absent coordinate), M is non-decreasing in i, so INV[c, p, v]
// is the first i with M[c, i, p] >= v (the count of i with M < v), and L
// where none reaches v.
//
// Bound: bytes. la read once (the rows the chain table names) and INV
// written once: 8.4 + 16.8 = 25.2 MB at the bench cell (64 validators, L =
// 1,024), 7.6 us at 3.35 TB/s.
//
// Design: one launch, each INV word written once, no atomic and no fill
// pass. A block takes chain c, a tile of BI_COLS coordinates and a segment
// of the chain's indices, BI_CHUNK indices at a time: the chunk's rows_by
// entries into shared memory (the next chunk's loaded while this one
// works); its la rows, 128 B each and coalesced over the tile, clamped and
// carried down each column as a running maximum in registers (a warp a
// slice of the chunk, every load of the slice in flight before the first
// is used, then the slices' maxima) into a column-major table; then a warp
// a column writes that column's run of v in (carry, chunk maximum] along
// v, coalesced, each lane BI_ILP lower-bound searches of its v in the
// column's maxima at once. The carry is the column's maximum so far. The
// slots above the chain's final maximum get L. Shared memory is one
// chunk's, the same at every L.
//
// Where chains x tiles leave the card idle (few chains, long chains: the
// catch-up section's 8 x 1), the chain axis is split into segments
// (tpu/_ext.py build_inv_plan) in one cooperative launch: a segment's block
// first takes its rows' column maxima and publishes them, each a 64-bit
// word tagged with the call's epoch in its high half (the word is its own
// flag: no flag to reset, no atomic), then reads every segment's word,
// BI_LOOK at a time: the maximum of the segments before it is its carry,
// the maximum of all of them the chain's final maximum. It writes as above
// (a segment of one chunk keeps its table; a longer one reads its la rows
// again, from L2), then its share of the slots above the final maximum,
// so that no one segment fills them all.

#include "common.cuh"

#define BI_THREADS 256
#define BI_MIN_BLOCKS 4                // blocks an SM: the plan's reach
#define BI_WARPS (BI_THREADS / 32)
#define BI_CHUNK 128                   // chain indices a block stages at once
#define BI_COLS 32                     // coordinates a tile: a lane each
#define BI_LD (BI_CHUNK + 1)           // a column's stride: conflict-free walks
#define BI_SLICE (BI_CHUNK / BI_WARPS)  // a warp's rows of a chunk
#define BI_ILP 2                       // searches in flight a lane
#define BI_LOOK 8                      // segment words in flight a thread

struct BiArgs {
    const int32_t* rows_by;
    const int32_t* la;
    int32_t* inv;
    // the segmented form: (blocks, BI_COLS) tagged segment maxima
    unsigned long long* seg_max;
    int n_c, l, n_p, e, tiles, segments, seg_len;
    unsigned epoch;
};

struct BiShared {
    int32_t m[BI_COLS * BI_LD];        // the chunk's running maxima, column-major
    int32_t rows[BI_CHUNK];            // the chunk's la rows (-1: nothing)
    int32_t part[BI_WARPS][BI_COLS];   // each warp's slice maximum
    int32_t carry[BI_COLS];            // each column's maximum before the chunk
    int32_t top[BI_COLS];              // and after it
    int32_t fin[BI_COLS];              // and at the chain's end
};

// This thread's la row of chunk [i0, i0 + cl) of chain c (threads below
// BI_CHUNK, one index each; -1: a padded slot, past cl or no rows). The
// caller loads the next chunk's while it works on this one.
__device__ __forceinline__ int bi_row(const BiArgs& a, int c, int i0, int cl) {
    const int tid = threadIdx.x;
    if (tid >= BI_CHUNK || tid >= cl || a.e <= 0) return -1;
    const int r = a.rows_by[(long long)c * a.l + i0 + tid];
    return r < 0 ? -1 : min(r, a.e - 1);  // the reference's gather clamps
}

// Stage a chunk for the tile at p0 from its rows (`row`, bi_row's): the
// running maxima of the clamped coordinates from each column's carry into
// sh.m and the chunk's last into sh.top.
__device__ void bi_chunk(BiShared& sh, const BiArgs& a, int p0, int row) {
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    __syncthreads();  // the last chunk's writes are done with sh.m and sh.rows
    if (tid < BI_CHUNK) sh.rows[tid] = row;
    __syncthreads();
    const int p = p0 + lane;
    const bool col = p < a.n_p;
    int v[BI_SLICE];
#pragma unroll
    for (int k = 0; k < BI_SLICE; ++k) {
        const int r = sh.rows[warp * BI_SLICE + k];
        v[k] = col && r >= 0 ? __ldg(a.la + (long long)r * a.n_p + p) : -1;
    }
    int run = -1;
#pragma unroll
    for (int k = 0; k < BI_SLICE; ++k) {
        run = max(run, v[k] < 0 ? -1 : min(v[k], a.l - 1));
        v[k] = run;
    }
    sh.part[warp][lane] = run;
    __syncthreads();
    int off = sh.carry[lane];
    for (int q = 0; q < warp; ++q) off = max(off, sh.part[q][lane]);
#pragma unroll
    for (int k = 0; k < BI_SLICE; ++k) sh.m[lane * BI_LD + warp * BI_SLICE + k] = max(off, v[k]);
    if (warp == BI_WARPS - 1) sh.top[lane] = max(off, run);
    __syncthreads();
}

// Each column's run v in (carry, top] of chunk i0 (a warp a column, lanes
// along v, BI_ILP searches in flight a lane), then carry = top.
__device__ void bi_write(BiShared& sh, const BiArgs& a, int c, int p0, int i0) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    for (int q = warp; q < BI_COLS; q += BI_WARPS) {
        const int p = p0 + q;
        const int lo = sh.carry[q] + 1, hi = sh.top[q];
        if (p < a.n_p) {
            int32_t* out = a.inv + ((long long)c * a.n_p + p) * a.l;
            const int32_t* col = sh.m + q * BI_LD;
            for (int v0 = lo + lane; v0 <= hi; v0 += 32 * BI_ILP) {
                // the first j with col[j] >= v (one exists: col[BI_CHUNK - 1]
                // = hi; a v past hi searches in range and is not written)
                int j[BI_ILP];
#pragma unroll
                for (int u = 0; u < BI_ILP; ++u) j[u] = 0;
#pragma unroll
                for (int step = BI_CHUNK / 2; step > 0; step >>= 1) {
#pragma unroll
                    for (int u = 0; u < BI_ILP; ++u) {
                        if (col[j[u] + step - 1] < v0 + 32 * u) j[u] += step;
                    }
                }
#pragma unroll
                for (int u = 0; u < BI_ILP; ++u) {
                    if (v0 + 32 * u <= hi) out[v0 + 32 * u] = i0 + j[u];
                }
            }
        }
        __syncwarp();
        if (lane == 0) sh.carry[q] = hi;
    }
}

// This segment's share (s of `segments` equal parts) of the slots above
// each column's final maximum: L.
__device__ void bi_fill(BiShared& sh, const BiArgs& a, int c, int p0, int s, int segments,
                        const int32_t* fins) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    __syncthreads();
    for (int q = warp; q < BI_COLS; q += BI_WARPS) {
        const int p = p0 + q;
        if (p >= a.n_p) continue;
        const int fin = fins[q], len = a.l - 1 - fin;
        const int lo = fin + 1 + (int)((long long)len * s / segments);
        const int hi = fin + 1 + (int)((long long)len * (s + 1) / segments);
        int32_t* out = a.inv + ((long long)c * a.n_p + p) * a.l;
        for (int v = lo + lane; v < hi; v += 32) out[v] = a.l;
    }
}

// Segment s's carry (the maximum of the segments before it) and the
// column's final maximum, from every segment's published maximum (words
// at `col`, a segment's BI_COLS apart; this segment's is `mine`), BI_LOOK
// words in flight.
__device__ void bi_segment_max(const BiArgs& a, const unsigned long long* col, int s, int mine,
                               int& carry, int& fin) {
    carry = -1;
    fin = mine;
    for (int q0 = 0; q0 < a.segments; q0 += BI_LOOK) {
        unsigned long long w[BI_LOOK];
#pragma unroll
        for (int u = 0; u < BI_LOOK; ++u) {
            const int q = q0 + u;
            w[u] = q < a.segments && q != s
                       ? *(const volatile unsigned long long*)(col + (long long)q * BI_COLS)
                       : 0ull;
        }
#pragma unroll
        for (int u = 0; u < BI_LOOK; ++u) {
            const int q = q0 + u;
            if (q >= a.segments || q == s) continue;
            while ((unsigned)(w[u] >> 32) != a.epoch) {
                w[u] = *(const volatile unsigned long long*)(col + (long long)q * BI_COLS);
            }
            const int v = (int)(unsigned)w[u];
            fin = max(fin, v);
            if (q < s) carry = max(carry, v);
        }
    }
}

template <bool SEGMENTED>
__global__ void __launch_bounds__(BI_THREADS, BI_MIN_BLOCKS) inv_walk(BiArgs a) {
    __shared__ BiShared sh;
    const int tid = threadIdx.x;
    const long long b = blockIdx.x;
    const int s = SEGMENTED ? (int)(b % a.segments) : 0;
    const long long ct = SEGMENTED ? b / a.segments : b;
    const int c = (int)(ct / a.tiles), p0 = (int)(ct % a.tiles) * BI_COLS;
    const int i_lo = s * a.seg_len, i_hi = min(i_lo + a.seg_len, a.l);
    if (tid < BI_COLS) sh.carry[tid] = -1;
    bool kept = false;
    int row = bi_row(a, c, i_lo, min(BI_CHUNK, i_hi - i_lo));
    if (SEGMENTED) {
        // this segment's column maxima
        kept = i_hi - i_lo <= BI_CHUNK;
        int first = row;
        for (int i0 = i_lo; i0 < i_hi; i0 += BI_CHUNK) {
            const int nx = i0 + BI_CHUNK;
            const int next = nx < i_hi ? bi_row(a, c, nx, min(BI_CHUNK, i_hi - nx)) : first;
            bi_chunk(sh, a, p0, row);
            if (tid < BI_COLS) sh.carry[tid] = sh.top[tid];
            row = next;  // past the last chunk: the first again, for the writes
        }
        if (tid < BI_COLS) {
            // every segment's maximum published, then read back: the carry
            // and the column's final maximum
            const int mine = sh.carry[tid];
            unsigned long long* col = a.seg_max + ct * a.segments * BI_COLS + tid;
            *(volatile unsigned long long*)(col + (long long)s * BI_COLS) =
                ((unsigned long long)a.epoch << 32) | (unsigned)mine;
            int carry, fin;
            bi_segment_max(a, col, s, mine, carry, fin);
            sh.carry[tid] = carry;
            sh.fin[tid] = fin;
            if (kept) {
                // the kept chunk's maxima and top, raised to the carry
                int32_t* m = sh.m + tid * BI_LD;
                for (int j = 0; j < BI_CHUNK; ++j) m[j] = max(m[j], carry);
                sh.top[tid] = max(mine, carry);
            }
        }
        __syncthreads();
    }
    for (int i0 = i_lo; i0 < i_hi; i0 += BI_CHUNK) {
        if (!kept) {
            const int nx = i0 + BI_CHUNK;
            const int next = nx < i_hi ? bi_row(a, c, nx, min(BI_CHUNK, i_hi - nx)) : -1;
            bi_chunk(sh, a, p0, row);
            row = next;
        }
        bi_write(sh, a, c, p0, i0);
    }
    // the final maxima: read back (segmented), or the last chunk's tops
    bi_fill(sh, a, c, p0, s, SEGMENTED ? a.segments : 1, SEGMENTED ? sh.fin : sh.carry);
}

// `tiles`, `segments` and `seg_len` as tpu/_ext.py build_inv_plan gives
// them; seg_max (blocks * BI_COLS words, zeroed once when allocated) and
// `epoch` (never 0, new each call) for the segmented form.
extern "C" int babble_build_inv(const int32_t* rows_by, const int32_t* la, int32_t* inv,
                                unsigned long long* seg_max, int n_c, int l, int n_p, int e,
                                int tiles, int segments, int seg_len, int epoch,
                                int device, void* stream) {
    BABBLE_CHECK(cudaSetDevice(device));
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (n_c < 1 || l < 1 || n_p < 1 || e < 0 || tiles != (n_p + BI_COLS - 1) / BI_COLS ||
        segments < 1 || seg_len < 1 || seg_len % BI_CHUNK != 0 ||
        (long long)segments * seg_len < l || (long long)(segments - 1) * seg_len >= l ||
        (segments > 1 && (seg_max == nullptr || epoch == 0))) {
        return (int)cudaErrorInvalidValue;
    }
    const BiArgs a{rows_by, la, inv, seg_max, n_c, l, n_p, e, tiles, segments, seg_len,
                   (unsigned)epoch};
    const long long blocks = (long long)n_c * tiles * segments;
    if (segments == 1) {
        inv_walk<false><<<(unsigned)blocks, BI_THREADS, 0, s>>>(a);
        BABBLE_CHECK_LAUNCH();
        return 0;
    }
    // a segment waits for every other segment's maxima: every block
    // resident at once
    int resident = 0;
    BABBLE_CHECK(babble_coop_blocks(inv_walk<true>, BI_THREADS, 0, device, blocks, &resident));
    if (resident < blocks) return (int)cudaErrorCooperativeLaunchTooLarge;
    BiArgs arg = a;
    void* params[] = {&arg};
    BABBLE_CHECK(cudaLaunchCooperativeKernel((const void*)inv_walk<true>, dim3((unsigned)blocks),
                                             dim3(BI_THREADS), params, 0, s));
    BABBLE_CHECK_LAUNCH();
    return 0;
}
