// closure_la: lastAncestors by pointer doubling, every pass in one
// cooperative launch.
//
// Replaces babble_tpu/tpu/doubling.py:172 _closure_la (a while_loop of
// chain-prefix + squaring passes over the parent successor tables). With
// every coordinate a per-chain index:
//   la0[e, q]  = index(e) if creator(e) = q, and each parent's own
//                coordinate on the parent's chain (-1 elsewhere);
//   pass:  P[c, i, q] = max over i' <= i of la[rows_by[c, i'], q] (-1 for
//                an empty slot), the prefix down every self-chain;
//          pre[e] = P[creator(e), index(e)] (rows with index < 0 keep la[e]);
//          la'[e, q] = max(pre[e, q], max over p with pre[e, p] >= 0 of
//                          pre[rows_by[p, pre[e, p]], q]);
//          changed = any(la' != la)   (against the iterate BEFORE the prefix)
// until nothing changes or pass_cap passes have run; the pass count is part
// of the result.
//
// Bound: operations, and the passes are dependent. A pass does N*l*N
// maxima for the prefix and up to E*N*N for the squaring, against E*N int32
// of output; at 256 validators and 65,536 rows that is up to 4.3 G maxima
// per pass, about 64 us at 67 T/s.
//
// Design: one cooperative launch runs every pass to the fixed point or
// pass_cap, three grid barriers a pass; the changed flag of each pass is
// reduced on the device, every block reads it after the pass's last
// barrier (a uniform exit), and the pass count is written to device
// memory, which the host reads once. Rows are kept with a stride of n
// rounded up to 4 words (padding -1), so every row moves 16 bytes a load.
//   setup   la0 into the first iterate; the tables that do not change
//           between passes: top[c], chain c's last slot that holds a row
//           (past it P repeats P[c, top[c]], so P is computed up to it and
//           every slot code is clamped to it), TS[p, x], where the
//           squaring finds the vector of target slot (p, x) (the P slot of
//           the target row, or its own iterate row when it lies off every
//           chain), the row each chain slot owns (rows_by[c, i] = e with
//           creator(e) = c and index(e) = i), each other ("loose") row's
//           own source, and ident[p], the length of chain p's prefix whose
//           target slots are their own P slots (the whole chain on a
//           staged section), where the squaring addresses P directly.
//   prefix  P in chain order (N, l, N), the coordinates the coalesced
//           axis, scanned by segments of each chain up to its top slot:
//           (a) each segment's maximum, a thread per (K slots,
//           coordinate); (b) each segment again, carried in from the
//           earlier segments' maxima.
//   square  tiles of consecutive slots of one chain (and tiles of the
//           loose rows): the block first turns each (row, p) of the tile
//           into its target vector's code (its row in one store that
//           holds P and both iterates; TS read once a tile, not once a
//           lane), then a thread takes four consecutive rows at four
//           coordinates. P is non-decreasing down a chain, so for each p
//           the four rows' targets are non-decreasing: the thread loads
//           the vector of each distinct target once and keeps it in
//           registers for the rows that repeat it (the tile's other row
//           groups find it in L1). Tiles go to blocks index-major (every
//           chain at the same slots at once), so the targets in flight lie
//           in a narrow band of P, which stays in L2. Writes the second
//           iterate (every row reads the previous one, as the reference's
//           blocked map does) and flags a changed row.
// Data written during the launch is read after the grid barrier that
// follows its writes, whose fences order them (on sm_90 the fence also
// invalidates the SM's L1, so the loads may be cached there).
//
// Launches per call: one, after a memset of its counters.

#include "common.cuh"

// threads of every block
#define CL_THREADS 256
// rows a thread of the squaring takes
#define CL_ROWS 4
// slots a thread of the prefix takes, at most
#define CL_K_MAX 16
// blocks an SM holds at once (64 registers a thread)
#define CL_MIN_BLOCKS 4
// a loose row's "own source" when a chain slot owns the row
#define CL_OWNED BABBLE_MIN_INT32
// a target code where a row skips a coordinate
#define CL_NONE -1

struct ClPlan {
    int ld;      // row stride: n rounded up to 4
    int ql;      // prefix: coordinate lanes (sl = CL_THREADS / ql slot lanes)
    int k;       // prefix: slots a thread takes (a segment is sl * k slots)
    int groups;  // prefix: segments a chain (l / segment)
    int ql4;     // square: 16-byte coordinate lanes (rg = CL_THREADS / ql4 row groups)
    int tile;    // square: rows a tile (rg * CL_ROWS)
};

__device__ __forceinline__ int4 cl_max4(int4 a, int4 b) {
    return make_int4(max(a.x, b.x), max(a.y, b.y), max(a.z, b.z), max(a.w, b.w));
}

// one coordinate of chain slot s's value for the prefix
__device__ __forceinline__ int cl_slot_val(const int32_t* __restrict__ rows_by,
                                           const int32_t* cur, long long s, int q, int e,
                                           int ld) {
    const int r = rows_by[s];
    return r >= 0 ? cur[(long long)min(r, e - 1) * ld + q] : -1;
}

__global__ void __launch_bounds__(CL_THREADS, CL_MIN_BLOCKS) cl_walk(
    const int32_t* __restrict__ creator, const int32_t* __restrict__ index,
    const int32_t* __restrict__ sp, const int32_t* __restrict__ op,
    const int32_t* __restrict__ rows_by, int32_t* store, int32_t* tot, int32_t* tables,
    int32_t* counters, int e, int n, int l, int pass_cap, ClPlan plan) {
    extern __shared__ int32_t smem[];
    const int ld = plan.ld;
    // the vectors, rows of ld words: P's n * l slots, then the two iterates
    // (a vector's "code" is its row here)
    const long long nl = (long long)n * l;
    int32_t* pt = store;
    int32_t* buf = store + nl * ld;
    const int tid = threadIdx.x;
    const long long stride = (long long)gridDim.x * blockDim.x;
    const long long gtid = (long long)blockIdx.x * blockDim.x + tid;
    unsigned int* bar = reinterpret_cast<unsigned int*>(counters);
    unsigned int bar_target = 0;
    int32_t* passes_out = counters + 1;
    int32_t* changed = counters + 2;
    int32_t* top = changed + pass_cap;  // zeroed with the counters
    // constant tables: TS (n, l), the slots' rows (n, l), the loose rows'
    // own sources (e), ident (n)
    int32_t* ts = tables;
    int32_t* slot_row = ts + (long long)n * l;
    int32_t* loose = slot_row + (long long)n * l;
    int32_t* ident = loose + e;

    // --- setup
    for (long long k = gtid; k < (long long)e * ld; k += stride) {
        const int ev = (int)(k / ld), q = (int)(k % ld);
        int v = -1;
        if (q < n) {
            const int idx = index[ev];
            if (creator[ev] == q && idx >= 0) v = idx;
            const int s = sp[ev];
            if (s >= 0) {
                const int r = min(s, e - 1);
                if (creator[r] == q) v = max(v, index[r]);
            }
            const int o = op[ev];
            if (o >= 0) {
                const int r = min(o, e - 1);
                if (creator[r] == q) v = max(v, index[r]);
            }
        }
        buf[k] = v;
    }
    for (long long s = gtid; s < (long long)n * l; s += stride) {
        const int p = (int)(s / l), x = (int)(s % l);
        const int r = rows_by[s];
        if (r >= 0) atomicMax(top + p, x);
        slot_row[s] = (r >= 0 && r < e && creator[r] == p && index[r] == x) ? r : -1;
    }
    babble_grid_sync(bar, bar_target);
    // a P slot code, clamped to its chain's top slot
    auto slot_code = [&](int cr, int it) {
        const int c = babble_clamp(cr, 0, n - 1);
        return c * l + min(min(it, l - 1), top[c]);
    };
    for (long long s = gtid; s < (long long)n * l; s += stride) {
        const int t = babble_clamp(rows_by[s], 0, e - 1);
        const int it = index[t];
        ts[s] = it >= 0 ? slot_code(creator[t], it) : -(t + 1);
    }
    for (long long ev = gtid; ev < e; ev += stride) {
        const int it = index[ev], cr = creator[ev];
        const bool owned = it >= 0 && it < l && cr >= 0 && cr < n &&
                           rows_by[(long long)cr * l + it] == (int)ev;
        loose[ev] = owned ? CL_OWNED : (it >= 0 ? slot_code(cr, it) : -(int)(ev + 1));
    }
    babble_grid_sync(bar, bar_target);
    {  // ident[p]: the first target slot of chain p that is not its own P slot
        const int lane = tid & 31;
        const long long gw = gtid >> 5;
        for (long long p = gw; p < n; p += stride >> 5) {
            int first = l;
            for (int x0 = 0; x0 < l; x0 += 32) {
                const int x = x0 + lane;
                const bool off = x < l && ts[p * l + x] != (int)(p * l + x);
                const unsigned m = __ballot_sync(BABBLE_FULL_MASK, off);
                if (m) {
                    first = x0 + __ffs(m) - 1;
                    break;
                }
            }
            if (lane == 0) ident[p] = first;
        }
    }
    babble_grid_sync(bar, bar_target);

    // shared memory: the prefix's two reductions (2 * CL_THREADS), then the
    // squaring's ident (n), tile rows and own vectors' codes (tile each),
    // and the tile's target codes (n rows of tile + 1 words, p-major, then
    // the row within a group, then the row group: lanes of a warp read
    // consecutive words, and the odd row stride spreads the fill's writes)
    int32_t* red = smem;
    int32_t* red2 = red + CL_THREADS;
    int32_t* s_ident = red2 + CL_THREADS;
    int32_t* s_row = s_ident + n;
    int32_t* s_src = s_row + plan.tile;
    int32_t* s_code = s_src + plan.tile;
    for (int p = tid; p < n; p += blockDim.x) s_ident[p] = ident[p];

    const int ql = plan.ql, sl_n = CL_THREADS / ql, kk_n = plan.k, groups = plan.groups;
    const int seg = sl_n * kk_n;
    const int nq = (ld + ql - 1) / ql;
    const int sl = tid / ql, qlane = tid % ql;
    const int ql4 = plan.ql4, rg_n = CL_THREADS / ql4, tile = plan.tile;
    const int nq4 = (ld / 4 + ql4 - 1) / ql4;
    const int rg = tid / ql4, q4 = tid % ql4;
    const long long tiles_slot = ((long long)n * l + tile - 1) / tile;
    const long long tiles_loose = ((long long)e + tile - 1) / tile;
    const long long items_ab = (long long)n * groups * nq;
    const long long items_c = (tiles_slot + tiles_loose) * nq4;
    const long long iter_words = (long long)e * ld;

    int passes = pass_cap;
    for (int pass = 0; pass < pass_cap; ++pass) {
        const int32_t* cur = buf + (pass & 1) * iter_words;
        int32_t* nxt = buf + ((pass + 1) & 1) * iter_words;
        // a table's source code (a P slot, or -(row + 1) for an iterate
        // row) as the code of its vector, and a vector's 16 bytes at q
        const long long cur_code = nl + (long long)(pass & 1) * e;
        auto code_of = [&](int src) { return src >= 0 ? src : (int)(cur_code - src - 1); };
        auto vec4 = [&](int code, int q) {
            return *reinterpret_cast<const int4*>(store + (long long)code * ld + q);
        };

        // --- prefix (a): each segment's maximum
        for (long long item = blockIdx.x; item < items_ab; item += gridDim.x) {
            const int qc = (int)(item % nq);
            const int c = (int)((item / nq) % n);
            const int g = (int)(item / ((long long)nq * n));
            const int top_c = top[c];
            if (g * seg > top_c) continue;  // block-uniform
            const int q = qc * ql + qlane;
            int m = -1;
            if (q < ld) {
                const int i0 = g * seg + sl * kk_n;
                const long long s0 = (long long)c * l + i0;
#pragma unroll
                for (int kk = 0; kk < CL_K_MAX; ++kk) {
                    if (kk < kk_n && i0 + kk <= top_c) {
                        m = max(m, cl_slot_val(rows_by, cur, s0 + kk, q, e, ld));
                    }
                }
            }
            red[tid] = m;
            __syncthreads();
            if (sl == 0 && q < ld) {
                for (int s2 = 1; s2 < sl_n; ++s2) m = max(m, red[s2 * ql + qlane]);
                __stcg(tot + ((long long)c * groups + g) * ld + q, m);
            }
            __syncthreads();
        }
        babble_grid_sync(bar, bar_target);

        // --- prefix (b): each segment, carried in from the earlier ones
        for (long long item = blockIdx.x; item < items_ab; item += gridDim.x) {
            const int qc = (int)(item % nq);
            const int c = (int)((item / nq) % n);
            const int g = (int)(item / ((long long)nq * n));
            const int top_c = top[c];
            if (g * seg > top_c) continue;  // block-uniform
            const int q = qc * ql + qlane;
            const int i0 = g * seg + sl * kk_n;
            const long long s0 = (long long)c * l + i0;
            int carry = -1, run = -1;
            if (q < ld) {
                for (int g2 = sl; g2 < g; g2 += sl_n) {
                    carry = max(carry, tot[((long long)c * groups + g2) * ld + q]);
                }
#pragma unroll
                for (int kk = 0; kk < CL_K_MAX; ++kk) {
                    if (kk < kk_n && i0 + kk <= top_c) {
                        run = max(run, cl_slot_val(rows_by, cur, s0 + kk, q, e, ld));
                    }
                }
            }
            red[tid] = run;
            red2[tid] = carry;
            __syncthreads();
            if (q < ld) {
                int base = -1;
                for (int s2 = 0; s2 < sl_n; ++s2) {
                    base = max(base, red2[s2 * ql + qlane]);
                    if (s2 < sl) base = max(base, red[s2 * ql + qlane]);
                }
                // the thread's slots again (cached), now with the carry
#pragma unroll
                for (int kk = 0; kk < CL_K_MAX; ++kk) {
                    if (kk < kk_n && i0 + kk <= top_c) {
                        base = max(base, cl_slot_val(rows_by, cur, s0 + kk, q, e, ld));
                        __stcg(pt + (s0 + kk) * ld + q, base);
                    }
                }
            }
            __syncthreads();
        }
        babble_grid_sync(bar, bar_target);

        // --- square
        bool diff = false;
        for (long long item = blockIdx.x; item < items_c; item += gridDim.x) {
            const int qc4 = (int)(item % nq4);
            const long long tl = item / nq4;
            bool any = false;
            if (tl < tiles_slot) {
                long long s0 = tl * tile;
                if (l % tile == 0) {  // index-major: every chain's tile at these slots
                    const long long ib = tl / n, c = tl % n;
                    s0 = c * l + ib * tile;
                }
                for (int t = tid; t < tile; t += blockDim.x) {
                    const int r = s0 + t < nl ? slot_row[s0 + t] : -1;
                    s_row[t] = r;
                    s_src[t] = (int)(s0 + t);
                    any |= r >= 0;
                }
            } else {
                const long long ev0 = (tl - tiles_slot) * tile;
                for (int t = tid; t < tile; t += blockDim.x) {
                    const long long ev = ev0 + t;
                    const int src = ev < e ? loose[ev] : CL_OWNED;
                    const bool mine = src != CL_OWNED;
                    s_row[t] = mine ? (int)ev : -1;
                    s_src[t] = mine ? code_of(src) : 0;
                    any |= mine;
                }
            }
            if (!__syncthreads_or(any)) continue;  // block-uniform
            // the tile's target codes: [p][row] (CL_NONE where the row
            // skips p), each read from the row's own vector once
            for (int k2 = tid; k2 < tile * n; k2 += blockDim.x) {
                const int t = k2 / n, p = k2 % n;
                int code = CL_NONE;
                if (s_row[t] >= 0) {
                    const int x = store[(long long)s_src[t] * ld + p];
                    if (x >= 0) {
                        code = x < s_ident[p] ? p * l + x
                                              : code_of(ts[(long long)p * l + min(x, l - 1)]);
                    }
                }
                s_code[p * (tile + 1) + (t % CL_ROWS) * rg_n + t / CL_ROWS] = code;
            }
            __syncthreads();
            const int q = (qc4 * ql4 + q4) * 4;
            if (q < ld) {
                int4 acc[CL_ROWS];
                const int4 none = make_int4(BABBLE_MIN_INT32, BABBLE_MIN_INT32,
                                            BABBLE_MIN_INT32, BABBLE_MIN_INT32);
#pragma unroll
                for (int kk = 0; kk < CL_ROWS; ++kk) {
                    const int t = rg * CL_ROWS + kk;
                    acc[kk] = s_row[t] >= 0 ? vec4(s_src[t], q) : none;
                }
#pragma unroll 2
                for (int p = 0; p < n; ++p) {
                    int4 v[CL_ROWS];
                    int cp = CL_NONE;
#pragma unroll
                    for (int kk = 0; kk < CL_ROWS; ++kk) {
                        const int code = s_code[p * (tile + 1) + kk * rg_n + rg];
                        if (code == CL_NONE) v[kk] = none;
                        else if (kk > 0 && code == cp) v[kk] = v[kk - 1];
                        else v[kk] = vec4(code, q);
                        cp = code;
                    }
#pragma unroll
                    for (int kk = 0; kk < CL_ROWS; ++kk) acc[kk] = cl_max4(acc[kk], v[kk]);
                }
#pragma unroll
                for (int kk = 0; kk < CL_ROWS; ++kk) {
                    const int r = s_row[rg * CL_ROWS + kk];
                    if (r < 0) continue;
                    const long long o = (long long)r * ld + q;
                    const int4 old = *reinterpret_cast<const int4*>(cur + o);
                    diff |= old.x != acc[kk].x || old.y != acc[kk].y || old.z != acc[kk].z ||
                            old.w != acc[kk].w;
                    __stcg(reinterpret_cast<int4*>(nxt + o), acc[kk]);
                }
            }
            __syncthreads();
        }
        if (__syncthreads_or(diff) && tid == 0) atomicOr(changed + pass, 1);
        babble_grid_sync(bar, bar_target);
        if (*(volatile int32_t*)(changed + pass) == 0) {
            passes = pass + 1;
            break;
        }
    }
    if (gtid == 0) *passes_out = passes;
}

extern "C" int babble_closure_la(
    const int32_t* creator, const int32_t* index, const int32_t* sp,
    const int32_t* op, const int32_t* rows_by, int32_t* store, int32_t* tot,
    int32_t* tables, int32_t* counters, int e, int n, int l, int pass_cap, int ld, int ql,
    int k, int groups, int ql4, int tile, int smem, int device, void* stream) {
    BABBLE_CHECK(cudaSetDevice(device));
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (k < 1 || k > CL_K_MAX || tile % CL_ROWS != 0 || CL_THREADS % ql != 0 ||
        CL_THREADS % ql4 != 0 || tile != CL_THREADS / ql4 * CL_ROWS) {
        return (int)cudaErrorInvalidValue;
    }
    BABBLE_CHECK(babble_allow_smem(cl_walk, (size_t)smem));
    BABBLE_CHECK(cudaMemsetAsync(counters, 0, (2 + (size_t)pass_cap + n) * sizeof(int32_t), s));
    // every block resident at once (the grid barrier), no more than the
    // largest phase has items
    const long long items =
        ((long long)n * l + tile - 1) / tile + ((long long)e + tile - 1) / tile;
    int g = 0;
    BABBLE_CHECK(babble_coop_blocks(cl_walk, CL_THREADS, (size_t)smem, device, items, &g));
    ClPlan plan{ld, ql, k, groups, ql4, tile};
    void* args[] = {
        (void*)&creator, (void*)&index, (void*)&sp, (void*)&op, (void*)&rows_by,
        (void*)&store, (void*)&tot, (void*)&tables, (void*)&counters,
        (void*)&e, (void*)&n, (void*)&l, (void*)&pass_cap, (void*)&plan,
    };
    BABBLE_CHECK(cudaLaunchCooperativeKernel((const void*)cl_walk, dim3(g), dim3(CL_THREADS),
                                             args, (size_t)smem, s));
    BABBLE_CHECK_LAUNCH();
    return 0;
}
