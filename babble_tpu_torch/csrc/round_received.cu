// round_received: DecideRoundReceived over the decided fame tables.
//
// Replaces babble_tpu/tpu/kernels.py:424 _decide_round_received
// (_received_tables_from, suffix_min, received_search, received_core).
//
//   famous_count[r] = |famous witnesses of round r|
//   min_la[r, c]    = min over famous witnesses w of round r of la[w][c]
//   i_ok[r]         = rounds_decided[r] and r <= last_round
//   horizon[k]      = first r >= k with not i_ok[r]   (R if none)
//   received(e)     = least i in (round(e), horizon[round(e)+1]) with
//                     famous_count[i] > 0, i_ok[i] and
//                     index(e) <= min_la[i, creator(e)];  -1 if none
//
// Bound: bytes. The function reads the famous witnesses' rows of la, the
// (R, N) tables, the (E,) index / creator / rounds and writes received
// (E,) once: about 1.8 MB at 65,536 padded events and R = N = 64.
//
// The tables (rt_grid), one design for K4 and the mesh's B23: the work is
// (round r, tile of RT_COLS columns) items, each taken by a cluster of
// `slices` blocks (tpu/_ext.py received_tables_plan sizes it so that the
// grid covers the card at 6 rounds x 1,024 validators); block s of a
// cluster takes the witnesses in bit words [s * wps, (s + 1) * wps) of
// the round, RT_CHUNK words at a time: the chunk's famous flags as bit
// words by ballot and the witnesses' clamped la rows in shared memory,
// then its warps walk the set bits only, warp q the bits b with b % 4 ==
// q, a lane a column, and only the words that hold one (a word of flags
// per warp: a round or slice with no famous witness walks nothing;
// common.cuh babble_famous_min, which K12's dw_tables calls too): every
// load coalesced over the tile's columns, eight in flight. The same pass counts the slice's famous witnesses and whether
// every present one is decided and one is present. Warp 0 takes the min
// over the warps; block 0 of the cluster the min, the sum and the
// verdicts of the others' through distributed shared memory behind one
// cluster barrier (two buffers in turn; the other merge open, atomicMin
// into a table set in the same launch, measured no faster: PERF.md) and
// writes min_la, and on tile 0 famous_count, i_ok and (B23)
// rounds_decided. Where the horizon is asked for, each round's block 0
// takes a ticket after its i_ok, and the round that takes the last one
// scans the horizon (a suffix min, one load a round; the ticket is an
// acquire-release atomic, no fence). A cluster an item;
// with the events a persistent grid of as many clusters as the card holds
// at once, striding over the items, then over the events.
//
// The events stop at their first round that is not i_ok, which is where
// horizon[round(e) + 1] stops them (the reference's clamps included: a
// round of -1 or below starts at 0, one at R - 1 or above receives
// nothing), so K4 needs no horizon: one cooperative launch, the tables,
// one grid barrier, the events; on one card B22's events ride B23's
// launch the same way. (K4's two-launch form, the tables and recv_events,
// measured faster where the items outnumber the resident blocks and
// slower on the bench grid: PERF.md.)
//
// Entry points:
//   babble_round_received   K4, one launch as above;
//   babble_fame_tables      B23, replaces sharded.py:329 _fame_tables: the
//                           tables with rounds_decided derived and the
//                           horizon, one launch;
//   babble_fame_received    B23 and B22 together where every position of
//                           the mesh lies on one card: B23's tables, one
//                           grid barrier, then the whole event axis as K4's
//                           events (they stop where the horizon stops B22),
//                           one launch;
//   babble_received_search  B22, replaces sharded.py:302 local_received:
//                           recv_events over one position's event shard,
//                           against the replicated tables (positions on
//                           distinct cards).
// The ticket and the grid barrier live on words that outlast the launch
// (the wrapper's `sync`, zeroed once when allocated): the ticket's last
// taker sets it back to 0, and the barrier's word comes back as it was.

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

#define RT_THREADS 128    // four warps, each every fourth witness
#define RT_COLS 32        // columns a tile: a lane a column
#define RT_CHUNK 32       // bit words of witnesses a block stages at once
#define RT_MAX_SLICES 8   // a portable cluster

struct RtArgs {
    const int32_t* wtable;
    const int32_t* la;
    const uint8_t* decided;
    const uint8_t* famous;
    const uint8_t* rounds_decided_in;  // K4: given; B23: null, derived here
    const int32_t* last_round;
    int32_t* min_la;
    int32_t* famous_count;
    uint8_t* i_ok;
    int32_t* horizon;             // null: not asked for
    uint8_t* rounds_decided_out;  // B23
    // K4's events (one launch)
    const int32_t* index;
    const int32_t* creator;
    const int32_t* rounds;
    int32_t* received;
    unsigned int* sync;  // [0] the horizon's ticket, [1] the grid barrier's word
    int r_max, n, e_la, e, slices, wps;
};

// the reference's creator gather: a negative creator counted from the end
// once, then clamped to [0, n)
__device__ __forceinline__ int recv_column(int c, int n) {
    return babble_clamp(c < 0 ? c + n : c, 0, n - 1);
}

// received(e) of one event against the finished tables and horizon (B22)
__device__ __forceinline__ int recv_event(long long k, const int32_t* index,
                                          const int32_t* creator, const int32_t* rounds,
                                          const int32_t* min_la, const int32_t* famous_count,
                                          const uint8_t* i_ok, const int32_t* horizon,
                                          int r_max, int n) {
    const int rd = rounds[k];
    const int c = recv_column(creator[k], n);
    const int idx = index[k];
    const int hs = horizon[babble_clamp(rd + 1, 0, r_max - 1)];
    const int stop = min(hs, r_max);
    for (int i = max(rd + 1, 0); i < stop; ++i) {
        if (famous_count[i] > 0 && i_ok[i] && idx <= min_la[(long long)i * n + c]) return i;
    }
    return -1;
}

// horizon[k] = min over r >= k of (i_ok[r] ? r_max : r), by one block: each
// thread a run of consecutive rounds (its loads issued together), the
// suffix min over the threads after it by shuffles and shared memory
__device__ void rt_horizon(const uint8_t* i_ok, int32_t* horizon, int r_max) {
    __shared__ int wmin[RT_THREADS / 32];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int per = (r_max + RT_THREADS - 1) / RT_THREADS;
    const int r0 = threadIdx.x * per;
    int v = r_max;
    for (int j = per - 1; j >= 0; --j) {
        const int r = r0 + j;
        if (r < r_max && !__ldcg(i_ok + r)) v = r;
    }
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const int u = __shfl_down_sync(BABBLE_FULL_MASK, v, o);
        if (lane + o < 32) v = min(v, u);
    }
    if (lane == 0) wmin[warp] = v;
    __syncthreads();
    int h = __shfl_down_sync(BABBLE_FULL_MASK, v, 1);
    if (lane == 31) h = r_max;
    for (int q = warp + 1; q < RT_THREADS / 32; ++q) h = min(h, wmin[q]);
    for (int j = per - 1; j >= 0; --j) {
        const int r = r0 + j;
        if (r >= r_max) continue;
        if (!__ldcg(i_ok + r)) h = r;
        horizon[r] = h;
    }
}

template <bool EVENTS>
__global__ void __launch_bounds__(RT_THREADS) rt_grid(RtArgs a) {
    __shared__ uint32_t fw[RT_CHUNK];        // the chunk's famous flags
    // the chunk's words that hold a bit of each warp's quarter
    __shared__ uint32_t occ[RT_THREADS / 32];
    __shared__ int32_t wrow[RT_CHUNK * 32];  // the chunk's clamped la rows
    // the warps' minima, then the block's (RT_MIN), the slice's famous
    // count and verdicts (not done, present), two buffers in turn for
    // block 0 of the cluster to read
    constexpr int RT_MIN = RT_THREADS, RT_CNT = RT_THREADS + RT_COLS;
    __shared__ int32_t part[2][RT_CNT + 3];
    __shared__ int s_last;
    cg::cluster_group cluster = cg::this_cluster();
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int n = a.n;
    const int slices = a.slices, s = (int)cluster.block_rank();
    const int clusters = gridDim.x / slices;
    const int words = (n + 31) / 32, tiles = (n + RT_COLS - 1) / RT_COLS;
    const unsigned quarter = 0x11111111u << warp;
    const long long items = (long long)a.r_max * tiles;
    const int lr = *a.last_round;
    const int32_t* la = a.la;
    const int k_lo = min(s * a.wps, words), k_hi = min(k_lo + a.wps, words);
    int buf = 0;
    for (long long it = blockIdx.x / slices; it < items; it += clusters) {
        const int r = (int)(it / tiles), t = (int)(it % tiles);
        const long long rn = (long long)r * n;
        const int c = t * RT_COLS + lane;
        int m = BABBLE_MAX_INT32, cnt = 0, undone = 0, present = 0;
        for (int k0 = k_lo; k0 < k_hi; k0 += RT_CHUNK) {
            const int k1 = min(k0 + RT_CHUNK, k_hi);
            __syncthreads();  // the last chunk's walk is done with fw, wrow and occ
            if (tid < RT_THREADS / 32) occ[tid] = 0;
            __syncthreads();  // occ is 0
            // a warp's words of the chunk (issuing every word's loads first
            // measured slower where a block stages few words: PERF.md)
            for (int k = k0 + warp; k < k1; k += RT_THREADS / 32) {
                const int w = 32 * k + lane;
                bool wv = false, dec = false, f = false;
                int row = 0;
                if (w < n) {
                    // the three loads issued together
                    const int wt = a.wtable[rn + w];
                    const bool d = a.decided[rn + w], fa = a.famous[rn + w];
                    wv = wt >= 0;
                    dec = wv && d;
                    f = dec && fa;
                    row = babble_clamp(wt, 0, a.e_la - 1);
                }
                const unsigned bits = __ballot_sync(BABBLE_FULL_MASK, f);
                wrow[(k - k0) * 32 + lane] = row;
                cnt += __popc(bits);
                undone |= wv && !dec;
                present |= wv;
                if (lane == 0) fw[k - k0] = bits;
                if (lane < RT_THREADS / 32 && (bits & (0x11111111u << lane))) {
                    atomicOr(&occ[lane], 1u << (k - k0));
                }
            }
            __syncthreads();
            if (c < n) {
                // only the words that hold a bit of this warp's quarter
                for (unsigned o = occ[warp]; o; o &= o - 1) {
                    const int k = __ffs(o) - 1;
                    m = min(m, babble_famous_min(fw, k, k + 1, c, quarter, [=](int w) {
                        return la + (long long)wrow[w] * n;
                    }));
                }
            }
        }
        // the slice's row verdicts, from every warp's share (a warp's cnt
        // counts its words once on every lane: lane 0's)
        cnt = lane == 0 ? cnt : 0;
        undone = __syncthreads_or(undone);
        present = __syncthreads_or(present);
        if (tid == 0) part[buf][RT_CNT] = 0;
        part[buf][tid] = m;
        __syncthreads();
        if (cnt) atomicAdd(&part[buf][RT_CNT], cnt);
        if (warp == 0) {
            for (int q = 1; q < RT_THREADS / 32; ++q) m = min(m, part[buf][q * 32 + lane]);
            part[buf][RT_MIN + lane] = m;
        }
        if (tid == 0) {
            part[buf][RT_CNT + 1] = undone;
            part[buf][RT_CNT + 2] = present;
        }
        if (slices > 1) {
            cluster.sync();
        } else {
            __syncthreads();
        }
        if (s == 0) {
            if (warp == 0) {
                for (int q = 1; q < slices; ++q) {
                    m = min(m, cluster.map_shared_rank(&part[buf][0], q)[RT_MIN + lane]);
                }
                if (c < n) a.min_la[rn + c] = m;
            }
            if (t == 0 && tid == 0) {
                int total = part[buf][RT_CNT], und = undone, pres = present;
                for (int q = 1; q < slices; ++q) {
                    const int32_t* o = cluster.map_shared_rank(&part[buf][0], q);
                    total += o[RT_CNT];
                    und |= o[RT_CNT + 1];
                    pres |= o[RT_CNT + 2];
                }
                bool rd;
                if (a.rounds_decided_in != nullptr) {
                    rd = a.rounds_decided_in[r] != 0;
                } else {
                    rd = !und && pres;
                    a.rounds_decided_out[r] = rd;
                }
                a.famous_count[r] = total;
                a.i_ok[r] = rd && r <= lr;
                s_last = 0;
                if (a.horizon != nullptr) {
                    // the round's ticket, acquire-release (its i_ok before it;
                    // the last taker sees every round's): the last round done
                    // scans the horizon
                    unsigned old;
                    asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;"
                                 : "=r"(old) : "l"(__cvta_generic_to_global(a.sync))
                                 : "memory");
                    s_last = old == (unsigned)a.r_max - 1;
                    if (s_last) *a.sync = 0;
                }
            }
            if (t == 0) {
                __syncthreads();
                if (s_last) rt_horizon(a.i_ok, a.horizon, a.r_max);
            }
        }
        buf ^= 1;
    }
    // no block leaves while block 0 of its cluster may read its shared memory
    if (slices > 1) cluster.sync();
    if (!EVENTS) return;
    // every table is final past the barrier (its fences drop the SM's L1);
    // an event's rounds stop at the first that is not i_ok (its horizon)
    babble_grid_flip_sync(a.sync + 1);
    const long long stride = (long long)gridDim.x * RT_THREADS;
    for (long long k = (long long)blockIdx.x * RT_THREADS + tid; k < a.e; k += stride) {
        const int rd = a.rounds[k];
        const int col = recv_column(a.creator[k], n);
        const int idx = a.index[k];
        int res = -1;
        for (int i = max(rd + 1, 0); i < a.r_max && a.i_ok[i]; ++i) {
            if (a.famous_count[i] > 0 && idx <= a.min_la[(long long)i * n + col]) {
                res = i;
                break;
            }
        }
        a.received[k] = res;
    }
}

__global__ void recv_events(const int32_t* __restrict__ index,
                            const int32_t* __restrict__ creator,
                            const int32_t* __restrict__ rounds,
                            const int32_t* __restrict__ min_la,
                            const int32_t* __restrict__ famous_count,
                            const uint8_t* __restrict__ i_ok,
                            const int32_t* __restrict__ horizon,
                            int32_t* received, int r_max, int n, int e) {
    int k = blockIdx.x * blockDim.x + threadIdx.x;
    if (k >= e) return;
    received[k] = recv_event(k, index, creator, rounds, min_la, famous_count, i_ok, horizon,
                             r_max, n);
}

// The tables' launch: clusters of `slices` blocks, a cluster an item; with
// the events a persistent cooperative grid (the barrier needs every block
// resident): as many clusters as the card holds at once, at most max(items,
// the clusters the events need).
template <bool EVENTS>
static int rt_launch(const RtArgs& a, int device, cudaStream_t s) {
    if (a.r_max < 1 || a.n < 1 || a.e_la < 1 || a.slices < 1 || a.slices > RT_MAX_SLICES ||
        a.wps < 1 || (long long)a.slices * a.wps < (a.n + 31) / 32) {
        return (int)cudaErrorInvalidValue;
    }
    const int tiles = (a.n + RT_COLS - 1) / RT_COLS;
    long long want = (long long)a.r_max * tiles;
    if (EVENTS) {
        const long long ev = ((long long)a.e + (long long)RT_THREADS * a.slices - 1) /
                             ((long long)RT_THREADS * a.slices);
        if (ev > want) want = ev;
    }
    // the cluster dimension where a cluster holds more than one block (a
    // launch of one-block clusters measured slower: PERF.md)
    cudaLaunchAttribute attrs[2];
    int n_attrs = 0;
    if (a.slices > 1) {
        attrs[n_attrs].id = cudaLaunchAttributeClusterDimension;
        attrs[n_attrs].val.clusterDim.x = (unsigned)a.slices;
        attrs[n_attrs].val.clusterDim.y = 1;
        attrs[n_attrs].val.clusterDim.z = 1;
        ++n_attrs;
    }
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)a.slices);
    cfg.blockDim = dim3(RT_THREADS);
    cfg.dynamicSmemBytes = 0;
    cfg.stream = s;
    cfg.attrs = attrs;
    cfg.numAttrs = n_attrs;
    long long clusters = want;
    if (EVENTS) {
        int resident = 0;
        if (a.slices > 1) {
            BABBLE_CHECK(cudaOccupancyMaxActiveClusters(&resident, rt_grid<EVENTS>, &cfg));
        } else {
            BABBLE_CHECK(babble_coop_blocks(rt_grid<EVENTS>, RT_THREADS, 0, device, want,
                                            &resident));
        }
        if (resident < clusters) clusters = resident;
        if (clusters < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
        attrs[n_attrs].id = cudaLaunchAttributeCooperative;
        attrs[n_attrs].val.cooperative = 1;
        ++n_attrs;
    }
    cfg.gridDim = dim3((unsigned)(clusters * a.slices));
    cfg.numAttrs = n_attrs;
    BABBLE_CHECK(cudaLaunchKernelEx(&cfg, rt_grid<EVENTS>, a));
    BABBLE_CHECK_LAUNCH();
    return 0;
}

// K4. `slices` and `wps` (bit words a slice) as tpu/_ext.py
// received_tables_plan gives them.
extern "C" int babble_round_received(
    const int32_t* wtable, const int32_t* la, const int32_t* index,
    const int32_t* creator, const int32_t* rounds, const uint8_t* decided,
    const uint8_t* famous, const uint8_t* rounds_decided,
    const int32_t* last_round, int32_t* min_la, int32_t* famous_count,
    uint8_t* i_ok, int32_t* received, unsigned int* sync,
    int r_max, int n, int e, int e_la, int slices, int wps, int device, void* stream) {
    BABBLE_CHECK(cudaSetDevice(device));
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const RtArgs a{wtable, la, decided, famous, rounds_decided, last_round, min_la,
                   famous_count, i_ok, nullptr, nullptr, index, creator, rounds, received,
                   sync, r_max, n, e_la, e, slices, wps};
    return e > 0 ? rt_launch<true>(a, device, s) : rt_launch<false>(a, device, s);
}

// B23: the tables with rounds_decided[r] = all(decided | ~wvalid) &
// any(wvalid) over round r's row, and the horizon, in one launch.
extern "C" int babble_fame_tables(
    const int32_t* wtable, const int32_t* la, const uint8_t* decided,
    const uint8_t* famous, const int32_t* last_round, int32_t* min_la,
    int32_t* famous_count, uint8_t* i_ok, int32_t* horizon, uint8_t* rounds_decided,
    unsigned int* sync, int r_max, int n, int e_la, int slices, int wps,
    int device, void* stream) {
    BABBLE_CHECK(cudaSetDevice(device));
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const RtArgs a{wtable, la, decided, famous, nullptr, last_round, min_la, famous_count,
                   i_ok, horizon, rounds_decided, nullptr, nullptr, nullptr, nullptr,
                   sync, r_max, n, e_la, 0, slices, wps};
    return rt_launch<false>(a, device, s);
}

// B23 and B22 in one launch: fame_tables' tables and horizon, then
// received (E,) over the unsharded event axis, in its global order.
extern "C" int babble_fame_received(
    const int32_t* wtable, const int32_t* la, const uint8_t* decided,
    const uint8_t* famous, const int32_t* last_round, const int32_t* index,
    const int32_t* creator, const int32_t* rounds, int32_t* min_la,
    int32_t* famous_count, uint8_t* i_ok, int32_t* horizon, uint8_t* rounds_decided,
    int32_t* received, unsigned int* sync, int r_max, int n, int e, int e_la, int slices,
    int wps, int device, void* stream) {
    BABBLE_CHECK(cudaSetDevice(device));
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const RtArgs a{wtable, la, decided, famous, nullptr, last_round, min_la, famous_count,
                   i_ok, horizon, rounds_decided, index, creator, rounds, received,
                   sync, r_max, n, e_la, e, slices, wps};
    return e > 0 ? rt_launch<true>(a, device, s) : rt_launch<false>(a, device, s);
}

extern "C" int babble_received_search(
    const int32_t* index, const int32_t* creator, const int32_t* rounds,
    const int32_t* min_la, const int32_t* famous_count, const uint8_t* i_ok,
    const int32_t* horizon, int32_t* received, int r_max, int n, int e,
    int device, void* stream) {
    BABBLE_CHECK(cudaSetDevice(device));
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (e > 0) {
        recv_events<<<babble_blocks(e, 256), 256, 0, s>>>(
            index, creator, rounds, min_la, famous_count, i_ok, horizon,
            received, r_max, n, e);
        BABBLE_CHECK_LAUNCH();
    }
    return 0;
}
