// Linear-gap sequence-to-graph DP (K1) and its traceback walks, run-length
// (K2) and dense, for Hopper (sm_90a), with a plain C interface for ctypes.
//
// Replaces vechat_tpu/ops/kernels/poa_pallas.py: _dp_kernel (pallas_call in
// _poa_dp_pallas), _traceback_walk_rle and _traceback_walk. The direction codes, run markers,
// best-cell pack and run headers are the reference's bit for bit; the plain
// PyTorch versions in ops/kernels/poa_linear.py compute the same outputs.
//
// K1: one warp per (window b, sequence d), thread t of it owning the W/32
// contiguous lanes [t*W/32, (t+1)*W/32) in registers. It replaced one block
// per (b, d) with a thread per lane, whose rows each waited at three block
// barriers (two in a block-wide scan) behind dependent loads of the graph
// row. Now a row is: the in-edge maxes (two DPX add-then-max a lane and
// in-edge, the H ring read with vector loads, the left neighbour's value by
// shuffle); the in-row gap as a serial max-plus scan over the thread's lanes
// and a 5-step shuffle scan of the 32 totals; the direction row staged in
// shared memory and written in 16-byte pieces. One __syncwarp a row and no
// block barrier. The graph rows come 32 at a time, fetched a batch ahead in
// registers and taken by shuffle. The int16 H ring is in shared memory when
// a block's warps' slices fit, else in a global scratch ring; a block holds
// up to 4 warps of one window, which share its graph rows in L1. What bounds
// it now is the latency of each row's chain of dependent steps (ring load,
// the two scans, ring store): the main path's launches give about one warp
// to each of the card's 528 schedulers, and twice the warps take only
// 1.1-1.2x the time (k1_probe.py). About 31 instructions a lane (cell) and
// 5 an in-edge, 24 and 4 of them on the INT32 pipe.
// K2: one warp per walk, stepping over tiles of its direction codes staged
// in shared memory; then the expansion of its headers to node-id pairs on the
// card (poa_expand_kernel). See the notes above the kernels.
// The dense walk (poa_walk_dense_kernel, the sharded route's walk) replaces
// _traceback_walk: one warp a walk with K2's tile cursor, a marked run one
// step, its pairs spread over the lanes as the expansion spreads them,
// written with the -2 columns into [B, D, L] rows. See the note above it.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kDeltaBits = 9;
constexpr int kDmask = (1 << kDeltaBits) - 1;
constexpr int kTie = 4096;
constexpr int kNegV = -(1 << 30);
constexpr int kNeg16 = -16000;
constexpr int kRunRBits = 9;
constexpr int kRunPpBits = 10;
constexpr int kRunPnShift = 19;
enum { kNW = 0, kSW = 1, kOV = 2 };

// ------------------------------------------------------------------- K1
// One warp per (window b, sequence d). Thread t of the warp owns the DP
// lanes [t*LPT, (t+1)*LPT) with LPT = W/32 and keeps their values in
// registers. The W buckets 128, 320, 576 and 768 (LPT 4, 10, 18, 24) have
// instantiations of their own (EXACT); any other W, a multiple of 32 up to
// 1024, runs the LPT-32 instantiation with a run-time lane count. PMAX is
// the number of in-edge slots fetched ahead in registers (8 or 16); slots
// past it, for P > 16, are read from global memory in the row loop. SMEM:
// the H ring in shared memory; SW: local mode (its clamp at 0 and stop
// code compiled in, nw and ov told apart at run time).

constexpr unsigned kFull = 0xffffffffu;
constexpr int kK1MaxWarps = 4;  // warps of a block: sequences of one window
// H value standing in for the missing left neighbour of lane 0: adding a
// profile and a delta pack to it stays below kNegV, without overflow
constexpr int kLowH = -(3 << 29);

template <int LPT, bool EXACT>
__device__ __forceinline__ bool live(int i, int lpt) {
  return EXACT || i < lpt;
}

// The thread's LPT int16 lanes at p, each times 2^SH (SH <= 15). Exact
// widths read whole words, 16 bytes at a time when LPT is a multiple of 8:
// at LPT 4, 10, 18 and 24 no two threads of a warp hit one bank.
template <int LPT, bool EXACT>
__device__ __forceinline__ void load_lanes(const short* p, int lpt, int SH, int (&h)[LPT]) {
  if constexpr (EXACT && LPT % 2 == 0) {
    int w[LPT / 2];
    if constexpr (LPT % 8 == 0) {
      const int4* q = reinterpret_cast<const int4*>(p);
#pragma unroll
      for (int k = 0; k < LPT / 8; ++k) {
        const int4 v = q[k];
        w[4 * k] = v.x;
        w[4 * k + 1] = v.y;
        w[4 * k + 2] = v.z;
        w[4 * k + 3] = v.w;
      }
    } else if constexpr (LPT % 4 == 0) {
      const int2* q = reinterpret_cast<const int2*>(p);
#pragma unroll
      for (int k = 0; k < LPT / 4; ++k) {
        const int2 v = q[k];
        w[2 * k] = v.x;
        w[2 * k + 1] = v.y;
      }
    } else {
      const int* q = reinterpret_cast<const int*>(p);
#pragma unroll
      for (int k = 0; k < LPT / 2; ++k) w[k] = q[k];
    }
    const int sr = 16 - SH;
#pragma unroll
    for (int k = 0; k < LPT / 2; ++k) {
      h[2 * k] = (int)((unsigned)w[k] << 16) >> sr;
      h[2 * k + 1] = (int)((unsigned)w[k] & 0xffff0000u) >> sr;
    }
  } else {
#pragma unroll
    for (int i = 0; i < LPT; ++i)
      if (live<LPT, EXACT>(i, lpt)) h[i] = (int)p[i] * (1 << SH);
  }
}

// The low halves of the thread's LPT values to its int16 lanes at p, with
// the access widths of load_lanes.
template <int LPT, bool EXACT>
__device__ __forceinline__ void store_lanes(short* p, int lpt, const int (&v)[LPT]) {
  if constexpr (EXACT && LPT % 2 == 0) {
    int w[LPT / 2];
#pragma unroll
    for (int k = 0; k < LPT / 2; ++k) w[k] = (int)__byte_perm(v[2 * k], v[2 * k + 1], 0x5410);
    if constexpr (LPT % 8 == 0) {
      int4* q = reinterpret_cast<int4*>(p);
#pragma unroll
      for (int k = 0; k < LPT / 8; ++k)
        q[k] = make_int4(w[4 * k], w[4 * k + 1], w[4 * k + 2], w[4 * k + 3]);
    } else if constexpr (LPT % 4 == 0) {
      int2* q = reinterpret_cast<int2*>(p);
#pragma unroll
      for (int k = 0; k < LPT / 4; ++k) q[k] = make_int2(w[2 * k], w[2 * k + 1]);
    } else {
      int* q = reinterpret_cast<int*>(p);
#pragma unroll
      for (int k = 0; k < LPT / 2; ++k) q[k] = w[k];
    }
  } else {
#pragma unroll
    for (int i = 0; i < LPT; ++i)
      if (live<LPT, EXACT>(i, lpt)) p[i] = (short)v[i];
  }
}

// the value of the thread's last lane
template <int LPT, bool EXACT>
__device__ __forceinline__ int last_lane(const int (&v)[LPT], int lpt) {
  if constexpr (EXACT) {
    return v[LPT - 1];
  } else {
    int r = v[0];
#pragma unroll
    for (int i = 1; i < LPT; ++i)
      if (i < lpt) r = v[i];
    return r;
  }
}

struct K1Args {
  const int* codes;    // [B, N] node codes, rank order
  const int* aux;      // [B, P, N] hslot << 16 | prio << 9 | delta
  const int* deg;      // [B, N] true in-degree (>= 1)
  const int* sink;     // [B, N] 1 = no out-edges
  const int* n_nodes;  // [B]
  const int* seqp;     // [B, D, W] lane j = code of position j-1
  const int* slen;     // [B, D]
  short* dirs;         // [B, N+1, D, W] out
  int* maxi;           // [B, D] out
  int* maxj;
  int* score;
  short* hring;        // [B*D, R+1, W] scratch when the ring is not in shared memory
  int N, P, D, W, R, mode, m, x, g, SH;
};

template <int LPT, int PMAX, bool SMEM, bool EXACT, bool SW>
__global__ void __launch_bounds__(32 * kK1MaxWarps) poa_dp_kernel(const K1Args a) {
  // per warp: [2, W] staged direction rows, then (SMEM) the [R+1, W] H ring
  extern __shared__ __align__(16) short k1_smem[];
  const int N = a.N, P = a.P, D = a.D, W = a.W, R = a.R, mode = a.mode, g = a.g, SH = a.SH;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x;
  const int d = blockIdx.y * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (d >= D) return;  // the kernel has no block barrier: a spare warp just leaves
  const int bd = b * D + d;
  const int lpt = EXACT ? LPT : W >> 5;
  const int j0 = lane * lpt;
  short* stage = k1_smem + (size_t)(threadIdx.x >> 5) *
                               (2 * W + (SMEM ? (size_t)(R + 1) * W : 0));
  // each thread reads and writes only its own lanes of the ring (the left
  // neighbour's value comes by shuffle), so the ring needs no barrier
  short* Hl = (SMEM ? stage + 2 * W : a.hring + (size_t)bd * (R + 1) * W) + j0;
  const int MASKC = (1 << SH) - 1;
  const int HORIZ = 1 << kDeltaBits;
  const int MARK_D = ((1 << (SH - kDeltaBits)) - 1) << kDeltaBits;  // run-marker codes
  const int MARK_V = MARK_D - (1 << kDeltaBits);
  const int VADJ = g * (1 << SH) - (P << kDeltaBits);
  const int MS = a.m * (1 << SH), XS = a.x * (1 << SH);
  const int CODE_D = (P + 2) << kDeltaBits, CODE_V = 2 << kDeltaBits;
  const int sl = a.slen[bd];
  const int nn = a.n_nodes[b];
  const int jg0 = j0 * g;
  const int chunks = W >> 3;  // 16-byte pieces of a direction row
  short* drow = a.dirs + ((size_t)b * (N + 1) * D + d) * W;
  const size_t row_stride = (size_t)D * W;
  const int* aux_b = a.aux + (size_t)b * P * N;
  const int* codes_b = a.codes + (size_t)b * N;
  const int* deg_b = a.deg + (size_t)b * N;
  const int* sink_b = a.sink + (size_t)b * N;

  int qc[LPT], rl[LPT];  // query codes; run length (> 0 diagonal, < 0 vertical)
  unsigned cmask = 0;    // lanes that may hold the best cell
#pragma unroll
  for (int i = 0; i < LPT; ++i) {
    qc[i] = 0;
    rl[i] = 0;
    if (live<LPT, EXACT>(i, lpt)) {
      const int j = j0 + i;
      qc[i] = a.seqp[(size_t)bd * W + j];
      const bool cell = mode == kNW ? j == sl : (j != 0 && j <= sl);
      cmask |= (unsigned)cell << i;
    }
  }
  {
    // slot R pins the row-0 boundary: start nodes at any rank read row 0
    int h0[LPT];
#pragma unroll
    for (int i = 0; i < LPT; ++i) h0[i] = SW ? 0 : jg0 + i * g;
    store_lanes<LPT, EXACT>(Hl + (size_t)R * W, lpt, h0);
    const int v0 = SW ? 0 : HORIZ * 0x10001;
    for (int c = lane; c < chunks; c += 32)
      reinterpret_cast<int4*>(drow)[c] = make_int4(v0, v0, v0, v0);
  }
  int best = SW ? 0 : kNeg16 * kTie + (kTie - 1);
  int bestj = j0;

  // graph rows come 32 at a time, fetched one batch ahead: lane k holds row
  // r0+k's code, in-degree | sink << 8 and first PMAX aux words, and the row
  // loop takes them by shuffle
  int nc = 0, nm = 0, na[PMAX];
  auto fetch = [&](int r0) {
    const int r = r0 + lane;
    const bool ok = r < nn;
    nc = ok ? codes_b[r] : 0;
    nm = ok ? deg_b[r] | (sink_b[r] != 0 ? 1 << 8 : 0) : 0;
#pragma unroll
    for (int p = 0; p < PMAX; ++p) na[p] = ok && p < P ? aux_b[(size_t)p * N + r] : 0;
  };
  fetch(0);
  int wslot = 0;  // ring slot of row hr: (hr - 1) % R
  for (int r0 = 0; r0 < nn; r0 += 32) {
    const int cc = nc, cm = nm;
    int ca[PMAX];
#pragma unroll
    for (int p = 0; p < PMAX; ++p) ca[p] = na[p];
    if (r0 + 32 < nn) fetch(r0 + 32);
    const int rows = min(32, nn - r0);
    for (int k = 0; k < rows; ++k) {
      const int hr = r0 + k + 1;
      const int code = __shfl_sync(kFull, cc, k);
      const int meta = __shfl_sync(kFull, cm, k);
      const int dg = meta & 0xff;
      // in-edges: every lane's best diagonal and vertical candidates, the
      // match/mismatch profile left out: it is the same for every in-edge
      // and is added once below (max(a + c, b + c) = max(a, b) + c)
      int dmax[LPT], vmax[LPT];
      auto edge = [&](int av, bool first) {
        const int dp = av & 0xffff;
        int h[LPT];
        load_lanes<LPT, EXACT>(Hl + (size_t)(av >> 16) * W, lpt, SH, h);
        int hl = __shfl_up_sync(kFull, last_lane<LPT, EXACT>(h, lpt), 1);
        if (lane == 0) hl = kLowH;
#pragma unroll
        for (int i = 0; i < LPT; ++i) {
          if (!live<LPT, EXACT>(i, lpt)) continue;
          const int hd = i == 0 ? hl : h[i - 1];
          if (first) {
            dmax[i] = hd + dp;
            vmax[i] = h[i] + dp;
          } else {
            dmax[i] = __viaddmax_s32(hd, dp, dmax[i]);
            vmax[i] = __viaddmax_s32(h[i], dp, vmax[i]);
          }
        }
      };
      // padding slots repeat slot 0 at a lower priority: skipping them
      // leaves the max unchanged
#pragma unroll
      for (int p = 0; p < PMAX; ++p)
        if (p < dg) edge(__shfl_sync(kFull, ca[p], k), p == 0);
      for (int p = PMAX; p < dg; ++p) edge(aux_b[(size_t)p * N + hr - 1], false);

      // packed cell values, and the in-row gap as a max-plus scan in the
      // lv - j*g domain: serial over the thread's lanes, then across the
      // warp's 32 totals
      int acc[LPT], s[LPT];
#pragma unroll
      for (int i = 0; i < LPT; ++i) {
        if (i > 0 && !live<LPT, EXACT>(i, lpt)) {
          s[i] = s[i - 1];
          continue;
        }
        int v = __viaddmax_s32(vmax[i], VADJ, dmax[i] + (qc[i] == code ? MS : XS));
        if (i == 0 && lane == 0) v = mode == kNW ? max(v, kNegV) : 0;
        acc[i] = v;
        const int xi = (v >> SH) - (jg0 + i * g);
        s[i] = i == 0 ? xi : max(s[i - 1], xi);
      }
      int tot = s[LPT - 1];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int u = __shfl_up_sync(kFull, tot, o);
        if (lane >= o) tot = max(tot, u);
      }
      int carry = __shfl_up_sync(kFull, tot, 1);
      if (lane == 0) carry = kNegV;
      // the diagonal run of lane 0 continues lane W-1's of the previous row
      // (the reference's roll): thread 0 takes thread 31's last lane
      const int rl_wrap = __shfl_sync(kFull, last_lane<LPT, EXACT>(rl, lpt), (lane + 31) & 31);
      int run[LPT], dc[LPT];
#pragma unroll
      for (int i = LPT - 1; i >= 0; --i) {  // descending: rl[i-1] is still the previous row's
        run[i] = 0;
        dc[i] = 0;
        if (!live<LPT, EXACT>(i, lpt)) continue;
        const int jg = jg0 + i * g;
        const int rv = SW ? __vimax3_s32(s[i] + jg, carry + jg, 0)
                          : __viaddmax_s32(s[i], jg, carry + jg);
        // horizontal loses every tie (last in reference priority order)
        int dcode = rv == (acc[i] >> SH) ? acc[i] & MASKC : HORIZ;
        if (SW && rv == 0) dcode = 0;
        // run markers: a diagonal unit-delta chain continues the previous
        // row's chain one lane to the left, a vertical one the same lane.
        // Both lengths are computed and one is kept:
        // min(max(r, 0) + 1, 511) = max(min(r + 1, 511), 1)
        const bool unit = (dcode & kDmask) == 1;
        const bool isd1 = unit && dcode >= CODE_D;
        const bool isv1 = unit && !isd1 && dcode >= CODE_V;
        const int cd = max(min((i == 0 ? rl_wrap : rl[i - 1]) + 1, kDmask), 1);
        const int cv = max(min(1 - rl[i], kDmask), 1);
        rl[i] = isd1 ? cd : (isv1 ? -cv : 0);
        dcode = isd1 ? (MARK_D | cd) : (isv1 ? (MARK_V | cv) : dcode);
        run[i] = rv;
        dc[i] = dcode;
      }
      store_lanes<LPT, EXACT>(Hl + (size_t)wslot * W, lpt, run);
      wslot = wslot + 1 == R ? 0 : wslot + 1;
      // the direction row: staged (two buffers, so one __syncwarp a row
      // orders both the writes before the reads and the reads before the
      // buffer's next writes), then written in 16-byte pieces
      short* st = stage + (hr & 1) * W;
      store_lanes<LPT, EXACT>(st + j0, lpt, dc);
      __syncwarp();
      int4* dr = reinterpret_cast<int4*>(drow + (size_t)hr * row_stride);
      for (int c = lane; c < chunks; c += 32) dr[c] = reinterpret_cast<const int4*>(st)[c];
      // best cell: the row's best cell lane, packed with the row
      if (cmask != 0 && (SW || (meta >> 8) != 0)) {
        int rm = INT_MIN;
        if (EXACT && cmask == (unsigned)((1ull << LPT) - 1)) {  // every lane a cell (sw, ov)
#pragma unroll
          for (int i = 0; i < LPT; ++i) rm = max(rm, run[i]);
        } else {
#pragma unroll
          for (int i = 0; i < LPT; ++i)
            if ((cmask >> i) & 1u) rm = max(rm, run[i]);
        }
        const int pack = rm * kTie + (kTie - 1 - hr);
        if (pack > best) {
          best = pack;
#pragma unroll
          for (int i = LPT - 1; i >= 0; --i)
            if (((cmask >> i) & 1u) && run[i] == rm) bestj = j0 + i;
        }
      }
    }
  }

  // best cell: highest score, then lowest row (packed), then lowest lane
  int wbest = best;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) wbest = max(wbest, __shfl_xor_sync(kFull, wbest, o));
  int jpick = best == wbest ? bestj : INT_MAX;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) jpick = min(jpick, __shfl_xor_sync(kFull, jpick, o));
  if (lane == 0) {
    const int sc = wbest >> 12;
    const int ipick = (kTie - 1) - (wbest & (kTie - 1));
    const bool empty = SW ? sc <= 0 : ipick == 0;
    a.maxi[bd] = empty ? 0 : ipick;
    a.maxj[bd] = empty ? 0 : jpick;
    a.score[bd] = sc;
  }
}

// ------------------------------------------------------------------- K2
// One warp per walk, kWalkWarps walks a block. It replaced one thread per
// walk, each of whose steps was a dependent load of one int16 code from
// device memory (dirs is hundreds of MB; a walk's consecutive rows lie D*W*2
// bytes apart), so a step cost a device-memory round trip. Now the warp
// stages a tile of its walk's codes in shared memory: rows [i-63, i] of
// dirs[b, :, d, :] by the 64 columns that end with the 16-byte piece holding
// j, both clamped at 0, copied with cp.async by 8 lanes a row, every piece in
// flight at once, so a tile costs about one device-memory latency. A walk
// never moves to a higher row or column, so it steps from shared memory until
// it leaves the tile through its top or left edge or jumps to a predecessor
// above it, and the warp restages at that cell. Every lane runs the step (the
// code is one broadcast load) and stores the same header word, so the step
// has no branch; the mode is a template parameter. What bounds it now is the
// chain of dependent steps, each a shared-memory load and the decode, plus
// one device-memory latency a tile (about 9 tiles a walk on the main path's
// windows). 4 warps take 32 KB of static shared memory, below the 48 KB that
// needs no opt-in. The dense walk steps with the same cursor (TileWalk).
constexpr int kWalkWarps = 4;
constexpr int kTileRows = 64;
constexpr int kTileCols = 64;  // 8 16-byte pieces a row: a warp copies 4 rows at a time

// A walk's cell (i, j) in dirs[b, :, d, :] ([B, N1, D, W], W % 8 == 0,
// 16-byte aligned) and the warp's tile of those codes in shared memory. Every
// lane of the warp holds the same cursor and calls step() together.
struct TileWalk {
  const short* base;  // this lane's piece of row 0: column piece lane % 8, row lane / 8
  short* tile;        // the warp's kTileRows x kTileCols codes
  short* mine;        // this lane's piece of the tile
  size_t row_stride;
  int W, P, marker_d;
  int lane;
  int i, j;
  int r0, c0;  // the tile's first row and column: none staged yet

  __device__ __forceinline__ TileWalk(const short* dirs, short* tile_, int lane_, int b, int d,
                                      int N1, int D, int W_, int P_, int i_, int j_)
      : tile(tile_), row_stride((size_t)D * W_), W(W_), P(P_), lane(lane_), i(i_), j(j_),
        r0(i_ + 1), c0(0) {
    const int pb = 32 - __clz(2 * P_ + 3);  // ceil(log2(2P + 4))
    marker_d = (1 << pb) - 1;
    base = dirs + (size_t)b * N1 * D * W_ + (size_t)d * W_ + (lane_ & 7) * 8 +
           (size_t)(lane_ >> 3) * row_stride;
    mine = tile_ + (lane_ >> 3) * kTileCols + (lane_ & 7) * 8;
  }

  // rows [i-63, i] by the 64 columns ending with j's 16-byte piece, clamped at 0
  __device__ __forceinline__ void stage() {
    r0 = max(i - kTileRows + 1, 0);
    c0 = max(((j + 8) & ~7) - kTileCols, 0);
    __syncwarp();  // every lane has read its last code of the previous tile
    if ((lane & 7) * 8 < W - c0) {
      const short* src = base + (size_t)r0 * row_stride + c0;
      short* dst = mine;
      for (int rr = lane >> 3; rr <= i - r0; rr += 4) {
        __pipeline_memcpy_async(dst, src, 16);
        src += 4 * row_stride;
        dst += 4 * kTileCols;
      }
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncwarp();  // every lane's pieces are in
  }

  // The move at (i, j): false at sw's stop code; else its run header (the
  // first pair (pn0, pp0), -1 for an insertion or a deletion, and its rl
  // pairs: a marked run is jumped whole) and (i, j) moves past it.
  template <int MODE>
  __device__ __forceinline__ bool step(int& pn0, int& pp0, int& rl) {
    if (i < r0 || j < c0) stage();
    const int code = tile[(i - r0) * kTileCols + (j - c0)];
    const int pr = code >> kDeltaBits, dl = code & kDmask;
    if (MODE == kSW && pr == 0) return false;
    const bool mrkd = pr == marker_d, mrkv = pr == marker_d - 1;
    const bool is_run = mrkd || mrkv;
    const bool is_diag = (pr >= P + 2 && pr < marker_d - 1) || mrkd;
    const bool is_vert = (pr >= 2 && pr <= P + 1) || mrkv;
    const bool moves = is_diag || is_vert;
    const int delta = is_run ? 1 : dl;
    rl = is_run ? dl : 1;
    int pi1 = moves ? i - delta : i;
    if (delta == 0) pi1 = moves ? 0 : i;  // delta 0: the predecessor is row 0
    const int pj1 = (is_diag || !is_vert) ? j - 1 : j;
    pn0 = pi1 == i ? -1 : i - 1;
    pp0 = pj1 == j ? -1 : j - 1;
    i = is_run ? i - rl : pi1;
    j = (is_run && is_diag) ? j - rl : pj1;
    return true;
  }

  // whether the walk goes on from (i, j) (sw: until its stop code)
  template <int MODE>
  __device__ __forceinline__ bool goes_on() const {
    if (MODE == kNW) return !(i == 0 && j == 0);
    if (MODE == kOV) return !(i == 0 || j == 0);
    return true;
  }
};

// whether walk (maxi, maxj) takes a first step
template <int MODE>
__device__ __forceinline__ bool walk_starts(int i, int j) {
  return MODE == kOV ? (i != 0 && j != 0) : !(i == 0 && j == 0);
}

template <int MODE>
__global__ void __launch_bounds__(32 * kWalkWarps) poa_walk_kernel(
    const short* __restrict__ dirs,  // [B, N1, D, W], W % 8 == 0, 16-byte aligned
    const int* __restrict__ maxi, const int* __restrict__ maxj,  // [B, D]
    int* __restrict__ runs,          // [L, B*D] zero-filled
    int* __restrict__ count,         // [B, D]
    int* __restrict__ steps,         // [1] zero-filled: max headers per walk
    int B, int N1, int D, int W, int L, int P) {
  __shared__ __align__(16) short tiles[kWalkWarps][kTileRows * kTileCols];
  const int BD = B * D;
  const int lane = threadIdx.x & 31;
  const int w = blockIdx.x * kWalkWarps + (threadIdx.x >> 5);
  if (w >= BD) return;  // no block barrier: a spare warp just leaves
  const int i0 = maxi[w], j0 = maxj[w];
  TileWalk t(dirs, tiles[threadIdx.x >> 5], lane, w / D, w % D, N1, D, W, P, i0, j0);
  bool active = walk_starts<MODE>(i0, j0);
  int cnt = 0, step = 0;
  while (active && step < L) {
    int pn0, pp0, rl;
    if (!t.step<MODE>(pn0, pp0, rl)) break;
    // every lane stores the same word: one store, no branch
    runs[(size_t)step * BD + w] = ((pn0 + 2) << kRunPnShift) | ((pp0 + 2) << kRunRBits) | rl;
    cnt += rl;
    ++step;
    active = t.goes_on<MODE>();
  }
  if (lane == 0) {
    count[w] = cnt;
    if (step) atomicMax(steps, step);
  }
}

// The warp's inclusive prefix sum of v
__device__ __forceinline__ int warp_inclusive_sum(int v) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(kFull, v, o);
    if ((threadIdx.x & 31) >= o) v += u;
  }
  return v;
}

// Pair p of a chunk of 32 runs whose inclusive scan of run lengths is es:
// the run k that holds it (a 5-step search) and its place q in that run. The
// run's pair q is (pn0 - q, pp0 - q), or (pn0, -1) from a deletion (pp0 =
// -1); a run of one pair has q = 0.
__device__ __forceinline__ int chunk_run(const int* es, int p, int& q) {
  int k = 0;  // the first run that ends past pair p
#pragma unroll
  for (int half = 16; half > 0; half >>= 1)
    if (es[k + half - 1] <= p) k += half;
  q = p - (k ? es[k - 1] : 0);
  return k;
}

// The expansion: walk w's headers to its count[w] pairs, front to back, at
// pairs[offsets[w], offsets[w] + count[w]), each pair one word of two int16
// halves: the node id (node_id of the rank) or -1, then the position or -1.
// Replaces the host decode of the JAX backend (poa_pallas.py runs_to_pairs_np,
// ranks_to_node_ids_np). One warp a walk: 32 headers at a time (the next 32
// loaded while these expand), a shuffle scan of their run lengths, then the
// lanes take the pairs those headers hold in turn, each finding its header by
// a 5-step search of the scan (chunk_run), so that a run of 511 pairs spreads
// over the warp and consecutive lanes write consecutive words. The warp reads
// every header row below S, so that headers holding more pairs than count[w]
// (a chunk's runs past the count, or a run after it) are caught as well as
// fewer: either sets *err, on which the wrapper raises, as the plain version
// does. Bound by the latency of its few dependent loads a walk (headers, node
// ids), not by its bytes.
constexpr int kExpandWarps = 4;
constexpr int kExpandUnroll = 4;  // pairs a lane takes before it stores them

__global__ void __launch_bounds__(32 * kExpandWarps) poa_expand_kernel(
    const int* __restrict__ runs,            // [L, B*D] headers from poa_walk_kernel
    const int* __restrict__ count,           // [B*D]
    const long long* __restrict__ offsets,   // [B*D] exclusive scan of count
    const int* __restrict__ node_id,         // [B, N]
    unsigned* __restrict__ pairs,            // [total] pn | pp << 16
    int* __restrict__ err,                   // [1] set to 1 where headers and count disagree
    int BD, int D, int N, int S) {           // S: header rows to read (steps)
  __shared__ int hdr[kExpandWarps][32], ends[kExpandWarps][32];
  const int lane = threadIdx.x & 31, wi = threadIdx.x >> 5;
  const int w = blockIdx.x * kExpandWarps + wi;
  if (w >= BD) return;
  const int c = count[w];
  unsigned* out = pairs + offsets[w];
  const int* nid = node_id + (size_t)(w / D) * N;
  int* hs = hdr[wi];
  int* es = ends[wi];
  int h = lane < S ? runs[(size_t)lane * BD + w] : 0;
  int done = 0;
  bool bad = false;
  for (int s0 = 0; s0 < S; s0 += 32) {
    const int s = s0 + 32 + lane;
    const int h_next = s < S ? runs[(size_t)s * BD + w] : 0;
    const int e = warp_inclusive_sum(h & ((1 << kRunRBits) - 1));
    hs[lane] = h;
    es[lane] = e;
    __syncwarp();
    const int tot = __shfl_sync(kFull, e, 31);
    if (tot > c - done) {  // more pairs than count: uniform over the warp
      bad = true;
      break;
    }
    for (int p0 = 0; p0 < tot; p0 += 32 * kExpandUnroll) {
      unsigned word[kExpandUnroll] = {};
      int dst[kExpandUnroll];
#pragma unroll
      for (int u = 0; u < kExpandUnroll; ++u) {
        const int p = p0 + u * 32 + lane;
        dst[u] = -1;
        if (p >= tot) continue;
        int q;
        const int hk = hs[chunk_run(es, p, q)];
        const int pn = (hk >> kRunPnShift) - 2 - q;
        const int pp0 = ((hk >> kRunRBits) & ((1 << kRunPpBits) - 1)) - 2;
        const int pp = pp0 >= 0 ? pp0 - q : pp0;
        const int node = pn >= 0 ? nid[pn] : -1;
        word[u] = ((unsigned)node & 0xffffu) | ((unsigned)pp << 16);
        dst[u] = c - 1 - (done + p);  // walk order is back to front
      }
#pragma unroll
      for (int u = 0; u < kExpandUnroll; ++u)
        if (dst[u] >= 0) out[dst[u]] = word[u];
    }
    done += tot;
    h = h_next;
    __syncwarp();  // every lane has read hs, es before the next chunk's stores
  }
  if ((bad || done != c) && lane == 0) atomicExch(err, 1);
}

// Columns [0, n) of an int16 row to -2, by the warp: 16 bytes a lane
// between the row's first 16-byte boundary and its last, one column a lane
// before and after (rows start wherever w * L * 2 bytes puts them).
__device__ __forceinline__ void fill_neg2(short* row, int n, int lane) {
  const int head = min(n, (int)((16 - (reinterpret_cast<size_t>(row) & 15)) & 15) >> 1);
  if (lane < head) row[lane] = -2;
  const int pieces = (n - head) >> 3;
  int4* body = reinterpret_cast<int4*>(row + head);
  const int v = (int)0xfffefffeu;
  for (int c = lane; c < pieces; c += 32) body[c] = make_int4(v, v, v, v);
  const int tail = head + (pieces << 3);  // fewer than 8 columns left
  if (tail + lane < n) row[tail + lane] = -2;
}

// The dense walk: walk w's pairs written back to front into pn/pp [B*D, L]
// int16, so that they are its last count[w] columns; every column before
// them holds -2. With node_id != nullptr pn holds node ids, else DP ranks.
// Replaces _traceback_walk of poa_pallas.py (all walks stepping together,
// one gather and one pair a step). One warp a walk, kWalkWarps walks a block,
// stepping with K2's cursor over staged tiles (TileWalk), so a marked run is
// one step of the chain: K1 marks a cell whose move is the last of a chain of
// rl diagonal (or vertical) delta-1 moves, and those moves' pairs are (i-1-k,
// j-1-k) (or (i-1-k, -1)), the ones the unit walk would step through. Lane
// k % 32 keeps header k; every 32 headers, and once at the end, the warp
// expands them as the expansion does (a shuffle scan of their run lengths,
// each lane taking pairs p, p+32, ... by chunk_run), so consecutive lanes
// write consecutive columns and the node ids are loads of their own, off the
// chain. The walk stops after L pairs, as the unit walk does, so its last
// run is cut at the pairs left. Then the warp writes the -2 columns of its
// two rows (fill_neg2). No block barrier: a spare warp leaves. 4 warps take
// 33 KB of static shared memory: K2's tiles and the headers of a chunk. What
// bounds it is K2's chain of steps plus a chunk's expansion every 32 of them:
// the kernel alone takes about what K2 and the expansion take together.
template <int MODE>
__global__ void __launch_bounds__(32 * kWalkWarps) poa_walk_dense_kernel(
    const short* __restrict__ dirs,  // [B, N1, D, W], W % 8 == 0, 16-byte aligned
    const int* __restrict__ maxi, const int* __restrict__ maxj,  // [B, D]
    const int* __restrict__ node_id,  // [B, N1 - 1] or nullptr
    short* __restrict__ pn, short* __restrict__ pp,  // [B*D, L]
    int* __restrict__ count,                         // [B, D]
    int B, int N1, int D, int W, int L, int P) {
  __shared__ __align__(16) short tiles[kWalkWarps][kTileRows * kTileCols];
  __shared__ int hdr[kWalkWarps][32], ends[kWalkWarps][32];
  const int BD = B * D;
  const int lane = threadIdx.x & 31, wi = threadIdx.x >> 5;
  const int w = blockIdx.x * kWalkWarps + wi;
  if (w >= BD) return;  // no block barrier: a spare warp just leaves
  const int b = w / D;
  const int* nid = node_id ? node_id + (size_t)b * (N1 - 1) : nullptr;
  short* pn_w = pn + (size_t)w * L;
  short* pp_w = pp + (size_t)w * L;
  int* hs = hdr[wi];
  int* es = ends[wi];
  const int i0 = maxi[w], j0 = maxj[w];
  TileWalk t(dirs, tiles[wi], lane, b, w % D, N1, D, W, P, i0, j0);
  bool active = walk_starts<MODE>(i0, j0);
  int total = 0, done = 0;  // pairs walked; pairs written (those of earlier chunks)
  int k = 0;                // headers held
  int hpn = 0, hpp = 0, hrl = 0;  // lane k's header
  // headers whose pairs the chunks write: columns [L - total, L - done)
  auto write_chunk = [&]() {
    const int e = warp_inclusive_sum(hrl);
    hs[lane] = (hpn & 0xffff) | (hpp << 16);
    es[lane] = e;
    __syncwarp();
    const int tot = total - done;
    for (int p0 = 0; p0 < tot; p0 += 32 * kExpandUnroll) {
      int vn[kExpandUnroll], vp[kExpandUnroll], col[kExpandUnroll];
#pragma unroll
      for (int u = 0; u < kExpandUnroll; ++u) {
        const int p = p0 + u * 32 + lane;
        col[u] = -1;
        if (p >= tot) continue;
        int q;
        const int h = hs[chunk_run(es, p, q)];
        const int pn0 = (short)(h & 0xffff), pp0 = h >> 16;
        const int rank = pn0 - q;
        vn[u] = rank >= 0 && nid ? nid[rank] : rank;
        vp[u] = pp0 >= 0 ? pp0 - q : pp0;
        col[u] = L - 1 - (done + p);  // walk order is back to front
      }
#pragma unroll
      for (int u = 0; u < kExpandUnroll; ++u)
        if (col[u] >= 0) {
          pn_w[col[u]] = (short)vn[u];
          pp_w[col[u]] = (short)vp[u];
        }
    }
    __syncwarp();  // every lane has read hs, es before the next chunk's stores
    done = total;
    k = 0;
    hrl = 0;
  };
  // a header holds at least one pair, so L steps reach L pairs
  for (int s = 0; active && total < L && s < L; ++s) {
    int pn0, pp0, rl;
    if (!t.step<MODE>(pn0, pp0, rl)) break;
    rl = min(rl, L - total);  // the unit walk stops after L pairs, maybe inside a run
    if (lane == k) {
      hpn = pn0;
      hpp = pp0;
      hrl = rl;
    }
    total += rl;
    active = t.goes_on<MODE>();
    if (++k == 32) write_chunk();
  }
  if (k) write_chunk();
  fill_neg2(pn_w, L - total, lane);
  fill_neg2(pp_w, L - total, lane);
  if (lane == 0) count[w] = total;
}

template <int LPT, int PMAX, bool SMEM, bool EXACT, bool SW>
int k1_launch(const K1Args& a, int B, int warps, int smem_bytes, cudaStream_t stream) {
  auto kern = poa_dp_kernel<LPT, PMAX, SMEM, EXACT, SW>;
  if (smem_bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem_bytes);
    if (e != cudaSuccess) return (int)e;
  }
  // one block per (window, group of `warps` sequences), one warp a sequence
  kern<<<dim3(B, (a.D + warps - 1) / warps), 32 * warps, smem_bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int LPT, int PMAX, bool EXACT>
int k1_variant(const K1Args& a, int B, int warps, int smem_bytes, int use_smem,
               cudaStream_t stream) {
  if (a.mode == kSW)
    return use_smem ? k1_launch<LPT, PMAX, true, EXACT, true>(a, B, warps, smem_bytes, stream)
                    : k1_launch<LPT, PMAX, false, EXACT, true>(a, B, warps, smem_bytes, stream);
  return use_smem ? k1_launch<LPT, PMAX, true, EXACT, false>(a, B, warps, smem_bytes, stream)
                  : k1_launch<LPT, PMAX, false, EXACT, false>(a, B, warps, smem_bytes, stream);
}

}  // namespace

extern "C" {

const char* cuda_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

int poa_dp_launch(const int* codes, const int* aux, const int* deg, const int* sink,
                  const int* n_nodes, const int* seqp, const int* slen, short* dirs,
                  int* maxi, int* maxj, int* score, short* hring, int B, int N, int P,
                  int D, int W, int R, int mode, int m, int x, int g, int SH,
                  int edge_slots, int warps, int use_smem, int smem_bytes, void* stream) {
  // the launch plan (poa_linear.dp_launch_plan) must agree with the kernel's
  // shared-memory layout
  const long slice = 2L * W + (use_smem ? (long)(R + 1) * W : 0);
  if (W % 32 != 0 || W < 32 || W > 1024 || warps < 1 || warps > kK1MaxWarps ||
      (long)smem_bytes != warps * slice * (long)sizeof(short) ||
      (edge_slots != 8 && edge_slots != 16) || edge_slots < (P < 16 ? P : 16))
    return (int)cudaErrorInvalidValue;
  const K1Args a{codes, aux, deg, sink, n_nodes, seqp, slen, dirs, maxi, maxj, score,
                 hring, N, P, D, W, R, mode, m, x, g, SH};
  const bool p16 = edge_slots == 16;
  cudaStream_t st = (cudaStream_t)stream;
  switch (W / 32) {
    case 4: return p16 ? k1_variant<4, 16, true>(a, B, warps, smem_bytes, use_smem, st)
                       : k1_variant<4, 8, true>(a, B, warps, smem_bytes, use_smem, st);
    case 10: return p16 ? k1_variant<10, 16, true>(a, B, warps, smem_bytes, use_smem, st)
                        : k1_variant<10, 8, true>(a, B, warps, smem_bytes, use_smem, st);
    case 18: return p16 ? k1_variant<18, 16, true>(a, B, warps, smem_bytes, use_smem, st)
                        : k1_variant<18, 8, true>(a, B, warps, smem_bytes, use_smem, st);
    case 24: return p16 ? k1_variant<24, 16, true>(a, B, warps, smem_bytes, use_smem, st)
                        : k1_variant<24, 8, true>(a, B, warps, smem_bytes, use_smem, st);
    default: return p16 ? k1_variant<32, 16, false>(a, B, warps, smem_bytes, use_smem, st)
                        : k1_variant<32, 8, false>(a, B, warps, smem_bytes, use_smem, st);
  }
}

int poa_walk_launch(const short* dirs, const int* maxi, const int* maxj, int* runs,
                    int* count, int* steps, int B, int N1, int D, int W, int L, int P,
                    int mode, void* stream) {
  // the tiles are copied in 16-byte pieces: every row must start on one
  if (W % 8 != 0 || reinterpret_cast<size_t>(dirs) % 16 != 0) return (int)cudaErrorInvalidValue;
  const int blocks = (B * D + kWalkWarps - 1) / kWalkWarps;
  auto kern = mode == kSW ? poa_walk_kernel<kSW>
                          : (mode == kOV ? poa_walk_kernel<kOV> : poa_walk_kernel<kNW>);
  kern<<<blocks, 32 * kWalkWarps, 0, (cudaStream_t)stream>>>(dirs, maxi, maxj, runs, count,
                                                              steps, B, N1, D, W, L, P);
  return (int)cudaGetLastError();
}

int poa_expand_launch(const int* runs, const int* count, const long long* offsets,
                      const int* node_id, unsigned* pairs, int* err, int BD, int D, int N,
                      int S, void* stream) {
  const int blocks = (BD + kExpandWarps - 1) / kExpandWarps;
  poa_expand_kernel<<<blocks, 32 * kExpandWarps, 0, (cudaStream_t)stream>>>(
      runs, count, offsets, node_id, pairs, err, BD, D, N, S);
  return (int)cudaGetLastError();
}

int poa_walk_dense_launch(const short* dirs, const int* maxi, const int* maxj,
                          const int* node_id, short* pn, short* pp, int* count, int B,
                          int N1, int D, int W, int L, int P, int mode, void* stream) {
  // the tiles are copied in 16-byte pieces: every row must start on one
  if (W % 8 != 0 || reinterpret_cast<size_t>(dirs) % 16 != 0) return (int)cudaErrorInvalidValue;
  const int blocks = (B * D + kWalkWarps - 1) / kWalkWarps;
  auto kern = mode == kSW ? poa_walk_dense_kernel<kSW>
                          : (mode == kOV ? poa_walk_dense_kernel<kOV> : poa_walk_dense_kernel<kNW>);
  kern<<<blocks, 32 * kWalkWarps, 0, (cudaStream_t)stream>>>(dirs, maxi, maxj, node_id, pn, pp,
                                                              count, B, N1, D, W, L, P);
  return (int)cudaGetLastError();
}

}  // extern "C"
