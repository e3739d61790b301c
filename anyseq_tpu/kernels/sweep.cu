// Tiled wavefront sweep of the alignment DP for a batch of problems, for
// NVIDIA Hopper (sm_90a), called from JAX through the XLA FFI.
//
// The (M, N) matrix of every problem is cut into TM x TN tiles. One kernel
// launch covers the tiles of one block anti-diagonal d = bi + bj of every
// problem (grid: problems x tiles); the handler issues all TMB + TNB - 1
// launches on the stream in order, so no host round trip separates them.
// Tiles hand their edges on through device memory: the H (and, affine, F)
// boundary row per problem, and per tile row the H column with its corner
// (and the E column).
//
// One warp relaxes one tile. Lane k owns R consecutive query rows and walks
// the tile's columns staggered by k steps: at step t it relaxes column
// t - k. The value above its first row comes from lane k - 1 by a warp
// shuffle (that lane relaxed the same column one step earlier), the value
// left of each row is the lane's own register from the previous step, so a
// tile needs no shared-memory barrier inside its sweep.
//
// Semantics are those of engine/xla_linmem.score_rows and
// engine/xla_affine.score_rows_affine: int32 max-plus arithmetic, rows at or
// beyond a problem's length carry the row above unchanged (so the final
// boundary row is H[m-1]), and `best` is the row-major first maximum over
// the valid cells. Results are bit-identical to those engines.
#include <cstdint>

#include <cuda_runtime.h>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr int LANES = 32;
constexpr int R = 4;              // query rows per lane
constexpr int TM = LANES * R;     // tile height (must match sweep.py)
constexpr int TN = 128;           // tile width (must match sweep.py)
constexpr int32_t SCORE_MIN = -2147483647;
constexpr int32_t NEG = -(1 << 29);  // xla_affine.NEG
constexpr unsigned FULL = 0xffffffffu;

enum { GLOBAL = 0, SEMIGLOBAL = 1, LOCAL = 2 };

struct Scoring {
  int32_t match, mismatch, gap, go, ge;
};

struct Problem {
  const int32_t* q;      // (P, M) query symbols
  const int32_t* s;      // (P, N) subject symbols
  const int32_t* ms;     // (P,) query lengths
  const int32_t* ns;     // (P,) subject lengths
  const int32_t* sgap;   // (P,) affine GLOBAL: top row continues a paid gap
  int32_t* hrow;         // (P, N) H boundary row; ends as H[m-1][:]
  int32_t* frow;         // (P, N) F boundary row (affine)
  int32_t* vcol;         // (P, TMB, TM + 1) H column, [0] = corner
  int32_t* vcole;        // (P, TMB, TM) E column (affine)
  int32_t* last_col;     // (P, M) H[i][n-1]
  int32_t* last_col_e;   // (P, M) E[i][n-1] (affine)
  int32_t* best_rows;    // (P, TMB, 3) running best of each tile row
  int M, N, TMB;
  Scoring sc;
};

// H on the boundary row i = -1 (j >= 0), boundary column j = -1 (i >= 0)
// and the corner, per scheme (xla_linmem._init_col, xla_affine._col_bound).
template <int MODE, bool AFFINE>
__device__ __forceinline__ int32_t top_h(int j, bool sg, const Scoring& sc) {
  if (MODE != GLOBAL) return 0;
  if (!AFFINE) return (j + 1) * sc.gap;
  return (sg ? 0 : sc.go) + (j + 1) * sc.ge;
}

template <int MODE, bool AFFINE>
__device__ __forceinline__ int32_t left_h(int i, bool sg, const Scoring& sc) {
  if (MODE != GLOBAL) return 0;
  if (!AFFINE) return (i + 1) * sc.gap;
  return sg ? NEG : sc.go + (i + 1) * sc.ge;
}

template <int MODE, bool AFFINE>
__device__ __forceinline__ int32_t corner_h(bool sg) {
  return (AFFINE && MODE == GLOBAL && sg) ? NEG : 0;
}

__device__ __forceinline__ bool lex_better(int32_t s1, int32_t i1, int32_t j1,
                                           int32_t s0, int32_t i0,
                                           int32_t j0) {
  return s1 > s0 || (s1 == s0 && (i1 < i0 || (i1 == i0 && j1 < j0)));
}

template <int MODE, bool AFFINE, bool BEST>
__global__ void __launch_bounds__(LANES)
sweep_diag(Problem pb, int d, int bi_lo) {
  const int p = blockIdx.x;
  const int bi = bi_lo + blockIdx.y;
  const int bj = d - bi;
  const int m = pb.ms[p];
  const int n = pb.ns[p];
  const int i0 = bi * TM;
  const int j0 = bj * TN;
  if (i0 >= m || j0 >= n) return;  // tile outside this problem

  const Scoring sc = pb.sc;
  const bool sg = AFFINE && MODE == GLOBAL && pb.sgap[p] != 0;
  const int lane = threadIdx.x;
  const int64_t prow = static_cast<int64_t>(p) * pb.N;
  const int64_t pcol = static_cast<int64_t>(p) * pb.M;
  int32_t* vcol = pb.vcol + (static_cast<int64_t>(p) * pb.TMB + bi) * (TM + 1);
  int32_t* vcole = pb.vcole + (static_cast<int64_t>(p) * pb.TMB + bi) * TM;

  __shared__ int32_t s_sym[TN];
  __shared__ int32_t s_top[TN];   // H row above the tile, then its last row
  __shared__ int32_t s_topf[TN];  // the same for F (affine)

  for (int c = lane; c < TN; c += LANES) {
    const int j = j0 + c;
    s_sym[c] = pb.s[prow + j];
    s_top[c] = bi == 0 ? top_h<MODE, AFFINE>(j, sg, sc) : pb.hrow[prow + j];
    if (AFFINE) s_topf[c] = bi == 0 ? NEG : pb.frow[prow + j];
  }

  // lft[0] = H[first row - 1][j0 - 1]; lft[1 + r] = H[row r][j0 - 1].
  const int row0 = i0 + lane * R;
  int32_t lft[R + 1];
  int32_t hcur[R], ecur[R], qsym[R];
#pragma unroll
  for (int r = 0; r <= R; ++r) {
    const int i = row0 - 1 + r;
    int32_t v;
    if (bj > 0) {
      v = vcol[lane * R + r];
    } else if (i < 0) {
      v = corner_h<MODE, AFFINE>(sg);
    } else {
      v = left_h<MODE, AFFINE>(i, sg, sc);
    }
    lft[r] = v;
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    hcur[r] = lft[r + 1];
    // Left of column 0, E + ge must equal xla_affine's NEG + go.
    ecur[r] = (AFFINE && bj > 0) ? vcole[lane * R + r] : NEG + sc.go - sc.ge;
    qsym[r] = pb.q[pcol + row0 + r];
  }
  __syncwarp();

  int32_t prev_up = lft[0];   // H[first row - 1][c - 1]
  int32_t bot_h = 0, bot_f = NEG;
  int32_t rb[R], rj[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    rb[r] = SCORE_MIN;
    rj[r] = -1;
  }

  for (int t = 0; t < TN + LANES - 1; ++t) {
    const int c = t - lane;
    int32_t up = __shfl_up_sync(FULL, bot_h, 1);
    int32_t upf = AFFINE ? __shfl_up_sync(FULL, bot_f, 1) : NEG;
    if (c < 0 || c >= TN) continue;
    if (lane == 0) {
      up = s_top[c];
      if (AFFINE) upf = s_topf[c];
    }
    const int j = j0 + c;
    const int32_t sym = s_sym[c];
    int32_t dg = prev_up;
    prev_up = up;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int32_t sub = qsym[r] == sym ? sc.match : sc.mismatch;
      const int32_t left = hcur[r];
      int32_t h, f = NEG;
      if (AFFINE) {
        f = max(up + sc.go + sc.ge, upf + sc.ge);
        const int32_t e = max(left + sc.go + sc.ge, ecur[r] + sc.ge);
        h = __vimax3_s32(dg + sub, f, e);
        ecur[r] = e;
      } else {
        h = __vimax3_s32(dg + sub, up + sc.gap, left + sc.gap);
      }
      if (MODE == LOCAL) h = max(h, 0);
      if (row0 + r >= m) {  // past the query: carry the row above
        h = up;
        f = upf;
      }
      if (BEST && row0 + r < m && j < n && h > rb[r]) {
        rb[r] = h;
        rj[r] = j;
      }
      dg = left;
      hcur[r] = h;
      up = h;
      upf = f;
    }
    bot_h = up;
    bot_f = upf;
    if (j == n - 1) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        pb.last_col[pcol + row0 + r] = hcur[r];
        if (AFFINE) pb.last_col_e[pcol + row0 + r] = ecur[r];
      }
    }
    if (c == TN - 1) {  // right edge: the next tile's left column
      if (lane == 0) vcol[0] = prev_up;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        vcol[lane * R + r + 1] = hcur[r];
        if (AFFINE) vcole[lane * R + r] = ecur[r];
      }
    }
    if (lane == LANES - 1) {  // lane 0 read this column LANES - 1 steps ago
      s_top[c] = bot_h;
      if (AFFINE) s_topf[c] = bot_f;
    }
  }
  __syncwarp();
  for (int c = lane; c < TN; c += LANES) {
    pb.hrow[prow + j0 + c] = s_top[c];
    if (AFFINE) pb.frow[prow + j0 + c] = s_topf[c];
  }

  if (BEST) {
    int32_t bs = SCORE_MIN, bi_ = -1, bj_ = -1;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (rb[r] > bs) {
        bs = rb[r];
        bi_ = row0 + r;
        bj_ = rj[r];
      }
    }
#pragma unroll
    for (int off = LANES / 2; off > 0; off /= 2) {
      const int32_t os = __shfl_down_sync(FULL, bs, off);
      const int32_t oi = __shfl_down_sync(FULL, bi_, off);
      const int32_t oj = __shfl_down_sync(FULL, bj_, off);
      if (lex_better(os, oi, oj, bs, bi_, bj_)) {
        bs = os;
        bi_ = oi;
        bj_ = oj;
      }
    }
    if (lane == 0) {
      int32_t* acc = pb.best_rows + (static_cast<int64_t>(p) * pb.TMB + bi) * 3;
      if (bj == 0 || lex_better(bs, bi_, bj_, acc[0], acc[1], acc[2])) {
        acc[0] = bs;
        acc[1] = bi_;
        acc[2] = bj_;
      }
    }
  }
}

template <int MODE, bool AFFINE, bool BEST>
void launch_all(const Problem& pb, int P, cudaStream_t stream) {
  const int TNB = pb.N / TN;
  for (int d = 0; d < pb.TMB + TNB - 1; ++d) {
    const int lo = d - TNB + 1 > 0 ? d - TNB + 1 : 0;
    const int hi = d < pb.TMB - 1 ? d : pb.TMB - 1;
    const dim3 grid(P, hi - lo + 1);
    sweep_diag<MODE, AFFINE, BEST><<<grid, LANES, 0, stream>>>(pb, d, lo);
  }
}

template <int MODE>
void dispatch_flags(const Problem& pb, int P, bool affine, bool best,
                    cudaStream_t stream) {
  if (affine) {
    if (best) launch_all<MODE, true, true>(pb, P, stream);
    else launch_all<MODE, true, false>(pb, P, stream);
  } else {
    if (best) launch_all<MODE, false, true>(pb, P, stream);
    else launch_all<MODE, false, false>(pb, P, stream);
  }
}

ffi::Error SweepImpl(cudaStream_t stream, ffi::Buffer<ffi::S32> q,
                     ffi::Buffer<ffi::S32> s, ffi::Buffer<ffi::S32> ms,
                     ffi::Buffer<ffi::S32> ns, ffi::Buffer<ffi::S32> sgap,
                     ffi::ResultBuffer<ffi::S32> last_row,
                     ffi::ResultBuffer<ffi::S32> last_col,
                     ffi::ResultBuffer<ffi::S32> last_col_e,
                     ffi::ResultBuffer<ffi::S32> best_rows,
                     ffi::ResultBuffer<ffi::S32> frow,
                     ffi::ResultBuffer<ffi::S32> vcol,
                     ffi::ResultBuffer<ffi::S32> vcole, int32_t mode,
                     int32_t affine, int32_t best, int32_t match,
                     int32_t mismatch, int32_t gap, int32_t gap_open,
                     int32_t gap_extend) {
  const auto qd = q.dimensions();
  const auto sd = s.dimensions();
  if (qd.size() != 2 || sd.size() != 2 || qd[0] != sd[0]) {
    return ffi::Error::InvalidArgument("q and s must be (P, M) and (P, N)");
  }
  const int64_t P = qd[0], M = qd[1], N = sd[1];
  if (M % TM != 0 || N % TN != 0 || M / TM > 65535) {
    return ffi::Error::InvalidArgument("padded shapes do not fit the tiles");
  }
  if (mode < GLOBAL || mode > LOCAL) {
    return ffi::Error::InvalidArgument("unknown mode");
  }
  if (P == 0) return ffi::Error::Success();

  Problem pb;
  pb.q = q.typed_data();
  pb.s = s.typed_data();
  pb.ms = ms.typed_data();
  pb.ns = ns.typed_data();
  pb.sgap = sgap.typed_data();
  pb.hrow = last_row->typed_data();
  pb.frow = frow->typed_data();
  pb.vcol = vcol->typed_data();
  pb.vcole = vcole->typed_data();
  pb.last_col = last_col->typed_data();
  pb.last_col_e = last_col_e->typed_data();
  pb.best_rows = best_rows->typed_data();
  pb.M = static_cast<int>(M);
  pb.N = static_cast<int>(N);
  pb.TMB = static_cast<int>(M / TM);
  pb.sc = Scoring{match, mismatch, gap, gap_open, gap_extend};

  // Cells no tile of a problem reaches keep a defined value.
  cudaMemsetAsync(pb.hrow, 0, sizeof(int32_t) * P * N, stream);
  cudaMemsetAsync(pb.last_col, 0, sizeof(int32_t) * P * M, stream);
  cudaMemsetAsync(pb.last_col_e, 0, sizeof(int32_t) * P * M, stream);

  switch (mode) {
    case GLOBAL:
      dispatch_flags<GLOBAL>(pb, P, affine, best, stream);
      break;
    case SEMIGLOBAL:
      dispatch_flags<SEMIGLOBAL>(pb, P, affine, best, stream);
      break;
    default:
      dispatch_flags<LOCAL>(pb, P, affine, best, stream);
      break;
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) {
    return ffi::Error::Internal(cudaGetErrorString(err));
  }
  return ffi::Error::Success();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(
    AnyseqSweep, SweepImpl,
    ffi::Ffi::Bind()
        .Ctx<ffi::PlatformStream<cudaStream_t>>()
        .Arg<ffi::Buffer<ffi::S32>>()     // q
        .Arg<ffi::Buffer<ffi::S32>>()     // s
        .Arg<ffi::Buffer<ffi::S32>>()     // ms
        .Arg<ffi::Buffer<ffi::S32>>()     // ns
        .Arg<ffi::Buffer<ffi::S32>>()     // sgap
        .Ret<ffi::Buffer<ffi::S32>>()     // last_row
        .Ret<ffi::Buffer<ffi::S32>>()     // last_col
        .Ret<ffi::Buffer<ffi::S32>>()     // last_col_e
        .Ret<ffi::Buffer<ffi::S32>>()     // best_rows
        .Ret<ffi::Buffer<ffi::S32>>()     // F boundary row (scratch)
        .Ret<ffi::Buffer<ffi::S32>>()     // H boundary columns (scratch)
        .Ret<ffi::Buffer<ffi::S32>>()     // E boundary columns (scratch)
        .Attr<int32_t>("mode")
        .Attr<int32_t>("affine")
        .Attr<int32_t>("best")
        .Attr<int32_t>("match")
        .Attr<int32_t>("mismatch")
        .Attr<int32_t>("gap")
        .Attr<int32_t>("gap_open")
        .Attr<int32_t>("gap_extend"));
