// Masked-uniform selection for Hopper, and the group-stretch proposal fused
// around it.  Built by eryn_tpu_torch/ops/_build.py; the wrappers are
// eryn_tpu_torch/ops/select_kernels.py:group_stretch_propose and
// onehot_select.
//
// Replaces eryn_tpu/ops/select_kernels.py:_select_kernel (onehot_select) and
// the tensor ops eryn_tpu/moves/rbgroupstretch.py:get_proposal_kernel puts
// around it.  The TPU kernel builds a (Qb, M) one-hot tile in VMEM, marking
// the rows whose running count equals k + 1, and contracts it against a
// zeroed copy of the complement with a lane reduction: O(Q * M) compares a
// temperature, and its inputs (the running counts, the queries, the zeroed
// and concatenated complement) are prepared by a dozen XLA ops because a
// VMEM tile wants them dense.  Nothing on this card asks for that layout.
//
// What bounds it on the card: at the LISA-style shape (10 temperatures, 100
// moving and 100 complement walkers, 8 leaves of 3 parameters) a proposal
// moves about 0.3 MB, a tenth of a microsecond at 3.35 TB/s, so the time is
// the launch and the longest chain of dependent memory trips inside it.  The
// design keeps that chain short and everything else out of device memory:
//
// * The 0/1 mask of one temperature's complement becomes one __ballot_sync
//   word per 32 entries in shared memory, with an exclusive prefix of the
//   words' bit counts beside it: 8 bytes per 32 entries (800 entries are 25
//   words), so about 929,000 entries fit a block's 227 KB; the wrappers
//   raise beyond that.  The counts are integers, exact at any size.
// * A pick is a binary search over the prefixes in shared memory and __fns
//   (the n-th set bit) inside one word: no dependent trip to global memory
//   before the one row load.  It lands on active rows only, so dormant rows
//   (which may hold NaN) are never read and no zeroed copy is made.
// * The complement is read where it lies: the rows of the permuted ensemble
//   before and after the moving block, a flat index with one gap.  No
//   concatenated copy of coordinates or masks.
// * The fused kernel goes on from the pick to the stretch (the periodic
//   difference and wrap included), the move mask and the factors, for every
//   branch of a small table passed by value, so a red/blue block's proposal
//   is one launch.
// * What does not depend on the scan (the draws, the moving leaf's mask, the
//   walker's count of moving dimensions) is requested before it, so that
//   those loads and the mask's are in flight together.
// * Each block scans its temperature's masks itself; the moving walkers of
//   a temperature are spread over a few blocks to fill more of the card,
//   and repeating the scan (a few hundred bytes) is cheaper than sharing it.
//
// The arithmetic is that of the plain version, operation for operation,
// through the round-to-nearest intrinsics of common.cuh.
#include "common.cuh"

namespace {

using eryn::Ops;

constexpr int kMaxBranches = 8;  // ops/select_kernels.py:MAX_BRANCHES
constexpr unsigned kFull = 0xffffffffu;
constexpr int kGroup = 4;  // words a warp scans at a time

// The mask of M entries as ballot words with an exclusive prefix of their
// bit counts: words[w] bit b is active(32 w + b), prefix[w] the active
// entries before word w.  Every thread of the block calls it (blockDim.x a
// multiple of 32, at most 1024); returns the number of active entries.
// warp_sums holds 32 ints.
template <typename Pred>
__device__ int scan_mask(Pred active, int M, unsigned* words, int* prefix,
                         int* warp_sums) {
  const int nwords = (M + 31) / 32;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  // a warp takes kGroup consecutive words at a time and asks for all their
  // entries before the first ballot, so their loads are in flight together
  for (int w = warp * kGroup; w < nwords; w += nwarps * kGroup) {
    bool on[kGroup];
#pragma unroll
    for (int k = 0; k < kGroup; ++k) {
      const int e = (w + k) * 32 + lane;
      on[k] = e < M ? active(e) : false;
    }
#pragma unroll
    for (int k = 0; k < kGroup; ++k) {
      const unsigned word = __ballot_sync(kFull, on[k]);
      if (lane == 0 && w + k < nwords) words[w + k] = word;
    }
  }
  __syncthreads();
  // each thread sums a strip of consecutive words, the strips' sums are
  // scanned across the block, and each thread writes its strip's prefixes
  const int per = (nwords + static_cast<int>(blockDim.x) - 1) /
                  static_cast<int>(blockDim.x);
  int w0 = static_cast<int>(threadIdx.x) * per;
  if (w0 > nwords) w0 = nwords;
  int w1 = w0 + per;
  if (w1 > nwords) w1 = nwords;
  int sum = 0;
  for (int w = w0; w < w1; ++w) sum += __popc(words[w]);
  int incl = sum;
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += v;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int v = lane < nwarps ? warp_sums[lane] : 0;
    for (int d = 1; d < 32; d <<= 1) {
      const int x = __shfl_up_sync(kFull, v, d);
      if (lane >= d) v += x;
    }
    warp_sums[lane] = v;
  }
  __syncthreads();
  int run = incl - sum + (warp ? warp_sums[warp - 1] : 0);
  for (int w = w0; w < w1; ++w) {
    prefix[w] = run;
    run += __popc(words[w]);
  }
  const int total = warp_sums[nwarps - 1];
  __syncthreads();
  return total;
}

// The entry whose running active count is k1, for 1 <= k1 <= the total: the
// last word whose prefix is below k1 holds it.
__device__ __forceinline__ int pick_entry(const unsigned* words,
                                          const int* prefix, int nwords,
                                          int k1) {
  int lo = 0, hi = nwords;  // first word with prefix >= k1, or nwords
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (prefix[mid] < k1) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  const int w = lo - 1;
  return w * 32 + static_cast<int>(__fns(words[w], 0, k1 - prefix[w]));
}

// floor-style modulo with the sign of the divisor, as torch.remainder and
// jnp.mod compute it: fmod, then one add where the signs differ
template <typename T>
__device__ __forceinline__ T pmod(T x, T p) {
  T r = fmod(x, p);
  if (r != T(0) && ((r < T(0)) != (p < T(0)))) r = Ops<T>::add(r, p);
  return r;
}

template <typename T>
__device__ __forceinline__ T stretch_factor(T u, T a, T a_minus_1, T log_a,
                                            int log_proposal) {
  if (log_proposal) {
    // ln z ~ U[-ln a, ln a]
    const T e = Ops<T>::sub(Ops<T>::mul(T(2), u), T(1));
    return Ops<T>::exp(Ops<T>::mul(e, log_a));
  }
  // z = ((a - 1) u + 1)^2 / a, the square by multiplication
  const T b = Ops<T>::add(Ops<T>::mul(a_minus_1, u), T(1));
  return Ops<T>::div(Ops<T>::mul(b, b), a);
}

template <typename T>
struct Branch {
  const T* s;                   // moving rows: (nt, ns, nl, nd) by s_tstride
  const unsigned char* s_inds;  // (nt, ns, nl) by si_tstride
  const T* c;                   // (nt, rows, nl, nd) contiguous
  const unsigned char* c_inds;  // (nt, rows, nl)
  const T* uu;                  // (nt, ns, nl)
  const T* per_leaf;            // (nl,) moving dimensions a leaf, or null: nd
  const T* period;              // (nd,) periods, inf where none, or null
  T* q;                         // (nt, ns, nl, nd)
  int s_tstride, si_tstride;    // elements between temperatures
  int nl, nd;
};

template <typename T>
struct BranchTable {
  Branch<T> b[kMaxBranches];
  int n;
};

// Block (t, y) proposes walkers [y cw, (y + 1) cw) of the moving block at
// temperature t, branch after branch, then their factors.  The complement
// of every branch is the rows of c outside [off, off + nskip).
template <typename T>
__global__ void __launch_bounds__(256) group_stretch_propose_kernel(
    const BranchTable<T> tab, const T* __restrict__ u, T* __restrict__ factors,
    int ns, int cw, int rows, int off, int nskip, T a, T a_minus_1, T log_a,
    int log_proposal) {
  extern __shared__ unsigned smem[];
  __shared__ int warp_sums[32];
  const int t = blockIdx.x;
  const int j0 = blockIdx.y * cw;
  const int nj = ns - j0 < cw ? ns - j0 : cw;  // at most blockDim.x
  const T* ut = u + static_cast<long>(t) * ns;
  // thread i < nj also sums walker j0 + i's moving dimensions, for its
  // factor (small integers, exact in T)
  const bool walker = static_cast<int>(threadIdx.x) < nj;
  T n_active = T(0);

  for (int b = 0; b < tab.n; ++b) {
    const Branch<T>& br = tab.b[b];
    const int nl = br.nl, nd = br.nd;
    const int M = (rows - nskip) * nl;
    const int nwords = (M + 31) / 32;
    unsigned* words = smem;
    int* prefix = reinterpret_cast<int*>(smem + nwords);
    // flat entry e of the complement lies at e, or past the gap
    const int lo = off * nl, gap = nskip * nl;
    const unsigned char* ci = br.c_inds + static_cast<long>(t) * rows * nl;
    const T* ct = br.c + static_cast<long>(t) * rows * nl * nd;
    const T* st = br.s + static_cast<long>(t) * br.s_tstride;
    const unsigned char* sit = br.s_inds + static_cast<long>(t) * br.si_tstride;
    const T* uut = br.uu + static_cast<long>(t) * ns * nl;

    // what leaf i of this block needs beside the scan.  A thread asks for
    // its first leaf's before the scan, so that these loads and the mask's
    // are in flight together
    const int nq = nj * nl;
    int leaf = 0;
    bool active = false;
    T u_pick = T(0), u_z = T(0);
    auto fetch = [&](int i) {
      leaf = (j0 + i / nl) * nl + i % nl;  // within the temperature
      active = sit[leaf] != 0;
      u_pick = uut[leaf];
      u_z = ut[j0 + i / nl];
    };
    if (threadIdx.x < nq) fetch(threadIdx.x);
    T n_branch = T(0);
    if (walker) {
      const unsigned char* si = sit + (j0 + threadIdx.x) * nl;
      for (int l = 0; l < nl; ++l) {
        if (si[l])
          n_branch = Ops<T>::add(n_branch,
                                 br.per_leaf ? br.per_leaf[l] : T(nd));
      }
    }

    const int cnt = scan_mask(
        [&](int e) { return ci[e < lo ? e : e + gap] != 0; }, M, words,
        prefix, warp_sums);
    // a branch with nothing to stretch toward moves no dimension
    if (cnt > 0) n_active = Ops<T>::add(n_active, n_branch);
    const T scale = T(cnt > 0 ? cnt : 1);

    for (int i = threadIdx.x; i < nq; i += blockDim.x) {
      if (i != static_cast<int>(threadIdx.x)) fetch(i);
      const T* srow = st + static_cast<long>(leaf) * nd;
      T* qrow = br.q + (static_cast<long>(t) * ns * nl + leaf) * nd;
      if (cnt == 0 || !active) {
        // an inactive leaf, or nothing to stretch toward: unchanged, NaN
        // in a dormant slot included
        for (int d = 0; d < nd; ++d) qrow[d] = srow[d];
        continue;
      }
      const T z = stretch_factor(u_z, a, a_minus_1, log_a, log_proposal);
      // k = floor(uu * max(cnt, 1)) in the float type: the product can
      // round up to cnt itself, and then no row has count k + 1
      const long long k1 =
          static_cast<long long>(Ops<T>::floor(Ops<T>::mul(u_pick, scale))) +
          1;
      const T* crow = nullptr;
      if (k1 >= 1 && k1 <= cnt) {
        const int e = pick_entry(words, prefix, nwords, static_cast<int>(k1));
        crow = ct + static_cast<long>(e < lo ? e : e + gap) * nd;
      }
      for (int d = 0; d < nd; ++d) {
        const T cv = crow ? crow[d] : T(0);
        T diff = Ops<T>::sub(cv, srow[d]);
        const T p = br.period ? br.period[d] : T(INFINITY);
        const bool periodic = isfinite(p);
        if (periodic) {
          // minimal signed distance, in [-p/2, p/2)
          const T half = Ops<T>::mul(T(0.5), p);
          diff = Ops<T>::sub(pmod(Ops<T>::add(diff, half), p), half);
        }
        T x = Ops<T>::sub(cv, Ops<T>::mul(diff, z));
        if (periodic) x = pmod(x, p);
        qrow[d] = x;
      }
    }
    __syncthreads();  // the next branch reuses words and prefix
  }

  // the factors: (N - 1) ln z, or N ln z for the log proposal, N the
  // dimensions that moved
  if (walker) {
    const int j = j0 + threadIdx.x;
    const T z = stretch_factor(ut[j], a, a_minus_1, log_a, log_proposal);
    const T expo = log_proposal ? n_active : Ops<T>::sub(n_active, T(1));
    factors[static_cast<long>(t) * ns + j] = Ops<T>::mul(expo, Ops<T>::log(z));
  }
}

// The selection alone, with the TPU kernel's signature: the mask is where
// the running count rises.  Block (t, y) answers queries [256 y, 256 y + 256).
template <typename T>
__global__ void __launch_bounds__(256) onehot_select_kernel(
    const T* __restrict__ cs, const T* __restrict__ kq,
    const T* __restrict__ c_clean, T* __restrict__ out, int M, int Q, int nd) {
  // cs (nt, M); kq (nt, Q); c_clean (nt, M, nd); out (nt, Q, nd)
  extern __shared__ unsigned smem[];
  __shared__ int warp_sums[32];
  const int t = blockIdx.x;
  const int nwords = (M + 31) / 32;
  unsigned* words = smem;
  int* prefix = reinterpret_cast<int*>(smem + nwords);
  const T* row = cs + static_cast<long>(t) * M;
  // the query is asked for before the scan: its load and the counts' are in
  // flight together
  const int q = blockIdx.y * blockDim.x + threadIdx.x;
  const T k = q < Q ? kq[static_cast<long>(t) * Q + q] : T(-1);
  const int cnt = scan_mask(
      [&](int e) { return row[e] != (e ? row[e - 1] : T(0)); }, M, words,
      prefix, warp_sums);
  if (q >= Q) return;
  const T* src = nullptr;
  // a query that is no integer in [0, cnt) matches no running count
  if (k == Ops<T>::floor(k) && k >= T(0) && k < T(cnt)) {
    const int e = pick_entry(words, prefix, nwords, static_cast<int>(k) + 1);
    src = c_clean + (static_cast<long>(t) * M + e) * nd;
  }
  T* dst = out + (static_cast<long>(t) * Q + q) * nd;
  for (int d = 0; d < nd; ++d) dst[d] = src ? src[d] : T(0);
}

template <typename K>
int allow_shared(K kernel, size_t shared) {
  if (shared <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(shared)));
}

template <typename T>
int launch_group(const void* const* s, const void* const* s_inds,
                 const void* const* c, const void* const* c_inds,
                 const void* const* uu, const void* const* per_leaf,
                 const void* const* period, void* const* q,
                 const int* s_tstride, const int* si_tstride, const int* nl,
                 const int* nd, int nbranches, const void* u, void* factors,
                 int nt, int ns, int rows, int off, int nskip, double a,
                 double log_a, int log_proposal, int shared_limit,
                 void* stream) {
  if (nbranches < 1 || nbranches > kMaxBranches || nt < 1 || ns < 1 ||
      off < 0 || nskip < 0 || off + nskip > rows)
    return static_cast<int>(cudaErrorInvalidValue);
  BranchTable<T> tab;
  tab.n = nbranches;
  int max_nl = 1;
  size_t max_words = 0;
  for (int b = 0; b < nbranches; ++b) {
    Branch<T>& br = tab.b[b];
    br.s = static_cast<const T*>(s[b]);
    br.s_inds = static_cast<const unsigned char*>(s_inds[b]);
    br.c = static_cast<const T*>(c[b]);
    br.c_inds = static_cast<const unsigned char*>(c_inds[b]);
    br.uu = static_cast<const T*>(uu[b]);
    br.per_leaf = static_cast<const T*>(per_leaf[b]);
    br.period = static_cast<const T*>(period[b]);
    br.q = static_cast<T*>(q[b]);
    br.s_tstride = s_tstride[b];
    br.si_tstride = si_tstride[b];
    br.nl = nl[b];
    br.nd = nd[b];
    if (nl[b] > max_nl) max_nl = nl[b];
    const size_t words =
        (static_cast<size_t>(rows - nskip) * nl[b] + 31) / 32;
    if (words > max_words) max_words = words;
  }
  const size_t shared = 8 * max_words;
  if (shared > static_cast<size_t>(shared_limit))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = group_stretch_propose_kernel<T>;
  const int err = allow_shared(kernel, shared);
  if (err) return err;
  // a thread a (walker, leaf) of the widest branch, 256 a block (and so at
  // most 256 walkers a block: a thread a factor)
  int cw = 256 / max_nl;
  if (cw < 1) cw = 1;
  if (cw > ns) cw = ns;
  const dim3 grid(nt, (ns + cw - 1) / cw);
  kernel<<<grid, 256, shared, static_cast<cudaStream_t>(stream)>>>(
      tab, static_cast<const T*>(u), static_cast<T*>(factors), ns, cw, rows,
      off, nskip, T(a), T(a - 1.0), T(log_a), log_proposal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_select(const void* cs, const void* kq, const void* c_clean,
                  void* out, int nt, int M, int Q, int nd, void* stream) {
  if (nt < 1 || M < 0 || Q < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t shared = 8 * ((static_cast<size_t>(M) + 31) / 32);
  auto kernel = onehot_select_kernel<T>;
  const int err = allow_shared(kernel, shared);
  if (err) return err;
  const dim3 grid(nt, (Q + 255) / 256);
  kernel<<<grid, 256, shared, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(cs), static_cast<const T*>(kq),
      static_cast<const T*>(c_clean), static_cast<T*>(out), M, Q, nd);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface, loaded with ctypes.  The arrays of the group-stretch
// entry hold one value per branch; masks are bool (one byte); every other
// array is in the state dtype.  Every function returns the CUDA error of its
// launch (0 on success).
#define ERYN_SELECT_ENTRIES(T, SUFFIX)                                        \
  int eryn_group_stretch_propose_##SUFFIX(                                    \
      const void* const* s, const void* const* s_inds, const void* const* c,  \
      const void* const* c_inds, const void* const* uu,                       \
      const void* const* per_leaf, const void* const* period,                 \
      void* const* q, const int* s_tstride, const int* si_tstride,            \
      const int* nl, const int* nd, int nbranches, const void* u,             \
      void* factors, int nt, int ns, int rows, int off, int nskip, double a,  \
      double log_a, int log_proposal, int shared_limit, void* stream) {       \
    return launch_group<T>(s, s_inds, c, c_inds, uu, per_leaf, period, q,     \
                           s_tstride, si_tstride, nl, nd, nbranches, u,       \
                           factors, nt, ns, rows, off, nskip, a, log_a,       \
                           log_proposal, shared_limit, stream);               \
  }                                                                           \
  int eryn_onehot_select_##SUFFIX(const void* cs, const void* kq,             \
                                  const void* c_clean, void* out, int nt,     \
                                  int M, int Q, int nd, void* stream) {       \
    return launch_select<T>(cs, kq, c_clean, out, nt, M, Q, nd, stream);      \
  }

extern "C" {
ERYN_SELECT_ENTRIES(float, f32)
ERYN_SELECT_ENTRIES(double, f64)
}  // extern "C"
