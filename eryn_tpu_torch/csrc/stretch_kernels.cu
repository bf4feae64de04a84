// Stretch-move kernels for Hopper: the proposal and the tempered
// Metropolis-Hastings accept that bracket the likelihood of each red/blue
// half, addressed through the walker permutation.  Built by
// eryn_tpu_torch/ops/_build.py into a shared library with a plain C
// interface; the wrappers are in eryn_tpu_torch/ops/stretch_kernels.py.
//
// Replaces two TPU kernels of eryn_tpu/ops/stretch_kernels.py:
//
// * _propose_kernel (stretch_propose): z draw, complement pick, affine
//   stretch and detailed-balance factor -> stretch_propose_kernel;
// * _accept_kernel (stretch_accept): tempered accept with its two NaN rules
//   and the merge of coords, logL and logp -> stretch_accept_kernel;
// * the two back to back at the half boundary (accept half 0, propose
//   half 1) -> stretch_accept_propose_kernel, one launch.
//
// What bounds them on the card: a call moves 10-200 KB, nanoseconds at the
// memory rate, so the bound is the launch and the host work around it, not
// the bytes.  The design therefore removes launches and device ops:
//
// * eryn_tpu keeps each red/blue half in a contiguous block of the permuted
//   ensemble, because TPU scatters are slow; that layout costs a gather
//   into it, slice copies and an inverse gather out of it every step.  On
//   this card an indexed row load or store costs what a contiguous one
//   does at these sizes, so the layout is dropped: the kernels read the
//   moving walker, its complement row, ndim_act, logL and logp straight from
//   the unpermuted (nt, nw, .) state through perm, and read u from u_all
//   (2, 3, nt, nw) at its offsets.  Half 0 is perm[0:n0] (n0 = nw - nw/2)
//   and its complement row r is walker perm[n0 + r]; half 1 is perm[n0:]
//   and its complement row r is walker perm[r], read from the updated
//   coordinates.
// * The accept writes the merged row, logL, logp and the accept flag in
//   place, in walker order, into (nt, nw) outputs: every walker belongs to
//   exactly one half, so the two halves fill them and no inverse gather is
//   needed.
// * Half 1's complement picks stay inside temperature t, so with one block
//   per temperature the dependency of half 1's proposal on half 0's accept
//   is a __syncthreads() inside the block, and the two run as one launch.
//   The updated half-0 rows are read back through L1/L2 after the barrier,
//   not staged in shared memory.
//
// Groups: ng independent ensembles (ParaEnsembleSampler) lie one after
// another, every per-group array with a leading group axis: the state
// (ng, nt, nw, .), perm (ng, nw), u_all (ng, 2, 3, nt, nw), betas (ng, nt).
// A launch runs ng * nt blocks; block b works on group g = b / nt and
// temperature t = b % nt, with the group's arrays found by offsets, so one
// launch covers every group and ng = 1 is the ungrouped launch.
//
// Threads loop over the walkers of a half with a stride of blockDim.x, so
// halves beyond 1024 walkers stay right.  The arithmetic is that of the TPU
// kernels, through the round-to-nearest intrinsics of common.cuh.
#include "common.cuh"

namespace {

using eryn::Ops;

// u_all is (2, 3, nt, nw): per half the z draw, the complement pick and the
// accept uniform; the j-th walker of a half reads column j
template <typename T>
__device__ __forceinline__ const T* u_row(const T* u_all, int half, int k,
                                          int t, int nt, int nw) {
  return u_all + (static_cast<long>(half * 3 + k) * nt + t) * nw;
}

// The proposal of half `half` at temperature t: moving rows from X, picked
// complement rows from C.  C is not __restrict__: after the barrier of the
// fused kernel it is the output the same block has just written.
// The TPU kernel picks the complement walker with a one-hot matmul on the
// MXU; here it is an indexed load of row floor(u1 * nc), computed from the
// same float product and clamped to nc - 1 so a product that rounds up to
// nc cannot read past the half.
template <typename T>
__device__ __forceinline__ void propose_half(
    const T* __restrict__ X, const T* C, const T* __restrict__ ndim_act,
    const long long* __restrict__ perm, const T* __restrict__ u_all,
    T* __restrict__ q, T* __restrict__ fac, int t, int nt, int nw, int D,
    int half, T a, T a_minus_1, int log_proposal) {
  const int n0 = nw - nw / 2;
  const int ns = half ? nw - n0 : n0;
  const int nc = nw - ns;
  const long long* s_walker = perm + (half ? n0 : 0);
  const long long* c_walker = perm + (half ? 0 : n0);
  const T* u_z = u_row(u_all, half, 0, t, nt, nw);
  const T* u_pick = u_row(u_all, half, 1, t, nt, nw);
  const long base = static_cast<long>(t) * nw;
  for (int j = threadIdx.x; j < ns; j += blockDim.x) {
    T z;
    if (log_proposal) {
      // ln z ~ U[-ln a, ln a]
      const T e = Ops<T>::sub(Ops<T>::mul(T(2), u_z[j]), T(1));
      z = Ops<T>::exp(Ops<T>::mul(e, Ops<T>::log(a)));
    } else {
      // z = ((a - 1) u + 1)^2 / a, the square by multiplication
      const T b = Ops<T>::add(Ops<T>::mul(a_minus_1, u_z[j]), T(1));
      z = Ops<T>::div(Ops<T>::mul(b, b), a);
    }
    int r = static_cast<int>(Ops<T>::floor(Ops<T>::mul(u_pick[j], T(nc))));
    r = r < 0 ? 0 : (r >= nc ? nc - 1 : r);
    const long w = base + s_walker[j];
    const T* srow = X + w * D;
    const T* crow = C + (base + c_walker[r]) * D;
    T* qrow = q + (static_cast<long>(t) * ns + j) * D;
    for (int d = 0; d < D; ++d) {
      const T cv = crow[d];
      qrow[d] = Ops<T>::sub(cv, Ops<T>::mul(Ops<T>::sub(cv, srow[d]), z));
    }
    // detailed-balance exponent: N - 1 for the Goodman-Weare density, N for
    // g(z) ~ 1/z
    const T nd = ndim_act[w];
    const T expo = log_proposal ? nd : Ops<T>::sub(nd, T(1));
    fac[static_cast<long>(t) * ns + j] = Ops<T>::mul(expo, Ops<T>::log(z));
  }
}

// The accept of half `half` at temperature t, merged in place into the
// walker-order outputs.  The two NaN rules of the TPU kernel are kept
// exactly: a NaN tempered log-likelihood (beta = 0 times -inf) becomes
// -inf, and a NaN decision never accepts.
template <typename T>
__device__ __forceinline__ void accept_half(
    const T* __restrict__ q, const T* __restrict__ X,
    const T* __restrict__ ll_new, const T* __restrict__ lp_new,
    const T* __restrict__ logl, const T* __restrict__ logp,
    const T* __restrict__ fac, const T* __restrict__ betas,
    const long long* __restrict__ perm, const T* __restrict__ u_all,
    T* X_out, T* __restrict__ logl_out, T* __restrict__ logp_out,
    T* __restrict__ acc_out, int t, int nt, int nw, int D, int half) {
  const int n0 = nw - nw / 2;
  const int ns = half ? nw - n0 : n0;
  const long long* walker = perm + (half ? n0 : 0);
  const T* u = u_row(u_all, half, 2, t, nt, nw);
  const T beta = betas[t];
  for (int j = threadIdx.x; j < ns; j += blockDim.x) {
    const long i = static_cast<long>(t) * ns + j;
    const long w = static_cast<long>(t) * nw + walker[j];
    const T ln = ll_new[i];
    const T lo = logl[w];
    const T pn = lp_new[i];
    const T po = logp[w];
    T tl_new = Ops<T>::mul(ln, beta);
    T tl_old = Ops<T>::mul(lo, beta);
    if (isnan(tl_new)) tl_new = -INFINITY;
    if (isnan(tl_old)) tl_old = -INFINITY;
    // fac + (tl_new + lp_new) - (tl_old + lp_old), in the TPU kernel's order
    const T lnpdiff = Ops<T>::sub(Ops<T>::add(fac[i], Ops<T>::add(tl_new, pn)),
                                  Ops<T>::add(tl_old, po));
    T d = Ops<T>::sub(lnpdiff, Ops<T>::log(u[j]));
    if (isnan(d)) d = -INFINITY;
    const bool accept = d > T(0);

    const T* src = accept ? q + i * D : X + w * D;
    T* dst = X_out + w * D;
    for (int k = 0; k < D; ++k) dst[k] = src[k];
    logl_out[w] = accept ? ln : lo;
    logp_out[w] = accept ? pn : po;
    acc_out[w] = accept ? T(1) : T(0);
  }
}

// Where block blockIdx.x of a grouped launch works: group g, temperature t,
// and the offsets of the group's arrays, in elements (rows: walker rows of
// the state; half(ns): rows of a half's (ng, nt, ns) arrays).
struct Group {
  long g;
  int t;
  long rows, perm, u, betas;
  __device__ Group(int nt, int nw)
      : g(blockIdx.x / nt),
        t(static_cast<int>(blockIdx.x - g * nt)),
        rows(g * nt * nw),
        perm(g * nw),
        u(6 * rows),
        betas(g * nt) {}
  __device__ long half(long ns) const { return betas * ns; }
};

// at most 1024 threads a block, so at most 64 registers a thread
constexpr int kMaxThreads = 1024;

template <typename T>
__global__ void __launch_bounds__(kMaxThreads) stretch_propose_kernel(
    const T* __restrict__ X, const T* __restrict__ C,
    const T* __restrict__ ndim_act, const long long* __restrict__ perm,
    const T* __restrict__ u_all, T* __restrict__ q, T* __restrict__ fac,
    int nt, int nw, int D, int half, T a, T a_minus_1, int log_proposal) {
  const Group grp(nt, nw);
  const long ns = half ? nw / 2 : nw - nw / 2;
  propose_half(X + grp.rows * D, C + grp.rows * D, ndim_act + grp.rows,
               perm + grp.perm, u_all + grp.u, q + grp.half(ns) * D,
               fac + grp.half(ns), grp.t, nt, nw, D, half, a, a_minus_1,
               log_proposal);
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads) stretch_accept_kernel(
    const T* __restrict__ q, const T* __restrict__ X,
    const T* __restrict__ ll_new, const T* __restrict__ lp_new,
    const T* __restrict__ logl, const T* __restrict__ logp,
    const T* __restrict__ fac, const T* __restrict__ betas,
    const long long* __restrict__ perm, const T* __restrict__ u_all,
    T* __restrict__ X_out, T* __restrict__ logl_out, T* __restrict__ logp_out,
    T* __restrict__ acc_out, int nt, int nw, int D, int half) {
  const Group grp(nt, nw);
  const long h = grp.half(half ? nw / 2 : nw - nw / 2);
  accept_half(q + h * D, X + grp.rows * D, ll_new + h, lp_new + h,
              logl + grp.rows, logp + grp.rows, fac + h, betas + grp.betas,
              perm + grp.perm, u_all + grp.u, X_out + grp.rows * D,
              logl_out + grp.rows, logp_out + grp.rows, acc_out + grp.rows,
              grp.t, nt, nw, D, half);
}

// Block t accepts half 0 of temperature t, then proposes half 1 of the same
// temperature from the rows it has just merged.  X_out carries no
// __restrict__: it is written before the barrier and read after it, and a
// read-only (non-coherent) load of it would be wrong.
template <typename T>
__global__ void __launch_bounds__(kMaxThreads) stretch_accept_propose_kernel(
    const T* __restrict__ q0, const T* __restrict__ X,
    const T* __restrict__ ll_new, const T* __restrict__ lp_new,
    const T* __restrict__ logl, const T* __restrict__ logp,
    const T* __restrict__ fac0, const T* __restrict__ betas,
    const T* __restrict__ ndim_act, const long long* __restrict__ perm,
    const T* __restrict__ u_all, T* X_out, T* __restrict__ logl_out,
    T* __restrict__ logp_out, T* __restrict__ acc_out, T* __restrict__ q1,
    T* __restrict__ fac1, int nt, int nw, int D, T a, T a_minus_1,
    int log_proposal) {
  const Group grp(nt, nw);
  const long h0 = grp.half(nw - nw / 2), h1 = grp.half(nw / 2);
  X += grp.rows * D;
  X_out += grp.rows * D;
  perm += grp.perm;
  u_all += grp.u;
  accept_half(q0 + h0 * D, X, ll_new + h0, lp_new + h0, logl + grp.rows,
              logp + grp.rows, fac0 + h0, betas + grp.betas, perm, u_all,
              X_out, logl_out + grp.rows, logp_out + grp.rows,
              acc_out + grp.rows, grp.t, nt, nw, D, 0);
  __syncthreads();
  propose_half(X, static_cast<const T*>(X_out), ndim_act + grp.rows, perm,
               u_all, q1 + h1 * D, fac1 + h1, grp.t, nt, nw, D, 1, a,
               a_minus_1, log_proposal);
}

// one warp at least, one thread per walker of the larger half up to
// kMaxThreads
inline int threads_for(int nw) {
  const int warps = (nw - nw / 2 + 31) / 32;
  return warps < 1 ? 32 : (32 * warps > kMaxThreads ? kMaxThreads : 32 * warps);
}

template <typename T>
int launch_propose(const void* X, const void* C, const void* ndim_act,
                   const void* perm, const void* u_all, void* q, void* fac,
                   int ng, int nt, int nw, int D, int half, double a,
                   int log_proposal, void* stream) {
  stretch_propose_kernel<T><<<ng * nt, threads_for(nw), 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(X), static_cast<const T*>(C),
      static_cast<const T*>(ndim_act), static_cast<const long long*>(perm),
      static_cast<const T*>(u_all), static_cast<T*>(q), static_cast<T*>(fac),
      nt, nw, D, half, T(a), T(a - 1.0), log_proposal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_accept(const void* q, const void* X, const void* ll_new,
                  const void* lp_new, const void* logl, const void* logp,
                  const void* fac, const void* betas, const void* perm,
                  const void* u_all, void* X_out, void* logl_out,
                  void* logp_out, void* acc_out, int ng, int nt, int nw,
                  int D, int half, void* stream) {
  stretch_accept_kernel<T><<<ng * nt, threads_for(nw), 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(X),
      static_cast<const T*>(ll_new), static_cast<const T*>(lp_new),
      static_cast<const T*>(logl), static_cast<const T*>(logp),
      static_cast<const T*>(fac), static_cast<const T*>(betas),
      static_cast<const long long*>(perm), static_cast<const T*>(u_all),
      static_cast<T*>(X_out), static_cast<T*>(logl_out),
      static_cast<T*>(logp_out), static_cast<T*>(acc_out), nt, nw, D, half);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_accept_propose(const void* q0, const void* X, const void* ll_new,
                          const void* lp_new, const void* logl,
                          const void* logp, const void* fac0,
                          const void* betas, const void* ndim_act,
                          const void* perm, const void* u_all, void* X_out,
                          void* logl_out, void* logp_out, void* acc_out,
                          void* q1, void* fac1, int ng, int nt, int nw,
                          int D, double a, int log_proposal, void* stream) {
  stretch_accept_propose_kernel<T><<<ng * nt, threads_for(nw), 0,
                                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q0), static_cast<const T*>(X),
      static_cast<const T*>(ll_new), static_cast<const T*>(lp_new),
      static_cast<const T*>(logl), static_cast<const T*>(logp),
      static_cast<const T*>(fac0), static_cast<const T*>(betas),
      static_cast<const T*>(ndim_act), static_cast<const long long*>(perm),
      static_cast<const T*>(u_all), static_cast<T*>(X_out),
      static_cast<T*>(logl_out), static_cast<T*>(logp_out),
      static_cast<T*>(acc_out), static_cast<T*>(q1), static_cast<T*>(fac1),
      nt, nw, D, T(a), T(a - 1.0), log_proposal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface, loaded with ctypes.  perm is int64; every other array
// is in the state dtype (f32 or f64); ng is the number of groups (1 for one
// ensemble).  Every function returns
// cudaGetLastError() after its launch (0 on success).
#define ERYN_STRETCH_ENTRIES(T, SUFFIX)                                       \
  int eryn_stretch_propose_##SUFFIX(                                          \
      const void* X, const void* C, const void* ndim_act, const void* perm,   \
      const void* u_all, void* q, void* fac, int ng, int nt, int nw, int D,   \
      int half, double a, int log_proposal, void* stream) {                   \
    return launch_propose<T>(X, C, ndim_act, perm, u_all, q, fac, ng, nt, nw, \
                             D, half, a, log_proposal, stream);               \
  }                                                                           \
  int eryn_stretch_accept_##SUFFIX(                                           \
      const void* q, const void* X, const void* ll_new, const void* lp_new,   \
      const void* logl, const void* logp, const void* fac, const void* betas, \
      const void* perm, const void* u_all, void* X_out, void* logl_out,       \
      void* logp_out, void* acc_out, int ng, int nt, int nw, int D, int half, \
      void* stream) {                                                         \
    return launch_accept<T>(q, X, ll_new, lp_new, logl, logp, fac, betas,     \
                            perm, u_all, X_out, logl_out, logp_out, acc_out,  \
                            ng, nt, nw, D, half, stream);                     \
  }                                                                           \
  int eryn_stretch_accept_propose_##SUFFIX(                                   \
      const void* q0, const void* X, const void* ll_new, const void* lp_new,  \
      const void* logl, const void* logp, const void* fac0,                   \
      const void* betas, const void* ndim_act, const void* perm,              \
      const void* u_all, void* X_out, void* logl_out, void* logp_out,         \
      void* acc_out, void* q1, void* fac1, int ng, int nt, int nw, int D,     \
      double a, int log_proposal, void* stream) {                             \
    return launch_accept_propose<T>(q0, X, ll_new, lp_new, logl, logp, fac0,  \
                                    betas, ndim_act, perm, u_all, X_out,      \
                                    logl_out, logp_out, acc_out, q1, fac1,    \
                                    ng, nt, nw, D, a, log_proposal, stream);  \
  }

extern "C" {
ERYN_STRETCH_ENTRIES(float, f32)
ERYN_STRETCH_ENTRIES(double, f64)
}  // extern "C"
