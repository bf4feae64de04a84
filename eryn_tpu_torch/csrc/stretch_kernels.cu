// Stretch-move kernels for Hopper: the proposal and the tempered
// Metropolis-Hastings accept that bracket the likelihood of each red/blue
// half.  Built by eryn_tpu_torch/ops/_build.py into a shared library with a
// plain C interface; the wrappers are in eryn_tpu_torch/ops/stretch_kernels.py.
//
// What bounds them on the card: at the north-star shape (10 temperatures x
// 50 moving walkers x 5 parameters) each launch touches a few kilobytes, far
// below one wave of one SM, so the time is the launch itself.  The design
// keeps each one to a single launch with no shared memory and no
// synchronisation: one thread per (temperature, moving walker), which loops
// over the D parameters.  The caller keeps each red/blue half in its own
// contiguous block, so the moving and complement walkers need no staging
// copies.
#include "common.cuh"

namespace {

using eryn::Ops;

// Replaces eryn_tpu/ops/stretch_kernels.py:_propose_kernel (stretch_propose).
// The TPU kernel picks the complement walker with a one-hot matmul on the
// MXU; here it is an indexed load of row floor(u1 * nc), computed from the
// same float product.  The index is clamped to nc - 1 so a product that
// rounds up to nc cannot read past the block.
template <typename T>
__global__ void stretch_propose_kernel(const T* __restrict__ s,
                                       const T* __restrict__ c,
                                       const T* __restrict__ ndim_act,
                                       const T* __restrict__ u,
                                       T* __restrict__ q, T* __restrict__ fac,
                                       int nt, int ns, int nc, int D, T a,
                                       T a_minus_1, int log_proposal) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= nt * ns) return;
  const int t = idx / ns;
  // u is (2, nt, ns): the z draw, then the complement pick
  const T u_z = u[idx];
  const T u_pick = u[nt * ns + idx];

  T z;
  if (log_proposal) {
    // ln z ~ U[-ln a, ln a]
    const T e = Ops<T>::sub(Ops<T>::mul(T(2), u_z), T(1));
    z = Ops<T>::exp(Ops<T>::mul(e, Ops<T>::log(a)));
  } else {
    // z = ((a - 1) u + 1)^2 / a, the square by multiplication
    const T b = Ops<T>::add(Ops<T>::mul(a_minus_1, u_z), T(1));
    z = Ops<T>::div(Ops<T>::mul(b, b), a);
  }

  int r = static_cast<int>(Ops<T>::floor(Ops<T>::mul(u_pick, T(nc))));
  r = r < 0 ? 0 : (r >= nc ? nc - 1 : r);
  const T* crow = c + (static_cast<long>(t) * nc + r) * D;
  const T* srow = s + static_cast<long>(idx) * D;
  T* qrow = q + static_cast<long>(idx) * D;
  for (int d = 0; d < D; ++d) {
    const T cv = crow[d];
    qrow[d] = Ops<T>::sub(cv, Ops<T>::mul(Ops<T>::sub(cv, srow[d]), z));
  }
  // detailed-balance exponent: N - 1 for the Goodman-Weare density, N for
  // g(z) ~ 1/z
  const T nd = ndim_act[idx];
  const T expo = log_proposal ? nd : Ops<T>::sub(nd, T(1));
  fac[idx] = Ops<T>::mul(expo, Ops<T>::log(z));
}

// Replaces eryn_tpu/ops/stretch_kernels.py:_accept_kernel (stretch_accept).
// The two NaN rules of the TPU kernel are kept exactly: a NaN tempered
// log-likelihood (beta = 0 times -inf) becomes -inf, and a NaN decision
// never accepts.
template <typename T>
__global__ void stretch_accept_kernel(
    const T* __restrict__ q, const T* __restrict__ s,
    const T* __restrict__ ll_new, const T* __restrict__ lp_new,
    const T* __restrict__ ll_old, const T* __restrict__ lp_old,
    const T* __restrict__ fac, const T* __restrict__ betas,
    const T* __restrict__ u, T* __restrict__ out_coords,
    T* __restrict__ out_ll, T* __restrict__ out_lp, T* __restrict__ acc,
    int nt, int ns, int D) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= nt * ns) return;
  const int t = idx / ns;
  const T beta = betas[t];
  const T ln = ll_new[idx];
  const T lo = ll_old[idx];
  const T pn = lp_new[idx];
  const T po = lp_old[idx];

  T tl_new = Ops<T>::mul(ln, beta);
  T tl_old = Ops<T>::mul(lo, beta);
  if (isnan(tl_new)) tl_new = -INFINITY;
  if (isnan(tl_old)) tl_old = -INFINITY;
  // fac + (tl_new + lp_new) - (tl_old + lp_old), in the TPU kernel's order
  const T lnpdiff = Ops<T>::sub(Ops<T>::add(fac[idx], Ops<T>::add(tl_new, pn)),
                                Ops<T>::add(tl_old, po));
  T d = Ops<T>::sub(lnpdiff, Ops<T>::log(u[idx]));
  if (isnan(d)) d = -INFINITY;
  const bool accept = d > T(0);

  const T* src = (accept ? q : s) + static_cast<long>(idx) * D;
  T* dst = out_coords + static_cast<long>(idx) * D;
  for (int k = 0; k < D; ++k) dst[k] = src[k];
  out_ll[idx] = accept ? ln : lo;
  out_lp[idx] = accept ? pn : po;
  acc[idx] = accept ? T(1) : T(0);
}

constexpr int kThreads = 128;

inline int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

template <typename T>
int launch_propose(const void* s, const void* c, const void* ndim_act,
                   const void* u, void* q, void* fac, int nt, int ns, int nc,
                   int D, double a, int log_proposal, void* stream) {
  stretch_propose_kernel<T><<<blocks_for(nt * ns), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(s), static_cast<const T*>(c),
      static_cast<const T*>(ndim_act), static_cast<const T*>(u),
      static_cast<T*>(q), static_cast<T*>(fac), nt, ns, nc, D, T(a),
      T(a - 1.0), log_proposal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_accept(const void* q, const void* s, const void* ll_new,
                  const void* lp_new, const void* ll_old, const void* lp_old,
                  const void* fac, const void* betas, const void* u,
                  void* out_coords, void* out_ll, void* out_lp, void* acc,
                  int nt, int ns, int D, void* stream) {
  stretch_accept_kernel<T><<<blocks_for(nt * ns), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(s),
      static_cast<const T*>(ll_new), static_cast<const T*>(lp_new),
      static_cast<const T*>(ll_old), static_cast<const T*>(lp_old),
      static_cast<const T*>(fac), static_cast<const T*>(betas),
      static_cast<const T*>(u), static_cast<T*>(out_coords),
      static_cast<T*>(out_ll), static_cast<T*>(out_lp), static_cast<T*>(acc),
      nt, ns, D);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface, loaded with ctypes.  Every function returns
// cudaGetLastError() after its launch (0 on success).
extern "C" {

int eryn_stretch_propose_f32(const void* s, const void* c,
                             const void* ndim_act, const void* u, void* q,
                             void* fac, int nt, int ns, int nc, int D,
                             double a, int log_proposal, void* stream) {
  return launch_propose<float>(s, c, ndim_act, u, q, fac, nt, ns, nc, D, a,
                               log_proposal, stream);
}

int eryn_stretch_propose_f64(const void* s, const void* c,
                             const void* ndim_act, const void* u, void* q,
                             void* fac, int nt, int ns, int nc, int D,
                             double a, int log_proposal, void* stream) {
  return launch_propose<double>(s, c, ndim_act, u, q, fac, nt, ns, nc, D, a,
                                log_proposal, stream);
}

int eryn_stretch_accept_f32(const void* q, const void* s, const void* ll_new,
                            const void* lp_new, const void* ll_old,
                            const void* lp_old, const void* fac,
                            const void* betas, const void* u,
                            void* out_coords, void* out_ll, void* out_lp,
                            void* acc, int nt, int ns, int D, void* stream) {
  return launch_accept<float>(q, s, ll_new, lp_new, ll_old, lp_old, fac,
                              betas, u, out_coords, out_ll, out_lp, acc, nt,
                              ns, D, stream);
}

int eryn_stretch_accept_f64(const void* q, const void* s, const void* ll_new,
                            const void* lp_new, const void* ll_old,
                            const void* lp_old, const void* fac,
                            const void* betas, const void* u,
                            void* out_coords, void* out_ll, void* out_lp,
                            void* acc, int nt, int ns, int D, void* stream) {
  return launch_accept<double>(q, s, ll_new, lp_new, ll_old, lp_old, fac,
                               betas, u, out_coords, out_ll, out_lp, acc, nt,
                               ns, D, stream);
}

}  // extern "C"
