// Parallel-tempering swap cascade for Hopper, with the payload channels
// carried through every rung.  Built by eryn_tpu_torch/ops/_build.py; the
// wrappers are eryn_tpu_torch/ops/pt_swap.py:pt_swap_cascade_multi and
// :_cascade_multi_rolled.
//
// Replaces two TPU kernels of eryn_tpu/ops/pt_swap.py:
//
// * _cascade_kernel (pt_swap_cascade_multi, up to 640 walkers).  The TPU
//   kernel rotates rung i-1 with a one-hot matmul, selects, and rotates back
//   with the transposed matmul.
// * _cascade_roll_kernel (_cascade_multi_rolled, above 640 walkers).  The TPU
//   kernel pads the walker axis to a multiple of 128 lanes, rotates with
//   pltpu.roll modulo the padded width, and carries a validity channel so
//   that a pair with a pad lane on either side never swaps.
//
// Here thread w of the block reads L_i[w] and its partner L_{i-1}[p] with
// p = (w + s_i) mod m, decides, and swaps the log-likelihood and every
// payload channel of that pair in place in the output copy.  m is nw for the
// first kernel and nwpad = ceil(nw / 128) * 128 for the rolled one, whose
// only other difference is one index test: a pair is taken only where
// p < nw (w < nw holds by the loop bound).  Pad lanes never exist in memory,
// so there is no validity channel and no padded copy.  Rotation modulo m is
// a bijection, so no two threads touch the same pair, for any loop order; a
// __syncthreads() separates the rungs, because rung i-1's row is the next
// rung's input.  Values only move and are never recomputed, so the outputs
// are bitwise those of the TPU kernels.
//
// What bounds it on the card: the rungs are sequential and each touches
// (1 + D) x nw values (8 x 1000 at config E, 20 x 1000 x 7 payload
// channels), a few hundred kilobytes in all, so the time is the launch plus
// nt - 1 block barriers.  One block covers the ensemble (the w += blockDim.x
// loop keeps ensembles beyond 1024 walkers correct); several blocks would
// need a grid-wide barrier between rungs.
#include "common.cuh"

namespace {

using eryn::Ops;

template <typename T, bool kRolled>
__global__ void pt_swap_cascade_kernel(const T* __restrict__ logl,
                                       const T* __restrict__ channels,
                                       const T* __restrict__ dbetas,
                                       const int* __restrict__ shifts,
                                       const T* __restrict__ raccept,
                                       T* __restrict__ out_logl,
                                       T* __restrict__ out_ch,
                                       T* __restrict__ sel, int nt, int nw,
                                       int D) {
  // logl (nt, nw); channels (nt, D, nw); raccept and sel (nt - 1, nw)
  for (int w = threadIdx.x; w < nw; w += blockDim.x) {
    for (int t = 0; t < nt; ++t) {
      out_logl[t * nw + w] = logl[t * nw + w];
      for (int d = 0; d < D; ++d) {
        const long k = (static_cast<long>(t) * D + d) * nw + w;
        out_ch[k] = channels[k];
      }
    }
  }
  __syncthreads();

  const int m = kRolled ? ((nw + 127) / 128) * 128 : nw;
  for (int i = nt - 1; i >= 1; --i) {
    const T dbeta = dbetas[i - 1];
    int s = shifts[i - 1] % m;
    if (s < 0) s += m;
    T* li = out_logl + static_cast<long>(i) * nw;
    T* lj = out_logl + static_cast<long>(i - 1) * nw;
    T* ci = out_ch + static_cast<long>(i) * D * nw;
    T* cj = out_ch + static_cast<long>(i - 1) * D * nw;
    for (int w = threadIdx.x; w < nw; w += blockDim.x) {
      int p = w + s;
      if (p >= m) p -= m;
      bool take = false;
      if (!kRolled || p < nw) {
        const T a = li[w];
        const T b = lj[p];
        const T pacc = Ops<T>::mul(dbeta, Ops<T>::sub(a, b));
        take = pacc > raccept[static_cast<long>(i - 1) * nw + w];
        if (take) {
          li[w] = b;
          lj[p] = a;
          for (int d = 0; d < D; ++d) {
            const T x = ci[static_cast<long>(d) * nw + w];
            ci[static_cast<long>(d) * nw + w] = cj[static_cast<long>(d) * nw + p];
            cj[static_cast<long>(d) * nw + p] = x;
          }
        }
      }
      sel[static_cast<long>(i - 1) * nw + w] = take ? T(1) : T(0);
    }
    __syncthreads();
  }
}

template <typename T, bool kRolled>
int launch_cascade(const void* logl, const void* channels, const void* dbetas,
                   const void* shifts, const void* raccept, void* out_logl,
                   void* out_ch, void* sel, int nt, int nw, int D,
                   void* stream) {
  int threads = ((nw + 31) / 32) * 32;
  if (threads > 1024) threads = 1024;
  pt_swap_cascade_kernel<T, kRolled><<<1, threads, 0,
                                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(logl), static_cast<const T*>(channels),
      static_cast<const T*>(dbetas), static_cast<const int*>(shifts),
      static_cast<const T*>(raccept), static_cast<T*>(out_logl),
      static_cast<T*>(out_ch), static_cast<T*>(sel), nt, nw, D);
  return static_cast<int>(cudaGetLastError());
}

__global__ void empty_kernel() {}

}  // namespace

extern "C" {

int eryn_pt_swap_cascade_f32(const void* logl, const void* channels,
                             const void* dbetas, const void* shifts,
                             const void* raccept, void* out_logl,
                             void* out_ch, void* sel, int nt, int nw, int D,
                             void* stream) {
  return launch_cascade<float, false>(logl, channels, dbetas, shifts, raccept,
                                      out_logl, out_ch, sel, nt, nw, D, stream);
}

int eryn_pt_swap_cascade_f64(const void* logl, const void* channels,
                             const void* dbetas, const void* shifts,
                             const void* raccept, void* out_logl,
                             void* out_ch, void* sel, int nt, int nw, int D,
                             void* stream) {
  return launch_cascade<double, false>(logl, channels, dbetas, shifts, raccept,
                                       out_logl, out_ch, sel, nt, nw, D, stream);
}

int eryn_pt_swap_cascade_rolled_f32(const void* logl, const void* channels,
                                    const void* dbetas, const void* shifts,
                                    const void* raccept, void* out_logl,
                                    void* out_ch, void* sel, int nt, int nw,
                                    int D, void* stream) {
  return launch_cascade<float, true>(logl, channels, dbetas, shifts, raccept,
                                     out_logl, out_ch, sel, nt, nw, D, stream);
}

int eryn_pt_swap_cascade_rolled_f64(const void* logl, const void* channels,
                                    const void* dbetas, const void* shifts,
                                    const void* raccept, void* out_logl,
                                    void* out_ch, void* sel, int nt, int nw,
                                    int D, void* stream) {
  return launch_cascade<double, true>(logl, channels, dbetas, shifts, raccept,
                                      out_logl, out_ch, sel, nt, nw, D, stream);
}

// One launch of a kernel that does nothing: the launch floor that
// chip_smoke.py measures beside the kernels' times.
int eryn_empty_launch(void* stream) {
  empty_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
