// Parallel-tempering swap cascade for Hopper, with the payload channels
// carried through every rung.  Built by eryn_tpu_torch/ops/_build.py; the
// wrapper is eryn_tpu_torch/ops/pt_swap.py:pt_swap_cascade_multi.
//
// Replaces eryn_tpu/ops/pt_swap.py:_cascade_kernel (pt_swap_cascade_multi).
// The TPU kernel rotates rung i-1 with a one-hot matmul, selects, and
// rotates back with the transposed matmul.  Here thread w of the block reads
// L_i[w] and its partner L_{i-1}[(w + s_i) mod nw], decides, and swaps the
// log-likelihood and every payload channel of that pair in place in the
// output copy.  The rotation is a bijection, so no two threads touch the
// same pair; a __syncthreads() separates the rungs, because rung i-1's row
// is the next rung's input.  Values only move and are never recomputed, so
// the outputs are bitwise those of the TPU kernel.
//
// What bounds it on the card: the rungs are sequential and each touches
// (1 + D) x nw values (8 x 100 at the north-star shape), so the time is the
// launch plus nt - 1 block barriers.  One block of threads covers the
// ensemble; several blocks would need a grid-wide barrier between rungs.
#include "common.cuh"

namespace {

using eryn::Ops;

template <typename T>
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

  for (int i = nt - 1; i >= 1; --i) {
    const T dbeta = dbetas[i - 1];
    int s = shifts[i - 1] % nw;
    if (s < 0) s += nw;
    T* li = out_logl + static_cast<long>(i) * nw;
    T* lj = out_logl + static_cast<long>(i - 1) * nw;
    T* ci = out_ch + static_cast<long>(i) * D * nw;
    T* cj = out_ch + static_cast<long>(i - 1) * D * nw;
    for (int w = threadIdx.x; w < nw; w += blockDim.x) {
      int p = w + s;
      if (p >= nw) p -= nw;
      const T a = li[w];
      const T b = lj[p];
      const T pacc = Ops<T>::mul(dbeta, Ops<T>::sub(a, b));
      const bool take = pacc > raccept[static_cast<long>(i - 1) * nw + w];
      if (take) {
        li[w] = b;
        lj[p] = a;
        for (int d = 0; d < D; ++d) {
          const T x = ci[static_cast<long>(d) * nw + w];
          ci[static_cast<long>(d) * nw + w] = cj[static_cast<long>(d) * nw + p];
          cj[static_cast<long>(d) * nw + p] = x;
        }
      }
      sel[static_cast<long>(i - 1) * nw + w] = take ? T(1) : T(0);
    }
    __syncthreads();
  }
}

template <typename T>
int launch_cascade(const void* logl, const void* channels, const void* dbetas,
                   const void* shifts, const void* raccept, void* out_logl,
                   void* out_ch, void* sel, int nt, int nw, int D,
                   void* stream) {
  int threads = ((nw + 31) / 32) * 32;
  if (threads > 1024) threads = 1024;
  pt_swap_cascade_kernel<T><<<1, threads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(logl), static_cast<const T*>(channels),
      static_cast<const T*>(dbetas), static_cast<const int*>(shifts),
      static_cast<const T*>(raccept), static_cast<T*>(out_logl),
      static_cast<T*>(out_ch), static_cast<T*>(sel), nt, nw, D);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int eryn_pt_swap_cascade_f32(const void* logl, const void* channels,
                             const void* dbetas, const void* shifts,
                             const void* raccept, void* out_logl,
                             void* out_ch, void* sel, int nt, int nw, int D,
                             void* stream) {
  return launch_cascade<float>(logl, channels, dbetas, shifts, raccept,
                               out_logl, out_ch, sel, nt, nw, D, stream);
}

int eryn_pt_swap_cascade_f64(const void* logl, const void* channels,
                             const void* dbetas, const void* shifts,
                             const void* raccept, void* out_logl,
                             void* out_ch, void* sel, int nt, int nw, int D,
                             void* stream) {
  return launch_cascade<double>(logl, channels, dbetas, shifts, raccept,
                                out_logl, out_ch, sel, nt, nw, D, stream);
}

}  // extern "C"
