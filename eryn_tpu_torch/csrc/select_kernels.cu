// Masked-uniform selection for Hopper: for every query, the payload row of
// the (k+1)-th active entry.  Built by eryn_tpu_torch/ops/_build.py; the
// wrapper is eryn_tpu_torch/ops/select_kernels.py:onehot_select.
//
// Replaces eryn_tpu/ops/select_kernels.py:_select_kernel (onehot_select).
// The TPU kernel builds a (Qb, M) one-hot tile in VMEM, marking the rows
// whose running count equals k + 1, and contracts it against the payload
// with a lane reduction: O(Q * M) compares per temperature.  Here one thread
// takes one query: a binary search for the lower bound of k + 1 in the
// non-decreasing counts cs[t, :M], then a copy of that row if its count is
// exactly k + 1, else zeros.  That is O(Q log M) loads and no (Q, M) tile
// anywhere.  The row found is the one active row of the one-hot; every other
// match of the one-hot is an inactive row, whose payload is zero, so the
// values agree with the TPU kernel (which may turn a -0.0 into +0.0).
//
// What bounds it on the card: at the LISA-style shape (10 temperatures,
// Q = M = 800, nd = 3) a call reads and writes about 0.2 MB, well under a
// microsecond at 3.35 TB/s, so the time is the launch.  Grid (nt, ceil(Q /
// 128)) with 128 threads a block keeps 70 blocks in flight at that shape.
#include "common.cuh"

namespace {

template <typename T>
__global__ void onehot_select_kernel(const T* __restrict__ cs,
                                     const T* __restrict__ kq,
                                     const T* __restrict__ c_clean,
                                     T* __restrict__ out, int M, int Q,
                                     int nd) {
  // cs (nt, M); kq (nt, Q); c_clean (nt, M, nd); out (nt, Q, nd)
  const int t = blockIdx.x;
  const int q = blockIdx.y * blockDim.x + threadIdx.x;
  if (q >= Q) return;
  const T* row = cs + static_cast<long>(t) * M;
  const T k1 = kq[static_cast<long>(t) * Q + q] + T(1);
  int lo = 0, hi = M;  // first index with row[index] >= k1, or M
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (row[mid] < k1) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  T* dst = out + (static_cast<long>(t) * Q + q) * nd;
  if (lo < M && row[lo] == k1) {
    const T* src = c_clean + (static_cast<long>(t) * M + lo) * nd;
    for (int d = 0; d < nd; ++d) dst[d] = src[d];
  } else {
    for (int d = 0; d < nd; ++d) dst[d] = T(0);
  }
}

template <typename T>
int launch_select(const void* cs, const void* kq, const void* c_clean,
                  void* out, int nt, int M, int Q, int nd, void* stream) {
  const int threads = 128;
  const dim3 grid(nt, (Q + threads - 1) / threads);
  onehot_select_kernel<T><<<grid, threads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(cs), static_cast<const T*>(kq),
      static_cast<const T*>(c_clean), static_cast<T*>(out), M, Q, nd);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int eryn_onehot_select_f32(const void* cs, const void* kq, const void* c_clean,
                           void* out, int nt, int M, int Q, int nd,
                           void* stream) {
  return launch_select<float>(cs, kq, c_clean, out, nt, M, Q, nd, stream);
}

int eryn_onehot_select_f64(const void* cs, const void* kq, const void* c_clean,
                           void* out, int nt, int M, int Q, int nd,
                           void* stream) {
  return launch_select<double>(cs, kq, c_clean, out, nt, M, Q, nd, stream);
}

}  // extern "C"
