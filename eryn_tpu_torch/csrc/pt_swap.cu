// Parallel-tempering swap cascade for Hopper: the decisions on the
// log-likelihood alone, the state moved once.  Built by
// eryn_tpu_torch/ops/_build.py; the wrappers are in
// eryn_tpu_torch/ops/pt_swap.py (pt_swap_cascade_tree, the sampler's entry,
// and the channel-form pt_swap_cascade_multi and _cascade_multi_rolled).
//
// Replaces two TPU kernels of eryn_tpu/ops/pt_swap.py together with the
// caller's relabelling, packing and epilogue
// (eryn_tpu/moves/tempering.py:_swap_kernel_pallas):
//
// * _cascade_kernel (pt_swap_cascade_multi, up to 640 walkers) rotates rung
//   i-1 with a one-hot matmul, selects, and rotates back;
// * _cascade_roll_kernel (_cascade_multi_rolled, above 640 walkers) rotates
//   modulo the walker count padded to a multiple of 128 and never swaps a
//   pair with a pad lane on either side.
//
// Both carry the whole packed state through every rung, because a gathered
// row is slow on the TPU.  On this card a gathered row costs what a
// contiguous one does, and only the log-likelihood decides a swap.  So:
//
// 1. Decision pass.  Slot w of rung t holds the log-likelihood of walker
//    pi[w] (the relabelling is an index, no gather op) and an int32 origin,
//    the flat slot t * nw + pi[w] it came from.  For i = nt-1 .. 1 thread w
//    pairs slot w of rung i with slot p = (w + s_i) mod m of rung i-1
//    (m = nw, or the 128-padded width with the test p < nw), decides
//    dbeta * (a - b) > raccept[i-1, w] with the rounding of the eager ops,
//    and swaps those two small values.  Rotation modulo m is a bijection, so
//    no two threads touch one slot; one block barrier separates the rungs.
//    A rung reads shared memory only: the rows of log-likelihoods and the
//    acceptance draws arrive through coalesced asynchronous copies
//    (cp.async) started three rungs ahead, into rings of four rows, so the
//    trip to L2 is off the chain of dependent rungs, and a row is relabelled
//    from shared memory (a gather from global memory costs a block a cycle
//    a walker and rung); the relabelling, the rotations and the ladder
//    differences are staged once.  Rung i is final after its own step and
//    is written out at once.
// 2. Move.  Every leaf of the state is read in its own (nt, nw, ...) layout
//    and type and written in walker order, out[t, pi[w]] = in[origin(t, w)]:
//    rows of bytes, so bool masks and integers move as they are.  A table of
//    leaves (pointer in, pointer out, row bytes) rides the launch by value.
//    Channels (nt, D, nw) are one more addressing of the same move.
// 3. The accepted pairings of each rung are counted in the kernel (a warp
//    reduction and one shared-memory atomic a warp).
//
// Groups: ng independent ladders (ParaEnsembleSampler) in one launch, every
// array with a leading group axis (logl (ng, nt, nw), betas (ng, nt), pi
// (ng, nw), shifts (ng, nt - 1), raccept (ng, nt - 1, nw), the leaves and
// the outputs likewise); blockIdx.y is the group, and a block's shared
// memory holds one ladder, as without groups (ng = 1).
//
// What bounds it on the card: a few hundred kilobytes move, so the time is
// the launch plus nt - 1 dependent rungs.  A rung is bound by instruction
// rate (about a hundred instructions a walker, 32 warps on one SM at 1000
// walkers), no longer by memory.  The payload uses many SMs without a grid
// barrier: each block of the grid repeats the cheap decision pass in its
// own shared memory and moves the payload of its own chunk of walkers, all
// leaves at once, a share of its warps each.  Where the rings exceed the
// shared memory a block may use, one block keeps the rows in global memory
// (in place in the output, with a scratch row of origins): slower, and
// right at every walker count.
#include "common.cuh"

#include <cuda_pipeline.h>
#include <stdint.h>

namespace {

using eryn::Ops;

constexpr int kMaxLeaves = 32;  // eryn_tpu_torch/ops/pt_swap.py:MAX_LEAVES
constexpr int kDepth = 3;       // rungs a row is fetched ahead of its use
constexpr int kRing = 4;        // rows of a ring: kDepth + 1, a power of two

struct Leaf {
  const unsigned char* in;
  unsigned char* out;
  int row_bytes;  // of one walker's row, or of one element of a channel
  int channels;   // 0: rows (nt, nw, row_bytes); D: channels (nt, D, nw)
};

struct LeafTable {
  Leaf leaf[kMaxLeaves];
  int n;
};

template <typename T>
struct CascadeArgs {
  const T* logl;           // (nt, nw)
  const T* betas;          // (nt,), or null where dbetas is given
  const T* dbetas;         // (nt - 1,), or null
  const long long* pi;     // (nw,) relabelling, or null for the identity
  const int* shifts;       // (nt - 1,)
  const T* raccept;        // (nt - 1, nw)
  T* out_logl;             // (nt, nw), walker order
  T* accepted;             // (nt - 1,) accepted pairings, or null
  T* sel;                  // (nt - 1, nw) accept mask in slot order, or null
  int* origin;             // (nt, nw) scratch of the global-memory form
  int nt, nw, cw;          // cw: walkers in a block's chunk
};

// Rows of V-sized units: out[t, pi[w]] = in[origin(t, w)] for this block's
// slots, the units first, first + stride, ...  Threads run along the row
// first, so a row is one coalesced access;
// the leaves do not overlap, so the loads of an unrolled group go out
// together.  A leaf holds fewer than 2^31 bytes (the wrapper checks), so the
// unit index fits 32 bits.
template <typename V, bool kGlobal>
__device__ void move_rows(const Leaf& lf, const long long* pi, const int* perm,
                          const int* origin, int nt, int nw, int w0, int nc,
                          int cw, unsigned first, unsigned stride) {
  const unsigned per = lf.row_bytes / static_cast<unsigned>(sizeof(V));
  const V* __restrict__ in = reinterpret_cast<const V*>(lf.in);
  V* __restrict__ out = reinterpret_cast<V*>(lf.out);
  const unsigned total = static_cast<unsigned>(nt) * nc * per;
#pragma unroll 4
  for (unsigned k = first; k < total; k += stride) {
    const unsigned slot = k / per;
    const unsigned e = k - slot * per;
    const unsigned t = slot / nc;
    const unsigned j = slot - t * nc;
    const unsigned v = kGlobal ? (pi ? static_cast<unsigned>(pi[w0 + j]) : w0 + j)
                               : perm[w0 + j];
    const unsigned dst = t * nw + v;
    const unsigned src = kGlobal ? origin[dst] : origin[t * cw + j];
    out[static_cast<size_t>(dst) * per + e] = in[static_cast<size_t>(src) * per + e];
  }
}

// Channels (nt, D, nw) of V-sized elements; threads run along the walkers.
template <typename V, bool kGlobal>
__device__ void move_channels(const Leaf& lf, const long long* pi,
                              const int* perm, const int* origin, int nt,
                              int nw, int w0, int nc, int cw, unsigned first,
                              unsigned stride) {
  const unsigned D = lf.channels;
  const V* __restrict__ in = reinterpret_cast<const V*>(lf.in);
  V* __restrict__ out = reinterpret_cast<V*>(lf.out);
  const unsigned total = static_cast<unsigned>(nt) * D * nc;
#pragma unroll 4
  for (unsigned k = first; k < total; k += stride) {
    const unsigned row = k / nc;  // t * D + d
    const unsigned j = k - row * nc;
    const unsigned t = row / D;
    const unsigned d = row - t * D;
    const unsigned v = kGlobal ? (pi ? static_cast<unsigned>(pi[w0 + j]) : w0 + j)
                               : perm[w0 + j];
    const unsigned src = kGlobal ? origin[t * nw + v] : origin[t * cw + j];
    const unsigned ts = src / nw;
    const unsigned ws = src - ts * nw;
    out[static_cast<size_t>(row) * nw + v] =
        in[(static_cast<size_t>(ts) * D + d) * nw + ws];
  }
}

template <bool kGlobal>
__device__ void move_leaf(const Leaf& lf, const long long* pi, const int* perm,
                          const int* origin, int nt, int nw, int w0, int nc,
                          int cw, unsigned first, unsigned stride) {
  // the widest unit that divides the row and keeps both pointers aligned
  const uintptr_t bits = reinterpret_cast<uintptr_t>(lf.in) |
                         reinterpret_cast<uintptr_t>(lf.out) |
                         static_cast<uintptr_t>(lf.row_bytes);
#define ERYN_MOVE(fn, V) \
  fn<V, kGlobal>(lf, pi, perm, origin, nt, nw, w0, nc, cw, first, stride)
  if (lf.channels) {
    switch (lf.row_bytes) {
      case 8: ERYN_MOVE(move_channels, unsigned long long); break;
      case 4: ERYN_MOVE(move_channels, unsigned int); break;
      case 2: ERYN_MOVE(move_channels, unsigned short); break;
      default: ERYN_MOVE(move_channels, unsigned char); break;
    }
  } else if ((bits & 15) == 0) {
    ERYN_MOVE(move_rows, uint4);
  } else if ((bits & 7) == 0) {
    ERYN_MOVE(move_rows, unsigned long long);
  } else if ((bits & 3) == 0) {
    ERYN_MOVE(move_rows, unsigned int);
  } else if ((bits & 1) == 0) {
    ERYN_MOVE(move_rows, unsigned short);
  } else {
    ERYN_MOVE(move_rows, unsigned char);
  }
#undef ERYN_MOVE
}

// Group g = blockIdx.y of a grouped launch: every array of the arguments
// and every leaf advanced to the group's own, the arrays lying group after
// group with a leading group axis.
template <typename T>
__device__ CascadeArgs<T> group_args(CascadeArgs<T> a, long g) {
  const long rows = g * a.nt * a.nw, rungs = g * (a.nt - 1);
  a.logl += rows;
  if (a.betas) a.betas += g * a.nt;
  if (a.dbetas) a.dbetas += rungs;
  if (a.pi) a.pi += g * a.nw;
  a.shifts += rungs;
  a.raccept += rungs * a.nw;
  a.out_logl += rows;
  if (a.accepted) a.accepted += rungs;
  if (a.sel) a.sel += rungs * a.nw;
  if (a.origin) a.origin += rows;
  return a;
}

__device__ Leaf group_leaf(Leaf lf, long g, int nt, int nw) {
  const long bytes = g * nt * static_cast<long>(nw) * lf.row_bytes *
                     (lf.channels ? lf.channels : 1);
  lf.in += bytes;
  lf.out += bytes;
  return lf;
}

template <typename T, bool kRolled, bool kGlobal>
__global__ void __launch_bounds__(1024, 1)
pt_swap_cascade_kernel(const CascadeArgs<T> args, const LeafTable leaves) {
  extern __shared__ __align__(16) unsigned char smem[];
  const long g = blockIdx.y;
  const CascadeArgs<T> a = group_args(args, g);
  const int nt = a.nt, nw = a.nw;
  const int tid = threadIdx.x, bd = blockDim.x;
  const int m = kRolled ? ((nw + 127) / 128) * 128 : nw;
  // this block's chunk of slots, of every rung
  const int w0 = kGlobal ? 0 : blockIdx.x * a.cw;
  const int nc = kGlobal ? nw : min(a.cw, nw - w0);
  const int* origin;
  const int* perm = nullptr;  // the relabelling staged in shared memory

  if (kGlobal) {
    // rows in global memory: slot w of rung t is out_logl[t, pi[w]], so the
    // cascade runs in place in walker order
    T* lg = a.out_logl;
    int* og = a.origin;
    const long n = static_cast<long>(nt) * nw;
    for (long k = tid; k < n; k += bd) {
      lg[k] = a.logl[k];
      og[k] = static_cast<int>(k);
    }
    __syncthreads();
    for (int i = nt - 1; i >= 1; --i) {
      const T dbeta = a.dbetas ? a.dbetas[i - 1]
                               : Ops<T>::sub(a.betas[i - 1], a.betas[i]);
      int s = a.shifts[i - 1] % m;
      if (s < 0) s += m;
      T* li = lg + static_cast<long>(i) * nw;
      T* lj = li - nw;
      int* oi = og + static_cast<long>(i) * nw;
      int* oj = oi - nw;
      int count = 0;
      for (int base = 0; base < nw; base += bd) {
        const int w = base + tid;
        bool take = false;
        if (w < nw) {
          int p = w + s;
          if (p >= m) p -= m;
          if (!kRolled || p < nw) {
            const long v = a.pi ? a.pi[w] : w;
            const long vp = a.pi ? a.pi[p] : p;
            const T x = li[v];
            const T b = lj[vp];
            take = Ops<T>::mul(dbeta, Ops<T>::sub(x, b)) >
                   a.raccept[static_cast<long>(i - 1) * nw + w];
            if (take) {
              li[v] = b;
              lj[vp] = x;
              const int ox = oi[v];
              oi[v] = oj[vp];
              oj[vp] = ox;
            }
          }
          if (a.sel)
            a.sel[static_cast<long>(i - 1) * nw + w] = take ? T(1) : T(0);
        }
        count += __syncthreads_count(take);
      }
      if (a.accepted && tid == 0) a.accepted[i - 1] = static_cast<T>(count);
    }
    origin = og;
  } else {
    // Rings of kRing rows, a rung r in slot r mod kRing.  ST: rows of logl
    // in walker order, landing through coalesced asynchronous copies started
    // kDepth rungs before they are relabelled into L; R: the acceptance
    // draws, landing likewise; L and O: log-likelihoods and origins in slot
    // order, of rung i, rung i-1 and rung i-2 (being relabelled for the
    // next rung).  Then
    // the ladder differences, the relabelling, the rotations, the accepted
    // counts, and the final origins of this block's chunk.
    T* ST = reinterpret_cast<T*>(smem);
    T* R = ST + kRing * nw;
    T* L = R + kRing * nw;
    T* DB = L + kRing * nw;
    int* O = reinterpret_cast<int*>(DB + (nt - 1));
    int* P = O + kRing * nw;
    int* S = P + nw;
    int* AC = S + (nt - 1);
    int* fin = AC + (nt - 1);
    perm = P;
    auto slot = [](int r) { return static_cast<unsigned>(r) % kRing; };
    // row r of logl as it lies, and the draws of rung j, for slot w; a row
    // or a rung that does not exist is skipped
    auto fetch = [&](int r, int j, int w) {
      if (r >= 0)
        __pipeline_memcpy_async(&ST[slot(r) * nw + w], &a.logl[r * nw + w],
                                sizeof(T));
      if (j >= 1)
        __pipeline_memcpy_async(&R[slot(j) * nw + w],
                                &a.raccept[(j - 1) * nw + w], sizeof(T));
    };
    for (int t = tid; t < nt - 1; t += bd) {
      const int s = a.shifts[t] % m;
      S[t] = s < 0 ? s + m : s;
      DB[t] = a.dbetas ? a.dbetas[t] : Ops<T>::sub(a.betas[t], a.betas[t + 1]);
      AC[t] = 0;
    }
    // what the rungs nt-1+kDepth .. nt would have started, a group each
    for (int k = kDepth; k >= 1; --k) {
      for (int w = tid; w < nw; w += bd)
        fetch(nt - 3 - kDepth + k, nt - 1 + k - kDepth, w);
      __pipeline_commit();
    }
    // the two top rungs, relabelled from global memory.  Thread w alone
    // reads P[w] and the draws it fetched; the rows wait for the barrier
    for (int w = tid; w < nw; w += bd) {
      const int v = a.pi ? static_cast<int>(a.pi[w]) : w;
      P[w] = v;
      for (int r = nt - 1; r >= 0 && r >= nt - 2; --r) {
        L[slot(r) * nw + w] = a.logl[r * nw + v];
        O[slot(r) * nw + w] = r * nw + v;
      }
    }
    __pipeline_wait_prior(kDepth - 1);
    __syncthreads();
    for (int i = nt - 1; i >= 1; --i) {
      const unsigned c = slot(i), q = slot(i - 1), n = slot(i + 2);
      const T* Lc = L + c * nw;
      const int* Oc = O + c * nw;
      T* Lp = L + q * nw;
      int* Op = O + q * nw;
      T* Ln = L + n * nw;  // of rung i-2; it held rung i+2
      int* On = O + n * nw;
      const T* Rc = R + c * nw;
      const T* STn = ST + n * nw;  // row i-2 as it lies, landed
      const T dbeta = DB[i - 1];
      const int s = S[i - 1];
      int count = 0;
      for (int w = tid; w < nw; w += bd) {
        // kDepth rungs ahead; the ring slots held row i-1 and the draws of
        // rung i+1, which no thread reads after the last barrier
        fetch(i - 2 - kDepth, i - kDepth, w);
        int p = w + s;
        if (p >= m) p -= m;
        const bool valid = !kRolled || p < nw;
        if (!valid) p = w;  // a slot to read; nothing is decided on it
        // every read before the first use, so that they overlap
        const int v = P[w];
        T x = Lc[w];
        int ox = Oc[w];
        const T b = Lp[p];
        const int ob = Op[p];
        const T r = Rc[w];
        if (i >= 2) {
          Ln[w] = STn[v];
          On[w] = (i - 2) * nw + v;
        }
        const bool take =
            valid && Ops<T>::mul(dbeta, Ops<T>::sub(x, b)) > r;
        if (take) {
          Lp[p] = x;
          Op[p] = ox;
          x = b;
          ox = ob;
        }
        count += take;
        // rung i is final
        if (w >= w0 && w < w0 + nc) {
          a.out_logl[i * nw + v] = x;
          fin[i * a.cw + (w - w0)] = ox;
          if (a.sel) a.sel[(i - 1) * nw + w] = take ? T(1) : T(0);
        }
      }
      if (a.accepted && blockIdx.x == 0) {
        count = __reduce_add_sync(0xffffffffu, count);
        if ((tid & 31) == 0 && count) atomicAdd(&AC[i - 1], count);
      }
      // all but the newest kDepth - 1 groups have landed: row i-3 and the
      // draws of rung i-1
      __pipeline_commit();
      __pipeline_wait_prior(kDepth - 1);
      __syncthreads();
    }
    // rung 0 is final after the last step
    for (int j = tid; j < nc; j += bd) {
      const int w = w0 + j;
      a.out_logl[P[w]] = L[w];  // ring slot 0
      fin[j] = O[w];
    }
    if (a.accepted && blockIdx.x == 0)
      for (int t = tid; t < nt - 1; t += bd)
        a.accepted[t] = static_cast<T>(AC[t]);
    origin = fin;
  }
  __syncthreads();

  // every leaf at once, a share of the warps each, so that the leaves'
  // trips to memory overlap; more leaves than warps go one after another
  const int nwarps = bd >> 5, warp = tid >> 5, nl = leaves.n;
  if (nl > nwarps) {
    for (int l = 0; l < nl; ++l)
      move_leaf<kGlobal>(group_leaf(leaves.leaf[l], g, nt, nw), a.pi, perm,
                         origin, nt, nw, w0, nc, a.cw, tid, bd);
  } else if (nl > 0) {
    const int l = warp % nl;
    const int share = (nwarps - l + nl - 1) / nl;  // warps on leaf l
    move_leaf<kGlobal>(group_leaf(leaves.leaf[l], g, nt, nw), a.pi, perm,
                       origin, nt, nw, w0, nc, a.cw,
                       (warp / nl) * 32 + (tid & 31), share * 32);
  }
}

template <typename T, bool kRolled, bool kGlobal>
int launch_kernel(const CascadeArgs<T>& a, const LeafTable& tab, dim3 grid,
                  int threads, size_t shared, cudaStream_t stream) {
  auto kernel = pt_swap_cascade_kernel<T, kRolled, kGlobal>;
  if (shared > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(shared));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<grid, threads, shared, stream>>>(a, tab);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_cascade(const void* logl, const void* betas, const void* dbetas,
                   const void* pi, const void* shifts, const void* raccept,
                   void* out_logl, void* accepted, void* sel, void* origin,
                   const void* const* leaf_in, void* const* leaf_out,
                   const int* leaf_row_bytes, const int* leaf_channels,
                   int nleaves, int ng, int nt, int nw, int cw, int rolled,
                   int shared_limit, void* stream) {
  if (nleaves < 0 || nleaves > kMaxLeaves || ng < 1 || ng > 65535 || nt < 1 ||
      nw < 1 || cw < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (cw > nw) cw = nw;
  CascadeArgs<T> a;
  a.logl = static_cast<const T*>(logl);
  a.betas = static_cast<const T*>(betas);
  a.dbetas = static_cast<const T*>(dbetas);
  a.pi = static_cast<const long long*>(pi);
  a.shifts = static_cast<const int*>(shifts);
  a.raccept = static_cast<const T*>(raccept);
  a.out_logl = static_cast<T*>(out_logl);
  a.accepted = static_cast<T*>(accepted);
  a.sel = static_cast<T*>(sel);
  a.origin = static_cast<int*>(origin);
  a.nt = nt;
  a.nw = nw;
  a.cw = cw;
  LeafTable tab;
  tab.n = nleaves;
  for (int l = 0; l < nleaves; ++l) {
    tab.leaf[l].in = static_cast<const unsigned char*>(leaf_in[l]);
    tab.leaf[l].out = static_cast<unsigned char*>(leaf_out[l]);
    tab.leaf[l].row_bytes = leaf_row_bytes[l];
    tab.leaf[l].channels = leaf_channels[l];
  }
  // a thread a walker for the decisions, and enough threads for the move
  int threads = ((nw + 31) / 32) * 32;
  if (threads > 1024) threads = 1024;
  if (threads < 256) threads = 256;
  // eryn_tpu_torch/ops/pt_swap.py:_shared_bytes
  const size_t shared =
      (3 * kRing * static_cast<size_t>(nw) + (nt - 1)) * sizeof(T) +
      ((kRing + 1) * static_cast<size_t>(nw) + 2 * (nt - 1) +
       static_cast<size_t>(nt) * cw) * 4;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (shared > static_cast<size_t>(shared_limit)) {
    if (!origin) return static_cast<int>(cudaErrorInvalidValue);
    const dim3 one(1, ng);
    return rolled ? launch_kernel<T, true, true>(a, tab, one, threads, 0, st)
                  : launch_kernel<T, false, true>(a, tab, one, threads, 0, st);
  }
  const dim3 grid((nw + cw - 1) / cw, ng);
  return rolled
             ? launch_kernel<T, true, false>(a, tab, grid, threads, shared, st)
             : launch_kernel<T, false, false>(a, tab, grid, threads, shared, st);
}

__global__ void empty_kernel() {}

}  // namespace

extern "C" {

int eryn_pt_swap_cascade_f32(const void* logl, const void* betas,
                             const void* dbetas, const void* pi,
                             const void* shifts, const void* raccept,
                             void* out_logl, void* accepted, void* sel,
                             void* origin, const void* const* leaf_in,
                             void* const* leaf_out, const int* leaf_row_bytes,
                             const int* leaf_channels, int nleaves, int ng,
                             int nt, int nw, int cw, int rolled,
                             int shared_limit, void* stream) {
  return launch_cascade<float>(logl, betas, dbetas, pi, shifts, raccept,
                               out_logl, accepted, sel, origin, leaf_in,
                               leaf_out, leaf_row_bytes, leaf_channels,
                               nleaves, ng, nt, nw, cw, rolled, shared_limit,
                               stream);
}

int eryn_pt_swap_cascade_f64(const void* logl, const void* betas,
                             const void* dbetas, const void* pi,
                             const void* shifts, const void* raccept,
                             void* out_logl, void* accepted, void* sel,
                             void* origin, const void* const* leaf_in,
                             void* const* leaf_out, const int* leaf_row_bytes,
                             const int* leaf_channels, int nleaves, int ng,
                             int nt, int nw, int cw, int rolled,
                             int shared_limit, void* stream) {
  return launch_cascade<double>(logl, betas, dbetas, pi, shifts, raccept,
                                out_logl, accepted, sel, origin, leaf_in,
                                leaf_out, leaf_row_bytes, leaf_channels,
                                nleaves, ng, nt, nw, cw, rolled,
                                shared_limit, stream);
}

// One launch of a kernel that does nothing: the launch floor that
// chip_smoke.py measures beside the kernels' times.
int eryn_empty_launch(void* stream) {
  empty_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
