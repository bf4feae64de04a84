"""The plain masked-uniform selection against the JAX package's Pallas
kernel (interpret mode on the CPU) and against its XLA one-hot contraction,
on the same numpy inputs.

Tolerance: none.  The selection only moves values, so the results must be
equal; ``assert_array_equal`` holds ``-0.0`` equal to ``+0.0``, the one
difference the one-hot sum may introduce.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from eryn_tpu.ops.select_kernels import onehot_select as jax_select
from eryn_tpu_torch.ops import select_kernels as port

torch.set_num_threads(1)


def _inputs(nt, Q, M, nd, seed=7):
    """Counts, queries and zeroed payload as the group-stretch move makes
    them; the last temperature has an empty active complement."""
    rng = np.random.default_rng(seed)
    m = (rng.random((nt, M)) < 0.4).astype(np.float32)
    m[-1] = 0.0
    cs = np.cumsum(m, axis=-1).astype(np.float32)
    cnt = m.sum(axis=-1)
    kq = np.floor(rng.random((nt, Q)) * np.maximum(cnt, 1.0)[:, None])
    kq = kq.astype(np.float32)
    c_clean = (rng.normal(size=(nt, M, nd)) * m[:, :, None]).astype(np.float32)
    return cs, kq, c_clean


@pytest.mark.parametrize(
    "shape", [(3, 10, 24, 2), (2, 130, 257, 3), (1, 1, 1, 1), (10, 800, 800, 3)]
)
def test_onehot_select_ref_matches_jax(shape):
    cs, kq, c_clean = _inputs(*shape)
    got = port.onehot_select_ref(
        torch.from_numpy(cs), torch.from_numpy(kq), torch.from_numpy(c_clean)
    ).numpy()
    want = jax_select(jnp.asarray(cs), jnp.asarray(kq), jnp.asarray(c_clean),
                      interpret=True)
    np.testing.assert_array_equal(got, np.asarray(want))
    # the XLA equality one-hot of eryn_tpu.moves.rbgroupstretch
    onehot = (cs[:, None, :] == kq[:, :, None] + 1.0).astype(np.float32)
    xla = jnp.einsum("tqm,tmd->tqd", jnp.asarray(onehot), jnp.asarray(c_clean),
                     precision=jax.lax.Precision.HIGHEST)
    np.testing.assert_array_equal(got, np.asarray(xla))
    assert not got[-1].any()  # the empty complement selects zeros
    if shape[0] > 1:
        assert got[0].any()


def test_onehot_select_sentinel_queries_select_zeros():
    cs, kq, c_clean = _inputs(2, 40, 50, 3, seed=1)
    kq[:, ::3] = -1.0  # k + 1 = 0 matches no active row
    got = port.onehot_select_ref(
        torch.from_numpy(cs), torch.from_numpy(kq), torch.from_numpy(c_clean)
    ).numpy()
    want = jax_select(jnp.asarray(cs), jnp.asarray(kq), jnp.asarray(c_clean),
                      interpret=True)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert not got[:, ::3].any()


def test_onehot_select_wrapper_takes_ref_on_cpu():
    args = [torch.from_numpy(x) for x in _inputs(3, 17, 29, 2, seed=2)]
    before = port.onehot_select.launches
    assert torch.equal(port.onehot_select(*args), port.onehot_select_ref(*args))
    assert port.onehot_select.launches == before
    # float64 too: the plain version keeps the payload's dtype
    args64 = [a.double() for a in args]
    assert port.onehot_select(*args64).dtype == torch.float64
