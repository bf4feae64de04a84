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


# ---------------------------------------------------------------------------
# the group-stretch proposal built on the selection
# ---------------------------------------------------------------------------

def _group_inputs(nt, nw, shapes, seed, dtype=np.float32):
    """A permuted ensemble of the branches ``shapes`` ``{name: (nl, nd)}``
    with NaN in dormant slots, one temperature whose leaves are all dormant,
    and the draws of one block."""
    rng = np.random.default_rng(seed)
    coords, inds = {}, {}
    for name, (nl, nd) in shapes.items():
        inds[name] = rng.random((nt, nw, nl)) < 0.4
        inds[name][-1] = False
        coords[name] = rng.normal(size=(nt, nw, nl, nd)).astype(dtype)
        coords[name][~inds[name]] = np.nan
    return ({n: torch.from_numpy(x) for n, x in coords.items()},
            {n: torch.from_numpy(x) for n, x in inds.items()}, rng)


def _draws(rng, nt, ns, shapes, dtype=np.float32):
    u = torch.from_numpy(rng.random((nt, ns)).astype(dtype))
    uu = {n: torch.from_numpy(rng.random((nt, ns, nl)).astype(dtype))
          for n, (nl, _) in shapes.items()}
    return u, uu


@pytest.mark.parametrize("off,ns", [(0, 5), (5, 6), (3, 4), (0, 11)])
@pytest.mark.parametrize("options", [
    {}, {"log_proposal": True, "a": 1.7},
    {"periods": {"m": torch.tensor([1.5, float("inf")]), "n": None},
     "per_leaf": {"m": None, "n": torch.tensor([2.0, 0.0, 1.0])}},
])
def test_group_stretch_block_form_equals_separate_form(off, ns, options):
    """The block form (moving rows and complement addressed inside one
    tensor) against the same proposal from a gathered complement: the same
    arithmetic on the same values, so equal bit for bit."""
    nt, nw, shapes = 3, 11, {"m": (4, 2), "n": (3, 3)}
    coords, inds, rng = _group_inputs(nt, nw, shapes, seed=off + ns)
    u, uu = _draws(rng, nt, ns, shapes)
    blk = slice(off, off + ns)
    s = {n: x[:, blk] for n, x in coords.items()}
    si = {n: x[:, blk] for n, x in inds.items()}
    q_b, f_b = port.group_stretch_propose(s, si, coords, inds, u, uu,
                                          skip=(off, ns), **options)

    def comp(x):
        return torch.cat([x[:, :off], x[:, off + ns:]], dim=1)

    q_s, f_s = port.group_stretch_propose(
        s, si, {n: comp(x) for n, x in coords.items()},
        {n: comp(x) for n, x in inds.items()}, u, uu, **options)
    assert torch.equal(f_b, f_s)
    for n in shapes:
        assert q_b[n].shape == s[n].shape
        same = (q_b[n] == q_s[n]) | (q_b[n].isnan() & q_s[n].isnan())
        assert same.all()
        # dormant leaves and the all-dormant temperature pass through
        assert q_b[n][~si[n]].isnan().all()
        assert q_b[n][-1].isnan().all()
        if ns < nw:
            assert (q_b[n][:-1][si[n][:-1]] != s[n][:-1][si[n][:-1]]).any()
    if ns == nw:  # no complement at all: the identity, and factors of 0 dims
        zz = port._stretch_factor(u, options.get("a", 2.0),
                                  options.get("log_proposal", False))
        expo = 0.0 if options.get("log_proposal") else -1.0
        assert torch.equal(f_b, expo * torch.log(zz))


def _pick_as_the_kernel_does(mask, k1):
    """The entry whose running active count is ``k1``, found as
    ``csrc/select_kernels.cu`` finds it: 32-entry mask words, an exclusive
    prefix of their bit counts, the last word whose prefix is below ``k1``,
    the n-th set bit inside it."""
    M = len(mask)
    words = [sum(int(mask[w * 32 + b]) << b for b in range(32) if w * 32 + b < M)
             for w in range(-(-M // 32))]
    prefix = np.concatenate([[0], np.cumsum([bin(x).count("1") for x in words])])
    w = int(np.searchsorted(prefix[:len(words)], k1, side="left")) - 1
    n, bit = k1 - prefix[w], -1
    while n:
        bit += 1
        n -= (words[w] >> bit) & 1
    return w * 32 + bit


@pytest.mark.parametrize("M,density", [(800, 0.4), (33, 0.9), (257, 0.02),
                                       (64, 1.0), (1, 1.0)])
def test_word_prefix_pick_matches_the_running_count(M, density):
    rng = np.random.default_rng(M)
    mask = rng.random(M) < density
    mask[rng.integers(M)] = True
    cs = np.cumsum(mask)
    for k1 in range(1, int(cs[-1]) + 1):
        e = _pick_as_the_kernel_does(mask, k1)
        assert mask[e] and cs[e] == k1


def test_group_stretch_wrapper_takes_ref_on_cpu():
    nt, nw, shapes = 2, 8, {"m": (3, 2)}
    coords, inds, rng = _group_inputs(nt, nw, shapes, seed=9, dtype=np.float64)
    u, uu = _draws(rng, nt, 4, shapes, dtype=np.float64)
    args = ({"m": coords["m"][:, 4:]}, {"m": inds["m"][:, 4:]}, coords, inds,
            u, uu, (4, 4))
    before = port.group_stretch_propose.launches
    q, f = port.group_stretch_propose(*args)
    q_r, f_r = port.group_stretch_propose_ref(*args)
    assert port.group_stretch_propose.launches == before
    assert q["m"].dtype == f.dtype == torch.float64
    assert torch.equal(f, f_r)
    assert torch.equal(q["m"].nan_to_num(7.0), q_r["m"].nan_to_num(7.0))
