"""The CUDA kernels against their plain PyTorch versions on the card, a
short sampler run through them, and the sampler's CUDA graphs against its
eager loop.  These need a CUDA device and the CUDA toolkit; without a card
they skip.  On a GPU machine::

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

(``--noconftest``: the suite's conftest imports jax, which this file does
not need.)

Tolerances: the swap cascades, the accepts and the selection kernel only
select and move values, so their outputs must be bitwise equal to the plain
versions'; the stretch proposals' floats agree within 1e-6 (float32) or
1e-12 (float64), a few ulp of ``exp``/``log``.  The group-stretch proposal
repeats its plain version operation for operation and must equal it (NaN
in the same places) at the default stretch scale; at another scale PyTorch
divides by a host scalar as a multiplication by its reciprocal, an ulp of
``z`` from the kernel's division, so that case takes the proposals'
tolerance, and 50 times it for the factors, which multiply ``ln z`` by up
to 24 dimensions.  A graphed run replays the eager run's operations on the
same numbers, so its chain equals the eager chain digit for digit; so do
the moves without gradients (``-k zoo``), kernel states included.
"""

import numpy as np
import pytest
import torch

from eryn_tpu_torch.ops import pt_swap, select_kernels, stretch_kernels as sk

pytestmark = pytest.mark.gpu

TOL = {torch.float32: 1e-6, torch.float64: 1e-12}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _gen():
    return torch.Generator().manual_seed(0)


def _randn(g, dtype, *shape):
    return torch.randn(shape, generator=g, dtype=torch.float64).to("cuda", dtype)


def _rand(g, dtype, *shape):
    return torch.rand(shape, generator=g, dtype=torch.float64).to("cuda", dtype)


# (nt, nw, D): north-star, config E, an odd shape, and halves of more than
# 1024 walkers (the block loops)
STRETCH_SHAPES = [(10, 100, 5), (20, 1000, 5), (8, 99, 13), (3, 4001, 5)]


def _stretch_state(dtype, nt, nw, D):
    """Walker-order state and draws of one step on the card, and each half's
    likelihood and prior values with NaN and -inf in them."""
    g = _gen()
    n0 = nw - nw // 2
    st = dict(
        X=_randn(g, dtype, nt, nw, D), logl=_randn(g, dtype, nt, nw) * 3,
        logp=_randn(g, dtype, nt, nw),
        ndim_act=torch.full((nt, nw), float(D), dtype=dtype, device="cuda"),
        perm=torch.randperm(nw, generator=g).cuda(),
        u_all=_rand(g, dtype, 2, 3, nt, nw),
        betas=torch.linspace(1.0, 0.0, nt, dtype=dtype, device="cuda"),
    )
    new = []
    for ns in (n0, nw - n0):
        ll, lp = _randn(g, dtype, nt, ns) * 3, _randn(g, dtype, nt, ns)
        ll[0, :3] = float("nan")
        ll[-1, :3] = float("-inf")
        lp[1, 0] = float("-inf")
        new.append((ll, lp))
    return st, new


def _outs(st):
    nan = float("nan")
    return (torch.full_like(st["X"], nan),
            *(torch.full_like(st["logl"], nan) for _ in range(3)))


def _assert_bitwise(outs_k, outs_r):
    for a, b in zip(outs_k, outs_r):
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", STRETCH_SHAPES)
@pytest.mark.parametrize("log_proposal", [False, True])
def test_stretch_propose_kernel(cuda, dtype, shape, log_proposal):
    st, _ = _stretch_state(dtype, *shape)
    for half in (0, 1):
        args = (st["X"], st["X"], st["ndim_act"], st["perm"], st["u_all"],
                half, 2.0, log_proposal)
        before = sk.stretch_propose.launches
        out = sk.stretch_propose(*args)
        ref = sk.stretch_propose_ref(*args)
        torch.cuda.synchronize()
        assert sk.stretch_propose.launches == before + 1
        for a, b in zip(out, ref):
            torch.testing.assert_close(a, b, rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", STRETCH_SHAPES)
@pytest.mark.parametrize("log_proposal", [False, True])
def test_stretch_accept_propose_kernel(cuda, dtype, shape, log_proposal):
    st, new = _stretch_state(dtype, *shape)
    q0, f0 = sk.stretch_propose_ref(st["X"], st["X"], st["ndim_act"],
                                    st["perm"], st["u_all"], 0)
    args = (q0, st["X"], *new[0], st["logl"], st["logp"], f0, st["betas"],
            st["ndim_act"], st["perm"], st["u_all"])
    outs_k, outs_r = _outs(st), _outs(st)
    before = sk.stretch_accept_propose.launches
    q_k, f_k = sk.stretch_accept_propose(*args, *outs_k, 2.0, log_proposal)
    q_r, f_r = sk.stretch_accept_propose_ref(*args, *outs_r, 2.0, log_proposal)
    torch.cuda.synchronize()
    assert sk.stretch_accept_propose.launches == before + 1
    # half 0 merged bitwise, half 1 untouched
    _assert_bitwise(outs_k, outs_r)
    n0 = shape[1] - shape[1] // 2
    assert outs_k[3][:, st["perm"][n0:]].isnan().all()
    assert 0 < outs_k[3][:, st["perm"][:n0]].sum() < q0.shape[0] * n0
    torch.testing.assert_close(q_k, q_r, rtol=TOL[dtype], atol=TOL[dtype])
    torch.testing.assert_close(f_k, f_r, rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", STRETCH_SHAPES)
def test_stretch_accept_kernel(cuda, dtype, shape):
    st, new = _stretch_state(dtype, *shape)
    outs_k, outs_r = _outs(st), _outs(st)
    for half in (0, 1):
        q, fac = sk.stretch_propose_ref(
            st["X"], outs_r[0] if half else st["X"], st["ndim_act"],
            st["perm"], st["u_all"], half,
        )
        args = (q, st["X"], *new[half], st["logl"], st["logp"], fac,
                st["betas"], st["perm"], st["u_all"], half)
        before = sk.stretch_accept.launches
        sk.stretch_accept(*args, *outs_k)
        sk.stretch_accept_ref(*args, *outs_r)
        torch.cuda.synchronize()
        assert sk.stretch_accept.launches == before + 1
        _assert_bitwise(outs_k, outs_r)
    # the two halves wrote every walker
    assert all(not x.isnan().any() for x in (outs_k[0], outs_k[3]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", [(10, 100, 7), (8, 99, 13), (3, 1500, 2)])
def test_pt_swap_kernel_bitwise(cuda, dtype, shape):
    nt, nw, D = shape
    g = _gen()
    betas = torch.logspace(0, -2, nt, dtype=dtype, device=cuda)
    args = (
        _randn(g, dtype, nt, nw) * 10, _randn(g, dtype, nt, D, nw),
        (betas[:-1] - betas[1:]).contiguous(),
        torch.randint(0, nw, (nt - 1,), generator=g, dtype=torch.int32).cuda(),
        torch.log(_rand(g, dtype, nt - 1, nw)),
    )
    out = pt_swap.pt_swap_cascade_multi(*args)
    # above 640 walkers the wrapper dispatches to the rolled cascade
    plain = (pt_swap._cascade_multi_rolled_ref if nw > pt_swap.ROLLED_THRESHOLD
             else pt_swap.pt_swap_cascade_multi_ref)
    ref = plain(*args)
    for a, b in zip(out, ref):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", [(20, 1000, 7), (3, 641, 5), (2, 2100, 3)])
def test_rolled_cascade_kernel_bitwise(cuda, dtype, shape):
    nt, nw, D = shape
    g = _gen()
    betas = torch.logspace(0, -2, nt, dtype=dtype, device=cuda)
    args = (
        _randn(g, dtype, nt, nw) * 10, _randn(g, dtype, nt, D, nw),
        (betas[:-1] - betas[1:]).contiguous(),
        torch.randint(0, nw, (nt - 1,), generator=g, dtype=torch.int32).cuda(),
        torch.log(_rand(g, dtype, nt - 1, nw)),
    )
    before = (pt_swap._cascade_multi_rolled.launches,
              pt_swap.pt_swap_cascade_multi.launches)
    out = pt_swap._cascade_multi_rolled(*args)
    ref = pt_swap._cascade_multi_rolled_ref(*args)
    torch.cuda.synchronize()
    assert (pt_swap._cascade_multi_rolled.launches,
            pt_swap.pt_swap_cascade_multi.launches) == (before[0] + 1, before[1])
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    assert 0 < out[2].sum() < out[2].numel()


def _tree_case(dtype, nt, nw, nleaves, ndim):
    """The sampler's swap tree, its log-likelihood and ladder and one
    cascade's draws on the card; and a maker of outputs like them."""
    g = _gen()
    logl = _randn(g, dtype, nt, nw) * 10
    leaves = [_randn(g, dtype, nt, nw, nleaves, ndim),
              _rand(g, dtype, nt, nw, nleaves) < 0.4, _randn(g, dtype, nt, nw)]
    args = (
        logl, leaves, torch.logspace(0, -2, nt, dtype=dtype, device="cuda"),
        torch.randperm(nw, generator=g).cuda(),
        torch.randint(0, nw, (nt - 1,), generator=g, dtype=torch.int32).cuda(),
        torch.log(_rand(g, dtype, nt - 1, nw)),
    )

    def outs():
        return (torch.empty_like(logl), [torch.empty_like(x) for x in leaves],
                torch.empty(nt - 1, dtype=dtype, device="cuda"),
                torch.empty((nt - 1, nw), dtype=dtype, device="cuda"))

    return args, outs


# (nt, nw, leaves, ndim): the north-star tree at the north-star and config E
# sizes, the RJ tree, the block loops, the first rolled size
TREE_SHAPES = [(10, 100, 1, 5), (20, 1000, 1, 5), (10, 200, 8, 3),
               (3, 1500, 1, 5), (3, 4001, 1, 5), (3, 641, 1, 5)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", TREE_SHAPES)
@pytest.mark.parametrize("form", ["grid", "one block", "global"])
def test_tree_cascade_kernel_bitwise(cuda, dtype, shape, form, monkeypatch):
    """The sampler's cascade against its plain version: a grid of blocks
    that each move a chunk of walkers, one block moving everything, and the
    form that keeps its rows in global memory."""
    nt, nw = shape[:2]
    args, outs = _tree_case(dtype, *shape)
    out_k, out_r = outs(), outs()
    if form == "global":
        monkeypatch.setattr(pt_swap, "SHARED_LIMIT", 0)
    rolled = nw > pt_swap.ROLLED_THRESHOLD
    before = (pt_swap.pt_swap_cascade_multi.launches,
              pt_swap._cascade_multi_rolled.launches)
    pt_swap.pt_swap_cascade_tree(*args, *out_k,
                                 chunk=nw if form == "one block" else None)
    pt_swap.pt_swap_cascade_tree_ref(*args, *out_r)
    torch.cuda.synchronize()
    assert (pt_swap.pt_swap_cascade_multi.launches,
            pt_swap._cascade_multi_rolled.launches) == (
        before[0] + (not rolled), before[1] + rolled)
    for a, b in zip((out_k[0], *out_k[1], *out_k[2:]),
                    (out_r[0], *out_r[1], *out_r[2:])):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert 0 < out_k[2].sum() < (nt - 1) * nw
    assert out_k[1][1].dtype == torch.bool


def test_tree_cascade_rejects_what_the_kernel_does_not_take(cuda):
    args, outs = _tree_case(torch.float32, 3, 16, 1, 2)
    logl, leaves, betas, pi, shifts, raccept = args
    out_logl, out_leaves, accepted, sel = outs()
    with pytest.raises(TypeError, match="pi has dtype"):
        pt_swap.pt_swap_cascade_tree(logl, leaves, betas, pi.int(), shifts,
                                     raccept, out_logl, out_leaves, accepted)
    with pytest.raises(ValueError, match=r"leaves\[0\] must be contiguous"):
        strided = torch.zeros((3, 16, 1, 4), device=cuda)[..., ::2]
        pt_swap.pt_swap_cascade_tree(
            logl, [strided] + leaves[1:], betas, pi, shifts, raccept,
            out_logl, out_leaves, accepted)
    with pytest.raises(ValueError, match="overlaps its input"):
        pt_swap.pt_swap_cascade_tree(logl, leaves, betas, pi, shifts, raccept,
                                     out_logl, leaves, accepted)
    # a table that is exactly full is one launch, one leaf more two
    ref = outs()
    pt_swap.pt_swap_cascade_tree_ref(*args, *ref)
    for n, launches in ((pt_swap.MAX_LEAVES, 1), (pt_swap.MAX_LEAVES + 1, 2)):
        many = [leaves[2]] * n
        many_out = [torch.empty_like(x) for x in many]
        before = pt_swap.pt_swap_cascade_multi.launches
        pt_swap.pt_swap_cascade_tree(logl, many, betas, pi, shifts, raccept,
                                     out_logl, many_out, accepted)
        torch.cuda.synchronize()
        assert pt_swap.pt_swap_cascade_multi.launches == before + launches
        assert all(torch.equal(x, ref[1][2]) for x in many_out)
        assert torch.equal(out_logl, ref[0]) and torch.equal(accepted, ref[2])


def _mixed_leaves(g, dtype, nt, nw, nleaves):
    """The leaves a state with blobs and supplementals adds to the swap
    tree: float blobs of width 2, an int64 tag, a float64 entry and a bool
    flag, repeated to ``nleaves``."""
    kinds = [
        lambda: _randn(g, dtype, nt, nw, 2),
        lambda: torch.randint(-2**40, 2**40, (nt, nw), generator=g,
                              dtype=torch.int64).cuda(),
        lambda: _randn(g, torch.float64, nt, nw, 3),
        lambda: _rand(g, dtype, nt, nw) < 0.5,
    ]
    return [kinds[k % len(kinds)]() for k in range(nleaves)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", [(10, 100), (20, 1000)])
@pytest.mark.parametrize("nleaves", [7, 40])
def test_tree_cascade_moves_mixed_leaves_in_groups(cuda, dtype, shape,
                                                   nleaves):
    """Blobs, an int64 tag, a float64 and a bool leaf beside the state's
    own, bitwise equal to the plain version, plain and rolled; above 32
    leaves one launch per group of 32, each counted, on the same draws."""
    nt, nw = shape
    args, _ = _tree_case(dtype, nt, nw, 1, 5)
    logl, leaves, betas, pi, shifts, raccept = args
    leaves = leaves + _mixed_leaves(_gen(), dtype, nt, nw, nleaves - 3)

    def outs():
        return (torch.empty_like(logl), [torch.empty_like(x) for x in leaves],
                torch.empty(nt - 1, dtype=dtype, device="cuda"),
                torch.empty((nt - 1, nw), dtype=dtype, device="cuda"))

    out_k, out_r = outs(), outs()
    counter = (pt_swap._cascade_multi_rolled if nw > pt_swap.ROLLED_THRESHOLD
               else pt_swap.pt_swap_cascade_multi)
    before = counter.launches
    pt_swap.pt_swap_cascade_tree(logl, leaves, betas, pi, shifts, raccept,
                                 *out_k)
    pt_swap.pt_swap_cascade_tree_ref(logl, leaves, betas, pi, shifts, raccept,
                                     *out_r)
    torch.cuda.synchronize()
    assert counter.launches == before + -(-nleaves // pt_swap.MAX_LEAVES)
    for a, b in zip((out_k[0], *out_k[1], *out_k[2:]),
                    (out_r[0], *out_r[1], *out_r[2:])):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert 0 < out_k[2].sum() < (nt - 1) * nw


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", [(10, 800, 800, 3), (2, 130, 257, 3),
                                   (1, 1, 1, 1)])
def test_onehot_select_kernel(cuda, dtype, shape):
    nt, Q, M, nd = shape
    g = _gen()
    m = (torch.rand((nt, M), generator=g) < 0.4).to(dtype)
    m[-1] = 0  # an empty active complement
    cs = torch.cumsum(m, dim=-1)
    kq = torch.floor(torch.rand((nt, Q), generator=g, dtype=dtype)
                     * m.sum(-1).clamp(min=1)[:, None])
    kq[:, ::7] = -1.0
    c_clean = torch.randn((nt, M, nd), generator=g, dtype=dtype) * m[..., None]
    args = [x.to(cuda).contiguous() for x in (cs, kq, c_clean)]
    before = select_kernels.onehot_select.launches
    out = select_kernels.onehot_select(*args)
    ref = select_kernels.onehot_select_ref(*args)
    torch.cuda.synchronize()
    assert select_kernels.onehot_select.launches == before + 1
    assert torch.equal(out, ref)
    assert torch.equal(out.cpu(), select_kernels.onehot_select_ref(cs, kq, c_clean))


def _group_case(dtype, nt, nw, shapes, off, ns, seed=0, empty=None,
                periodic=False, gibbs=False):
    """A permuted ensemble of the branches ``shapes`` ``{name: (nl, nd)}``
    on the card with NaN in dormant slots, the draws of block ``[off, off +
    ns)`` (every seventh pick draw exactly 1, so that ``k + 1`` exceeds the
    count), and the arguments of ``group_stretch_propose`` for it."""
    g = torch.Generator().manual_seed(seed)
    coords, inds, uu, per_leaf, periods = {}, {}, {}, {}, {}
    for name, (nl, nd) in shapes.items():
        m = torch.rand((nt, nw, nl), generator=g) < 0.4
        if empty is not None:
            m[empty] = False  # no active complement at this temperature
        x = torch.randn((nt, nw, nl, nd), generator=g, dtype=torch.float64)
        x[~m] = float("nan")
        coords[name], inds[name] = x.to("cuda", dtype), m.cuda()
        draws = torch.rand((nt, ns, nl), generator=g, dtype=torch.float64)
        draws.view(-1)[::7] = 1.0
        uu[name] = draws.to("cuda", dtype)
        per_leaf[name] = (torch.randint(0, nd + 1, (nl,), generator=g)
                          .to("cuda", dtype) if gibbs else None)
        periods[name] = None
        if periodic:
            p = torch.full((nd,), float("inf"), dtype=dtype)
            p[0] = 1.5
            periods[name] = p.cuda()
    u = _rand(g, dtype, nt, ns)
    blk = slice(off, off + ns)
    return ({n: x[:, blk] for n, x in coords.items()},
            {n: x[:, blk] for n, x in inds.items()}, coords, inds, u, uu,
            (off, ns)), dict(per_leaf=per_leaf, periods=periods)


def _same(a, b):
    return bool(((a == b) | (a.isnan() & b.isnan())).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", [
    # the RJ shape, both blocks of the split
    dict(nt=10, nw=200, shapes={"m": (8, 3)}, off=0, ns=100),
    dict(nt=10, nw=200, shapes={"m": (8, 3)}, off=100, ns=100),
    # two branches, a Gibbs per-leaf table, an empty complement on one
    # temperature, one periodic dimension, the log proposal
    dict(nt=3, nw=37, shapes={"m": (4, 2), "n": (3, 3)}, off=13, ns=12,
         empty=1, periodic=True, gibbs=True, log_proposal=True),
    # more words than threads in a block, an odd block, no rows before it
    dict(nt=2, nw=1400, shapes={"m": (7, 1)}, off=0, ns=9),
    # the whole ensemble moves: no complement
    dict(nt=2, nw=6, shapes={"m": (2, 2)}, off=0, ns=6),
])
def test_group_stretch_propose_kernel(cuda, dtype, case):
    case = dict(case)
    log_proposal = case.pop("log_proposal", False)
    args, kw = _group_case(dtype, **case)
    before = select_kernels.group_stretch_propose.launches
    q, f = select_kernels.group_stretch_propose(
        *args, log_proposal=log_proposal, **kw)
    q_r, f_r = select_kernels.group_stretch_propose_ref(
        *args, log_proposal=log_proposal, **kw)
    torch.cuda.synchronize()
    assert select_kernels.group_stretch_propose.launches == before + 1
    assert torch.equal(f, f_r)
    for n in q:
        assert _same(q[n], q_r[n]), n
    # the separate form (a gathered complement, no skip) on the same kernel
    off, ns = args[6]
    comp = lambda x: torch.cat([x[:, :off], x[:, off + ns:]], 1).contiguous()
    q_s, f_s = select_kernels.group_stretch_propose(
        {n: x.contiguous() for n, x in args[0].items()},
        {n: x.contiguous() for n, x in args[1].items()},
        {n: comp(x) for n, x in args[2].items()},
        {n: comp(x) for n, x in args[3].items()}, args[4], args[5],
        log_proposal=log_proposal, **kw)
    assert torch.equal(f_s, f) and all(_same(q_s[n], q[n]) for n in q)
    # another stretch scale: within the proposals' tolerance
    q_a, f_a = select_kernels.group_stretch_propose(*args, a=1.7, **kw)
    q_ar, f_ar = select_kernels.group_stretch_propose_ref(*args, a=1.7, **kw)
    tol = TOL[dtype]
    torch.testing.assert_close(f_a, f_ar, rtol=0, atol=50 * tol)
    if not case.get("periodic"):  # an ulp at a wrap point is a whole period
        for n in q_a:
            torch.testing.assert_close(q_a[n], q_ar[n], rtol=tol, atol=tol,
                                       equal_nan=True)


def test_group_stretch_propose_rejects_bad_input(cuda):
    args, kw = _group_case(torch.float32, 2, 12, {"m": (3, 2)}, 4, 4)
    s, si, c, ci, u, uu, skip = args
    with pytest.raises(ValueError, match="contiguous"):
        select_kernels.group_stretch_propose(
            {"m": s["m"].transpose(2, 3).contiguous().transpose(2, 3)}, si, c,
            ci, u, uu, skip)
    with pytest.raises(TypeError, match="dtype"):
        select_kernels.group_stretch_propose(s, si, c, ci, u.double(), uu, skip)
    with pytest.raises(ValueError, match="skip"):
        select_kernels.group_stretch_propose(s, si, c, ci, u, uu, (10, 4))
    many = {str(i): s["m"] for i in range(select_kernels.MAX_BRANCHES + 1)}
    with pytest.raises(ValueError, match="branches"):
        select_kernels.group_stretch_propose(many, si, c, ci, u, uu, skip)
    with pytest.raises(ValueError, match="shared memory"):
        select_kernels._check_entries("group_stretch_propose", 1 << 20)


def test_wrapper_rejects_bad_input(cuda):
    st, new = _stretch_state(torch.float32, 2, 8, 3)
    X, nd, perm, u = st["X"], st["ndim_act"], st["perm"], st["u_all"]
    Xt = X.transpose(0, 1).contiguous().transpose(0, 1)
    with pytest.raises(ValueError, match="contiguous"):
        sk.stretch_propose(Xt, Xt, nd, perm, u, 0)
    with pytest.raises(TypeError, match="dtype"):
        sk.stretch_propose(X, X, nd.double(), perm, u, 0)
    with pytest.raises(TypeError, match="perm has dtype"):
        sk.stretch_propose(X, X, nd, perm.int(), u, 0)
    q, fac = sk.stretch_propose(X, X, nd, perm, u, 0)
    outs = _outs(st)
    args = (q, X, *new[0], st["logl"], st["logp"], fac, st["betas"], perm, u,
            0)
    with pytest.raises(TypeError, match="X_out has dtype"):
        sk.stretch_accept(*args, outs[0].double(), *outs[1:])
    with pytest.raises(ValueError, match="logl has shape"):
        sk.stretch_accept(*args[:4], st["logl"][:, :6].contiguous(),
                          *args[5:], *outs)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_sampler_runs_through_the_kernels(cuda, dtype):
    from eryn_tpu_torch import (
        DeviceBackend, EnsembleSampler, ProbDistContainer, uniform_dist,
    )

    priors = ProbDistContainer({i: uniform_dist(-5.0, 5.0) for i in range(3)})
    sampler = EnsembleSampler(
        33, 3, lambda x: -0.5 * torch.sum(x * x), priors,
        tempering_kwargs=dict(ntemps=4), seed=0, device=cuda, dtype=dtype,
    )
    assert isinstance(sampler.backend, DeviceBackend)
    kernels = (sk.stretch_propose, sk.stretch_accept_propose,
               sk.stretch_accept, pt_swap.pt_swap_cascade_multi)
    counts = [k.launches for k in kernels]
    coords = priors.rvs(size=(4, 33), generator=torch.Generator(cuda).manual_seed(1))
    sampler.run_mcmc(coords, 400, burn=100)
    # one of each stretch kernel per step, and one cascade launch per
    # tempering phase (one phase per step)
    assert [k.launches - c for k, c in zip(kernels, counts)] == [500] * 4
    cold = sampler.get_chain(temp_index=0)["model_0"].reshape(-1, 3)
    assert cold.dtype == (np.float32 if dtype == torch.float32 else np.float64)
    assert np.all(np.abs(cold.mean(0)) < 0.2)
    assert np.all(np.isfinite(sampler.get_autocorr_time()["model_0"]))


def test_rj_sampler_runs_through_the_kernels(cuda):
    """Reversible jump with the group stretch on the card: two proposal
    launches (one per half) and one cascade launch per tempering phase
    (two per step: after the in-model and after the RJ move)."""
    from eryn_tpu_torch import EnsembleSampler, ProbDistContainer, uniform_dist
    from eryn_tpu_torch.moves import RedBlueGroupStretchMove

    pr = ProbDistContainer({i: uniform_dist(-1.0, 1.0) for i in range(2)})
    sampler = EnsembleSampler(
        32, 2, lambda c, i: torch.zeros((), device=cuda), pr, nleaves_max=3,
        moves=RedBlueGroupStretchMove(live_dangerously=True), rj_moves=True,
        tempering_kwargs=dict(ntemps=3), fill_zero_leaves_val=0.0, seed=0,
        device=cuda,
    )
    coords = pr.rvs(size=(3, 32, 3), generator=torch.Generator(cuda).manual_seed(1))
    kernels = (select_kernels.group_stretch_propose,
               pt_swap.pt_swap_cascade_multi)
    counts = [k.launches for k in kernels]
    sampler.run_mcmc(coords, 200, burn=50)
    after = [k.launches for k in kernels]
    assert [a - b for a, b in zip(after, counts)] == [500, 500]
    k = sampler.get_nleaves()["model_0"][:, 0]
    assert set(np.unique(k)) == {0, 1, 2, 3}
    assert 0 < sampler.rj_acceptance_fraction.mean() < 1


# ----------------------------------------------------------------------
# the compiled segment: graphs against the eager loop
# ----------------------------------------------------------------------
def _graph_sampler(cuda, kind, cuda_graph, moves=None, tempering=None, **kw):
    """A 4 x 32 x 3 tempered Gaussian, or a small RJ configuration (3 x 32
    walkers, up to 3 leaves, group stretch and birth/death), on the card,
    with its start (``tempering``: more of ``tempering_kwargs``)."""
    from eryn_tpu_torch import EnsembleSampler, ProbDistContainer, State, uniform_dist
    from eryn_tpu_torch.moves import RedBlueGroupStretchMove

    g = torch.Generator(cuda).manual_seed(1)
    if kind == "rj":
        pr = ProbDistContainer({i: uniform_dist(-1.0, 1.0) for i in range(2)})
        sampler = EnsembleSampler(
            32, 2,
            lambda c, i: -0.5 * torch.sum(torch.where(i[:, None], c, 0.0) ** 2),
            pr, nleaves_max=3, rj_moves=True,
            moves=moves or RedBlueGroupStretchMove(live_dangerously=True),
            tempering_kwargs=dict(ntemps=3, **(tempering or {})),
            fill_zero_leaves_val=0.0, seed=0, device=cuda,
            cuda_graph=cuda_graph, **kw)
        coords = pr.rvs(size=(3, 32, 3), generator=g)
        inds = torch.rand((3, 32, 3), generator=g, device=cuda) < 0.5
        return sampler, State(coords, inds=inds)
    pr = ProbDistContainer({i: uniform_dist(-5.0, 5.0) for i in range(3)})
    sampler = EnsembleSampler(
        32, 3, lambda x: -0.5 * torch.sum(x * x), pr, moves=moves,
        tempering_kwargs=dict(ntemps=4, **(tempering or {})), seed=0,
        device=cuda, cuda_graph=cuda_graph, **kw)
    return sampler, pr.rvs(size=(4, 32), generator=g)


def _run_record(sampler, start, steps, burn):
    sampler.run_mcmc(start, steps, burn=burn)
    b = sampler.backend
    out = {k: np.asarray(v) for k, v in dict(
        chain=sampler.get_chain()["model_0"], inds=sampler.get_inds()["model_0"],
        log_like=sampler.get_log_like(), log_prior=sampler.get_log_prior(),
        betas=sampler.get_betas(), accepted=b.accepted,
        swaps=b.swaps_accepted).items()}
    if sampler.has_reversible_jump:
        out["rj_accepted"] = np.asarray(b.rj_accepted)
    out["time"] = int(sampler.temperature_control.time)
    return out


@pytest.mark.parametrize("kind", ["gaussian", "rj", "two moves"])
def test_graphed_chain_equals_the_eager_chain(cuda, kind):
    """From one seed, the graphed run and the eager run give the same chain,
    log-likelihoods, ladder, clock, accept and swap counts, digit for
    digit; the ladder adapts under replay, the clock counts the adapting
    phases; the launch counters and ``graph_replays`` agree with the
    schedule (one replay per schedule entry but the first of each graph,
    which runs eagerly)."""
    from eryn_tpu_torch import StretchMove

    kernels = (sk.stretch_propose, sk.stretch_accept_propose,
               sk.stretch_accept, pt_swap.pt_swap_cascade_multi,
               select_kernels.group_stretch_propose)
    moves = None
    extra = {}
    if kind == "two moves":
        extra = dict(num_repeats_in_model=2)
    steps, burn = 60, 20
    runs = {}
    for graphed in (False, True):
        if kind == "two moves":
            moves = [(StretchMove(), 0.5), (StretchMove(a=1.7), 0.5)]
        sampler, start = _graph_sampler(
            cuda, "rj" if kind == "rj" else "gaussian", graphed, moves=moves,
            **extra)
        before = [k.launches for k in kernels]
        runs[graphed] = _run_record(sampler, start, steps, burn)
        launches = [k.launches - b for k, b in zip(kernels, before)]
        runs[graphed]["launches"] = launches
        if graphed:
            keys = sampler._graphs.warm
            per_step = {"gaussian": 1, "rj": 2, "two moves": 2}[kind]
            assert sampler.graph_replays == per_step * (steps + burn) - len(keys)
        else:
            assert sampler.graph_replays == 0
    for key in runs[False]:
        np.testing.assert_array_equal(runs[True][key], runs[False][key],
                                      err_msg=key)
    n = steps + burn
    stretch, cascade, group = {
        "gaussian": (n, n, 0), "rj": (0, 2 * n, 2 * n),
        "two moves": (2 * n, 2 * n, 0)}[kind]
    assert runs[True]["launches"] == [stretch] * 3 + [cascade, group]
    # one adapting phase per in-model entry
    assert runs[True]["time"] == n * (2 if kind == "two moves" else 1)
    assert not np.array_equal(runs[True]["betas"][-1], runs[True]["betas"][0])


def test_capture_of_a_likelihood_that_reads_the_host_raises(cuda):
    """A likelihood that calls ``.item()`` runs its first (eager) step, then
    fails to capture: the error names the move, the likelihood and
    ``cuda_graph=False``, with which the same sampler runs; and the process
    goes on capturing and drawing afterwards."""
    from eryn_tpu_torch import EnsembleSampler, ProbDistContainer, uniform_dist

    scale = torch.ones((), device=cuda)

    def reads_the_host(x):
        return -0.5 * (x * x).sum(-1) * scale.item()

    pr = ProbDistContainer({i: uniform_dist(-5.0, 5.0) for i in range(3)})
    coords = pr.rvs(size=(2, 16), generator=torch.Generator(cuda).manual_seed(1))
    s = EnsembleSampler(16, 3, reads_the_host, pr, vectorize=True,
                        tempering_kwargs=dict(ntemps=2), seed=0, device=cuda)
    with pytest.raises(RuntimeError, match="cuda_graph=False") as err:
        s.run_mcmc(coords, 5)
    assert "StretchMove" in str(err.value)
    assert "reads_the_host" in str(err.value)
    s = EnsembleSampler(16, 3, reads_the_host, pr, vectorize=True,
                        tempering_kwargs=dict(ntemps=2), seed=0, device=cuda,
                        cuda_graph=False)
    s.run_mcmc(coords, 5)
    assert s.get_chain()["model_0"].shape == (5, 2, 16, 1, 3)
    assert torch.isfinite(torch.rand(3, device=cuda)).all()
    s = EnsembleSampler(16, 3, lambda x: -0.5 * torch.sum(x * x), pr,
                        tempering_kwargs=dict(ntemps=2), seed=0, device=cuda)
    s.run_mcmc(coords, 5)
    assert s.graph_replays == 4


# ----------------------------------------------------------------------
# the long-run path: file and host backends, resume, hooks, on the card
# ----------------------------------------------------------------------
def _long_run_backend(kind, tmp_path, name):
    from eryn_tpu_torch import Backend, HDFBackend

    if kind == "hdf":
        pytest.importorskip("h5py")
        return HDFBackend(str(tmp_path / f"{name}.h5"))
    return Backend()


@pytest.mark.parametrize("kind", ["gaussian", "rj"])
@pytest.mark.parametrize("backend", ["hdf", "host"])
def test_checkpointed_run_graphed_equals_eager(cuda, tmp_path, kind, backend):
    """A run into a file or host backend in segments of 10 (each segment
    copied behind the next one's work, with its checkpoint): graphed and
    eager give the same chain and the same checkpoint, digit for digit."""
    runs = {}
    for graphed in (False, True):
        sampler, start = _graph_sampler(
            cuda, kind, graphed,
            backend=_long_run_backend(backend, tmp_path, f"g{graphed}"))
        runs[graphed] = _run_record(sampler, start, 40, 10)
        b = sampler.backend
        runs[graphed]["clock"] = b.get_sampler_clock()
        runs[graphed]["generator"] = np.asarray(b.random_state)
    for key in runs[False]:
        np.testing.assert_array_equal(runs[True][key], runs[False][key],
                                      err_msg=key)
    assert runs[True]["clock"] == runs[True]["time"] == 50


@pytest.mark.parametrize("kind", ["gaussian", "rj"])
@pytest.mark.parametrize("backend", ["hdf", "host"])
def test_resume_on_the_card_equals_the_uninterrupted_run(cuda, tmp_path, kind,
                                                          backend):
    """20 + 20 stored steps, the second 20 by a fresh graphed sampler that
    resumes the first's backend, against 40 in one run: the same chain,
    counters, clock and generator state."""
    full, start = _graph_sampler(cuda, kind, True)
    full.run_mcmc(start, 40, segment_size=10)
    store = _long_run_backend(backend, tmp_path, "resume")
    first, start = _graph_sampler(cuda, kind, True, backend=store)
    first.run_mcmc(start, 20, segment_size=10)
    del first
    resumed, _ = _graph_sampler(cuda, kind, True, backend=store)
    assert resumed.backend.iteration == 20
    resumed.run_mcmc(None, 20, segment_size=10)
    for name in ("chain", "inds"):
        np.testing.assert_array_equal(
            resumed.backend.get_value(name)["model_0"],
            full.backend.get_value(name)["model_0"], err_msg=name)
    for name in ("log_like", "log_prior", "betas"):
        np.testing.assert_array_equal(
            resumed.backend.get_value(name),
            full.backend.get_value(name).astype(np.float64), err_msg=name)
    for name in ("accepted", "swaps_accepted"):
        np.testing.assert_array_equal(getattr(resumed.backend, name),
                                      getattr(full.backend, name))
    assert int(resumed.temperature_control.time) == int(
        full.temperature_control.time)
    assert torch.equal(resumed._gen.get_state(), full._gen.get_state())


def test_stretch_scale_update_under_graphs_equals_eager(cuda):
    """``AdjustStretchProposalScale`` every 10 steps changes ``a``; the
    graphed sampler drops its graphs at each change and captures anew, so
    its chain equals the eager one digit for digit, and every step but one
    eager run per capture is a replay."""
    from eryn_tpu_torch.utils import AdjustStretchProposalScale

    runs, scales = {}, {}
    for graphed in (False, True):
        update = AdjustStretchProposalScale()
        sampler, start = _graph_sampler(cuda, "gaussian", graphed,
                                        update_fn=update, update_iterations=10)
        seen = []
        sampler.update_fn = lambda i, s, smp: (update(i, s, smp),
                                               seen.append(smp.moves[0].a))
        runs[graphed] = _run_record(sampler, start, 60, None)
        scales[graphed] = seen
        if graphed:
            changes = sum(a != b for a, b in zip([2.0] + seen[:-2], seen[:-1]))
            assert changes > 0
            assert sampler.graph_captures == 1 + changes
            assert sampler.graph_replays == 60 - sampler.graph_captures
    assert scales[True] == scales[False]
    for key in runs[False]:
        np.testing.assert_array_equal(runs[True][key], runs[False][key],
                                      err_msg=key)


# ----------------------------------------------------------------------
# the tempered-analysis path
# ----------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["gaussian", "rj"])
def test_deo_graphed_equals_eager(cuda, kind):
    """Deterministic even-odd swaps with the Syed schedule, graphed and
    eager from one seed: the same chain, ladders, clock, accept and swap
    counts, digit for digit.  The parity comes from the clock inside each
    replay, so every boundary swaps; no cascade kernel runs; the clock
    ticks on every tempering phase (the RJ move's too).  Under reversible
    jump the in-model phase always falls on an even clock and the RJ phase
    on an odd one, and only the in-model swaps are stored, as in
    eryn_tpu: the stored fractions are the even boundaries'."""
    steps, burn = 60, 20
    runs = {}
    for graphed in (False, True):
        sampler, start = _graph_sampler(
            cuda, kind, graphed,
            tempering=dict(swap_scheme="deo", adaptation_scheme="syed"))
        before = pt_swap.pt_swap_cascade_multi.launches
        runs[graphed] = _run_record(sampler, start, steps, burn)
        assert pt_swap.pt_swap_cascade_multi.launches == before
        swaps = np.asarray(sampler.swap_acceptance_fraction)
        if kind == "rj":
            assert np.all(swaps[0::2] > 0) and not swaps[1::2].any(), swaps
        else:
            assert np.all(swaps > 0), swaps
    for key in runs[False]:
        np.testing.assert_array_equal(runs[True][key], runs[False][key],
                                      err_msg=key)
    n = steps + burn
    assert runs[True]["time"] == n * (2 if kind == "rj" else 1)
    assert not np.array_equal(runs[True]["betas"][-1], runs[True]["betas"][0])


@pytest.mark.parametrize("kind", ["gaussian", "rj"])
def test_device_getters_equal_the_host_getters(cuda, kind):
    """A chain on the card (``DeviceBackend``) and the same chain from the
    same seed in ``Backend()``, on a fixed ladder: evidence within 1e-6
    relative (float32 log-likelihoods reduced in float64 on the card, in
    float32 by NumPy), Gelman-Rubin, R-hat and ESS within 1e-10."""
    from eryn_tpu_torch import Backend, DeviceBackend

    tempering = dict(adaptive=False, **({} if kind == "rj" else
                                         dict(Tmax=np.inf)))
    out = {}
    for name, backend in (("device", None), ("host", Backend())):
        sampler, start = _graph_sampler(cuda, kind, True, tempering=tempering,
                                        backend=backend)
        sampler.run_mcmc(start, 80, burn=20)
        b = sampler.backend
        assert isinstance(b, DeviceBackend) == (name == "device")
        out[name] = dict(
            ti=b.get_evidence_estimate(discard=10),
            gr=b.get_gelman_rubin_convergence_diagnostic(doprint=False),
            rhat=b.get_rank_normalized_rhat(return_parts=True),
            ess=b.get_effective_sample_size(return_parts=True),
            chain=sampler.get_chain()["model_0"])
    np.testing.assert_array_equal(out["device"]["chain"], out["host"]["chain"])
    np.testing.assert_allclose(out["device"]["ti"], out["host"]["ti"],
                               rtol=1e-6)
    for key in ("gr", "rhat", "ess"):
        np.testing.assert_allclose(
            np.asarray(out["device"][key]["model_0"], dtype=np.float64),
            np.asarray(out["host"][key]["model_0"], dtype=np.float64),
            rtol=1e-10, err_msg=key)


@pytest.mark.parametrize("rj", [False, True])
def test_non_uniform_priors_graphed_equal_eager(cuda, rj):
    """A multivariate normal on a tuple key, a normal and a log-uniform:
    their log densities (and, under reversible jump, the births drawn from
    them) run inside the captured steps; graphed equals eager digit for
    digit."""
    from eryn_tpu_torch import EnsembleSampler, State
    from eryn_tpu_torch.interop import priors_from_spec
    from eryn_tpu_torch.moves import RedBlueGroupStretchMove

    priors = priors_from_spec(
        {(0, 1): ("mvn_dist", (np.zeros(2), np.array([[1.0, 0.3],
                                                      [0.3, 0.5]]))),
         2: ("normal_dist", (0.0, 2.0)), 3: ("log_uniform", (0.1, 10.0))},
        device=cuda)
    runs = {}
    for graphed in (False, True):
        if rj:
            sampler = EnsembleSampler(
                32, 4, lambda c, i: -0.5 * torch.sum(
                    torch.where(i[:, None], c, 0.0) ** 2),
                priors, nleaves_max=3, rj_moves=True,
                moves=RedBlueGroupStretchMove(live_dangerously=True),
                tempering_kwargs=dict(ntemps=3), fill_zero_leaves_val=0.0,
                seed=2, device=cuda, cuda_graph=graphed)
            coords = priors.rvs_stratified((3, 32, 3), seed=1)
            inds = np.random.default_rng(1).random((3, 32, 3)) < 0.5
            start = State(coords, inds=inds)
        else:
            sampler = EnsembleSampler(
                32, 4, lambda x: -0.5 * torch.sum(x * x), priors,
                tempering_kwargs=dict(ntemps=3), seed=2, device=cuda,
                cuda_graph=graphed)
            start = priors.rvs_stratified((3, 32), seed=1)
        runs[graphed] = _run_record(sampler, start, 40, 10)
        assert np.isfinite(runs[graphed]["log_prior"]).all()
    for key in runs[False]:
        np.testing.assert_array_equal(runs[True][key], runs[False][key],
                                      err_msg=key)


# ----------------------------------------------------------------------
# the move zoo without gradients
# ----------------------------------------------------------------------
ZOO = ["gaussian diag", "gaussian full", "gaussian sequential", "gaussian random",
       "distgen", "group stretch", "mt independent", "mt regenerated", "dr",
       "combine", "mt rj", "model swap",
       # the gradient moves and the rest of the in-model zoo
       "mala", "mala precond", "hmc", "hmc jittered", "hmc precond", "chees",
       "de", "snooker", "walk", "kde", "slice", "aimh"]


def _zoo_sampler(cuda, kind, cuda_graph):
    """A small configuration of ``kind`` on the card and its start: the
    4 x 32 x 3 tempered Gaussian for the in-model moves, 3 x 32 walkers
    with up to 3 leaves for multiple-try reversible jump, two one-leaf
    models for the model swap."""
    from eryn_tpu_torch import EnsembleSampler, ProbDistContainer, State, uniform_dist
    from eryn_tpu_torch import moves as tm

    g = torch.Generator(cuda).manual_seed(1)
    if kind == "mt rj":
        pr = ProbDistContainer({i: uniform_dist(-1.0, 1.0) for i in range(2)})
        sampler = EnsembleSampler(
            32, 2,
            lambda c, i: -0.5 * torch.sum(torch.where(i[:, None], c, 0.0) ** 2),
            pr, nleaves_max=3,
            moves=tm.RedBlueGroupStretchMove(live_dangerously=True),
            rj_moves=[tm.MTDistGenMoveRJ(pr, nleaves_max={"model_0": 3},
                                         nleaves_min={"model_0": 0},
                                         num_try=4)],
            tempering_kwargs=dict(ntemps=3), fill_zero_leaves_val=0.0,
            seed=0, device=cuda, cuda_graph=cuda_graph)
        coords = pr.rvs(size=(3, 32, 3), generator=g)
        inds = torch.rand((3, 32, 3), generator=g, device=cuda) < 0.5
        return sampler, State(coords, inds=inds)
    if kind == "model swap":
        names = ["a", "b"]
        priors = {"a": ProbDistContainer({0: uniform_dist(0.0, 2.0)}),
                  "b": ProbDistContainer({0: uniform_dist(-1.0, 1.0)})}

        def ll(coords, inds):
            x = sum(torch.sum(torch.where(inds[n][:, None], coords[n], 0.0))
                    for n in names)
            return -0.5 * (x - 0.5) ** 2 / 0.3

        sampler = EnsembleSampler(
            32, {"a": 1, "b": 1}, ll, priors, branch_names=names,
            nleaves_max={"a": 1, "b": 1}, nleaves_min={"a": 0, "b": 0},
            moves=[tm.GaussianMove({"a": 0.05, "b": 0.05})],
            rj_moves=[tm.ModelSwapRJMove(priors)],
            tempering_kwargs=dict(ntemps=3), fill_zero_leaves_val=-1e8,
            seed=0, device=cuda, cuda_graph=cuda_graph)
        pick = torch.rand((3, 32, 1), generator=g, device=cuda) < 0.5
        coords = {n: priors[n].rvs(size=(3, 32, 1), generator=g) for n in names}
        return sampler, State(coords, inds={"a": pick, "b": ~pick})
    pr = ProbDistContainer({i: uniform_dist(-5.0, 5.0) for i in range(3)})
    diag = {"model_0": np.full(3, 0.5 ** 2)}
    move = {
        "gaussian diag": lambda: tm.GaussianMove(diag),
        "gaussian full": lambda: tm.GaussianMove(
            {"model_0": 0.25 * np.eye(3) + 0.05}),
        "gaussian sequential": lambda: tm.GaussianMove(
            {"model_0": 1.0}, mode="sequential", factor=2.0),
        "gaussian random": lambda: tm.GaussianMove({"model_0": 1.0},
                                                   mode="random"),
        "distgen": lambda: tm.DistributionGenerate({"model_0": pr}),
        "group stretch": lambda: tm.GroupStretchMove(n_iter_update=7),
        "mt independent": lambda: tm.MTDistGenMove(
            {"model_0": pr}, num_try=4, independent=True),
        "mt regenerated": lambda: tm.MTDistGenMove(
            {"model_0": pr}, num_try=4, independent=False),
        "dr": lambda: tm.DelayedRejection(tm.GaussianMove(diag), max_iter=2),
        "combine": lambda: tm.CombineMove([
            tm.GroupStretchMove(n_iter_update=7),
            tm.DelayedRejection(tm.GaussianMove(diag, mode="sequential"),
                                max_iter=2)]),
        # tune_steps inside the run, so that the graphs replay the
        # adaptation and its freeze
        "mala": lambda: tm.MALAMove(tune_steps=30),
        "mala precond": lambda: tm.MALAMove(tune_steps=30,
                                            ensemble_precondition=True),
        "hmc": lambda: tm.HMCMove(tune_steps=30),
        "hmc jittered": lambda: tm.HMCMove(num_leapfrog=(3, 7), tune_steps=30),
        "hmc precond": lambda: tm.HMCMove(tune_steps=30,
                                          ensemble_precondition=True),
        "chees": lambda: tm.ChEESHMCMove(tune_steps=30),
        "de": lambda: tm.DEMove(),
        "snooker": lambda: tm.DESnookerMove(),
        "walk": lambda: tm.WalkMove(),
        "kde": lambda: tm.KDEMove(),
        "slice": lambda: tm.SliceMove(tune_steps=30),
        "aimh": lambda: tm.AIMHMove(tune_steps=30),
    }[kind]()
    sampler = EnsembleSampler(
        32, 3, lambda x: -0.5 * torch.sum(x * x), pr, moves=move,
        tempering_kwargs=dict(ntemps=4), seed=0, device=cuda,
        cuda_graph=cuda_graph)
    return sampler, pr.rvs(size=(4, 32), generator=g)


def _zoo_record(sampler, start, steps, burn):
    from eryn_tpu_torch.interop import kernel_state_to_numpy

    sampler.run_mcmc(start, steps, burn=burn)
    b = sampler.backend
    out = {f"chain {n}": c for n, c in sampler.get_chain().items()}
    out.update({f"inds {n}": m for n, m in sampler.get_inds().items()})
    out.update(log_like=sampler.get_log_like(), betas=sampler.get_betas(),
               accepted=b.accepted, swaps=b.swaps_accepted,
               time=int(sampler.temperature_control.time))
    if sampler.has_reversible_jump:
        out["rj_accepted"] = b.rj_accepted
    for i, leaf in enumerate(kernel_state_to_numpy(sampler._kernel_states)):
        out[f"kernel state {i}"] = leaf
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize("kind", ZOO)
def test_zoo_graphed_equals_eager(cuda, kind):
    """Each in-model move from one seed, graphed and eager: chains,
    masks, ladders, clock, accept and swap counts and the moves' kernel
    states equal digit for digit.  One cascade launch per swap phase (two
    a step under ``CombineMove``, one per move under reversible jump); no
    stretch kernel outside the red/blue group stretch; kernel 5 twice a
    step beside multiple-try reversible jump."""
    steps, burn = 40, 10
    n = steps + burn
    kernels = (sk.stretch_propose, sk.stretch_accept_propose, sk.stretch_accept,
               pt_swap.pt_swap_cascade_multi,
               select_kernels.group_stretch_propose)
    runs = {}
    for graphed in (False, True):
        sampler, start = _zoo_sampler(cuda, kind, graphed)
        before = [k.launches for k in kernels]
        runs[graphed] = _zoo_record(sampler, start, steps, burn)
        launches = [k.launches - b for k, b in zip(kernels, before)]
        phases = 2 * n if kind in ("combine", "mt rj", "model swap") else n
        assert launches == [0, 0, 0, phases,
                            2 * n if kind == "mt rj" else 0], launches
        if graphed:
            per_step = 2 if sampler.has_reversible_jump else 1
            assert sampler.graph_replays == per_step * n - per_step
        else:
            assert sampler.graph_replays == 0
    for key in runs[False]:
        np.testing.assert_array_equal(runs[True][key], runs[False][key],
                                      err_msg=key)
    assert runs[True]["time"] == (2 * n if kind == "combine" else n)
    acc = runs[True]["accepted"][0] / n
    assert 0 < acc.mean(), acc


# ----------------------------------------------------------------------
# blobs and supplementals through the graphed step
# ----------------------------------------------------------------------
BLOB_MOVES = ["stretch", "de", "gaussian", "mala", "chees", "slice", "mt"]


def _blob_run(cuda, kind, cuda_graph):
    """A 4 x 32 x 3 tempered Gaussian whose likelihood returns ``(ll, [-2
    ll, x0])`` and divides by a branch supplemental ``sigma`` of ones, with
    a state tag ``rid`` and a host object per walker; its record."""
    from eryn_tpu_torch import (BranchSupplemental, EnsembleSampler,
                                ProbDistContainer, State, uniform_dist)
    from eryn_tpu_torch import moves as tm

    nt, nw = 4, 32
    pr = ProbDistContainer({i: uniform_dist(-5.0, 5.0) for i in range(3)})
    move = {
        "stretch": lambda: tm.StretchMove(),
        "de": lambda: tm.DEMove(),
        "gaussian": lambda: tm.GaussianMove({"model_0": np.full(3, 0.25)}),
        "mala": lambda: tm.MALAMove(tune_steps=20),
        "chees": lambda: tm.ChEESHMCMove(tune_steps=20, max_leapfrog=8),
        "slice": lambda: tm.SliceMove(tune_steps=20),
        "mt": lambda: tm.MTDistGenMove({"model_0": pr}, num_try=4),
    }[kind]()

    def ll(x, supps):
        v = -0.5 * torch.sum((x / supps["sigma"]) ** 2)
        return v, torch.stack([-2.0 * v, x[0]])

    sampler = EnsembleSampler(
        nw, 3, ll, pr, moves=move, provide_supplemental=True,
        tempering_kwargs=dict(ntemps=nt), seed=0, device=cuda,
        cuda_graph=cuda_graph)
    g = torch.Generator(cuda).manual_seed(1)
    objs = np.empty((nt, nw), dtype=object)
    objs[...] = [[("w", t * nw + w) for w in range(nw)] for t in range(nt)]
    state = State(
        {"model_0": pr.rvs(size=(nt, nw), generator=g)},
        supplemental=BranchSupplemental(
            {"rid": torch.arange(nt * nw, device=cuda).reshape(nt, nw),
             "obj": objs}),
        branch_supplemental={"model_0": BranchSupplemental(
            {"sigma": torch.ones((nt, nw), device=cuda)})})
    cascade = pt_swap.pt_swap_cascade_multi.launches
    stretch = sk.stretch_propose.launches + sk.stretch_accept.launches
    sampler.run_mcmc(state, 30, burn=10)
    assert pt_swap.pt_swap_cascade_multi.launches - cascade == 40
    assert sk.stretch_propose.launches + sk.stretch_accept.launches == stretch
    last = sampler._previous_state
    return {"chain": sampler.get_chain()["model_0"],
            "log_like": sampler.get_log_like(), "blobs": sampler.get_blobs(),
            "rid": last.supplemental["rid"].cpu().numpy(),
            "obj": np.array([o[1] for o in last.supplemental["obj"].ravel()]),
            "sigma": last.branches["model_0"].supplemental["sigma"].cpu().numpy()}


@pytest.mark.parametrize("kind", BLOB_MOVES)
def test_blobs_and_supplementals_graphed_equal_eager(cuda, kind):
    """Blobs, a state tag, a branch supplemental and a host object through
    the graphed step: equal to the eager loop digit for digit, the blob
    identity on every stored sample, the tag a permutation that the host
    objects follow, one cascade launch a step and no stretch kernel."""
    eager, graphed = (_blob_run(cuda, kind, g) for g in (False, True))
    for key in eager:
        np.testing.assert_array_equal(graphed[key], eager[key], err_msg=key)
    np.testing.assert_array_equal(graphed["blobs"][..., 0],
                                  -2.0 * graphed["log_like"])
    np.testing.assert_array_equal(graphed["blobs"][..., 1],
                                  graphed["chain"][:, :, :, 0, 0])
    rid = graphed["rid"].ravel()
    assert sorted(rid.tolist()) == list(range(rid.size))
    assert not np.array_equal(rid, np.arange(rid.size))
    np.testing.assert_array_equal(graphed["obj"], rid)


# ----------------------------------------------------------------------
# the host side: a NumPy likelihood, and a host move among native ones
# ----------------------------------------------------------------------
@pytest.mark.parametrize("vectorize", [False, True])
def test_host_likelihood_on_the_card_captures_nothing(cuda, vectorize):
    """A NumPy likelihood on the card with ``cuda_graph=True``: host mode,
    no graph captured or replayed, one of each stretch kernel and one
    cascade a step; its chain equals the ``cuda_graph=False`` run's."""
    from eryn_tpu_torch import EnsembleSampler, ProbDistContainer, uniform_dist

    def ll(x):
        if vectorize:
            return -0.5 * np.sum(x**2, axis=-1)
        return -0.5 * float(np.sum(x**2))

    pr = ProbDistContainer({i: uniform_dist(-5.0, 5.0) for i in range(3)})
    kernels = (sk.stretch_propose, sk.stretch_accept_propose,
               sk.stretch_accept, pt_swap.pt_swap_cascade_multi)
    chains = []
    for graph in (True, False):
        s = EnsembleSampler(16, 3, ll, pr, tempering_kwargs=dict(ntemps=3),
                            seed=0, device=cuda, cuda_graph=graph,
                            vectorize=vectorize)
        before = [k.launches for k in kernels]
        start = pr.rvs(size=(3, 16),
                       generator=torch.Generator(cuda).manual_seed(1))
        with pytest.warns(UserWarning, match="never as a CUDA graph"):
            s.run_mcmc(start, 30, burn=10)
        assert s.likelihood_mode == "host"
        assert s.graph_captures == s.graph_replays == 0 and s._graphs is None
        assert [k.launches - b for k, b in zip(kernels, before)] == [40] * 4
        chains.append(s.get_chain()["model_0"])
    np.testing.assert_array_equal(chains[0], chains[1])


def test_hybrid_run_graphed_equals_eager(cuda):
    """A host MH move beside the stretch move: graphed, the stretch slots
    replay their graph and the host slots run eagerly between them; the run
    equals the ``cuda_graph=False`` run digit for digit."""
    from eryn_tpu_torch import EnsembleSampler, ProbDistContainer, uniform_dist
    from eryn_tpu_torch.moves import MHMove, StretchMove

    class HostMH(MHMove):
        def get_proposal(self, branches_coords, random, branches_inds=None,
                         **kwargs):
            q = {n: np.asarray(c) + 0.3 * random.randn(*np.shape(c))
                 for n, c in branches_coords.items()}
            return q, np.zeros(next(iter(q.values())).shape[:2])

    pr = ProbDistContainer({i: uniform_dist(-5.0, 5.0) for i in range(3)})
    runs = {}
    for graph in (False, True):
        with pytest.warns(UserWarning, match="HYBRID"):
            s = EnsembleSampler(
                32, 3, lambda x: -0.5 * torch.sum(x * x), pr,
                moves=[(StretchMove(), 0.8), (HostMH(), 0.2)],
                tempering_kwargs=dict(ntemps=4), seed=0, device=cuda,
                cuda_graph=graph)
        start = pr.rvs(size=(4, 32),
                       generator=torch.Generator(cuda).manual_seed(1))
        runs[graph] = _run_record(s, start, 60, 20)
        native, host = s.moves
        assert native.num_proposals + host.num_proposals == 80
        assert host.num_proposals > 0
        if graph:
            assert s.graph_replays == native.num_proposals - 1
    for key in runs[False]:
        np.testing.assert_array_equal(runs[True][key], runs[False][key],
                                      err_msg=key)


# ----------------------------------------------------------------------
# groups: the kernels with a leading group axis, under torch.func.vmap,
# and the batched runner graphed against its eager loop
# ----------------------------------------------------------------------
def _grouped_stretch(dtype, G, nt, nw, D):
    """``G`` stretch states of :func:`_stretch_state` stacked on a leading
    group axis, each group's draws its own."""
    parts = [_stretch_state(dtype, nt, nw, D) for _ in range(G)]
    g = torch.Generator().manual_seed(G)
    for st, _ in parts:
        st["perm"] = torch.randperm(nw, generator=g).cuda()
        st["u_all"] = _rand(g, dtype, 2, 3, nt, nw)
    st = {k: torch.stack([p[0][k] for p in parts]) for k in parts[0][0]}
    new = [tuple(torch.stack([p[1][h][i] for p in parts]) for i in range(2))
           for h in range(2)]
    return st, new


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("G", [1, 4])
def test_grouped_stretch_kernels(cuda, dtype, G):
    """The split and fused stretch steps over ``G`` groups in one launch
    each equal their plain grouped versions bitwise (a grouped launch runs
    each group's arithmetic of the ungrouped one); at ``G = 1`` they equal
    the ungrouped launch."""
    nt, nw, D = 10, 100, 5
    st, new = _grouped_stretch(dtype, G, nt, nw, D)
    X, nd, perm, u, betas = (st[k] for k in ("X", "ndim_act", "perm", "u_all",
                                             "betas"))
    before = [k.launches for k in (sk.stretch_propose, sk.stretch_accept_propose,
                                   sk.stretch_accept)]

    def outs():
        return (torch.full_like(X, np.nan),
                *(torch.full_like(st["logl"], np.nan) for _ in range(3)))

    runs = {}
    for form in ("kernel", "plain"):
        sfx = "" if form == "kernel" else "_ref"
        propose = getattr(sk, "stretch_propose_grouped" + sfx)
        acc_prop = getattr(sk, "stretch_accept_propose_grouped" + sfx)
        accept = getattr(sk, "stretch_accept_grouped" + sfx)
        o = outs()
        q0, f0 = propose(X, X, nd, perm, u, 0)
        q1, f1 = acc_prop(q0, X, *new[0], st["logl"], st["logp"], f0, betas,
                          nd, perm, u, *o)
        accept(q1, X, *new[1], st["logl"], st["logp"], f1, betas, perm, u, 1,
               *o)
        # the split form: accept half 0 alone, then propose half 1
        o2 = outs()
        accept(q0, X, *new[0], st["logl"], st["logp"], f0, betas, perm, u, 0,
               *o2)
        q1s, f1s = propose(X, o2[0], nd, perm, u, 1)
        runs[form] = (q0, f0, q1, f1, *o, q1s, f1s, *o2)
    torch.cuda.synchronize()
    for a, b in zip(runs["kernel"], runs["plain"]):
        assert torch.equal(a.isnan(), b.isnan()) and _max_abs(a, b) == 0.0
    after = [k.launches for k in (sk.stretch_propose, sk.stretch_accept_propose,
                                  sk.stretch_accept)]
    assert [a - b for a, b in zip(after, before)] == [2, 1, 2]
    assert 0 < float(runs["kernel"][7].sum()) < G * nt * nw
    if G == 1:
        o = outs()
        q0, f0 = sk.stretch_propose(X[0], X[0], nd[0], perm[0], u[0], 0)
        q1, f1 = sk.stretch_accept_propose(
            q0, X[0], new[0][0][0], new[0][1][0], st["logl"][0],
            st["logp"][0], f0, betas[0], nd[0], perm[0], u[0],
            *(x[0] for x in o))
        for a, b in zip((q0, f0, q1, f1), runs["kernel"][:4]):
            assert torch.equal(a, b[0])


def _max_abs(a, b):
    same = (a == b) | (a.isnan() & b.isnan())
    d = (a.double() - b.double()).abs().masked_fill(same, 0.0)
    return float(d.max()) if d.numel() else 0.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("nw", [100, 1000])
def test_grouped_cascade(cuda, dtype, G, nw):
    """``G`` ladders in one launch (``blockIdx.y``), plain and rolled, in
    the grid form and with the rows in global memory: bitwise the plain
    grouped version, and at ``G = 1`` the ungrouped launch."""
    nt, nl, nd = 5, 2, 3
    g = torch.Generator().manual_seed(nw + G)
    logl = _randn(g, dtype, G, nt, nw) * 10
    leaves = [_randn(g, dtype, G, nt, nw, nl, nd),
              _rand(g, dtype, G, nt, nw, nl) < 0.4, _randn(g, dtype, G, nt, nw)]
    betas = torch.logspace(0, -2, nt, dtype=dtype, device="cuda").expand(
        G, nt) * (1 + 0.1 * _rand(g, dtype, G, 1))
    betas = betas.contiguous()
    pi = torch.stack([torch.randperm(nw, generator=g) for _ in range(G)]).cuda()
    shifts = torch.randint(0, nw, (G, nt - 1), generator=g,
                           dtype=torch.int32).cuda()
    raccept = torch.log(_rand(g, dtype, G, nt - 1, nw))

    def outs():
        return (torch.empty_like(logl), [torch.empty_like(x) for x in leaves],
                logl.new_empty((G, nt - 1)), logl.new_empty((G, nt - 1, nw)))

    args = (logl, leaves, betas, pi, shifts, raccept)
    ref = outs()
    pt_swap.pt_swap_cascade_tree_grouped_ref(*args, *ref)
    flat = lambda o: (o[0], *o[1], o[2], o[3])  # noqa: E731
    for form in ("grid", "global"):
        got = outs()
        limit = pt_swap.SHARED_LIMIT
        if form == "global":
            pt_swap.SHARED_LIMIT = 0
        try:
            pt_swap.pt_swap_cascade_tree_grouped(*args, *got)
        finally:
            pt_swap.SHARED_LIMIT = limit
        for a, b in zip(flat(got), flat(ref)):
            assert a.dtype == b.dtype and torch.equal(a, b), form
    assert 0 < float(ref[2].sum()) < G * (nt - 1) * nw
    if G == 1:
        one = (torch.empty_like(logl[0]), [torch.empty_like(x[0]) for x in leaves],
               logl.new_empty(nt - 1), logl.new_empty((nt - 1, nw)))
        pt_swap.pt_swap_cascade_tree(*(x[0] for x in (logl,)),
                                     [x[0] for x in leaves],
                                     *(x[0] for x in args[2:]), *one)
        for a, b in zip(flat(one), flat(ref)):
            assert torch.equal(a, b[0])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("G", [1, 4])
def test_grouped_group_stretch_propose(cuda, dtype, G):
    """``G * nt`` rows of one launch equal each group's plain version."""
    cases = [_group_case(dtype, nt=10, nw=200, shapes={"m": (8, 3)}, off=100,
                         ns=100, seed=i) for i in range(G)]
    args = []
    for i in range(6):
        if isinstance(cases[0][0][i], dict):
            args.append({n: torch.stack([c[0][i][n] for c in cases])
                         for n in cases[0][0][i]})
        else:
            args.append(torch.stack([c[0][i] for c in cases]))
    # the moving block as a view of the permuted ensemble, as the move has it
    args[0] = {n: x[:, :, 100:200] for n, x in args[2].items()}
    args[1] = {n: x[:, :, 100:200] for n, x in args[3].items()}
    before = select_kernels.group_stretch_propose.launches
    q, f = select_kernels.group_stretch_propose_grouped(*args, skip=(100, 100))
    assert select_kernels.group_stretch_propose.launches == before + 1
    q_r, f_r = select_kernels.group_stretch_propose_grouped_ref(
        *args, skip=(100, 100))
    assert torch.equal(f, f_r) and all(_same(q[n], q_r[n]) for n in q)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_vmapped_ops_equal_a_loop_over_groups(cuda, dtype):
    """Inside ``torch.func.vmap`` the wrappers reach the grouped launches
    (one launch for every group) through their custom ops; the results
    equal a Python loop over the groups, launch by launch."""
    G, nt, nw, D = 3, 4, 40, 3
    st, new = _grouped_stretch(dtype, G, nt, nw, D)

    def step(X, nd, perm, u, ll, lp, betas, l0, p0, l1, p1):
        q, f0 = sk.stretch_propose(X, X, nd, perm, u, 0)
        outs = (torch.empty_like(X), torch.empty_like(ll),
                torch.empty_like(ll), torch.empty_like(ll))
        q1, f1 = sk.stretch_accept_propose(q, X, l0, p0, ll, lp, f0, betas,
                                           nd, perm, u, *outs)
        sk.stretch_accept(q1, X, l1, p1, ll, lp, f1, betas, perm, u, 1, *outs)
        return outs

    ins = (st["X"], st["ndim_act"], st["perm"], st["u_all"], st["logl"],
           st["logp"], st["betas"], *new[0], *new[1])
    counters = (sk.stretch_propose, sk.stretch_accept_propose, sk.stretch_accept)
    before = [k.launches for k in counters]
    batched = torch.func.vmap(step)(*ins)
    assert [k.launches - b for k, b in zip(counters, before)] == [1, 1, 1]
    for g in range(G):
        one = step(*(x[g] for x in ins))
        for a, b in zip(batched, one):
            assert torch.equal(a[g], b)


@pytest.mark.parametrize("kind", ["gaussian", "rj"])
def test_para_graphed_equals_eager(cuda, kind):
    """The batched runner's graphed chain equals its eager chain digit for
    digit, with one launch of each stretch kernel (or two group-stretch
    proposals) and one cascade a step for all the groups together."""
    from eryn_tpu_torch import ProbDistContainer, uniform_dist
    from eryn_tpu_torch.moves import RedBlueGroupStretchMove
    from eryn_tpu_torch.parallel import ParaEnsembleSampler

    G, steps, burn = 4, 40, 10
    g = torch.Generator(cuda).manual_seed(3)
    if kind == "rj":
        pr = ProbDistContainer({i: uniform_dist(-1.0, 1.0) for i in range(2)})
        kw = dict(nleaves_max=3, rj_moves=True, fill_zero_leaves_val=0.0,
                  moves=RedBlueGroupStretchMove(live_dangerously=True))
        ll = lambda c, i: -0.5 * torch.sum(  # noqa: E731
            torch.where(i[:, None], c, 0.0) ** 2)
        ndim, nt = 2, 3
        coords = pr.rvs(size=(G, nt, 32, 3), generator=g)
        inds = torch.rand((G, nt, 32, 3), generator=g, device=cuda) < 0.5
    else:
        pr = ProbDistContainer({i: uniform_dist(-5.0, 5.0) for i in range(3)})
        kw, ndim, nt, inds = {}, 3, 4, None
        ll = lambda x: -0.5 * torch.sum(x * x)  # noqa: E731
        coords = pr.rvs(size=(G, nt, 32), generator=g)
    kernels = (sk.stretch_propose, sk.stretch_accept_propose, sk.stretch_accept,
               pt_swap.pt_swap_cascade_multi, select_kernels.group_stretch_propose)
    runs = {}
    for graphed in (False, True):
        para = ParaEnsembleSampler(G, 32, ndim, ll, pr,
                                   tempering_kwargs=dict(ntemps=nt), seed=5,
                                   device=cuda, cuda_graph=graphed, **kw)
        before = [k.launches for k in kernels]
        para.run_mcmc(coords, steps, burn=burn, inds=inds)
        runs[graphed] = dict(
            chain=para.get_chain()["model_0"], inds=para.get_inds()["model_0"],
            log_like=para.get_log_like(), betas=para.get_betas(),
            launches=[k.launches - b for k, b in zip(kernels, before)])
        if graphed:
            per_step = 2 if kind == "rj" else 1
            assert para.graph_replays == per_step * (steps + burn) - len(
                para._graphs.warm)
    for key in runs[False]:
        np.testing.assert_array_equal(runs[True][key], runs[False][key],
                                      err_msg=key)
    n = steps + burn
    expect = ([n] * 3 + [n, 0]) if kind == "gaussian" else [0] * 3 + [2 * n, 2 * n]
    assert runs[True]["launches"] == expect
    chain = runs[True]["chain"]
    assert not np.array_equal(chain[:, 0], chain[:, 1])


def _mesh_zoo_rank(rank, world):
    """One NCCL rank on a ``(1, 1)`` mesh, the sharded route
    (``_one_rank_layout``): the tuning moves and the group stretch at equal
    weights, captured, then eager, from one seed; each run's getters, its
    replays and its graphs per move."""
    from eryn_tpu_torch import (
        DeviceBackend,
        EnsembleSampler,
        ProbDistContainer,
        State,
        uniform_dist,
    )
    from eryn_tpu_torch import moves as tm
    from eryn_tpu_torch.parallel import make_mesh, shard_state

    mesh = make_mesh(1)
    pr = ProbDistContainer({i: uniform_dist(-5.0, 5.0) for i in range(3)})
    out = {}
    for graphed in (True, False):
        moves = [tm.SliceMove(tune_steps=4), tm.MALAMove(tune_steps=4),
                 tm.HMCMove(num_leapfrog=(2, 3), tune_steps=4),
                 tm.ChEESHMCMove(max_leapfrog=4, init_num_leapfrog=2,
                                 tune_steps=4),
                 tm.AIMHMove(tune_steps=4), tm.GroupStretchMove(n_iter_update=3)]
        s = EnsembleSampler(
            32, 3, lambda x: -0.5 * torch.sum(x * x), pr,
            moves=[(m, 1 / len(moves)) for m in moves],
            tempering_kwargs=dict(ntemps=4), seed=5, device="cuda",
            cuda_graph=graphed, backend=DeviceBackend())
        coords = pr.rvs(size=(4, 32), generator=torch.Generator(
            device="cuda").manual_seed(5))
        state = shard_state(State({"model_0": coords[:, :, None, :]}), mesh)
        s._one_rank_layout = state.sharding.layout
        s.run_mcmc(state, 40, burn=20)
        per = {}
        for key in (s._graphs.graphs if graphed else ()):
            per[key[0]] = per.get(key[0], 0) + 1
        out[graphed] = dict(
            chain=s.get_chain()["model_0"], log_like=s.get_log_like(),
            betas=s.get_betas(), acc=s.acceptance_fraction,
            swaps=s.swap_acceptance_fraction, replays=s.graph_replays,
            graphs=[per.get(j, 0) for j in range(len(moves))],
            sharded=s._mesh_layout is not None)
    return out


def test_mesh_nccl_zoo_captured_equals_eager(cuda):
    """Under a one-rank NCCL mesh every native move's sharded step is
    captured, a tuning move's in two graphs (tuning and tuned), the group
    stretch's in two (a refresh due and not), the slice move's in one; the
    captured chain, which crosses both, equals the eager one digit for
    digit."""
    from eryn_tpu_torch.parallel._spawn import launch

    got = launch(_mesh_zoo_rank, 1, backend="nccl", timeout=300)[0]
    cap, eag = got[True], got[False]
    assert cap["sharded"] and eag["sharded"]
    for key in ("chain", "log_like", "betas", "acc", "swaps"):
        np.testing.assert_array_equal(cap[key], eag[key], err_msg=key)
    assert cap["replays"] > 0 and eag["replays"] == 0
    assert cap["graphs"] == [1, 2, 2, 2, 2, 2]
