"""One whole sampler step of the port's kernel path (fused stretch move, swap
cascade, ladder adjustment), driven by numpy-made draws, against the same
sequence composed from the JAX package's functions
(``moves/stretch.py:_propose_impl_fused`` and
``moves/tempering.py:_swap_kernel_pallas`` / ``ladder_adjustment_kernel``).

On the CPU the port's kernel wrappers run their plain versions; the JAX
kernels run in interpret mode.  The CPU path's general cascade is held to
eryn_tpu's XLA-form ``swap_kernel`` the same way, with the draws that
function takes from its key.

Tolerances: stretch accept decisions and per-rung swap counts are compared
exactly.  Coordinates, log-likelihoods, log-priors and betas agree within
rtol 1e-6 / atol 1e-6: the two libraries round the likelihood's reduction,
``exp`` and ``log`` differently, by a few float32 ulp.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import eryn_tpu
from eryn_tpu.ops.pt_swap import pt_swap_cascade_multi as jax_cascade
from eryn_tpu.ops.stretch_kernels import stretch_accept as jax_accept
from eryn_tpu.ops.stretch_kernels import stretch_propose as jax_propose

import eryn_tpu_torch
from eryn_tpu_torch.interop import state_from_numpy

torch.set_num_threads(1)

NT, NDIM, TIME = 4, 3, 7


def _inputs(nw, seed):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    coords = rng.uniform(-2, 2, (NT, nw, 1, NDIM)).astype(f32)
    logl = (-0.5 * (coords[:, :, 0] ** 2).sum(-1)).astype(f32)
    logp = np.full((NT, nw), 3 * np.log(0.1), f32)
    betas = eryn_tpu.moves.tempering.make_ladder(NDIM, NT).astype(f32)
    draws = dict(
        perm=rng.permutation(nw),
        u_all=rng.random((2, 3, NT, nw)).astype(f32),
        pi=rng.permutation(nw),
        shifts=rng.integers(0, nw, NT - 1).astype(np.int32),
        raccept=np.log(rng.random((NT - 1, nw))).astype(f32),
    )
    return coords, logl, logp, betas, draws


def _jax_step(nw, coords, logl, logp, betas, d):
    """The JAX package's kernel-path step, composed by hand from its
    functions with the given draws."""
    priors = eryn_tpu.ProbDistContainer(
        {i: eryn_tpu.uniform_dist(-5.0, 5.0) for i in range(NDIM)}
    )
    sampler = eryn_tpu.EnsembleSampler(
        nw, NDIM, lambda x: -0.5 * jnp.sum(x * x), priors,
        tempering_kwargs=dict(ntemps=NT), seed=0,
    )
    ctx = sampler.get_eval_context()
    tc = sampler.temperature_control
    betas = jnp.asarray(betas)
    perm = jnp.asarray(d["perm"])
    u_all = jnp.asarray(d["u_all"])

    # moves/stretch.py:196-263
    X = jnp.asarray(coords).reshape(NT, nw, -1)
    inds = jnp.ones((NT, nw, 1), dtype=bool)
    ndim_act = jnp.full((NT, nw), float(NDIM), jnp.float32)
    inv_perm = jnp.argsort(perm)
    n0 = nw - nw // 2
    Xp = X[:, perm]
    lolp = jnp.stack(
        [jnp.asarray(logl), jnp.asarray(logp), ndim_act, jnp.zeros_like(ndim_act)],
        axis=-1,
    )[:, perm]
    for half, (off, ns) in enumerate(zip([0, n0], [n0, nw - n0])):
        s_blk = Xp[:, off:off + ns]
        c_blk = jnp.concatenate([Xp[:, :off], Xp[:, off + ns:]], axis=1)
        blk = lolp[:, off:off + ns]
        q, factors = jax_propose(
            s_blk, c_blk, blk[..., 2], u_all[half, :2, :, :ns], a=2.0,
            interpret=True,
        )
        q_b = {"model_0": q.reshape(NT, ns, 1, NDIM)}
        inds_b = {"model_0": inds[:, off:off + ns]}
        logp_new = ctx.compute_log_prior(q_b, inds_b)
        logl_new, _ = ctx.compute_log_like(q_b, inds_b, logp_new)
        coords_blk, logl_blk, logp_blk, acc = jax_accept(
            q, s_blk, logl_new, logp_new, blk[..., 0], blk[..., 1], factors,
            betas, u_all[half, 2, :, :ns], interpret=True,
        )
        Xp = Xp.at[:, off:off + ns].set(coords_blk)
        lolp = lolp.at[:, off:off + ns].set(
            jnp.stack([logl_blk, logp_blk, blk[..., 2], acc], axis=-1)
        )
    X = Xp[:, inv_perm]
    out = lolp[:, inv_perm]
    logl, logp, accepted = out[..., 0], out[..., 1], out[..., 3]

    # moves/tempering.py:550-607 (payload cascade)
    swap_tree = {
        "coords": {"model_0": X.reshape(NT, nw, 1, NDIM)},
        "inds": {"model_0": inds},
        "log_prior": logp,
    }
    channels, unpack = tc._try_pack_channels(swap_tree, logl)
    E = jax.nn.one_hot(jnp.asarray(d["pi"]), nw, dtype=jnp.float32, axis=0)

    def relabel(x, m):
        return jnp.matmul(x, m, precision=jax.lax.Precision.HIGHEST)

    logl_res, ch_res, sel = jax_cascade(
        relabel(logl, E), relabel(channels, E), betas[:-1] - betas[1:],
        jnp.asarray(d["shifts"]), jnp.asarray(d["raccept"]), interpret=True,
    )
    logl = relabel(logl_res, E.T)
    swap_tree = unpack(relabel(ch_res, E.T))
    # moves/tempering.py:776-798 and :610-618
    ratios = sel.sum(axis=-1) / nw
    betas = tc.ladder_adjustment_kernel(jnp.float32(TIME), betas, ratios)
    return dict(
        coords=swap_tree["coords"]["model_0"], log_like=logl,
        log_prior=swap_tree["log_prior"], betas=betas, accepted=accepted,
        swaps=ratios * nw,
    )


def _port_step(nw, coords, logl, logp, betas, d):
    """The port's step through ``StretchMove.propose_kernel`` with the
    fused path and kernel cascade forced on, and its draws replaced."""
    priors = eryn_tpu_torch.ProbDistContainer(
        {i: eryn_tpu_torch.uniform_dist(-5.0, 5.0) for i in range(NDIM)}
    )
    move = eryn_tpu_torch.StretchMove(use_kernels=True)
    sampler = eryn_tpu_torch.EnsembleSampler(
        nw, NDIM, lambda x: -0.5 * torch.sum(x * x), priors,
        tempering_kwargs=dict(ntemps=NT, use_kernels=True), moves=[move],
        seed=0, device="cpu",
    )
    t = {k: torch.from_numpy(np.asarray(v)) for k, v in d.items()}
    move.draw_fused = lambda *args: (t["perm"], t["u_all"])
    sampler.temperature_control.draw_kernel = lambda *args: (
        t["pi"], t["shifts"], t["raccept"]
    )
    state = state_from_numpy(
        dict(coords={"model_0": coords}, log_like=logl, log_prior=logp,
             betas=betas),
        device="cpu",
    )
    state, accepted, swaps, time, _ = move.propose_kernel(
        None, state, TIME, sampler.get_eval_context()
    )
    assert time == TIME + 1
    return dict(
        coords=state.branches["model_0"].coords, log_like=state.log_like,
        log_prior=state.log_prior, betas=state.betas, accepted=accepted,
        swaps=swaps,
    )


@pytest.mark.parametrize("nw,seed", [(32, 0), (33, 1), (99, 2)])
def test_fused_step_matches_jax_composition(nw, seed):
    args = _inputs(nw, seed)
    ref = {k: np.asarray(v) for k, v in _jax_step(nw, *args).items()}
    out = {k: v.numpy() for k, v in _port_step(nw, *args).items()}
    # decisions
    np.testing.assert_array_equal(out["accepted"], ref["accepted"])
    np.testing.assert_array_equal(out["swaps"], ref["swaps"])
    assert 0 < ref["accepted"].sum() < ref["accepted"].size
    assert ref["swaps"].sum() > 0
    # states
    for key in ("coords", "log_like", "log_prior", "betas"):
        np.testing.assert_allclose(out[key], ref[key], rtol=1e-6, atol=1e-6,
                                   err_msg=key)
    assert not np.array_equal(out["betas"], args[3])  # the ladder moved


@pytest.mark.parametrize("nw", [32, 33])
def test_general_cascade_matches_jax_swap_kernel(nw):
    """The CPU cascade (per-rung permutations, provenance gather) against
    eryn_tpu's XLA-form ``swap_kernel``, with the permutations and
    acceptance draws reproduced from the JAX key the reference consumes.
    Decisions and the swapped payload are exact; only values move."""
    rng = np.random.default_rng(nw)
    f32 = np.float32
    logl = (rng.standard_normal((NT, nw)) * 3).astype(f32)
    tree = {
        "coords": {"model_0": rng.standard_normal((NT, nw, 1, NDIM)).astype(f32)},
        "inds": {"model_0": np.ones((NT, nw, 1), bool)},
        "log_prior": rng.standard_normal((NT, nw)).astype(f32),
    }
    betas = eryn_tpu.moves.tempering.make_ladder(NDIM, NT).astype(f32)
    key = jax.random.PRNGKey(nw)
    jtc = eryn_tpu.moves.TemperatureControl(NDIM, nw, ntemps=NT)
    j_tree, j_logl, j_acc, _ = jtc.swap_kernel(
        key, jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(logl),
        jnp.asarray(betas),
    )
    # the draws eryn_tpu's swap_kernel makes from this key
    k_perm, k_acc = jax.random.split(key)
    perms = np.array(jnp.argsort(
        jax.random.uniform(k_perm, (NT - 1, 2, nw)), axis=-1))
    raccept = np.array(jnp.log(
        jax.random.uniform(k_acc, (NT - 1, nw), dtype=jnp.float32)))

    ttc = eryn_tpu_torch.TemperatureControl(NDIM, nw, ntemps=NT)
    t_tree, t_logl, t_acc = ttc._swap_cascade_general(
        jax.tree_util.tree_map(torch.from_numpy, tree), torch.from_numpy(logl),
        torch.from_numpy(betas), torch.from_numpy(perms),
        torch.from_numpy(raccept),
    )
    np.testing.assert_array_equal(t_acc.numpy(), np.asarray(j_acc))
    assert 0 < t_acc.sum() < (NT - 1) * nw
    np.testing.assert_array_equal(t_logl.numpy(), np.asarray(j_logl))
    for (path, t), j in zip(
        jax.tree_util.tree_flatten_with_path(t_tree)[0],
        jax.tree_util.tree_leaves(j_tree),
    ):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=str(path))
