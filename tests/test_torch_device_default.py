"""The port runs on the card unless the caller asks for the CPU:
``EnsembleSampler`` and ``state_from_numpy`` without ``device=`` build on
CUDA, and where there is none they raise with a message that names
``device="cpu"``; there is no silent CPU fallback."""

import numpy as np
import pytest
import torch

import eryn_tpu_torch
from eryn_tpu_torch.interop import state_from_numpy
from eryn_tpu_torch.state import resolve_device

NT, NW, NDIM = 2, 8, 2


def _sampler(**kw):
    priors = eryn_tpu_torch.ProbDistContainer(
        {i: eryn_tpu_torch.uniform_dist(-5.0, 5.0) for i in range(NDIM)}
    )
    return eryn_tpu_torch.EnsembleSampler(
        NW, NDIM, lambda x: -0.5 * torch.sum(x * x), priors,
        tempering_kwargs=dict(ntemps=NT), seed=0, **kw
    )


def _numpy_state():
    coords = np.random.default_rng(0).uniform(-1, 1, (NT, NW, 1, NDIM))
    return {"coords": {"model_0": coords}}


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        assert _sampler().device.type == "cuda"
        state = state_from_numpy(_numpy_state())
        assert state.branches["model_0"].coords.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match='device="cpu"'):
        _sampler()
    with pytest.raises(RuntimeError, match='device="cpu"'):
        state_from_numpy(_numpy_state())


def test_default_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='pass device="cpu"'):
        resolve_device(None)
    with pytest.raises(RuntimeError, match='pass device="cpu"'):
        _sampler()
    with pytest.raises(RuntimeError, match='pass device="cpu"'):
        state_from_numpy(_numpy_state())


def test_default_with_cuda_names_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device(None) == torch.device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_device_cpu_runs_and_moves_the_initial_state():
    sampler = _sampler(device="cpu", dtype=torch.float64)
    assert sampler.device == torch.device("cpu")
    assert type(sampler.backend) is eryn_tpu_torch.Backend
    # a float32 state is moved to the sampler's device and dtype
    state = state_from_numpy(_numpy_state(), device="cpu")
    out = sampler.run_mcmc(state, 5)
    assert out.branches["model_0"].coords.dtype == torch.float64
    assert sampler.get_chain()["model_0"].shape == (5, NT, NW, 1, NDIM)
