"""The port's NumPy data path against ``pgpfa``'s ``backend="numpy"`` path,
the parameter conversions, and import hygiene."""

import inspect
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import pgpfa
from pgpfa.data.init import initialize_params as jax_init
from pgpfa.data.surrogate import stevenson_surrogate as jax_stevenson
from pgpfa.models.params import rbf_kernel as jax_rbf
import pgpfa_torch
from pgpfa_torch.convert import params_from_numpy, params_to_numpy, to_numpy, to_tensor
from pgpfa_torch.data.synthetic import rbf_kernel_numpy
import torch_helpers  # noqa: F401  (sets the torch thread count)

REPO = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("kw", [
    dict(xdim=2, ydim=15, numTrials=4, trialDur=400, binSize=10, seed=3),
    dict(xdim=3, ydim=20, numTrials=5, trialDur=500, binSize=20, seed=7, dOffset=-0.5,
         fixTau=True, fixedTau=[0.05, 0.1, 0.3]),
])
def test_dataset_matches_numpy_backend(kw):
    """Same generator calls in the same order: Y and the parameters are
    identical; X agrees to 1e-12 (its kernel's exp is NumPy's, not XLA's)."""
    a = pgpfa.dataset(backend="numpy", **kw)
    b = pgpfa_torch.dataset(**kw)
    np.testing.assert_array_equal(b.Y, a.Y)
    for k in ("C", "d", "tau"):
        np.testing.assert_array_equal(b.params[k], a.params[k])
    np.testing.assert_allclose(b.X, a.X, rtol=0, atol=1e-12)
    assert (b.T, b.numTrials, b.binSize) == (a.T, a.numTrials, a.binSize)
    assert len(b.data) == len(a.data)


def test_stevenson_surrogate_matches():
    """The full-width workload's data at 3 trials: identical counts."""
    a = jax_stevenson(xdim=5, seed=2011, numTrials=3)
    b = pgpfa_torch.stevenson_surrogate(xdim=5, seed=2011, numTrials=3)
    assert b.Y.shape == (3, 90, 140)
    np.testing.assert_array_equal(b.Y, a.Y)


@pytest.mark.parametrize("with_data", [True, False])
def test_initialize_params_matches(with_data):
    """Poisson-PCA init (or the random init) to 1e-12: the same NumPy calls."""
    ds = pgpfa_torch.dataset(xdim=3, ydim=20, numTrials=5, trialDur=500, binSize=10, seed=5)
    exp = ds if with_data else None
    a = jax_init(3, 20, exp, seed=4)
    b = pgpfa_torch.initialize_params(3, 20, exp, seed=4)
    for k in ("C", "d", "tau"):
        np.testing.assert_allclose(b[k], a[k], rtol=1e-12, atol=1e-12)


def test_rbf_kernel_numpy_matches_jax():
    """The NumPy kernel used for sampling vs the JAX one: 1e-14 (exp ULPs)."""
    tau = np.array([0.05, 0.2, 0.45])
    np.testing.assert_allclose(rbf_kernel_numpy(tau, 30, 10.0),
                               np.asarray(jax_rbf(tau, 30, 10.0)), rtol=0, atol=1e-14)


def test_params_round_trip():
    p = {"C": np.arange(6.0).reshape(3, 2), "d": np.ones((3, 1)), "tau": np.array([[0.1, 0.2]])}
    tp = params_from_numpy(p, "cpu", torch.float64)
    assert tp.C.dtype == torch.float64 and tp.d.shape == (3,) and tp.tau.shape == (2,)
    assert (tp.ydim, tp.xdim) == (3, 2)
    back = params_to_numpy(tp)
    np.testing.assert_array_equal(back["C"], p["C"])
    np.testing.assert_array_equal(back["tau"], p["tau"].ravel())
    x = np.random.default_rng(0).normal(size=(2, 2, 5))
    np.testing.assert_array_equal(to_numpy(to_tensor(x, "cpu")), x)


@pytest.mark.parametrize("fn", [pgpfa_torch.fit, params_from_numpy, to_tensor])
def test_entry_points_default_to_the_card(fn):
    assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_no_device_means_the_card():
    """Without a device argument the arrays go to the card; on a machine
    without one that raises instead of running on the CPU."""
    p = {"C": np.ones((3, 2)), "d": np.zeros(3), "tau": np.array([0.1, 0.2])}
    if torch.cuda.is_available():
        assert to_tensor(p["C"]).device.type == "cuda"
        assert params_from_numpy(p).C.device.type == "cuda"
        return
    with pytest.raises((RuntimeError, AssertionError)):
        to_tensor(p["C"])
    with pytest.raises((RuntimeError, AssertionError)):
        params_from_numpy(p)


def test_port_imports_no_jax():
    """``import pgpfa_torch`` (the whole public surface) pulls in no JAX."""
    code = (
        "import sys, pgpfa_torch\n"
        "import pgpfa_torch.ops.blockmat, pgpfa_torch.ops.cuda_kernels, pgpfa_torch.ops._build\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'pgpfa.')) or m == 'pgpfa')\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)
