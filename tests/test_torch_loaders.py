"""The port's real-data loaders (``pgpfa_torch.data.loaders``) against the JAX
package's (``pgpfa.data.loaders``) on files each test writes itself, with
the schemas of ``tests/test_components.py``. Both are NumPy and SciPy, so
they run live here and must agree exactly: every attribute of the JAX
loader's result, with its value and dtype."""

import os
import subprocess
import sys

import numpy as np
import pytest

import pgpfa.data.loaders as J
import pgpfa_torch.data.loaders as P


def _same(got, want):
    """Every attribute of ``want`` on ``got``, equal (arrays: values and
    dtypes; the trial list: each trial's counts)."""
    assert set(vars(got)) == set(vars(want))
    for k, w in vars(want).items():
        g = getattr(got, k)
        if k == "data":
            assert len(g) == len(w)
            for a, b in zip(g, w):
                assert a["Y"].dtype == b["Y"].dtype
                np.testing.assert_array_equal(a["Y"], b["Y"])
        elif k == "initParams":
            for name in ("tau", "C", "d"):
                np.testing.assert_array_equal(g[name], w[name])
        elif k == "spikeTimes":
            assert g.equals(w)
        elif isinstance(w, np.ndarray):
            assert g.dtype == w.dtype, k
            np.testing.assert_array_equal(g, w)
        else:
            assert g == w and type(g) is type(w), k


@pytest.mark.parametrize("keep_second_half", [True, False])
def test_stevenson_loader(tmp_path, keep_second_half):
    """The Stevenson schema (``spikes`` ydim x ms, ``timeBase``), binned
    into 1400-ms trials of 10-ms bins, with and without the reference's
    second-half rule."""
    import scipy.io as sio

    rng = np.random.default_rng(0)
    spikes = rng.poisson(0.01, size=(20, 4 * 1400))
    path = os.path.join(tmp_path, "stevenson.mat")
    sio.savemat(path, {"spikes": spikes, "timeBase": np.arange(spikes.shape[1])})
    ds = P.StevensonDataset(path, trialDur=1400, binSize=10, keepSecondHalf=keep_second_half)
    _same(ds, J.StevensonDataset(path, trialDur=1400, binSize=10,
                                 keepSecondHalf=keep_second_half))
    assert ds.T == 140 and ds.ydim == 20
    assert ds.numTrials == (2 if keep_second_half else 4)
    lo = 2 * 1400 if keep_second_half else 0
    np.testing.assert_allclose(ds.Y.sum(), spikes[:, lo:].sum())


@pytest.mark.parametrize("with_params", [False, True])
def test_matlab_dataset_loader(tmp_path, with_params):
    """The P-GPFA MATLAB schema (``dataPPGPFA`` struct array with
    ``spkcount`` and ``trialDur``), and its optional ``initParams`` file."""
    import scipy.io as sio

    rng = np.random.default_rng(1)
    rec = np.zeros((1, 3), dtype=[("spkcount", "O"), ("trialDur", "O")])
    for i in range(3):
        rec[0, i]["spkcount"] = rng.poisson(0.5, size=(8, 25))
        rec[0, i]["trialDur"] = np.asarray([[0.5]])
    path = os.path.join(tmp_path, "ppgpfa.mat")
    sio.savemat(path, {"dataPPGPFA": rec})
    ppath = None
    if with_params:
        prm = np.zeros((1, 1), dtype=[("tau", "O"), ("C", "O"), ("d", "O")])
        prm[0, 0]["tau"] = np.array([[0.1, 0.2]])
        prm[0, 0]["C"] = rng.normal(size=(8, 2))
        prm[0, 0]["d"] = rng.normal(size=(8, 1))
        ppath = os.path.join(tmp_path, "init.mat")
        sio.savemat(ppath, {"initParams": prm})
    ds = P.MATLABdataset(path, ppath)
    _same(ds, J.MATLABdataset(path, ppath))
    assert ds.numTrials == 3 and ds.ydim == 8 and ds.T == 25
    assert ds.trialDur == 500 and ds.binSize == 20
    assert hasattr(ds, "initParams") == with_params


def test_crcns_loader(tmp_path):
    """The spike-time table (pandas pickle with ``unit`` and ``time``)."""
    pd = pytest.importorskip("pandas")

    bin_s, total_bins = 0.02, 100
    rng = np.random.default_rng(5)
    rows = []
    for u in range(3):
        for b in range(total_bins):
            rows += [{"unit": u, "time": (b + 0.5) * bin_s}] * rng.poisson(0.8)
        rows += [{"unit": u, "time": 0.0}, {"unit": u, "time": total_bins * bin_s}]
    path = os.path.join(tmp_path, "crcns.pkl")
    pd.DataFrame(rows).to_pickle(path)
    ds = P.load_crcns_data(path, trialDur=1000, binSize=20)
    _same(ds, J.load_crcns_data(path, trialDur=1000, binSize=20))
    assert ds.ydim == 3 and ds.T == 50 and ds.numTrials == 2


def test_gpfa_cv_comparison_loader(tmp_path):
    """The GPFA comparison schema (``dat`` struct array, ``spikes`` rasters
    at 1 ms with one extra column)."""
    import scipy.io as sio

    rng = np.random.default_rng(6)
    R, ydim, dur = 4, 6, 401
    rec = np.zeros((1, R), dtype=[("spikes", "O")])
    for i in range(R):
        rec[0, i]["spikes"] = rng.poisson(0.02, size=(ydim, dur))
    path = os.path.join(tmp_path, "dat.mat")
    sio.savemat(path, {"dat": rec})
    ds = P.loadDataForGPFA_CV_comparison(path, binSize=20)
    _same(ds, J.loadDataForGPFA_CV_comparison(path, binSize=20))
    assert ds.ydim == ydim and ds.trialDur == 400 and ds.T == 20
    assert ds.Y.shape == (R, ydim, 20) and ds.avgFR.shape == (ydim,)


def test_high_data_loader(tmp_path):
    """The ``ex1_spikecounts`` schema (``D`` struct array, ``data``
    rasters)."""
    import scipy.io as sio

    rng = np.random.default_rng(7)
    R, ydim, dur = 3, 5, 200
    rec = np.zeros((1, R), dtype=[("data", "O")])
    for i in range(R):
        rec[0, i]["data"] = rng.poisson(0.05, size=(ydim, dur))
    path = os.path.join(tmp_path, "ex1_spikecounts.mat")
    sio.savemat(path, {"D": rec})
    ds = P.loadDataHighData(path, binSize=10)
    _same(ds, J.loadDataHighData(path, binSize=10))
    assert ds.ydim == ydim and ds.T == 20 and ds.numTrials == R
    assert ds.raster.shape == (ydim, 20 * R)


def test_loaders_reexported_without_pandas():
    """The compat modules re-export the port's loaders, and importing them
    pulls in neither pandas, nor JAX, nor the JAX package."""
    from pgpfa_torch.compat import datamanager, util

    assert datamanager.StevensonDataset is P.StevensonDataset
    assert datamanager.MATLABdataset is util.MATLABdataset is P.MATLABdataset
    assert util.load_crcns_data is P.load_crcns_data
    assert util.loadDataForGPFA_CV_comparison is P.loadDataForGPFA_CV_comparison
    assert util.loadDataHighData is P.loadDataHighData
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("import sys, pgpfa_torch.data.loaders, pgpfa_torch.compat.datamanager; "
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'pgpfa', 'pandas')))")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=repo,
                       timeout=120, check=True)
    assert r.stdout.strip() == "[]", r.stdout
