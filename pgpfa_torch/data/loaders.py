"""Real-data loaders (the port's own copy of ``pgpfa/data/loaders.py``;
NumPy and SciPy only, ``pandas`` imported inside :class:`load_crcns_data`
alone).

Covers every loader in the reference:

* :class:`StevensonDataset` — CRCNS Stevenson-2011 motor-cortex ``.mat``
  (reference ``funs/datamanager.py:8-54``). The recording is not part of
  this repository: the default paths name the user's own files, and the
  tests write files of the same schema.
* :class:`load_crcns_data` — pandas pickle of spike times
  (reference ``funs/util.py:74-110``).
* :class:`loadDataForGPFA_CV_comparison` — ``data/dat.mat``
  (reference ``funs/util.py:130-153``).
* :class:`loadDataHighData` — ``data/ex1_spikecounts.mat``
  (reference ``funs/util.py:155-178``).
* :class:`MATLABdataset` — P-GPFA-format ``.mat`` + optional init params
  (reference ``funs/util.py:888-919``).

All loaders produce the common experiment surface: ``.data`` (list of
``{'Y': (ydim, T)}``), ``.Y`` (stacked ``(R, ydim, T)``), ``.ydim``,
``.trialDur``, ``.binSize``, ``.T``, ``.numTrials``. They are NumPy
arrays on the host; the fits put them on a device.
"""

from __future__ import annotations

import numpy as np


def _finalize(obj, data_list):
    obj.data = data_list
    obj.Y = np.stack([tr["Y"] for tr in data_list], axis=0)
    obj.numTrials = len(data_list)
    return obj


def _bin_columns(raster: np.ndarray, width: int) -> np.ndarray:
    """Sum adjacent column groups of width ``width`` (vectorized binning)."""
    ydim, n = raster.shape
    T = n // width
    return raster[:, : T * width].reshape(ydim, T, width).sum(axis=2)


class StevensonDataset:
    """Stevenson 2011 motor-cortex recording, binned into equal trials.

    Schema (reference ``funs/datamanager.py:11-36``): the ``.mat`` holds
    ``spikes`` (ydim x total-ms binary), ``timeBase``; trials are fixed
    ``trialDur``-ms windows; following the reference, only the second half of
    the trials is kept (the first half is stimulus-free).
    """

    def __init__(self, filepath="data/Stevenson_2011_e1.mat", trialDur=1400, binSize=10,
                 keepSecondHalf=True):
        import scipy.io as sio

        m = sio.loadmat(filepath)
        spikes = np.asarray(m["spikes"])
        ydim, total_ms = spikes.shape
        T = int(trialDur // binSize)
        num_trials = int(total_ms // trialDur)

        data = []
        for r in range(num_trials):
            window = spikes[:, r * trialDur : (r + 1) * trialDur]
            data.append({"Y": _bin_columns(window, binSize).astype(float)})
        if keepSecondHalf:
            data = data[len(data) // 2 :]

        self.ydim = ydim
        self.trialDur = trialDur
        self.binSize = binSize
        self.T = T
        _finalize(self, data)


class load_crcns_data:
    """Spike-time table (pandas pickle with ``unit``/``time`` columns) chopped
    into fixed-duration pseudo-trials (reference ``funs/util.py:74-110``)."""

    def __init__(self, filepath, trialDur=1000, binSize=20, numTrials=None):
        import pandas as pd

        T = int(trialDur // binSize)
        table = pd.read_pickle(filepath)
        units = np.unique(table.unit.values)
        ydim = len(units)
        total_bins = int(np.floor(table.time.values.max() / (binSize / 1000.0)))
        if numTrials is None:
            numTrials = total_bins // T

        counts = np.zeros((ydim, total_bins))
        for i, u in enumerate(units):
            times = table.time[table.unit == u].values
            counts[i], _ = np.histogram(times, bins=total_bins)

        data = [
            {"Y": counts[:, r * T : (r + 1) * T].astype(float)} for r in range(numTrials)
        ]
        self.spikeTimes = table
        self.ydim = ydim
        self.trialDur = trialDur
        self.binSize = binSize
        self.T = T
        _finalize(self, data)


class loadDataForGPFA_CV_comparison:
    """GPFA comparison set ``data/dat.mat`` (reference ``funs/util.py:130-153``)."""

    def __init__(self, filepath="data/dat.mat", binSize=20):
        import scipy.io as sio

        m = sio.loadmat(filepath)
        trials = m["dat"]["spikes"][0]
        ydim, trialDur = trials[0][:, :-1].shape
        T = int(trialDur // binSize)
        data = [
            {"Y": _bin_columns(np.asarray(tr, dtype=float), binSize)[:, :T]}
            for tr in trials
        ]
        self.ydim = ydim
        self.trialDur = trialDur
        self.binSize = binSize
        self.T = T
        _finalize(self, data)
        self.raster = np.concatenate([tr["Y"] for tr in data], axis=1)
        self.avgFR = self.raster.sum(axis=1) / self.numTrials / self.trialDur * 1000.0


class loadDataHighData:
    """``data/ex1_spikecounts.mat`` (reference ``funs/util.py:155-178``)."""

    def __init__(self, filepath="data/ex1_spikecounts.mat", binSize=10):
        import scipy.io as sio

        m = sio.loadmat(filepath)
        trials = m["D"]["data"][0]
        ydim, trialDur = trials[0].shape
        T = int(trialDur // binSize)
        data = [
            {"Y": _bin_columns(np.asarray(tr, dtype=float), binSize)} for tr in trials
        ]
        self.ydim = ydim
        self.trialDur = trialDur
        self.binSize = binSize
        self.T = T
        _finalize(self, data)
        self.raster = np.concatenate([tr["Y"] for tr in data], axis=1)
        self.avgFR = self.raster.sum(axis=1) / self.numTrials / self.trialDur * 1000.0


class MATLABdataset:
    """P-GPFA-format ``.mat`` with precomputed spike counts and optional init
    params (reference ``funs/util.py:888-919``)."""

    def __init__(self, datfilename, paramfilename=None):
        import scipy.io as sio

        m = sio.loadmat(datfilename)
        trials = m["dataPPGPFA"]
        ydim, T = np.shape(trials[0, 0]["spkcount"])
        trialDur = int(np.ravel(trials[0, 0]["trialDur"])[0] * 1000)
        data = [
            {"Y": np.asarray(trials[0, i]["spkcount"], dtype=float)}
            for i in range(trials.shape[1])
        ]
        self.ydim = ydim
        self.T = T
        self.trialDur = trialDur
        self.binSize = int(trialDur // T)
        _finalize(self, data)

        if paramfilename is not None:
            p = sio.loadmat(paramfilename)["initParams"]
            self.initParams = {
                "tau": np.ravel(p["tau"][0][0]),
                "C": np.asarray(p["C"][0][0]),
                "d": np.ravel(p["d"][0][0]),
            }
