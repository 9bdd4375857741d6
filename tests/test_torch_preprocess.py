"""The port's raw-data preprocessing and synthetic series against the JAX
package's, on the CPU.

- SMD: raw CSVs written here (two machines; decimals at and just off the
  halfway points between neighbouring float32 values, a CRLF line, a blank
  line, an unparseable field, a one-column label file). The port's pickles
  equal the JAX package's output of its C++ ``strtof`` reader
  (``native/host_ops.cpp:102``) array for array, dtype included: the
  ``jax_native`` fixture makes sure that this process has loaded that
  library, and a spy asserts that the C++ path and not the
  ``np.genfromtxt`` fallback answered. Its fallback rounds through float64,
  so the test also shows that it differs at the off-halfway decimals and
  that the port agrees with a once-rounded exact value.
- MSL/SMAP: ``labeled_anomalies.csv`` and per-channel .npy files written
  here; every pickle equal (``np.array_equal``, dtype too).
- ``synthetic_series`` and ``write_smd_like`` equal bit for bit.
"""

import fcntl
import os
import pickle
import shutil
import tempfile
import time
from decimal import Decimal, localcontext
from fractions import Fraction
from unittest import mock

import numpy as np
import pytest

from mtad_gat_tpu.data import preprocess as jax_pre
from mtad_gat_tpu.data import synthetic as jax_syn
from mtad_gat_tpu_torch.cli import preprocess_cli
from mtad_gat_tpu_torch.data import preprocess as port_pre
from mtad_gat_tpu_torch.data import synthetic as port_syn


def _settled(path, pause=0.2, limit=30.0):
    end = time.monotonic() + limit
    while os.path.exists(path) and time.monotonic() < end:
        before = os.stat(path)
        time.sleep(pause)
        after = os.stat(path) if os.path.exists(path) else None
        if after and (before.st_size, before.st_mtime_ns) == (after.st_size, after.st_mtime_ns):
            return


@pytest.fixture(scope="module")
def jax_native():
    """The JAX package's C++ host library, loaded in this process (it is
    built at first use; see ``test_torch_predict.py``'s fixture of the same
    name, whose lock this one shares)."""
    from mtad_gat_tpu.native import host_ops

    if os.environ.get("MTAD_GAT_NO_NATIVE"):
        pytest.fail("MTAD_GAT_NO_NATIVE is set: the C++ path cannot be compared")
    if not os.path.exists(host_ops._LIB_PATH) and shutil.which("g++") is None:
        pytest.fail("no g++ to build the JAX package's host library")
    deadline = time.monotonic() + 240.0
    lock_path = os.path.join(tempfile.gettempdir(), "mtad_gat_tpu_libmtadhost.lock")
    with open(lock_path, "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        _settled(host_ops._LIB_PATH)
        while not host_ops.native_available():
            if time.monotonic() > deadline:
                pytest.fail("the JAX package's host library did not load in 240 s")
            time.sleep(0.5)
            _settled(host_ops._LIB_PATH)
            with host_ops._lock:
                host_ops._tried = False
    return host_ops


def _near_halfway(rng, n):
    """Decimal strings at, just above and just below the halfway points
    between neighbouring float32 values, and their once-rounded float32."""
    a = (rng.standard_normal(n) * 10.0 ** rng.integers(-6, 6, n)).astype(np.float32)
    b = np.nextafter(a, np.float32(np.inf))
    mids = (a.astype(np.float64) + b.astype(np.float64)) / 2
    texts, want = [], []
    for lo, hi, m in zip(a, b, mids):
        exact = Decimal(float(m))
        with localcontext() as ctx:
            ctx.prec = 200              # exact sums of these decimals
            tiny = Decimal(float(abs(np.spacing(m)))) / Decimal(10**6)
            above, below = exact + tiny, exact - tiny
        for text, side in ((str(exact), 0), (str(above), 1), (str(below), -1)):
            texts.append(text)
            if side == 0:      # a tie: to even
                want.append(lo if int(lo.view(np.uint32)) % 2 == 0 else hi)
            else:
                want.append(hi if side > 0 else lo)
            # float64 lands on the halfway point; the decimal lies on its side
            assert float(text) == m
            assert (Fraction(text) > Fraction(float(m))) - (Fraction(text) < Fraction(float(m))) == side
    return texts, np.asarray(want, np.float32)


def _write_raw_smd(root, rng):
    """Two machines' train/test/test_label CSVs; returns machine-1-1's
    train decimals and their once-rounded float32 values."""
    texts, want = _near_halfway(rng, 24)         # 72 decimals = 8 rows x 9 cols
    for name in ("machine-1-1", "machine-2-3"):
        for cat in ("train", "test", "test_label"):
            os.makedirs(root / "ServerMachineDataset" / cat, exist_ok=True)
            if cat == "test_label":
                lines = [str(int(x)) for x in rng.integers(0, 2, 8)]
            elif name == "machine-1-1" and cat == "train":
                lines = [",".join(texts[r * 9:(r + 1) * 9]) for r in range(8)]
                lines[3] += "\r"                         # a CRLF line
                lines.insert(5, "")                      # a blank line
            else:
                vals = rng.standard_normal((6, 9)) * 100
                lines = [",".join(f"{v:.7f}" for v in row) for row in vals]
                if cat == "test":
                    lines[2] = lines[2].replace(lines[2].split(",")[4], "n/a", 1)
            (root / "ServerMachineDataset" / cat / f"{name}.txt").write_text("\n".join(lines) + "\n")
    return texts, want


def _pickles(folder):
    out = {}
    for name in sorted(os.listdir(folder)):
        with open(os.path.join(folder, name), "rb") as f:
            out[name] = pickle.load(f)
    return out


def _assert_same_pickles(got, want):
    assert got.keys() == want.keys()
    for name in want:
        assert got[name].dtype == want[name].dtype, name
        assert got[name].shape == want[name].shape, name
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


def test_smd_pickles_equal_the_jax_native_reader(jax_native, tmp_path):
    rng = np.random.default_rng(0)
    texts, want = _write_raw_smd(tmp_path / "port", rng)
    shutil.copytree(tmp_path / "port", tmp_path / "jax")

    answered = []
    real_load = jax_native._load

    def spy():
        lib = real_load()
        answered.append(lib is not None)
        return lib

    # the C++ reader answers every file: its loader returns the library and
    # the numpy fallback is never called
    with mock.patch.object(jax_native, "_load", spy), \
            mock.patch.object(jax_native.np, "genfromtxt", side_effect=AssertionError):
        jax_pre.preprocess("SMD", data_root=str(tmp_path / "jax"))
    assert len(answered) == 6 and all(answered), "the JAX package's C++ reader did not answer"
    preprocess_cli.main(["--dataset", "SMD", "--data_root", str(tmp_path / "port")])

    proc = "ServerMachineDataset/processed"
    got, ref = _pickles(tmp_path / "port" / proc), _pickles(tmp_path / "jax" / proc)
    assert len(got) == 6
    _assert_same_pickles(got, ref)
    train = got["machine-1-1_train.pkl"]
    np.testing.assert_array_equal(train.reshape(-1), want)      # rounded once
    assert got["machine-1-1_test_label.pkl"].ndim == 1
    assert np.isnan(got["machine-2-3_test.pkl"][2, 4])
    # the JAX package's numpy fallback rounds twice and misses some of them
    fallback = np.genfromtxt(tmp_path / "port" / "ServerMachineDataset" / "train" /
                             "machine-1-1.txt", dtype=np.float32, delimiter=",")
    assert (fallback.reshape(-1) != want).any()


def test_csv_reader_is_once_rounded_on_random_decimals(tmp_path):
    rng = np.random.default_rng(1)
    texts, want = _near_halfway(rng, 200)
    (tmp_path / "x.csv").write_text("\n".join(",".join(texts[i:i + 6])
                                              for i in range(0, len(texts), 6)) + "\n")
    got = port_pre.csv_load_f32(str(tmp_path / "x.csv"))
    np.testing.assert_array_equal(got.reshape(-1), want)


def test_nasa_pickles_equal_jax(tmp_path):
    rng = np.random.default_rng(2)
    rows = [("P-1", "SMAP", "[[3, 5]]", "10"), ("P-2", "SMAP", "[[0, 1]]", "8"),
            ("M-1", "MSL", "[[1, 2], [6, 7]]", "9"), ("A-1", "SMAP", "[[0, 0], [8, 9]]", "12"),
            ("C-1", "MSL", "[[4, 4]]", "7")]
    for side in ("port", "jax"):
        data = tmp_path / side / "data"
        for cat in ("train", "test"):
            os.makedirs(data / cat)
        lines = ["chan_id,spacecraft,anomaly_sequences,class,num_values"]
        lines += [f'{c},{s},"{a}",[point],{n}' for c, s, a, n in rows]
        (data / "labeled_anomalies.csv").write_text("\n".join(lines) + "\n")
    for chan, _, _, n in rows:
        for cat in ("train", "test"):
            arr = rng.standard_normal((int(n), 4))
            for side in ("port", "jax"):
                np.save(tmp_path / side / "data" / cat / f"{chan}.npy", arr)
    for ds in ("SMAP", "MSL"):
        jax_pre.preprocess(ds, data_root=str(tmp_path / "jax"))
        preprocess_cli.main(["--dataset", ds.lower(), "--data_root", str(tmp_path / "port")])
    proc = "data/processed"
    got = _pickles(tmp_path / "port" / proc)
    assert len(got) == 6 and got["SMAP_test_label.pkl"].dtype == np.bool_
    _assert_same_pickles(got, _pickles(tmp_path / "jax" / proc))


@pytest.mark.parametrize("args", [(300, 120, 5, 3, 0), (80, 200, 38, 4, 7), (50, 40, 1, 1, 2)])
def test_synthetic_series_equal_jax(args):
    for got, want in zip(port_syn.synthetic_series(*args), jax_syn.synthetic_series(*args)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_write_smd_like_equals_jax(tmp_path):
    kw = dict(group="2-4", n_train=90, n_test=70, n_features=6, anomaly_segments=2, seed=5)
    port_syn.write_smd_like(str(tmp_path / "port"), **kw)
    jax_syn.write_smd_like(str(tmp_path / "jax"), **kw)
    proc = "ServerMachineDataset/processed"
    got = _pickles(tmp_path / "port" / proc)
    assert len(got) == 3
    _assert_same_pickles(got, _pickles(tmp_path / "jax" / proc))
