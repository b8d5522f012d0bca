"""The torch package's native mmap gather (paddle_operator_tpu_torch/
train/data.py ``NativeTokenFile``, ``mmap_token_batches(native=...)``)
held against its own python gather and the JAX package's
``native=False`` batches for the same seed: equal arrays.  The cases of
tests/test_data_utils.py's ``TestNativeDataIO`` run on the port, which
builds its own library from ``native/dataio.cpp`` with ``g++`` into
``build/native_torch/`` (never into ``native/build/``, where the JAX
package looks for its library).
"""

import itertools
import os

import numpy as np
import pytest

from paddle_operator_tpu.train import data as JD
from paddle_operator_tpu_torch.train import data as TD


@pytest.fixture(scope="module")
def lib():
    path = TD.build_native_lib()
    assert os.path.exists(path)
    assert os.path.dirname(path) == str(TD.NATIVE_DIR)
    assert "native/build" not in path
    return path


@pytest.mark.parametrize("dtype,top", [(np.uint16, 60000),
                                       (np.uint32, 2 ** 31 - 1)])
def test_native_equals_python_and_jax(lib, tmp_path, dtype, top):
    path = str(tmp_path / "tok.bin")
    np.random.default_rng(0).integers(0, top, 50000).astype(dtype).tofile(path)
    a = TD.mmap_token_batches(path, 16, 64, dtype=dtype, seed=9, native=True)
    b = TD.mmap_token_batches(path, 16, 64, dtype=dtype, seed=9,
                              native=False)
    c = JD.mmap_token_batches(path, 16, 64, dtype=dtype, seed=9,
                              native=False)
    for x, y, z in itertools.islice(zip(a, b, c), 3):
        assert x["tokens"].dtype == y["tokens"].dtype == np.int32
        np.testing.assert_array_equal(x["tokens"], y["tokens"])
        np.testing.assert_array_equal(x["tokens"], z["tokens"])


def test_default_takes_native_once_built(lib, tmp_path, monkeypatch):
    path = str(tmp_path / "tok.bin")
    np.arange(3000, dtype=np.uint16).tofile(path)
    made = []
    real = TD.NativeTokenFile
    monkeypatch.setattr(TD, "NativeTokenFile",
                        lambda *a, **k: made.append(1) or real(*a, **k))
    next(TD.mmap_token_batches(path, 2, 8))
    assert made == [1]
    monkeypatch.setattr(TD, "_find_native_lib", lambda: None)
    next(TD.mmap_token_batches(path, 2, 8))          # python gather
    next(TD.mmap_token_batches(path, 2, 8, native=False))
    assert made == [1]


def test_native_uint32_widening(lib, tmp_path):
    """tests/test_data_utils.py:95 on the port."""
    path = tmp_path / "tok32.bin"
    np.arange(5000, dtype=np.uint32).tofile(path)
    batch = next(TD.mmap_token_batches(str(path), 4, 16, dtype=np.uint32,
                                       native=True))
    assert batch["tokens"].dtype == np.int32
    assert (np.diff(batch["tokens"][0]) == 1).all()


def test_native_bounds_check(lib, tmp_path):
    """tests/test_data_utils.py:103 on the port."""
    path = tmp_path / "small.bin"
    np.arange(100, dtype=np.uint16).tofile(path)
    f = TD.NativeTokenFile(str(path))
    assert len(f) == 100
    with pytest.raises(IndexError):
        f.gather(np.array([95]), 10)
    with pytest.raises(IndexError):
        f.gather(np.array([-1]), 5)
    np.testing.assert_array_equal(f.gather(np.array([90]), 10)[0],
                                  np.arange(90, 100))
    f.close()


def test_refusals(lib, tmp_path):
    with pytest.raises(ValueError, match="unsupported token dtype"):
        TD.NativeTokenFile(str(tmp_path / "x.bin"), dtype=np.uint8)
    with pytest.raises(FileNotFoundError):
        next(TD.mmap_token_batches(str(tmp_path / "missing.bin"), 2, 8,
                                   native=True))
