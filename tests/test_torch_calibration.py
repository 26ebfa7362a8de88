"""PyTorch port: the eGeMAPS calibration table and the feature names.

No calibration table is recorded in the repository, so a synthetic one
(seeded scales and offsets for a subset of the 88 names) is written to a
temporary directory. ``load_calibration`` must read the same ``(88, 2)``
array as the JAX package, identity rows for the names it lacks, and read a
rewritten file again (its cache key is the path and mtime);
``apply_calibration`` on 88-D and 264-D inputs is held against JAX's at
rtol 1e-6 (one float32 multiply-add either way).
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from koemorph_tpu.ops import egemaps as jeg
from koemorph_tpu_torch.ops import egemaps as eg


def _table(path, seed: int, n: int = 30) -> dict:
    rng = np.random.default_rng(seed)
    names = rng.choice(jeg.FEATURE_NAMES, n, replace=False)
    table = {str(k): [float(rng.uniform(0.5, 2.0)),
                      float(rng.normal(0.0, 3.0))] for k in names}
    table["notAFeature"] = [9.0, 9.0]
    path.write_text(json.dumps(table))
    return table


def test_feature_names_equal_jax():
    assert eg.feature_names() == eg.FEATURE_NAMES == jeg.FEATURE_NAMES
    assert len(eg.FEATURE_NAMES) == eg.NUM_FEATURES == 88


def test_load_matches_jax_with_identity_rows(tmp_path):
    path = tmp_path / "calib.json"
    table = _table(path, seed=1)
    got = eg.load_calibration(str(path))
    want = jeg.load_calibration(str(path))
    assert got.dtype == np.float32 and got.shape == (88, 2)
    np.testing.assert_array_equal(got, want)
    listed = np.asarray([n in table for n in eg.FEATURE_NAMES])
    np.testing.assert_array_equal(got[~listed],
                                  np.tile([1.0, 0.0], ((~listed).sum(), 1)))
    assert listed.sum() == 30
    # cached: the same array object until the file changes
    assert eg.load_calibration(str(path)) is got


def test_rewritten_file_is_read_again(tmp_path):
    path = tmp_path / "calib.json"
    _table(path, seed=2)
    first = eg.load_calibration(str(path))
    _table(path, seed=3)
    st = os.stat(path)
    os.utime(path, ns=(st.st_atime_ns, st.st_mtime_ns + 10**9))
    second = eg.load_calibration(str(path))
    assert not np.array_equal(first, second)
    np.testing.assert_array_equal(second, jeg.load_calibration(str(path)))


@pytest.mark.parametrize("width", [88, 264])
def test_apply_matches_jax(tmp_path, width):
    path = tmp_path / "calib.json"
    _table(path, seed=4)
    calib = eg.load_calibration(str(path))
    x = np.random.default_rng(5).normal(0, 10, (3, width)).astype(
        np.float32)
    got = eg.apply_calibration(torch.from_numpy(x), calib).numpy()
    want = np.asarray(jeg.apply_calibration(jnp.asarray(x), calib))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    tiled = np.tile(calib, (width // 88, 1))
    np.testing.assert_allclose(got, x * tiled[:, 0] + tiled[:, 1],
                               rtol=1e-6, atol=1e-6)


def test_missing_file_is_the_identity(tmp_path):
    assert eg.load_calibration(str(tmp_path / "absent.json")) is None
    # the default table beside the module is not recorded
    assert eg.load_calibration() is None
    x = torch.randn(2, 264)
    assert eg.apply_calibration(x) is x


def test_bad_width_raises(tmp_path):
    path = tmp_path / "calib.json"
    _table(path, seed=6)
    calib = eg.load_calibration(str(path))
    with pytest.raises(ValueError, match="multiple of 88"):
        eg.apply_calibration(torch.zeros(2, 100), calib)
