"""The port's snapshot format (utils/checkpoint.py) vs the JAX package's.

Round trip (tensors and numpy arrays), the atomic write (a crash between
the write and the rename keeps the old snapshot and leaks no temp file),
a truncated file (ValueError), a missing one (FileNotFoundError), a bit
flip (checksum ValueError), a newer schema (refused), a legacy file with
no checksum (loads), the world-size mismatch warning, and snapshots
crossing between the packages both ways with equal keys and arrays.
CPU only.
"""

import os
import warnings

import numpy as np
import pytest
import torch

from megba_tpu.utils import checkpoint as jck

from megba_tpu_torch.utils import checkpoint as tck

# One intra-op thread: the suite runs several test processes a core,
# and the port's small operations lose more to thread hand-offs
# than they gain.
torch.set_num_threads(1)


def _state(seed=0):
    rng = np.random.default_rng(seed)
    return dict(
        cameras=rng.standard_normal((5, 9)),
        points=rng.standard_normal((11, 3)).astype(np.float32),
        region=1.5e3, cost=42.25, iteration=4, world_size=1,
        process_index=0,
        extra={"v": np.asarray(2.0), "accepted": np.asarray(3),
               "stopped": np.asarray(False),
               "trace_cost": rng.standard_normal(4),
               "trace_pcg_iters": np.arange(4, dtype=np.int32),
               "topology": np.arange(5, dtype=np.int64)})


def _save(mod, path, st):
    st = dict(st)
    mod.save_state(path, st.pop("cameras"), st.pop("points"), **st)


def _assert_same(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k])


def test_round_trip_tensors_and_arrays(tmp_path):
    st = _state()
    path = str(tmp_path / "s.npz")
    _save(tck, path, dict(st, cameras=torch.from_numpy(st["cameras"])))
    got = tck.load_state(path)
    np.testing.assert_array_equal(got["cameras"], st["cameras"])
    np.testing.assert_array_equal(got["points"], st["points"])
    assert float(got["region"]) == 1.5e3 and int(got["iteration"]) == 4
    assert int(got["world_size"]) == 1 and int(got["process_index"]) == 0
    np.testing.assert_array_equal(got["extra_trace_pcg_iters"],
                                  np.arange(4, dtype=np.int32))
    assert "__checksum__" not in got and "__schema__" not in got
    # A tensor and its numpy array write the same snapshot.
    path2 = str(tmp_path / "s2.npz")
    _save(tck, path2, st)
    _assert_same(got, tck.load_state(path2))


def test_crash_between_write_and_rename_keeps_old_snapshot(
        tmp_path, monkeypatch):
    path = str(tmp_path / "snap.npz")
    tck.save_state(path, np.ones((2, 2)), np.zeros((3,)), region=1.5,
                   iteration=4)
    before = tck.load_state(path)

    def exploding_replace(src, dst):
        raise OSError("simulated crash between write and rename")

    monkeypatch.setattr(os, "replace", exploding_replace)
    with pytest.raises(OSError, match="simulated crash"):
        tck.save_state(path, np.full((2, 2), 9.0), np.ones((3,)),
                       region=9.9, iteration=5)
    monkeypatch.undo()
    _assert_same(before, tck.load_state(path))
    assert os.listdir(tmp_path) == ["snap.npz"]


@pytest.mark.parametrize("damage", ["truncated", "bit_flip", "missing"])
def test_damaged_snapshot_refused(tmp_path, damage):
    path = str(tmp_path / "snap.npz")
    _save(tck, path, _state())
    if damage == "missing":
        os.unlink(path)
        with pytest.raises(FileNotFoundError):
            tck.load_state(path)
        return
    if damage == "truncated":
        with open(path, "r+b") as f:
            f.truncate(os.path.getsize(path) // 2)
        match = "corrupt or truncated"
    else:
        # Flip one bit of the stored cameras and rewrite the npz as it
        # is (checksum kept): the digest must catch it.
        with np.load(path) as z:
            raw = {k: z[k] for k in z.files}
        raw["cameras"] = raw["cameras"].copy()
        raw["cameras"].view(np.uint8)[3] ^= 1
        np.savez(path, **raw)
        match = "checksum"
    with pytest.raises(ValueError, match=match):
        tck.load_state(path)


def test_newer_schema_refused_and_legacy_loads(tmp_path):
    path = str(tmp_path / "snap.npz")
    _save(tck, path, _state())
    with np.load(path) as z:
        raw = {k: z[k] for k in z.files}
    raw["__schema__"] = np.asarray(tck.SCHEMA_VERSION + 1)
    np.savez(path, **raw)
    with pytest.raises(ValueError, match="newer schema"):
        tck.load_state(path)
    # A legacy snapshot: no schema, no checksum.
    legacy = {k: v for k, v in raw.items()
              if k not in ("__schema__", "__checksum__")}
    np.savez(path, **legacy)
    got = tck.load_state(path)
    np.testing.assert_array_equal(got["cameras"], legacy["cameras"])


def test_world_size_mismatch_warns(tmp_path):
    path = str(tmp_path / "snap.npz")
    _save(tck, path, dict(_state(), world_size=4))
    with pytest.warns(UserWarning, match="world_size 4"):
        tck.load_state(path, expect_world_size=1)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tck.load_state(path, expect_world_size=4)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_snapshots_cross_between_packages(tmp_path, writer):
    st = _state(1)
    a, b = str(tmp_path / "a.npz"), str(tmp_path / "b.npz")
    wmod, rmod = (jck, tck) if writer == "jax" else (tck, jck)
    _save(wmod, a, st)
    _save(rmod, b, st)
    # The other package loads it, and both write the same arrays (the
    # checksum included: the digests agree).
    _assert_same(rmod.load_state(a), wmod.load_state(a))
    with np.load(a) as za, np.load(b) as zb:
        _assert_same({k: za[k] for k in za.files},
                     {k: zb[k] for k in zb.files})
    assert tck.SCHEMA_VERSION == jck.SCHEMA_VERSION
