"""Port's checkpoint module against ``repro.checkpoint``: the reference's
own cases (``tests/test_checkpoint.py``: round trip with bf16 and f32
leaves, latest step, metadata, corruption detected with fallback, no
partial visibility, async save with retention, restore, async errors)
on torch trees, then the on-disk layout against the reference's: the
same tree saved by both packages gives the same manifest (leaf paths,
shapes, dtypes — bf16 as ``"bfloat16"`` over ``uint16`` bits — and the
shard map) and the same stored arrays, and each package loads the
other's checkpoint with every leaf's value and dtype kept."""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import checkpoint as jckpt  # noqa: E402
from repro_torch.checkpoint import (CheckpointManager, decode_json,  # noqa: E402
                                    encode_json, latest_step,
                                    load_checkpoint, save_checkpoint)


def _tree():
    return {
        "params": {"w": torch.arange(12, dtype=torch.bfloat16).reshape(3, 4),
                   "b": torch.ones((4,), dtype=torch.float32)},
        "opt": {"m": torch.zeros((3, 4), dtype=torch.float32),
                "step": torch.tensor(7, dtype=torch.int32)},
    }


def _jax_tree():
    return {
        "params": {"w": jnp.arange(12, dtype=jnp.bfloat16).reshape(3, 4),
                   "b": jnp.ones((4,), jnp.float32)},
        "opt": {"m": jnp.zeros((3, 4), jnp.float32),
                "step": jnp.int32(7)},
    }


def test_bf16_and_f32_leaves(tmp_path):
    save_checkpoint(str(tmp_path), 3, _tree(), num_shards=2)
    loaded, manifest = load_checkpoint(str(tmp_path))
    assert manifest["step"] == 3
    w = loaded["params"]["w"]
    assert isinstance(w, torch.Tensor) and w.dtype == torch.bfloat16
    assert torch.equal(w, _tree()["params"]["w"])
    assert loaded["params"]["b"].dtype == np.float32
    assert int(loaded["opt"]["step"]) == 7


def test_latest_step(tmp_path):
    for s in (1, 5, 3):
        save_checkpoint(str(tmp_path), s, _tree())
    assert latest_step(str(tmp_path)) == 5


def test_metadata(tmp_path):
    save_checkpoint(str(tmp_path), 1, _tree(),
                    metadata={"data_step": 42, "dp_size": 4})
    _, manifest = load_checkpoint(str(tmp_path))
    assert manifest["metadata"] == {"data_step": 42, "dp_size": 4}


def test_corruption_detected_and_fallback(tmp_path):
    save_checkpoint(str(tmp_path), 1, _tree())
    save_checkpoint(str(tmp_path), 2, _tree())
    shard = os.path.join(str(tmp_path), "step_000000002", "shard_000.npz")
    with open(shard, "r+b") as f:
        f.seek(30)
        f.write(b"\xff\xff\xff")
    with pytest.raises(Exception):
        load_checkpoint(str(tmp_path), step=2)
    _, manifest = load_checkpoint(str(tmp_path))
    assert manifest["step"] == 1


def test_no_partial_visibility(tmp_path):
    os.makedirs(os.path.join(str(tmp_path), ".tmp_ckpt_x"))
    assert latest_step(str(tmp_path)) is None


def test_async_save_and_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, num_shards=1)
    for s in (10, 20, 30):
        mgr.save(s, _tree())
    mgr.wait()
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(str(tmp_path))
                   if d.startswith("step_"))
    assert steps == [20, 30]


def test_async_save_snapshots_the_tree_before_returning(tmp_path):
    """``save`` copies every leaf before its writer thread starts, so an
    in-place update right after the call does not reach the file."""
    tree = _tree()
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, tree)
    tree["params"]["w"].fill_(-1)
    mgr.wait()
    loaded, _ = mgr.restore()
    assert torch.equal(loaded["params"]["w"], _tree()["params"]["w"])


def test_restore(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(5, _tree(), block=True)
    tree, manifest = mgr.restore()
    assert manifest["step"] == 5
    assert "params" in tree


def test_async_error_surfaces_on_wait(tmp_path):
    mgr = CheckpointManager(os.path.join(str(tmp_path), "x"))
    mgr.save(1, {"bad": object()})
    with pytest.raises(Exception):
        mgr.wait()


def test_json_leaves_equal_reference():
    obj = {"free": [[3, 2, 1], []], "rng": {"state": 2 ** 100, "inc": 7},
           "x": 0.1, "s": "ünï"}
    got, want = encode_json(obj), jckpt.encode_json(obj)
    assert got.dtype == want.dtype == np.uint8
    assert np.array_equal(got, want)
    assert decode_json(got) == jckpt.decode_json(want) == obj


def _manifest(path):
    with open(os.path.join(path, "manifest.json")) as f:
        m = json.load(f)
    m.pop("sha256")         # npz members carry the write time
    return m


def test_layout_equals_reference(tmp_path):
    tdir = save_checkpoint(str(tmp_path / "t"), 4, _tree(), num_shards=3,
                           metadata={"m": 1})
    jdir = jckpt.save_checkpoint(str(tmp_path / "j"), 4, _jax_tree(),
                                 num_shards=3, metadata={"m": 1})
    assert os.path.basename(tdir) == os.path.basename(jdir)
    assert _manifest(tdir) == _manifest(jdir)
    assert _manifest(tdir)["leaves"]["params/w"]["dtype"] == "bfloat16"
    for s in range(3):
        name = f"shard_{s:03d}.npz"
        with np.load(os.path.join(tdir, name)) as t, \
                np.load(os.path.join(jdir, name)) as j:
            assert sorted(t.files) == sorted(j.files)
            for k in t.files:
                assert t[k].dtype == j[k].dtype and \
                    np.array_equal(t[k], j[k]), k


def test_each_package_reads_the_others_checkpoint(tmp_path):
    jckpt.save_checkpoint(str(tmp_path / "j"), 2, _jax_tree())
    got, _ = load_checkpoint(str(tmp_path / "j"))
    assert got["params"]["w"].dtype == torch.bfloat16
    assert torch.equal(got["params"]["w"], _tree()["params"]["w"])
    assert np.array_equal(got["opt"]["m"], np.zeros((3, 4), np.float32))

    save_checkpoint(str(tmp_path / "t"), 2, _tree())
    back, _ = jckpt.load_checkpoint(str(tmp_path / "t"))
    assert str(back["params"]["w"].dtype) == "bfloat16"
    np.testing.assert_array_equal(
        np.asarray(back["params"]["w"], np.float32),
        np.arange(12, dtype=np.float32).reshape(3, 4))
    assert int(back["opt"]["step"]) == 7
