"""The port's metastate-only sync against the JAX package: over nested
dicts built in an unsorted insertion order (JAX flattens dicts sorted,
torch's pytree in insertion order) the ``split`` paths, the ``full_pack``
bytes and the ``DeltaSync.pack`` bytes equal the reference's byte for
byte, with numpy leaves and with torch tensor leaves; unpack round-trips.
Exact everywhere."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import metasync as JMS  # noqa: E402
from repro_torch.core import metasync as MS  # noqa: E402


def _tree(j, *, tensors=False):
    """A job-state-like tree whose dict levels are NOT in sorted order;
    ``j`` moves the descriptors, the heap keeps its content but its head."""
    rng = np.random.default_rng(0)
    heap = rng.standard_normal(6000).astype(np.float32)
    heap[:8] = j
    tree = {
        "ring": {"submit_count": np.int32(j + 1),
                 "doorbell_pos": np.int32(j % 4)},
        "zz_weights": {"w_out": rng.standard_normal((40, 200))
                       .astype(np.float32),
                       "bias": np.zeros(3, np.float32)},
        "job": {"slot_mask": np.full(8, j % 2, np.int32),
                "job_id": np.int32(j), "chain_prev_id": np.int32(j - 1),
                "flags": [np.bool_(j % 3 == 0), np.arange(5, dtype=np.int64)],
                "nothing": None},
        "heap": heap,
        "count": 3,
        "a_hidden": np.float32(0.5),
    }
    if tensors:
        return _to_torch(tree)
    return tree


def _to_torch(x):
    if isinstance(x, dict):
        return {k: _to_torch(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_to_torch(v) for v in x]
    if isinstance(x, (np.ndarray, np.generic)):
        return torch.from_numpy(np.array(x))
    return x


@pytest.mark.parametrize("tensors", [False, True], ids=["numpy", "torch"])
def test_split_paths_and_order_equal_the_reference(tensors):
    meta, data = MS.split(_tree(4, tensors=tensors))
    jmeta, jdata = JMS.split(_tree(4))
    assert list(meta) == list(jmeta) and list(data) == list(jdata)
    assert "['job']['job_id']" in meta and "['heap']" in data
    assert not any("nothing" in p for p in list(meta) + list(data))


@pytest.mark.parametrize("tensors", [False, True], ids=["numpy", "torch"])
def test_full_pack_bytes_equal_the_reference(tensors):
    assert MS.full_pack(_tree(2, tensors=tensors)) == \
        JMS.full_pack(_tree(2))


@pytest.mark.parametrize("tensors", [False, True], ids=["numpy", "torch"])
def test_delta_sync_bytes_and_stats_equal_the_reference(tensors):
    ds, jds = MS.DeltaSync(), JMS.DeltaSync()
    base, jbase = {}, {}
    for j in (0, 1, 1, 2):
        meta = MS.split(_tree(j, tensors=tensors))[0]
        jmeta = JMS.split(_tree(j))[0]
        wire, jwire = ds.pack(meta), jds.pack(jmeta)
        assert wire == jwire
        base = MS.DeltaSync.unpack(wire, base)
        jbase = JMS.DeltaSync.unpack(jwire, jbase)
        assert list(base) == list(jbase)
        for path, leaf in jmeta.items():
            np.testing.assert_array_equal(base[path], np.asarray(leaf))
            np.testing.assert_array_equal(jbase[path], base[path])
    assert ds.stats == jds.stats
    assert ds.stats["leaves_skipped"] > 0


def test_bf16_leaf_packs_as_the_reference_packs_a_bf16_jax_array():
    """numpy has no bfloat16: the reference's ``np.asarray`` of a bf16 JAX
    array saves raw 2-byte elements under ``'<V2'``; a bf16 tensor leaf
    gives those bytes and loads back as the same ``V2`` array."""
    vals = np.random.default_rng(3).standard_normal((3, 5)).astype(np.float32)
    jarr = jnp.asarray(vals, jnp.bfloat16)
    t = torch.from_numpy(vals).to(torch.bfloat16)
    blob = MS._pack_leaf(t)
    assert blob == JMS._pack_leaf(jarr)
    assert b"'descr': '<V2'" in blob
    back, jback = MS._unpack_leaf(blob), JMS._unpack_leaf(blob)
    assert back.dtype == jback.dtype and back.dtype.itemsize == 2
    assert back.tobytes() == jback.tobytes() == \
        t.view(torch.int16).numpy().tobytes()
    tree = {"z": {"logits": t}, "a_step": torch.tensor(2, dtype=torch.int32)}
    jtree = {"z": {"logits": jarr}, "a_step": jnp.asarray(2)}
    assert MS.full_pack(tree) == JMS.full_pack(jtree)


@pytest.mark.parametrize("path,shape,dtype", [
    ("['w']", (4097,), np.float32), ("['w']", (4096,), np.float32),
    ("['table']", (4096 * 64,), np.int32), ("['table']", (4096 * 64 + 1,),
                                             np.int32),
    ("['hidden']", (9000,), np.float32), ("['hidden_mask']", (9000,),
                                          np.float32),
    ("['ids']", (9000,), np.float32), ("['flags']", (300_000,), np.bool_),
    ("['x'][0]['page_table']", (10_000,), np.float32),
])
def test_is_metastate_equals_the_reference(path, shape, dtype):
    arr = np.zeros(shape, dtype)
    want = JMS.is_metastate(path, arr)
    assert MS.is_metastate(path, arr) == want
    assert MS.is_metastate(path, torch.from_numpy(arr)) == want


def test_merge_rebuilds_the_tree_from_both_halves():
    tree = _tree(5, tensors=True)
    meta, data = MS.split(tree)
    meta = {p: v + 1 if p == "['job']['job_id']" else v
            for p, v in meta.items()}
    out = MS.merge(tree, meta, data)
    assert list(out) == list(tree)                # the tree's own order
    assert int(out["job"]["job_id"]) == 6
    assert out["job"]["nothing"] is None
    assert out["heap"] is tree["heap"]
    assert MS.split(out)[1].keys() == data.keys()
