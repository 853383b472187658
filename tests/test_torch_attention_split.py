"""The attention kernels' host-side plans and the decode merge rule, on the
CPU: the split planner and the flash tile planner are functions of shapes
only, and the split-KV algorithm (each split's partial softmax state,
merged in split order by ``merge_partials``, which the CUDA kernel
mirrors) equals the plain version and the JAX reference (``repro.kernels.
ref`` and the Pallas kernel in interpret mode) in fp32 for every split
count from 1 to 32, splits with no valid slot included."""
import importlib
import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops, ref  # noqa: E402
from repro_torch import kernels as K  # noqa: E402

DA = importlib.import_module("repro_torch.kernels.decode_attention")
FA = importlib.import_module("repro_torch.kernels.flash_attention")

B, H, HKV, HD, W = 3, 8, 2, 32, 96
LENGTHS = np.array([1, W, 41], np.int32)     # 1 and W, and one between


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), atol=tol, rtol=tol)


@pytest.fixture(scope="module")
def decode_case():
    """fp32 inputs from a numpy seed, the plain version's output and the
    JAX reference's and Pallas kernel's on the same values."""
    rng = np.random.default_rng(11)
    q, kc, vc = (rng.standard_normal(s).astype(np.float32)
                 for s in ((B, H, HD), (B, W, HKV, HD), (B, W, HKV, HD)))
    t = tuple(torch.from_numpy(x) for x in (q, kc, vc))
    lens = torch.from_numpy(LENGTHS)
    jx = tuple(jnp.asarray(x) for x in (q, kc, vc))
    return dict(
        torch=t, lengths=lens,
        plain=K.decode_attention_plain(*t, lens).numpy(),
        ref=np.asarray(ref.decode_attention(*jx, jnp.asarray(LENGTHS))),
        pallas=np.asarray(ops.decode_attention(*jx, jnp.asarray(LENGTHS),
                                               blk_w=W)))


@pytest.mark.parametrize("splits", range(1, 33))
def test_split_merge_matches_plain_and_reference(decode_case, splits):
    """Every split count 1..32 over W = 96 (chunks of 96 down to 3
    slots; at length 1 every split but the first holds no valid slot,
    and from 25 splits on the last ones lie wholly past W)."""
    plan = DA.SplitPlan(splits, -(-W // splits))
    got = DA.decode_attention_split(*decode_case["torch"],
                                    decode_case["lengths"], plan).numpy()
    for want in ("plain", "ref", "pallas"):
        _close(got, decode_case[want], 1e-6)


def test_dropped_last_split_fails_the_check(decode_case):
    """A plan one split short, at lengths that put one slot in the last
    split, fails the fp32 check that the full plan passes."""
    q, kc, vc = decode_case["torch"]
    plan = DA.SplitPlan(3, 32)
    lens = torch.tensor([65, 65, 65], dtype=torch.int32)
    want = K.decode_attention_plain(q, kc, vc, lens)
    tol = K.TOLERANCE[torch.float32]
    full = DA.decode_attention_split(q, kc, vc, lens, plan)
    short = DA.decode_attention_split(q, kc, vc, lens, DA.SplitPlan(2, 32))
    assert torch.allclose(full, want, atol=tol, rtol=tol)
    assert not torch.allclose(short, want, atol=tol, rtol=tol)


def test_merge_partials_rule():
    """One split is returned normalised; a split with no valid slot
    (m = -inf, l = 0, acc = 0) changes nothing; all empty gives 0."""
    g = torch.Generator().manual_seed(3)
    m, l = torch.randn(1, 4, generator=g), torch.rand(1, 4, generator=g) + 1
    acc = torch.randn(1, 4, 8, generator=g)
    one = DA.merge_partials(m, l, acc)
    torch.testing.assert_close(one, acc[0] / l[0, :, None], atol=0, rtol=0)
    empty = (torch.full((1, 4), float("-inf")), torch.zeros(1, 4),
             torch.zeros(1, 4, 8))
    with_empty = DA.merge_partials(*(torch.cat([a, e]) for a, e in
                                     zip((m, l, acc), empty)))
    torch.testing.assert_close(with_empty, one, atol=0, rtol=0)
    assert torch.equal(DA.merge_partials(*empty), torch.zeros(4, 8))


@pytest.mark.parametrize("B_,Hkv,W_,sm", [
    (4, 2, 1024, 132), (4, 32, 1024, 132), (1, 2, 64, 132), (1, 1, 4096, 132),
    (8, 8, 4096, 132), (1, 2, 1, 132), (2, 4, 100, 16), (64, 8, 1024, 132)])
def test_plan_splits_covers_the_cache_in_whole_tiles(B_, Hkv, W_, sm):
    plan = DA.plan_splits(B_, Hkv, W_, sm)
    assert 1 <= plan.splits <= DA.MAX_SPLITS
    assert plan.chunk % DA.SPLIT_GRANULE == 0
    assert (plan.splits - 1) * plan.chunk < W_ <= plan.splits * plan.chunk
    assert plan.chunk <= DA.MAX_CHUNK or plan.splits == DA.MAX_SPLITS
    # about one block per SM where the cache is long enough to split
    blocks = B_ * Hkv * plan.splits
    assert blocks >= min(sm, B_ * Hkv * -(-W_ // DA.SPLIT_GRANULE),
                         B_ * Hkv * DA.MAX_SPLITS) * 7 // 8


def test_plan_splits_at_the_main_shape():
    """qwen2.5-3b at serving batch 4 on an H100's 132 SMs: 16 splits of
    64 slots, 128 blocks (zamba2's 32 KV heads: 8 of 128, so that no block
    walks more than 128 slots)."""
    assert DA.plan_splits(4, 2, 1024, 132) == DA.SplitPlan(16, 64)
    assert DA.plan_splits(4, 32, 1024, 132) == DA.SplitPlan(8, 128)


def test_planners_take_shapes_not_tensors():
    """No tensor, so no host read of ``lengths``, can enter a plan."""
    for fn in (DA.plan_splits, FA.tile_rows):
        params = inspect.signature(fn).parameters.values()
        assert all(p.annotation in (int, "int") for p in params), fn
    with pytest.raises(TypeError, match="W must be an int"):
        DA.plan_splits(4, 2, torch.tensor(1024), 132)
    with pytest.raises(TypeError, match="B must be an int"):
        DA.plan_splits(torch.tensor([685, 560]).max(), 2, 1024, 132)


@pytest.mark.parametrize("B_,Sq,H_,want", [
    (1, 512, 16, 64),     # qwen2.5-3b prefill: 128 blocks of 64 rows
    (1, 256, 16, 32),     # MLA at S = 256: 64 blocks of 64 -> 128 of 32
    (1, 300, 32, 64),     # zamba2: 160 blocks
    (1, 37, 16, 32), (4, 512, 16, 64)])
def test_tile_rows(B_, Sq, H_, want):
    assert FA.tile_rows(B_, Sq, H_, 132) == want


def test_an_outgrown_counter_buffer_is_kept():
    """A CUDA graph captured on the counter buffer goes on using its
    address, so a larger call that outgrows the buffer must not free it."""
    import gc
    import weakref
    dev = torch.device("cpu")
    first = DA._counters(dev, 8)
    assert DA._counters(dev, 8) is first
    kept = weakref.ref(first)
    del first
    grown = DA._counters(dev, kept().numel() + 1)
    gc.collect()
    assert kept() is not None and kept() is not grown
    assert grown.numel() > kept().numel() and not grown.any()
