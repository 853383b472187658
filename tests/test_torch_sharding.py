"""The port's sharding rules against the reference's, on the CPU and in
one process: ``rules_for`` for every mode, ``spec`` over a sweep of
shapes and mesh shapes (the reference's hypothesis cases included as
fixed cases), ``choose_mesh_shape``, ``shardings_for`` over every arch's
schema at the production and 2 x 2 meshes, and the placement rules of
the custom ops' strategies.  No process group is started: the meshes
here are stand-ins with a ``DeviceMesh``'s names and shape (what the
rules read).  The multi-rank checks are ``test_torch_distributed.py``."""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from jax.sharding import PartitionSpec  # noqa: E402

from repro import sharding as JS  # noqa: E402
from repro.runtime import elastic as JE  # noqa: E402
from repro_torch import sharding as SH  # noqa: E402
from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.kernels import _sharding  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.runtime import elastic as TE  # noqa: E402
from repro_torch.training import steps as ST  # noqa: E402

AXES = {"2d": ("data", "model"), "3d": ("pod", "data", "model")}
MODES = ("train", "train_zero", "serve")


def _mesh(shape, names):
    """What the rules and ``placements`` read of a DeviceMesh."""
    return types.SimpleNamespace(mesh_dim_names=tuple(names),
                                 mesh=torch.empty(shape), ndim=len(shape),
                                 size=lambda d=None: (int(np.prod(shape))
                                                      if d is None
                                                      else shape[d]))


def _ref_spec(*args):
    return tuple(JS.spec(*args))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("axes", list(AXES), ids=list(AXES))
def test_rules_for_equals_reference(mode, axes):
    assert SH.rules_for(mode, AXES[axes]) == JS.rules_for(mode, AXES[axes])
    assert SH.rules_for(mode, AXES[axes], fsdp=False) == \
        JS.rules_for(mode, AXES[axes], fsdp=False)


def test_rules_for_refuses_an_unknown_mode():
    with pytest.raises(ValueError, match="unknown mode"):
        SH.rules_for("infer", AXES["2d"])


# the reference's hypothesis cases (tests/test_sharding_analysis.py) as
# fixed cases: (batch, ffn) shapes on a 16 x 16 train mesh, edges first
_HYPOTHESIS = [(1, 1), (1, 512), (512, 1), (16, 16), (17, 33), (256, 255),
               (512, 512), (48, 96), (3, 7), (128, 100)]
_SWEEP = [
    # (axes, shape, mesh shape, mode, mesh axes)
    (("batch", "kv_seq", "kv_heads", "head_dim"), (128, 4096, 8, 128),
     {"data": 16, "model": 16}, "serve", "2d"),
    (("batch", "seq", None), (256, 2048, 4096),
     {"pod": 2, "data": 16, "model": 16}, "train_zero", "3d"),
    (("batch", "seq", None), (96, 2048, 4096),
     {"pod": 2, "data": 16, "model": 16}, "train_zero", "3d"),
    (("batch", "seq", None), (8, 128, 2048), {"data": 2, "model": 2},
     "train", "2d"),
    (("fsdp", "heads", "head_dim"), (2048, 16, 128),
     {"data": 16, "model": 16}, "train", "2d"),
    (("fsdp", "kv_heads", "head_dim"), (2048, 2, 128),
     {"data": 16, "model": 16}, "train", "2d"),
    (("experts", "expert_embed", None), (64, 2048, 1408),
     {"pod": 2, "data": 16, "model": 16}, "serve", "3d"),
    (("vocab", "fsdp"), (151936, 2048), {"data": 16, "model": 16},
     "train", "2d"),
    (("vocab", "fsdp"), (151936, 2048), {"data": 4, "model": 3},
     "train", "2d"),
    ((None, "batch", "ssm_heads", None, None), (5, 8, 64, 64, 128),
     {"data": 16, "model": 16}, "serve", "2d"),
    (("stack", None, "batch", "ssm_heads", None, None),
     (6, 5, 4, 4, 512, 512), {"data": 2, "model": 2}, "serve", "2d"),
    (("batch", None, "expert_ffn"), (1, 1, 1), {"data": 16, "model": 16},
     "train", "2d"),
    ((), (), {"data": 2, "model": 2}, "train", "2d"),
] + [(("batch", "ffn"), s, {"data": 16, "model": 16}, "train", "2d")
     for s in _HYPOTHESIS]


@pytest.mark.parametrize("axes,shape,mesh_shape,mode,mesh_axes", _SWEEP,
                         ids=[f"{i}" for i in range(len(_SWEEP))])
def test_spec_equals_reference(axes, shape, mesh_shape, mode, mesh_axes):
    rules = SH.rules_for(mode, AXES[mesh_axes])
    assert SH.spec(axes, rules) == _ref_spec(axes, rules)
    got = SH.spec(axes, rules, shape, mesh_shape)
    assert got == _ref_spec(axes, rules, shape, mesh_shape)
    for dim, part in zip(shape, got):    # the reference's property
        if part is not None:
            n = np.prod([mesh_shape[a] for a in
                         (part if isinstance(part, tuple) else (part,))])
            assert dim % n == 0


def test_spec_tuple_matches_partition_spec():
    """A spec tuple is a PartitionSpec's entries, so ``PartitionSpec(*s)``
    rebuilds the reference's."""
    rules = SH.rules_for("train", AXES["3d"])
    s = SH.spec(("batch", "seq", None), rules)
    assert PartitionSpec(*s) == JS.spec(("batch", "seq", None), rules)


def test_choose_mesh_shape_equals_reference():
    for n in range(1, 513):
        for prefer in (16, 2):
            assert TE.choose_mesh_shape(n, prefer) == \
                JE.choose_mesh_shape(n, prefer), (n, prefer)


def test_placements_split_a_tuple_outer_mesh_dim_first():
    from torch.distributed.tensor import Replicate, Shard
    mesh = _mesh((2, 2, 2), AXES["3d"])
    assert SH.placements((("pod", "data"), "model"), mesh) == \
        (Shard(0), Shard(0), Shard(1))
    assert SH.placements((None, None), mesh) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="axis order"):
        SH.placements((("data", "pod"),), mesh)


_MESHES = {"16x16": ((16, 16), AXES["2d"]), "2x16x16": ((2, 16, 16),
                                                       AXES["3d"]),
           "2x2": ((2, 2), AXES["2d"])}


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", ARCHS)
def test_shardings_for_every_schema_follows_the_reference_spec(arch, mode):
    """Every param leaf (and the train state's, for the train modes) gets
    the placements of the reference's divisibility-checked spec for its
    logical axes and shape, at the production meshes and at 2 x 2."""
    cfg = get_config(arch)
    if mode == "serve":
        axes, tree = M.param_axes(cfg), M.abstract_params(cfg)
    else:
        axes, tree = ST.train_state_axes(cfg), ST.abstract_train_state(cfg)
    flat_ax = torch.utils._pytree.tree_flatten(axes, is_leaf=SH.is_axes)[0]
    flat = torch.utils._pytree.tree_leaves(tree)
    for shape, names in _MESHES.values():
        mesh = _mesh(shape, names)
        rules = SH.rules_for(mode, names)
        got = torch.utils._pytree.tree_flatten(
            SH.shardings_for(axes, tree, mesh, rules),
            is_leaf=lambda x: isinstance(x, tuple) and not SH.is_axes(x)
            or x == ())[0]
        ms = dict(zip(names, shape))
        want = [SH.placements(_ref_spec(a, rules, tuple(t.shape), ms), mesh)
                for a, t in zip(flat_ax, flat)]
        assert len(got) == len(want) == len(flat)
        assert got == want


def test_shardings_for_splits_only_what_divides():
    """kv_heads 2 on a model axis of 16 stays whole (the reference's
    fallback), while DTensor alone would split it unevenly."""
    from torch.distributed.tensor import Replicate, Shard
    cfg = get_config("qwen2.5-3b")
    mesh = _mesh((16, 16), AXES["2d"])
    sh = SH.shardings_for(M.param_axes(cfg), M.abstract_params(cfg), mesh,
                          SH.rules_for("train", AXES["2d"]))
    wk = sh["stages"][0][0]["attn"]["wk"]        # [D, Hkv=2, hd]
    assert wk == (Shard(0), Replicate())
    wq = sh["stages"][0][0]["attn"]["wq"]        # [D, H=16, hd]
    assert wq == (Shard(0), Shard(1))


def test_constrain_leaves_plain_tensors_and_no_rules_alone():
    x = torch.ones(4, 8)
    rules = SH.rules_for("train", AXES["2d"])
    assert SH.constrain(x, ("batch", None), rules) is x
    assert SH.constrain(x, ("batch", None), None) is x
    assert SH.mesh_of({"a": [x]}) is None
    assert SH.to_plain({"a": x})["a"] is x


def test_every_custom_op_has_a_strategy():
    """Each of the port's custom ops, forward and backward, has a sharding
    strategy whose last row replicates everything."""
    ops = {name for name in dir(torch.ops.repro_torch)
           if isinstance(getattr(torch.ops.repro_torch, name),
                         torch._ops.OpOverloadPacket)}
    names = [name for name, _ in _sharding.strategies()]
    assert sorted(names) == sorted(ops) and len(names) == 12


@pytest.mark.parametrize("dims,kept", [((0,), (1, 2)), ((-1,), (0, 1)),
                                       ((0, 2), (1,))])
def test_flip_and_roll_strategies_split_only_the_dims_they_keep(dims,
                                                                kept):
    """``aten.flip``'s and ``aten.roll``'s rows (registered where DTensor
    has none, as in torch 2.11): a split on a flipped or rolled dim would
    move data within each shard only, so only the kept dims split."""
    from torch.distributed.tensor import Replicate, Shard
    x = types.SimpleNamespace(ndim=3, placements=())
    rows = _sharding._flip(x, list(dims))
    assert rows[:-1] == [([Shard(d)], [Shard(d), None]) for d in kept]
    assert rows[-1] == ([Replicate()], [Replicate(), None])
    rows = _sharding._roll(x, [1] * len(dims), list(dims))
    assert rows[:-1] == [([Shard(d)], [Shard(d), None, None]) for d in kept]
    assert rows[-1] == ([Replicate()], [Replicate(), None, None])
    assert _sharding._roll(x, [1]) == [([Replicate()], [Replicate(), None])]


@pytest.mark.parametrize("shape,counts,want", [
    ((2, 2), (4, 2), True),      # split 2 ways: 2 | 4 and 2 | 2
    ((1, 4), (4, 2), True),      # 4 parts exceed Hkv: DTensor drops them
    ((2, 2), (6, 3), False),     # 2 parts of Hkv 3: uneven
    ((2, 3), (12, 6), True),
    ((2, 3), (12, 4), False),    # 3 parts of 4 kv heads
    ((4, 4), (16, 8), True),
    ((4, 4), (12, 12), True),    # 4 parts; 16 exceed 12
    ((2, 4), (12, 12), False),   # 8 parts of 12
])
def test_splits_evenly(shape, counts, want):
    assert _sharding.splits_evenly(_mesh(shape, AXES["2d"]), *counts) == want


def test_mesh_descriptor_without_a_mesh_is_unchanged():
    from repro_torch.core.recorder import mesh_descriptor
    assert mesh_descriptor() == {"shape": [1, 1], "axes": ["data", "model"]}
    assert mesh_descriptor(_mesh((2, 2), AXES["2d"])) == \
        {"shape": [2, 2], "axes": ["data", "model"]}
