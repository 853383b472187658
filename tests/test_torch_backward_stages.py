"""The redesigned backward kernels' decompositions and plans, on the CPU.

``flash_attention_backward_staged`` mirrors the bf16 wgmma kernel of
``csrc/flash_attention_backward.cu`` (launch A per 64-row query tile over
its visible 64-key tiles; launch B per 64-key tile and split of the
group's heads, the splits' partials summed in split order) and
``rmsnorm_backward_staged`` the two launches of
``csrc/rmsnorm_backward.cu`` (a partial row of dscale per block of
``chunk`` rows, the partial rows summed in contiguous parts, the parts in
order).  Each is held to ``jax.grad`` of the reference's pure-JAX
``chunked_attention`` / ``apply_norm`` (``repro/models/layers.py:103``,
``:69``) at fp32 ``allclose`` 1e-5 over the cases of
``test_torch_train_kernels.py``, at the plan the card would take and at
plans that split otherwise (a ragged last split, several blocks of rows);
a plan one split or one block short fails the check.  The planners are
pinned at the train shapes on an H100's 132 SMs and take shapes only."""
import importlib
import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import layers as JL  # noqa: E402
from repro_torch import kernels as K  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from test_torch_train_kernels import CASES  # noqa: E402

FA = importlib.import_module("repro_torch.kernels.flash_attention")
RN = importlib.import_module("repro_torch.kernels.rmsnorm")
TOL = 1e-5
SM = 132     # an H100's SMs

FLASH_CASES = [c for c in CASES if c[0] != "rmsnorm"]
NORM_CASES = [c for c in CASES if c[0] == "rmsnorm"]


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), atol=tol, rtol=tol)


def _agree(a, b, tol=TOL):
    return np.allclose(np.asarray(a, np.float32), np.asarray(b, np.float32),
                       atol=tol, rtol=tol)


def _flash_inputs(case):
    kind, B, Sq, Sk, H, Hkv, hd, causal, window, q_offset = case
    rng = np.random.default_rng(len(kind) + hd)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)
    q, k, v = f32(B, Sq, H, hd), f32(B, Sk, Hkv, hd), f32(B, Sk, Hkv, hd)
    return (q, k, v, f32(B, Sq, H, hd),
            dict(causal=causal, window=window, q_offset=q_offset))


def _flash_plan(case, which):
    """The card's plan (132 SMs), or one of ceil(G / 2) heads a split
    (a ragged last split where G is odd)."""
    _, B, Sq, Sk, H, Hkv, hd = case[:7]
    plan = FA.plan_flash_backward(B, Sq, Sk, H, Hkv, hd, SM)
    if which == "ragged":
        G = H // Hkv
        hp = -(-G // 2)
        plan = plan._replace(heads_per=hp, splits=-(-G // hp))
    return plan


@pytest.fixture(scope="module")
def jax_grads():
    memo = {}

    def get(case):
        if case not in memo:
            q, k, v, dout, kw = _flash_inputs(case)
            _, vjp = jax.vjp(
                lambda q, k, v: JL.chunked_attention(q, k, v, **kw),
                *map(jnp.asarray, (q, k, v)))
            memo[case] = [np.asarray(g) for g in vjp(jnp.asarray(dout))]
        return memo[case]
    return get


@pytest.mark.parametrize("which", ["planned", "ragged"])
@pytest.mark.parametrize("case", FLASH_CASES, ids=[c[0] for c in FLASH_CASES])
def test_flash_staged_matches_jax_grad(jax_grads, case, which):
    q, k, v, dout, kw = _flash_inputs(case)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, dout))
    out = K.flash_attention_plain(tq, tk, tv, **kw)
    got = FA.flash_attention_backward_staged(
        tq, tk, tv, out, tdo, plan=_flash_plan(case, which), **kw)
    for a, b in zip(got, jax_grads(case)):
        _close(a, b)


def test_flash_staged_rounds_as_the_bf16_kernel():
    """With bf16 inputs the mirror rounds P and dS to bf16 as the kernel
    does, and stays within the card's bf16 limit of the plain backward."""
    case = ("causal G=8", 1, 70, 70, 8, 1, 64, True, 0, 0)
    q, k, v, dout, kw = _flash_inputs(case)
    tq, tk, tv, tdo = (torch.from_numpy(a).to(torch.bfloat16)
                       for a in (q, k, v, dout))
    out = K.flash_attention_plain(tq, tk, tv, **kw)
    got = FA.flash_attention_backward_staged(tq, tk, tv, out, tdo, **kw)
    want = K.flash_attention_backward_plain(tq, tk, tv, out, tdo, **kw)
    tol = K.TOLERANCE[torch.bfloat16]
    for a, b in zip(got, want):
        assert a.dtype == torch.bfloat16
        _close(a.float(), b.float(), tol)


def test_flash_staged_plan_one_split_short_fails():
    """A plan whose splits leave out the group's last head fails the fp32
    check of dk and dv that the full plan passes; dq (launch A) holds."""
    case = ("causal G=3", 1, 40, 40, 3, 1, 64, True, 0, 0)
    q, k, v, dout, kw = _flash_inputs(case)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, dout))
    out = K.flash_attention_plain(tq, tk, tv, **kw)
    want = K.flash_attention_backward_plain(tq, tk, tv, out, tdo, **kw)
    full = FA.FlashBackwardPlan(2, 2)
    short = full._replace(splits=1)
    ok = FA.flash_attention_backward_staged(tq, tk, tv, out, tdo, plan=full,
                                            **kw)
    bad = FA.flash_attention_backward_staged(tq, tk, tv, out, tdo,
                                             plan=short, **kw)
    assert all(_agree(a, b) for a, b in zip(ok, want))
    assert _agree(bad[0], want[0])
    assert not _agree(bad[1], want[1]) and not _agree(bad[2], want[2])


def _norm_inputs(case):
    kind, B, Sq, _, _, _, hd = case[:7]
    rng = np.random.default_rng(len(kind) + hd)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)
    return f32(B, Sq, hd), f32(B, Sq, hd), 1.0 + 0.1 * f32(hd)


def _norm_plan(rows, D, which):
    plan = RN.plan_rmsnorm_backward(rows, D, 4, SM)
    if which == "blocks of 2":     # several rows a block, two a group
        plan = plan._replace(grid=-(-rows // 2), chunk=2, group=2)
    elif which == "ragged":        # rows that do not divide the chunk
        plan = plan._replace(grid=-(-rows // 4), chunk=4, group=4, cols=32)
    return plan


@pytest.mark.parametrize("which", ["planned", "blocks of 2", "ragged"])
@pytest.mark.parametrize("case", NORM_CASES,
                         ids=[f"{c[0]} D={c[6]}" for c in NORM_CASES])
def test_rmsnorm_staged_matches_jax_grad(case, which):
    x, g, scale = _norm_inputs(case)
    _, vjp = jax.vjp(lambda x, s: JL.apply_norm({"scale": s}, x),
                     jnp.asarray(x), jnp.asarray(scale))
    jdx, jds = vjp(jnp.asarray(g))
    rows, D = x.shape[0] * x.shape[1], x.shape[-1]
    plan = _norm_plan(rows, D, which)
    assert plan.grid * plan.chunk >= rows
    dx, ds = RN.rmsnorm_backward_staged(*map(torch.from_numpy, (x, scale, g)),
                                        plan=plan)
    _close(dx, jdx)
    _close(ds, jds)


def test_rmsnorm_staged_plan_one_block_short_fails():
    """A plan whose blocks leave out the last rows fails the dscale check
    that the full plan passes."""
    x, g, scale = _norm_inputs(NORM_CASES[0])
    rows, D = x.shape[0] * x.shape[1], x.shape[-1]
    t = tuple(map(torch.from_numpy, (x, scale, g)))
    want = RN.rmsnorm_backward_plain(*t)[1]
    full = RN.NormBackwardPlan(32, -(-rows // 4), 4, 4, 8)
    short = full._replace(grid=full.grid - 1)
    assert _agree(RN.rmsnorm_backward_staged(*t, plan=full)[1], want)
    assert not _agree(RN.rmsnorm_backward_staged(*t, plan=short)[1], want)


# the attention of a train step (batch 8 of seq 128; phi-3-vision's 576
# image + 128 text rows; whisper's encoder over 1,500 frames)
FLASH_TRAIN = {
    "qwen2.5-3b": ((8, 128, 128, 16, 2, 128), FA.FlashBackwardPlan(2, 4)),
    "zamba2-1.2b": ((8, 128, 128, 32, 32, 64), FA.FlashBackwardPlan(1, 1)),
    "phi-3-vision-4.2b": ((1, 704, 704, 32, 32, 96),
                          FA.FlashBackwardPlan(1, 1)),
    "whisper-large-v3": ((2, 1500, 1500, 20, 20, 64),
                         FA.FlashBackwardPlan(1, 1)),
}


@pytest.mark.parametrize("arch", list(FLASH_TRAIN))
def test_plan_flash_backward_at_train_shapes(arch):
    """qwen's group of 8 in 4 splits of 2 (128 blocks on 132 SMs); G = 1
    needs no split.  Every plan covers the group in at most 8 splits, the
    last one non-empty, and reaches 7/8 of the SMs where the group allows."""
    shape, want = FLASH_TRAIN[arch]
    plan = FA.plan_flash_backward(*shape, SM)
    assert plan == want
    B, Sq, Sk, H, Hkv, hd = shape
    G = H // Hkv
    assert 1 <= plan.splits <= FA.BWD_MAX_SPLIT
    assert (plan.splits - 1) * plan.heads_per < G
    assert G <= plan.splits * plan.heads_per
    blocks = B * Hkv * -(-Sk // FA.BWD_TILE) * plan.splits
    assert 8 * blocks >= 7 * SM or plan.splits == min(G, FA.BWD_MAX_SPLIT)


def test_plan_flash_backward_splits_ragged_groups():
    """A group of 3 over 64 units: 2 splits, of 2 heads and of 1."""
    assert FA.plan_flash_backward(8, 128, 128, 12, 4, 64, SM) == \
        FA.FlashBackwardPlan(2, 2)
    # the smoke widths keep the mma.sync kernel's walk over the whole group
    assert FA.plan_flash_backward(2, 37, 37, 8, 2, 32, SM) == \
        FA.FlashBackwardPlan(4, 1)


@pytest.mark.parametrize("arch,want", [
    ("qwen2.5-3b", RN.NormBackwardPlan(256, 128, 8, 4, 8)),
    ("zamba2-1.2b", RN.NormBackwardPlan(256, 128, 8, 4, 8)),
    ("phi-3-vision-4.2b", RN.NormBackwardPlan(384, 128, 8, 4, 16)),
    ("whisper-large-v3", RN.NormBackwardPlan(160, 128, 8, 4, 8)),
])
def test_plan_rmsnorm_backward_at_train_shapes(arch, want):
    """A train step's rows (batch 8 of seq 128) at the model's width in
    bf16: at most one block per SM, so at most 132 partial rows, each
    block's 8 rows in two groups of 4 through the ring of two stages,
    both loading at once."""
    D = get_config(arch).d_model
    plan = RN.plan_rmsnorm_backward(8 * 128, D, 2, SM)
    assert plan == want
    assert plan.grid <= SM and plan.grid * plan.chunk >= 8 * 128
    assert plan.threads * 8 >= D and plan.threads % 32 == 0
    assert 2 * plan.group * 2 * D * 2 <= RN.BACKWARD_RING_BYTES
    assert -(-D // plan.cols) >= SM or plan.cols == 8


def test_backward_planners_take_shapes_not_tensors():
    for fn in (FA.plan_flash_backward, RN.plan_rmsnorm_backward):
        params = inspect.signature(fn).parameters.values()
        assert all(p.annotation in (int, "int") for p in params), fn
    with pytest.raises(TypeError, match="Sk must be an int"):
        FA.plan_flash_backward(8, 128, torch.tensor(128), 16, 2, 128, SM)
    with pytest.raises(TypeError, match="rows must be an int"):
        RN.plan_rmsnorm_backward(torch.tensor(1024), 2048, 2, SM)
