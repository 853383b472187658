"""The redesigned scan backward kernels' plans and rounding, on the CPU.

``mamba_chunk_scan_backward_staged`` mirrors ``csrc/
mamba_scan_backward.cu`` (passes that store only the states entering
chunks 1..n−1 and the cotangents leaving chunks 0..n−2; chunk blocks over
groups of heads, ``plan_scan_backward``, whose dB and dC shares are summed
in group order) and ``mlstm_chunk_scan_backward_staged`` mirrors ``csrc/
mlstm_scan_backward.cu`` (the same passes; the scores summed over 64-column
tiles of d; dq, dk, dv per tile with dg's parts summed in tile order, and
<dC'_out, C'_in> from the state tiles' parts).  In fp32 each is held to
``jax.vjp`` of the reference's chunk chain (``repro/kernels/ref.py``) at
1e-5 of the largest value, as ``test_torch_train_kernels.py`` holds the
plain versions, and to the plain version at 1e-4.  With ``parts`` each
product with an fp32 operand sees it as the bf16 kernels do
(``split_product``): at xlstm-350m's and zamba2-1.2b's widths two parts
meet the bf16 limit the card holds the kernels to (2e-2) and one part
fails it, at every product on its own; each planted fault fails the
check."""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro_torch import kernels as K  # noqa: E402
from test_torch_train_kernels import _jax_scan, _scan_inputs  # noqa: E402

MS = importlib.import_module("repro_torch.kernels.mamba_scan")
ML = importlib.import_module("repro_torch.kernels.mlstm")
BF16_TOL = K.TOLERANCE[torch.bfloat16]
SM = 132     # an H100's SMs

# kind, B, nc, Q, width: one kernel chunk, two, a caller chunk's edge
# inside a kernel chunk, four kernel chunks with a ragged last (S = 210),
# three of one-row caller chunks, one row; the mLSTM's widths 72 and 130
# give two and three 64-column tiles of d, the last ragged
CASES = [(kind, B, nc, Q, w)
         for kind, w2 in (("mamba", 8), ("mlstm", 72))
         for B, nc, Q, w in ((2, 1, 1, 8), (1, 2, 64, w2), (1, 2, 150, 8),
                             (1, 3, 70, w2), (1, 130, 1, 8), (1, 1, 37, w2))]
CASES.append(("mlstm", 1, 2, 96, 130))


def _ids(cases):
    return [" ".join(map(str, c)) for c in cases]


def _staged(kind, *a, **kw):
    if kind == "mamba":
        kw.setdefault("group", 1)
        return MS.mamba_chunk_scan_backward_staged(*a, **kw)
    return ML.mlstm_chunk_scan_backward_staged(*a, **kw)


def _plain(kind, *a):
    return (K.mamba_chunk_scan_backward_plain if kind == "mamba"
            else K.mlstm_chunk_scan_backward_plain)(*a)


def _args(kind, B, nc, Q, width, seed):
    """torch inputs, (y,) and cotangents of a scan at a small width."""
    ins, cot = _scan_inputs(kind, B, nc, Q, np.random.default_rng(seed),
                            width=width)
    t = [torch.from_numpy(x) for x in ins]
    d = [torch.from_numpy(x) for x in cot]
    if kind == "mamba":
        return ins, cot, (*t, *d)
    return ins, cot, (*t, K.mlstm_chunk_scan_plain(*t)[0], *d)


def _scaled_close(got, want, tol):
    for a, b in zip(got, want):
        b = np.asarray(b, dtype=np.float32)
        scale = max(1.0, float(np.abs(b).max()))
        np.testing.assert_allclose(a.float().numpy() / scale, b / scale,
                                   atol=tol, rtol=tol)


# the JAX chain is traced chunk by chunk: the cases of three chunks or fewer
JAX_CASES = [c for c in CASES if c[2] <= 3]


@pytest.mark.parametrize("case", JAX_CASES, ids=_ids(JAX_CASES))
def test_staged_backward_matches_jax_vjp(case):
    kind, B, nc, Q, width = case
    ins, cot, a = _args(kind, B, nc, Q, width, nc * Q + width)
    want = jax.jit(lambda ins, cot: jax.vjp(
        lambda *x: _jax_scan(kind, *x), *ins)[1](cot))(ins, cot)
    groups = (1, 2) if kind == "mamba" else (None,)
    for group in groups:   # the head groups do not change the sums' terms
        kw = {} if group is None else {"group": group}
        _scaled_close(_staged(kind, *a, **kw), want, 1e-5)


@pytest.mark.parametrize("case", CASES, ids=_ids(CASES))
def test_staged_backward_matches_plain(case):
    kind, B, nc, Q, width = case
    _, _, a = _args(kind, B, nc, Q, width, 7 + nc)
    _scaled_close(_staged(kind, *a), _plain(kind, *a), 1e-4)


def _full_width(kind, B, nc, Q, seed=0, decay=1.0):
    """A scan's inputs at zamba2-1.2b's (nh 64, P = N = 64) or
    xlstm-350m's (nh 4, dh 512) widths as the card tests draw them, with
    bf16 B, C or q, k, v, the forward's y and nonzero cotangents."""
    g = torch.Generator().manual_seed(seed)
    rn = lambda *s: torch.randn(*s, generator=g)
    bf = torch.bfloat16
    if kind == "mamba":
        ins = (rn(B, nc, Q, 64, 64) * 0.5, (rn(B, nc, Q, 64) * 0.5).to(bf),
               (rn(B, nc, Q, 64) * 0.5).to(bf),
               torch.cumsum(-rn(B, nc, Q, 64).abs() * 0.1, 2))
        outs = K.mamba_chunk_scan_plain(*ins)
        return (*ins, *(rn(*o.shape) for o in outs))
    ins = (*((rn(B, nc, Q, 4, 512) * 512 ** -0.25).to(bf) for _ in range(2)),
           rn(B, nc, Q, 4, 512).to(bf),
           torch.cumsum(-rn(B, nc, Q, 4).abs() * 0.2, 2) * decay,
           torch.clamp_max(rn(B, nc, Q, 4), 8.0))
    outs = K.mlstm_chunk_scan_plain(*ins)
    return (*ins, outs[0], *(rn(*o.shape) for o in outs))


def _agree(got, want, tol=BF16_TOL):
    """The card's bf16 check: every gradient in its dtype, atol = rtol."""
    return all(torch.allclose(a.float(), b.float(), atol=tol, rtol=tol)
               for a, b in zip(got, want))


@pytest.mark.parametrize("Q,nc", [(128, 1), (150, 2)])
@pytest.mark.parametrize("kind", ["mamba", "mlstm"])
def test_two_parts_meet_the_bf16_limit_and_one_fails(kind, Q, nc):
    a = _full_width(kind, 1, nc, Q)
    want = _plain(kind, *a)
    assert MS.BACKWARD_PARTS == 2
    assert _agree(_staged(kind, *a, parts=2), want)
    assert not _agree(_staged(kind, *a, parts=1), want)


# each product the kernels split, as the mirrors write it
PRODUCTS = {
    "mamba": ["bjhp,bjn->bhpn", "bihp,bin->bhpn", "bcihp,bcjhp->bcijh",
              "bchpn,bcjn->bcjhp", "bcijh,bcihp->bcjhp", "bcijh,bcin->bcjhn",
              "bcjhp,bchpn->bcjhn", "bcihp,bchpn->bcihn",
              "bcijh,bcjn->bcihn"],
    "mlstm": ["bjhd,bjhe->bhde", "bcihd,bcjhd->bcijh", "bihd,bihe->bhde",
              "bcihe,bchde->bcihd", "bcijh,bcjhd->bcihd",
              "bcjhe,bchde->bcjhd", "bcijh,bcihd->bcjhd",
              "bcijh,bcihe->bcjhe", "bcjhd,bchde->bcjhe"]}
PRODUCT_CASES = [(k, eq) for k, eqs in PRODUCTS.items() for eq in eqs]


@pytest.mark.parametrize("kind,eq", PRODUCT_CASES,
                         ids=[f"{k} {e}" for k, e in PRODUCT_CASES])
def test_one_part_fails_at_every_product(kind, eq, monkeypatch):
    """Two parts at every product: the mirror with that one product cut to
    one part fails the bf16 limit at a train step's rows."""
    a = _full_width(kind, 1, 1, 128)
    want = _plain(kind, *a)
    mod = MS if kind == "mamba" else ML
    split, seen = MS.split_product, []

    def product(e, x, y, parts):
        seen.append(e)
        return split(e, x, y, 1 if e == eq else parts)
    monkeypatch.setattr(mod, "split_product", product)
    assert not _agree(_staged(kind, *a, parts=2), want)
    assert eq in seen


def test_split_product_keeps_the_cross_terms_to_the_same_order():
    g = torch.Generator().manual_seed(3)
    a, b = torch.randn(5, 7, generator=g), torch.randn(7, 4, generator=g)
    ah, al = MS.bf16_parts(a, 2)
    bh, bl = MS.bf16_parts(b, 2)
    two = MS.split_product("ik,kj->ij", a, b, 2)
    assert torch.allclose(two, ah @ bh + ah @ bl + al @ bh, atol=1e-6)
    assert torch.equal(MS.split_product("ik,kj->ij", a, b, 1), ah @ bh)
    # an exact (bf16-valued) operand meets every part of the other
    e = b.to(torch.bfloat16).float()
    assert torch.allclose(MS.split_product("ik,kj->ij", a, e, 2),
                          (ah + al) @ e, atol=1e-6)
    assert torch.allclose(MS.split_product("ik,kj->ij", a, b, None), a @ b,
                          atol=1e-6)
    assert torch.equal(sum(MS.bf16_parts(a, 3)), MS.split_bf16(a))


FAULTS = [("mamba", MS.FAULT_WRONG_COTANGENT, 1.0),
          ("mamba", MS.FAULT_DROP_GROUP, 1.0),
          ("mamba", MS.FAULT_ONE_PART, 1.0),
          ("mlstm", ML.FAULT_WRONG_COTANGENT, 1.0),
          ("mlstm", ML.FAULT_DROP_TILE, 1.0),
          ("mlstm", ML.FAULT_ROWS_DROP_TILE, 1.0),
          ("mlstm", ML.FAULT_ONE_PART, 1.0),
          ("mlstm", ML.FAULT_STATE_DROP_TILE, 0.01)]


@pytest.mark.parametrize("kind,fault,decay", FAULTS,
                         ids=[f"{k} fault {f}" for k, f, _ in FAULTS])
def test_planted_faults_fail_the_check(kind, fault, decay):
    """Each planted fault of the kernels, in the mirror at a train step's
    rows in bf16 with the kernels' parts, fails the check that the mirror
    passes; <dC'_out, C'_in>'s with the forget gates near 1 (at the usual
    gates e^{gl} is ~e^-10 and the term does not show)."""
    a = _full_width(kind, 1, 1, 128, seed=1, decay=decay)
    want = _plain(kind, *a)
    kw = {"group": 4} if kind == "mamba" else {}
    assert _agree(_staged(kind, *a, parts=2, **kw), want)
    assert not _agree(_staged(kind, *a, parts=2, fault=fault, **kw), want)


def test_plan_scan_backward_from_shapes():
    plan = MS.plan_scan_backward
    assert plan(8, 2, 64, SM) == MS.BackwardPlan(4, 16)     # train: 256
    assert plan(1, 5, 64, SM) == MS.BackwardPlan(2, 32)     # 300 tokens
    assert plan(64, 4, 64, SM) == MS.BackwardPlan(8, 8)
    assert plan(1, 1, 3, SM) == MS.BackwardPlan(1, 3)
    for B, n, nh in ((8, 2, 64), (1, 5, 64), (3, 1, 6), (1, 1, 1)):
        g, groups = plan(B, n, nh, SM)
        assert groups == -(-nh // g) and g in (1, 2, 4, 8)
        assert g == 1 or B * n * groups >= SM



def _chip_smoke():
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_bounds", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("kind", ["mamba", "mlstm"])
def test_bound_counts_each_split_product_at_its_bf16_products(kind):
    """``chip_smoke.py:_scan_backward_ops(parts=)``: with bf16 inputs a
    product with an fp32 operand costs ``parts`` bf16 products (one of
    two fp32 operands parts·(parts + 1)/2), so the bound falls below the
    count that put every such product at the fp32 peak and rises with the
    parts; fp32 inputs count three TF32 products a product."""
    CS = _chip_smoke()
    for B, Q, nc in CS.BWD_SCAN_CASES:
        ms = {}
        for esz, parts in ((2, 1), (2, 2), (2, 3), (4, 2)):
            ops = CS._scan_backward_ops(kind, B, Q, nc, esz, parts)
            assert set(ops) == ({"bfloat16", "float32"} if esz == 2 else
                                {"tfloat32", "float32"})
            nbytes = CS._scan_backward_bytes(kind, B, Q, nc, esz)
            ms[esz, parts] = CS.bound(nbytes, ops, "bfloat16")[0]
        assert ms[2, 1] <= ms[2, 2] <= ms[2, 3]
        # the train row's bf16 bounds PERF.md gives (0.1647 and 0.0432 ms
        # with every fp32-operand product at the fp32 peak)
        if (B, Q, nc) == (8, 128, 1):
            assert round(ms[2, 2], 4) == (0.0178 if kind == "mamba"
                                          else 0.0256)
