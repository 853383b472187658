"""The chunk scans' staged design on the CPU: the Python mirror of the
CUDA kernels' plan and stages (``plan_scan``, ``rebase``,
``mamba_chunk_scan_staged``, ``mlstm_chunk_scan_staged``) against the
sequential plain versions and the JAX reference (the Pallas kernels in
interpret mode and ``kernels/ref.py``), and an emulation of the bf16
kernels' split products at the main path's shapes.

The limit is the kernels' fp32 one, 1e-4 (atol = rtol): the stages sum
in another order than the chunk-by-chunk plain versions.  The cases cover
Q = 1 with a prime nc (rows cut into kernel chunks across many caller
chunks), B = 2, two caller chunks of 160 (S = 320) and one caller chunk
(nc = 1).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops, ref  # noqa: E402
from repro_torch import kernels as K  # noqa: E402
from repro_torch.kernels import mamba_scan as MS  # noqa: E402
from repro_torch.kernels import mlstm as ML  # noqa: E402

TOL = 1e-4
# (B, nc, Q): Q = 1 with a prime nc, B = 2, S = 320, nc = 1
CASES = [(1, 67, 1), (2, 2, 12), (1, 2, 160), (1, 1, 37)]


def _close(a, b, tol=TOL):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    np.testing.assert_allclose(a, b, atol=tol, rtol=tol)


def _agree(a, b, tol=TOL):
    return torch.allclose(a.float(), b.float(), atol=tol, rtol=tol)


def _mamba_inputs(rng, B, nc, Q, nh=3, P=8, N=8):
    f = lambda *s, sc=0.5: (rng.standard_normal(s) * sc).astype(np.float32)
    cum = np.cumsum(-np.abs(f(B, nc, Q, nh, sc=1.0)) * 0.1, axis=2)
    return [torch.from_numpy(x) for x in
            (f(B, nc, Q, nh, P), f(B, nc, Q, N), f(B, nc, Q, N), cum)]


def _mlstm_inputs(rng, B, nc, Q, nh=2, dh=16):
    f = lambda *s, sc=0.3: (rng.standard_normal(s) * sc).astype(np.float32)
    cumf = np.cumsum(-np.abs(f(B, nc, Q, nh, sc=1.0)) * 0.2, axis=2)
    li = np.minimum(f(B, nc, Q, nh, sc=1.0), 2.0)
    return [torch.from_numpy(x) for x in
            (f(B, nc, Q, nh, dh), f(B, nc, Q, nh, dh), f(B, nc, Q, nh, dh),
             cumf, li)]


# ------------------------------------------------------------------ plan --
@pytest.mark.parametrize("nc,Q,chunks", [(2, 150, 5), (1, 128, 2),
                                         (257, 1, 5), (4, 256, 16),
                                         (2, 160, 5), (1, 1, 1)])
def test_plan_scan_cuts_the_rows_into_kernel_chunks(nc, Q, chunks):
    assert MS.plan_scan(nc, Q) == MS.ScanPlan(MS.SCAN_CHUNK, chunks)


def test_plan_scan_reads_no_tensor():
    """The plan is a function of ints: a tensor (whose value would need a
    host read) is refused, as are bools and sizes below 1."""
    for bad in ((torch.tensor(2), 150), (2, torch.tensor(150)),
                (2.0, 150), (True, 150)):
        with pytest.raises(TypeError, match="must be an int"):
            MS.plan_scan(*bad)
    with pytest.raises(ValueError):
        MS.plan_scan(0, 4)


@pytest.mark.parametrize("B,nc,Q", CASES + [(1, 5, 30)])
def test_rebase_is_the_global_cumsum_restarted_per_kernel_chunk(B, nc, Q):
    """g of row t in the kernel chunk from s0 is F_t - F_{s0-1}, with F the
    log-decay cumsum over the whole sequence (the caller's restarts at
    every chunk of Q rows undone)."""
    rng = np.random.default_rng(Q + nc)
    cum = torch.cumsum(-torch.from_numpy(
        np.abs(rng.standard_normal((B, nc, Q, 3))).astype(np.float64)), 2)
    plan = MS.plan_scan(nc, Q)
    g = MS.rebase(cum, plan)
    S, L = nc * Q, plan.chunk
    F = torch.cumsum(torch.diff(cum, dim=2, prepend=torch.zeros(
        B, nc, 1, 3, dtype=cum.dtype)).reshape(B, S, 3), 1)
    Fp = torch.cat([torch.zeros(B, 1, 3, dtype=F.dtype), F], 1)
    for c in range(plan.chunks):
        rows = min(L, S - c * L)
        want = F[:, c * L:c * L + rows] - Fp[:, c * L:c * L + 1]
        torch.testing.assert_close(g[:, c, :rows], want, atol=1e-9, rtol=0)
        assert not g[:, c, rows:].any()


@pytest.mark.parametrize("B,nc,Q", CASES + [(1, 5, 30), (1, 2, 150),
                                            (1, 257, 1)])
def test_rebase_adjoint_is_the_vjp_of_rebase(B, nc, Q):
    """The scans' backwards map dg to dcum through ``rebase_adjoint``,
    written out: it equals autograd's vjp of ``rebase`` in fp64, the rows
    past the last ignored."""
    rng = np.random.default_rng(Q * nc)
    plan = MS.plan_scan(nc, Q)
    cum = torch.zeros(B, nc, Q, 3, dtype=torch.float64)
    dg = torch.from_numpy(rng.standard_normal(
        (B, plan.chunks, plan.chunk, 3)))
    want = torch.func.vjp(lambda c: MS.rebase(c, plan), cum)[1](dg)[0]
    torch.testing.assert_close(MS.rebase_adjoint(dg, plan, nc, Q), want,
                               atol=1e-12, rtol=0)


# ---------------------------------------------------------------- stages --
@pytest.mark.parametrize("B,nc,Q", CASES)
def test_mamba_stages_vs_plain_pallas_and_ref(B, nc, Q):
    rng = np.random.default_rng(100 + Q)
    x, Bm, Cm, cum = _mamba_inputs(rng, B, nc, Q)
    y, st = MS.mamba_chunk_scan_staged(x, Bm, Cm, cum)
    yp, sp = K.mamba_chunk_scan_plain(x, Bm, Cm, cum)
    _close(y, yp)
    _close(st, sp)
    j = [jnp.asarray(t.numpy()) for t in (x, Bm, Cm, cum)]
    y_k, st_k = ops.mamba_chunk_scan(*j)
    _close(y, y_k)
    _close(st, st_k)
    h = jnp.zeros((B, 3, 8, 8))
    for c in range(nc):
        y_c, h = ref.mamba_chunk(*(t[:, c] for t in j), h)
        _close(y[:, c], y_c)
    _close(st, h)


@pytest.mark.parametrize("B,nc,Q", CASES)
def test_mlstm_stages_vs_plain_pallas_and_ref(B, nc, Q):
    rng = np.random.default_rng(200 + Q)
    a = _mlstm_inputs(rng, B, nc, Q)
    y, C, n = ML.mlstm_chunk_scan_staged(*a)
    for got, want in zip((y, C, n), K.mlstm_chunk_scan_plain(*a)):
        _close(got, want)
    j = [jnp.asarray(t.numpy()) for t in a]
    _close(y, ops.mlstm_chunk_scan(*j))
    hh, nn = jnp.zeros((B, 2, 16, 16)), jnp.zeros((B, 2, 16))
    for c in range(nc):
        y_c, hh, nn = ref.mlstm_chunk(*(t[:, c] for t in j), hh, nn)
        _close(y[:, c], y_c)
    _close(C, hh)
    _close(n, nn)


@pytest.mark.parametrize("which", ["mamba", "mlstm"])
def test_planted_faults_fail_the_limit(which):
    """The staged design's faults (a kernel chunk reading the state that
    entered the chunk before it; cum not rebased across caller chunks;
    each bf16 split cut to its first part) each fail the limit that the
    stages pass."""
    rng = np.random.default_rng(7)
    for (B, nc, Q), fault in (((1, 2, 150), MS.FAULT_WRONG_STATE),
                              ((1, 67, 1), MS.FAULT_NO_REBASE),
                              ((1, 2, 150), MS.FAULT_SPLIT_LOW)):
        if which == "mamba":
            a = _mamba_inputs(rng, B, nc, Q)
            staged, plain = MS.mamba_chunk_scan_staged, \
                K.mamba_chunk_scan_plain
        else:
            a = _mlstm_inputs(rng, B, nc, Q)
            staged, plain = ML.mlstm_chunk_scan_staged, \
                K.mlstm_chunk_scan_plain
        want = plain(*a)[0]
        split = fault == MS.FAULT_SPLIT_LOW
        assert _agree(staged(*a, split=split)[0], want)
        assert not _agree(staged(*a, split=split, fault=fault)[0], want)


# ------------------------------------------------- the bf16 kernels' splits --
def _bf16(t):
    return t.to(torch.bfloat16)


def test_mlstm_split_products_meet_the_limit_at_the_main_path_shape():
    """xlstm-350m's 300-token prefill (q, k, v [1, 2, 150, 4, 512] bf16,
    the scales chip_smoke.py gives them): with q kᵀ exact and the three
    products whose other operand is fp32 split into three bf16 parts,
    y, C and n stay within 1e-4 of the fp32 plain version; cut to one
    bf16 part they do not."""
    g = torch.Generator().manual_seed(0)
    rn = lambda *s: torch.randn(*s, generator=g)
    B, nc, Q, nh, dh = 1, 2, 150, 4, 512
    a = (_bf16(rn(B, nc, Q, nh, dh) * dh ** -0.25),
         _bf16(rn(B, nc, Q, nh, dh) * dh ** -0.25), _bf16(rn(B, nc, Q, nh, dh)),
         torch.cumsum(-rn(B, nc, Q, nh).abs() * 0.2, 2),
         torch.clamp_max(rn(B, nc, Q, nh), 8.0))
    want = K.mlstm_chunk_scan_plain(*a)
    for got, w in zip(ML.mlstm_chunk_scan_staged(*a, split=True), want):
        assert _agree(got, w)
    cut = ML.mlstm_chunk_scan_staged(*a, split=True, fault=MS.FAULT_SPLIT_LOW)
    assert not _agree(cut[0], want[0])


def test_mamba_split_products_meet_the_limit_at_the_main_path_shape():
    """zamba2-1.2b's 300-token prefill (x̄ [1, 2, 150, 64, 64] fp32, B and
    C bf16): the state update (w ⊙ x̄ split into three bf16 parts) and the
    carried term (the entering state split likewise), with C Bᵀ exact and
    the intra-chunk product fp32, stay within 1e-4; cut to one bf16 part
    they do not."""
    g = torch.Generator().manual_seed(1)
    rn = lambda *s: torch.randn(*s, generator=g)
    B, nc, Q, nh, P, N = 1, 2, 150, 64, 64, 64
    a = (rn(B, nc, Q, nh, P) * 0.5, _bf16(rn(B, nc, Q, N) * 0.5),
         _bf16(rn(B, nc, Q, N) * 0.5),
         torch.cumsum(-rn(B, nc, Q, nh).abs() * 0.1, 2))
    want = K.mamba_chunk_scan_plain(*a)
    for got, w in zip(MS.mamba_chunk_scan_staged(*a, split=True), want):
        assert _agree(got, w)
    cut = MS.mamba_chunk_scan_staged(*a, split=True, fault=MS.FAULT_SPLIT_LOW)
    assert not _agree(cut[0], want[0])


def test_split_parts_sum_to_the_operand():
    """Three bf16 parts hold an fp32 value to about 2^-24 relative; one
    holds it to 2^-9."""
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(4096)
                         .astype(np.float32)) * 100
    rel = ((MS.split_bf16(x) - x).abs() / x.abs()).max()
    assert rel < 2 ** -22
    one = ((MS.split_bf16(x, fault=MS.FAULT_SPLIT_LOW) - x).abs()
           / x.abs()).max()
    assert 2 ** -12 < one <= 2 ** -8
