"""The host-side plans of the redesigned ``moe_gmm`` and ``rmsnorm``
kernels, on the CPU.

``plan_gmm`` (the bf16 grouped expert matmul): its persistent blocks walk
every (expert, F tile, row tile) item exactly once, its two tiles are the
CUDA kernels' and fit the H100's shared memory, it reads plain ints only,
and it puts up to 8 rows on one mma.sync N tile (decode), up to 128 in
one wgmma item, and row tiles of 128 above.  The kernel's walk (items in
``plan_items`` order, each summed over its 128- or 64-deep ring steps)
is replayed in plain PyTorch and held to
``moe_gmm_plain`` and to the JAX reference (``repro.kernels.ref`` and the
Pallas kernel in interpret mode) in fp32.  ``plan_gmm_backward``: its two
launches (dx, dw) walk every 128 x 256 output tile once (``plan_items``),
it takes the TMA kernels exactly where every row is 16-byte aligned and
keeps dy's tile resident in dw where R <= 128, the TMA kernels' rings,
buffers and resident tile are the CUDA constants and fit shared memory,
and the walks replayed in plain PyTorch (the resident dy tile included)
give ``moe_gmm_backward_plain``'s gradients.  ``plan_rmsnorm``: a warp per
row up to 2 KB rows, a block per row above, and every row normalised
exactly once by the grid-stride walk."""
import importlib
import inspect
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops, ref  # noqa: E402
from repro_torch import kernels as K  # noqa: E402

MG = importlib.import_module("repro_torch.kernels.moe_gmm")
RN = importlib.import_module("repro_torch.kernels.rmsnorm")
CSRC = Path(MG.__file__).resolve().parents[1] / "csrc"

# (E, R, D, F): deepseek-v2-lite-16b's decode and prefill products, the
# tiles' edges, mixtral-8x22b's, and ragged ones
GMM_SHAPES = [(64, 6, 2048, 1408), (64, 6, 1408, 2048), (64, 12, 2048, 1408),
              (64, 16, 1408, 2048), (64, 32, 2048, 1408), (64, 1, 2048, 1408),
              (64, 8, 2048, 1408), (64, 9, 2048, 1408), (64, 64, 2048, 1408),
              (64, 65, 2048, 1408), (64, 6, 1400, 1408), (8, 320, 6144, 16384),
              (3, 37, 200, 72), (3, 5, 131, 67), (2, 150, 96, 64)]
SM_COUNTS = (132, 114, 7, 1)


@pytest.mark.parametrize("sm", SM_COUNTS)
@pytest.mark.parametrize("E,R,D,F", GMM_SHAPES)
def test_gmm_plan_walks_every_item_once(E, R, D, F, sm):
    plan = MG.plan_gmm(E, R, D, F, sm)
    spec = plan.spec
    assert plan.f_tiles * spec.cols >= F > (plan.f_tiles - 1) * spec.cols
    assert plan.r_tiles * spec.rows >= R > (plan.r_tiles - 1) * spec.rows
    assert plan.items == E * plan.f_tiles * plan.r_tiles
    assert 1 <= plan.grid <= min(plan.items, sm)
    walked = [it for b in range(plan.grid) for it in MG.plan_items(plan, b)]
    every = {(e, ft, rt) for e in range(E) for ft in range(plan.f_tiles)
             for rt in range(plan.r_tiles)}
    assert len(walked) == len(every) == plan.items
    assert set(walked) == every
    # no block walks more than one item more than another
    counts = [len(MG.plan_items(plan, b)) for b in range(plan.grid)]
    assert max(counts) - min(counts) <= 1


def _cuda_tiles():
    """The two bf16 kernels' constants in csrc/moe_gmm.cu as GmmTiles."""
    src = (CSRC / "moe_gmm.cu").read_text()
    c = {k: int(v) for k, v in re.findall(r"\b([MG]_[A-Z]+) = (\d+)", src)}
    assert "__launch_bounds__(M_THREADS, 1)" in src
    assert "__launch_bounds__(G_THREADS, 1)" in src
    return (MG.GmmTile(c["M_BR"], c["M_BF"], c["M_THREADS"] // 32, c["M_BD"],
                       c["M_STAGES"], False),
            MG.GmmTile(c["G_BR"], c["G_BN"], c["G_THREADS"] // 32, c["G_BD"],
                       c["G_STAGES"], True))


def test_gmm_tiles_are_the_kernels_and_fit_shared_memory():
    """The Python tiles mirror the CUDA kernels' constants; each stage
    holds whole 32-deep ldmatrix or 16-deep wgmma steps, the wgmma tile
    whole warpgroups of 64 rows and 64-column blocks; one block's ring fits
    the 227 KB a block may use and the SM's 228 KB (1 KB reserved)."""
    assert _cuda_tiles() == MG.GMM_TILES
    mma, wg = MG.GMM_TILES
    assert not mma.wgmma and mma.rows == 8 and mma.cols == 16 * mma.warps
    assert mma.depth % 32 == 0
    assert wg.wgmma and wg.rows == 64 * (wg.warps // 4) and wg.cols % 64 == 0
    assert wg.cols <= 256 and wg.depth % 16 == 0 and wg.stages >= 3
    for t in MG.GMM_TILES:
        assert t.smem_bytes <= MG.SMEM_LIMIT
        assert t.smem_bytes + 1024 <= MG.SMEM_PER_SM


@pytest.mark.parametrize("R", [1, 2, 6, 8])
def test_gmm_plan_puts_up_to_8_rows_on_one_n_tile(R):
    """Decode: out^T on mma.sync, F on M, the rows on one N tile of 8."""
    plan = MG.plan_gmm(64, R, 2048, 1408, 132)
    assert plan.tile == 0 and not plan.spec.wgmma
    assert plan.spec.rows == 8 and plan.r_tiles == 1
    assert plan.spec.cols % 16 == 0    # whole 16-column A tiles


@pytest.mark.parametrize("R", [9, 12, 16, 17, 32, 33, 48, 64])
def test_gmm_plan_keeps_9_to_64_rows_in_one_warpgroup_item(R):
    """9 to 64 rows: the wgmma tile, the rows on M, all in one item (one
    row tile, so w is read from device memory once)."""
    plan = MG.plan_gmm(64, R, 2048, 1408, 132)
    assert plan.tile == 1 and plan.spec.wgmma and plan.r_tiles == 1


@pytest.mark.parametrize("R", [65, 100, 128, 129, 320])
def test_gmm_plan_tiles_rows_above_64(R):
    """Above 64 rows: items of 128 rows, one row tile up to 128 and row
    tiles above (w read again from L2 by each)."""
    plan = MG.plan_gmm(8, R, 6144, 16384, 132)
    assert plan.tile == 1 and plan.spec.rows == 128
    assert plan.r_tiles == -(-R // 128)


def test_gmm_plan_reads_only_shapes_and_the_sm_count():
    """A function of five ints: the same ints give the same plan, and a
    tensor (whose reading could be a host sync) or a float is refused."""
    params = list(inspect.signature(MG.plan_gmm).parameters)
    assert params == ["E", "R", "D", "F", "sm_count"]
    assert MG.plan_gmm(64, 6, 2048, 1408, 132) == \
        MG.plan_gmm(64, 6, 2048, 1408, 132)
    assert MG.plan_gmm(64, 6, 2048, 1408, 132) != \
        MG.plan_gmm(64, 6, 2048, 1408, 114)
    for bad in (torch.tensor(6), 6.0, True):
        with pytest.raises(TypeError):
            MG.plan_gmm(64, bad, 2048, 1408, 132)
    with pytest.raises(TypeError):
        MG.plan_gmm(64, 6, 2048, 1408, torch.tensor(132))


def _walk(x, w, plan):
    """The kernel's algorithm in plain PyTorch, fp32: every block's items
    in its order, each the sum over its ring steps of the x tile times
    the w tile (zeros past R, D and F)."""
    spec = plan.spec
    E, R, D = x.shape
    F = w.shape[2]
    out = torch.full((E, R, F), float("nan"))
    for b in range(plan.grid):
        for e, ft, rt in MG.plan_items(plan, b):
            r0, f0 = rt * spec.rows, ft * spec.cols
            acc = torch.zeros(spec.rows, spec.cols)
            for ks in range(max(1, -(-D // spec.depth))):
                d0 = ks * spec.depth
                xt = torch.zeros(spec.rows, spec.depth)
                wt = torch.zeros(spec.depth, spec.cols)
                xs = x[e, r0:r0 + spec.rows, d0:d0 + spec.depth].float()
                ws = w[e, d0:d0 + spec.depth, f0:f0 + spec.cols].float()
                xt[:xs.shape[0], :xs.shape[1]] = xs
                wt[:ws.shape[0], :ws.shape[1]] = ws
                acc += xt @ wt
            rows, cols = min(spec.rows, R - r0), min(spec.cols, F - f0)
            out[e, r0:r0 + rows, f0:f0 + cols] = acc[:rows, :cols]
    return out


@pytest.mark.parametrize("sm", [3, 132])
@pytest.mark.parametrize("E,R,D,F", [(3, 6, 200, 72), (2, 12, 256, 128),
                                     (2, 40, 129, 64), (2, 70, 256, 128),
                                     (3, 5, 131, 67), (2, 150, 96, 136)])
def test_gmm_walk_matches_plain_and_reference(E, R, D, F, sm):
    """Every row tile (8, 16, 64 and 128 rows, one and two row tiles), a
    D off the ring's step and ragged F, on a few SMs (several items a
    block) and on 132; the Pallas kernel where its blocks divide the
    shapes."""
    rng = np.random.default_rng(E * 1000 + R + D + F)
    x = rng.standard_normal((E, R, D)).astype(np.float32) * D ** -0.5
    w = rng.standard_normal((E, D, F)).astype(np.float32)
    got = _walk(torch.from_numpy(x), torch.from_numpy(w),
                MG.plan_gmm(E, R, D, F, sm))
    assert not torch.isnan(got).any()
    want = K.moe_gmm_plain(torch.from_numpy(x), torch.from_numpy(w))
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(ref.moe_gmm(jnp.asarray(x), jnp.asarray(w))),
        atol=1e-5, rtol=1e-5)
    if D % min(D, 128) == 0 and F % min(F, 128) == 0:
        np.testing.assert_allclose(
            got.numpy(),
            np.asarray(ops.moe_gmm(jnp.asarray(x), jnp.asarray(w))),
            atol=1e-5, rtol=1e-5)


def test_gmm_walk_fails_the_check_when_an_item_is_skipped():
    """The plan one item short leaves the last item unwritten, which the
    check rejects (the kernel's planted fault of the same name)."""
    E, R, D, F = 3, 6, 200, 72
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((E, R, D)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((E, D, F)).astype(np.float32))
    plan = MG.plan_gmm(E, R, D, F, 4)
    short = _walk(x, w, plan._replace(items=plan.items - 1))
    assert not torch.allclose(short, K.moe_gmm_plain(x, w), atol=1e-4,
                              rtol=1e-4)


# (E, R, D, F): deepseek-v2-lite-16b's train row (both expert products),
# mixtral-8x22b's, a 256-token group's R = 32, ragged ones, and aligned
# ones on either side of the resident tile's 128 rows
GMM_BWD_SHAPES = [(64, 128, 2048, 1408), (64, 128, 1408, 2048),
                  (8, 320, 6144, 16384), (3, 37, 200, 72), (3, 5, 131, 67),
                  (2, 150, 96, 300), (64, 32, 2048, 1408), (2, 129, 256, 512),
                  (2, 64, 136, 264)]


@pytest.mark.parametrize("sm", SM_COUNTS)
@pytest.mark.parametrize("E,R,D,F", GMM_BWD_SHAPES)
def test_gmm_backward_plan_walks_every_tile_once(E, R, D, F, sm):
    """dx's tiles cover [R, D] and dw's [D, F] of every expert, each
    walked once, the blocks' shares within one chunk of each other (one
    item; with dy resident, one unit: all the D tiles of one (expert, F
    tile), walked in a row by one block); where dx runs in thread block
    clusters (its 2 to 4 row tiles sharing w's tile), each cluster takes
    whole chunks of as many row tiles, one a block."""
    plan = MG.plan_gmm_backward(E, R, D, F, sm)
    for walk, (M, N) in ((plan.dx, (R, D)), (plan.dw, (D, F))):
        spec = walk.spec
        assert spec == MG.GMM_TILES[1]
        assert walk.f_tiles * spec.cols >= N > (walk.f_tiles - 1) * spec.cols
        assert walk.r_tiles * spec.rows >= M > (walk.r_tiles - 1) * spec.rows
        assert walk.items == E * walk.f_tiles * walk.r_tiles
        assert walk.grid % walk.cluster == 0 and walk.grid <= sm
        assert 1 <= walk.grid // walk.cluster <= walk.items // walk.chunk
        walked = [it for b in range(walk.grid)
                  for it in MG.plan_items(walk, b)]
        assert sorted(walked) == sorted(
            (e, nt, mt) for e in range(E) for nt in range(walk.f_tiles)
            for mt in range(walk.r_tiles))
        counts = [len(MG.plan_items(walk, b)) for b in range(walk.grid)]
        assert max(counts) - min(counts) <= walk.chunk
    cl = plan.dx.r_tiles if plan.tma and 2 <= plan.dx.r_tiles <= 4 else 1
    assert plan.dx.cluster == plan.dx.chunk == (cl if cl <= sm else 1)
    assert plan.dw.cluster == 1
    for walk in (plan.dx,):
        for k in range(walk.grid // walk.cluster):
            ranks = [MG.plan_items(walk, k * walk.cluster + r)
                     for r in range(walk.cluster)]
            for same in zip(*ranks):     # one chunk: consecutive row tiles
                assert {it[:2] for it in same} == {same[0][:2]}
                assert [it[2] for it in same] == list(
                    range(same[0][2], same[0][2] + walk.cluster))
    if plan.resident:
        assert plan.dw.chunk == plan.dw.r_tiles
        for b in range(plan.dw.grid):
            items = MG.plan_items(plan.dw, b)
            for u in range(0, len(items), plan.dw.chunk):
                unit = items[u:u + plan.dw.chunk]
                assert {it[:2] for it in unit} == {unit[0][:2]}
                assert [it[2] for it in unit] == list(range(plan.dw.r_tiles))
    else:
        assert plan.dw.chunk == 1


@pytest.mark.parametrize("E,R,D,F", GMM_BWD_SHAPES + [(2, 7, 64, 8),
                                                      (2, 7, 64, 12),
                                                      (2, 7, 60, 8)])
def test_gmm_backward_plan_takes_tma_exactly_where_rows_are_aligned(E, R, D,
                                                                    F):
    """The TMA kernels exactly where every row of x [E,R,D], w [E,D,F] and
    dy [E,R,F] starts on a 16-byte boundary (what the wrapper's
    ``_rows_aligned`` finds on fresh tensors), the cp.async kernel
    elsewhere; dy resident in dw exactly on the TMA path with R <= 128."""
    plan = MG.plan_gmm_backward(E, R, D, F, 132)
    assert plan.tma == (D * 2 % 16 == 0 and F * 2 % 16 == 0)
    assert plan.resident == (plan.tma and R <= MG.RESIDENT_ROWS)
    if E * R * D * F <= 2 ** 22:
        x = torch.empty(E, R, D, dtype=torch.bfloat16)
        w = torch.empty(E, D, F, dtype=torch.bfloat16)
        dy = torch.empty(E, R, F, dtype=torch.bfloat16)
        assert plan.tma == all(MG._rows_aligned(t) for t in (x, w, dy))


def test_gmm_backward_plan_reads_only_shapes_and_the_sm_count():
    params = list(inspect.signature(MG.plan_gmm_backward).parameters)
    assert params == ["E", "R", "D", "F", "sm_count"]
    assert MG.plan_gmm_backward(64, 128, 2048, 1408, 132) == \
        MG.plan_gmm_backward(64, 128, 2048, 1408, 132)
    for bad in (torch.tensor(128), 128.0, True):
        with pytest.raises(TypeError):
            MG.plan_gmm_backward(64, bad, 2048, 1408, 132)


def _cu_constants():
    """The integer constants of csrc/moe_gmm_backward.cu by name."""
    src = (CSRC / "moe_gmm_backward.cu").read_text()
    return src, {k: int(v) for k, v in
                 re.findall(r"\b([A-Z][A-Z_]*) = (\d+)[,;]", src)}


def test_gmm_backward_tma_tiles_are_the_kernels_and_fit_shared_memory():
    """``GMM_BWD_TMA`` mirrors the TMA kernel's constants: 128 x 256
    items 64 deep (``GMM_TILES[1]``'s tile), the rings of dx (dy and w a
    stage), of dw streamed (x and dy a stage, a [128][256] bf16 output
    buffer) and of dw with dy resident (x a stage, the buffer, dy's
    [128][256] tile); each fits the 227 KB a block may use and the SM's
    228 KB; the producer's and the consumers' registers add up to what one
    block of 384 threads holds; dy is resident up to 2 ring steps of R."""
    src, c = _cu_constants()
    assert "__launch_bounds__(T_THREADS, 1)" in src
    spec = MG.GMM_TILES[1]
    assert (c["T_BM"], c["T_BN"], c["T_BK"]) == \
        (spec.rows, spec.cols, spec.depth)
    assert c["T_THREADS"] == 3 * 128
    a, b = 2 * c["T_BM"] * c["T_BK"], 2 * c["T_BK"] * c["T_BN"]
    out = 2 * c["T_BM"] * c["T_BN"]
    assert MG.GMM_BWD_TMA == {
        "dx": MG.GmmBwdTile(c["DX_STAGES"], a + b, 0, 0),
        "dw": MG.GmmBwdTile(c["DW_STAGES"], a + b, out, 0),
        "dw_resident": MG.GmmBwdTile(c["DWR_STAGES"], a, out, 2 * b)}
    assert MG.RESIDENT_ROWS == 2 * c["T_BK"]
    for t in MG.GMM_BWD_TMA.values():
        assert t.stages >= 3
        assert t.stage_bytes % 1024 == 0    # each stage on the swizzle's
        assert t.smem_bytes <= MG.SMEM_LIMIT    # 1024-byte period
        assert t.smem_bytes + 1024 <= MG.SMEM_PER_SM
    launch_regs = 65536 // c["T_THREADS"] // 8 * 8
    assert 256 * c["CONSUMER_REGS"] + 128 * c["PRODUCER_REGS"] == \
        c["T_THREADS"] * launch_regs
    assert c["CONSUMER_REGS"] <= 255 and c["PRODUCER_REGS"] >= 24


def _walk_backward(x, w, dy, plan, stale_resident=False):
    """The two launches' algorithm in plain PyTorch, fp32: every block's
    items in its order, each the sum over its 64-deep ring steps (dx: over
    F, dw: over R) of the A tile times the B tile, zeros past the edges.
    Where ``plan.resident``, dw's B is the [R x 256] tile of dy a block
    loads at the first item of each unit and keeps for the unit's D
    tiles; ``stale_resident`` keeps the block's first unit's tile instead
    (the kernel's planted fault of the same name)."""
    spec = MG.GMM_TILES[1]
    E, R, D = x.shape
    F = w.shape[2]
    # launch dx: A = dy [R][F], B = w^T; launch dw: A = x^T, B = dy
    ops_ = ((plan.dx, dy, w.transpose(1, 2), R, D, F, False),
            (plan.dw, x.transpose(1, 2), dy, D, F, R, plan.resident))
    outs = []
    for walk, a, b, M, N, Kd, resident in ops_:
        k_steps = max(1, -(-Kd // spec.depth))
        out = torch.full((E, M, N), float("nan"))

        def b_tile(e, n0, k0):
            bt = torch.zeros(spec.depth, spec.cols)
            sb = b[e, k0:k0 + spec.depth, n0:n0 + spec.cols].float()
            bt[:sb.shape[0], :sb.shape[1]] = sb
            return bt
        for blk in range(walk.grid):
            held = None
            for j, (e, nt, mt) in enumerate(MG.plan_items(walk, blk)):
                m0, n0 = mt * spec.rows, nt * spec.cols
                if resident and j % walk.chunk == 0 and \
                        not (stale_resident and held is not None):
                    held = [b_tile(e, n0, ks * spec.depth)
                            for ks in range(k_steps)]
                acc = torch.zeros(spec.rows, spec.cols)
                for ks in range(k_steps):
                    k0 = ks * spec.depth
                    at = torch.zeros(spec.rows, spec.depth)
                    sa = a[e, m0:m0 + spec.rows, k0:k0 + spec.depth].float()
                    at[:sa.shape[0], :sa.shape[1]] = sa
                    acc += at @ (held[ks] if resident else b_tile(e, n0, k0))
                rows, cols = min(spec.rows, M - m0), min(spec.cols, N - n0)
                out[e, m0:m0 + rows, n0:n0 + cols] = acc[:rows, :cols]
        outs.append(out)
    return tuple(outs)


def _bwd_inputs(E, R, D, F):
    rng = np.random.default_rng(E + R + D + F)
    return tuple(torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                 for s in ((E, R, D), (E, D, F), (E, R, F)))


@pytest.mark.parametrize("sm", [3, 132])
@pytest.mark.parametrize("E,R,D,F", [(3, 37, 200, 72), (3, 5, 131, 67),
                                     (2, 150, 96, 300), (2, 128, 264, 520),
                                     (2, 200, 256, 512)])
def test_gmm_backward_walk_matches_plain(E, R, D, F, sm):
    """Both launches' walks (one and two M tiles, ragged edges, several
    items a block; dw with dy resident over two and three D tiles, and
    streamed past 128 rows) against the plain backward in fp32."""
    x, w, dy = _bwd_inputs(E, R, D, F)
    plan = MG.plan_gmm_backward(E, R, D, F, sm)
    got = _walk_backward(x, w, dy, plan)
    for a, b in zip(got, K.moe_gmm_backward_plain(x, w, dy)):
        assert not torch.isnan(a).any()
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-5)


def test_gmm_backward_walk_fails_the_check_with_a_stale_resident_tile():
    """dw keeping a block's first unit's dy tile for its later units (the
    kernel's planted fault ``FAULT_STALE_RESIDENT``) fails the check; dx
    is untouched."""
    E, R, D, F = 2, 128, 264, 520
    x, w, dy = _bwd_inputs(E, R, D, F)
    plan = MG.plan_gmm_backward(E, R, D, F, 2)
    assert plan.resident and plan.dw.grid * plan.dw.chunk < plan.dw.items
    dx, dw = _walk_backward(x, w, dy, plan, stale_resident=True)
    want = K.moe_gmm_backward_plain(x, w, dy)
    torch.testing.assert_close(dx, want[0], atol=1e-4, rtol=1e-5)
    assert not torch.allclose(dw, want[1], atol=1e-2, rtol=1e-2)


# (rows, D, itemsize): the served shapes of every family and the widest
NORM_SHAPES = [(2048, 2048, 2), (2048, 2048, 4), (4, 2048, 2), (4, 2048, 4),
               (300, 4096, 2), (300, 2048, 2), (300, 1024, 2), (4, 512, 2),
               (512, 512, 4), (2048, 8192, 4), (1, 8, 2), (37, 1032, 2),
               (5000, 1024, 2), (3, 8192, 2), (2, 16384, 2), (2, 8192, 4)]


@pytest.mark.parametrize("sm", [132, 7])
@pytest.mark.parametrize("rows,D,itemsize", NORM_SHAPES)
def test_rmsnorm_plan_covers_every_row_once(rows, D, itemsize, sm):
    plan = RN.plan_rmsnorm(rows, D, itemsize, sm)
    nvec = D * itemsize // 16
    assert plan.per_warp == (D * itemsize <= RN.WARP_ROW_BYTES)
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= 1024
    if plan.per_warp:
        assert 32 * plan.vecs >= nvec and plan.vecs in (1, 2, 4)
        rpb = plan.threads // 32
        assert rpb in (1, 2, 4, 8)
        # the grid-stride walk: warp k of block b takes rows b rpb + k,
        # + grid rpb, ...
        seen = [r for b in range(plan.grid) for k in range(rpb)
                for r in range(b * rpb + k, rows, plan.grid * rpb)]
        assert sorted(seen) == list(range(rows))
        assert plan.grid <= sm * min(32, 2048 // plan.threads)
    else:
        assert plan.threads * plan.vecs >= nvec > \
            (plan.threads - 32) * plan.vecs
        assert plan.vecs == 2 and plan.grid == rows


def test_rmsnorm_plan_reads_only_shapes_and_the_sm_count():
    params = list(inspect.signature(RN.plan_rmsnorm).parameters)
    assert params == ["rows", "D", "itemsize", "sm_count"]
    with pytest.raises(TypeError):
        RN.plan_rmsnorm(torch.tensor(4), 2048, 2, 132)
    with pytest.raises(TypeError):
        RN.plan_rmsnorm(4, 2048.0, 2, 132)
