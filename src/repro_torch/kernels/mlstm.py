"""Chunkwise mLSTM scan: a hand-written CUDA kernel and its plain version.

Replaces the TPU kernel ``repro/kernels/mlstm.py:mlstm_chunk_scan``
(Pallas) and computes what ``repro/models/xlstm.py:mlstm_forward``
computes between its gates and its output gate: over chunked views, the
intra-chunk masked ``q kᵀ v`` plus ``q C e^{cumf}``, normalised by
``max(|n|, 1)``, with the matrix memory C and the normaliser n carried
from chunk to chunk.  Unlike the Pallas kernel it also returns the final
(C, n), which the model keeps as its decode cache.

What bounds it on the H100: operations at xlstm-350m's widths (with bf16
q, k, v each product with an fp32 operand costs three bf16 products on
the tensor cores, a little more time than one read of q, k, v and one
write of y and the state).  The Pallas grid (B, nc) walks the chunks in order with
every head's C in one program (1 MiB a head at xlstm-350m's dh = 512).
The kernel (``csrc/mlstm_scan.cu``) regroups the caller's chunks into
kernel chunks of 64 rows (``mamba_scan.plan_scan``; cumf rebased,
``mamba_scan.rebase``) and runs in stages over (b, kernel chunk, head,
tile): the state entering each kernel chunk (one ordered pass per (b,
head, 64 x 64 tile of C)), the masked, decayed scores and their row sums
once per (b, kernel chunk, head), then the outputs per 32 value columns.
bf16 inputs run on the tensor cores, every fp32 operand split into three
bf16 parts (``mamba_scan.split_bf16``); fp32 inputs on the CUDA cores.
``mlstm_chunk_scan_staged`` is the same plan and stages in plain PyTorch,
for the CPU tests.

The gradient (``mlstm_chunk_scan_backward``, ``csrc/
mlstm_scan_backward.cu``) is registered as the op's autograd.  The TPU
kernel has no backward (the reference differentiates its pure-JAX
``xlstm.py`` scan); this one is the port's own.  The forward keeps its
schema and saves only y, so the backward recomputes the state (C, n)
entering each kernel chunk but the first and the normaliser, runs the
ordered pass backwards for the cotangent of the state leaving each but
the last, then per (b, kernel chunk, head, 64 columns) forms dq, dk and
dv and their parts of dg and dli, summed over the column tiles in order.
bf16 inputs run every product on the tensor cores, each fp32 operand
split into ``mamba_scan.BACKWARD_PARTS`` bf16 parts; fp32 inputs as
three TF32 products (3xTF32).  The rebase of cumf and its adjoint are launches of the
kernel too.  ``mlstm_chunk_scan_backward_staged`` is its plan and
rounding in plain PyTorch, for the CPU tests.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._sharding import placement_types as _sharding_types
from repro_torch.kernels._sharding import replicated
from repro_torch.kernels._build import plain_float
from repro_torch.kernels.mamba_scan import (FAULT_ONE_PART,
                                            FAULT_WRONG_COTANGENT,
                                            FAULT_WRONG_STATE, MAX_Q, _causal,
                                            _last_put, _valid_rows, chunked,
                                            last_rows, plan_scan, rebase,
                                            rebase_adjoint, split_bf16,
                                            split_product, unchunked)

SOURCE = "src/repro_torch/csrc/mlstm_scan.cu"
REPLACES = "src/repro/kernels/mlstm.py:54"
MAX_DH = 512


def mlstm_chunk_plain(q, k, v, cumf, li, C_prev, n_prev, *,
                      diagonal: int = 0):
    """One chunk, as ``repro/kernels/ref.py:mlstm_chunk``: q, k, v
    [B,Q,nh,dh]; cumf, li [B,Q,nh]; C_prev [B,nh,dh,dh]; n_prev [B,nh,dh]
    -> (y, C, n).  The causal mask keeps ``j <= i + diagonal`` (the
    model's is 0)."""
    Q = q.shape[1]
    q, k, v = plain_float(q), plain_float(k), plain_float(v)
    scores = torch.einsum("bihd,bjhd->bijh", q, k)
    decay = torch.exp(cumf[:, :, None] - cumf[:, None, :] + li[:, None])
    lmat = torch.where(_causal(Q, diagonal, q.device)[None, :, :, None],
                       decay, 0.0)
    y_diag = torch.einsum("bijh,bjhd->bihd", scores * lmat, v)
    n_diag = torch.einsum("bijh,bjhd->bihd", lmat, k)
    iw = torch.exp(cumf)
    y_off = torch.einsum("bihd,bhde->bihe", q, C_prev) * iw[..., None]
    n_off = torch.einsum("bihd,bhd->bih", q, n_prev) * iw
    n = (q * n_diag).sum(-1) + n_off
    y = (y_diag + y_off) / torch.clamp_min(n.abs()[..., None], 1.0)
    kbar = k * torch.exp(cumf[:, -1:] - cumf + li)[..., None]
    cd = torch.exp(cumf[:, -1])
    C = C_prev * cd[:, :, None, None] + torch.einsum("bjhd,bjhe->bhde",
                                                     kbar, v)
    n_new = n_prev * cd[..., None] + kbar.sum(1)
    return y, C, n_new


def mlstm_chunk_scan_plain(q, k, v, cumf, li, *, diagonal: int = 0):
    """The same function as the kernel in plain PyTorch (the CPU path and
    the oracle): ``mlstm_chunk_plain`` chained over the chunks.

    q, k, v [B,nc,Q,nh,dh]; cumf, li [B,nc,Q,nh] fp32 -> (y [B,nc,Q,nh,dh]
    fp32, C [B,nh,dh,dh] fp32, n [B,nh,dh] fp32)."""
    B, nc, Q, nh, dh = q.shape
    ft = torch.promote_types(q.dtype, torch.float32)
    C = q.new_zeros(B, nh, dh, dh, dtype=ft)
    n = q.new_zeros(B, nh, dh, dtype=ft)
    ys = []
    for c in range(nc):
        y, C, n = mlstm_chunk_plain(q[:, c], k[:, c], v[:, c], cumf[:, c],
                                    li[:, c], C, n, diagonal=diagonal)
        ys.append(y)
    return torch.stack(ys, 1), C, n


def mlstm_chunk_scan_staged(q, k, v, cumf, li, *, split: bool = False,
                            fault: int = 0):
    """The kernel's plan and stages in plain PyTorch, in fp32: the state
    entering each kernel chunk by one ordered pass, the masked, decayed
    scores and their row sums once per (b, kernel chunk, head), then the
    outputs.  With ``split`` the three products whose operand is fp32
    (w ⊙ k against v, P against v, q against C) see that operand as the
    bf16 kernel does (``split_bf16``); q kᵀ is exact from bf16 either
    way.  Same arguments and results as ``mlstm_chunk_scan_plain``;
    ``fault`` plants the kernel's faults."""
    B, nc, Q, nh, dh = q.shape
    plan = plan_scan(nc, Q)
    S, L, n = nc * Q, plan.chunk, plan.chunks
    sp = (lambda x: split_bf16(x, fault=fault)) if split else (lambda x: x)
    g = rebase(cumf, plan, fault=fault)                  # [B,n,L,nh]
    gl = last_rows(g, S)                                 # [B,n,nh]
    qc, kc, vc = (chunked(t.float(), plan) for t in (q, k, v))
    lic = chunked(li, plan)
    valid = _valid_rows(plan, S, g.device)               # [n,L]
    w = torch.exp(gl[:, :, None] - g + lic) * valid[None, :, :, None]
    C = q.new_zeros(B, nh, dh, dh, dtype=torch.float32)
    nv = q.new_zeros(B, nh, dh, dtype=torch.float32)
    Cin, nin = [], []
    for c in range(n):                                   # the ordered pass
        Cin.append(C)
        nin.append(nv)
        d = torch.exp(gl[:, c])
        kw = w[:, c, ..., None] * kc[:, c]
        C = C * d[..., None, None] + torch.einsum("bjhd,bjhe->bhde", sp(kw),
                                                  vc[:, c])
        nv = nv * d[..., None] + kw.sum(1)
    scores = torch.einsum("bcihd,bcjhd->bcijh", qc, kc)  # once per chunk
    decay = torch.exp(g[:, :, :, None] - g[:, :, None, :] + lic[:, :, None])
    keep = _causal(L, 0, g.device)[None] & valid[:, :, None]
    Pm = torch.where(keep[None, ..., None], scores * decay, 0.0)
    rowsum = Pm.sum(3)                                   # [B,n,L,nh]
    ys = []
    for c in range(n):
        src = c - 1 if fault & FAULT_WRONG_STATE else c
        eg = torch.exp(g[:, c])                          # [B,L,nh]
        num = torch.einsum("bijh,bjhe->bihe", sp(Pm[:, c]), vc[:, c])
        den = rowsum[:, c]
        if src > 0:
            num = num + torch.einsum("bihd,bhde->bihe", qc[:, c],
                                     sp(Cin[src])) * eg[..., None]
            den = den + torch.einsum("bihd,bhd->bih", qc[:, c],
                                     nin[src]) * eg
        ys.append(num / torch.clamp_min(den.abs()[..., None], 1.0))
    return unchunked(torch.stack(ys, 1), nc, Q), C, nv


@torch.library.custom_op("repro_torch::mlstm_chunk_scan", mutates_args=())
def _scan_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             cumf: torch.Tensor, li: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    raise NotImplementedError(
        f"mlstm_chunk_scan: no implementation on {q.device}")


@_scan_op.register_kernel("cpu")
def _scan_cpu(q, k, v, cumf, li):
    return mlstm_chunk_scan_plain(q, k, v, cumf, li)


@_scan_op.register_fake
def _scan_fake(q, k, v, cumf, li):
    B, _, _, nh, dh = q.shape
    f32 = torch.promote_types(q.dtype, torch.float32)
    return (torch.empty_like(q, dtype=f32), q.new_empty(B, nh, dh, dh,
                                                        dtype=f32),
            q.new_empty(B, nh, dh, dtype=f32))


_ARGTYPES = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 9 + [ctypes.c_void_p]


def _launch(q, k, v, cumf, li, fault: int = 0):
    """One call of the kernel on CUDA tensors (its two launches); a
    ``fault`` only plants a fault for the checks."""
    B, nc, Q, nh, dh = q.shape
    _build.require(q.dtype in _build.DTYPE_CODES and k.dtype == q.dtype
                   and v.dtype == q.dtype and cumf.dtype == torch.float32
                   and li.dtype == torch.float32,
                   f"mlstm_chunk_scan: dtypes {q.dtype}/{k.dtype}/{v.dtype}/"
                   f"{cumf.dtype}/{li.dtype}")
    _build.require(k.shape == q.shape and v.shape == q.shape
                   and cumf.shape == (B, nc, Q, nh) and li.shape == cumf.shape,
                   f"mlstm_chunk_scan: shapes {q.shape} {k.shape} {v.shape} "
                   f"{cumf.shape} {li.shape}")
    _build.require(all(t.is_contiguous() and t.device == q.device
                       for t in (q, k, v, cumf, li)),
                   "mlstm_chunk_scan: inputs must be contiguous on one device")
    _build.require(1 <= Q <= MAX_Q and 1 <= dh <= MAX_DH,
                   f"mlstm_chunk_scan: Q={Q}, dh={dh} not supported")
    _build.require(dh * q.element_size() % 16 == 0
                   and all(t.data_ptr() % 16 == 0 for t in (q, k, v)),
                   f"mlstm_chunk_scan: q, k, v rows of dh={dh} must be "
                   f"16-byte aligned")
    plan = plan_scan(nc, Q)
    f32 = torch.float32
    y = torch.empty_like(q, dtype=f32)
    C = q.new_empty(B, nh, dh, dh, dtype=f32)
    n = q.new_empty(B, nh, dh, dtype=f32)
    if y.numel() == 0:
        return y, C, n
    # scratch: the state entering each kernel chunk but the first; the
    # masked, decayed scores of each (b, kernel chunk, head), row sums.
    # Cin grows with the prompt: nh·dh²·4 bytes a kernel chunk and batch
    # row (4 MiB at xlstm-350m: 60 MiB at 1,024 tokens, 2 GiB at 32k)
    Cin = q.new_empty(plan.chunks - 1, B, nh, dh, dh, dtype=f32)
    nin = q.new_empty(plan.chunks - 1, B, nh, dh, dtype=f32)
    P = q.new_empty(B, plan.chunks, nh, plan.chunk, plan.chunk, dtype=f32)
    den = q.new_empty(B, plan.chunks, nh, plan.chunk, dtype=f32)
    fn = _build.entry("mlstm_chunk_scan_launch", _ARGTYPES)
    _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), cumf.data_ptr(),
                    li.data_ptr(), y.data_ptr(), C.data_ptr(), n.data_ptr(),
                    Cin.data_ptr(), nin.data_ptr(), P.data_ptr(),
                    den.data_ptr(), B, nc, Q, nh, dh, plan.chunk, plan.chunks,
                    _build.DTYPE_CODES[q.dtype], fault,
                    _build.stream_handle(q)),
                 "mlstm_chunk_scan")
    return y, C, n


@_scan_op.register_kernel("cuda")
def _scan_cuda(q, k, v, cumf, li):
    out = _launch(q, k, v, cumf, li)
    if out[0].numel():
        mlstm_chunk_scan.launches += 1
    return out


def mlstm_chunk_scan(q, k, v, cumf, li):
    """q, k, v [B,nc,Q,nh,dh]; cumf, li [B,nc,Q,nh] fp32 -> (y
    [B,nc,Q,nh,dh] fp32 normalised, C [B,nh,dh,dh] fp32, n [B,nh,dh]
    fp32).  CUDA tensors launch the kernel, CPU tensors take the plain
    version."""
    return _scan_op(q, k, v, cumf, li)


mlstm_chunk_scan.launches = 0    # kernel launches (CUDA path only)


# ------------------------------------------------------------- backward --
BACKWARD_SOURCE = "src/repro_torch/csrc/mlstm_scan_backward.cu"
BACKWARD_TILE = 64      # columns of d a block of launches 2 to 4 owns
# planted faults of the backward (csrc kFault*), for the checks only;
# FAULT_WRONG_COTANGENT (1) and FAULT_ONE_PART (4) are the SSD backward's
FAULT_DROP_TILE = 2     # the sum of dg's column-tile parts drops the last
FAULT_ROWS_DROP_TILE = 8     # launch 2's sum of the d tiles' scores drops
                             # the last tile
FAULT_STATE_DROP_TILE = 16   # the sum of <dC'_out, C'_in>'s tile parts
                             # drops the last tile


def _tile_parts(x: torch.Tensor, T: int) -> torch.Tensor:
    """x [..., dh] -> [..., T]: the sums over each 64-column tile."""
    x = torch.nn.functional.pad(x, (0, T * BACKWARD_TILE - x.shape[-1]))
    return x.reshape(*x.shape[:-1], T, BACKWARD_TILE).sum(-1)


def mlstm_chunk_scan_backward_staged(q, k, v, cumf, li, y, dy, dC=None,
                                     dn=None, *, parts=None, fault: int = 0):
    """The backward kernel's plan and stages in plain PyTorch, in fp32.
    Launches 1 and 3, the ordered passes, store only what is read: the
    state entering chunks 1..n−1 (chunk 0's is zero) and the cotangent
    leaving chunks 0..n−2 (the last chunk's is (dC, dn)), so neither forms
    the product of the chunk it ends on; launch 3 also forms <dC'_out,
    C'_in> of each chunk from its 64 x 64 tiles.  Launch 2 forms q kᵀ,
    dy vᵀ, q·n_in and dy·y per 64 columns of d and sums the tiles in
    order.  Launch 4 forms dq, dk (per 64 columns of d) and dv (per 64
    columns of e), each with its part of dg and dli, which launch 5 sums
    over the tiles in order.  With ``parts`` every product with an fp32
    operand sees it as the bf16 kernel does (``split_product``); q kᵀ is
    exact either way.  Same arguments and results as
    ``mlstm_chunk_scan_backward_plain``; ``fault`` plants the kernel's
    faults."""
    B, nc, Q, nh, dh = q.shape
    plan = plan_scan(nc, Q)
    S, L, n = nc * Q, plan.chunk, plan.chunks
    T = -(-dh // BACKWARD_TILE)
    if parts and fault & FAULT_ONE_PART:
        parts = 1
    sp = lambda eq, a, b: split_product(eq, a, b, parts)
    g = rebase(cumf.float(), plan)                       # [B,n,L,nh]
    gl = last_rows(g, S)                                 # [B,n,nh]
    qc, kc, vc, yc, dyc = (chunked(t.float(), plan)
                           for t in (q, k, v, y, dy))
    lic = chunked(li.float(), plan)
    rows = _valid_rows(plan, S, g.device)                # [n,L]
    valid = rows[None, :, :, None]
    ws = torch.exp(gl[:, :, None] - g + lic) * valid     # e^{gl-g_j+li_j}
    eg = torch.exp(g) * valid                            # e^{g_i}
    decay = torch.exp(gl)                                # [B,n,nh]
    zero = qc.new_zeros(B, nh, dh, dh)
    Cin, nin = [zero] * n, [zero[..., 0]] * n
    for c in range(n - 1):                               # launch 1
        kw = ws[:, c, ..., None] * kc[:, c]
        Cin[c + 1] = Cin[c] * decay[:, c, :, None, None] + sp(
            "bjhd,bjhe->bhde", kw, vc[:, c])
        nin[c + 1] = nin[c] * decay[:, c, :, None] + kw.sum(1)
    Cin, nin = torch.stack(Cin, 1), torch.stack(nin, 1)  # [B,n,nh,dh(,dh)]
    # launch 2: the d tiles' q kᵀ, dy vᵀ, q·n_in, dy·y summed in order
    drop = bool(fault & FAULT_ROWS_DROP_TILE)
    tiles = lambda f: sum((f(slice(BACKWARD_TILE * t, BACKWARD_TILE * (t + 1)))
                           for t in range(T - 1 if drop else T)),
                          torch.zeros_like(f(slice(0, 0))))
    Sc = tiles(lambda s: torch.einsum("bcihd,bcjhd->bcijh", qc[..., s],
                                      kc[..., s]))
    Dv = tiles(lambda s: sp("bcihd,bcjhd->bcijh", dyc[..., s], vc[..., s]))
    qn = tiles(lambda s: (qc[..., s] * nin[:, :, None, :, s]).sum(-1))
    dyy = tiles(lambda s: (dyc[..., s] * yc[..., s]).sum(-1))
    keep = (_causal(L, 0, g.device)[None] & rows[:, :, None])[
        None, ..., None]                                 # [1,n,L,L,1]
    w = torch.where(keep, torch.exp(g[:, :, :, None] - g[:, :, None, :]
                                    + lic[:, :, None]), 0.0)
    den = (w * Sc).sum(3) + eg * qn
    m = torch.clamp_min(den.abs(), 1.0)
    rs = 1.0 / m
    dden = torch.where(den.abs() > 1.0, -torch.sign(den) * dyy / m, 0.0)
    W1 = w * (rs[:, :, :, None] * Dv + dden[:, :, :, None])
    W2 = w * Sc
    A = W1 * Sc
    # launch 3: the cotangent leaving each chunk, from (dC, dn) backwards
    dCo = [None] * n
    dno = [None] * n
    dCo[n - 1] = zero if dC is None else dC.float()
    dno[n - 1] = zero[..., 0] if dn is None else dn.float()
    for c in range(n - 1, 0, -1):
        dCo[c - 1] = dCo[c] * decay[:, c, :, None, None] + sp(
            "bihd,bihe->bhde", qc[:, c],
            (eg * rs)[:, c, ..., None] * dyc[:, c])
        dno[c - 1] = dno[c] * decay[:, c, :, None] + torch.einsum(
            "bih,bihd->bhd", (eg * dden)[:, c], qc[:, c])
    dCo, dno = torch.stack(dCo, 1), torch.stack(dno, 1)
    st_tiles = torch.nn.functional.pad(
        dCo * Cin, (0, T * BACKWARD_TILE - dh, 0, T * BACKWARD_TILE - dh))
    st_tiles = st_tiles.reshape(B, n, nh, T, BACKWARD_TILE, T,
                                BACKWARD_TILE).sum((4, 6)).flatten(3)
    st_tiles[..., ::T] += _tile_parts(dno * nin, T)      # n: e tile 0's
    st = sum((st_tiles[..., i] for i in range(
        T * T - 1 if fault & FAULT_STATE_DROP_TILE else T * T)),
        torch.zeros_like(st_tiles[..., 0]))
    src = [min(c + 1, n - 1) if fault & FAULT_WRONG_COTANGENT else c
           for c in range(n)]
    dCs, dns = dCo[:, src], dno[:, src]
    # launch 4: dq, dk per d tile, dv per e tile
    cq = eg[..., None] * (rs[..., None] * sp("bcihe,bchde->bcihd", dyc, Cin)
                          + nin[:, :, None] * dden[..., None])
    dq = sp("bcijh,bcjhd->bcihd", W1, kc) + cq
    dks = ws[..., None] * (sp("bcjhe,bchde->bcjhd", vc, dCs)
                           + dns[:, :, None])
    dk = sp("bcijh,bcihd->bcjhd", W1, qc) + dks
    dv = sp("bcijh,bcihe->bcjhe", rs[:, :, :, None] * W2, dyc) + \
        ws[..., None] * sp("bcjhd,bchde->bcjhe", kc, dCs)
    # launch 5: dg, dli from the tiles' parts in order
    kept = T - 1 if fault & FAULT_DROP_TILE else T
    car = _tile_parts(qc * cq, T)[..., :kept].sum(-1)   # [B,n,L,nh]
    ks = _tile_parts(kc * dks, T)[..., :kept].sum(-1)
    dg = A.sum(3) - A.sum(2) + car - ks
    dg = _last_put(dg, S, decay * st + ks.sum(2))
    dli = A.sum(2) + ks
    return (unchunked(dq, nc, Q).to(q.dtype), unchunked(dk, nc, Q).to(k.dtype),
            unchunked(dv, nc, Q).to(v.dtype),
            rebase_adjoint(dg, plan, nc, Q).to(cumf.dtype),
            unchunked(dli, nc, Q).to(li.dtype))



def mlstm_chunk_scan_backward_plain(q, k, v, cumf, li, y, dy, dC=None,
                                    dn=None):
    """The gradient of ``mlstm_chunk_scan`` in plain PyTorch (the CPU path
    and the oracle), as an explicit reverse pass over the kernel's plan.
    The normaliser is one more value column: with v' = [v, 1] and the
    state C' = [C, n], den is num with v replaced by 1.  With m_i =
    max(|den_i|, 1) the cotangents of num and den are dy_i / m_i and
    -sign(den_i)·[|den_i| > 1]·(dy_i·y_i) / m_i (``y`` is the forward's
    output).  The state entering each kernel chunk is recomputed by the
    forward's ordered pass, the cotangent of the state leaving it by the
    same pass run backwards from (dC, dn) (zeros for None); then per
    chunk, with w_ij = e^{g_i−g_j+li_j} (j ≤ i), D_ij = dnum'_i·v'_j and
    w^s_j = e^{gl−g_j+li_j}:

        dq_i = Σ_j w_ij D_ij k_j + e^{g_i} C'_in dnum'_i
        dk_j = Σ_i w_ij D_ij q_i + w^s_j dC'_out v'_j
        dv_j = Σ_i w_ij (q_i·k_j) dnum_i + w^s_j k_jᵀ dC_out

    and dg from the intra-chunk, carried and state terms; li_j enters
    where −g_j does, so dli_j is the column part of dg_j with its sign
    flipped.  dcumf is dg through ``rebase``'s adjoint.
    -> (dq, dk, dv, dcumf, dli), each in its input's dtype."""
    B, nc, Q, nh, dh = q.shape
    plan = plan_scan(nc, Q)
    S, L, n = nc * Q, plan.chunk, plan.chunks
    ft = torch.promote_types(q.dtype, torch.float32)
    g = rebase(cumf.to(ft), plan)                        # [B,n,L,nh]
    gl = last_rows(g, S)                                 # [B,n,nh]
    qc, kc, vc, yc, dyc = (chunked(t.to(ft), plan) for t in (q, k, v, y, dy))
    lic = chunked(li.to(ft), plan)
    rows = _valid_rows(plan, S, g.device)                # [n,L]
    valid = rows[None, :, :, None]
    ws = torch.exp(gl[:, :, None] - g + lic) * valid     # e^{gl-g_j+li_j}
    eg = torch.exp(g) * valid                            # e^{g_i}
    decay = torch.exp(gl)                                # [B,n,nh]
    C = q.new_zeros(B, nh, dh, dh, dtype=ft)
    nv = q.new_zeros(B, nh, dh, dtype=ft)
    Cin, nin = [], []
    for c in range(n):                                   # forward pass
        Cin.append(C)
        nin.append(nv)
        C = C * decay[:, c, :, None, None] + torch.einsum(
            "bjh,bjhd,bjhe->bhde", ws[:, c], kc[:, c], vc[:, c])
        nv = nv * decay[:, c, :, None] + torch.einsum(
            "bjh,bjhd->bhd", ws[:, c], kc[:, c])
    Cin, nin = torch.stack(Cin, 1), torch.stack(nin, 1)  # [B,n,nh,dh(,dh)]
    keep = (_causal(L, 0, g.device)[None] & rows[:, :, None])[
        None, ..., None]                                 # [1,n,L,L,1]
    w = torch.where(keep, torch.exp(g[:, :, :, None] - g[:, :, None, :]
                                    + lic[:, :, None]), 0.0)
    Sc = torch.einsum("bcihd,bcjhd->bcijh", qc, kc)      # q_i · k_j
    den = (w * Sc).sum(3) + eg * torch.einsum("bcihd,bchd->bcih", qc, nin)
    m = torch.clamp_min(den.abs(), 1.0)
    dnum = dyc / m[..., None]
    dden = torch.where(den.abs() > 1.0,
                       -torch.sign(den) * (dyc * yc).sum(-1) / m, 0.0)
    dCo = torch.zeros_like(C) if dC is None else dC.to(ft)
    dno = torch.zeros_like(nv) if dn is None else dn.to(ft)
    dCout, dnout = [None] * n, [None] * n
    for c in reversed(range(n)):                         # reverse pass
        dCout[c], dnout[c] = dCo, dno
        dCo = dCo * decay[:, c, :, None, None] + torch.einsum(
            "bih,bihd,bihe->bhde", eg[:, c], qc[:, c], dnum[:, c])
        dno = dno * decay[:, c, :, None] + torch.einsum(
            "bih,bihd,bih->bhd", eg[:, c], qc[:, c], dden[:, c])
    dCout, dnout = torch.stack(dCout, 1), torch.stack(dnout, 1)
    D = torch.einsum("bcihe,bcjhe->bcijh", dnum, vc) + dden[:, :, :, None]
    W1, W2 = w * D, w * Sc
    A = W1 * Sc
    carq = torch.einsum("bchde,bcihe->bcihd", Cin, dnum) \
        + nin[:, :, None] * dden[..., None]              # C'_in dnum'_i
    dq = torch.einsum("bcijh,bcjhd->bcihd", W1, kc) + eg[..., None] * carq
    dks = ws[..., None] * (torch.einsum("bchde,bcjhe->bcjhd", dCout, vc)
                           + dnout[:, :, None])
    dk = torch.einsum("bcijh,bcihd->bcjhd", W1, qc) + dks
    dv = torch.einsum("bcijh,bcihe->bcjhe", W2, dnum) + ws[..., None] * \
        torch.einsum("bcjhd,bchde->bcjhe", kc, dCout)
    ks = (kc * dks).sum(-1)                              # [B,n,L,nh]
    dg = A.sum(3) - A.sum(2) + eg * (qc * carq).sum(-1) - ks
    st = decay * ((dCout * Cin).sum((-1, -2)) + (dnout * nin).sum(-1))
    dg = _last_put(dg, S, st + ks.sum(2))
    dli = A.sum(2) + ks
    return (unchunked(dq, nc, Q).to(q.dtype), unchunked(dk, nc, Q).to(k.dtype),
            unchunked(dv, nc, Q).to(v.dtype),
            rebase_adjoint(dg, plan, nc, Q).to(cumf.dtype),
            unchunked(dli, nc, Q).to(li.dtype))


@torch.library.custom_op("repro_torch::mlstm_chunk_scan_backward",
                         mutates_args=())
def _scan_bwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 cumf: torch.Tensor, li: torch.Tensor, y: torch.Tensor,
                 dy: torch.Tensor, dC: torch.Tensor, dn: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                            torch.Tensor, torch.Tensor]:
    raise NotImplementedError(
        f"mlstm_chunk_scan_backward: no implementation on {q.device}")


@_scan_bwd_op.register_kernel("cpu")
def _scan_bwd_cpu(q, k, v, cumf, li, y, dy, dC, dn):
    return _build.contiguous(
        mlstm_chunk_scan_backward_plain(q, k, v, cumf, li, y, dy, dC, dn))


@_scan_bwd_op.register_fake
def _scan_bwd_fake(q, k, v, cumf, li, y, dy, dC, dn):
    return tuple(torch.empty_like(t) for t in (q, k, v, cumf, li))


_BWD_ARGTYPES = [ctypes.c_void_p] * 28 + [ctypes.c_int] * 10 \
    + [ctypes.c_void_p]


def _launch_backward(q, k, v, cumf, li, y, dy, dC, dn, fault: int = 0):
    """One run of the backward kernel on CUDA tensors: eight launches
    (six with one kernel chunk), the rebase of cumf first and its adjoint
    last (``rebase``, ``rebase_adjoint``); ``fault`` plants a fault for
    the checks only.  Scratch: the rebased cumf and its gradient, the state
    entering each kernel chunk but the first and the cotangent leaving
    each but the last (the last chunk's is (dC, dn), read in place),
    nh·dh·(dh + 1)·4 bytes each a kernel chunk and batch row (4 MiB at
    xlstm-350m: 64 MiB for a train step's batch 8 of two kernel chunks);
    per (b, kernel chunk, head) each 64-column tile's q kᵀ and dy vᵀ (2
    MiB at dh 512) and the two weighted [64, 64] matrices; dg's parts per
    64 columns of d and <dC'_out, C'_in>'s per state tile."""
    B, nc, Q, nh, dh = q.shape
    f32 = torch.float32
    _build.require(q.dtype in _build.DTYPE_CODES and k.dtype == q.dtype
                   and v.dtype == q.dtype and all(
                       t.dtype == f32 for t in (cumf, li, y, dy, dC, dn)),
                   f"mlstm_chunk_scan_backward: dtypes {q.dtype}/{k.dtype}/"
                   f"{v.dtype} and {[str(t.dtype) for t in (cumf, li, y, dy, dC, dn)]}")
    _build.require(k.shape == q.shape and v.shape == q.shape
                   and y.shape == q.shape and dy.shape == q.shape
                   and cumf.shape == (B, nc, Q, nh) and li.shape == cumf.shape
                   and dC.shape == (B, nh, dh, dh) and dn.shape == (B, nh, dh),
                   f"mlstm_chunk_scan_backward: shapes {q.shape} {k.shape} "
                   f"{v.shape} {cumf.shape} {li.shape} {y.shape} {dy.shape} "
                   f"{dC.shape} {dn.shape}")
    _build.require(all(t.is_contiguous() and t.device == q.device
                       for t in (q, k, v, cumf, li, y, dy, dC, dn)),
                   "mlstm_chunk_scan_backward: inputs must be contiguous on "
                   "one device")
    _build.require(1 <= Q <= MAX_Q and 1 <= dh <= MAX_DH,
                   f"mlstm_chunk_scan_backward: Q={Q}, dh={dh} not supported")
    plan = plan_scan(nc, Q)
    L, n = plan.chunk, plan.chunks
    T = -(-dh // BACKWARD_TILE)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if q.numel() == 0:
        return dq, dk, dv, torch.zeros_like(cumf), torch.zeros_like(li)
    new = lambda *s: q.new_empty(*s, dtype=f32)
    g, dg = new(B, n, L, nh), new(B, n, L, nh)           # cumf rebased
    Cin, dCo = new(n - 1, B, nh, dh, dh), new(n - 1, B, nh, dh, dh)
    nin, dno = new(n - 1, B, nh, dh), new(n - 1, B, nh, dh)
    part, pv = new(B, n, nh, T, 2, L, L), new(B, n, nh, T, 2, L)
    W1, W2 = new(B, n, nh, L, L), new(B, n, nh, L, L)
    rows = new(4, B, n, nh, L)          # 1 / m, dden, rowA - colA, colA
    stp = new(B, n, nh, T * T)
    pq, pk = new(B, n, T, L, nh), new(B, n, T, L, nh)
    dcumf, dli = torch.empty_like(cumf), torch.empty_like(li)
    # 16-byte rows: cp.async; else the kernel's plain loads
    vec = int(dh * q.element_size() % 16 == 0 and dh % 4 == 0 and all(
        t.data_ptr() % 16 == 0 for t in (q, k, v, y, dy, dC, Cin, dCo)))
    fn = _build.entry("mlstm_chunk_scan_backward_launch", _BWD_ARGTYPES)
    ptrs = (q, k, v, cumf, li, y, dy, dC, dn, g, Cin, nin, dCo, dno, part,
            pv, W1, W2, rows, stp, pq, pk, dq, dk, dv, dg, dcumf, dli)
    _build.check(fn(*(t.data_ptr() for t in ptrs), B, nc * Q, Q, nh, dh, n,
                    T, _build.DTYPE_CODES[q.dtype], vec, fault,
                    _build.stream_handle(q)),
                 "mlstm_chunk_scan_backward")
    return dq, dk, dv, dcumf, dli


@_scan_bwd_op.register_kernel("cuda")
def _scan_bwd_cuda(q, k, v, cumf, li, y, dy, dC, dn):
    out = _launch_backward(q, k, v, cumf, li, y, dy, dC, dn)
    if q.numel():
        mlstm_chunk_scan_backward.launches += 1
    return out


def mlstm_chunk_scan_backward(q, k, v, cumf, li, y, dy, dC=None, dn=None):
    """(dq, dk, dv, dcumf, dli) of ``mlstm_chunk_scan(q, k, v, cumf, li)``
    -> (y, C, n) for the gradients dy, dC, dn (zeros for None); ``y`` is
    the forward's output.  CUDA tensors launch the kernel, CPU tensors
    take the plain version."""
    B, _, _, nh, dh = q.shape
    ft = torch.promote_types(q.dtype, torch.float32)
    if dC is None:
        dC = q.new_zeros(B, nh, dh, dh, dtype=ft)
    if dn is None:
        dn = q.new_zeros(B, nh, dh, dtype=ft)
    return _scan_bwd_op(q, k, v, cumf, li, y, dy.contiguous(),
                        dC.contiguous(), dn.contiguous())


mlstm_chunk_scan_backward.launches = 0   # kernel runs (CUDA path only)


def _setup_context(ctx, inputs, output):
    ctx.save_for_backward(*inputs, output[0])


def _backward(ctx, dy, dC, dn):
    return mlstm_chunk_scan_backward(*ctx.saved_tensors, dy, dC, dn)


torch.library.register_autograd("repro_torch::mlstm_chunk_scan", _backward,
                                setup_context=_setup_context)


# ------------------------------------------------------------- sharding --
def _sharding(q, k, v, cumf, li):
    """Batch or heads split; the chunk and row dims are never split (the
    (C, n) state is carried across them)."""
    S, R, _ = _sharding_types()
    return [([S(0)] * 3, [S(0)] * 5), ([S(3), S(1), S(1)], [S(3)] * 5),
            replicated(3, (q, k, v, cumf, li))]


def _backward_sharding(q, k, v, cumf, li, y, dy, dC, dn):
    """The forward's rows for the five gradients."""
    S, R, _ = _sharding_types()
    return [([S(0)] * 5, [S(0)] * 9), ([S(3)] * 5, [S(3)] * 7 + [S(1)] * 2),
            replicated(5, (q, k, v, cumf, li, y, dy, dC, dn))]


SHARDING = (("mlstm_chunk_scan", _sharding),
            ("mlstm_chunk_scan_backward", _backward_sharding))
