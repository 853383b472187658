"""Per-rank cost of a PyTorch step: flops, HBM bytes and collective wire
bytes, from the ops it dispatches or from its exported graph.

Counterpart of ``repro/analysis/hlo.py``.  The port has no HLO text; it
has two program forms, and one per-op cost table (``Counter.count``)
serves both:

* the ops a step dispatches, seen by a ``TorchDispatchMode`` while the
  step runs (``analyze``, ``trace``): on real tensors, or under
  ``FakeTensorMode`` over a fake process group on the production mesh
  (``launch/dryrun.py``);
* an ``ExportedProgram``'s graph, the recorder's (``analyze_exported``),
  run node by node on fake inputs of its placeholders' shapes.

Per op:

* flops -- aten products and convolutions by ``torch.utils.flop_counter``'s
  registered formulas (PyTorch's own, no kernel library's); each of the
  port's 12 custom ops (``repro_torch::*``) by a formula of the work its
  kernel must do (``CUSTOM``): causal attention counts each row's visible
  keys, decode counts each row's ``lengths`` (the whole cache where the
  lengths cannot be read: fake tensors), the chunk scans count the
  least-work chunking of their products at the peak of the dtype each
  runs at.  These are the operations ``chip_smoke.py``'s kernels phase
  bounds each kernel by.  Flops are kept by dtype (``flops_by_dtype``:
  "bfloat16", "tfloat32", "float32", ...), since an H100 runs them at
  peaks 15x apart; elementwise work counts no flops, as in the
  reference's HLO count (dots only), except inside a custom op's formula.
* bytes, in one of two modes:
  - ``"eager"`` (the counterpart of the reference's ``"final"``): every
    dispatched op's tensor inputs and outputs, which is what eager
    PyTorch moves; views, ``empty`` and ops that return no tensor move
    nothing;
  - ``"fused"`` (the counterpart of ``"spmd"``): elementwise, convert and
    broadcast chains are free (fused into their neighbours), reductions
    read their input once, gathers and slices write their output, scatters
    move their update twice, copies and concatenations move both sides,
    and a product's operands are traced back through convert, reshape,
    transpose and scale chains to their source (``_source_bytes``), so
    ``serving/quant.py``'s int8 weights count at int8 bytes.
  A custom op counts each operand read once and each output written once
  in both modes (a decode's caches only over the valid rows).
* collectives -- ``_c10d_functional`` all-gather, all-reduce,
  reduce-scatter and all-to-all (and DTensor's ``shard_dim_alltoall``)
  under the reference's names (``COLLECTIVES``), ring wire bytes a rank
  by ``_wire_bytes`` (the reference's), over the size of the process
  group the op names; each collective's bytes are also kept by the link
  level its group crosses (``roofline.link_of``).

Under DTensor a step's count is what one rank runs: the mode steps aside
for DTensor arguments (``NotImplemented``), so it sees each op's local
shards and the collectives DTensor's redistributions issue, and it does
not count the global-shape ops DTensor's sharding propagation runs on a
shape's first call (``ShardingPropagator._propagate_tensor_meta_non_cached``
is wrapped while a mode is active), so a first and a repeated call count
the same.  A host read of a fake scalar (AdamW's grad norm, lr and step)
reads 1.

The port's model loops over its layers in Python and exports no
``while_loop``, so no trip-count correction is needed (the reference's
``hlo.py`` multiplies ``while`` bodies by their trip counts).

``trace`` also follows the storage the step allocates (a weak reference
on each new storage, so autograd's saved tensors count while they live):
``peak_bytes`` is the peak of live storage allocated during the step, the
counterpart of XLA's temp plus fresh outputs.
"""
from __future__ import annotations

import contextlib
import dataclasses
import sys
import weakref
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.analysis import roofline as RF

aten = torch.ops.aten

_DTYPE_BYTES = {
    torch.bool: 1, torch.uint8: 1, torch.int8: 1, torch.int16: 2,
    torch.int32: 4, torch.int64: 8, torch.float16: 2, torch.bfloat16: 2,
    torch.float32: 4, torch.float64: 8, torch.complex64: 8,
    torch.complex128: 16,
    **{getattr(torch, n): 1 for n in ("float8_e4m3fn", "float8_e5m2",
                                      "float8_e4m3fnuz", "float8_e5m2fnuz")
       if hasattr(torch, n)},
}

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

MODES = ("eager", "fused")


def _nbytes(t) -> int:
    if not isinstance(t, torch.Tensor):
        return 0
    return t.numel() * _DTYPE_BYTES.get(t.dtype, t.element_size())


def peak_dtype(dtype: torch.dtype) -> str:
    """The name of the peak (``roofline.PEAK_OPS_S``) a product in
    ``dtype`` runs at on the card: fp32 products take TF32 where PyTorch
    allows it (``torch.get_float32_matmul_precision``)."""
    if dtype in (torch.bfloat16, torch.float16):
        return "bfloat16"
    if dtype == torch.float32:
        return "float32" if torch.get_float32_matmul_precision() == \
            "highest" else "tfloat32"
    if dtype == torch.float64:
        return "float64"
    if dtype in (torch.int8, torch.uint8):
        return "int8"
    if _DTYPE_BYTES.get(dtype) == 1:
        return "float8"
    return "float32"


# ----------------------------------------------------------------- Cost --
@dataclasses.dataclass
class Cost:
    flops: float = 0.0
    hbm_bytes: float = 0.0
    layout_bytes: float = 0.0   # the reference's entry-level layout copies;
    #                             an eager program makes none: always 0
    coll: Dict[str, float] = dataclasses.field(default_factory=dict)
    coll_count: Dict[str, int] = dataclasses.field(default_factory=dict)
    flops_by_dtype: Dict[str, float] = dataclasses.field(default_factory=dict)
    coll_by_link: Dict[str, float] = dataclasses.field(default_factory=dict)
    # {custom op name: {"count", "flops", "bytes"}}
    custom_ops: Dict[str, Dict[str, float]] = dataclasses.field(
        default_factory=dict)

    def add_flops(self, by_dtype: Dict[str, float]) -> None:
        for d, n in by_dtype.items():
            self.flops += n
            self.flops_by_dtype[d] = self.flops_by_dtype.get(d, 0.0) + n

    def add_collective(self, kind: str, wire: float, link: str) -> None:
        self.coll[kind] = self.coll.get(kind, 0.0) + wire
        self.coll_count[kind] = self.coll_count.get(kind, 0) + 1
        self.coll_by_link[link] = self.coll_by_link.get(link, 0.0) + wire

    @property
    def coll_bytes(self) -> float:
        return sum(self.coll.values())

    def as_dict(self):
        """The reference's keys, then the port's: flops by dtype, wire
        bytes by link level and each custom op's share."""
        return {"flops": self.flops, "hbm_bytes": self.hbm_bytes,
                "layout_bytes": self.layout_bytes,
                "coll_bytes": self.coll_bytes, "coll": dict(self.coll),
                "coll_count": dict(self.coll_count),
                "flops_by_dtype": dict(self.flops_by_dtype),
                "coll_by_link": dict(self.coll_by_link),
                "custom_ops": {k: dict(v) for k, v in self.custom_ops.items()}}


def _wire_bytes(kind: str, in_b: float, out_b: float, n: int) -> float:
    r = (n - 1) / n if n > 1 else 0.0
    if kind == "all-gather":
        return out_b * r
    if kind == "reduce-scatter":
        return in_b * r
    if kind == "all-reduce":
        return 2.0 * in_b * r
    if kind == "all-to-all":
        return max(in_b, out_b) * r
    return out_b  # collective-permute


# ------------------------------------------------------ custom op formulas --
def _visible_pairs(Sq: int, Sk: int, causal: bool, window: int,
                   q_offset: int) -> int:
    """Keys each query row sees, summed over rows (``flash_attention``'s
    mask: row i at position i + q_offset sees keys j <= it when causal,
    and j > it - window with a window)."""
    total = 0
    for p in range(q_offset, q_offset + Sq):
        hi = min(p, Sk - 1) if causal else Sk - 1
        lo = max(0, p - window + 1) if window else 0
        total += max(0, hi - lo + 1)
    return total


def _in_out_bytes(args, out) -> int:
    return sum(_nbytes(t) for t in pytree.tree_leaves((args, out)))


def _valid_rows(lengths, W: int) -> int:
    """Cache rows a decode reads: each row's ``lengths`` (at most W), or
    the whole cache where the lengths are fake."""
    from torch._subclasses.fake_tensor import FakeTensor
    B = lengths.shape[0]
    if isinstance(lengths, FakeTensor) or lengths.device.type == "meta":
        return B * W
    return int(lengths.long().clamp(0, W).sum())


def _rmsnorm(a, out):
    return {"float32": 4 * a["x"].numel()}, _in_out_bytes(a, out)


def _rmsnorm_backward(a, out):
    return {"float32": 12 * a["x"].numel()}, _in_out_bytes(a, out)


def _flash_pairs(a):
    q, k = a["q"], a["k"]
    return q.shape[0] * _visible_pairs(q.shape[1], k.shape[1], a["causal"],
                                       a["window"], a["q_offset"])


def _flash_attention(a, out):
    q, v = a["q"], a["v"]
    H, hd, hdv = q.shape[2], q.shape[3], v.shape[3]
    return ({peak_dtype(q.dtype): 2 * (hd + hdv) * H * _flash_pairs(a)},
            _in_out_bytes(a, out))


def _flash_attention_backward(a, out):
    """Five products over the visible pairs: S, dQ and dK over hd, dP and
    dV over hd_v."""
    q, v = a["q"], a["v"]
    H, hd, hdv = q.shape[2], q.shape[3], v.shape[3]
    return ({peak_dtype(q.dtype): 2 * (3 * hd + 2 * hdv) * H
             * _flash_pairs(a)}, _in_out_bytes(a, out))


def _decode(a, out, cache_keys):
    q, kc, vc = a["q"], a["k_cache"], a["v_cache"]
    B, H, hd = q.shape
    W, hdv = kc.shape[1], vc.shape[3]
    n_valid = _valid_rows(a["lengths"], W)
    row = lambda t: _nbytes(t) // max(B * W, 1)     # bytes of one cache row
    nbytes = _nbytes(q) + _nbytes(out) + _nbytes(a["lengths"]) + \
        n_valid * sum(row(a[k]) for k in cache_keys)
    return {peak_dtype(q.dtype): 2 * (hd + hdv) * H * n_valid}, nbytes


def _decode_attention(a, out):
    return _decode(a, out, ("k_cache", "v_cache"))


def _decode_attention_int8(a, out):
    return _decode(a, out, ("k_cache", "v_cache", "k_scale", "v_scale"))


def _moe_gmm(a, out):
    x, w = a["x"], a["w"]
    E, R, D = x.shape
    return ({peak_dtype(x.dtype): 2 * E * R * D * w.shape[2]},
            _in_out_bytes(a, out))


def _moe_gmm_backward(a, out):
    x, w = a["x"], a["w"]
    E, R, D = x.shape
    return ({peak_dtype(x.dtype): 4 * E * R * D * w.shape[2]},
            _in_out_bytes(a, out))


def least_ops(count: Callable, B: int, S: int) -> Dict[str, float]:
    """The operations ``count(chunks, pairs)`` of a scan over B rows of S
    steps cut into chunks of L rows (the last shorter), at the L from 1
    (the recurrent form) to the kernel's 64 whose work takes the least
    time at the peaks.  Every such cut computes the same scan (the
    kernel's own plan regroups the caller's chunks), so the least work of
    any of them bounds it."""
    def at(L):
        full, rest = divmod(S, L)
        return count(B * (full + (rest > 0)),
                     B * (full * L * (L + 1) + rest * (rest + 1)) // 2)
    return min((at(L) for L in range(1, 65)), key=RF.compute_time)


def _scan_parts(backward: bool) -> int:
    import importlib
    MS = importlib.import_module("repro_torch.kernels.mamba_scan")
    return MS.BACKWARD_PARTS if backward else MS.SPLIT_PARTS


def _mamba_chunk_scan(a, out):
    """Per row the carried term and the state update (split products with
    the fp32 state), per causal pair C Bᵀ (exact in bf16) and the decayed
    scores times x̄ (fp32)."""
    xbar, Bc = a["xbar"], a["B_c"]
    B, nc, Q, nh, P = xbar.shape
    N = Bc.shape[-1]
    rows, bf16 = B * nc * Q, Bc.dtype != torch.float32
    parts = _scan_parts(False)

    def ops(chunks, pairs):
        exact, fp32 = 2 * pairs * N, 2 * pairs * nh * P
        split = 2 * 2 * rows * nh * P * N
        if not bf16:
            return {"float32": exact + fp32 + split}
        return {"bfloat16": exact + parts * split, "float32": fp32}
    return least_ops(ops, B, nc * Q), _in_out_bytes(a, out)


def _mlstm_chunk_scan(a, out):
    q = a["q"]
    B, nc, Q, nh, dh = q.shape
    rows, bf16 = B * nc * Q, q.dtype != torch.float32
    parts = _scan_parts(False)

    def ops(chunks, pairs):
        exact, fp32 = 2 * nh * pairs * dh, 2 * nh * pairs
        split = 2 * nh * (pairs * dh + 2 * rows * dh * dh + rows * dh)
        if not bf16:
            return {"float32": exact + fp32 + split}
        return {"bfloat16": exact + parts * split, "float32": fp32}
    return least_ops(ops, B, nc * Q), _in_out_bytes(a, out)


def _scan_backward_ops(count, B, S, bf16):
    """{dtype: operations} of a scan backward from ``count(chunks, pairs)``
    -> (exact, one fp32 operand, two fp32 operands, fp32 dots): fp32
    inputs run every product as three TF32 products; bf16 inputs run a
    product with one fp32 operand as ``parts`` bf16 products and one of
    two as parts·(parts + 1)/2."""
    parts = _scan_parts(True)

    def ops(chunks, pairs):
        exact, one, two, dots = count(chunks, pairs)
        if not bf16:
            return {"tfloat32": 3 * (exact + one + two), "float32": dots}
        return {"bfloat16": exact + parts * one
                + parts * (parts + 1) // 2 * two, "float32": dots}
    return least_ops(ops, B, S)


def _mamba_chunk_scan_backward(a, out):
    xbar, Bc = a["xbar"], a["B_c"]
    B, nc, Q, nh, P = xbar.shape
    N, rows = Bc.shape[-1], B * nc * Q

    def count(chunks, pairs):
        return (2 * pairs * N,
                2 * (3 * rows * nh * P * N + 2 * pairs * nh * N),
                2 * (2 * rows * nh * P * N + 2 * pairs * nh * P),
                2 * chunks * nh * P * N)
    return (_scan_backward_ops(count, B, nc * Q, Bc.dtype != torch.float32),
            _in_out_bytes(a, out))


def _mlstm_chunk_scan_backward(a, out):
    q = a["q"]
    B, nc, Q, nh, dh = q.shape
    rows = B * nc * Q

    def count(chunks, pairs):
        return (2 * nh * pairs * dh,
                2 * nh * (3 * rows * dh * (dh + 1) + rows * dh * dh
                          + 3 * pairs * dh),
                2 * nh * (rows * dh * (dh + 1) + pairs * dh),
                2 * nh * chunks * dh * (dh + 1))
    return (_scan_backward_ops(count, B, nc * Q, q.dtype != torch.float32),
            _in_out_bytes(a, out))


# name -> formula(bound args, out) -> ({dtype: operations}, bytes)
CUSTOM = {
    "rmsnorm": _rmsnorm,
    "rmsnorm_backward": _rmsnorm_backward,
    "flash_attention": _flash_attention,
    "flash_attention_backward": _flash_attention_backward,
    "decode_attention": _decode_attention,
    "decode_attention_int8": _decode_attention_int8,
    "moe_gmm": _moe_gmm,
    "moe_gmm_backward": _moe_gmm_backward,
    "mamba_chunk_scan": _mamba_chunk_scan,
    "mamba_chunk_scan_backward": _mamba_chunk_scan_backward,
    "mlstm_chunk_scan": _mlstm_chunk_scan,
    "mlstm_chunk_scan_backward": _mlstm_chunk_scan_backward,
}


def _bind(func, args, kwargs) -> Dict[str, Any]:
    """An op's arguments by their schema names."""
    schema = func._schema.arguments
    bound = {a.name: v for a, v in zip(schema, args)}
    bound.update(kwargs)
    for a in schema:
        if a.name not in bound and a.has_default_value():
            bound[a.name] = a.default_value
    return bound


def custom_op_cost(func, args, kwargs, out) -> Tuple[Dict[str, float], int]:
    """({dtype: operations}, bytes) of one call of a ``repro_torch::`` op."""
    return CUSTOM[_op_name(func)](_bind(func, args, kwargs), out)


# ---------------------------------------------------------- op categories --
def _op_name(func) -> str:
    return func.name().split("::", 1)[1].split(".", 1)[0]


def _namespace(func) -> str:
    return func.name().split("::", 1)[0]


_COLL_NAMESPACES = ("_c10d_functional", "_c10d_functional_autograd",
                    "c10d_functional", "_dtensor")


def _collective_kind(func) -> Optional[str]:
    if _namespace(func) not in _COLL_NAMESPACES:
        return None
    name = _op_name(func)
    if "all_gather" in name:
        return "all-gather"
    if "reduce_scatter" in name:
        return "reduce-scatter"
    if "all_reduce" in name:
        return "all-reduce"
    if "all_to_all" in name or "alltoall" in name:
        return "all-to-all"
    if "permute" in name or "broadcast" in name:
        return "collective-permute"
    return None     # wait_tensor and the like: no traffic of their own


def _group_ranks(func, args, kwargs, num_devices: int) -> List[int]:
    """The global ranks of the process group a collective names (its
    ``group_name`` argument), or ``range(num_devices)``."""
    name = _bind(func, args, kwargs).get("group_name")
    if isinstance(name, str):
        import torch.distributed as dist
        from torch.distributed.distributed_c10d import _resolve_process_group
        try:
            return list(dist.get_process_group_ranks(
                _resolve_process_group(name)))
        except (ValueError, RuntimeError, KeyError):
            pass
    return list(range(max(num_devices, 1)))


def _is_view(func) -> bool:
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


_FREE = {aten.empty.memory_format, aten.empty_strided.default,
         aten.empty_like.default, aten.new_empty.default,
         aten.new_empty_strided.default, aten._local_scalar_dense.default}

# "fused": the categories of the reference's spmd mode (hlo.py:195-202)
_FUSED_INOUT = {aten.cat, aten.constant_pad_nd, aten.flip, aten.sort,
                aten.clone, aten.copy, aten.copy_, aten.roll, aten.repeat,
                aten.topk}
_FUSED_OUT_ONLY = {aten.index, aten.gather, aten.index_select,
                   aten.embedding, aten.take_along_dim}
_FUSED_UPDATE = {aten.index_put, aten.index_put_, aten.scatter,
                 aten.scatter_, aten.scatter_add, aten.scatter_add_,
                 aten.slice_scatter, aten.select_scatter, aten.index_add,
                 aten.index_add_, aten.index_copy, aten.index_copy_,
                 aten.masked_scatter}
_FUSED_REDUCE = {aten.sum, aten.mean, aten.amax, aten.amin, aten.max,
                 aten.min, aten.argmax, aten.argmin, aten.logsumexp,
                 aten._softmax, aten._log_softmax, aten.var_mean, aten.var,
                 aten.linalg_vector_norm, aten.cumsum, aten.prod, aten.any,
                 aten.all, aten.norm}
# the elementwise producer chain of a product's operand (_source_bytes)
_CHAIN = {aten._to_copy, aten.view, aten._unsafe_view, aten.reshape,
          aten.t, aten.transpose, aten.permute, aten.expand, aten.clone,
          aten.alias, aten.unsqueeze, aten.squeeze, aten.contiguous,
          aten._reshape_alias, aten.detach}

_CHAIN_DEPTH = 6     # producers the reference's _source_bytes walks back

_UPDATE_ARG = {"index_put": "values", "index_put_": "values",
               "scatter": "src", "scatter_": "src", "scatter_add": "src",
               "scatter_add_": "src", "slice_scatter": "src",
               "select_scatter": "src", "index_add": "source",
               "index_add_": "source", "index_copy": "source",
               "index_copy_": "source", "masked_scatter": "source"}


def _flop_formula(func):
    from torch.utils.flop_counter import flop_registry
    return flop_registry.get(func.overloadpacket)


def _tensors(tree) -> List[torch.Tensor]:
    return [t for t in pytree.tree_leaves(tree) if isinstance(t, torch.Tensor)]


# ------------------------------------------------------------- Counter --
class Counter:
    """The per-op cost table applied op by op (``count``), with the
    producer chains the ``"fused"`` mode traces products through."""

    def __init__(self, num_devices: int = 1, mode: str = "eager"):
        if mode not in MODES:
            raise ValueError(f"mode {mode!r} not in {MODES}")
        self.num_devices = num_devices
        self.mode = mode
        self.cost = Cost()
        self.collectives: List[tuple] = []     # (wire bytes, kind, shape,
        #                                        group size, link)
        # tensor -> the bytes along its elementwise producer chain, itself
        # first (at most _CHAIN_DEPTH producers back)
        self._chains = WeakIdKeyDictionary()

    def _chain(self, t) -> tuple:
        return self._chains.get(t, (_nbytes(t),))

    def _record_producer(self, func, args, out) -> None:
        """Extend the producer chain to ``out`` where ``func`` is a link
        of one (convert, reshape, transpose, copy, broadcast, or a
        multiply by a scale at most a quarter of the other operand)."""
        packet = func.overloadpacket
        ins = [a for a in args if isinstance(a, torch.Tensor)]
        if packet is aten.mul and len(ins) == 2:
            b0, b1 = _nbytes(ins[0]), _nbytes(ins[1])
            if min(b0, b1) * 4 > max(b0, b1):       # not a scale factor
                return
            src = ins[0] if b0 >= b1 else ins[1]
        elif packet in _CHAIN and ins:
            src = ins[0]
        else:
            return
        for o in _tensors(out):
            self._chains[o] = ((_nbytes(o),) + self._chain(src))[
                :_CHAIN_DEPTH + 1]

    def _source_bytes(self, t) -> int:
        """Min bytes along the elementwise producer chain of ``t`` -- the
        reference's ``_source_bytes``: fused streaming reads (dequant,
        upcasts) count at their source's bytes."""
        return min((b for b in self._chain(t) if b), default=_nbytes(t))

    def count(self, func, args, kwargs, out) -> None:
        """Add one dispatched op (its tensor args and outputs real, fake
        or export's meta values) to ``self.cost``."""
        c = self.cost
        if self.mode == "fused":
            self._record_producer(func, args, out)
        if _namespace(func) == "repro_torch":
            flops, nbytes = custom_op_cost(func, args, kwargs, out)
            c.add_flops(flops)
            c.hbm_bytes += nbytes
            row = c.custom_ops.setdefault(
                _op_name(func), {"count": 0, "flops": 0.0, "bytes": 0.0})
            row["count"] += 1
            row["flops"] += sum(flops.values())
            row["bytes"] += nbytes
            return
        kind = _collective_kind(func)
        outs = _tensors(out)
        if kind is not None:
            in_b = sum(map(_nbytes, _tensors((args, kwargs))))
            out_b = sum(map(_nbytes, outs))
            ranks = _group_ranks(func, args, kwargs, self.num_devices)
            wb = _wire_bytes(kind, in_b, out_b, len(ranks))
            link = RF.link_of(ranks)
            c.add_collective(kind, wb, link)
            c.hbm_bytes += in_b + out_b
            self.collectives.append(
                (wb, kind, tuple(outs[0].shape) if outs else (), len(ranks),
                 link))
            return
        formula = _flop_formula(func)
        if formula is not None:
            ins = _tensors((args, kwargs))
            c.add_flops({peak_dtype(ins[0].dtype):
                         float(formula(*args, **kwargs, out_val=out))})
            if self.mode == "fused":
                c.hbm_bytes += sum(self._source_bytes(a) for a in ins) + \
                    sum(map(_nbytes, outs))
            else:
                c.hbm_bytes += sum(map(_nbytes, ins + outs))
            return
        if not outs or func in _FREE or _is_view(func):
            return
        if self.mode == "eager":
            c.hbm_bytes += sum(map(_nbytes, _tensors((args, kwargs)) + outs))
            return
        packet = func.overloadpacket
        if packet in _FUSED_OUT_ONLY:
            c.hbm_bytes += sum(map(_nbytes, outs))
        elif packet in _FUSED_UPDATE:
            upd = _bind(func, args, kwargs).get(_UPDATE_ARG[_op_name(func)])
            c.hbm_bytes += 2 * (_nbytes(upd) if isinstance(
                upd, torch.Tensor) else sum(map(_nbytes, outs)))
        elif packet in _FUSED_REDUCE:
            c.hbm_bytes += sum(map(_nbytes, _tensors((args, kwargs))))
        elif packet in _FUSED_INOUT:
            c.hbm_bytes += sum(map(_nbytes, _tensors((args, kwargs)) + outs))
        # elementwise / convert / broadcast: fused, free


# ------------------------------------------------- the dispatched walker --
def _dtensor_type():
    mod = sys.modules.get("torch.distributed.tensor")
    return getattr(mod, "DTensor", None) if mod is not None else None


class CostMode(TorchDispatchMode):
    """Counts every op dispatched under it with a ``Counter`` of each byte
    mode (``counters``; ``counter`` is ``mode``'s) and follows the storage
    the ops allocate (module docstring)."""

    def __init__(self, num_devices: int = 1, mode: str = "eager"):
        super().__init__()
        self.counters = {m: Counter(num_devices, m) for m in MODES}
        self.counter = self.counters[mode]
        self._propagating = 0
        self._live: Dict[int, int] = {}       # storage id -> bytes
        self.live_bytes = 0
        self.peak_bytes = 0
        self._patched = None

    # DTensor's sharding propagation: not this rank's work
    def _wrap_propagator(self):
        if _dtensor_type() is None:
            return
        from torch.distributed.tensor._sharding_prop import ShardingPropagator
        name = "_propagate_tensor_meta_non_cached"
        orig = getattr(ShardingPropagator, name, None)
        if orig is None:
            raise RuntimeError(
                f"cost: this torch ({torch.__version__}) has no "
                f"ShardingPropagator.{name}; DTensor's propagation would be "
                "counted as the rank's work")
        mode = self

        def wrapped(prop, *a, **kw):
            mode._propagating += 1
            try:
                return orig(prop, *a, **kw)
            finally:
                mode._propagating -= 1
        setattr(ShardingPropagator, name, wrapped)
        self._patched = (ShardingPropagator, name, orig)

    def __enter__(self):
        self._wrap_propagator()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            if self._patched is not None:
                cls, name, orig = self._patched
                setattr(cls, name, orig)
                self._patched = None

    def _free(self, key: int) -> None:
        self.live_bytes -= self._live.pop(key, 0)

    def _track(self, args, out) -> None:
        ins = set()
        for t in _tensors(args):
            with contextlib.suppress(RuntimeError, NotImplementedError):
                ins.add(t.untyped_storage()._cdata)
        for t in _tensors(out):
            try:
                st = t.untyped_storage()
            except (RuntimeError, NotImplementedError):
                continue
            key = st._cdata
            if key in ins or key in self._live:
                continue
            n = st.nbytes()
            self._live[key] = n
            self.live_bytes += n
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
            weakref.finalize(st, self._free, key)

    def fresh_bytes(self, tree) -> int:
        """Bytes of the storages of ``tree``'s tensors that the step
        allocated and that are still live."""
        seen, total = set(), 0
        for t in _local_tensors(tree):
            key = t.untyped_storage()._cdata
            if key in self._live and key not in seen:
                seen.add(key)
                total += self._live[key]
        return total

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self._propagating:
            return func(*args, **kwargs)
        DT = _dtensor_type()
        if DT is not None and any(isinstance(t, DT) for t in
                                  pytree.tree_leaves((args, kwargs))):
            return NotImplemented
        if func is aten._local_scalar_dense.default:
            from torch._subclasses.fake_tensor import FakeTensor
            if isinstance(args[0], FakeTensor):
                return 1.0 if args[0].is_floating_point() else 1
        out = func(*args, **kwargs)
        for c in self.counters.values():
            c.count(func, args, kwargs, out)
        self._track((args, kwargs), out)
        return out


def _local_tensors(tree) -> List[torch.Tensor]:
    """The tensors of ``tree``, a DTensor as its local shard."""
    DT = _dtensor_type()
    out = []
    for t in _tensors(tree):
        out.append(t.to_local() if DT is not None and isinstance(t, DT)
                   else t)
    return out


def _storage_bytes(tree, keep=None) -> int:
    """Bytes of the distinct storages of ``tree``'s tensors on this rank
    (a DTensor: its local shard's), those in ``keep`` (storage ids) only
    if given.  A view counts the whole storage it holds alive."""
    seen, total = set(), 0
    for t in _local_tensors(tree):
        st = t.untyped_storage()
        key = st._cdata
        if key not in seen and (keep is None or key in keep):
            seen.add(key)
            total += st.nbytes()
    return total


def tree_bytes(tree) -> int:
    """Bytes of the distinct storages ``tree``'s tensors hold on this rank
    (a DTensor: its local shard's; a view: its whole storage)."""
    return _storage_bytes(tree)


def shared_bytes(tree, other) -> int:
    """Bytes of ``tree``'s distinct storages that ``other`` also holds
    (on this rank): what a step's outputs reuse of its inputs."""
    return _storage_bytes(tree, {t.untyped_storage()._cdata
                                 for t in _local_tensors(other)})


@dataclasses.dataclass
class Trace:
    """One traced call: its output, its cost in ``mode`` (``costs``: in
    every byte mode), and the peak of live storage it allocated
    (``peak_bytes``), of which ``fresh_out_bytes`` is still held by the
    output."""
    out: Any
    cost: Cost
    costs: Dict[str, Cost]
    peak_bytes: int
    fresh_out_bytes: int
    collectives: List[tuple]


def trace(fn, args, kwargs=None, *, num_devices: int = 1,
          mode: str = "eager") -> Trace:
    """Run ``fn(*args, **kwargs)`` once under a ``CostMode``."""
    cm = CostMode(num_devices, mode)
    with cm:
        out = fn(*args, **(kwargs or {}))
    return Trace(out, cm.counter.cost,
                 {m: c.cost for m, c in cm.counters.items()},
                 cm.peak_bytes, cm.fresh_bytes(out), cm.counter.collectives)


def analyze(fn, args, num_devices: int = 1, mode: str = "eager",
            kwargs=None) -> Dict:
    """Per-rank cost of one call of ``fn(*args)`` (``Cost.as_dict()``)."""
    return trace(fn, args, kwargs, num_devices=num_devices,
                 mode=mode).cost.as_dict()


def top_collectives(fn, args, num_devices: int = 1, k: int = 20):
    """Debug: the largest collectives of one call, by wire bytes a rank:
    (wire bytes, kind, output shape, group size, link level)."""
    rows = trace(fn, args, num_devices=num_devices).collectives
    return sorted(rows, reverse=True)[:k]


# --------------------------------------------------- the exported walker --
def analyze_exported(ep, num_devices: int = 1, mode: str = "eager") -> Dict:
    """Per-rank cost of an ``ExportedProgram``: its graph run node by node
    (``torch.fx.Interpreter``) on fake inputs of its placeholders' shapes
    and dtypes, under a ``CostMode``, so each node's op is priced by the
    same table as a dispatched step (a composite node, ``einsum``, by the
    ops it decomposes into).  Nothing is allocated or computed."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    fm = FakeTensorMode(allow_non_fake_inputs=True)
    with fm:
        flat = []
        for node in ep.graph.nodes:
            if node.op != "placeholder":
                continue
            v = node.meta.get("val")
            flat.append(torch.empty_strided(
                v.shape, v.stride(), dtype=v.dtype, device=v.device)
                if isinstance(v, torch.Tensor) else v)
    cm = CostMode(num_devices, mode)
    with fm, cm:
        torch.fx.Interpreter(ep.graph_module).run(*flat)
    return cm.counter.cost.as_dict()


__all__ = ["COLLECTIVES", "MODES", "CUSTOM", "Cost", "Counter", "CostMode",
           "Trace", "trace", "analyze", "analyze_exported", "top_collectives",
           "custom_op_cost", "least_ops", "peak_dtype", "tree_bytes",
           "shared_bytes"]
