"""Roofline terms for one NVIDIA H100 from a step's per-rank cost.

Counterpart of ``repro/analysis/roofline.py``, with the H100's rates in
place of the TPU v5e's:

    T_compute    = sum over dtypes of flops_at_dtype / PEAK_OPS_S[dtype]
    T_memory     = hbm_bytes_per_rank / HBM_BW
    T_collective = sum over link levels of wire_bytes / LINK_BW[level]

flops / bytes come from ``repro_torch.analysis.cost`` (per rank: one
rank's local shards and its collectives); MODEL_FLOPS is the analytic
6ND / 2ND budget (``analytic_model_flops``, the reference's verbatim), so
the MODEL/counted ratio exposes remat and dispatch waste.

Sources of the constants:

* ``PEAK_OPS_S``: NVIDIA's H100 data sheet, SXM part, dense rates
  without sparsity, at the full 700 W power limit: 989e12 bf16 / fp16,
  495e12 TF32, 67e12 fp32 outside the tensor cores, 67e12 fp64 on the
  tensor cores, 1,979e12 int8 and fp8.  These are the rates
  ``chip_smoke.py`` bounds its kernels by.  A card set below 700 W
  (``nvidia-smi --query-gpu=power.limit``) runs slower under load.
* ``HBM_BW``: the same data sheet, 3.35e12 bytes/s of HBM3 (80 GB part).
* ``LINK_BW``: per GPU and per direction.  ``"nvlink"``: 450e9 bytes/s,
  NVLink 4's 900 GB/s bidirectional on the HGX H100 board, for a group
  whose ranks share one node of ``GPUS_PER_NODE`` = 8 GPUs.
  ``"network"``: 50e9 bytes/s, one 400 Gb/s NDR InfiniBand link a GPU, for
  a group that spans nodes.  Ranks are laid out row-major, 8 to a node,
  so the 16-wide ``model`` axis of both production meshes spans two
  nodes.

No TPU figure remains.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.models.config import ModelConfig

PEAK_OPS_S = {"bfloat16": 989e12, "tfloat32": 495e12, "float32": 67e12,
              "float64": 67e12, "int8": 1979e12, "float8": 1979e12}
PEAK_FLOPS = PEAK_OPS_S["bfloat16"]   # MFU's denominator, as the reference's
HBM_BW = 3.35e12                      # bytes/s / GPU
LINK_BW = {"nvlink": 450e9, "network": 50e9}   # bytes/s / GPU / direction
GPUS_PER_NODE = 8


def link_of(ranks) -> str:
    """The link level a collective over the global ``ranks`` crosses:
    "nvlink" when all share one node (ranks row-major, GPUS_PER_NODE a
    node), else "network"."""
    return "nvlink" if len({r // GPUS_PER_NODE for r in ranks}) <= 1 \
        else "network"


def compute_time(flops_by_dtype: Dict[str, float]) -> float:
    """Seconds for ``{dtype name: operations}`` at each dtype's peak."""
    return sum(n / PEAK_OPS_S[d] for d, n in flops_by_dtype.items())


@dataclasses.dataclass
class Roofline:
    t_compute: float
    t_memory: float
    t_collective: float
    flops: float
    hbm_bytes: float
    coll_bytes: float
    model_flops_per_chip: float

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def step_time(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def roofline_fraction(self) -> float:
        """How close the cell is to compute-bound (compute roofline)."""
        t = self.step_time
        return self.t_compute / t if t else 0.0

    @property
    def model_flops_ratio(self) -> float:
        """MODEL_FLOPS / counted flops -- 'useful' fraction of the step's
        compute."""
        return self.model_flops_per_chip / self.flops if self.flops else 0.0

    @property
    def mfu(self) -> float:
        """Model-flops utilization (at the bf16 peak) at the
        roofline-predicted step time."""
        t = self.step_time
        return (self.model_flops_per_chip / PEAK_FLOPS) / t if t else 0.0

    def as_dict(self) -> Dict:
        return {
            "t_compute_s": self.t_compute, "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective, "dominant": self.dominant,
            "flops_per_chip": self.flops, "hbm_bytes_per_chip": self.hbm_bytes,
            "coll_bytes_per_chip": self.coll_bytes,
            "model_flops_per_chip": self.model_flops_per_chip,
            "model_flops_ratio": self.model_flops_ratio,
            "roofline_fraction": self.roofline_fraction, "mfu": self.mfu,
        }


def from_recording_manifest(manifest: Dict, model_flops_total: float,
                            num_chips: int = 1) -> Roofline:
    """Roofline terms from a recording's MANIFEST alone -- the
    replay-side counterpart of ``from_hlo``.  A replayer never runs the
    analysis, but the manifest carries the cost the recorder counted from
    the exported program (``cost``: 'flops', 'bytes accessed', and
    'flops_by_dtype' where the recorder wrote it), which places the
    replayed program on the same roofline point as its native twin."""
    cost = manifest.get("cost", {}) or {}
    flops = float(cost.get("flops", 0.0))
    hbm = float(cost.get("bytes accessed", 0.0))
    hlo_cost = {"flops": flops, "hbm_bytes": hbm, "coll_bytes": 0.0}
    if cost.get("flops_by_dtype"):
        hlo_cost["flops_by_dtype"] = cost["flops_by_dtype"]
    return from_hlo(hlo_cost, model_flops_total, num_chips)


def from_hlo(hlo_cost: Dict, model_flops_total: float, num_chips: int) -> Roofline:
    """Roofline of a cost dict (``cost.Cost.as_dict()``; the name is the
    reference's).  ``flops_by_dtype`` prices each dtype at its peak, and
    ``coll_by_link`` each link level at its rate; a dict without them (the
    reference's) counts every flop at the bf16 peak and every wire byte on
    the network."""
    mf = model_flops_total / num_chips
    by_dtype = hlo_cost.get("flops_by_dtype") or \
        {"bfloat16": hlo_cost["flops"]}
    by_link = hlo_cost.get("coll_by_link") or \
        {"network": hlo_cost["coll_bytes"]}
    return Roofline(
        t_compute=compute_time(by_dtype),
        t_memory=hlo_cost["hbm_bytes"] / HBM_BW,
        t_collective=sum(b / LINK_BW[k] for k, b in by_link.items()),
        flops=hlo_cost["flops"], hbm_bytes=hlo_cost["hbm_bytes"],
        coll_bytes=hlo_cost["coll_bytes"], model_flops_per_chip=mf)


def analytic_model_flops(cfg: ModelConfig, kind: str, batch: int,
                         seq: int) -> float:
    """MODEL_FLOPS: 6·N·D (train) / 2·N·D (prefill) / 2·N_active·B (decode),
    plus the attention O(S²) (train/prefill) or O(S) (decode) term."""
    n_active = cfg.param_count(active_only=True) - cfg.vocab_size * cfg.d_model \
        * (1 if cfg.tie_embeddings else 2)
    n_active += cfg.vocab_size * cfg.d_model  # lm head matmul is real compute
    hd, H = cfg.hd(), cfg.num_heads

    def attn_flops(tokens, ctx):
        if cfg.family == "ssm":
            return 0.0
        L = cfg.num_layers if cfg.family != "hybrid" \
            else cfg.num_layers // max(cfg.shared_every, 1)
        if cfg.family == "audio":
            L = cfg.num_layers  # decoder self-attn (cross handled below)
        eff_ctx = min(ctx, cfg.sliding_window) if cfg.sliding_window else ctx
        f = 4.0 * tokens * eff_ctx * H * hd * L
        if kind in ("train", "prefill") and not cfg.sliding_window:
            f *= 0.5  # causal
        if cfg.family == "audio":
            f += 4.0 * tokens * cfg.encdec.encoder_seq * H * hd * cfg.num_layers
        return f

    if kind == "train":
        toks = batch * seq
        return 6.0 * n_active * toks + 3.0 * attn_flops(toks, seq)
    if kind == "prefill":
        toks = batch * seq
        return 2.0 * n_active * toks + attn_flops(toks, seq)
    # decode: one token per sequence
    return 2.0 * n_active * batch + attn_flops(batch, seq)


__all__ = ["PEAK_OPS_S", "PEAK_FLOPS", "HBM_BW", "LINK_BW", "GPUS_PER_NODE",
           "link_of", "compute_time", "Roofline", "from_recording_manifest",
           "from_hlo", "analytic_model_flops"]
