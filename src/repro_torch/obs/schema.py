"""Report/artifact schema checks — observability fields can't silently die.

Counterpart of ``repro/obs/schema.py``: the same required keys and
acceptance flags, plain Python over dicts and JSON files.

The motivating bug: ``NetworkEmulator.snapshot()`` once silently
dropped ``async_trips``/``collapsed_spins``, so ``Workspace.report()
["net"]`` under-reported async and collapsed traffic with no test
noticing.  This module pins the shapes:

  * ``check_workspace_report`` — the ``Workspace.report()`` contract
    (net / registry / sessions / replays / metrics / schedulers);
  * ``check_bench_file`` — per-``BENCH_*.json`` required keys plus the
    acceptance FLAGS each artifact asserts about itself (bit-exactness,
    monotone ladders, trace attribution): a flag that flips to False
    fails the check, so CI catches regressions, not just vanished keys;
  * a CLI for the CI step::

        PYTHONPATH=src python -m repro_torch.obs.schema BENCH_*.json TRACE_*.json
"""
from __future__ import annotations

import json
import os
import sys

from repro_torch.obs.metrics import QUANTILE_KEYS


class SchemaError(ValueError):
    """A report/artifact is missing required observability fields (or an
    acceptance flag it declares about itself is False)."""


def _require(d: dict, keys, where: str) -> None:
    if not isinstance(d, dict):
        raise SchemaError(f"{where}: expected a dict, got {type(d).__name__}")
    missing = [k for k in keys if k not in d]
    if missing:
        raise SchemaError(f"{where}: missing fields {missing}")


def _flags(d: dict, keys, where: str) -> None:
    _require(d, keys, where)
    bad = [k for k in keys if d[k] is not True]
    if bad:
        raise SchemaError(f"{where}: acceptance flags not True: {bad}")


NET_KEYS = ("time_s", "round_trips", "async_trips", "bytes_sent",
            "bytes_received", "collapsed_spins", "bytes")
SESSION_KEYS = ("net", "passes", "virtual_time_s", "blocking_round_trips",
                "async_round_trips", "bytes_sent", "bytes_received", "jobs",
                "ops_executed", "per_pass")
REPLAY_KEYS = ("net", "passes", "virtual_time_s", "blocking_round_trips",
               "collapsed_spins", "dispatches", "plan_ops", "jobs",
               "per_pass")
HIST_KEYS = ("count", "sum", "min", "max") + QUANTILE_KEYS
SCHED_KEYS = ("preemptions", "eviction_unsupported", "live_slots", "streams")
SCHED_STREAM_KEYS = ("stalled", "stall_hwm", "unevictable",
                     "evicted_requests", "admissions_deferred")
FLEET_KEYS = ("name", "policy", "tick_s", "ticks", "virtual_time_s",
              "arrivals", "served", "failed", "migrations", "balancer",
              "autoscale", "replicas")
FLEET_BALANCER_KEYS = ("policy", "queue_limit", "queue_depth", "offered",
                       "placed", "rejected", "queue_hwm")
FLEET_REPLICA_KEYS = ("name", "region", "boot_virtual_s", "ready_at",
                      "draining", "retired", "served", "outstanding")
STORE_KEYS = ("chunk_reads", "puts", "gets", "cache", "read_replicas")
CACHE_KEYS = ("max_bytes", "nbytes", "entries", "hits", "misses",
              "evictions")
CAMPAIGN_KEYS = ("name", "devices", "variants", "recorded",
                 "skipped_published", "skipped_leased", "share_history",
                 "tick_s", "ticks", "virtual_time_s",
                 "sum_record_virtual_s", "publishes", "compiles",
                 "artifact_reuses", "speculation", "per_device")
CAMPAIGN_DEVICE_KEYS = ("name", "hw_class", "net", "recorded",
                        "busy_virtual_s", "blocking_round_trips", "spec")
ATTEST_KEYS = ("epoch", "log_size", "root", "quotes", "proofs_verified",
               "proof_bytes")


def check_histogram_summary(s: dict, where: str = "histogram") -> dict:
    _require(s, HIST_KEYS, where)
    return s


def check_scheduler_stats(s: dict, where: str = "scheduler") -> dict:
    _require(s, SCHED_KEYS, where)
    for name, row in s["streams"].items():
        _require(row, SCHED_STREAM_KEYS, f"{where}.streams[{name}]")
    return s


def check_fleet_stats(s: dict, where: str = "fleet") -> dict:
    """Validate one ``ReplicaPool.stats()`` dict; returns ``s``."""
    _require(s, FLEET_KEYS, where)
    _require(s["balancer"], FLEET_BALANCER_KEYS, f"{where}.balancer")
    _require(s["autoscale"], ("enabled", "scale_ups", "retired"),
             f"{where}.autoscale")
    for r in s["replicas"]:
        _require(r, FLEET_REPLICA_KEYS,
                 f"{where}.replicas[{r.get('name')}]")
    return s


def check_registry_store_stats(s: dict,
                               where: str = "registry_store") -> dict:
    """Validate ``report()["registry_store"]`` (LRU cache counters and
    regional read-replica summaries)."""
    _require(s, STORE_KEYS, where)
    if s["cache"] is not None:
        _require(s["cache"], CACHE_KEYS, f"{where}.cache")
    for rr in s["read_replicas"]:
        _require(rr, ("region", "chunk_pulls", "chunk_pull_bytes",
                      "ensure_passthrough", "proofs_relayed", "cache"),
                 f"{where}.read_replicas[{rr.get('region')}]")
        _require(rr["cache"], CACHE_KEYS,
                 f"{where}.read_replicas[{rr.get('region')}].cache")
    return s


def check_campaign_stats(s: dict, where: str = "campaign") -> dict:
    """Validate one ``RecordCampaign.stats()`` dict; returns ``s``."""
    _require(s, CAMPAIGN_KEYS, where)
    _require(s["speculation"], ("predicts", "hits", "records", "hit_rate",
                                "shared"), f"{where}.speculation")
    for d in s["per_device"]:
        _require(d, CAMPAIGN_DEVICE_KEYS,
                 f"{where}.per_device[{d.get('name')}]")
        _require(d["spec"], ("predict", "hit", "record"),
                 f"{where}.per_device[{d.get('name')}].spec")
    return s


def check_workspace_report(rep: dict) -> dict:
    """Validate the full ``Workspace.report()`` shape; returns ``rep``."""
    _require(rep, ("net", "registry_client", "registry_service", "sessions",
                   "replays", "replayer_stats", "metrics", "schedulers",
                   "fleet", "campaigns", "registry_store", "attest"),
             "report")
    if rep["attest"] is not None:
        _require(rep["attest"], ATTEST_KEYS, "report.attest")
    if rep["net"] is not None:
        _require(rep["net"], NET_KEYS, "report.net")
    for i, s in enumerate(rep["sessions"]):
        _require(s, SESSION_KEYS, f"report.sessions[{i}]")
    for i, r in enumerate(rep["replays"]):
        _require(r, REPLAY_KEYS, f"report.replays[{i}]")
    _require(rep["metrics"], ("counters", "histograms"), "report.metrics")
    for k, h in rep["metrics"]["histograms"].items():
        check_histogram_summary(h, f"report.metrics.histograms[{k}]")
    for i, s in enumerate(rep["schedulers"]):
        check_scheduler_stats(s, f"report.schedulers[{i}]")
    for i, s in enumerate(rep["fleet"]):
        check_fleet_stats(s, f"report.fleet[{i}]")
    for i, s in enumerate(rep["campaigns"]):
        check_campaign_stats(s, f"report.campaigns[{i}]")
    check_registry_store_stats(rep["registry_store"],
                               "report.registry_store")
    return rep


# ------------------------------------------------------- bench artifacts --
def _check_multitenant(d: dict) -> None:
    _require(d, ("archs", "solo", "multi", "frontier", "scheduler",
                 "bit_exact_vs_solo", "frontier_only_syncs"), "multitenant")
    for section in ("solo", "multi"):
        for row in d[section]:
            _require(row, ("stream", "tokens", "host_syncs",
                           "syncs_per_token", "latency_quantiles"),
                     f"multitenant.{section}[{row.get('stream')}]")
            _require(row["latency_quantiles"], QUANTILE_KEYS,
                     f"multitenant.{section}[{row.get('stream')}]"
                     ".latency_quantiles")
    check_scheduler_stats(d["scheduler"], "multitenant.scheduler")
    _flags(d, ("bit_exact_vs_solo", "frontier_only_syncs"), "multitenant")


def _check_recording(d: dict) -> None:
    _require(d, ("rows", "wifi_virtual_times_s", "trace_attribution"),
             "recording")
    for row in d["rows"]:
        _require(row, ("stack", "net", "virtual_time_s", "blocking_rts",
                       "trace_attribution"), f"recording[{row.get('stack')}]")
    _flags(d, ("monotone_virtual_time", "all_passes_ge_90pct_below_naive",
               "bit_exact_vs_legacy", "verifies_under_key",
               "trace_attributed_ge_95pct"), "recording")


def _check_replay(d: dict) -> None:
    _require(d, ("native_rows", "ablation"), "replay")
    _flags(d, ("replay_not_slower_than_native", "monotone_virtual_time",
               "bit_exact_vs_naive_replay", "bit_exact_vs_live"), "replay")


def _check_registry(d: dict) -> None:
    _require(d, ("rows", "record_virtual_s", "delta_publish_wire_bytes"),
             "registry")
    _flags(d, ("warm_zero_recording_rts", "warm_reduction_ge_80pct",
               "delta_wire_lt_full"), "registry")


def _check_fleet(d: dict) -> None:
    _require(d, ("tenants", "traffic", "policies", "registry_boot"),
             "fleet")
    _require(d["traffic"], ("seed", "horizon_s", "burst_every_s",
                            "burst_len_s", "burst_x", "arrivals"),
             "fleet.traffic")
    if len(d["policies"]) < 2:
        raise SchemaError("fleet: need >= 2 placement policies, got "
                          f"{len(d['policies'])}")
    for row in d["policies"]:
        where = f"fleet.policies[{row.get('policy')}]"
        _require(row, ("policy", "per_tenant", "pool"), where)
        for tenant, tr in row["per_tenant"].items():
            _require(tr, ("served", "latency_quantiles"),
                     f"{where}.per_tenant[{tenant}]")
            _require(tr["latency_quantiles"], QUANTILE_KEYS,
                     f"{where}.per_tenant[{tenant}].latency_quantiles")
        check_fleet_stats(row["pool"], f"{where}.pool")
    _require(d["registry_boot"], ("cold_boot_virtual_s",
                                  "warm_boot_virtual_s", "reduction_pct"),
             "fleet.registry_boot")
    _flags(d, ("bit_exact_vs_solo", "warm_boot_cheaper_than_cold",
               "warm_boot_reduction_ge_80pct"), "fleet")


def _check_fanout(d: dict) -> None:
    _require(d, ("net", "variants", "device_ladder", "serial",
                 "speculation", "reduction_at_4_devices_pct"), "fanout")
    _require(d["serial"], ("sessions", "virtual_time_s"), "fanout.serial")
    if len(d["device_ladder"]) < 3:
        raise SchemaError("fanout: need a >= 3-rung device ladder, got "
                          f"{len(d['device_ladder'])}")
    for row in d["device_ladder"]:
        where = f"fanout.device_ladder[{row.get('devices')}]"
        _require(row, ("devices", "virtual_time_s", "campaign"), where)
        check_campaign_stats(row["campaign"], f"{where}.campaign")
    _require(d["speculation"], ("shared_hit_rate", "cold_hit_rate"),
             "fanout.speculation")
    _flags(d, ("monotone_virtual_time", "fanout_reduction_ge_70pct",
               "bit_exact_vs_serial", "shared_spec_hit_ge_cold"), "fanout")


def _check_decode(d: dict) -> None:
    _require(d, ("depths", "replay_vs_live"), "decode")
    _flags(d, ("identical_streams_across_depths",), "decode")


def _check_attest(d: dict) -> None:
    _require(d, ("proof_ladder", "verify_overhead", "split_view", "quote"),
             "attest")
    if len(d["proof_ladder"]) < 3:
        raise SchemaError("attest: need a >= 3-rung proof-size ladder, got "
                          f"{len(d['proof_ladder'])}")
    for row in d["proof_ladder"]:
        _require(row, ("entries", "proof_hashes", "proof_wire_bytes",
                       "log2_bound"), f"attest.proof_ladder[{row.get('entries')}]")
    _require(d["verify_overhead"], ("warm_fetch_unverified_s",
                                    "warm_fetch_verified_s", "overhead_pct",
                                    "proof_bytes"), "attest.verify_overhead")
    _require(d["quote"], ("bound_fields", "perturbations_rejected"),
             "attest.quote")
    _flags(d, ("split_view_detected", "verify_overhead_le_5pct",
               "offline_verifier_no_model_imports",
               "proof_growth_sublinear"), "attest")


def _check_trace(d: dict) -> None:
    _require(d, ("traceEvents",), "trace")
    if not isinstance(d["traceEvents"], list) or not d["traceEvents"]:
        raise SchemaError("trace: traceEvents must be a non-empty list")


BENCH_CHECKS = {
    "BENCH_multitenant.json": _check_multitenant,
    "BENCH_recording.json": _check_recording,
    "BENCH_replay.json": _check_replay,
    "BENCH_registry.json": _check_registry,
    "BENCH_decode.json": _check_decode,
    "BENCH_fleet.json": _check_fleet,
    "BENCH_fanout.json": _check_fanout,
    "BENCH_attest.json": _check_attest,
}


def check_bench_file(path: str) -> str:
    base = os.path.basename(path)
    with open(path) as f:
        data = json.load(f)
    if base in BENCH_CHECKS:
        BENCH_CHECKS[base](data)
        return f"schema ok: {base}"
    if base.startswith("TRACE"):
        _check_trace(data)
        return f"schema ok: {base} ({len(data['traceEvents'])} events)"
    raise SchemaError(f"no schema registered for {base}")


def main(argv=None) -> int:
    paths = list(sys.argv[1:] if argv is None else argv)
    if not paths:
        print("usage: python -m repro_torch.obs.schema BENCH_*.json "
              "TRACE_*.json")
        return 2
    for p in paths:
        print(check_bench_file(p))
    return 0


if __name__ == "__main__":
    sys.exit(main())


__all__ = ["SchemaError", "check_workspace_report", "check_bench_file",
           "check_histogram_summary", "check_scheduler_stats",
           "check_fleet_stats", "check_campaign_stats",
           "check_registry_store_stats", "main"]
