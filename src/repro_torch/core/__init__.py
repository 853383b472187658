"""CODY core: record/replay of exported step programs, the paper's three
I/O optimizations (deferral, speculation, metastate-only sync), the
network emulator, replay-plan compaction, and the ExecutionChannel
transport seam the serving stack dispatches through.  The replayer
(``repro_torch.core.replay``) is imported on its own, as in the
reference."""
from repro_torch.core.attest import (TamperedRecordingError,
                                     TopologyMismatchError,
                                     UnverifiedRecordingError, fingerprint,
                                     sign, verify)
from repro_torch.core.channel import (ChannelCapabilityError,
                                      ExecutionChannel, LiveChannel,
                                      NetemBilledChannel, ReplayChannel)
from repro_torch.core.deferral import (CommitQueue, Op, Symbol,
                                       SymbolReResolutionError,
                                       UnresolvedSymbolError)
from repro_torch.core.metasync import (DeltaSync, full_pack, is_metastate,
                                       merge, split)
from repro_torch.core.netem import (CELLULAR, LOCAL, PROFILES, WIFI,
                                    NetProfile, NetworkEmulator)
from repro_torch.core.recording import Recording
from repro_torch.core.replay_passes import (REPLAY_PASS_NAMES,
                                            CommitCoalesce, DeadRegisterElim,
                                            PlanExecutor, PollCollapse,
                                            ReplayPlan, plan_for,
                                            replay_plan_report,
                                            resolve_replay_passes,
                                            verified_plan)
from repro_torch.core.speculation import (HistorySpeculator, MispredictError,
                                          SpeculativeRunner)

__all__ = [
    "CommitQueue", "Op", "Symbol", "UnresolvedSymbolError",
    "SymbolReResolutionError", "Recording", "ExecutionChannel",
    "LiveChannel", "ReplayChannel", "NetemBilledChannel",
    "ChannelCapabilityError", "HistorySpeculator", "MispredictError",
    "SpeculativeRunner", "DeltaSync", "full_pack", "is_metastate", "merge",
    "split", "NetworkEmulator", "NetProfile", "PROFILES", "WIFI", "CELLULAR",
    "LOCAL",
    "fingerprint", "sign", "verify", "TamperedRecordingError",
    "TopologyMismatchError", "UnverifiedRecordingError",
    "REPLAY_PASS_NAMES", "ReplayPlan", "DeadRegisterElim", "PollCollapse",
    "CommitCoalesce", "PlanExecutor", "plan_for", "verified_plan",
    "replay_plan_report", "resolve_replay_passes",
]
