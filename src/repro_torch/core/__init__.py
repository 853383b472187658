"""CODY core: record/replay of exported step programs, the paper's I/O
optimizations (deferral, speculation) and the ExecutionChannel transport
seam the serving stack dispatches through.  The replayer
(``repro_torch.core.replay``) is imported on its own, as in the
reference."""
from repro_torch.core.attest import (TamperedRecordingError,
                                     TopologyMismatchError,
                                     UnverifiedRecordingError, fingerprint,
                                     sign, verify)
from repro_torch.core.channel import (ChannelCapabilityError,
                                      ExecutionChannel, LiveChannel,
                                      ReplayChannel)
from repro_torch.core.deferral import (CommitQueue, Op, Symbol,
                                       SymbolReResolutionError,
                                       UnresolvedSymbolError)
from repro_torch.core.recording import Recording
from repro_torch.core.speculation import (HistorySpeculator, MispredictError,
                                          SpeculativeRunner)

__all__ = [
    "CommitQueue", "Op", "Symbol", "UnresolvedSymbolError",
    "SymbolReResolutionError", "Recording", "ExecutionChannel",
    "LiveChannel", "ReplayChannel", "ChannelCapabilityError",
    "HistorySpeculator", "MispredictError", "SpeculativeRunner",
    "fingerprint", "sign", "verify", "TamperedRecordingError",
    "TopologyMismatchError", "UnverifiedRecordingError",
]
