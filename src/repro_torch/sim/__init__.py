"""Federated systems runtime on the port: client heterogeneity and latency
models, the sync/deadline/adaptive/overselect policies over simulated time
and the buffered, staleness-weighted async policy, the upload codec with
optional error feedback and DP uploads, the byte ledger, and the engine
(``run_rounds``: chunks of rounds, or of recorded async fires and merges,
replayed as CUDA graphs on the card), and seeded fault injection
(``faults.py``); the counterpart of ``repro.sim``."""
from repro_torch.sim.clients import (     # noqa: F401
    AdaptiveDeadlines,
    ClientProfiles,
    LatencyTrace,
    latency_model_names,
    make_latency_model,
    make_profiles,
    register_latency_model,
    round_arrivals,
    uniform_profiles,
)
from repro_torch.sim.faults import (      # noqa: F401
    FaultConfig,
    FaultModel,
    build_fault_model,
)
from repro_torch.sim.engine import (      # noqa: F401
    EngineResult,
    run_rounds,
    run_to_objective,
)
from repro_torch.sim.server import (      # noqa: F401
    FedSim,
    SimConfig,
    SimMetrics,
    client_work_flops,
)
from repro_torch.sim.transport import (   # noqa: F401
    ByteLedger,
    CodecConfig,
    codec_roundtrip,
    ef_roundtrip,
    encoded_client_bytes,
    stacked_client_bytes,
    tree_client_bytes,
)
