"""Declarative experiment specs on the port: one typed config surface, the
counterpart of ``repro.spec``. The same TOML/JSON files load in both
packages (``examples/specs/*.toml``):

    from repro_torch import spec as xspec

    exp = xspec.ExperimentSpec.load("examples/specs/fig8_faults.toml")
    summary = exp.build().run()          # on the card; build("cpu") here

Module map: ``types``, ``serialize`` and ``sweep`` are copies of the JAX
package's (JSON, TOML and numpy only); ``registry`` and ``build`` build
torch tasks, states and a ``FedSim``. Task kind ``lm`` builds the arch's
dense model (``repro_torch.models``), its federated token batches and the
LM loss, as JAX's does.
"""
from repro_torch.spec.build import RunHandle, build          # noqa: F401
from repro_torch.spec.registry import (                      # noqa: F401
    register_algorithm,
    register_codec,
    register_engine,
    register_fleet,
    register_policy,
    register_task,
)
from repro_torch.spec.sweep import load_sweep, sweep         # noqa: F401
from repro_torch.spec.types import (                         # noqa: F401
    AlgorithmSpec,
    CodecSpec,
    EngineSpec,
    ExperimentSpec,
    FaultSpec,
    FleetSpec,
    PolicySpec,
    PrivacySpec,
    SpecError,
    TaskSpec,
    TelemetrySpec,
)
