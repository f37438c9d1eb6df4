"""Privacy: the DP accountant, the noise and clip config, and the
secure-aggregation mask billing; the counterpart of ``repro.privacy``.

An inert config (no noise budget, no secure aggregation) builds no model
at all -- ``build_privacy_model`` returns None -- so the simulator then
takes its plain paths.
"""
from __future__ import annotations

from repro_torch.privacy.accounting import (  # noqa: F401
    MECHANISMS,
    SENSITIVITY_MODES,
    PrivacyConfig,
    PrivacyModel,
    build_privacy_model,
)
