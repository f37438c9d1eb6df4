"""Moving FedEPM state and LM params between the port and numpy (and so
the JAX package), and npz checkpoints in the JAX package's layout."""
from repro_torch.checkpoint.npz import (  # noqa: F401
    restore,
    restore_fedepm,
    save,
    save_fedepm,
)
