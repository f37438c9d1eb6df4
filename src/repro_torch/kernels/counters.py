"""The launch counters of the port's hand-written kernels.

Each kernel's wrapper adds one to its ``.launches`` where it launches the
kernel. ``launch_counters`` names them all, so a caller can set every count
to 0 before a path and read them after it.
"""
from __future__ import annotations


def launch_counters() -> dict:
    """Kernel name -> its wrapper, which carries the ``.launches`` count."""
    from repro_torch.kernels.ens.ens import ens_cuda
    from repro_torch.kernels.prox.prox import prox_update_cuda
    from repro_torch.kernels.quant import quant
    from repro_torch.kernels.threefry.threefry import (threefry_block_cuda,
                                                       threefry_cuda,
                                                       threefry_rows_cuda)
    return {"prox_update": prox_update_cuda, "ens": ens_cuda,
            "quantize_cols": quant.quantize_cols_cuda,
            "ef_accumulate": quant.ef_accumulate_cuda,
            "private_quantize_cols": quant.private_quantize_cols_cuda,
            "quantize": quant.quantize_cuda, "threefry": threefry_cuda,
            "threefry_rows": threefry_rows_cuda,
            "threefry_block": threefry_block_cuda}
