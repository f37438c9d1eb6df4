"""Twins of the JAX package's paper benchmarks (``benchmarks/fig2_accuracy``,
``fig3_k0``, ``fig4_rho``, ``table1_lct`` and their part of ``run.py``) on
the port: the same grids, row names and claim rows, run through
``repro_torch.launch.paper`` on the card unless ``device`` says otherwise.
"""
