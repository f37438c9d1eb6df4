"""The port's FedEPM rounds on reduced zamba2-1.2b on a live mesh of gloo
ranks against JAX's ``build_fedepm`` across as many forced host devices
(``tests/_torch_mesh.py`` runs both and states the settings): one round
(JAX's second-round gradient is NaN here, ROADMAP queue 3), the spatial
round with ``ens="a2a"`` and the temporal round (microbatch 2, remat), at
D = 2 and 4: masks exactly, the states and metrics within ``STATE_RTOL``
= 4e-6 of the scales of ``tests/_torch_distributed.py::
assert_close_to_jax`` (JAX's own runs on 2 and 4 devices stay within
8.8e-7 of its one-device run here; on xlstm-125m they move more,
``tests/test_torch_mesh_xlstm.py``).
"""
from __future__ import annotations

import pytest

import _torch_distributed as H
import _torch_mesh as M

CASES = ("zamba2-1.2b/spatial_a2a", "zamba2-1.2b/temporal")
DS = (2, 4)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX at D = 2 and 4; the port's groups of 2 and 4 ranks."""
    return M.run_both(tmp_path_factory.mktemp("mesh"), DS, CASES, {
        D: (CASES,) for D in DS})


@pytest.mark.parametrize("D", DS)
@pytest.mark.parametrize("case", CASES)
def test_rounds_against_jax_across_devices(runs, case, D):
    jax_runs, port = runs
    got, got_mets = M.states(port[D][case])
    want, want_mets = M.states(jax_runs[D, case])
    H.assert_close_to_jax(got, got_mets, want, want_mets)
