"""The port's FedEPM rounds on reduced xlstm-125m on a live mesh of gloo
ranks against JAX's ``build_fedepm`` across as many forced host devices
(``tests/_torch_mesh.py`` runs both and states the settings): one round
(JAX's second-round gradient is NaN here, ROADMAP queue 3), the spatial
round with ``ens="a2a"`` and the temporal round (microbatch 2, remat), at
D = 2 and 4: masks exactly, the states and metrics within ``STATE_RTOL``
= 4e-6 of the scales of ``tests/_torch_distributed.py::
assert_close_to_jax``, plus JAX's own spread between its runs on D
devices and on one, measured in the same subprocesses. JAX's runs on 2
and 4 devices move up to 1.9e-6 of a tree's scale from its one-device
run here, which on top of the port's distance from JAX's one-device run
(``test_torch_distributed_families``) can pass 4e-6: 4.07e-6 on the
spatial round at D = 4, where the port's 4 ranks give its one-device
bits.
"""
from __future__ import annotations

import pytest

import _torch_distributed as H
import _torch_mesh as M

CASES = ("xlstm-125m/spatial_a2a", "xlstm-125m/temporal")
DS = (2, 4)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX at D = 1, 2 and 4; the port's groups of 2 and 4 ranks."""
    return M.run_both(tmp_path_factory.mktemp("mesh"), (1,) + DS, CASES, {
        D: (CASES,) for D in DS})


@pytest.mark.parametrize("D", DS)
@pytest.mark.parametrize("case", CASES)
def test_rounds_against_jax_across_devices(runs, case, D):
    jax_runs, port = runs
    got, got_mets = M.states(port[D][case])
    want, want_mets = M.states(jax_runs[D, case])
    spread = H.assert_close_to_jax(want, want_mets,
                                   *M.states(jax_runs[1, case]), rtol=1.0)
    H.assert_close_to_jax(got, got_mets, want, want_mets,
                          H.STATE_RTOL + spread)
