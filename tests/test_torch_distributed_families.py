"""``repro_torch.core.distributed`` on the xlstm and hybrid families
(reduced xlstm-125m and zamba2-1.2b) against JAX's ``build_fedepm`` on a
one-device mesh, at ``chip_smoke.DIST_SETTINGS`` in both
``chip_smoke.DIST_MODES`` (``tests/_torch_distributed.py`` holds the
settings and states the tolerance). One round: JAX's second-round
gradient is NaN on both (the aggregate of the first round's noised
uploads overflows its masked exps, ROADMAP queue 3), where the port's is
finite.

- the port's round against JAX's: masks exact, metrics and w_tau, W and Z
  within ``STATE_RTOL`` = 4e-6 of each tree's scale;
- JAX's digests equal ``chip_smoke.JAX_DIST``, which the card's run of
  the same rounds is held to.
"""
from __future__ import annotations

import pytest

import chip_smoke

import _torch_distributed as H

RUNS = [(arch, mode) for arch in ("xlstm-125m", "zamba2-1.2b")
        for mode in sorted(chip_smoke.DIST_MODES)]


@pytest.fixture(scope="module")
def jax_runs():
    """One live JAX run per (arch, mode), shared by the file."""
    return {(arch, mode): H.jax_rounds(arch, chip_smoke.DIST_ROUNDS[arch],
                                       **chip_smoke.DIST_MODES[mode])
            for arch, mode in RUNS}


@pytest.mark.parametrize("arch,mode", RUNS)
def test_rounds_against_jax(arch, mode, jax_runs):
    got, got_mets = H.port_rounds(arch, chip_smoke.DIST_ROUNDS[arch],
                                  **chip_smoke.DIST_MODES[mode])
    want, want_mets = jax_runs[arch, mode]
    H.assert_close_to_jax(got, got_mets, want, want_mets)


@pytest.mark.parametrize("arch,mode", RUNS)
def test_jax_digests_are_chip_smoke_constants(arch, mode, jax_runs):
    states, mets = jax_runs[arch, mode]
    got = [chip_smoke.dist_digest(st, m.selected)
           for st, m in zip(states, mets)]
    assert got == chip_smoke.JAX_DIST[arch][mode]
