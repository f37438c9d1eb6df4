"""The port's ssm/hybrid family (``repro_torch.models.ssm``) on reduced
zamba2-1.2b against a live JAX run on the CPU (``_torch_families.py`` says
what each shared check holds), and the hybrid's segmentation: the shared
block before each group of ``shared_attn_every`` mamba layers and before
the ragged tail.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_families as fam
from repro import configs as jconfigs
from repro.models import ssm as jssm
from repro_torch import configs as tconfigs
from repro_torch.checkpoint.convert import lm_params_from_numpy
from repro_torch.core.treeutil import tmap
from repro_torch.models import ssm as tssm

torch.set_num_threads(1)

ARCH = "zamba2-1.2b"


@pytest.fixture(scope="module")
def jrun():
    return fam.jax_spec_run(ARCH)


def test_reduced_init_matches_jax_bitwise():
    """``dt_bias`` (log of expm1 of exp of a uniform) and ``A_log`` (log of
    a linspace) included: XLA:CPU's f32 forms (``core/xla_cpu.py``)."""
    fam.check_init(ARCH)


def test_logits_losses_and_client_grads_match_jax():
    """``shared_attn`` is applied twice: its gradient sums both."""
    fam.check_logits_losses_grads(ARCH)


def test_chunked_ce_matches_jax():
    fam.check_chunked(ARCH)


@pytest.mark.parametrize("engine", ["eager", "scan"])
def test_train_spec_matches_jax(engine, jrun, tmp_path, capsys):
    fam.check_train_spec(ARCH, engine, jrun, tmp_path, capsys)


def test_chip_smoke_constants_are_jax(jrun):
    fam.check_chip_constants(ARCH, jrun)


@pytest.mark.parametrize("reduced", [True, False])
def test_hybrid_segments_match_jax(reduced):
    get = "get_reduced" if reduced else "get_config"
    want = jssm._segments(getattr(jconfigs, get)(ARCH))
    assert tssm._segments(getattr(tconfigs, get)(ARCH)) == want
    assert want == ([(True, 3), (True, 1)] if reduced
                    else [(True, 6)] * 6 + [(True, 2)])


def test_hybrid_runs_a_group_then_the_tail(monkeypatch):
    """Reduced zamba2 (4 layers, the shared block every 3): the shared
    block, mamba layers 0-2, the shared block, mamba layer 3."""
    _, tcfg, jm, _ = fam.models(ARCH)
    tp = lm_params_from_numpy(jax.device_get(jm.init(jax.random.PRNGKey(0))),
                              device="cpu")
    W = tmap(lambda t: t.unsqueeze(0), tp)
    calls = []
    real_mamba, real_shared = tssm.mamba_block, tssm.shared_block

    def mamba(x, p, cfg):
        calls.append(p["in_proj"].data_ptr())
        return real_mamba(x, p, cfg)

    def shared(x, p, cfg, positions):
        calls.append("shared")
        return real_shared(x, p, cfg, positions)

    monkeypatch.setattr(tssm, "mamba_block", mamba)
    monkeypatch.setattr(tssm, "shared_block", shared)
    toks = torch.zeros((1, 2, 8), dtype=torch.int32)
    tssm.hidden(W, {"tokens": toks}, tcfg)
    ptrs = [t.data_ptr() for t in W["mamba_layers"]["in_proj"].unbind(1)]
    assert calls == ["shared", ptrs[0], ptrs[1], ptrs[2], "shared",
                     ptrs[3]]


def test_ssd_gradient_is_finite_where_jax_overflows():
    """dt A = -160 a step makes exp(diff) overflow above the diagonal: the
    outputs are JAX's within RTOL; the gradient to dt is NaN in JAX (0 *
    inf in where's backward) and finite in the port."""
    rng = np.random.default_rng(0)
    S, T, H, hd, N = 2, 10, 2, 4, 3
    x = rng.standard_normal((S, T, H, hd)).astype(np.float32)
    Bm, Cm = rng.standard_normal((2, S, T, N)).astype(np.float32)
    dt = np.full((S, T, H), 10.0, np.float32)
    A = np.full((H,), -16.0, np.float32)

    def jout(dd):
        return jssm._ssd_scan(x, Bm, Cm, dd, A, 4)[0]

    jg = jax.grad(lambda dd: jnp.sum(jout(dd)))(jnp.asarray(dt))
    assert np.isnan(np.asarray(jg)).any()
    tdt = torch.from_numpy(dt).requires_grad_(True)
    out, _ = tssm._ssd_scan(torch.from_numpy(x), torch.from_numpy(Bm),
                            torch.from_numpy(Cm), tdt,
                            torch.from_numpy(A).expand(S, H), 4)
    fam.close(out, jout(jnp.asarray(dt)), "ssd out")
    (g,) = torch.autograd.grad(out.sum(), tdt)
    assert torch.isfinite(g).all()
