"""The port's xlstm family (``repro_torch.models.xlstm``) on reduced
xlstm-125m against a live JAX run on the CPU (``_torch_families.py`` says
what each shared check holds), and the mLSTM's chunking: the output does
not depend on the chunk length, padded chunks included.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_families as fam
from repro.models import registry as jregistry
from repro.models import xlstm as jxlstm
from repro_torch.checkpoint.convert import lm_params_from_numpy
from repro_torch.models import registry as tregistry
from repro_torch.models import xlstm as txlstm

torch.set_num_threads(1)

ARCH = "xlstm-125m"


@pytest.fixture(scope="module")
def jrun():
    return fam.jax_spec_run(ARCH)


def test_reduced_init_matches_jax_bitwise():
    fam.check_init(ARCH)


def test_logits_losses_and_client_grads_match_jax():
    fam.check_logits_losses_grads(ARCH)


def test_chunked_ce_matches_jax():
    fam.check_chunked(ARCH)


@pytest.mark.parametrize("engine", ["eager", "scan"])
def test_train_spec_matches_jax(engine, jrun, tmp_path, capsys):
    fam.check_train_spec(ARCH, engine, jrun, tmp_path, capsys)


def test_chip_smoke_constants_are_jax(jrun):
    fam.check_chip_constants(ARCH, jrun)


def test_xlstm_chunk_invariance():
    """JAX's ``test_xlstm_chunk_invariance`` on the port: 19 tokens in
    chunks of 8 (the reduced config's, three chunks, the last padded), 4
    and 64 (one padded chunk, as at full width's 32 tokens): each within
    JAX's 2e-5 of the chunks of 8, and each within RTOL of JAX at the same
    chunk length."""
    jcfg, tcfg, jm, tm = fam.models(ARCH)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = lm_params_from_numpy(jax.device_get(jp), device="cpu")
    toks = np.random.default_rng(1).integers(0, jcfg.vocab, (2, 19),
                                             dtype=np.int32)
    base = tm.apply(tp, {"tokens": torch.from_numpy(toks)})
    assert torch.isfinite(base).all()
    for chunk in (4, 8, 64):
        jc = dataclasses.replace(jcfg, ssm_chunk=chunk)
        tc = dataclasses.replace(tcfg, ssm_chunk=chunk)
        got = tregistry.get_model(tc).apply(tp, {"tokens":
                                                 torch.from_numpy(toks)})
        want = jregistry.get_model(jc).apply(jp, {"tokens":
                                                  jnp.asarray(toks)})
        fam.close(got, want, f"chunk {chunk}")
        assert float((got - base).abs().max()) <= 2e-5, chunk


def test_mlstm_gradient_is_finite_where_jax_overflows():
    """Forget gates at -200 make exp(dmat) overflow above the diagonal
    (each step adds 200 to the log weight): the outputs are JAX's within
    RTOL; the gradient to the input gates is NaN in JAX (where(mask, exp,
    0), whose backward multiplies 0 by inf) and finite in the port (exp of
    the masked argument)."""
    rng = np.random.default_rng(0)
    q, k, v = rng.standard_normal((3, 2, 10, 2, 8)).astype(np.float32)
    i_pre = rng.standard_normal((2, 10, 2)).astype(np.float32)
    f_pre = np.full((2, 10, 2), -200.0, np.float32)

    def jout(ii):
        return jxlstm._mlstm_scan(q, k, v, ii, f_pre, 4)[0]

    jg = jax.grad(lambda ii: jnp.sum(jout(ii)))(jnp.asarray(i_pre))
    assert np.isnan(np.asarray(jg)).any()
    ti = torch.from_numpy(i_pre).requires_grad_(True)
    out, _ = txlstm._mlstm_scan(*(torch.from_numpy(a) for a in (q, k, v)),
                                ti, torch.from_numpy(f_pre), 4)
    fam.close(out, jout(jnp.asarray(i_pre)), "mlstm out")
    (g,) = torch.autograd.grad(out.sum(), ti)
    assert torch.isfinite(g).all()
