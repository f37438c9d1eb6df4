"""The port's analytic roofline (``repro_torch/launch/roofline.py``)
against JAX's ``repro.launch.roofline``.

Every analytic function gives JAX's number exactly, for all ten archs at
full width and the four input shapes (the same float arithmetic in the
same order): ``_param_counts``, ``total_param_bytes``,
``fwd_matmul_flops``, ``attn_fwd_flops``, ``ssd_fwd_flops``,
``train_flops``, ``prefill_flops``, ``decode_flops`` and the three
``*_hbm_bytes``. ``analyse`` on a synthetic one-card record gives JAX's
FLOP and byte totals, model FLOPs and useful ratio, the H100's peaks in
the times, no collective time, and the measured wall's share of the peak.
"""
from __future__ import annotations

import dataclasses

import pytest

from repro import configs as jconfigs
from repro.launch import roofline as jroof
from repro.launch import steps as jsteps
from repro.models.config import INPUT_SHAPES as JSHAPES
from repro_torch import configs as tconfigs
from repro_torch.launch import roofline as troof
from repro_torch.launch import steps as tsteps
from repro_torch.models.config import INPUT_SHAPES as TSHAPES


def _cfgs(arch, shape):
    """Both sides' configs as the step resolves them (the long_500k
    sliding-window variant included); None for a skip."""
    j = jsteps.resolve_arch(arch, JSHAPES[shape])
    t = tsteps.resolve_arch(arch, TSHAPES[shape])
    assert isinstance(j, jsteps.Skip) == isinstance(t, tsteps.Skip)
    if isinstance(j, jsteps.Skip):
        return None
    return j[0], t[0]


@pytest.mark.parametrize("shape", list(JSHAPES))
@pytest.mark.parametrize("arch", jconfigs.ALL_ARCHS)
def test_analytic_model_matches_jax(arch, shape):
    cfgs = _cfgs(arch, shape)
    if cfgs is None:
        return
    jc, tc = cfgs
    s = JSHAPES[shape]
    B, T = s.global_batch, s.seq_len
    assert troof._param_counts(tc) == jroof._param_counts(jc)
    assert troof.total_param_bytes(tc) == jroof.total_param_bytes(jc)
    assert troof._itemsize(tc) == jroof._itemsize(jc)
    for fn, args in (("fwd_matmul_flops", (B * T,)),
                     ("attn_fwd_flops", (B, T)), ("ssd_fwd_flops", (B, T)),
                     ("train_flops", (B, T, 4, 16)),
                     ("prefill_flops", (B, T)), ("decode_flops", (B, T)),
                     ("train_hbm_bytes", (B, T, 4, 16, 4)),
                     ("prefill_hbm_bytes", (B, T)),
                     ("decode_hbm_bytes", (B, T))):
        assert getattr(troof, fn)(tc, *args) == \
            getattr(jroof, fn)(jc, *args), fn


@pytest.mark.parametrize("kind,shape", [("train", "train_4k"),
                                        ("prefill", "prefill_32k"),
                                        ("decode", "decode_32k")])
def test_analyse_on_a_synthetic_record(kind, shape):
    """A one-card record at a cut batch: the totals are JAX's analytic
    ones, the times use the H100's peaks, and the share is model FLOPs
    over wall x peak."""
    arch = "smollm-135m"
    jshape = dataclasses.replace(JSHAPES[shape], global_batch=8)
    tshape = dataclasses.replace(TSHAPES[shape], global_batch=8)
    rec = {"arch": arch, "shape": shape, "mesh": "single",
           "mesh_shape": {"data": 1, "model": 1}, "kind": kind,
           "static": {"m": 1, "k0": 4}, "wall_s": 0.25,
           "input_shape": {"seq_len": tshape.seq_len, "global_batch": 8}}
    want = jroof.analyse(dict(rec), jconfigs.get_config(arch), jshape)
    got = troof.analyse(rec, tconfigs.get_config(arch), tshape)
    assert got.detail["flops"] == want.detail["flops"]
    assert got.detail["hbm"] == want.detail["hbm"]
    assert got.model_flops == want.model_flops
    assert got.useful_ratio == want.useful_ratio
    assert got.chips == 1 and got.collective_s == 0.0
    assert got.compute_s == want.detail["flops"]["total"] / troof.PEAK_FLOPS
    assert got.memory_s == want.detail["hbm"]["total"] / troof.HBM_BW
    assert got.bottleneck == max(("compute", got.compute_s),
                                 ("memory", got.memory_s),
                                 key=lambda x: x[1])[0]
    assert got.wall_s == 0.25
    assert got.peak_share == got.model_flops / (0.25 * troof.PEAK_FLOPS)
    assert troof.record_shape(rec) == tshape
    assert (troof.PEAK_FLOPS, troof.HBM_BW, troof.LINK_BW) == \
        (989e12, 3.35e12, 450e9)
