"""Byte-accurate communication accounting and the upload codec; the
counterpart of ``repro.sim.transport``.

Byte ledger
-----------
Wire sizes come from the real leaf dtypes and shapes of the exchanged
trees: the broadcast moves one dense copy of w^{tau+1} per contacted
client, the upload one (possibly encoded) copy of z_i per client whose
upload completed. ``ByteLedger`` accumulates both per round and per client
on the host, in integers wherever the wire size is whole and in float64
only otherwise, so long runs cannot drift. Wire sizes are memoized per
(leaf shapes and dtypes, codec).

Upload codec
------------
Per leaf, each client keeps the top ceil(topk_frac * n) coordinates by
magnitude, snaps them onto a ``bits``-bit uniform grid, and the server
dequantizes before aggregation, substituting the client's previous upload
on dropped coordinates. Every (leaf, client) pair is one row of a packed
layout (``kernels/rows.py``): leaves grouped by dtype, leaf-major rows
back to back with no padding, each row as wide as its leaf (its keep
count on the top-k path). A whole tree encodes in one ``quantize_cols``
launch per dtype group over the group's row table, and the dense path's
leaves come out as views of that launch's output. With error feedback the
wire carries C(z - h) and both sides keep h <- h + C(z - h)
(``ef_accumulate`` on the dense path). With upload privacy the upload is
l1-clipped or taken as-is, perturbed with per-client noise, then encoded;
the dense quantized Laplace configuration is one ``private_quantize_cols``
launch per group.

JAX pads each group's rows to its widest leaf (an (R, n_max) array, or
(R, k_max) on the top-k path); the packed layout holds the same rows'
live coordinates only, so xlstm-125m's 129 leaves x 4 clients take 2.97 GB
an f32 plane, not the 79.7 GB of rows padded to its 38.6M-wide embedding.

Randomness is data. Where JAX passes a PRNG key, these functions take what
the key would have drawn: ``dither``, one packed uint32 plane (carried in
int32) per dtype group of the plan in plan order, laid out as the row
table that ``dither_shapes`` gives (None for a group that draws nothing),
and ``noise``, the unit-noise tree of ``draw_unit_noise``. A group that
needs a plane and gets None raises. ``codec_dither`` and
``draw_unit_noise`` draw them from keys of the JAX-compatible stream
(``repro_torch.random``) as the JAX functions do. A value of JAX's padded
plane depends only on its key and flat index (partitionable threefry), so
the packed dither, each row hashed from its padded row's first counter, is
JAX's bit for bit at the live entries; the noise is JAX's within one ulp
(log1p).

Every codec and privacy op here is per client: each row's keep set, scale,
l1 norm, clip factor and noise depend on that client's row alone, and no
op reduces across clients. So a rank of a mesh runs them on its block of
the clients (``sim/engine.py``), and only the draws need to know where
the block sits: ``dither_shapes(..., m_all, row0)`` gives the block's rows
the counters of JAX's whole padded plane, and ``draw_unit_noise(...,
row0)`` draws the block's values of each whole leaf.

Ties in the top-k select go to the lowest index, as ``lax.top_k`` breaks
them (a stable descending sort per leaf, truncated to the leaf's keep
count: the set and order ``lax.top_k`` picks from a padded row, whose
padding has magnitude -1). Where jitted XLA contracts a multiply-add
in the clip-and-noise step, the port rounds once in the same place
(``_clip_noise_tree``).
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import random
from repro_torch.core.treeutil import tree_leaves, tree_unflatten
from repro_torch.kernels.quant import ops as quant_ops
from repro_torch.kernels.quant.ref import laplace_from_u32, u32_to_unit
from repro_torch.kernels.rows import PackedRows, leaf_views
from repro_torch.telemetry.events import NULL_RECORDER

# ---------------------------------------------------------------------------
# byte accounting
# ---------------------------------------------------------------------------


def _leaf_meta(leaves) -> tuple:
    """Hashable (shape, dtype) signature of a flattened tree."""
    return tuple((tuple(x.shape), str(x.dtype)) for x in leaves)


# wire-size memos, keyed by (leaf signature[, codec])
_DENSE_BYTES_CACHE: dict = {}
_STACKED_BYTES_CACHE: dict = {}
_ENCODED_BYTES_CACHE: dict = {}


def tree_client_bytes(tree) -> int:
    """Dense wire bytes of ONE client's tree (leaves without client axis)."""
    leaves = tree_leaves(tree)
    key = _leaf_meta(leaves)
    got = _DENSE_BYTES_CACHE.get(key)
    if got is None:
        got = _DENSE_BYTES_CACHE[key] = sum(
            x.numel() * x.element_size() for x in leaves)
    return got


def stacked_client_bytes(tree) -> int:
    """Dense wire bytes of ONE client's slice of a stacked (m, ...) tree."""
    leaves = tree_leaves(tree)
    key = _leaf_meta(leaves)
    got = _STACKED_BYTES_CACHE.get(key)
    if got is None:
        got = _STACKED_BYTES_CACHE[key] = sum(
            (x.numel() // x.shape[0]) * x.element_size() for x in leaves)
    return got


@dataclasses.dataclass(frozen=True)
class CodecConfig:
    """Upload compression: keep top-k by magnitude, quantize kept values.

    topk_frac: fraction of each leaf's coordinates kept (1.0 = dense).
    bits: wire bits per kept value (>= 2), or 0 to send kept values raw.
    stochastic: unbiased dithered rounding (True) vs round-half-up.
    index_bytes: per-kept-coordinate index cost when sparse (k < n).
    error_feedback: EF21-style codec memory (``ef_roundtrip``); the wire
        format and byte accounting are unchanged.
    """

    topk_frac: float = 1.0
    bits: int = 8
    stochastic: bool = True
    index_bytes: int = 4
    error_feedback: bool = False

    def __post_init__(self):
        if not (0.0 < self.topk_frac <= 1.0):
            raise ValueError(f"topk_frac must be in (0, 1]; got {self.topk_frac}")
        if self.bits != 0 and self.bits < 2:
            raise ValueError(f"bits must be 0 (raw) or >= 2; got {self.bits}")


def _leaf_k(n: int, frac: float) -> int:
    return n if frac >= 1.0 else max(1, math.ceil(frac * n))


def encoded_client_bytes(tree, codec: CodecConfig | None) -> float:
    """Wire bytes of ONE client's (possibly encoded) upload of a stacked
    tree. Per leaf of n coordinates with k kept: dense (k == n) n*bits/8
    payload + 4 B scale; sparse k*bits/8 payload + k*index_bytes + 4 B
    scale; bits = 0 means raw leaf-dtype values (no scale when dense)."""
    if codec is None:
        return float(stacked_client_bytes(tree))
    leaves = tree_leaves(tree)
    key = (_leaf_meta(leaves), codec)
    got = _ENCODED_BYTES_CACHE.get(key)
    if got is not None:
        return got
    total = 0.0
    for x in leaves:
        n = x.numel() // x.shape[0]
        k = _leaf_k(n, codec.topk_frac)
        payload = k * (codec.bits / 8.0 if codec.bits else x.element_size())
        index = 0.0 if k == n else k * codec.index_bytes
        scale = 4.0 if codec.bits else (0.0 if k == n else 4.0)
        total += payload + index + scale
    _ENCODED_BYTES_CACHE[key] = total
    return total


def codec_event_attrs(codec: CodecConfig, *, n_clients: int,
                      up_bytes) -> dict:
    """Attrs dict for a telemetry ``codec_encode`` event."""
    return {"clients": int(n_clients),
            "bytes": float(up_bytes) * int(n_clients),
            "topk_frac": codec.topk_frac, "bits": codec.bits,
            "error_feedback": codec.error_feedback}


class LedgerSnapshot(NamedTuple):
    """O(1) running-total snapshot of a :class:`ByteLedger` (integer and
    float accumulators apart, so deltas are exact on the integer paths)."""

    up_i: int
    down_i: int
    up_f: float
    down_f: float

    @property
    def up(self) -> float:
        return float(self.up_i + self.up_f)

    @property
    def down(self) -> float:
        return float(self.down_i + self.down_f)


class ByteLedger:
    """Per-round, per-client cumulative communication record (host-side).

    Per-client counters accumulate in int64 whenever the per-transfer wire
    size is a whole number of bytes and in float64 only otherwise;
    ``up``/``down`` expose the combined float64 view. Scalar running totals
    make ``total_up``/``total_down`` and ``snapshot``/``delta`` O(1). With
    a telemetry recorder attached, every record call that carries a ``ts``
    emits a ``ledger_record`` event.
    """

    def __init__(self, m: int, *, telemetry=None):
        self.m = m
        self.telemetry = NULL_RECORDER if telemetry is None else telemetry
        self._up_i = np.zeros(m, np.int64)
        self._down_i = np.zeros(m, np.int64)
        self._up_f = np.zeros(m, np.float64)
        self._down_f = np.zeros(m, np.float64)
        self._tot_up_i = 0
        self._tot_down_i = 0
        self._tot_up_f = 0.0
        self._tot_down_f = 0.0
        self.rounds: list[dict] = []

    @property
    def up(self) -> np.ndarray:
        """(m,) cumulative uplink bytes per client (float64 view)."""
        return self._up_i + self._up_f

    @property
    def down(self) -> np.ndarray:
        """(m,) cumulative downlink bytes per client (float64 view)."""
        return self._down_i + self._down_f

    def record_round(self, *, down_mask: np.ndarray, up_mask: np.ndarray,
                     down_bytes: float, up_bytes, ts: float | None = None,
                     round_idx: int | None = None) -> dict:
        """down_mask: clients the server contacted; up_mask: clients whose
        upload completed; up_bytes: scalar or (m,) per-client size."""
        return self.record_counts(
            down_counts=np.asarray(down_mask, bool).astype(np.int64),
            up_counts=np.asarray(up_mask, bool).astype(np.int64),
            down_bytes=down_bytes, up_bytes=up_bytes, ts=ts,
            round_idx=round_idx)

    def record_counts(self, *, down_counts: np.ndarray,
                      up_counts: np.ndarray, down_bytes: float,
                      up_bytes, ts: float | None = None,
                      round_idx: int | None = None) -> dict:
        """Transfers as integer counts per client; n_down/n_up report
        distinct clients, the byte totals weight by the counts."""
        down_counts = np.asarray(down_counts, np.int64)
        up_counts = np.asarray(up_counts, np.int64)
        up_pc = np.broadcast_to(np.asarray(up_bytes, np.float64), (self.m,))
        d = down_counts * float(down_bytes)
        u = up_counts * up_pc
        if float(down_bytes).is_integer():
            di = down_counts * np.int64(down_bytes)
            self._down_i += di
            self._tot_down_i += int(di.sum())
        else:
            self._down_f += d
            self._tot_down_f += float(d.sum())
        if np.all(up_pc == np.floor(up_pc)):
            ui = up_counts * up_pc.astype(np.int64)
            self._up_i += ui
            self._tot_up_i += int(ui.sum())
        else:
            self._up_f += u
            self._tot_up_f += float(u.sum())
        rec = {"round": len(self.rounds), "down": float(d.sum()),
               "up": float(u.sum()), "n_down": int((down_counts > 0).sum()),
               "n_up": int((up_counts > 0).sum())}
        self.rounds.append(rec)
        if self.telemetry.enabled and ts is not None:
            self.telemetry.event(
                "ledger_record", ts=ts,
                round_idx=len(self.rounds) - 1 if round_idx is None
                else round_idx,
                up=rec["up"], down=rec["down"], n_up=rec["n_up"],
                n_down=rec["n_down"], total_up=self.total_up,
                total_down=self.total_down)
        return rec

    def snapshot(self) -> LedgerSnapshot:
        """O(1) copy of the running totals (int/float paths separate)."""
        return LedgerSnapshot(up_i=self._tot_up_i, down_i=self._tot_down_i,
                              up_f=self._tot_up_f, down_f=self._tot_down_f)

    def checkpoint(self) -> dict:
        """Deep copy of the full ledger state, for :meth:`restore`."""
        return {"up_i": self._up_i.copy(), "down_i": self._down_i.copy(),
                "up_f": self._up_f.copy(), "down_f": self._down_f.copy(),
                "tot": (self._tot_up_i, self._tot_down_i,
                        self._tot_up_f, self._tot_down_f),
                "rounds": [dict(r) for r in self.rounds]}

    def restore(self, chk: dict) -> None:
        """Rewind to a :meth:`checkpoint` (the checkpoint stays reusable)."""
        self._up_i = chk["up_i"].copy()
        self._down_i = chk["down_i"].copy()
        self._up_f = chk["up_f"].copy()
        self._down_f = chk["down_f"].copy()
        (self._tot_up_i, self._tot_down_i,
         self._tot_up_f, self._tot_down_f) = chk["tot"]
        self.rounds = [dict(r) for r in chk["rounds"]]

    def delta(self, since: LedgerSnapshot) -> dict:
        """Bytes moved since ``since`` -- exact on the integer paths."""
        return {"up": float((self._tot_up_i - since.up_i)
                            + (self._tot_up_f - since.up_f)),
                "down": float((self._tot_down_i - since.down_i)
                              + (self._tot_down_f - since.down_f))}

    @property
    def total_up(self) -> float:
        return float(self._tot_up_i + self._tot_up_f)

    @property
    def total_down(self) -> float:
        return float(self._tot_down_i + self._tot_down_f)

    @property
    def total(self) -> float:
        return self.total_up + self.total_down


# ---------------------------------------------------------------------------
# batched multi-leaf encode plan (cached per leaf shapes/dtypes and codec)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _GroupPlan:
    """One dtype group of the packed layout.

    ``index``/``shape``/``n``/``k`` are per leaf (flattened-tree position,
    stacked shape, flat coordinate count, keep count). ``rows(m)`` is the
    row table of the values the group's kernel takes: leaf-major, rows
    [l*m, (l+1)*m) belong to leaf l, each n_l wide on the dense path and
    k_l on the top-k path, with no padding; a row's dither counters start
    at r * n_max (dense) or r * k_max (top-k), JAX's padded plane's.
    """

    index: tuple[int, ...]
    shape: tuple[tuple[int, ...], ...]
    n: tuple[int, ...]
    k: tuple[int, ...]
    n_max: int
    k_max: int
    dense: bool       # every leaf keeps all coordinates (k == n)

    def rows(self, m: int, m_all: int = 0, row0: int = 0) -> PackedRows:
        return PackedRows(self.n if self.dense else self.k, m, m_all, row0)


_PLAN_CACHE: dict = {}


def _codec_plan(leaves, codec: CodecConfig) -> tuple[_GroupPlan, ...]:
    key = (_leaf_meta(leaves), codec)
    plan = _PLAN_CACHE.get(key)
    if plan is not None:
        return plan
    by_dtype: dict[str, list[int]] = {}
    for i, x in enumerate(leaves):
        by_dtype.setdefault(str(x.dtype), []).append(i)
    groups = []
    for idxs in by_dtype.values():
        ns = tuple(leaves[i].numel() // leaves[i].shape[0] for i in idxs)
        ks = tuple(_leaf_k(n, codec.topk_frac) for n in ns)
        groups.append(_GroupPlan(
            index=tuple(idxs),
            shape=tuple(tuple(leaves[i].shape) for i in idxs),
            n=ns, k=ks, n_max=max(ns), k_max=max(ks),
            dense=all(k == n for k, n in zip(ks, ns))))
    plan = _PLAN_CACHE[key] = tuple(groups)
    return plan


def _pack(blocks) -> torch.Tensor:
    """Leaf blocks -> one flat buffer, leaf-major, no padding."""
    return torch.cat([x.reshape(-1) for x in blocks])


def _unpack(flat: torch.Tensor, gp: _GroupPlan, m: int) -> list:
    """The dense group's leaves as views of a packed buffer."""
    return [v.view(shape)
            for v, shape in zip(leaf_views(flat, gp.rows(m)), gp.shape)]


@functools.cache
def _row_counts(rows: PackedRows, device: torch.device) -> torch.Tensor:
    """(R,) int32 live count of each row, its width (every packed column is
    a live one), built once per (row table, device) and kept, as the row
    tables are (a captured graph reads it); callers only read it."""
    return torch.from_numpy(rows.row_widths().astype(np.int32)).to(device)


def _row_amax(blocks) -> torch.Tensor:
    """(R,) f32 per-row max |value| over leaf blocks (m, w), leaf-major. Max
    is exact, so it is the padded row's: padding adds zeros to a max of
    magnitudes."""
    return torch.cat([torch.amax(torch.abs(x.to(torch.float32)), dim=1)
                      for x in blocks])


def _topk_leaf(x: torch.Tensor, k: int) -> torch.Tensor:
    """(m, k) indices of the top-k magnitudes per row of one leaf block,
    descending, ties to the lowest index (as ``lax.top_k``)."""
    return torch.sort(torch.abs(x.to(torch.float32)), dim=1, descending=True,
                      stable=True).indices[:, :k]


def _quantize_kept(vals: list, rows: PackedRows, codec: CodecConfig, u32):
    """The top-k path's kept values (m, k_l) per leaf, quantized in one
    ``quantize_cols`` launch over their packed rows, or raw where bits is
    0. Every packed column is a kept one, so the fallback is never read."""
    if not codec.bits:
        return vals
    v_p = _pack(vals)
    enc = quant_ops.quantize_cols(v_p, v_p, _row_amax(vals),
                                  _row_counts(rows, v_p.device), codec.bits,
                                  u32, rows=rows)
    return leaf_views(enc, rows)


def _group_rows(gp: _GroupPlan, m: int, codec: CodecConfig, m_all: int = 0,
                row0: int = 0):
    """The row table of the group's dither, or None where it draws none."""
    if not codec.bits or not codec.stochastic:
        return None
    return gp.rows(m, m_all, row0)


def uses_fused_private(codec: CodecConfig | None, privacy) -> bool:
    """The dense quantized Laplace configuration: one fused
    ``private_quantize_cols`` launch per dtype group."""
    return (codec is not None and codec.bits >= 2 and codec.topk_frac >= 1.0
            and privacy.mechanism == "laplace")


def dither_shapes(tree_z, codec: CodecConfig | None, *,
                  fused_private: bool = False, m_all: int = 0,
                  row0: int = 0) -> list:
    """Per dtype group of the plan, in plan order: the row table
    (``PackedRows``) of the packed uint32 dither plane the round-trip of
    ``tree_z`` consumes, or None where that group draws nothing.
    ``fused_private`` asks for the planes of the fused private path (see
    ``uses_fused_private``). ``tree_z`` may hold clients ``row0`` on of
    ``m_all`` (a rank's block): the tables then take their rows' counters
    of the whole plane."""
    if codec is None:
        return []
    leaves = tree_leaves(tree_z)
    m = leaves[0].shape[0]
    plan = _codec_plan(leaves, codec)
    if fused_private:
        return [gp.rows(m, m_all, row0) if codec.stochastic else None
                for gp in plan]
    return [_group_rows(gp, m, codec, m_all, row0) for gp in plan]


def _take_dither(dither, g: int, rows, device) -> torch.Tensor | None:
    if rows is None:
        return None
    u = None if dither is None or g >= len(dither) else dither[g]
    if u is None:
        raise ValueError(f"dtype group {g} needs a dither plane of "
                         f"{rows.numel} values")
    if u.dim() != 1 or u.numel() != rows.numel:
        raise ValueError(f"dtype group {g}: dither plane {tuple(u.shape)}, "
                         f"expected ({rows.numel},) packed")
    return u.to(device)


# ---------------------------------------------------------------------------
# codec round-trip (what the server holds after dequantization)
# ---------------------------------------------------------------------------

def _codec_group(z_leaves, fb_leaves, u32, codec: CodecConfig,
                 gp: _GroupPlan):
    """Fused round-trip of one dtype group; returns decoded leaves."""
    m = z_leaves[0].shape[0]
    if gp.dense and not codec.bits:
        return z_leaves  # every coordinate kept and sent raw: identity
    rows = gp.rows(m)
    z = [x.reshape(m, -1) for x in z_leaves]

    if gp.dense:
        # no coordinate dropping: quantize every packed column in place
        z_p = _pack(z)
        out = quant_ops.quantize_cols(z_p, z_p, _row_amax(z),
                                      _row_counts(rows, z_p.device),
                                      codec.bits, u32, rows=rows)
        return _unpack(out, gp, m)

    idx = [_topk_leaf(x, k) for x, k in zip(z, gp.k)]
    vals = _quantize_kept([torch.gather(x, 1, i) for x, i in zip(z, idx)],
                          rows, codec, u32)
    return [fb.reshape(m, -1).scatter(1, i, v).view(shape)
            for fb, i, v, shape in zip(fb_leaves, idx, vals, gp.shape)]


def codec_roundtrip(tree_z, tree_fallback, dither, codec: CodecConfig | None):
    """Encode + decode every client's upload; stacked (m, ...) trees.

    ``tree_fallback`` supplies dropped coordinates (the server's stale
    copy). Identity when codec is None or is the dense raw codec.
    ``dither``: one packed plane per plan group, as ``dither_shapes``
    gives.
    """
    if codec is None or (codec.topk_frac >= 1.0 and not codec.bits):
        return tree_z
    leaves = tree_leaves(tree_z)
    fb_leaves = tree_leaves(tree_fallback)
    m = leaves[0].shape[0]
    out = list(leaves)
    for g, gp in enumerate(_codec_plan(leaves, codec)):
        u32 = _take_dither(dither, g, _group_rows(gp, m, codec),
                           leaves[0].device)
        dec = _codec_group([leaves[i] for i in gp.index],
                           [fb_leaves[i] for i in gp.index], u32, codec, gp)
        for i, leaf in zip(gp.index, dec):
            out[i] = leaf
    return tree_unflatten(tree_z, out)


# ---------------------------------------------------------------------------
# error-feedback round-trip (EF21-style codec memory)
# ---------------------------------------------------------------------------

def _ef_group(z_leaves, h_leaves, u32, codec: CodecConfig, gp: _GroupPlan):
    """Fused EF step of one dtype group; returns the new shared memories."""
    m = z_leaves[0].shape[0]
    if gp.dense and not codec.bits:
        # the wire carries the full residual exactly: bit-exact identity
        return z_leaves
    rows = gp.rows(m)
    z = [x.reshape(m, -1) for x in z_leaves]
    h = [x.reshape(m, -1) for x in h_leaves]

    if gp.dense:
        # the scale is taken of the f32 residual: jitted XLA drops the
        # round trip through a bf16 residual (excess precision)
        scale = torch.cat([
            torch.amax(torch.abs(a.to(torch.float32) - b.to(torch.float32)),
                       dim=1) for a, b in zip(z, h)])
        out = quant_ops.ef_accumulate(_pack(z), _pack(h), scale, codec.bits,
                                      u32, rows=rows)
        return _unpack(out, gp, m)

    r = [a - b for a, b in zip(z, h)]
    idx = [_topk_leaf(x, k) for x, k in zip(r, gp.k)]
    vals = _quantize_kept([torch.gather(x, 1, i) for x, i in zip(r, idx)],
                          rows, codec, u32)
    # accumulate the kept residuals
    return [b.scatter_add(1, i, v).view(shape)
            for b, i, v, shape in zip(h, idx, vals, gp.shape)]


def ef_roundtrip(tree_z, tree_h, dither, codec: CodecConfig | None):
    """Error-feedback encode + decode; stacked (m, ...) trees.

    ``tree_h`` is the shared codec memory. Returns the new memory, which is
    also what the server now holds for each client. Identity when codec is
    None, and exact identity for the dense raw codec.
    """
    if codec is None or (codec.topk_frac >= 1.0 and not codec.bits):
        return tree_z
    leaves = tree_leaves(tree_z)
    h_leaves = tree_leaves(tree_h)
    m = leaves[0].shape[0]
    out = list(leaves)
    for g, gp in enumerate(_codec_plan(leaves, codec)):
        u32 = _take_dither(dither, g, _group_rows(gp, m, codec),
                           leaves[0].device)
        dec = _ef_group([leaves[i] for i in gp.index],
                        [h_leaves[i] for i in gp.index], u32, codec, gp)
        for i, leaf in zip(gp.index, dec):
            out[i] = leaf
    return tree_unflatten(tree_z, out)


# ---------------------------------------------------------------------------
# private round-trip (clip + DP noise in front of the codec)
# ---------------------------------------------------------------------------

def _gaussian_from_u32(u32: torch.Tensor) -> torch.Tensor:
    """Unit Gaussian noise from uint32 bits via the inverse CDF, the uniform
    clamped away from {0, 1}. ``ndtri`` may differ from JAX's by a few
    ulps."""
    u = torch.clamp(u32_to_unit(u32), 1e-7, 1.0 - 1e-7)
    return torch.special.ndtri(u)


def codec_dither(key: torch.Tensor, shapes: list) -> list:
    """The codec's dither planes for one round: ``key`` split once per plan
    group, as ``codec_roundtrip`` splits it in JAX, and each group's
    packed plane drawn from its own key where ``shapes``
    (``dither_shapes``) gives a row table: ``jax.random.bits`` of the
    group's padded plane at the live entries (``random.bits_rows``, one
    launch), the 32 bits carried in int32 as the quantizer kernels take
    them; None elsewhere."""
    if all(s is None for s in shapes):
        return [None] * len(shapes)
    keys = random.split(key, len(shapes))
    return [None if s is None else random.bits_rows(keys[g], s)
            for g, s in enumerate(shapes)]


def draw_unit_noise(pkey: torch.Tensor, tree_like, privacy,
                    row0: int = 0):
    """Unit-scale DP noise tree, f32 leaves shaped like ``tree_like``: JAX's
    ``_draw_noise_leaves``, ``pkey`` split once per leaf in flatten order
    and each leaf's bits mapped through the mechanism's inverse CDF. Drawn
    on ``pkey``'s device. Where ``tree_like`` holds clients ``row0`` on of
    stacked leaves (a rank's block), each leaf's values are those rows of
    the whole leaf's draw."""
    to_noise = (laplace_from_u32 if privacy.mechanism == "laplace"
                else _gaussian_from_u32)
    leaves = tree_leaves(tree_like)
    keys = random.split(pkey, len(leaves))
    return tree_unflatten(tree_like, [
        to_noise(random.bits(keys[i], tuple(x.shape),
                             row0 * math.prod(x.shape[1:])))
        for i, x in enumerate(leaves)])


# the JAX package's per-client l1 (abs(x) @ ones under jit) sums a one-leaf
# tree's row in column order, checked up to 40 columns; rows up to this
# width are summed so here, wider rows and trees of several leaves in
# another order than XLA's, within 2 ulp (tests/test_torch_transport.py)
_SEQUENTIAL_L1_WIDTH = 32


def _client_l1(leaves, m: int) -> torch.Tensor:
    """(m,) per-client l1 norm over a stacked tree, f32, summed leaf by leaf
    in flatten order."""
    tot = torch.zeros(m, dtype=torch.float32, device=leaves[0].device)
    for x in leaves:
        a = torch.abs(x.to(torch.float32)).reshape(m, -1)
        if a.shape[1] <= _SEQUENTIAL_L1_WIDTH:
            row = torch.zeros_like(tot)
            for j in range(a.shape[1]):
                row = row + a[:, j]
        else:
            row = a.sum(dim=1)
        tot = tot + row
    return tot


def _f32(v: float, like: torch.Tensor) -> torch.Tensor:
    # a fill on the device, not a copy from the host: a captured CUDA graph
    # takes no host-to-device copy
    return torch.full((), v, dtype=torch.float32, device=like.device)


def privacy_row_params(l1: torch.Tensor, privacy):
    """Per-client (clip factor, noise scale) from the upload l1 norms.

    Surrogate mode uses the paper's data-dependent sensitivity
    ``2 * ||z||_1`` (eq. 39) and never rescales; clip mode first enforces
    ``||z||_1 <= clip`` (factor min(1, clip / ||z||_1)) and uses ``2 *
    clip``. Laplace scale is ``b = delta_hat / eps``; the Gaussian std
    multiplies in ``sqrt(2 ln(1.25 / delta))``. Every constant is rounded to
    f32 first and each division is a true divide, as in JAX.
    """
    if privacy.sensitivity == "clip":
        clip = _f32(privacy.clip, l1)
        clipf = torch.clamp_max(
            torch.div(clip, torch.clamp_min(l1, 1e-30)), 1.0)
        delta_hat = torch.full_like(l1, 2.0 * privacy.clip)
    else:
        clipf = torch.ones_like(l1)
        delta_hat = 2.0 * l1
    b = delta_hat * _f32(1.0 / privacy.eps, l1)
    if privacy.mechanism == "gaussian":
        b = b * _f32(math.sqrt(2.0 * math.log(1.25 / privacy.delta)), l1)
    return clipf, b


def _per_row(v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return v.reshape((x.shape[0],) + (1,) * (x.dim() - 1))


def _clip_noise_tree(tree_z, noise, clipf, b, privacy):
    """Sequential clip + noise per leaf, z_i * clipf_i + b_i * noise with
    one rounding where jitted XLA has one: fma(z_i, clipf_i, b_i * noise) in
    clip mode; in surrogate mode XLA folds the multiply by the constant
    clip factor 1 away and contracts the noise term, fma(b_i, noise, z_i).
    """
    out = []
    for x, n in zip(tree_leaves(tree_z), tree_leaves(noise)):
        x32, br = x.to(torch.float32), _per_row(b, x)
        if privacy.sensitivity == "clip":
            y = torch.addcmul(br * n, x32, _per_row(clipf, x))
        else:
            y = torch.addcmul(x32, br, n)
        out.append(y.to(x.dtype))
    return tree_unflatten(tree_z, out)


def _fused_private(tree_z, dither, noise, codec: CodecConfig, clipf, b):
    """Dense quantized Laplace path: ONE fused clip + noise + quantize
    launch per dtype group."""
    leaves = tree_leaves(tree_z)
    n_leaves = tree_leaves(noise)
    m = leaves[0].shape[0]
    out = list(leaves)
    for g, gp in enumerate(_codec_plan(leaves, codec)):
        rows = gp.rows(m)
        z = [leaves[i].reshape(m, -1) for i in gp.index]
        # the unit noise packs into the same leaf-major layout
        lap = _pack([n_leaves[i] for i in gp.index])
        cf_r = clipf.repeat(len(gp.index))
        b_r = b.repeat(len(gp.index))
        # the quantizer range covers the CLIPPED pre-noise magnitudes;
        # noisy outliers saturate at the grid edge (bounded-output DP)
        scale = _row_amax(z) * cf_r
        u32q = _take_dither(dither, g, rows if codec.stochastic else None,
                            z[0].device)
        z_p = _pack(z)
        dec = quant_ops.private_quantize_cols(
            z_p, z_p, cf_r, b_r, scale, _row_counts(rows, z_p.device),
            codec.bits, u32q, lap, rows=rows)
        for i, leaf in zip(gp.index, _unpack(dec, gp, m)):
            out[i] = leaf
    return tree_unflatten(tree_z, out)


def private_roundtrip(tree_z, tree_fallback, dither, noise,
                      codec: CodecConfig | None, privacy):
    """Clip + DP noise + codec round-trip; stacked (m, ...) trees.

    ``noise`` is the unit-noise tree shaped like ``tree_z``; ``privacy`` a
    PrivacyConfig or None. With no noise to add (None or eps == 0) this IS
    ``codec_roundtrip``. The dense quantized Laplace configuration runs as
    one fused launch per dtype group; every other one applies the same
    clip + noise first and lets the codec finish.
    """
    if privacy is None or privacy.eps <= 0:
        return codec_roundtrip(tree_z, tree_fallback, dither, codec)
    leaves = tree_leaves(tree_z)
    clipf, b = privacy_row_params(_client_l1(leaves, leaves[0].shape[0]),
                                  privacy)
    if uses_fused_private(codec, privacy):
        return _fused_private(tree_z, dither, noise, codec, clipf, b)
    noisy = _clip_noise_tree(tree_z, noise, clipf, b, privacy)
    return codec_roundtrip(noisy, tree_fallback, dither, codec)


def private_ef_roundtrip(tree_z, tree_h, dither, noise,
                         codec: CodecConfig | None, privacy):
    """Error-feedback variant: EF compresses the NOISY upload's residual
    (clip + noise in front, then ``ef_roundtrip`` unchanged)."""
    if privacy is None or privacy.eps <= 0:
        return ef_roundtrip(tree_z, tree_h, dither, codec)
    leaves = tree_leaves(tree_z)
    clipf, b = privacy_row_params(_client_l1(leaves, leaves[0].shape[0]),
                                  privacy)
    noisy = _clip_noise_tree(tree_z, noise, clipf, b, privacy)
    return ef_roundtrip(noisy, tree_h, dither, codec)
