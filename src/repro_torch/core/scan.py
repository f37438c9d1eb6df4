"""A round body run over the rows of a stream: the port's counterpart of
``jax.lax.scan`` over the FedEPM, baseline and simulator round bodies.

``ScanProgram(step)`` runs ``step(carry, x) -> (carry, ys)``, with ``carry``
a list of tensors, ``x`` one row of each stream tensor and ``ys`` a list of
tensors, over the first n rows of the streams, and stacks each ``ys`` entry
over the rows. The step computes its new carry into fresh tensors (none a
view of the old carry: the graph copies them over the old one in turn).

On the CPU it is a plain loop. On the card the step is captured once as a
CUDA graph and replayed once per row:

- the carry lives in static buffers that the graph reads and then
  overwrites in place, the counterpart of JAX's donated carry;
- the streams are copied once per run into static buffers of a fixed
  number of rows, and the graph reads its row through a device cursor that it
  advances itself, so nothing on the host changes between replays;
- each row's ``ys`` go into static stacks at the cursor.

The capture follows PyTorch's pattern for a backward pass: one call of the
step on a side stream first (it also loads the kernels' libraries and fills
the lazy caches: ENS offsets, codec plans), then ``torch.cuda.graph``.
Whatever in the step waits for the host (``.item()``, ``.cpu()``, a copy
from pageable memory to the card) makes the capture raise; nothing falls
back to running the step eagerly.

Two programs may share one carry (``ScanProgram(step, share=other)``): the
async engine's fire and merge bodies both read and write the algorithm
state, and the host replays them one row at a time in the order it
recorded (``begin``, then ``advance`` once per row, then ``outputs``).
New carry shapes drop every captured graph on that carry.

Launch counters: a kernel's wrapper adds to its ``.launches`` when it is
called, and under capture it is called without launching. The program
takes those counts off again after the capture and adds them back once per
replay, so each counter still counts the kernel's launches on the card.
``GRAPH_STATS`` sums, over all programs since ``reset_graph_stats``, the
captures, the replays and the kernel launches made by replays. The
collectives' census (``sharding/comm.py``) is kept the same way: a
collective captured in the graph (the engine's round on a mesh) is taken
off the census after the capture and recorded again at each replay.
"""
from __future__ import annotations

import gc

import numpy as np
import torch

from repro_torch.core.treeutil import tree_leaves, tree_unflatten
from repro_torch.kernels.counters import launch_counters
from repro_torch.sharding import comm

GRAPH_STATS: dict = {}


def reset_graph_stats() -> None:
    GRAPH_STATS.clear()
    GRAPH_STATS.update(captures=0, replays=0,
                       kernel_launches={n: 0 for n in launch_counters()})


reset_graph_stats()


class _CarryBox:
    """The carry that one or more programs step: its tensors and a version
    that changes whenever they are made anew (a graph captured on older
    buffers is stale)."""

    def __init__(self):
        self.carry: list | None = None
        self.version = 0
        self.captured = False  # some program holds a graph on this version


class ScanProgram:
    """``step`` over the rows of a stream; see the module docstring. A
    subclass may define ``step`` as a method instead of passing it;
    ``share`` is another program whose carry this one steps too."""

    def __init__(self, step=None, share: "ScanProgram | None" = None):
        if step is not None:
            self.step = step
        self._box = share._box if share is not None else _CarryBox()
        self.graph_launches: dict = {}  # kernel -> launches per replay
        self.graph_census: list = []    # the collectives of one replay
        self._graph = None
        self._graph_version = -1
        self._xs: list = []
        self._ys: list = []
        self._rows: list = []
        self._t = 0
        self._cursor = None

    @property
    def carry(self) -> list | None:
        return self._box.carry

    @carry.setter
    def carry(self, value) -> None:
        self._box.carry = value

    def load(self, carry) -> None:
        """Make ``carry`` (a list of tensors) the program's carry. On the
        card it is copied into the static buffers while their shapes
        match; new shapes drop the captured graphs."""
        carry = list(carry)
        box = self._box
        if box.captured and [(c.shape, c.dtype) for c in carry] == [
                (b.shape, b.dtype) for b in box.carry]:
            for b, c in zip(box.carry, carry):
                b.copy_(c)
            return
        box.carry = [c.clone() for c in carry]
        box.version += 1
        box.captured = False

    def run(self, xs, n: int, capacity: int = 0) -> list:
        """Step through rows 0..n-1 of the stream tensors ``xs`` (leading
        axis >= n) from the loaded carry; returns the stacked ``ys``,
        (n, ...) each. On the card they are views of the static stacks,
        overwritten by the next run; a capture sizes the stream buffers
        for ``max(n, capacity)`` rows, and a longer run captures again."""
        self.begin(xs, n, capacity)
        for _ in range(n):
            self.advance()
        return self.outputs(n)

    def begin(self, xs, n: int, capacity: int = 0) -> None:
        """Take the streams of a run of n rows (``run``'s arguments); the
        rows are then stepped one ``advance`` at a time."""
        self._t = 0
        if not self.carry[0].is_cuda:
            self._xs, self._rows = list(xs), []
            return
        sig = [(x.shape[1:], x.dtype) for x in xs]
        if self._graph is None or self._graph_version != self._box.version \
                or n > self._xs[0].shape[0] or sig != [
                (b.shape[1:], b.dtype) for b in self._xs]:
            self._capture(xs, n, max(n, capacity))
        for b, x in zip(self._xs, xs):
            b[:n].copy_(x[:n])
        self._cursor.zero_()

    def advance(self) -> None:
        """Step the next row: the step on the CPU, one replay on the card."""
        t = self._t
        self._t += 1
        if not self.carry[0].is_cuda:
            self.carry, ys = self.step(self.carry, [x[t] for x in self._xs])
            self._rows.append(list(ys))
            return
        self._graph.replay()
        counters = launch_counters()
        for name, k in self.graph_launches.items():
            counters[name].launches += k
            GRAPH_STATS["kernel_launches"][name] += k
        comm.CENSUS.extend(dict(r) for r in self.graph_census)
        GRAPH_STATS["replays"] += 1

    def outputs(self, n: int) -> list:
        """The stacked ``ys`` of the n rows stepped since ``begin``."""
        if not self.carry[0].is_cuda:
            return [torch.stack(col) for col in zip(*self._rows)]
        return [y[:n] for y in self._ys]

    def _capture(self, xs, n: int, cap: int) -> None:
        dev = self.carry[0].device
        self._xs = [torch.zeros((cap,) + tuple(x.shape[1:]), dtype=x.dtype,
                                device=dev) for x in xs]
        for b, x in zip(self._xs, xs):
            b[:n].copy_(x[:n])
        self._cursor = torch.zeros(1, dtype=torch.int64, device=dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            _, ys = self.step(self.carry, [b[0] for b in self._xs])
        torch.cuda.current_stream(dev).wait_stream(side)
        self._ys = [torch.zeros((cap,) + tuple(y.shape), dtype=y.dtype,
                                device=dev) for y in ys]
        counters = launch_counters()
        before = {name: fn.launches for name, fn in counters.items()}
        census0 = len(comm.CENSUS)
        graph = torch.cuda.CUDAGraph()
        # a collection during the capture could destroy another program's
        # graph, a call that invalidates the capture
        gc_was_on = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph):
                x = [b.index_select(0, self._cursor).squeeze(0)
                     for b in self._xs]
                new, ys = self.step(self.carry, x)
                for b, c in zip(self.carry, new):
                    b.copy_(c)
                for s, y in zip(self._ys, ys):
                    s.index_copy_(0, self._cursor, y.unsqueeze(0))
                self._cursor.add_(1)
        finally:
            if gc_was_on:
                gc.enable()
            self.graph_launches = {
                name: fn.launches - before[name]
                for name, fn in counters.items()
                if fn.launches != before[name]}
            for name, fn in counters.items():
                fn.launches = before[name]
            self.graph_census = comm.CENSUS[census0:]
            del comm.CENSUS[census0:]
        self._graph = graph
        self._graph_version = self._box.version
        self._box.captured = True
        GRAPH_STATS["captures"] += 1


class StateCarry:
    """The algorithm state (w_tau, W, Z, key) of a ``FedEPMState`` or
    ``BaselineState`` as a flat carry list, and back."""

    def __init__(self, state):
        self.cls = type(state)
        self.like = state
        self.sizes = [len(tree_leaves(t)) for t in
                      (state.w_tau, state.W, state.Z)]

    def leaves(self, state) -> list:
        return (tree_leaves(state.w_tau) + tree_leaves(state.W)
                + tree_leaves(state.Z) + [state.key])

    def state(self, leaves, k):
        a, b, c = self.sizes
        return self.cls(
            w_tau=tree_unflatten(self.like.w_tau, leaves[:a]),
            W=tree_unflatten(self.like.W, leaves[a:a + b]),
            Z=tree_unflatten(self.like.Z, leaves[a + b:a + b + c]),
            k=k, key=leaves[a + b + c])


def host_bools(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, bool)


def round_starts(k: int, k0: int, abandoned: np.ndarray) -> list:
    """Each round's k: it advances by k0 past every round not abandoned."""
    ks = []
    for ab in abandoned:
        ks.append(k)
        k += 0 if ab else k0
    return ks


def state_scan(body, sched_fn, k0: int):
    """``run(state, masks, abandoned) -> (state, stacked metrics)`` of the
    algorithms' ``make_scan_rounds``: ``body(state, (mask, abandoned,
    *schedule row))`` over the (K, m) mask stream, with ``sched_fn(ks,
    device)`` the schedule stream for the rounds' k (a tensor or a tuple of
    them). The program is captured at the first call on the card and
    replayed after; the state handed in is copied, never written."""
    held: dict = {}

    def step(carry, x):
        st, met = body(held["carry"].state(carry, 0), tuple(x))
        held["metrics"] = type(met)
        return held["carry"].leaves(st), list(met)

    prog = ScanProgram(step)

    def run(state, masks, abandoned):
        ab = host_bools(abandoned)
        dev = tree_leaves(state.W)[0].device
        sched = sched_fn(round_starts(int(state.k), k0, ab), dev)
        xs = [torch.from_numpy(host_bools(masks)).to(dev),
              torch.from_numpy(ab).to(dev)]
        xs += list(sched) if isinstance(sched, tuple) else [sched]
        held["carry"] = StateCarry(state)
        prog.load(held["carry"].leaves(state))
        ys = prog.run(xs, len(ab))
        out = held["carry"].state([c.clone() for c in prog.carry],
                                  int(state.k) + k0 * int((~ab).sum()))
        return out, held["metrics"](*ys)

    return run
