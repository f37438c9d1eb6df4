"""Multi-cell sweep driver: one command runs a ``[sweep]`` spec grid.

A copy of ``repro.launch.sweep_run`` (JSON, TOML and numpy only), so that the port
imports nothing of the JAX package.

``python -m repro_torch.launch.sweep_run --spec FILE.toml --out-dir DIR`` reads
a spec file carrying a ``[sweep]`` table (dotted-path axes + ``seeds``;
:func:`repro_torch.spec.sweep.load_sweep`, docs/spec.md), expands the
cross-product, and executes every cell:

* **in parallel** across local processes (``--jobs N``; ``--jobs 1`` runs
  inline in this process). Each worker process holds its own
  ``repro_torch.spec.build`` task-data cache, so cells sharing a resolved
  ``TaskSpec`` reuse ONE device copy of the batches and the warm jit
  caches within that worker;
* **resumably**: each finished cell writes an atomic per-cell result file
  under ``DIR/cells/`` (temp file + ``os.replace``) recording the cell
  spec, runner, context and summary. A rerun of the same sweep skips
  every cell whose result file is present, ``ok``, and fingerprint-equal
  (same spec/runner/ctx) -- so a killed run re-executes only the
  missing/failed cells;
* into **one merged artifact**: when every cell is ``ok``, the driver
  writes ``DIR/merged.json`` -- a self-describing document (base spec,
  axes, seeds, cell name -> run summary). The default runner attaches the
  run-telemetry recorder (``--no-telemetry`` to opt out), so each summary
  carries the ``"telemetry"`` block from docs/observability.md; the merge
  strips that block's wall-clock fields (``wall_s``,
  ``rounds_per_sec_wall``), which makes the merged artifact byte-for-byte
  deterministic: independent of ``--jobs``, and identical between an
  uninterrupted run and a kill + resume (pinned in
  tests/test_torch_spec.py). Per-cell wall times stay in the cell files.

Any cell failure leaves a ``failed`` cell file (re-executed on rerun),
skips the merge, and exits nonzero -- a broken grid can never pass CI
silently. The port's Fig. 8 twin (``repro_torch.benchmarks.fig8_faults``)
runs its grid through :func:`execute_cells`/:func:`write_merged` with a
custom runner.

Exit codes: 0 all cells ok (merged written); 1 any cell failed; 3 cells
left pending by ``--max-cells`` (resume by rerunning).
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import hashlib
import json
import os
import pathlib
import re
import sys
import tempfile
import time
import traceback
from dataclasses import dataclass, field
from typing import Mapping, Sequence

SCHEMA = 1
DEFAULT_RUNNER = "repro_torch.launch.sweep_run:run_cell"
# wall-clock fields inside summary["telemetry"] -- everything else in a
# run summary is a pure function of the spec, which is what makes the
# merged artifact byte-identical across --jobs counts and resumes
VOLATILE_TELEMETRY_KEYS = ("wall_s", "rounds_per_sec_wall")

EXIT_OK, EXIT_FAILED, EXIT_PENDING = 0, 1, 3


# ---------------------------------------------------------------------------
# runners
# ---------------------------------------------------------------------------

def run_cell(spec, ctx: Mapping) -> dict:
    """The default cell runner: ``spec.build().run()`` -> summary dict.

    ``ctx["telemetry"]`` (default True) attaches the event recorder when
    the spec itself leaves telemetry off -- observational-only, so the
    rest of the summary is unchanged (docs/observability.md).
    ``ctx["device"]`` (default the card) is the torch device the cell runs
    on.
    """
    if ctx.get("telemetry", True) and not spec.telemetry.enabled:
        spec = spec.replace(**{"telemetry.enabled": True})
    return spec.build(device=ctx.get("device")).run()


def _resolve_runner(ref: str):
    """``"module:attr"`` -> callable ``runner(spec, ctx) -> summary``."""
    import importlib
    mod, _, attr = ref.partition(":")
    if not mod or not attr:
        raise ValueError(f"runner ref {ref!r} is not 'module:attr'")
    fn = getattr(importlib.import_module(mod), attr)
    if not callable(fn):
        raise TypeError(f"runner ref {ref!r} resolved to non-callable "
                        f"{fn!r}")
    return fn


# ---------------------------------------------------------------------------
# per-cell result files
# ---------------------------------------------------------------------------

def cell_filename(name: str) -> str:
    """Filesystem-safe, collision-free file name for one cell.

    Cell names carry ``/``, ``=`` and arbitrary value text; the readable
    prefix is sanitized and truncated, and a short digest of the FULL
    name keeps two long names from colliding after truncation.
    """
    safe = re.sub(r"[^A-Za-z0-9._=-]+", "_", name).strip("_")[:80]
    digest = hashlib.sha1(name.encode()).hexdigest()[:10]
    return f"{safe}.{digest}.json"


def _atomic_write_json(path: pathlib.Path, doc: dict) -> None:
    """Write ``doc`` via temp file + ``os.replace`` in the target dir, so
    a kill mid-write never leaves a truncated result file behind."""
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=path.parent, prefix=path.name + ".",
                               suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
            f.write("\n")
        os.replace(tmp, path)
    except BaseException:
        with contextlib.suppress(OSError):
            os.unlink(tmp)
        raise


def _read_cell(path: pathlib.Path) -> dict | None:
    try:
        return json.loads(path.read_text())
    except (OSError, json.JSONDecodeError):
        return None                      # missing/corrupt == not done


def _norm(doc):
    """JSON-round-trip normalization, so fingerprints compare equal
    between the in-memory dict and the one read back from a cell file."""
    return json.loads(json.dumps(doc, sort_keys=True))


def _execute_one(payload) -> tuple[str, str, str | None]:
    """Run one cell and write its result file. -> (name, status, error).

    Top-level (picklable) so it runs identically inline and in spawned
    pool workers; the spec travels as its ``to_dict`` form.
    """
    name, spec_dict, runner_ref, ctx, path_str = payload
    from repro_torch.spec import ExperimentSpec
    path = pathlib.Path(path_str)
    spec = ExperimentSpec.from_dict(spec_dict)
    rec = {"schema": SCHEMA, "name": name, "spec": spec_dict,
           "runner": runner_ref, "ctx": ctx}
    t0 = time.perf_counter()
    try:
        runner = _resolve_runner(runner_ref)
        rec.update(status="ok", summary=runner(spec, ctx),
                   wall_s=time.perf_counter() - t0)
        err = None
    except Exception as e:  # noqa: BLE001 - per-cell isolation is the point
        err = f"{type(e).__name__}: {e}"
        rec.update(status="failed", error=err,
                   traceback=traceback.format_exc(),
                   wall_s=time.perf_counter() - t0)
    _atomic_write_json(path, rec)
    return name, rec["status"], err


# ---------------------------------------------------------------------------
# the driver
# ---------------------------------------------------------------------------

@dataclass
class SweepResult:
    """Outcome of one :func:`execute_cells` invocation."""

    records: dict            # cell name -> result-file record, grid order
    executed: list = field(default_factory=list)
    skipped: list = field(default_factory=list)
    failed: list = field(default_factory=list)
    pending: list = field(default_factory=list)   # cut by max_cells

    @property
    def ok(self) -> bool:
        return not self.failed and not self.pending


def refuse_meshed(cells: Sequence) -> None:
    """Raise if a cell runs on a mesh (``[engine] mesh`` > 1): a cell runs
    in one process on one device; cells across cards are ROADMAP queue 1
    item 14.5."""
    from repro_torch.spec.build import spec_ranks
    meshed = [c.name for c in cells if spec_ranks(c) > 1]
    if meshed:
        raise ValueError(
            f"sweep cell(s) {meshed[:3]} run on a mesh ([engine] mesh > "
            f"1): a cell runs in one process on one device; a sweep of "
            f"cells across cards is ROADMAP queue 1 item 14.5")


def execute_cells(cells: Sequence, *, out_dir, jobs: int = 1,
                  runner: str = DEFAULT_RUNNER,
                  ctx: Mapping | None = None,
                  cell_ctx: Mapping[str, Mapping] | None = None,
                  max_cells: int | None = None, rerun: bool = False,
                  progress=None) -> SweepResult:
    """Execute a grid of validated spec cells, resumably and in parallel.

    ``runner`` is a ``"module:attr"`` ref resolved IN THE WORKER (it must
    be importable there); ``ctx`` is a JSON-serializable dict passed to
    every cell, ``cell_ctx`` maps cell names to per-cell overrides (how
    fig7's race cells receive their per-cell objective targets). A cell
    whose existing result file is ``ok`` with the same (spec, runner,
    ctx) fingerprint is skipped, unless ``rerun`` forces re-execution.
    ``max_cells`` caps how many pending cells this invocation attempts
    (the resume test's controlled kill point). ``progress(name, status,
    err, done, total)`` is called per finished cell.
    """
    ctx = dict(ctx or {})
    cell_ctx = cell_ctx or {}
    refuse_meshed(cells)
    names = [c.name for c in cells]
    if len(set(names)) != len(names):
        dupe = sorted({n for n in names if names.count(n) > 1})
        raise ValueError(f"duplicate cell name(s): {dupe[:3]}")
    unknown = set(cell_ctx) - set(names)
    if unknown:
        raise ValueError(f"cell_ctx for unknown cell(s): "
                         f"{sorted(unknown)[:3]}")
    cells_dir = pathlib.Path(out_dir) / "cells"
    cells_dir.mkdir(parents=True, exist_ok=True)

    res = SweepResult(records={})
    todo = []
    paths = {}
    for cell in cells:
        cctx = _norm({**ctx, **dict(cell_ctx.get(cell.name, {}))})
        path = paths[cell.name] = cells_dir / cell_filename(cell.name)
        spec_dict = _norm(cell.to_dict())
        rec = _read_cell(path)
        if (not rerun and rec is not None and rec.get("status") == "ok"
                and _norm(rec.get("spec")) == spec_dict
                and rec.get("runner") == runner
                and _norm(rec.get("ctx")) == cctx):
            res.records[cell.name] = rec
            res.skipped.append(cell.name)
        else:
            todo.append((cell.name, spec_dict, runner, cctx, str(path)))
    if max_cells is not None and len(todo) > max_cells:
        todo, cut = todo[:max_cells], todo[max_cells:]
        res.pending = [t[0] for t in cut]

    def _account(name, status, err):
        (res.executed if status == "ok" else res.failed).append(name)
        if progress is not None:
            progress(name, status, err,
                     len(res.executed) + len(res.failed) +
                     len(res.skipped), len(cells))

    if jobs <= 1 or len(todo) <= 1:
        for payload in todo:
            _account(*_execute_one(payload))
    else:
        # spawn, not fork: workers must initialize their own torch and CUDA
        # runtime.
        # Each worker's process-local task-data cache is what shares one
        # device dataset across the same-task cells it picks up.
        import multiprocessing as mp
        with mp.get_context("spawn").Pool(
                processes=min(jobs, len(todo))) as pool:
            for out in pool.imap(_execute_one, todo):
                _account(*out)

    for name in res.executed + res.failed:
        res.records[name] = _read_cell(paths[name]) or {
            "status": "failed", "name": name,
            "error": "result file unreadable after execution"}
    # re-key in grid order (records were filled skip-first)
    res.records = {n: res.records[n] for n in names if n in res.records}
    return res


def _strip_volatile(summary: dict) -> dict:
    out = copy.deepcopy(summary)
    tel = out.get("telemetry")
    if isinstance(tel, dict):
        for key in VOLATILE_TELEMETRY_KEYS:
            tel.pop(key, None)
    return out


def write_merged(out_path, cells: Sequence, records: Mapping, *,
                 meta: Mapping | None = None) -> dict:
    """Merge ok cell records into the ONE self-describing sweep artifact.

    ``cells`` fixes the artifact's cell order (the grid order, not
    completion order); every cell must have an ``ok`` record. The
    document is written with sorted keys and no wall-clock fields, so the
    same grid always produces the same bytes.
    """
    body = {}
    for cell in cells:
        rec = records.get(cell.name)
        if rec is None or rec.get("status") != "ok":
            raise ValueError(f"cannot merge: cell {cell.name!r} has no ok "
                             f"result")
        body[cell.name] = _strip_volatile(rec["summary"])
    doc = {"schema": SCHEMA, "kind": "sweep", **(dict(meta or {})),
           "n_cells": len(body), "cells": body}
    _atomic_write_json(pathlib.Path(out_path), doc)
    return doc


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="expand a [sweep] spec file and run every cell: "
                    "parallel, resumable, one merged JSON artifact")
    ap.add_argument("--spec", required=True,
                    help="spec file (.toml/.json) with an optional "
                         "[sweep] table of dotted-path axes + seeds")
    ap.add_argument("--out-dir", required=True,
                    help="sweep state dir: per-cell results under "
                         "cells/, merged artifact at merged.json")
    ap.add_argument("--jobs", type=int, default=1,
                    help="worker processes (1 = inline, no subprocess)")
    ap.add_argument("--max-cells", type=int, default=None,
                    help="attempt at most N pending cells this run "
                         "(exit %d; rerun to resume)" % EXIT_PENDING)
    ap.add_argument("--rerun", action="store_true",
                    help="re-execute every cell, ignoring existing "
                         "result files")
    ap.add_argument("--no-telemetry", action="store_true",
                    help="do not attach the run-telemetry recorder to "
                         "cells (summaries lose their 'telemetry' block)")
    ap.add_argument("--quiet", action="store_true",
                    help="suppress per-cell progress lines")
    ap.add_argument("--device", default=None,
                    help="torch device of every cell (default cuda)")
    args = ap.parse_args(argv)

    from repro_torch.spec import SpecError, load_sweep
    try:
        base, cells = load_sweep(args.spec)
    except SpecError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    out_dir = pathlib.Path(args.out_dir)
    if not args.quiet:
        print(f"# sweep {base.name!r}: {len(cells)} cell(s) -> {out_dir}",
              file=sys.stderr)

    def progress(name, status, err, done, total):
        if not args.quiet:
            tail = "" if err is None else f"  {err}"
            print(f"# [{done}/{total}] {status:6s} {name}{tail}",
                  file=sys.stderr, flush=True)

    try:
        refuse_meshed(cells)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    res = execute_cells(
        cells, out_dir=out_dir, jobs=args.jobs, max_cells=args.max_cells,
        rerun=args.rerun,
        ctx={"telemetry": not args.no_telemetry,
             **({"device": args.device} if args.device else {})},
        progress=progress)

    print(f"# executed={len(res.executed)} skipped={len(res.skipped)} "
          f"failed={len(res.failed)} pending={len(res.pending)}",
          file=sys.stderr)
    if res.failed:
        for name in res.failed:
            rec = res.records.get(name) or {}
            print(f"# FAILED {name}: {rec.get('error')}", file=sys.stderr)
        print(f"# {len(res.failed)} cell(s) failed; rerun re-executes "
              f"only these", file=sys.stderr)
        return EXIT_FAILED
    if res.pending:
        print(f"# incomplete: {len(res.pending)} cell(s) pending "
              f"(--max-cells cut); rerun to resume", file=sys.stderr)
        return EXIT_PENDING
    from repro_torch.spec.sweep import parse_sweep_table
    from repro_torch.spec.serialize import read_spec_file
    table = dict(read_spec_file(args.spec)).get("sweep") or {}
    axes, seeds = parse_sweep_table(table) if table else ({}, None)
    merged = out_dir / "merged.json"
    write_merged(merged, cells, res.records,
                 meta={"name": base.name, "base": base.to_dict(),
                       "axes": axes, "seeds": seeds})
    print(f"{merged}: {len(cells)} cell(s) merged")
    return EXIT_OK


if __name__ == "__main__":
    sys.exit(main())
