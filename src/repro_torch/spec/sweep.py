"""Cross-product sweep expansion over experiment specs.

A copy of ``repro.spec.sweep`` (JSON, TOML and numpy only), so that the port
imports nothing of the JAX package.

``sweep(base, axes, seeds=...)`` turns one base
:class:`~repro_torch.spec.types.ExperimentSpec` plus a mapping of dotted-path
axes into the full grid of validated cells, the way the benchmark modules
define their figure grids::

    cells = sweep(
        base,
        {"algorithm.name": ["fedepm", "sfedavg"],
         "policy": [PolicySpec(name="sync"),
                    PolicySpec(name="deadline", deadline=0.002)]},
        seeds=[0, 1, 2])

Axis keys are either a dotted section field (``"policy.deadline"``) or a
whole section (``"policy"``, replacing the sub-spec object). The product
iterates in axis-insertion order with the LAST axis fastest (row-major,
like ``itertools.product``); ``seeds`` appends a final per-cell seed axis
setting the experiment's master ``seed``. Every cell is validated before
the list is returned, and cell names extend the base name with
``axis=value`` segments (plus ``s<seed>``), so a grid's JSON artifacts are
self-describing; when a whole-section axis makes two cells share a name
(two ``CodecSpec`` values share one ``.name``), each collision gets a
stable ``#<ordinal>`` suffix so names stay unique.

Numeric axis values are normalized before entering a name: floats print
as their shortest 12-significant-digit form (so a computed grid value
like ``0.1 * 3`` names the cell ``policy.deadline=0.3``, not
``...=0.30000000000000004``), bools print TOML-style ``true``/``false``.
Two axis values that normalize to the same text fall into the same
``#<ordinal>`` collision handling as sub-spec axes, so names stay unique
regardless.

``load_sweep(path)`` reads a spec FILE carrying an optional ``[sweep]``
table (dotted-path axes + ``seeds``) and returns the expanded grid --
the input surface of the multi-cell driver
(:mod:`repro_torch.launch.sweep_run`, docs/spec.md).
"""
from __future__ import annotations

import itertools
from typing import Mapping, Sequence

from repro_torch.spec.types import ExperimentSpec, SpecError


def _fmt_value(value) -> str:
    """Normalize one scalar axis value for use inside a cell name."""
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, float):
        # shortest-readable, not shortest-roundtrip: 12 significant digits
        # absorbs binary-float artifacts (0.1 * 3) that would otherwise
        # leak 17-digit noise into artifact keys
        return format(value, ".12g")
    return str(value)


def _segment(path: str, value) -> str:
    if hasattr(value, "name") and not isinstance(value, str):
        return f"{path}={value.name}"       # a whole sub-spec: use its name
    return f"{path}={_fmt_value(value)}"


def sweep(base: ExperimentSpec, axes: Mapping[str, Sequence], *,
          seeds: Sequence[int] | None = None) -> list[ExperimentSpec]:
    """Expand ``base`` over ``axes`` (x ``seeds``) -> validated cells."""
    for path, values in axes.items():
        if isinstance(values, (str, bytes)) or not isinstance(
                values, Sequence):
            raise SpecError(f"sweep axis {path!r} must be a sequence of "
                            f"values; got {type(values).__name__}")
        if len(values) == 0:
            raise SpecError(f"sweep axis {path!r} is empty")
    combos: list[tuple[ExperimentSpec, str]] = []
    paths = list(axes)
    for combo in itertools.product(*(axes[p] for p in paths)):
        spec = base
        segments = []
        for path, value in zip(paths, combo):
            spec = spec.replace(**{path: value})
            segments.append(_segment(path, value))
        name = "/".join([base.name, *segments]) if segments else base.name
        combos.append((spec, name))
    # a whole-section axis can yield colliding names (two CodecSpecs share
    # one .name); artifacts keyed by cell name must never overwrite each
    # other, so collisions get a stable per-duplicate ordinal
    counts: dict[str, int] = {}
    for _, name in combos:
        counts[name] = counts.get(name, 0) + 1
    seen: dict[str, int] = {}
    cells: list[ExperimentSpec] = []
    for spec, name in combos:
        if counts[name] > 1:
            k = seen[name] = seen.get(name, -1) + 1
            name = f"{name}#{k}"
        for seed in (seeds if seeds is not None else [None]):
            cell = spec if seed is None else spec.replace(seed=seed)
            cell = cell.replace(
                name=name if seed is None else f"{name}/s{seed}")
            cells.append(cell.validate())
    return cells


# ---------------------------------------------------------------------------
# [sweep] spec files
# ---------------------------------------------------------------------------

_SCALARS = (str, int, float, bool)


def parse_sweep_table(table) -> tuple[dict, list | None]:
    """Validate a raw ``[sweep]`` table -> (axes, seeds).

    Every key except ``seeds`` is an axis: a dotted section field (quoted
    in TOML, e.g. ``"policy.deadline"``) or a top-level spec field, mapped
    to a non-empty list of scalars. Axis order is the table's key order
    (last axis fastest, matching :func:`sweep`); ``seeds`` must be a list
    of ints and always expands innermost. Whole-section axes (sub-spec
    values) are a Python-API-only feature -- a table value must be a flat
    scalar list.
    """
    if not isinstance(table, Mapping):
        raise SpecError(f"[sweep] must be a table/object, "
                        f"got {type(table).__name__}")
    axes: dict = {}
    seeds = None
    for key, values in table.items():
        if not isinstance(values, Sequence) or isinstance(values,
                                                          (str, bytes)):
            raise SpecError(f"[sweep] {key}: expected a list of values, "
                            f"got {type(values).__name__}")
        if len(values) == 0:
            raise SpecError(f"[sweep] {key}: axis is empty")
        if key == "seeds":
            bad = [v for v in values
                   if not isinstance(v, int) or isinstance(v, bool)]
            if bad:
                raise SpecError(f"[sweep] seeds: expected ints, "
                                f"got {bad[0]!r}")
            seeds = list(values)
            continue
        bad = [v for v in values if not isinstance(v, _SCALARS)]
        if bad:
            raise SpecError(f"[sweep] {key}: axis values must be scalars "
                            f"(str/int/float/bool), got {bad[0]!r}")
        axes[key] = list(values)
    return axes, seeds


def load_sweep(path) -> tuple[ExperimentSpec, list[ExperimentSpec]]:
    """Read a spec file with an optional ``[sweep]`` table -> (base, cells).

    Without a ``[sweep]`` table the file is an ordinary single-cell spec
    and the grid is ``[base]`` (validated). With one, the remaining
    sections form the base cell and the grid is its :func:`sweep`
    cross-product -- each cell validated, each named
    ``<base>/<axis>=<value>/.../s<seed>``. Unknown axis paths surface as
    :class:`~repro_torch.spec.types.SpecError` exactly like
    ``ExperimentSpec.replace`` misuse.
    """
    from repro_torch.spec import serialize
    d = dict(serialize.read_spec_file(path))
    table = d.pop("sweep", None)
    base = ExperimentSpec.from_dict(d)
    if table is None:
        return base, [base.validate()]
    axes, seeds = parse_sweep_table(table)
    if not axes and seeds is None:
        raise SpecError(f"{path}: [sweep] table defines no axes and no "
                        f"seeds")
    return base, sweep(base, axes, seeds=seeds)
