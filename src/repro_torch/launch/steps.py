"""Step builders: (architecture x input shape x mesh) -> a step to run;
the counterpart of ``repro.launch.steps``.

For every (arch, shape) pair this gives a ``StepBundle``: the step
callable, shape-and-dtype stand-ins for its arguments (tensors on the meta
device: shapes and dtypes, never allocated), and the partition specs the
JAX package would place them with on the mesh, which the dry-run writes
into its record. The dry-run, the roofline and the launchers share it.

Shape semantics, as in JAX:
  train_4k    -> ONE FedEPM communication round (``core/distributed.py``'s
                 ``build_fedepm``: k0 prox iterations, ENS aggregation, the
                 DP upload), the client layout from ``configs.fed_plan``.
  prefill_32k -> the full forward over the prompt: next-token logits and
                 the decode state.
  decode_32k, long_500k -> ONE token through a KV/recurrent cache of
                 seq_len. long_500k on full-attention archs uses the
                 sliding-window VARIANT (window 4096); encoder-only archs
                 skip the decode shapes.

A step runs on one device (a one-device mesh record) or, the train step,
on the ranks of a live (D, M) mesh (``sharding/mesh.py``): there each rank
holds its blocks of the state (``static["init"]``, cut over "data" and
"model" by ``static["sspecs"]``) and of the batch, which ``shard_tree``
cuts by ``static["bspecs"]`` (a client's rows over "model" too where M
divides them: ``static["batch_rows"]``). A tiny arch (its params over M
below 128 MiB, M dividing its rows) takes JAX's branch: weights whole
over "model", W and Z cut over the client axis only, the batch cut over
"model", the gradient all_reduced over it. The serve steps and a record
mesh of more than one device stay for ROADMAP queue 1 item 14.5. Each
builder takes ``shape`` to cut the batch or the sequence of its
``INPUT_SHAPES`` entry.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable, Optional

import torch

from repro_torch import configs, random
from repro_torch.core import distributed as dist_mod
from repro_torch.core.fedepm import FedEPMConfig
from repro_torch.core.tasks import ChunkedLMLoss
from repro_torch.core.treeutil import tmap, tree_leaves
from repro_torch.launch.mesh import client_axes, n_client_groups
from repro_torch.launch.roofline import total_param_bytes
from repro_torch.models.config import INPUT_SHAPES, ArchConfig, InputShape
from repro_torch.models.registry import get_model
from repro_torch.sharding.rules import DEFAULT_RULES, P, axis_rules
from repro_torch.sharding.mesh import is_live
from repro_torch.sharding.specs import entry_axes, named, spec_leaves, \
    spec_map

SWA_WINDOW = 4096  # sliding-window width for the long_500k dense variant

# serving params above this many bytes per device (TP only) switch to
# FSDP(+TP) storage so one copy fits
_SERVE_FSDP_THRESHOLD = 8 << 30


@dataclasses.dataclass
class StepBundle:
    arch: str
    shape: str
    kind: str                 # "train" | "prefill" | "decode"
    fn: Callable              # step(*args)
    args: tuple               # stand-ins (meta tensors), never allocated
    in_shardings: tuple       # specs with their mesh: dryrun's record
    out_shardings: Any
    donate_argnums: tuple = ()  # the record's; ``fn`` donates itself
    notes: str = ""
    static: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Skip:
    arch: str
    shape: str
    reason: str


# ---------------------------------------------------------------------------
# arch resolution (variants + skips)
# ---------------------------------------------------------------------------

def resolve_arch(name: str, shape: InputShape):
    """Returns (cfg, note) or Skip."""
    cfg = configs.get_config(name)
    note = ""
    if shape.kind == "decode" and cfg.attention == "bidirectional":
        return Skip(name, shape.name,
                    "encoder-only architecture: no decode step exists")
    if shape.name == "long_500k":
        sub_quadratic = cfg.family in ("xlstm", "hybrid", "ssm") or \
            cfg.sliding_window is not None
        if not sub_quadratic:
            if cfg.family in ("dense", "vlm"):
                cfg = dataclasses.replace(cfg, sliding_window=SWA_WINDOW)
                note = (f"long_500k uses the sliding-window VARIANT "
                        f"(window={SWA_WINDOW}); full attention would need "
                        f"a {shape.seq_len}-token dense cache")
            else:
                return Skip(name, shape.name,
                            "no sub-quadratic variant for this family")
    return cfg, note


# ---------------------------------------------------------------------------
# input stand-ins (meta tensors, never allocated)
# ---------------------------------------------------------------------------

def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(int(s) for s in shape), dtype=dtype,
                       device="meta")


def lm_batch_specs(cfg: ArchConfig, lead: tuple, seq: int,
                   with_targets: bool = True) -> dict:
    """Batch tree of stand-ins for one model call; ``lead`` are leading
    axes ((m, b) for stacked clients, (B,) for serving)."""
    d = {}
    if cfg.family == "audio":
        d["frame_embeds"] = _sds(lead + (seq, cfg.d_model), cfg.dtype)
        t_total = seq
    elif cfg.family == "vlm":
        t_text = max(seq - cfg.n_patches, 16)
        d["tokens"] = _sds(lead + (t_text,), torch.int32)
        d["patch_embeds"] = _sds(lead + (cfg.n_patches, cfg.d_model),
                                 cfg.dtype)
        t_total = t_text + cfg.n_patches
    else:
        d["tokens"] = _sds(lead + (seq,), torch.int32)
        t_total = seq
    if with_targets:
        d["targets"] = _sds(lead + (t_total,), torch.int32)
        d["loss_mask"] = _sds(lead + (t_total,), torch.float32)
    return d


def train_activation_rules(mesh, mode: str, seq_parallel: bool = True) -> dict:
    """Logical-axis rules of the train step: the residual stream on "model"
    (sequence parallelism) where it would threaten memory; the per-client
    batch unsharded in spatial mode, on the client axes in temporal."""
    ca = client_axes(mesh)
    r = dict(DEFAULT_RULES)
    r.update({
        "batch": None if mode == "spatial" else ca,
        "seq": None,
        "seq_res": ("model",) if seq_parallel else None,
        "heads": ("model",),
        "kv_heads": ("model",),
        "mlp": ("model",),
        "vocab": ("model",),
        "experts": None,
    })
    return r


def serve_activation_rules(mesh) -> dict:
    ca = client_axes(mesh)
    r = dict(DEFAULT_RULES)
    r.update({
        "batch": ca,
        "seq": None,
        "seq_res": None,
        "heads": ("model",),
        "kv_heads": ("model",),
        "mlp": ("model",),
        "vocab": ("model",),
        "experts": None,
    })
    return r


# ---------------------------------------------------------------------------
# serve-state spec heuristic
# ---------------------------------------------------------------------------

def auto_state_specs(abstract_state, mesh, batch_size: int,
                     batch_axes: tuple, model_axis: str = "model"):
    """Per leaf: the first axis (among the leading two) equal to
    batch_size -> batch axes; then the largest remaining divisible axis ->
    model axis. Tiny leaves stay replicated."""
    ba = batch_axes if len(batch_axes) > 1 else batch_axes[0]
    bsz = math.prod(mesh.shape[a] for a in
                    (batch_axes if isinstance(ba, tuple) else (ba,)))
    ms = mesh.shape[model_axis]

    def one(leaf):
        shape = tuple(leaf.shape)
        parts = [None] * len(shape)
        if batch_size > 1:
            for i in range(min(2, len(shape))):
                if shape[i] == batch_size and batch_size % bsz == 0:
                    parts[i] = ba
                    break
        best, best_dim = -1, 0
        for i in range(len(shape)):
            if parts[i] is None and shape[i] % ms == 0 \
                    and shape[i] >= max(ms, 64) and shape[i] > best_dim:
                best, best_dim = i, shape[i]
        if best >= 0 and math.prod(shape) >= (1 << 16):
            parts[best] = model_axis
        return P(*parts)

    return tmap(one, abstract_state)


# ---------------------------------------------------------------------------
# train step (FedEPM round)
# ---------------------------------------------------------------------------

def build_train_step(arch: str, mesh, *, ens: str = "gather", k0: int = 4,
                     eps_dp: float = 0.1, rho: float = 0.5,
                     remat: bool = False, loss_chunk: int = 512,
                     shape: Optional[InputShape] = None):
    # per-BLOCK remat is on by default via ArchConfig.remat; ``remat`` here
    # additionally remats the WHOLE loss
    shape = shape or INPUT_SHAPES["train_4k"]
    res = resolve_arch(arch, shape)
    if isinstance(res, Skip):
        return res
    cfg, note = res
    plan = configs.fed_plan(arch)
    ca = client_axes(mesh)
    tiny = False
    if plan["mode"] == "spatial":
        m = n_client_groups(mesh)
        dist = dist_mod.DistConfig(
            mode="spatial", ens=ens, client_axes=ca, fsdp_axes=(),
            state_dtype=torch.bfloat16
            if plan.get("state_dtype") == "bfloat16" else None,
            remat=remat)
        # tiny models replicate their weights inside the client group and
        # use "model" as intra-client batch parallelism
        tiny = total_param_bytes(cfg) // mesh.shape["model"] < (128 << 20)
    else:
        m = int(plan["m"])
        b_client = shape.global_batch // m
        # batch axes: the largest suffix of the client axes whose product
        # divides the per-client batch
        batch_axes = ca
        while batch_axes and b_client % math.prod(
                mesh.shape[a] for a in batch_axes):
            batch_axes = batch_axes[1:]
        batch_axes = batch_axes or ("data",)
        # microbatches so small that the step's batch no longer covers the
        # batch mesh axes are capped
        ca_size = math.prod(mesh.shape[a] for a in batch_axes)
        mb = min(int(plan.get("microbatch", 1)),
                 max(1, b_client // ca_size))
        dist = dist_mod.DistConfig(
            mode="temporal", ens="gather", client_axes=batch_axes,
            fsdp_axes=("data",), state_dtype=None, remat=remat,
            microbatch=mb)
    if shape.global_batch % m:
        raise ValueError(f"global_batch {shape.global_batch} % m {m}")
    b_local = shape.global_batch // m

    model = get_model(cfg)
    loss_fn = ChunkedLMLoss(cfg, chunk=loss_chunk)
    fed_cfg = FedEPMConfig.paper_defaults(m=m, rho=rho, k0=k0,
                                          eps_dp=eps_dp)
    init_fn, step_fn, sspecs_fn = dist_mod.build_fedepm(
        model, loss_fn, fed_cfg, mesh, dist)

    abstract_state = init_fn(random.PRNGKey(0), device="meta")
    sspecs = sspecs_fn(abstract_state)
    batch = lm_batch_specs(cfg, (m, b_local), shape.seq_len)
    # a live mesh also cuts a client's rows over "model" where its ranks
    # divide them; the record keeps JAX's specs
    bspecs = dist_mod.batch_specs(batch, dist,
                                  mesh if is_live(mesh) else None)

    # sequence-parallel residuals only where the stored residual stream
    # would otherwise threaten memory
    b_step = b_local if dist.mode == "spatial" \
        else (shape.global_batch // m) // max(dist.microbatch, 1)
    resid_bytes = cfg.n_layers * b_step * shape.seq_len * cfg.d_model * 2
    rules = train_activation_rules(mesh, dist.mode,
                                   seq_parallel=resid_bytes > 4e9)
    tiny = dist.mode == "spatial" and tiny \
        and b_local % mesh.shape["model"] == 0
    if tiny:
        rules.update({"batch": ("model",), "heads": None, "kv_heads": None,
                      "mlp": None, "vocab": None, "seq_res": None})
        sspecs = sspecs._replace(
            w_tau=spec_map(lambda _: P(), sspecs.w_tau),
            W=spec_map(lambda s: P(s[0]) if len(s) else P(), sspecs.W),
            Z=spec_map(lambda s: P(s[0]) if len(s) else P(), sspecs.Z))

    def fn(state, batches):
        with axis_rules(mesh, rules):
            return step_fn(state, batches, sspecs, donate=True,
                           bspecs=bspecs)

    in_sh = (named(sspecs, mesh), named(bspecs, mesh))
    out_sh = (named(sspecs, mesh), None)
    return StepBundle(
        arch=arch, shape=shape.name, kind="train", fn=fn,
        args=(abstract_state, batch), in_shardings=in_sh,
        out_shardings=out_sh, donate_argnums=(0,),
        notes="; ".join(filter(None, [note, f"fedepm[{dist.mode}] m={m} "
                                            f"k0={k0} ens={dist.ens}"])),
        static={"mode": dist.mode, "m": m, "k0": k0, "b_local": b_local,
                "ens": dist.ens, "cfg": cfg, "fed": fed_cfg,
                "init": functools.partial(init_fn, sspecs=sspecs),
                "sspecs": sspecs, "bspecs": bspecs, "tiny": tiny,
                "batch_rows": _batch_branch(bspecs)})


def _batch_branch(bspecs) -> str:
    """Which rows of a client's batch a rank takes: "cut over model" or
    "whole rows" over it (``core/distributed.py::batch_specs``)."""
    spec = spec_leaves(bspecs)[0]
    cut = len(spec) > 1 and "model" in entry_axes(spec[1])
    return "cut over model" if cut else "whole rows"


# ---------------------------------------------------------------------------
# serve steps
# ---------------------------------------------------------------------------

def _serve_param_setup(cfg: ArchConfig, mesh):
    """Stand-in params and their storage specs (TP, +FSDP if one copy is
    too big for a device)."""
    model = get_model(cfg)
    abstract_params = model.init(random.PRNGKey(0).to("meta"))
    dist_tp = dist_mod.DistConfig(mode="spatial", fsdp_axes=())
    pspecs = dist_mod.param_specs(cfg, abstract_params, mesh, dist_tp)
    per_chip = 0
    for sp, leaf in zip(spec_leaves(pspecs), tree_leaves(abstract_params)):
        div = 1
        for e in sp:
            if e is None:
                continue
            for a in (e if isinstance(e, tuple) else (e,)):
                div *= mesh.shape[a]
        per_chip += leaf.numel() * leaf.element_size() // div
    fsdp = per_chip > _SERVE_FSDP_THRESHOLD
    if fsdp:
        dist_f = dist_mod.DistConfig(mode="temporal", fsdp_axes=("data",))
        pspecs = dist_mod.param_specs(cfg, abstract_params, mesh, dist_f)
    return model, abstract_params, pspecs, fsdp


def _batch_spec(mesh, batch):
    ca = client_axes(mesh)
    ca_spec = ca if len(ca) > 1 else ca[0]
    return tmap(lambda x: P(ca_spec, *([None] * (x.dim() - 1))), batch)


def build_prefill_step(arch: str, mesh, shape: Optional[InputShape] = None):
    shape = shape or INPUT_SHAPES["prefill_32k"]
    res = resolve_arch(arch, shape)
    if isinstance(res, Skip):
        return res
    cfg, note = res
    model, aparams, pspecs, fsdp = _serve_param_setup(cfg, mesh)
    B = shape.global_batch
    batch = lm_batch_specs(cfg, (B,), shape.seq_len, with_targets=False)
    bspecs = _batch_spec(mesh, batch)
    rules = serve_activation_rules(mesh)

    def fn(params, b):
        with axis_rules(mesh, rules), torch.no_grad():
            if cfg.attention == "bidirectional":
                # encoder: prefill == full encode (logits for every frame)
                return model.apply(params, b)
            return model.prefill(params, b, max_len=shape.seq_len)

    in_sh = (named(pspecs, mesh), named(bspecs, mesh))
    return StepBundle(
        arch=arch, shape=shape.name, kind="prefill", fn=fn,
        args=(aparams, batch), in_shardings=in_sh, out_shardings=None,
        notes="; ".join(filter(None, [note, "fsdp-params" if fsdp else ""])),
        static={"B": B, "fsdp": fsdp, "cfg": cfg})


def build_decode_step(arch: str, mesh, shape_name: str,
                      shape: Optional[InputShape] = None):
    shape = shape or INPUT_SHAPES[shape_name]
    res = resolve_arch(arch, shape)
    if isinstance(res, Skip):
        return res
    cfg, note = res
    if not get_model(cfg).has_decode:
        return Skip(arch, shape.name, "encoder-only: no decode step")
    model, aparams, pspecs, fsdp = _serve_param_setup(cfg, mesh)
    ca = client_axes(mesh)
    B = shape.global_batch
    astate = model.init_decode_state(B, shape.seq_len, shape.seq_len - 1,
                                     device="meta")
    stspecs = auto_state_specs(astate, mesh, B, ca)
    batch = {"tokens": _sds((B, 1), torch.int32)}
    ca_spec = ca if len(ca) > 1 else ca[0]
    bspec = {"tokens": P(ca_spec, None) if B > 1 else P(None, None)}

    rules = serve_activation_rules(mesh)
    if fsdp:
        # weight-stationary decode: per-token activations unconstrained
        rules["batch"] = None

    def fn(params, state, b):
        with axis_rules(mesh, rules), torch.no_grad():
            return model.decode_step(params, state, b)

    in_sh = (named(pspecs, mesh), named(stspecs, mesh), named(bspec, mesh))
    out_sh = (None, named(stspecs, mesh))
    return StepBundle(
        arch=arch, shape=shape.name, kind="decode", fn=fn,
        args=(aparams, astate, batch), in_shardings=in_sh,
        out_shardings=out_sh, donate_argnums=(1,),
        notes="; ".join(filter(None, [note, "fsdp-params" if fsdp else ""])),
        static={"B": B, "fsdp": fsdp, "cfg": cfg, "S": shape.seq_len})


def build_step(arch: str, shape_name: str, mesh, shape=None, **kw):
    if shape_name == "train_4k":
        return build_train_step(arch, mesh, shape=shape, **kw)
    if shape_name == "prefill_32k":
        return build_prefill_step(arch, mesh, shape)
    return build_decode_step(arch, mesh, shape_name, shape)


# ---------------------------------------------------------------------------
# real arguments for a run
# ---------------------------------------------------------------------------

def lm_batch(specs: dict, raw: Optional[dict], key, vocab: int,
             device) -> dict:
    """A batch of ``specs``' shapes on ``device``: tokens and targets from
    ``raw`` (``data/lm.py``'s numpy batches) where given, the targets
    right-aligned into the target length with a loss mask over them, as
    JAX's train CLI pads them; else drawn below ``vocab`` with
    ``random.randint`` from ``key`` under a mask of ones. Frontend stubs
    (patch and frame embeddings) are zeros."""
    out = {}
    keys = random.split(key.to(device), len(specs))
    for (k, spec), kk in zip(sorted(specs.items()), keys):
        if spec.dtype == torch.int32:
            out[k] = random.randint(kk, tuple(spec.shape), 0, vocab)
        elif k == "loss_mask":
            out[k] = torch.ones(spec.shape, dtype=spec.dtype, device=device)
        else:
            out[k] = torch.zeros(spec.shape, dtype=spec.dtype, device=device)
    if raw is not None:
        tok = specs["tokens"].shape[-1]
        out["tokens"] = torch.as_tensor(raw["tokens"][..., :tok],
                                        device=device)
        if "targets" in specs:
            n = specs["targets"].shape[-1]
            tt = torch.as_tensor(raw["targets"][..., :n], device=device)
            out["targets"] = torch.zeros(specs["targets"].shape,
                                         dtype=torch.int32, device=device)
            out["targets"][..., n - tt.shape[-1]:] = tt
            out["loss_mask"] = torch.zeros(specs["targets"].shape,
                                           dtype=torch.float32,
                                           device=device)
            out["loss_mask"][..., n - tt.shape[-1]:] = 1.0
    return out


def make_args(bundle: StepBundle, device, seed: int = 0,
              raw: Optional[dict] = None) -> tuple:
    """Real arguments of the bundle's shapes on ``device``: the initial
    state or params from ``PRNGKey(seed)``, a decode state whose caches
    stand at seq_len - 1, and a batch (``lm_batch``)."""
    cfg = bundle.static["cfg"]
    k_init, k_batch = random.split(random.PRNGKey(seed, device=device))
    batch = lm_batch(bundle.args[-1], raw, k_batch, cfg.vocab, device)
    if bundle.kind == "train":
        return bundle.static["init"](k_init, device=device), batch
    model = get_model(cfg)
    params = model.init(k_init)
    if bundle.kind == "prefill":
        return params, batch
    S = bundle.static["S"]
    state = model.init_decode_state(bundle.static["B"], S, S - 1,
                                    device=device)
    return params, state, batch
