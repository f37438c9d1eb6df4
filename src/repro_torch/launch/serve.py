"""Serving launcher: prefill, then a greedy decode loop, on one device; the
counterpart of ``repro.launch.serve``.

    python -m repro_torch.launch.serve --arch zamba2-1.2b --new-tokens 8
    python -m repro_torch.launch.serve --arch smollm-135m --reduced \\
        --device cpu

runs on the CUDA card unless ``--device`` names another. As in JAX: the
params come from ``PRNGKey(0)``, the prompts (B, Tp) from
``randint(PRNGKey(1), (B, Tp), 0, vocab)`` (and a vlm's patch prefix from
``normal(PRNGKey(2), (B, n_patches, d), cfg.dtype)``), the caches are
sized for Tp + new_tokens + n_patches, prefill gives the first token by
argmax and each decode step the next; the printed lines, the flags and
their defaults and the exit codes are JAX's. An encoder-only arch prints
that it has nothing to decode and returns 1. More than one device
(``--devices`` above 1, a ``--mesh-shape`` other than 1,1) exits 2: the
mesh across cards is ROADMAP queue 1 item 14.5.

Decode on the card replays one CUDA graph (``core/scan.py``) of the step
per (arch, B, max_len): captured after a warm-up call, over static state
buffers that each replay overwrites in place, the counterpart of JAX's
``jit(decode_step, donate_argnums=1)``. The eager step is the plain path,
and the graph gives its bits. The loop reads nothing back to the host
before its end. Serving runs under ``torch.inference_mode()``.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import torch

from repro_torch import configs, random
from repro_torch.core.scan import ScanProgram
from repro_torch.core.treeutil import tree_leaves, tree_unflatten
from repro_torch.kernels.common import resolve_device
from repro_torch.launch.mesh import MESH_ACROSS_CARDS
from repro_torch.models.config import ArchConfig
from repro_torch.models.registry import Model, get_model

MESH_NOT_PORTED = (f"{MESH_ACROSS_CARDS} part 2 (serving across cards); "
                   f"serve runs on one device (--devices 1, --mesh-shape "
                   f"1,1)")


def prompt_batch(cfg: ArchConfig, batch: int, prompt_len: int,
                 device) -> dict:
    """JAX serve's request: prompts from ``PRNGKey(1)``, and for a vlm the
    patch prefix from ``PRNGKey(2)`` in ``cfg.dtype``."""
    out = {"tokens": random.randint(random.PRNGKey(1, device=device),
                                    (batch, prompt_len), 0, cfg.vocab)}
    if cfg.family == "vlm":
        out["patch_embeds"] = random.normal(
            random.PRNGKey(2, device=device),
            (batch, cfg.n_patches, cfg.d_model), dtype=cfg.dtype)
    return out


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """The next tokens (B, 1) int32: the argmax over the vocabulary of the
    last position (the first among equal maxima, as ``jnp.argmax``)."""
    return torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)


class Decoder:
    """Greedy decode of n tokens from a prefill's state and first token.

    ``load(state, tok, n)`` takes the start; ``steps()`` runs the n steps
    and waits for nothing; ``result()`` gives (tokens (n, B, 1), logits
    (n, B, 1, V), the final state). Eager (``graph=False``), each step is
    ``model.decode_step`` and an argmax. With ``graph``, the same step runs
    in a ``ScanProgram``: on the card ``load`` copies the start into the
    static buffers (capturing the graph the first time) and each step is
    one replay; on the CPU the program is a loop of the step.
    """

    def __init__(self, model: Model, params, graph: bool = True):
        # the step holds no reference to the decoder: a graph held in a
        # reference cycle would outlive the run (its pool and the params)
        # until the cycle collector ran
        self._like: dict = {}
        self._step = _greedy_step(model, params, self._like)
        self.program = ScanProgram(self._step) if graph else None

    def load(self, state, tok: torch.Tensor, n: int) -> None:
        self._n, self._like["state"] = n, state
        carry = [tok] + tree_leaves(state)
        if self.program is None:
            self._carry, self._ys = carry, []
            return
        self.program.load(carry)
        # a stream of no columns: the step reads only its carry
        self.program.begin([torch.empty((n, 0), device=tok.device)], n)

    def steps(self) -> None:
        for _ in range(self._n):
            if self.program is None:
                self._carry, ys = self._step(self._carry, None)
                self._ys.append(ys)
            else:
                self.program.advance()

    def result(self):
        if self.program is None:
            logits, toks = (torch.stack(col) for col in zip(*self._ys))
            carry = self._carry
        else:
            logits, toks = self.program.outputs(self._n)
            carry = self.program.carry
        return toks, logits, tree_unflatten(self._like["state"], carry[1:])


def _greedy_step(model: Model, params, like: dict):
    """The decode step over a flat carry [token, *state leaves] (the state
    shaped like ``like["state"]``): (the new carry, [logits, next
    token])."""
    def step(carry, _):
        state = tree_unflatten(like["state"], carry[1:])
        logits, state = model.decode_step(params, state,
                                          {"tokens": carry[0]})
        nxt = greedy(logits)
        return [nxt] + tree_leaves(state), [logits, nxt]
    return step


@dataclasses.dataclass
class ServeResult:
    """One request's output and times. ``tokens`` (B, 1 + new_tokens): the
    prefill's argmax, then each decode step's; ``prefill_logits`` (B, 1,
    V); ``logits`` (new_tokens, B, 1, V), each step's; ``state`` the
    final decode state. ``prefill_s``, ``capture_s`` (loading the start,
    and capturing the graph if it had none) and ``steps_s`` are host
    times that end in a synchronise on the card."""
    tokens: torch.Tensor
    prefill_logits: torch.Tensor
    logits: torch.Tensor
    state: dict
    prefill_s: float
    capture_s: float
    steps_s: float

    @property
    def decode_s(self) -> float:
        return self.capture_s + self.steps_s


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve(cfg: ArchConfig, batch: int = 4, prompt_len: int = 64,
          new_tokens: int = 8, device=None,
          graph: bool = True) -> ServeResult:
    """JAX serve's flow for ``cfg`` on one device (the card unless
    ``device`` names another): init from ``PRNGKey(0)``, the prompts,
    prefill and ``new_tokens`` greedy decode steps, eager or (``graph``)
    as replays of one CUDA graph on the card."""
    dev = resolve_device(device)
    model = get_model(cfg)
    with torch.inference_mode():
        params = model.init(random.PRNGKey(0, device=dev))
        req = prompt_batch(cfg, batch, prompt_len, dev)
        max_len = prompt_len + new_tokens + (cfg.n_patches or 0)
        _sync(dev)
        t0 = time.perf_counter()
        first, state = model.prefill(params, req, max_len=max_len)
        _sync(dev)
        t1 = time.perf_counter()
        tok = greedy(first)
        decoder = Decoder(model, params, graph)
        decoder.load(state, tok, new_tokens)
        _sync(dev)
        t2 = time.perf_counter()
        decoder.steps()
        toks, logits, state = decoder.result()
        _sync(dev)
        t3 = time.perf_counter()
        tokens = torch.cat([tok, toks[..., 0].transpose(0, 1)], dim=1)
    return ServeResult(tokens=tokens, prefill_logits=first, logits=logits,
                       state=state, prefill_s=t1 - t0, capture_s=t2 - t1,
                       steps_s=t3 - t2)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--devices", type=int, default=0,
                    help="device count: one device only")
    ap.add_argument("--mesh-shape", default="",
                    help="data,model: 1,1 (one device) only")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda)")
    return ap


def main(argv=None) -> int:
    ap = parser()
    args = ap.parse_args(argv)
    if args.devices > 1 or args.mesh_shape not in ("", "1,1"):
        ap.error(MESH_NOT_PORTED)
    cfg = configs.get_reduced(args.arch) if args.reduced \
        else configs.get_config(args.arch)
    if not get_model(cfg).has_decode:
        print(f"{args.arch} is encoder-only; nothing to decode")
        return 1
    B, Tp = args.batch, args.prompt_len
    res = serve(cfg, B, Tp, args.new_tokens, device=args.device)
    print(f"prefill {Tp}x{B}: {res.prefill_s:.2f}s")
    dt = res.decode_s
    print(f"decode {args.new_tokens} tokens: {dt:.2f}s "
          f"({args.new_tokens*B/dt:.1f} tok/s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
