"""Four gradients of one training batch, for the question whether the
decoder sequence kernels (rows 5 and 6, ``ops/decoder.py``) train worse
than the plain input-feed loop in bf16:

  kernel        rows 5 and 6 on the card (``decoder_fwd``, ``decoder_bwd``), bf16
  kernel_plain  their plain versions (``decoder_fwd_ref``, ``decoder_bwd_ref``), bf16
  loop          the plain input-feed loop, the ``scans`` route's decoder, bf16
  loop_f32      the ``plain`` route from the same parameters, f32

All four take the same parameters, batch and step, and the same random
draws: the first route's dropout masks, word-dropout draws and z noise are
taped and replayed to the others (:class:`NoiseTape`), so that only the
decoder's arithmetic differs between the first three. :func:`compare`
gives, for each parameter tensor, for the decoder's weights with the
gradient of the attention memory as one group (``decoder``) and for all
parameters (``all``), each route's relative distance ``||g - g_f32|| /
||g_f32||`` and cosine with ``loop_f32``, and the kernel's relative
distance from its plain version, ``||g_kernel - g_plain|| / ||g_plain||``.

On the CPU there is no kernel route: a wrapper given CPU tensors runs its
plain version, which is ``kernel_plain``.

:func:`gate_run` builds the quality gate's vmmt_c run on one route
(``tools/quality_gate.py``: its corpus, config, initial parameters, batch
order and generator) and steps it as the ``Trainer`` does, so that a
replay follows the gate's trajectory step for step.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import math
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from variational_mmt_torch.config import Config
from variational_mmt_torch.convert import params_from_jax
from variational_mmt_torch.data.dataset import BinarizedDataset, BucketIterator
from variational_mmt_torch.data.prefetch import device_batches
from variational_mmt_torch.data.synthetic import make_ambiguous_corpus
from variational_mmt_torch.models.model import VMMTModel, build_model, init_params
from variational_mmt_torch.ops import decoder as dec_ops
from variational_mmt_torch.tools import quality_gate as qg
from variational_mmt_torch.tools.runs import route_model
from variational_mmt_torch.train.trainer import (create_train_state, host_batches,
                                                 loss_and_grads, make_train_step)

ROUTES = ("kernel", "kernel_plain", "loop", "loop_f32")
REF = "loop_f32"
# chip_smoke.py's bf16 bound on every kernel against its plain version
KERNEL_BOUND = 2e-2


class NoiseTape:
    """Tapes the draws that ``torch.rand`` and ``torch.randn`` make from a
    generator on a first pass, and hands the same values, cast to the
    dtype asked for, to every later pass, in order. A later pass that asks
    for another kind or shape of draw, or for fewer or more draws, raises."""

    def __init__(self):
        self.draws: List[tuple] = []

    @contextlib.contextmanager
    def pass_(self, replay: bool) -> Iterator[None]:
        originals = {"rand": torch.rand, "randn": torch.randn}
        pos = [0]

        def patched(kind):
            orig = originals[kind]

            def draw(*size, generator=None, **kw):
                if generator is None:
                    return orig(*size, **kw)
                if not replay:
                    out = orig(*size, generator=generator, **kw)
                    self.draws.append((kind, out.detach().clone()))
                    return out
                shape = torch.Size(size[0] if len(size) == 1 and not isinstance(size[0], int)
                                   else size)
                if pos[0] >= len(self.draws):
                    raise RuntimeError(f"noise tape: draw {pos[0]} ({kind} {tuple(shape)}) "
                                       f"beyond the {len(self.draws)} taped")
                got_kind, taped = self.draws[pos[0]]
                if got_kind != kind or taped.shape != shape:
                    raise RuntimeError(f"noise tape: draw {pos[0]} is {kind} {tuple(shape)}, "
                                       f"the tape has {got_kind} {tuple(taped.shape)}")
                pos[0] += 1
                return taped.to(dtype=kw.get("dtype") or torch.get_default_dtype(),
                                device=kw.get("device") or taped.device)
            return draw

        torch.rand, torch.randn = patched("rand"), patched("randn")
        try:
            yield
        finally:
            torch.rand, torch.randn = originals["rand"], originals["randn"]
        if replay and pos[0] != len(self.draws):
            raise RuntimeError(f"noise tape: a pass took {pos[0]} of {len(self.draws)} draws")


@contextlib.contextmanager
def plain_decoder_kernels() -> Iterator[None]:
    """Rows 5 and 6 replaced by their plain versions on any device (the
    wrappers run them only for CPU tensors)."""
    fwd, bwd = dec_ops.decoder_fwd, dec_ops.decoder_bwd
    dec_ops.decoder_fwd = lambda *a, probe=None: dec_ops.decoder_fwd_ref(*a)
    dec_ops.decoder_bwd = lambda *a, probe=None: dec_ops.decoder_bwd_ref(*a)
    try:
        yield
    finally:
        dec_ops.decoder_fwd, dec_ops.decoder_bwd = fwd, bwd


@contextlib.contextmanager
def decoder_loop(model: VMMTModel) -> Iterator[None]:
    """The model's teacher-forced decoder on the plain input-feed loop."""
    was = model.decoder.pallas_decoder
    model.decoder.pallas_decoder = False
    try:
        yield
    finally:
        model.decoder.pallas_decoder = was


@contextlib.contextmanager
def memory_grad(model: VMMTModel, box: dict) -> Iterator[None]:
    """Keeps the gradient of the attention memory (the encoder's output
    that the decoder reads) in ``box["memory"]``."""
    orig = model.decode_train

    def decode_train(tgt_in, memory, *a, **k):
        memory.retain_grad()
        box["memory"] = memory
        return orig(tgt_in, memory, *a, **k)

    model.decode_train = decode_train
    try:
        yield
    finally:
        del model.decode_train


def f32_config(cfg: Config) -> Config:
    """``cfg`` on the plain route: f32, no kernels."""
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model,
                                                              **route_model("plain")))


def f32_twin(cfg: Config, model: VMMTModel) -> VMMTModel:
    """The plain route's model of ``cfg``, on ``model``'s device, holding
    ``model``'s parameters (:func:`four_gradients` copies them in)."""
    device = next(model.parameters()).device
    twin = build_model(f32_config(cfg).model, device=device)
    twin.load_state_dict(model.state_dict())
    return twin


def four_gradients(cfg: Config, model: VMMTModel, batch: Dict[str, torch.Tensor], step: int,
                   generator: torch.Generator, twin: Optional[VMMTModel] = None
                   ) -> Dict[str, dict]:
    """Loss, KL sum and gradients of one batch on each of ``ROUTES``:
    {route: {"loss", "kl", "grads": {parameter name: f32 tensor, "memory":
    the attention memory's}}}. ``cfg`` and ``model`` are the kernel route's
    (bf16, ``use_pallas``, ``pallas_decoder``); ``twin`` the f32 model that
    :func:`f32_twin` builds (made here if None), given ``model``'s
    parameters first. ``generator`` is not advanced: the first route draws
    from a copy of it and the others replay those draws. On the CPU the
    ``kernel`` route is left out."""
    device = next(model.parameters()).device
    routes = ROUTES if device.type == "cuda" else ROUTES[1:]
    if twin is None:
        twin = f32_twin(cfg, model)
    else:
        twin.load_state_dict(model.state_dict())
    cfg32 = f32_config(cfg)
    names = [n for n, _ in model.named_parameters()]
    if [n for n, _ in twin.named_parameters()] != names:
        raise ValueError("the f32 twin's parameters are not the model's")
    gen = torch.Generator(device=generator.device)
    gen.set_state(generator.get_state())
    tape = NoiseTape()
    settings = {"kernel": (cfg, model, contextlib.nullcontext),
                "kernel_plain": (cfg, model, plain_decoder_kernels),
                "loop": (cfg, model, lambda: decoder_loop(model)),
                "loop_f32": (cfg32, twin, contextlib.nullcontext)}
    out = {}
    for i, route in enumerate(routes):
        c, m, ctx = settings[route]
        box: dict = {}
        with ctx(), memory_grad(m, box), tape.pass_(replay=i > 0):
            loss, metrics, grads = loss_and_grads(c, m, batch, step, gen)
        g = {n: t.detach().float().clone() for n, t in zip(names, grads)}
        g["memory"] = box["memory"].grad.detach().float().clone()
        out[route] = {"loss": float(loss.detach()), "kl": float(metrics["kl_sum"].detach()),
                      "grads": g}
        m.zero_grad(set_to_none=True)
    return out


def _norm(ts: Sequence[torch.Tensor]) -> float:
    return math.sqrt(sum(float((t.double() ** 2).sum()) for t in ts))


def _dot(a: Sequence[torch.Tensor], b: Sequence[torch.Tensor]) -> float:
    return sum(float((x.double() * y.double()).sum()) for x, y in zip(a, b))


def rel_distance(a: Sequence[torch.Tensor], b: Sequence[torch.Tensor]) -> float:
    """||a - b|| / ||b|| over the tensors taken as one vector (inf where
    b is 0 and a is not, 0 where both are)."""
    num = _norm([x.double() - y.double() for x, y in zip(a, b)])
    den = _norm(b)
    return num / den if den > 0 else (0.0 if num == 0 else math.inf)


def cosine(a: Sequence[torch.Tensor], b: Sequence[torch.Tensor]) -> float:
    """<a, b> / (||a|| ||b||) over the tensors taken as one vector (1 where
    both are 0)."""
    na, nb = _norm(a), _norm(b)
    if na == 0 or nb == 0:
        return 1.0 if na == nb else 0.0
    return _dot(a, b) / (na * nb)


def groups(names: Sequence[str]) -> Dict[str, List[str]]:
    """Every gradient alone, ``decoder`` (the decoder's weights and the
    attention memory) and ``all`` (every parameter)."""
    params = [n for n in names if n != "memory"]
    out = {n: [n] for n in names}
    out["decoder"] = [n for n in params if n.startswith("decoder.")] + ["memory"]
    out["all"] = params
    return out


def compare(grads: Dict[str, dict]) -> Dict[str, dict]:
    """{group: {route: {"rel", "cos"} against ``REF`` for every other route,
    and "kernel_vs_plain" where both kernel routes ran}} over
    :func:`groups`."""
    ref = REF
    names = list(grads[ref]["grads"])
    out = {}
    for group, members in groups(names).items():
        want = [grads[ref]["grads"][n] for n in members]
        rec = {}
        for route, r in grads.items():
            if route == ref:
                continue
            got = [r["grads"][n] for n in members]
            rec[route] = {"rel": rel_distance(got, want), "cos": cosine(got, want)}
        if "kernel" in grads and "kernel_plain" in grads:
            rec["kernel_vs_plain"] = rel_distance(
                [grads["kernel"]["grads"][n] for n in members],
                [grads["kernel_plain"]["grads"][n] for n in members])
        out[group] = rec
    return out


def kernel_leaves_plain(dist: Dict[str, dict]) -> Dict[str, float]:
    """The decoder's gradients (and the ``decoder`` group) whose kernel
    route lies more than ``KERNEL_BOUND`` from its plain version: {name:
    distance}."""
    return {g: rec["kernel_vs_plain"] for g, rec in dist.items()
            if "kernel_vs_plain" in rec and (g == "decoder" or g == "memory"
                                             or g.startswith("decoder."))
            and not rec["kernel_vs_plain"] <= KERNEL_BOUND}


FIRST_STEPS = 4  # chip_smoke.py's PEAKED_STEPS: the steps before bf16 drift grows


def _rel_err(got: Sequence[torch.Tensor], want: Sequence[torch.Tensor]) -> float:
    """max over tensors of max|got - want| / max|want| (chip_smoke.py's)."""
    return max(float((g.float() - w.float()).abs().max())
               / max(float(w.float().abs().max()), 1e-30) for g, w in zip(got, want))


def capture_decoder_call(cfg: Config, model: VMMTModel, batch: Dict[str, torch.Tensor],
                         step: int, generator: torch.Generator) -> tuple:
    """The 15 inputs that the kernel route's teacher-forced decoder gives
    ``fused_decoder_pallas`` on this batch (from a copy of ``generator``),
    and the cotangents (d_attn, d_probs) that the loss sends back to it."""
    from variational_mmt_torch.models import decoder as dec_model

    orig = dec_model.fused_decoder_pallas
    seen: dict = {}

    def capture(*args):
        seen["args"] = tuple(a.detach().clone() for a in args)
        attn_hs, probs = orig(*args)
        for i, t in enumerate((attn_hs, probs)):
            if t.requires_grad:
                t.register_hook(lambda g, i=i: None if g is None
                                else seen.__setitem__(i, g.detach().clone()))
        return attn_hs, probs

    gen = torch.Generator(device=generator.device)
    gen.set_state(generator.get_state())
    dec_model.fused_decoder_pallas = capture
    try:
        loss_and_grads(cfg, model, batch, step, gen)
    finally:
        dec_model.fused_decoder_pallas = orig
        model.zero_grad(set_to_none=True)
    args = seen["args"]
    (B, T, _), S = args[0].shape, args[-1].shape[1]
    d_attn = seen.get(0, torch.zeros((B, T, args[2].shape[-1]), device=args[0].device))
    d_probs = seen.get(1, torch.zeros((B, T, S), device=args[0].device))  # aligns unused
    return args, (d_attn.float(), d_probs.float())


def decoder_checks(args: tuple, cot: tuple) -> dict:
    """Rows 5 and 6 against their plain versions on inputs ``args`` and
    cotangents ``cot`` from :func:`capture_decoder_call`, as chip_smoke.py
    checks them at random inputs: in the compute dtype, the largest
    relative error over the whole sequence and over the first
    ``FIRST_STEPS`` steps each pass processes (forward t < 4, backward t >=
    T-4), and each version's distance from the f32 math of the same inputs;
    in f32, the kernels against their plain versions over the whole
    sequence. The backward of each reads the plain forward's streams. Also
    the attention's largest probability, averaged over (row, step) (1: all
    on one source position)."""
    T = args[0].shape[1]
    kernel = (dec_ops.decoder_fwd, dec_ops.decoder_bwd)
    plain = (dec_ops.decoder_fwd_ref, dec_ops.decoder_bwd_ref)

    def both(fns, a):
        streams = dec_ops.decoder_fwd_ref(*a)
        return fns[0](*a), fns[1](*a[:14], *streams, *cot)

    a32 = tuple(a.float() for a in args)
    k, p, x = both(kernel, args), both(plain, args), both(plain, a32)
    k32 = both(kernel, a32)
    out = {}
    first = (range(FIRST_STEPS), range(T - FIRST_STEPS, T))
    for i, name in enumerate(("fwd", "bwd")):
        ks, ps = [a for a in k[i] if a.dim() == 3], [a for a in p[i] if a.dim() == 3]
        out[name] = {
            "whole": _rel_err(k[i], p[i]),
            "first_steps": max(_rel_err([a[:, t] for a in ks], [a[:, t] for a in ps])
                               for t in first[i]),
            "kernel_vs_f32": _rel_err(k[i], x[i]), "plain_vs_f32": _rel_err(p[i], x[i]),
            "f32_whole": _rel_err(k32[i], x[i])}
    out["mean_max_prob"] = float(p[0][3].float().amax(-1).mean())
    return out


@dataclasses.dataclass
class GateRun:
    """One route of the region gate's vmmt_c run, stepped as the
    ``Trainer`` steps it."""
    cfg: Config
    model: VMMTModel
    state: object
    step_fn: object
    batches: Iterator[Dict[str, torch.Tensor]]
    data: tuple  # (src, tgt, feats, sv, tv, b): the corpus, test split from b

    def next_batch(self) -> Dict[str, torch.Tensor]:
        return next(self.batches)

    def step(self, batch: Dict[str, torch.Tensor]) -> Dict[str, float]:
        self.state, m = self.step_fn(self.state, batch, self.state.generator)
        return {k: float(v.detach()) for k, v in m.items() if torch.is_tensor(v)}

    def close(self) -> None:
        self.batches.close()


def gate_run(args, route: str, seed: int, model_type: str = "vmmt_c",
             device: torch.device = torch.device("cuda")) -> GateRun:
    """The gate's run of ``model_type`` at ``seed`` on ``route``, built as
    ``quality_gate.run_one`` builds it: corpus, config, initial parameters,
    batch order and the training generator."""
    args = copy.copy(args)
    args.route = route
    n = args.n_train + args.n_valid + args.n_test
    a, b = args.n_train, args.n_train + args.n_valid
    src, tgt, feats, sv, tv, _, _ = make_ambiguous_corpus(
        n, vocab_size=args.vocab_size, img_dim=args.img_dim, seed=args.data_seed,
        regions=args.img_regions)
    cfg = qg.build_cfg(model_type, seed, args)
    ids = lambda lines, v: [np.asarray(v.encode(s), np.int32) for s in lines]  # noqa: E731
    it = BucketIterator(BinarizedDataset(ids(src[:a], sv), ids(tgt[:a], tv)), args.batch_size,
                        qg.BUCKETS, img_feats=None if model_type == "nmt" else feats[:a],
                        shuffle=True, seed=seed)
    model = build_model(cfg.model, device=device)
    model.load_state_dict(params_from_jax(init_params(cfg.model, seed=seed), cfg.model))
    state = create_train_state(cfg, model)
    return GateRun(cfg, model, state, make_train_step(cfg),
                   device_batches(host_batches(it), device), (src, tgt, feats, sv, tv, b))
