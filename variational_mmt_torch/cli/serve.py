"""``serve`` CLI of the port: an online translation server over trained
checkpoints of either package. Mirrors ``variational_mmt_tpu/cli/serve.py``:
loads the checkpoint (several comma-separated: an ensemble, combined by
``-ensemble_mode``), runs every (bucket x batch) decode shape once, then
answers HTTP requests, batching them dynamically into the offline path's
device shapes. It runs on CUDA unless given ``-device cpu`` and exits with
an error without CUDA.

    python -m variational_mmt_torch.cli.serve -model ckpts/ -port 8080
    curl -s localhost:8080/translate -d '{"texts": ["a man rides a horse ."]}'

It prints ``serving on http://HOST:PORT`` once it accepts requests (with
``-port 0`` the system picks the port). ``-infer_dtype bfloat16`` or
``int8`` serves with bfloat16 weights, or with int8 codes and per-column
scales (the checkpoints are then read into host memory, and the card holds
only the cast weights between requests).

Across ranks, under ``torchrun`` (README.md, "Across GPUs"):

    torchrun --nproc_per_node 4 -m variational_mmt_torch.cli.serve -model ckpts/ \
        -tensor_parallel 2 -port 8080

serves on the mesh of WORLD_SIZE / N data x N model ranks
(``-tensor_parallel N``, as JAX computes its data degree): rank 0 answers
HTTP (``/health`` and the stats are its own) and every other rank follows
its device calls (``TranslationService.follow``); ``-batch_size`` must
divide by the data degree, an ensemble is refused, and so is WORLD_SIZE
above 1 with ``-tensor_parallel 1`` (the port cannot leave a rank idle).
SIGTERM (or Ctrl-C) to rank 0 stops every rank; a rank that fails ends the
service, and the CLI exits non-zero.

Dispatcher processes (``-procs``) are spawned and import this module
again, so it imports nothing heavy at its top level.
"""

from __future__ import annotations

import argparse
import os
import signal

from variational_mmt_torch.config import DecodeConfig

DEFAULT_BUCKETS = [16, 24, 32, 48, 64]


def add_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("-model", required=True,
                   help="checkpoint dir (or specific step dir); "
                        "comma-separate several for an ensemble")
    p.add_argument("-use_ema", action="store_true",
                   help="serve the EMA (Polyak-averaged) weights instead of "
                        "the raw params (requires -ema_decay > 0 at train)")
    p.add_argument("-ensemble_mode", default="prob", choices=["prob", "logprob"],
                   help="ensemble combination of per-step distributions: "
                        "mean probability (prob) or mean log-prob (logprob)")
    p.add_argument("-infer_dtype", default="float32",
                   choices=["float32", "bfloat16", "int8"],
                   help="decode-time weight precision: bfloat16 weights, or int8 codes "
                        "with per-column scales (a quarter of f32's resident bytes)")
    p.add_argument("-host", default="127.0.0.1")
    p.add_argument("-port", type=int, default=8080)
    p.add_argument("-beam_size", type=int, default=4)
    p.add_argument("-n_best", type=int, default=1)
    p.add_argument("-max_length", type=int, default=100)
    p.add_argument("-min_length", type=int, default=0)
    p.add_argument("-alpha", type=float, default=0.6)
    p.add_argument("-coverage_beta", type=float, default=0.0)
    p.add_argument("-block_ngram_repeat", type=int, default=0,
                   help="g > 0: no served hypothesis may contain a repeated "
                        "g-gram (same semantics as the translate CLI)")
    p.add_argument("-ignore_when_blocking", default="",
                   help="space-separated tokens exempt from ngram blocking")
    p.add_argument("-batch_size", type=int, default=32,
                   help="device batch = dynamic-batch cap; size it to the "
                        "expected concurrent in-flight request count")
    p.add_argument("-max_wait_ms", type=float, default=5.0,
                   help="batching window after the first queued request")
    p.add_argument("-bpe_codes", default="", help="BPE codes applied to request text")
    p.add_argument("-max_src_tokens", type=int, default=0,
                   help="longest accepted source in post-BPE tokens (0 = the "
                        "largest bucket; larger values add a warmed bucket)")
    p.add_argument("-over_length", choices=["reject", "truncate"], default="reject",
                   help="sources beyond the cap: reject -> HTTP 400, "
                        "truncate -> serve the capped prefix")
    p.add_argument("-no_lower", action="store_true")
    p.add_argument("-no_warmup", action="store_true")
    p.add_argument("-tensor_parallel", type=int, default=1,
                   help=">1: serve decode on a 2-D (data, model) mesh with vocab-parallel "
                        "embeddings+generator (under torchrun)")
    p.add_argument("-pipeline_depth", type=int, default=0, choices=[0, 1, 2],
                   help="worker pipeline depth: 0 = auto (serial on single-core "
                        "hosts, pipelined otherwise); 2 gathers and dispatches "
                        "the next group while one runs; 1 the serial loop")
    p.add_argument("-procs", type=int, default=0,
                   help="HTTP dispatcher processes sharing the port via "
                        "SO_REUSEPORT (0 = single-process threaded server)")
    p.add_argument("-sampling_temp", type=float, default=0.0,
                   help="> 0: serve ancestral sampling instead of beam "
                        "(forces beam_size/n_best 1); requests may pass "
                        "per-sentence 'sample_ids' — the sampled answer is "
                        "reproducible per (seed, sample_id, source, image)")
    p.add_argument("-sampling_topk", type=int, default=0,
                   help="sampling truncation: keep the k most likely tokens")
    p.add_argument("-sampling_topp", type=float, default=0.0,
                   help="nucleus truncation: smallest set with cum-prob >= p")
    p.add_argument("-latent_from", default="mean", choices=["mean", "sample"],
                   help="decode-time z: prior mean or per-sentence sample")
    p.add_argument("-seed", type=int, default=7,
                   help="decode seed (sampling services)")
    p.add_argument("-device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda (the default; an error without CUDA) or cpu")


ACROSS_GPUS = '(README.md, "Across GPUs")'


def main(argv=None) -> None:
    p = argparse.ArgumentParser("vmmt-torch serve")
    add_args(p)
    opt = p.parse_args(argv)
    if opt.tensor_parallel > 1 and "," in opt.model:
        raise SystemExit("-tensor_parallel: not supported with an ensemble — serve a "
                         "single -model")
    world = int(os.environ.get("WORLD_SIZE") or 1)
    if world > 1 and opt.tensor_parallel <= 1:
        raise SystemExit(f"WORLD_SIZE is {world}: serving across ranks takes -tensor_parallel "
                         f"N > 1 with WORLD_SIZE = data ranks x N; -tensor_parallel 1 would "
                         f"leave ranks idle {ACROSS_GPUS}")

    from variational_mmt_torch.cli.train import cli_device, cli_mesh, quiet_unless_main

    device = cli_device(opt.device)
    mesh = cli_mesh(0, opt.tensor_parallel, device)
    if mesh is not None and opt.batch_size % mesh.n_data:
        mesh.close()
        raise SystemExit(f"-batch_size {opt.batch_size} is not divisible by the "
                         f"{mesh.n_data} data-parallel ranks: every rank decodes an equal "
                         f"share of each batch; pick a multiple of {mesh.n_data}")
    with quiet_unless_main(mesh):
        serve(opt, mesh.device if mesh is not None else device, mesh)


def _interrupt(signum, frame):
    raise KeyboardInterrupt


def serve(opt, device, mesh) -> None:
    """The run of :func:`main` once its mesh is made (on every rank)."""
    import _thread

    from variational_mmt_torch.cli.loading import load_device, load_model_spec
    from variational_mmt_torch.data.bpe import BPE
    from variational_mmt_torch.serve import ServeConfig, TranslationService
    from variational_mmt_torch.serve.ranks import RankFailed

    lm = load_model_spec(opt.model, use_ema=opt.use_ema,
                         device=load_device(device, opt.infer_dtype))
    if lm.ensemble:
        print(f"ensemble of {len(lm.models)} checkpoints ({opt.ensemble_mode})")
    beam_size, n_best = opt.beam_size, opt.n_best
    if opt.sampling_temp > 0.0:
        beam_size = n_best = 1  # sampling decodes one draw a stream
    dcfg = DecodeConfig(
        beam_size=beam_size, n_best=n_best, max_length=opt.max_length,
        min_length=opt.min_length, alpha=opt.alpha, batch_size=opt.batch_size,
        coverage_beta=opt.coverage_beta, ensemble_mode=opt.ensemble_mode,
        infer_dtype=opt.infer_dtype, sampling_temp=opt.sampling_temp,
        sampling_topk=opt.sampling_topk, sampling_topp=opt.sampling_topp,
        latent_from=opt.latent_from, decode_seed=opt.seed,
        block_ngram_repeat=opt.block_ngram_repeat,
        ignore_when_blocking=opt.ignore_when_blocking)
    scfg = ServeConfig(
        max_wait_ms=opt.max_wait_ms, warmup=not opt.no_warmup, lower=not opt.no_lower,
        max_src_tokens=opt.max_src_tokens, over_length=opt.over_length,
        pipeline_depth=opt.pipeline_depth)
    bpe = BPE.load(opt.bpe_codes) if opt.bpe_codes else None
    if mesh is not None:  # JAX's line (:160)
        print(f"serving over ({mesh.n_data} data x {mesh.n_model} model) mesh, "
              f"{mesh.backend}; rank 0 is pid {os.getpid()}", flush=True)
    print("warming the decode shapes..." if scfg.warmup else "warmup skipped", flush=True)
    service = TranslationService(lm.translator_args(), lm.src_vocab, lm.tgt_vocab, dcfg,
                                 buckets=lm.cfgs[0].data.buckets or DEFAULT_BUCKETS, scfg=scfg,
                                 bpe=bpe, mesh=mesh, device=device)
    if service.is_follower:
        try:
            service.follow()
        except RankFailed as e:
            raise SystemExit(f"serving ended: {e}") from None
        return
    # a failed rank interrupts serve_forever (or the dispatchers' wait)
    service.on_failure = _thread.interrupt_main
    old_term = signal.signal(signal.SIGTERM, _interrupt)
    try:
        _run_server(opt, service, lm, dcfg)
    finally:
        signal.signal(signal.SIGTERM, old_term)
    if service.failure is not None:
        raise SystemExit(f"serving ended: {service.failure!r}")


def _run_server(opt, service, lm, dcfg) -> None:
    from variational_mmt_torch.serve import MPServingServer, ServingServer

    # 'step' stays an int and 'model_type' a string; an ensemble's members
    # ride the plural fields
    types = [c.model.model_type for c in lm.cfgs]
    info = {"model_type": ",".join(types), "step": lm.steps[0],
            "beam_size": dcfg.beam_size,  # the effective width (1 when sampling)
            "ensemble": len(lm.models) if lm.ensemble else 0}
    if dcfg.sampling_temp > 0.0:
        info["sampling_temp"] = dcfg.sampling_temp  # advertises sample_ids
    if lm.ensemble:
        info.update(steps=list(lm.steps), model_types=types)
    if opt.procs > 0:
        server = MPServingServer(service, opt.host, opt.port, procs=opt.procs, info=info)
        server.start()
        print(f"serving on http://{opt.host}:{server.port}  "
              f"({opt.procs} dispatcher processes, POST /translate)", flush=True)
        try:
            import threading

            threading.Event().wait()  # the dispatchers own the sockets
        except KeyboardInterrupt:
            pass
        finally:
            server.stop()
        return
    server = ServingServer(service, opt.host, opt.port, info=info)
    print(f"serving on http://{opt.host}:{server.port}  (POST /translate)", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.stop()


if __name__ == "__main__":
    main()
