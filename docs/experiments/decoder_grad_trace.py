"""The region gate's seed 12 traced gradient by gradient: does the bf16
decoder sequence kernels' route (rows 5 and 6) train worse than the plain
loop because the kernels leave their plain versions, or because of the
bf16 contract they share with JAX's Pallas kernels?

Replays the gate's vmmt_c run (``tools/quality_gate.py -models vmmt_c
-seeds 12 -img_regions 4 -img_pool attn``, 2500 steps) on the ``kernels``
route and, in lockstep on the same batches, on the ``scans`` route. At
step 0, every ``-every`` steps, after the last step, and at the step after
each step where the kernels route's training loss first departs from the
scans route's by more than ``-depart`` (relative), it takes the gradient
of every parameter four ways from the kernels route's parameters, batch
and random draws (``variational_mmt_torch/tools/grad_trace.py``): (i) rows
5 and 6 on the card, (ii) their plain versions on the card, (iii) the
plain input-feed loop, all bf16, and (iv) the plain route in f32. Each
traced step is one JSON line: the distances and cosines of (i)-(iii) from
(iv) and of (i) from (ii), per parameter tensor and for the decoder's
weights with the attention memory as a group; rows 5 and 6 against their
plain versions on the decoder's own inputs and cotangents of that batch,
in bf16 and f32, as ``chip_smoke.py`` checks them at random inputs
(``grad_trace.decoder_checks``); both routes' training loss and KL, and
the card. A last line gives each route's test BLEU.

    python docs/experiments/decoder_grad_trace.py -out trace.jsonl

Run from the repository's root on a CUDA card. Flags it does not know
go to the gate (``-hidden_dim 16 ...``); ``-device cpu`` runs routes (ii)
to (iv) on the CPU, at a width the CPU can take.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402

from variational_mmt_torch.config import DecodeConfig  # noqa: E402
from variational_mmt_torch.decode.translator import Translator  # noqa: E402
from variational_mmt_torch.evals.bleu import corpus_bleu  # noqa: E402
from variational_mmt_torch.tools import grad_trace as gt  # noqa: E402
from variational_mmt_torch.tools import quality_gate as qg  # noqa: E402
from variational_mmt_torch.tools.runs import card_name, route_pallas_step  # noqa: E402


def test_bleu(run: gt.GateRun, route: str, batch_size: int, device: torch.device) -> float:
    """The test split's BLEU, beam 4, as the gate decodes it on ``route``."""
    src, tgt, feats, sv, tv, b = run.data
    dcfg = DecodeConfig(beam_size=4, max_length=40, batch_size=batch_size, alpha=0.6,
                        pallas_step=route_pallas_step(route))
    tr = Translator(run.model, sv, tv, dcfg, buckets=qg.BUCKETS, device=device)
    hyp = tr.translate_ids([sv.encode(s) for s in src[b:]], feats[b:])
    tr.close()
    return round(corpus_bleu([tv.decode(nb[0][1]) for nb in hyp], [[r] for r in tgt[b:]])["bleu"],
                 2)


def summary(dist: dict) -> dict:
    """The groups' numbers, rounded for the line."""
    return {g: {k: (round(v, 7) if isinstance(v, float) else
                    {kk: round(vv, 7) for kk, vv in v.items()}) for k, v in rec.items()}
            for g, rec in dist.items()}


def main(argv=None) -> list:
    p = argparse.ArgumentParser("gradient trace of the decoder sequence kernels",
                                add_help=False)  # -hidden_dim is the gate's, not -h
    p.add_argument("-seed", type=int, default=12)
    p.add_argument("-steps", type=int, default=2500)
    p.add_argument("-every", type=int, default=50)
    p.add_argument("-depart", type=float, default=0.1)
    p.add_argument("-device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("-out", default="decoder_grad_trace.jsonl")
    args, rest = p.parse_known_args(argv)
    gate = qg.parse_args(["-img_regions", "4", "-img_pool", "attn", "-device", args.device]
                        + rest)
    device = torch.device(args.device)
    card = card_name(device)
    runs = {r: gt.gate_run(gate, r, args.seed, device=device) for r in ("kernels", "scans")}
    twin = gt.f32_twin(runs["kernels"].cfg, runs["kernels"].model)
    rows, departed, onsets, pending = [], False, [], False
    t0 = time.time()
    out = open(args.out, "a")
    for s in range(args.steps + 1):
        k = runs["kernels"]
        last = s == args.steps
        batch = k.next_batch()
        trigger = ("start" if s == 0 else "end" if last else "every" if s % args.every == 0
                   else "departure" if pending else None)
        pending = False
        row = None
        if trigger:
            g = gt.four_gradients(k.cfg, k.model, batch, k.state.step, k.state.generator, twin)
            dist = gt.compare(g)
            row = {"step": s, "trigger": trigger,
                   "route_losses": {r: round(v["loss"], 5) for r, v in g.items()},
                   "route_kl": {r: round(v["kl"], 5) for r, v in g.items()},
                   "groups": summary({n: dist[n] for n in ("decoder", "all")}),
                   "tensors": summary({n: v for n, v in dist.items()
                                       if n not in ("decoder", "all")}),
                   "kernel_leaves_plain": gt.kernel_leaves_plain(dist),
                   "kernel_checks": gt.decoder_checks(*gt.capture_decoder_call(
                       k.cfg, k.model, batch, k.state.step, k.state.generator))}
        if not last:
            sbatch = runs["scans"].next_batch()
            if not all(torch.equal(batch[x], sbatch[x]) for x in batch):
                raise RuntimeError(f"step {s}: the two routes read different batches")
            mk = k.step(batch)
            ms = runs["scans"].step(sbatch)
            gap = abs(mk["loss"] - ms["loss"]) / max(abs(ms["loss"]), 1e-12)
            if gap > args.depart and not departed:
                onsets.append(s)
                pending = True
            departed = gap > args.depart
            if row is not None:
                row.update(loss_kernels=round(mk["loss"], 5), kl_kernels=round(mk["kl_sum"], 5),
                           loss_scans=round(ms["loss"], 5), kl_scans=round(ms["kl_sum"], 5),
                           loss_gap=round(gap, 6))
        if row is not None:
            row.update(seconds=round(time.time() - t0, 1), card=card)
            rows.append(row)
            print(json.dumps(row), flush=True)
            out.write(json.dumps(row) + "\n")
            out.flush()
    for r in runs.values():
        r.close()
    end = {"summary": True, "seed": args.seed, "steps": args.steps,
           "traced": len(rows), "departure_onsets": onsets,
           "test_bleu": {r: test_bleu(run, r, gate.batch_size, device)
                         for r, run in runs.items()},
           "seconds": round(time.time() - t0, 1), "card": card}
    print(json.dumps(end), flush=True)
    out.write(json.dumps(end) + "\n")
    out.close()
    return rows + [end]


if __name__ == "__main__":
    main()
