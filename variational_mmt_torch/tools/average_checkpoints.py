"""Average the parameters of several checkpoints into a new one. Mirrors
the root ``tools/average_checkpoints.py``, flag for flag:

    python -m variational_mmt_torch.tools.average_checkpoints -ckpts dir1 dir2 ... -output out_dir
    python -m variational_mmt_torch.tools.average_checkpoints -ckpt_root ckpts -last 3 -output out_dir

The newest checkpoint (the last given) is the base: the result keeps its
step, lr, optimizer moments, EMA and generator state. The sum is taken in
float64 and cast to float32. Host code: loads on the CPU, no ``-device``.
"""

from __future__ import annotations

import argparse
import os

import torch

from variational_mmt_torch.train.checkpoint import (list_checkpoints, load_checkpoint,
                                                    save_checkpoint)


def main(argv=None) -> str:
    p = argparse.ArgumentParser()
    p.add_argument("-ckpts", nargs="*", default=[], help="explicit checkpoint dirs")
    p.add_argument("-ckpt_root", default="", help="root dir holding step_* checkpoints")
    p.add_argument("-last", type=int, default=3, help="with -ckpt_root: how many newest to average")
    p.add_argument("-output", required=True)
    opt = p.parse_args(argv)

    paths = list(opt.ckpts)
    if opt.ckpt_root:
        steps = list_checkpoints(opt.ckpt_root)[-opt.last:]
        paths += [os.path.join(opt.ckpt_root, f"step_{s:08d}") for s in steps]
    if not paths:
        raise SystemExit("no checkpoints given")

    state, cfg, model, sv, tv = load_checkpoint(paths[-1], device="cpu")
    acc = [q.detach().double() for q in model.parameters()]
    for path in paths[:-1]:
        _, cfg2, model2, _, _ = load_checkpoint(path, device="cpu")
        if cfg2.model != cfg.model:
            raise SystemExit(f"architecture mismatch: {path}")
        acc = [a + q.detach().double() for a, q in zip(acc, model2.parameters())]
    with torch.no_grad():
        for q, a in zip(model.parameters(), acc):
            q.copy_((a / len(paths)).float())
    out = save_checkpoint(opt.output, state, cfg, sv, tv, keep=0)
    print(f"averaged {len(paths)} checkpoints -> {out}")
    return out


if __name__ == "__main__":
    main()
