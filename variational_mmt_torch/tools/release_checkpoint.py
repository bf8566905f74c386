"""Strip a checkpoint for deployment: drop the optimizer state and,
optionally, cast the float parameters to bfloat16 in the file or publish
the EMA weights as the parameters. Mirrors the root
``tools/release_checkpoint.py``, flag for flag:

    python -m variational_mmt_torch.tools.release_checkpoint -model runs/ckpts -output release/
    python -m variational_mmt_torch.tools.release_checkpoint \\
        -model runs/ckpts/step_00004000 -output release/ -dtype bfloat16 [-ema]

``-model`` takes a checkpoint directory (its newest step is released) or
one ``step_*`` directory. The released checkpoint decodes as the source
does; ``-train_from`` it restarts the optimizer. Host code: no ``-device``.
"""

from __future__ import annotations

import argparse
import os

from variational_mmt_torch.train.checkpoint import latest_checkpoint, release_checkpoint


def main(argv=None) -> dict:
    p = argparse.ArgumentParser("vmmt-torch release checkpoint")
    p.add_argument("-model", required=True,
                   help="checkpoint dir (newest step) or a step_* dir")
    p.add_argument("-output", required=True, help="released checkpoint dir")
    p.add_argument("-dtype", default="keep", choices=["keep", "bfloat16"],
                   help="bfloat16: cast float params in the artifact")
    p.add_argument("-ema", action="store_true",
                   help="publish the EMA (Polyak-averaged) weights as the "
                        "artifact's params (requires -ema_decay > 0 at "
                        "train time); the standard deploy for an EMA run")
    args = p.parse_args(argv)

    src = args.model
    if not os.path.exists(os.path.join(src, "state.msgpack")):
        latest = latest_checkpoint(src)
        if latest is None:
            raise SystemExit(f"no checkpoint under {src}")
        src = latest
    info = release_checkpoint(src, args.output, dtype=args.dtype, ema=args.ema)
    mb = 1024.0 * 1024.0
    print(f"released {src} -> {args.output} "
          f"({info['src_bytes'] / mb:.1f} MB -> {info['dst_bytes'] / mb:.1f} MB, "
          f"dtype={args.dtype}, ema={args.ema})")
    return info


if __name__ == "__main__":
    main()
