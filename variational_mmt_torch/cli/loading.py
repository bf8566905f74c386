"""``-model`` checkpoint loading for the translate and serve CLIs. Mirrors
``load_model_spec`` of ``variational_mmt_tpu/cli/loading.py`` (:28-119): a
step directory, or a run root resolved to its latest step, or several of
them comma-separated (an ensemble). ``-use_ema`` decodes with each member's
EMA weights. The optimizer state is dropped. An ensemble's members must
share both vocabs, and its vmmt_c members the image-feature interface (one
feature tensor feeds every conditional prior; vmmt_f and nmt members ignore
the image at decode and mix freely).
"""

from __future__ import annotations

import dataclasses
import os
from typing import List

import torch

from variational_mmt_torch.config import Config, ModelConfig
from variational_mmt_torch.data.vocab import Vocab
from variational_mmt_torch.models.model import VMMTModel
from variational_mmt_torch.train.checkpoint import latest_checkpoint, load_checkpoint


def consumes_decode_feats(mcfg: ModelConfig) -> bool:
    """Decoding reads the image only through vmmt_c's conditional prior."""
    return mcfg.model_type == "vmmt_c" and mcfg.img_feat_dim > 0


@dataclasses.dataclass
class LoadedModels:
    """One or more checkpoints loaded for decoding, one entry a member."""

    models: List[VMMTModel]
    cfgs: List[Config]
    steps: List[int]
    src_vocab: Vocab
    tgt_vocab: Vocab

    @property
    def ensemble(self) -> bool:
        return len(self.models) > 1

    def translator_args(self):
        """The model for a ``Translator``: the one model, or the list."""
        return self.models if self.ensemble else self.models[0]


def resolve_checkpoint(path: str) -> str:
    """A step directory as given, or a run root's latest step."""
    if os.path.exists(os.path.join(path, "state.msgpack")):
        return path
    resolved = latest_checkpoint(path)
    if resolved is None:
        raise SystemExit(f"-model: no checkpoint at {path!r} (neither a state.msgpack dir nor "
                         "a run root with step_* dirs)")
    return resolved


def load_device(device, infer_dtype: str):
    """Where a CLI reads its checkpoints: the decode device at float32, else
    host memory, since the translator keeps only its cast weights on the
    device (f32 members there too would outweigh them)."""
    return device if infer_dtype in ("", "float32") else torch.device("cpu")


def load_model_spec(spec: str, use_ema: bool = False, device=None) -> LoadedModels:
    """Load ``-model`` onto ``device``; SystemExit with an operator's
    message on an empty path segment, a member without EMA state under
    ``use_ema``, another vocab, or vmmt_c members on different image
    features."""
    raw_paths = [s.strip() for s in spec.split(",")]
    if any(not s for s in raw_paths):
        raise SystemExit(f"-model: empty checkpoint path in {spec!r} (stray comma?)")
    models, cfgs, steps = [], [], []
    src_vocab = tgt_vocab = None
    for raw in raw_paths:
        path = resolve_checkpoint(raw)
        state, cfg, model, sv, tv = load_checkpoint(path, device=device)
        print(f"loaded {path} (step {state.step}, {cfg.model.model_type})")
        if src_vocab is None:
            src_vocab, tgt_vocab = sv, tv
        elif sv.itos != src_vocab.itos or tv.itos != tgt_vocab.itos:
            # the beam combines distributions by position, and the source
            # is encoded once
            raise SystemExit(f"ensemble member {path} was trained with a different vocab; "
                             "all -model checkpoints must come from the same preprocess run")
        if use_ema:
            if state.ema is None:
                raise SystemExit(f"-use_ema: {path} has no EMA state (trained with "
                                 "ema_decay=0); retrain with -ema_decay or drop the flag")
            with torch.no_grad():
                for p, e in zip(model.parameters(), state.ema):
                    p.copy_(e)
        models.append(model)
        cfgs.append(cfg)
        steps.append(state.step)
        del state  # the optimizer moments go with it
    ifaces = {(c.model.img_feat_dim, c.model.img_feat_type)
              for c in cfgs if consumes_decode_feats(c.model)}
    if len(ifaces) > 1:
        raise SystemExit(f"ensemble members disagree on the image-feature interface "
                         f"{sorted(ifaces)}: all vmmt_c members must be trained on the same "
                         "feature type/dim (one -img_feats tensor feeds every conditional "
                         "prior)")
    return LoadedModels(models, cfgs, steps, src_vocab, tgt_vocab)
