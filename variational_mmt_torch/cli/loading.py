"""``-model`` checkpoint loading for the translate CLI. Mirrors
``load_model_spec`` of ``variational_mmt_tpu/cli/loading.py`` for a single
checkpoint: a step directory, or a run root resolved to its latest step;
``-use_ema`` decodes with the EMA weights. The optimizer state is dropped.
A comma-separated ensemble is refused, as the port's ``Translator`` refuses
one (ROADMAP.md queue 1, item 5.4).
"""

from __future__ import annotations

import dataclasses
import os

import torch

from variational_mmt_torch.config import Config, ModelConfig
from variational_mmt_torch.data.vocab import Vocab
from variational_mmt_torch.models.model import VMMTModel
from variational_mmt_torch.train.checkpoint import latest_checkpoint, load_checkpoint


def consumes_decode_feats(mcfg: ModelConfig) -> bool:
    """Decoding reads the image only through vmmt_c's conditional prior."""
    return mcfg.model_type == "vmmt_c" and mcfg.img_feat_dim > 0


@dataclasses.dataclass
class LoadedModel:
    model: VMMTModel
    cfg: Config
    step: int
    src_vocab: Vocab
    tgt_vocab: Vocab
    path: str


def resolve_checkpoint(path: str) -> str:
    """A step directory as given, or a run root's latest step."""
    if os.path.exists(os.path.join(path, "state.msgpack")):
        return path
    resolved = latest_checkpoint(path)
    if resolved is None:
        raise SystemExit(f"-model: no checkpoint at {path!r} (neither a state.msgpack dir nor "
                         "a run root with step_* dirs)")
    return resolved


def load_model_spec(spec: str, use_ema: bool = False, device=None) -> LoadedModel:
    if "," in spec:
        raise SystemExit("-model: ensembles (comma-separated checkpoints) are not ported yet "
                         "(ROADMAP.md queue 1, item 5.4); pass a single checkpoint")
    path = resolve_checkpoint(spec)
    state, cfg, model, src_vocab, tgt_vocab = load_checkpoint(path, device=device)
    print(f"loaded {path} (step {state.step}, {cfg.model.model_type})")
    if use_ema:
        if state.ema is None:
            raise SystemExit(f"-use_ema: {path} has no EMA state (trained with ema_decay=0); "
                             "retrain with -ema_decay or drop the flag")
        with torch.no_grad():
            for p, e in zip(model.parameters(), state.ema):
                p.copy_(e)
    return LoadedModel(model, cfg, state.step, src_vocab, tgt_vocab, path)
