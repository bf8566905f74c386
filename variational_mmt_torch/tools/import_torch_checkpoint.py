"""Import an upstream OpenNMT-py-family PyTorch checkpoint (``.pt``)
straight into a port checkpoint directory: the migration path for users of
the upstream code with trained models. Mirrors the root
``tools/import_torch_checkpoint.py`` flag for flag; its host code (the
stub-tolerant loader, the state-dict and vocab extraction, the mapping,
dimension inference and tree merge) is copied, and only the template and
the writer are the port's (``models/model.py`` ``build_model`` and
``init_params``, ``train/checkpoint.py`` ``save_checkpoint``):

    python -m variational_mmt_torch.tools.import_torch_checkpoint -ckpt model.pt \
        -out ckpts/imported [-strict] [-allow_partial] [-map rules.json]

1. ``torch.load`` the ``.pt``: restricted (``weights_only``) first, then,
   with a warning, an unpickler that replaces classes of the upstream
   package (``onmt.*``, not installed) by attribute bags, so the tensors
   and vocab tables still come out.
2. Map the state-dict tensors onto the model's parameter tree: the core
   NMT modules (embeddings, bi-GRU/LSTM encoder, input-feed stacked
   decoder, global attention, generator, bridge) follow OpenNMT-py's
   layout; the port's gates follow the same cuDNN convention ([r|z|n],
   the candidate's h-side bias inside the reset gate), so the conversion
   is transposes and column splits. The LSTM forget gate's structural +1
   is taken out of the imported ``bias_hh``.
3. Report what was not mapped (unconsumed source tensors, leaves left at
   fresh init); ``-strict`` refuses either. ``-map`` takes a JSON list of
   ``[src_regex, target_path_template, raw|t]`` rules for fork-specific
   modules.
4. Write a checkpoint (config.json, vocabs, state.msgpack with a fresh
   optimizer state) that the port's and the JAX package's loaders read.

Refusals: shape mismatches and unknown targets always; a bridge-less
source (OpenNMT-py's default passes the encoder finals straight through,
which the per-layer tanh bridge cannot represent) unless
``-allow_partial``. Leaves left at fresh init come from the port's own
initializer (numpy seed ``train.seed``), not from JAX's. SECURITY: a
``.pt`` is a pickle, and unpickling one can run code embedded in it; only
import files from sources you trust. Host code: loads on the CPU, no
``-device``.
"""

from __future__ import annotations

import argparse
import io
import json
import pickle
import re
import sys

import numpy as np

# ----------------------------------------------------------------------
# 1. stub-tolerant torch.load
# ----------------------------------------------------------------------
def _make_stub(module: str, name: str):
    """An attribute-bag class standing in for an unimportable pickled class.

    pickle restores instance state via __dict__ update (or __setstate__),
    so the stub ends up carrying the original attributes — enough to read
    vocab tables / opt namespaces out of it."""

    class _Stub:
        _stub_module = module
        _stub_name = name

        def __init__(self, *a, **k):
            self._stub_args = a
            self._stub_kwargs = k

        def __setstate__(self, state):
            if isinstance(state, dict):
                self.__dict__.update(state)
            else:
                self._stub_state = state

        def __repr__(self):
            return f"<stub {module}.{name}>"

    _Stub.__name__ = name
    return _Stub


class _StubUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        try:
            return super().find_class(module, name)
        except (ImportError, AttributeError):
            return _make_stub(module, name)


class _StubPickleModule:
    """Duck-typed ``pickle`` module handed to torch.load(pickle_module=...)."""

    Unpickler = _StubUnpickler
    # torch probes these attributes even when only loading
    load = staticmethod(lambda f, **kw: _StubUnpickler(f, **kw).load())
    loads = staticmethod(
        lambda b, **kw: _StubUnpickler(io.BytesIO(b), **kw).load())
    HIGHEST_PROTOCOL = pickle.HIGHEST_PROTOCOL


def load_torch_file(path: str):
    """Load the ``.pt``, restricted-first.

    SECURITY: a legacy torch checkpoint is a pickle — unpickling can execute
    arbitrary code, and the stub unpickler only replaces classes that FAIL
    to import (an importable reducer like ``os.system`` would still run).
    We therefore try torch's restricted ``weights_only=True`` loader first;
    only when that fails (legacy checkpoints carry vocab/opt objects it
    rejects) do we fall back to the permissive stub unpickler, with a loud
    warning. Only import ``.pt`` files from sources you trust.
    """
    import torch

    try:
        return torch.load(path, map_location="cpu", weights_only=True)
    except Exception:
        pass
    print("WARNING: restricted (weights_only) load failed — falling back to "
          "the permissive unpickler. Unpickling a legacy checkpoint can "
          "execute code embedded in the file; only proceed if you trust "
          "its source.", file=sys.stderr)
    try:
        return torch.load(path, map_location="cpu",
                          pickle_module=_StubPickleModule, weights_only=False)
    except TypeError:  # older torch: no weights_only kwarg
        return torch.load(path, map_location="cpu",
                          pickle_module=_StubPickleModule)


# ----------------------------------------------------------------------
# 2. state-dict extraction + vocab extraction
# ----------------------------------------------------------------------
def _is_tensor(x) -> bool:
    import torch

    return isinstance(x, torch.Tensor)


def extract_state_dict(ckpt) -> dict:
    """Flatten the upstream checkpoint into {dotted_name: np.float32 array}.

    Accepts the OpenNMT-py layout ({'model': sd, 'generator': sd, ...}),
    or a bare state_dict."""
    sd = {}
    if isinstance(ckpt, dict) and any(_is_tensor(v) for v in ckpt.values()):
        src = {"": ckpt}
    elif isinstance(ckpt, dict):
        src = {}
        if isinstance(ckpt.get("model"), dict):
            src[""] = ckpt["model"]
        if isinstance(ckpt.get("generator"), dict):
            src["generator."] = ckpt["generator"]
        if not src:
            raise ValueError(
                f"no state dict found in checkpoint (top-level keys: "
                f"{sorted(k for k in ckpt if isinstance(k, str))})")
    else:
        raise ValueError(f"unsupported checkpoint object: {type(ckpt)}")
    for prefix, d in src.items():
        for k, v in d.items():
            if _is_tensor(v):
                key = prefix + k
                # a 'generator.' prefix may already be present in 'model'
                if prefix and k.startswith(prefix):
                    key = k
                sd[key] = v.detach().to("cpu").float().numpy()
    return sd


def _vocab_itos(obj):
    """Best-effort itos list from an upstream vocab object (stub or real).

    Handles: torchtext Vocab (.itos), legacy onmt Dict (.idxToLabel {i: s}),
    plain list of strings, plain {str: int} stoi."""
    if obj is None:
        return None
    if isinstance(obj, (list, tuple)) and obj and all(
            isinstance(s, str) for s in obj):
        return list(obj)
    itos = getattr(obj, "itos", None)
    if isinstance(itos, (list, tuple)):
        return list(itos)
    i2l = getattr(obj, "idxToLabel", None)
    if isinstance(i2l, dict) and i2l:
        # compacting a gappy index map would silently shift every token
        # after the gap to a wrong id (embedding rows are positional)
        if sorted(i2l) != list(range(len(i2l))):
            sys.exit(
                f"checkpoint vocab has non-contiguous indices (e.g. a pruned "
                f"legacy Dict): {len(i2l)} entries, max index {max(i2l)}. "
                f"Remap it to dense 0..N-1 ids (and reorder the embedding "
                f"rows identically), then pass it via -src_vocab/-tgt_vocab.")
        return [i2l[i] for i in sorted(i2l)]
    if isinstance(obj, dict) and obj and all(
            isinstance(v, int) for v in obj.values()):
        inv = {v: k for k, v in obj.items()}
        if sorted(inv) != list(range(len(inv))):
            sys.exit(
                f"checkpoint stoi vocab has non-contiguous (or duplicate) "
                f"indices: {len(obj)} entries, {len(inv)} distinct ids, max "
                f"id {max(inv)}. Remap to dense 0..N-1 ids and pass via "
                f"-src_vocab/-tgt_vocab.")
        return [inv[i] for i in sorted(inv)]
    # torchtext Field wraps the vocab
    inner = getattr(obj, "vocab", None)
    if inner is not None and inner is not obj:
        return _vocab_itos(inner)
    return None


def extract_vocabs(ckpt):
    """(src_itos, tgt_itos) from 'vocab' / 'dicts' entries, else (None, None)."""
    if not isinstance(ckpt, dict):
        return None, None
    v = ckpt.get("vocab", ckpt.get("dicts"))
    if v is None:
        return None, None
    if isinstance(v, dict):
        return _vocab_itos(v.get("src")), _vocab_itos(v.get("tgt"))
    if isinstance(v, (list, tuple)):  # [('src', field), ('tgt', field)]
        out = {}
        for item in v:
            if isinstance(item, (list, tuple)) and len(item) == 2:
                out[item[0]] = _vocab_itos(item[1])
        return out.get("src"), out.get("tgt")
    return None, None


# ----------------------------------------------------------------------
# 3. the mapping
# ----------------------------------------------------------------------
# embeddings: three known naming generations of OpenNMT-py
_EMB_ALIASES = [
    "{side}.embeddings.make_embedding.emb_luts.0.weight",
    "{side}.embeddings.emb_luts.0.weight",
    "{side}.embeddings.word_lut.weight",
    "{side}.word_lut.weight",
]


def _first(sd, names):
    for n in names:
        if n in sd:
            return n
    return None


def _set(updates, path, value):
    node = updates
    parts = path.split("/")
    for p in parts[:-1]:
        node = node.setdefault(p, {})
    node[parts[-1]] = np.asarray(value, np.float32)


def _fix_lstm_bias(bias_hh: np.ndarray, n_gates: int) -> np.ndarray:
    """models/gru.py adds a structural +1 to the LSTM forget preactivation;
    torch learns it inside bias — subtract so imported math is identical."""
    if n_gates != 4:
        return bias_hh
    H = bias_hh.shape[0] // 4
    out = bias_hh.copy()
    out[H:2 * H] -= 1.0
    return out


def map_core(sd: dict, consumed: set) -> dict:
    """Map the deterministic OpenNMT-py core onto our tree. Returns nested
    updates dict; records consumed source keys in ``consumed``."""
    up: dict = {}

    # ---- embeddings
    for side, tgt in (("encoder", "src_embed"), ("decoder", "tgt_embed")):
        k = _first(sd, [a.format(side=side) for a in _EMB_ALIASES])
        if k:
            _set(up, f"{tgt}/embedding", sd[k])
            consumed.add(k)

    # ---- bi-RNN encoders (encoder.rnn.*; the latent target-side encoder,
    # if the fork exposes one as '<name>.rnn.*', goes through -map)
    for k in list(sd):
        m = re.fullmatch(
            r"encoder\.rnn\.(weight|bias)_(ih|hh)_l(\d+)(_reverse)?", k)
        if not m:
            continue
        kind, part, layer, rev = m.groups()
        dirname = "bwd" if rev else "fwd"
        base = f"encoder/{dirname}{layer}"
        w = sd[k]
        if kind == "weight":
            _set(up, f"{base}/ih/kernel" if part == "ih" else f"{base}/hh_kernel",
                 w.T)
        else:
            G = 0
            # gate count from the matching weight (bias len = G*H)
            if part == "hh":
                wk = sd.get(k.replace("bias", "weight"))
                if wk is not None:
                    G = wk.shape[0] // wk.shape[1]
                w = _fix_lstm_bias(w, G)
            _set(up, f"{base}/ih/bias" if part == "ih" else f"{base}/hh_bias", w)
        consumed.add(k)

    # ---- decoder: input-feed StackedGRU/StackedLSTM cells
    # (decoder.rnn.layers.{l}.weight_ih ...)
    dec_layers = sorted({
        int(m.group(1)) for k in sd
        if (m := re.fullmatch(r"decoder\.rnn\.layers\.(\d+)\..*", k))})
    emb_k = _first(sd, [a.format(side="decoder") for a in _EMB_ALIASES])
    E = sd[emb_k].shape[1] if emb_k else None
    for l in dec_layers:
        base = f"decoder.rnn.layers.{l}"
        w_ih, b_ih = sd.get(f"{base}.weight_ih"), sd.get(f"{base}.bias_ih")
        w_hh, b_hh = sd.get(f"{base}.weight_hh"), sd.get(f"{base}.bias_hh")
        if w_hh is not None:
            G = w_hh.shape[0] // w_hh.shape[1]
            _set(up, f"decoder/step/hh_kernel{l}", w_hh.T)
            consumed.add(f"{base}.weight_hh")
            if b_hh is not None:
                _set(up, f"decoder/step/hh_bias{l}", _fix_lstm_bias(b_hh, G))
                consumed.add(f"{base}.bias_hh")
        if w_ih is None:
            continue
        if l == 0:
            # layer 0 consumes cat([emb, input_feed]) (SURVEY.md §3.2):
            # split the columns between our hoisted ih_emb and ih_feed
            if E is None:
                E = w_ih.shape[1] - w_ih.shape[0] // (
                    w_hh.shape[0] // w_hh.shape[1] if w_hh is not None else 3)
            _set(up, "decoder/ih_emb/kernel", w_ih[:, :E].T)
            if w_ih.shape[1] > E:
                _set(up, "decoder/step/ih_feed/kernel", w_ih[:, E:].T)
            if b_ih is not None:
                _set(up, "decoder/ih_emb/bias", b_ih)
                consumed.add(f"{base}.bias_ih")
        else:
            _set(up, f"decoder/step/ih_mid{l - 1}/kernel", w_ih.T)
            if b_ih is not None:
                _set(up, f"decoder/step/ih_mid{l - 1}/bias", b_ih)
                consumed.add(f"{base}.bias_ih")
        consumed.add(f"{base}.weight_ih")

    # ---- decoder as plain nn.GRU (StdRNNDecoder, input_feed=False)
    for k in list(sd):
        m = re.fullmatch(r"decoder\.rnn\.(weight|bias)_(ih|hh)_l(\d+)", k)
        if not m:
            continue
        kind, part, layer = m.group(1), m.group(2), int(m.group(3))
        w = sd[k]
        if part == "hh":
            tgt = f"decoder/step/hh_kernel{layer}" if kind == "weight" \
                else f"decoder/step/hh_bias{layer}"
            if kind == "bias":
                wk = sd.get(f"decoder.rnn.weight_hh_l{layer}")
                w = _fix_lstm_bias(w, wk.shape[0] // wk.shape[1] if wk is not None else 0)
                _set(up, tgt, w)
            else:
                _set(up, tgt, w.T)
        else:
            base = "decoder/ih_emb" if layer == 0 else f"decoder/step/ih_mid{layer - 1}"
            _set(up, f"{base}/kernel" if kind == "weight" else f"{base}/bias",
                 w.T if kind == "weight" else w)
        consumed.add(k)

    # ---- global attention
    attn_map = [
        ("decoder.attn.linear_in.weight", "decoder/step/attn/linear_in/kernel", True),
        ("decoder.attn.linear_out.weight", "decoder/step/attn/linear_out/kernel", True),
        ("decoder.attn.linear_out.bias", "decoder/step/attn/linear_out/bias", False),
        ("decoder.attn.linear_query.weight", "decoder/step/attn/linear_query/kernel", True),
        ("decoder.attn.linear_query.bias", "decoder/step/attn/linear_query/bias", False),
        ("decoder.attn.linear_context.weight", "decoder/step/attn/linear_context/kernel", True),
        ("decoder.attn.v.weight", "decoder/step/attn/v/kernel", True),
    ]
    for src, tgt, transpose in attn_map:
        if src in sd:
            _set(up, tgt, sd[src].T if transpose else sd[src])
            consumed.add(src)

    # ---- generator (nn.Sequential(Linear, LogSoftmax) upstream)
    for src in ("generator.0.weight", "generator.weight"):
        if src in sd:
            _set(up, "generator/kernel", sd[src].T)
            consumed.add(src)
            break
    for src in ("generator.0.bias", "generator.bias"):
        if src in sd:
            _set(up, "generator/bias", sd[src])
            consumed.add(src)
            break

    # ---- encoder->decoder bridge [U-MED naming: '-bridge'-era Linears]
    for k in list(sd):
        m = re.fullmatch(r"(?:decoder\.)?bridge\.(\d+)\.(weight|bias)", k)
        if m:
            l, kind = int(m.group(1)), m.group(2)
            _set(up, f"bridge{l}/kernel" if kind == "weight" else f"bridge{l}/bias",
                 sd[k].T if kind == "weight" else sd[k])
            consumed.add(k)
    return up


def apply_user_map(sd: dict, rules, up: dict, consumed: set):
    """-map rules: [[src_regex, tgt_template, transform], ...]."""
    for src_re, tgt_tpl, transform in rules:
        pat = re.compile(src_re)
        for k in sd:
            m = pat.fullmatch(k)
            if not m:
                continue
            tgt = m.expand(tgt_tpl)
            v = sd[k]
            if transform == "t":
                v = v.T
            elif transform != "raw":
                raise ValueError(f"unknown -map transform {transform!r}")
            _set(up, tgt, v)
            consumed.add(k)


# ----------------------------------------------------------------------
# 4. dim inference + tree merge
# ----------------------------------------------------------------------
def infer_dims(sd: dict) -> dict:
    dims = {}
    enc_emb = _first(sd, [a.format(side="encoder") for a in _EMB_ALIASES])
    dec_emb = _first(sd, [a.format(side="decoder") for a in _EMB_ALIASES])
    if enc_emb:
        dims["src_vocab_size"], dims["emb_dim"] = sd[enc_emb].shape
    if dec_emb:
        dims["tgt_vocab_size"] = sd[dec_emb].shape[0]
        dims.setdefault("emb_dim", sd[dec_emb].shape[1])
    hh0 = sd.get("decoder.rnn.layers.0.weight_hh",
                 sd.get("decoder.rnn.weight_hh_l0"))
    if hh0 is not None:
        dims["hidden_dim"] = hh0.shape[1]
        dims["rnn_type"] = {3: "gru", 4: "lstm"}.get(
            hh0.shape[0] // hh0.shape[1], "gru")
    enc_layers = {int(m.group(1)) for k in sd if (m := re.fullmatch(
        r"encoder\.rnn\.weight_ih_l(\d+)(?:_reverse)?", k))}
    if enc_layers:
        dims["enc_layers"] = max(enc_layers) + 1
    dec_layers = set()
    for k in sd:
        m = (re.fullmatch(r"decoder\.rnn\.layers\.(\d+)\.weight_ih", k)
             or re.fullmatch(r"decoder\.rnn\.weight_ih_l(\d+)", k))
        if m:
            dec_layers.add(int(m.group(1)))
    if dec_layers:
        dims["dec_layers"] = max(dec_layers) + 1
    dims["input_feed"] = any(k.startswith("decoder.rnn.layers.") for k in sd)
    if "decoder.attn.v.weight" in sd:
        dims["attn_type"] = "mlp"
    elif "decoder.attn.linear_in.weight" in sd:
        dims["attn_type"] = "general"
    elif "decoder.attn.linear_out.weight" in sd:
        dims["attn_type"] = "dot"
    return dims


def merge_into(params, updates, prefix=""):
    """Overwrite init-tree leaves with mapped values (shape-checked).
    Returns (filled_paths, mismatched, unknown_target_paths)."""
    filled, mismatched, unknown = [], [], []
    for k, v in updates.items():
        path = f"{prefix}{k}"
        if k not in params:
            unknown.append(path)
            continue
        # a -map rule can land an array on an interior node (or a subtree on
        # a leaf); classify instead of crashing on dict.shape / recursing
        # into an ndarray
        if isinstance(v, dict) != isinstance(params[k], dict):
            unknown.append(
                f"{path} ({'subtree' if isinstance(v, dict) else 'tensor'} "
                f"mapped onto a "
                f"{'subtree' if isinstance(params[k], dict) else 'leaf'})")
            continue
        if isinstance(v, dict):
            f2, m2, u2 = merge_into(params[k], v, path + "/")
            filled += f2
            mismatched += m2
            unknown += u2
        else:
            tgt = params[k]
            if tuple(tgt.shape) != tuple(v.shape):
                mismatched.append(f"{path}: ours {tuple(tgt.shape)} vs "
                                  f"imported {tuple(v.shape)}")
            else:
                params[k] = v.astype(np.float32)
                filled.append(path)
    return filled, mismatched, unknown


def leaf_paths(tree, prefix=""):
    out = []
    for k, v in tree.items():
        p = f"{prefix}{k}"
        out += leaf_paths(v, p + "/") if isinstance(v, dict) else [p]
    return out


# ----------------------------------------------------------------------
# 5. CLI
# ----------------------------------------------------------------------
def main(argv=None):
    ap = argparse.ArgumentParser(
        "import_torch_checkpoint",
        description="Convert an upstream PyTorch checkpoint into a native "
                    "checkpoint directory")
    ap.add_argument("-ckpt", required=True, help="upstream .pt file")
    ap.add_argument("-out", required=True, help="output checkpoint dir")
    ap.add_argument("-model_type", default=None,
                    choices=[None, "nmt", "vmmt_f", "vmmt_c"],
                    help="default: nmt unless latent tensors were mapped")
    ap.add_argument("-src_vocab", default=None,
                    help="vocab json (else extracted from the checkpoint)")
    ap.add_argument("-tgt_vocab", default=None)
    ap.add_argument("-map", dest="map_file", default=None,
                    help="JSON list of [src_regex, tgt_path, raw|t] extra rules")
    ap.add_argument("-latent_dim", type=int, default=None)
    ap.add_argument("-img_feat_dim", type=int, default=None)
    ap.add_argument("-strict", action="store_true",
                    help="error on unconsumed source tensors or unfilled "
                         "target leaves")
    ap.add_argument("-allow_partial", action="store_true",
                    help="write the checkpoint even when load-bearing "
                         "target leaves (encoder->decoder bridge) stayed at "
                         "fresh init. Default: refuse — a bridge-less "
                         "upstream model (OpenNMT-py's default passes "
                         "encoder finals straight through) cannot be "
                         "represented faithfully by the native per-layer "
                         "tanh bridge, and random bridge kernels silently "
                         "change every decode")
    ap.add_argument("-compute_dtype", default="float32",
                    choices=["float32", "bfloat16"],
                    help="compute dtype baked into the imported config. "
                         "Default float32: the 'forward logits equal to "
                         "torch' guarantee holds at f32; bfloat16 decodes "
                         "faster but may not reproduce upstream outputs "
                         "bit-for-bit")
    opt = ap.parse_args(argv)

    ckpt = load_torch_file(opt.ckpt)
    sd = extract_state_dict(ckpt)
    print(f"loaded {len(sd)} tensors from {opt.ckpt}")

    consumed: set = set()
    updates = map_core(sd, consumed)
    if opt.map_file:
        with open(opt.map_file) as f:
            apply_user_map(sd, json.load(f), updates, consumed)

    dims = infer_dims(sd)
    if not {"src_vocab_size", "tgt_vocab_size", "emb_dim", "hidden_dim"} <= set(dims):
        sys.exit(f"could not infer model dims from the state dict "
                 f"(got {dims}); is this an OpenNMT-family checkpoint?")

    from variational_mmt_torch.config import Config, ModelConfig
    from variational_mmt_torch.convert import params_from_jax
    from variational_mmt_torch.data.vocab import SPECIALS, Vocab
    from variational_mmt_torch.models.model import build_model, init_params
    from variational_mmt_torch.train.checkpoint import save_checkpoint
    from variational_mmt_torch.train.trainer import create_train_state

    has_latent = any(p.startswith(("infnet/", "prior/")) for p in leaf_paths(updates))
    model_type = opt.model_type or (
        "vmmt_c" if any(p.startswith("prior/") for p in leaf_paths(updates))
        else "vmmt_f" if has_latent else "nmt")
    mcfg = ModelConfig(
        model_type=model_type,
        src_vocab_size=dims["src_vocab_size"],
        tgt_vocab_size=dims["tgt_vocab_size"],
        emb_dim=dims["emb_dim"], hidden_dim=dims["hidden_dim"],
        enc_layers=dims.get("enc_layers", 2),
        dec_layers=dims.get("dec_layers", 2),
        rnn_type=dims.get("rnn_type", "gru"),
        attn_type=dims.get("attn_type", "general"),
        input_feed=dims.get("input_feed", True),
        latent_dim=opt.latent_dim or 128,
        img_feat_dim=(opt.img_feat_dim if opt.img_feat_dim is not None
                      else (2048 if model_type != "nmt" else 0)),
        compute_dtype=opt.compute_dtype,
    )
    print(f"inferred config: {model_type} E={mcfg.emb_dim} H={mcfg.hidden_dim} "
          f"enc={mcfg.enc_layers} dec={mcfg.dec_layers} rnn={mcfg.rnn_type} "
          f"attn={mcfg.attn_type} input_feed={mcfg.input_feed} "
          f"V=({mcfg.src_vocab_size},{mcfg.tgt_vocab_size})")

    cfg = Config(model=mcfg)
    # param_init=0: the init tree is only a template for unmapped leaves
    cfg.train.param_init = 0.0
    params = init_params(mcfg, seed=cfg.train.seed)
    filled, mismatched, unknown = merge_into(params, updates)
    unconsumed = sorted(set(sd) - consumed)
    unfilled = sorted(set(leaf_paths(params)) - set(filled))

    print(f"mapped {len(filled)} / {len(leaf_paths(params))} target leaves")
    for title, items in (("shape-mismatched", mismatched),
                         ("unknown targets (check -map rules)", unknown),
                         ("UNCONSUMED source tensors", unconsumed),
                         ("target leaves left at fresh init", unfilled)):
        if items:
            print(f"-- {title} ({len(items)}):")
            for it in items:
                print(f"   {it}")
    if mismatched or unknown:
        sys.exit("shape mismatches / unknown targets — refusing to write")
    if opt.strict and (unconsumed or unfilled):
        sys.exit("-strict: unmapped tensors remain (see report above)")
    # decode INIT depends on the bridge: leaving it at random init silently
    # diverges every translation from the source model. Bridge-less upstream
    # models (OpenNMT-py default: encoder finals passed through, LSTM cell
    # state carried) cannot be represented by the native per-layer tanh
    # bridge at all — refuse rather than write a lookalike checkpoint.
    unfilled_bridge = [p for p in unfilled if p.startswith("bridge")]
    if unfilled_bridge and not opt.allow_partial:
        sys.exit(
            f"no bridge tensors found in the source but the native model "
            f"has {len(unfilled_bridge)} bridge leaves "
            f"({', '.join(unfilled_bridge[:4])}{'...' if len(unfilled_bridge) > 4 else ''}). "
            f"A bridge-less upstream model cannot be imported faithfully "
            f"(its decoder init is the raw encoder finals; ours applies a "
            f"learned tanh Linear). Re-run with -allow_partial to write "
            f"anyway (decode WILL differ from the source model), or supply "
            f"-map rules if the fork stores its bridge under another name.")

    def _load_vocab(flag, size, side):
        if flag:
            return Vocab.load(flag)
        s, t = extract_vocabs(ckpt)
        itos = s if side == "src" else t
        if itos is None:
            sys.exit(f"no {side} vocab in the checkpoint — pass -{side}_vocab")
        if itos[:4] != SPECIALS:
            sys.exit(f"{side} vocab specials are {itos[:4]}, expected "
                     f"{SPECIALS} (OpenNMT-py order) — remap it and pass "
                     f"-{side}_vocab")
        if len(itos) != size:
            sys.exit(f"{side} vocab has {len(itos)} types but the embedding "
                     f"table has {size} rows")
        return Vocab(itos)

    src_vocab = _load_vocab(opt.src_vocab, mcfg.src_vocab_size, "src")
    tgt_vocab = _load_vocab(opt.tgt_vocab, mcfg.tgt_vocab_size, "tgt")

    model = build_model(mcfg, device="cpu")
    model.load_state_dict(params_from_jax(params, mcfg))
    state = create_train_state(cfg, model)
    path = save_checkpoint(opt.out, state, cfg, src_vocab, tgt_vocab)
    print(f"wrote {path}")
    return path


if __name__ == "__main__":
    main()
