"""PyTorch port: the rules around it. It imports nothing of JAX or of the
JAX package (and neither msgpack nor flax, which the card's machine lacks:
checkpoints and the serving wire go through the port's codec); what a
serving dispatcher process imports loads no torch; its entry points need
CUDA unless asked for the CPU; kernel
wrappers take their plain versions only for CPU tensors and never swallow
an error; every option outside the port raises NotImplementedError, and
the model options of ROADMAP.md item 5.5, once refused, build and run."""

import ast
import dataclasses
import pathlib
import re

import numpy as np
import pytest
import torch

from variational_mmt_torch import kernels
from variational_mmt_torch.config import DecodeConfig, ModelConfig
from variational_mmt_torch.data.vocab import SPECIALS, Vocab
from variational_mmt_torch.decode.translator import Translator, make_translate_fn
from variational_mmt_torch.models.model import build_model
from variational_mmt_torch.ops import decode_step as ds
from variational_mmt_torch.ops import decoder, gru_scan

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "variational_mmt_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "msgpack", "variational_mmt_tpu")
TINY = dict(model_type="vmmt_c", src_vocab_size=24, tgt_vocab_size=24, emb_dim=16,
            hidden_dim=16, latent_dim=4, img_feat_dim=6, compute_dtype="float32",
            use_pallas=True)


def imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_nothing_of_jax(path):
    bad = [m for m in imported_modules(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


# a ``file:line`` citation of the JAX package opens nothing (chip_smoke.py's
# "replaces" fields); any other string naming a path in it is refused
CITATION = re.compile(r"variational_mmt_tpu/[\w/]+\.py:\d+")


def path_strings(path):
    """Every string constant of ``path`` that is not a docstring."""
    tree = ast.parse(path.read_text(), filename=str(path))
    docs = {id(node.body[0].value) for node in ast.walk(tree)
            if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef))
            and node.body and isinstance(node.body[0], ast.Expr)
            and isinstance(node.body[0].value, ast.Constant)}
    return [n.value for n in ast.walk(tree)
            if isinstance(n, ast.Constant) and isinstance(n.value, str) and id(n) not in docs]


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_names_no_path_into_the_jax_package(path):
    """No file of the port reads from the JAX package's directory: no
    string (an f-string's parts too) names ``variational_mmt_tpu`` as a
    path, so nothing compiles or loads the JAX package's C++ sources or
    library without importing it."""
    bad = [v for v in path_strings(path) if "variational_mmt_tpu" in v
           and CITATION.fullmatch(v.strip()) is None]
    assert not bad, f"{path.name} names {bad}"


def test_path_guard_catches_a_path_into_the_jax_package(tmp_path):
    src = tmp_path / "loader.py"
    src.write_text('"""Loads variational_mmt_tpu/native/batcher.cpp."""\n'
                   'import os\n'
                   'SRC = os.path.join(ROOT, "variational_mmt_tpu", "native")\n'
                   'CITE = "variational_mmt_tpu/ops/pallas/gru.py:165"\n')
    named = [v for v in path_strings(src) if "variational_mmt_tpu" in v]
    assert sorted(named) == ["variational_mmt_tpu", "variational_mmt_tpu/ops/pallas/gru.py:165"]
    assert [v for v in named if CITATION.fullmatch(v) is None] == ["variational_mmt_tpu"]


def test_port_package_found():
    names = {p.name for p in PORT_FILES}
    assert {"chip_smoke.py", "translator.py", "gru_scan.py", "decode_step.py", "decoder.py",
            "trainer.py", "checkpoint.py", "msgpack_io.py", "loading.py", "logging.py",
            "tensorboard.py", "streams.py", "beam.py", "service.py", "frontend.py", "rpc.py",
            "http_server.py", "errors.py", "serve.py", "msgpack_codec.py", "iw_eval.py",
            "diagnostics.py", "mbr.py", "meteor.py", "porter.py", "bleu.py", "prefetch.py",
            "fused_decoder.py"} <= names
    scanned = {p.parent.name for p in PORT_FILES}
    assert {"cli", "utils", "train", "data", "decode", "serve", "evals", "native"} <= scanned


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_need_cuda_unless_cpu_is_asked(no_cuda):
    cfg = ModelConfig(**TINY)
    vocab = Vocab(SPECIALS + ["a", "b"])
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(cfg)
    model = build_model(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        Translator(model, vocab, vocab)
    with pytest.raises(RuntimeError, match="CUDA"):
        Translator(model, vocab, vocab, device="cuda")
    assert Translator(model, vocab, vocab, device="cpu").device.type == "cpu"


def test_wrappers_have_no_try_that_could_fall_back():
    for mod in (gru_scan, ds, decoder, kernels):
        tree = ast.parse(pathlib.Path(mod.__file__).read_text())
        assert not [n for n in ast.walk(tree) if isinstance(n, ast.Try)], mod.__name__


def test_wrappers_on_a_non_cpu_tensor_launch_or_raise(monkeypatch):
    """Off the CPU a wrapper goes to its kernel; an error there reaches the
    caller (meta tensors stand in for CUDA ones: shapes, no data)."""
    class NoKernel(RuntimeError):
        pass

    def library(name):
        raise NoKernel(name)

    monkeypatch.setattr(kernels, "library", library)
    meta = lambda *s: torch.empty(*s, device="meta")  # noqa: E731
    N, S, H = 4, 3, 8
    chain = (meta(N, 3 * H), meta(N, H), meta(N, H), meta(N, H), meta(H, 3 * H),
             meta(H, 3 * H), meta(3 * H), meta(H, 3 * H), meta(3 * H), meta(H, 3 * H),
             meta(3 * H))
    with pytest.raises(NoKernel):
        gru_scan.gru_layer_scan(meta(N, 5, 3 * H), meta(N, 5), meta(N, H), meta(H, 3 * H),
                                meta(3 * H))
    with pytest.raises(NoKernel):
        ds.gru_chain(*chain)
    with pytest.raises(NoKernel):
        ds.decode_step(*chain, meta(N, S, H), meta(N, S, H), meta(H, H), meta(N, S))
    with pytest.raises(TypeError):  # mixed dtypes are refused, not converted
        ds.gru_chain(chain[0].to(torch.bfloat16), *chain[1:])
    T = 5
    scan = (meta(N, T, 3 * H), meta(N, T), meta(N, H), meta(H, 3 * H), meta(3 * H))
    with pytest.raises(NoKernel):
        gru_scan.gru_layer_scan_bwd(*scan, meta(N, T, H), meta(N, T, H))
    seq = (meta(N, T, 3 * H), meta(N, T, H), meta(N, H), meta(N, H)) + chain[4:] + (
        meta(N, S, H), meta(N, S, H), meta(H, H))
    with pytest.raises(NoKernel):
        decoder.decoder_fwd(*seq, meta(N, S))
    with pytest.raises(NoKernel):
        decoder.decoder_bwd(*seq, meta(N, T, H), meta(N, T, H), meta(N, T, H), meta(N, T, S),
                            meta(N, T, H), meta(N, T, S))
    with pytest.raises(TypeError):
        decoder.decoder_fwd(seq[0].to(torch.bfloat16), *seq[1:], meta(N, S))


@pytest.mark.parametrize("over", [
    dict(rnn_type="lstm"), dict(attn_type="dot"), dict(attn_type="mlp"),
    dict(img_feat_type="conv", img_pool="attn"), dict(input_feed=False),
], ids=lambda d: ",".join(f"{k}={v}" for k, v in d.items()))
def test_item_5_5_model_options_build_and_train(over):
    """Once refused (ROADMAP.md item 5.5): each option builds, takes random
    weights from ``init_params`` and gives finite logits and gradients on
    the kernel route (the kernels' plain versions on the CPU)."""
    from variational_mmt_torch.convert import params_from_jax
    from variational_mmt_torch.models.model import init_params

    cfg = ModelConfig(**{**TINY, **over})
    model = build_model(cfg, device="cpu")
    model.load_state_dict(params_from_jax(init_params(cfg, seed=0), cfg))
    img = torch.randn((2, 49, 6) if cfg.img_feat_type == "conv" else (2, 6))
    out = model(torch.randint(4, 24, (2, 5)), torch.randint(4, 24, (2, 7)), img, sample=False)
    assert out["logits"].shape == (2, 7, 24) and torch.isfinite(out["logits"]).all()
    out["logits"].logsumexp(-1).sum().backward()
    assert all(torch.isfinite(p.grad).all() for p in model.parameters() if p.grad is not None)
    assert float(model.bridge0.kernel.grad.abs().max()) > 0.0


@pytest.mark.parametrize("over", [
    dict(model_type="vmmt_f"), dict(model_type="nmt"), dict(z_cond="init+input"),
    dict(share_embeddings=True),
], ids=lambda d: ",".join(f"{k}={v}" for k, v in d.items()))
def test_ported_model_families_and_z_cond_build(over):
    """Once refused above; the families, init+input and one shared
    embedding table are ported now."""
    model = build_model(ModelConfig(**{**TINY, **over}), device="cpu")
    assert model.is_latent == (model.cfg.model_type != "nmt")
    assert hasattr(model, "z_input_proj") == (over.get("z_cond") == "init+input")
    assert hasattr(model, "src_embed") != bool(over.get("share_embeddings"))


@pytest.mark.parametrize("over", [
    dict(infer_dtype="bfloat16"), dict(infer_dtype="int8"),
], ids=lambda d: ",".join(f"{k}={v}" for k, v in d.items()))
def test_ported_infer_dtypes_build(over):
    """Once refused naming item 5.4; the translator now holds its weights
    at the dtype (parity with JAX: tests/test_torch_infer_dtype.py)."""
    model = build_model(ModelConfig(**TINY), device="cpu")
    dcfg = dataclasses.replace(DecodeConfig(), **over)
    make_translate_fn(model, dcfg)
    vocab = Vocab(SPECIALS + [f"w{i}" for i in range(20)])
    tr = Translator(model, vocab, vocab, dcfg, buckets=[8], device="cpu")
    held = {v.dtype if torch.is_tensor(v) else v["int8"].dtype
            for k, v in tr.weights[0].items() if model.state_dict()[k].dim() >= 2}
    assert held == {torch.bfloat16 if over["infer_dtype"] == "bfloat16" else torch.int8}


@pytest.mark.parametrize("over", [
    dict(sampling_temp=1.0, beam_size=1), dict(latent_from="sample"),
    dict(coverage_beta=0.2), dict(block_ngram_repeat=2), dict(replace_unk=True),
    dict(dump_beam=True),
], ids=lambda d: ",".join(f"{k}={v}" for k, v in d.items()))
def test_ported_decode_options_build(over):
    """Once refused above; sampling, latent_from=sample and the beam's
    options are ported now (their parity with JAX: tests/test_torch_
    beam_options.py and tests/test_torch_sampling.py)."""
    model = build_model(ModelConfig(**TINY), device="cpu")
    vocab = Vocab(SPECIALS + ["a", "b"])
    dcfg = dataclasses.replace(DecodeConfig(max_length=4), **over)
    make_translate_fn(model, dcfg)
    tr = Translator(model, vocab, vocab, dcfg, device="cpu")
    img = np.zeros((1, TINY["img_feat_dim"]), np.float32)
    assert len(tr.translate_ids([[4, 5]], img)) == 1
    tr.close()


# what a dispatcher process imports: the frontend, the RPC and its codec,
# the tokenizer, BPE with its native segmenter, and the vocab
# (tests/test_torch_serve.py runs it)
TORCH_FREE = ["serve/__init__.py", "serve/errors.py", "serve/frontend.py", "serve/rpc.py",
              "utils/__init__.py", "utils/msgpack_codec.py", "data/__init__.py",
              "data/tokenizer.py", "data/bpe.py", "data/vocab.py", "native/__init__.py",
              "__init__.py"]


@pytest.mark.parametrize("rel", TORCH_FREE)
def test_wire_modules_import_neither_torch_nor_msgpack(rel):
    """No import of torch or msgpack, and of the port only modules that are
    torch-free themselves."""
    path = ROOT / "variational_mmt_torch" / rel
    ours = {"variational_mmt_torch." + r[:-3].replace("/", ".").replace(".__init__", "")
            for r in TORCH_FREE if r != "__init__.py"} | {"variational_mmt_torch"}
    for m in imported_modules(path):
        assert m.split(".")[0] not in ("torch", "msgpack", "jax"), (rel, m)
        if m.startswith("variational_mmt_torch"):
            assert m in ours, (rel, m)


def test_ensembles_mesh_and_packing_raise():
    """A mesh raises, naming its ROADMAP item; an ensemble, once refused
    too (item 5.4), builds (tests/test_torch_ensemble.py holds it to JAX)."""
    model = build_model(ModelConfig(**TINY), device="cpu")
    vocab = Vocab(SPECIALS + ["a", "b"])
    assert len(Translator([model, model], vocab, vocab, device="cpu").models) == 2
    # item 5.8 ported the mesh: only a parallel.mesh.Mesh is one
    with pytest.raises(TypeError, match="Mesh"):
        Translator(model, vocab, vocab, mesh=object(), device="cpu")


def test_conv_features_are_mean_pooled():
    cfg = ModelConfig(**{**TINY, "img_feat_type": "conv"})
    model = build_model(cfg, device="cpu")
    img = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 3, 6)).astype(np.float32))
    assert torch.equal(model._img_in(img), img.mean(dim=1))
