"""PyTorch port: decoding, the IW-ELBO and checkpoints across ranks
(parallel/, ROADMAP.md item 5.8) on a CPU gloo mesh of 2 ranks against the
JAX package on its virtual CPU mesh of 2 devices, the port's data-parallel
training against its single process, and the train and translate CLIs
under ``torchrun``.

The ranks run once for the module (tests/torch_parallel_worker.py, group
``decode``: TP-2, one data x two model ranks, and DP-2, each rank a
process, with a timeout). The cases mirror tests/test_tp.py (decode :232,
int8 decode :260, IW :297, the checkpoint round trip :313). Inputs are
numpy-seeded, parameters JAX's (``params_from_jax``), the IW noise JAX's
own, injected as tests/test_torch_iw_eval.py injects it. f32. Tolerances:
decoded token ids equal and scores within 1e-4 (tests/test_torch_translate.py;
at int8 the tokens of all but one sentence, as
tests/test_torch_infer_dtype.py allows for a bf16-rounded near tie, and
TP-2 int8 against the port's own single process equal with scores within
2e-5, tests/test_tp.py:287); IW bounds 1e-5 relative; checkpoint
parameters exact against the ranks' gathered ones and 2e-3 relative /
1e-4 absolute against JAX's single device after 2 steps
(tests/test_tp.py:344); the DP-2 losses within 1e-6 relative of the port's
single process."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_iw_eval import LAYOUT, TINY as IW_TINY, host_batches, jax_eps, models
from test_torch_parallel import cfg_dict, jax_steps, np_batch, np_tree
from test_tp import V, tp_batch, tp_cfg
from torch_parallel_worker import ROOT, spawn
from variational_mmt_tpu.config import DecodeConfig as JaxDecodeConfig
from variational_mmt_tpu.data.vocab import SPECIALS as JAX_SPECIALS
from variational_mmt_tpu.data.vocab import Vocab as JaxVocab
from variational_mmt_tpu.decode.iw_eval import iw_elbo_corpus as jax_iw_elbo_corpus
from variational_mmt_tpu.decode.translator import Translator as JaxTranslator
from variational_mmt_tpu.models.model import build_model as jax_build_model
from variational_mmt_tpu.parallel.mesh import make_mesh as jax_make_mesh
from variational_mmt_tpu.parallel.tp import make_mesh_2d
from variational_mmt_tpu.train.checkpoint import load_checkpoint as jax_load_checkpoint
from variational_mmt_tpu.train.trainer import create_train_state as jax_create_train_state
from variational_mmt_torch.config import Config, DecodeConfig, ModelConfig, TrainConfig
from variational_mmt_torch.convert import flatten, params_from_jax
from variational_mmt_torch.data import synthetic
from variational_mmt_torch.data.vocab import SPECIALS, Vocab
from variational_mmt_torch.decode.translator import Translator
from variational_mmt_torch.models.model import build_model
from variational_mmt_torch.train import checkpoint as ck
from variational_mmt_torch.train.trainer import create_train_state, make_train_step

TIMEOUT_S = 120  # the 2 ranks of the module's cases, with their start-up
CLI_TIMEOUT_S = 120  # one torchrun launch of 2 ranks
DCFG = dict(beam_size=3, max_length=8, batch_size=4)


def decode_inputs():
    """tests/test_tp.py:232's model, vocab and 9 sources (an odd count:
    padding rows)."""
    jcfg = tp_cfg()
    tree = np_tree(jax_create_train_state(jcfg, jax_build_model(jcfg.model)).params)
    rng = np.random.default_rng(5)
    src = [list(map(int, rng.integers(4, V, rng.integers(3, 7)))) for _ in range(9)]
    img = rng.standard_normal((9, 16)).astype(np.float32)
    return jcfg, tree, src, img


def jax_decode(jcfg, tree, src, img, mesh, infer_dtype="float32"):
    vocab = JaxVocab(JAX_SPECIALS + [f"w{i}" for i in range(V - 4)])
    tr = JaxTranslator(jax_build_model(jcfg.model), tree, vocab, vocab,
                       JaxDecodeConfig(**DCFG, infer_dtype=infer_dtype), buckets=[8], mesh=mesh)
    return tr.translate_ids(src, img)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    jax_side, inp = {}, {}
    jcfg, tree, src, img = decode_inputs()
    inp["decode"] = {"cfg": cfg_dict(jcfg), "tree": tree, "dcfg": DCFG, "src": src, "img": img}
    for name, mesh in (("1x2", make_mesh_2d(1, 2)), ("2x1", jax_make_mesh(2))):
        for dt in ("float32", "int8"):
            jax_side[("decode", name, dt)] = jax_decode(jcfg, tree, src, img, mesh, dt)

    jmodel, iw_tree, _ = models(dict(model_type="vmmt_c"))
    batches = host_batches()
    rng = jax.random.PRNGKey(7)
    eps = [jax_eps(jax.random.fold_in(rng, i), 2, (b.batch_size, 4))
           for i, b in enumerate(batches)]
    jbatches = [{k: jnp.asarray(getattr(b, k)) for k in LAYOUT} for b in batches]
    jax_side["iw"] = jax_iw_elbo_corpus(jmodel, iw_tree, jbatches, 2, rng)
    inp["iw"] = {"cfg": {"model": dict(IW_TINY, model_type="vmmt_c")},
                 "tree": iw_tree, "k": 2, "eps": eps,
                 "batches": [{k: getattr(b, k) for k in LAYOUT} for b in batches]}

    jcfg = tp_cfg("nmt")
    batch = np_batch(tp_batch())
    jax_side["ckpt"] = jax_steps(jcfg, batch, jax_make_mesh(1), 2)
    ckdir = str(tmp_path_factory.mktemp("tp_ckpt"))
    inp["ckpt"] = {"cfg": cfg_dict(jcfg), "tree": jax_side["ckpt"][3], "batch": batch,
                   "dir": ckdir}

    jcfg = tp_cfg("vmmt_c")
    inp["dp2"] = {"cfg": cfg_dict(jcfg), "tree": tree, "batch": batch}
    ranks = spawn("decode", 2, str(tmp_path_factory.mktemp("tp_decode")), inp, TIMEOUT_S)
    return jax_side, inp, ranks


def assert_nbest(got, want, rtol=1e-4, atol=1e-4):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert [ids for _, ids in a] == [ids for _, ids in b], (a, b)
        np.testing.assert_allclose([s for s, _ in a], [s for s, _ in b], rtol=rtol, atol=atol)


@pytest.mark.parametrize("mesh", ["1x2", "2x1"])
def test_decode_matches_jax(run, mesh):
    """Beam decoding on TP-2 (vocab-parallel embeddings, logits gathered to
    the full V) and on DP-2 (rows split, n-best lists gathered) == JAX's
    Translator on its mesh, on every rank (tests/test_tp.py:232)."""
    jax_side, _, ranks = run
    for r in ranks:
        assert_nbest(r["case_decode"][(mesh, "float32")], jax_side[("decode", mesh, "float32")])


@pytest.mark.parametrize("mesh", ["1x2", "2x1"])
def test_int8_decode_matches_jax(run, mesh):
    """int8 composes with TP: quantized before sharding, codes sharded like
    the tensor and the generator's scale on the vocab (tests/test_tp.py:260)."""
    jax_side, inp, ranks = run
    want = jax_side[("decode", mesh, "int8")]
    for r in ranks:
        got = r["case_decode"][(mesh, "int8")]
        same = sum([i for _, i in a] == [i for _, i in b] for a, b in zip(got, want))
        assert same >= len(want) - 1, (got, want)
    H = inp["decode"]["cfg"]["model"]["hidden_dim"]
    assert ranks[0]["case_decode"]["int8_shapes"] == ((H, V // 2), (V // 2,))
    # TP-2 against the port's own single process at int8: a pure re-layout
    cfg = Config(model=ModelConfig(**inp["decode"]["cfg"]["model"]))
    model = build_model(cfg.model, device="cpu")
    model.load_state_dict(params_from_jax(inp["decode"]["tree"], cfg.model))
    vocab = Vocab(SPECIALS + [f"w{i}" for i in range(V - 4)])
    single = Translator(model, vocab, vocab, DecodeConfig(**DCFG, infer_dtype="int8"),
                        buckets=[8], device="cpu").translate_ids(inp["decode"]["src"],
                                                                 inp["decode"]["img"])
    for r in ranks:
        assert_nbest(r["case_decode"][(mesh, "int8")], single, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("mesh", ["1x2", "2x1"])
def test_iw_elbo_matches_jax(run, mesh):
    """The K-sample IW bound on TP-2 and DP-2 == JAX's, with JAX's noise
    (tests/test_tp.py:297)."""
    jax_side, _, ranks = run
    want = jax_side["iw"]
    for r in ranks:
        got = r["case_iw"][mesh]
        assert got["n_sents"] == want["n_sents"] == 11
        for k in ("iw_elbo_per_sent", "iw_text_per_sent", "iw_ppl"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)


def test_tp_checkpoint_roundtrip(run):
    """A TP-2 checkpoint holds the full gathered tensors: the port's single
    process and JAX read it, it equals the ranks' gathered parameters and,
    within JAX's tolerance, JAX's single-device run; DP-2 resumes it at
    another degree, reseeding each data rank's generator and saying so
    (tests/test_tp.py:313)."""
    jax_side, _, ranks = run
    got = ranks[0]["case_checkpoint"]
    state, cfg, model, _, _ = ck.load_checkpoint(got["path"], device="cpu")
    assert tuple(model.generator.kernel.shape) == (cfg.model.hidden_dim, V)
    loaded = {n: p.detach().numpy() for n, p in model.named_parameters()}
    jstate = jax_load_checkpoint(got["path"])[0]
    jloaded = flatten(np_tree(jstate.params))
    _, _, want, _ = jax_side["ckpt"]
    for name in want:
        np.testing.assert_array_equal(loaded[name], got["params"][name], err_msg=name)
        np.testing.assert_array_equal(jloaded[name], got["params"][name], err_msg=name)
        np.testing.assert_allclose(loaded[name], want[name], rtol=2e-3, atol=1e-4,
                                   err_msg=name)
    np.testing.assert_allclose(got["losses"], jax_side["ckpt"][0], rtol=1e-5)
    assert state.step == 2
    for r in ranks:
        res = r["case_checkpoint"]
        assert res["step"] == 2
        for name, p in res["resumed"].items():
            np.testing.assert_array_equal(p, got["params"][name], err_msg=name)
    assert "reseeded" in ranks[0]["case_checkpoint"]["said"]
    gens = [r["case_checkpoint"]["generator"] for r in ranks]
    assert not np.array_equal(gens[0], gens[1])  # one stream a data rank


def test_dp2_matches_the_single_process(run):
    """3 deterministic f32 steps of vmmt_c on DP-2 == the port's single
    process: the loss divided by the global sentence count, the gradients
    summed over the data group."""
    _, inp, ranks = run
    d = inp["dp2"]
    cfg = Config(model=ModelConfig(**d["cfg"]["model"]), train=TrainConfig(**d["cfg"]["train"]))
    model = build_model(cfg.model, device="cpu")
    model.load_state_dict(params_from_jax(d["tree"], cfg.model))
    state = create_train_state(cfg, model)
    step = make_train_step(cfg, deterministic=True, sample=False)
    batch = {k: (torch.tensor(v).long() if v.dtype.kind in "iu" else torch.tensor(v))
             for k, v in d["batch"].items()}
    want = []
    for _ in range(3):
        state, m = step(state, batch, state.generator)
        want.append(float(m["loss"].detach()))
    for r in ranks:
        np.testing.assert_allclose(r["case_dp2"]["losses"], want, rtol=1e-6)


def torchrun(args, workdir, timeout=CLI_TIMEOUT_S):
    """``torchrun --standalone --nproc_per_node 2 -m <args>`` on the CPU."""
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
           "2", "-m", *args]
    proc = subprocess.run(cmd, cwd=workdir, env=env, capture_output=True, text=True,
                          timeout=timeout)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    return proc.stdout


def test_train_and_translate_clis_under_torchrun(tmp_path):
    """``cli.train -num_shards 2`` on 2 ranks, with a validation (greedy
    BLEU and the IW bound across the ranks), writes a checkpoint that a
    single process reads; ``cli.translate -tensor_parallel 2`` on 2 ranks
    writes what the single process writes; rank 0 alone prints."""
    from variational_mmt_torch.cli import preprocess as cli_preprocess
    from variational_mmt_torch.cli import translate as cli_translate

    d = tmp_path
    src, tgt, feats, _, _ = synthetic.make_corpus(60, vocab_size=40, img_dim=16, seed=9,
                                                  max_len=8)
    for name, lines in [("train.src", src[:48]), ("train.tgt", tgt[:48]),
                        ("test.src", src[48:]), ("test.tgt", tgt[48:])]:
        with open(d / name, "w") as f:
            f.writelines(" ".join(line) + "\n" for line in lines)
    np.save(d / "train.feats.npy", feats[:48])
    np.save(d / "test.feats.npy", feats[48:])
    cli_preprocess.main(["-train_src", f"{d}/train.src", "-train_tgt", f"{d}/train.tgt",
                         "-valid_src", f"{d}/test.src", "-valid_tgt", f"{d}/test.tgt",
                         "-save_data", f"{d}/demo", "-bpe_merges", "30", "-pretokenized",
                         "-vocab_pad_multiple", "2"])
    small = ["-word_vec_size", "16", "-rnn_size", "32", "-enc_layers", "1", "-dec_layers",
             "1", "-z_latent_dim", "4", "-buckets", "16", "-compute_dtype", "float32",
             "-device", "cpu"]
    out = torchrun(["variational_mmt_torch.cli.train", "-data", f"{d}/demo", "-save_model",
                    f"{d}/run", "-model_type", "vmmt_c", "-train_img_feats",
                    f"{d}/train.feats.npy", "-valid_img_feats", f"{d}/test.feats.npy",
                    "-img_feat_dim", "16", "-batch_size", "8", "-max_steps", "2",
                    "-valid_every", "2", "-valid_bleu", "1", "-valid_iw", "2", "-num_shards",
                    "2", *small], str(d))
    assert out.count("training done") == 1 and "2 data x 1 model" in out
    assert out.count("validation greedy BLEU") == 1
    state, cfg, *_ = ck.load_checkpoint(ck.latest_checkpoint(f"{d}/run"), device="cpu")
    assert state.step == 2
    common = ["-model", f"{d}/run", "-src", f"{d}/test.src", "-img_feats",
              f"{d}/test.feats.npy", "-pretokenized", "-beam_size", "3", "-batch_size", "4",
              "-device", "cpu"]
    single = cli_translate.main(common + ["-output", f"{d}/single.txt"])
    out = torchrun(["variational_mmt_torch.cli.translate", *common, "-output", f"{d}/tp.txt",
                    "-tensor_parallel", "2"], str(d))
    assert out.count("translated 12 sentences") == 1
    with open(f"{d}/single.txt") as a, open(f"{d}/tp.txt") as b:
        assert a.read() == b.read()
    assert len(single["nbest"]) == 12
