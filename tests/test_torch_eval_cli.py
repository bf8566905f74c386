"""PyTorch port: the evaluation flags of the translate and train CLIs on
the CPU, against JAX's translate CLI on one checkpoint that both packages
read (tests/test_torch_cli.py's chain: JAX's preprocess, the port's train
CLI): ``-dump_attn`` writes equal .npz files (1e-5), ``-latent_diag``
prints the same line, ``-report_meteor`` the same METEOR; ``-iw_eval`` and
``-mbr_samples`` run and print lines of JAX's form (their draws differ:
threefry against the port's generator); a K=1 IW bound is a bound on the
text's log-likelihood. ``-valid_iw`` reports ``iw_elbo`` from the
``Trainer`` at each validation."""

import re

import numpy as np
import pytest

from test_torch_cli import corpus, trained, translate_args, vmmt_c  # noqa: F401
from variational_mmt_tpu.cli import translate as jax_translate
from variational_mmt_torch.cli import train as cli_train
from variational_mmt_torch.cli import translate as cli_translate

NUM = r"-?\d+\.\d+"


def run_both(d, ckpt, tmp_path, capsys, *flags):
    """Both CLIs with ``flags`` (FILE becomes a file of each's own); returns
    {package: (stdout lines, the port's returned report or None)}."""
    out = {}
    for name, main, extra in (("port", cli_translate.main, ["-device", "cpu"]),
                              ("jax", jax_translate.main, [])):
        args = [f"{tmp_path}/{name}.npz" if a == "FILE" else a for a in flags]
        capsys.readouterr()
        report = main(translate_args(d, ckpt, f"{tmp_path}/{name}.txt", *args, *extra))
        out[name] = (capsys.readouterr().out.splitlines(), report)
    return out


def lines_with(lines, prefix):
    return [line for line in lines if line.startswith(prefix)]


def test_dump_attn_writes_what_jax_writes(corpus, trained, tmp_path, capsys):
    out = run_both(str(corpus), trained, tmp_path, capsys, "-dump_attn", "FILE")
    mine, theirs = np.load(f"{tmp_path}/port.npz"), np.load(f"{tmp_path}/jax.npz")
    assert sorted(mine.files) == sorted(theirs.files) and len(mine.files) == 10
    for k in theirs.files:
        assert mine[k].shape == theirs[k].shape
        np.testing.assert_allclose(mine[k], theirs[k], rtol=0, atol=1e-5, err_msg=k)
        np.testing.assert_allclose(mine[k].sum(-1), 1.0, atol=1e-5)
    want = lines_with(out["jax"][0], "wrote attention matrices")
    assert lines_with(out["port"][0], "wrote attention matrices") == \
        [w.replace("jax.npz", "port.npz") for w in want] and len(want) == 1


def test_latent_diag_and_meteor_print_what_jax_prints(corpus, trained, tmp_path, capsys):
    out = run_both(str(corpus), trained, tmp_path, capsys, "-latent_diag", "-report_meteor")
    for prefix in ("LATENT DIAG:", "METEOR(original) =", "BLEU ="):
        got, want = lines_with(out["port"][0], prefix), lines_with(out["jax"][0], prefix)
        assert got == want and len(want) == 1, prefix
    report = out["port"][1]
    assert report["latent_diag"]["n_sents"] == 10 and "meteor" in report


def test_meteor_preset_and_tables_print_what_jax_prints(corpus, trained, tmp_path, capsys):
    syn = tmp_path / "syn.txt"
    syn.write_text("a\tthe\n")
    out = run_both(str(corpus), trained, tmp_path, capsys, "-report_meteor", "-meteor_preset",
                   "1.5-en", "-meteor_synonyms", str(syn), "-meteor_paraphrases", str(syn))
    got, want = (lines_with(out[k][0], "METEOR(1.5-en) =") for k in ("port", "jax"))
    assert got == want and len(want) == 1


def test_iw_eval_prints_a_line_of_jaxs_form(corpus, trained, tmp_path, capsys):
    form = re.compile(rf"^IW-ELBO \(K=3\): joint {NUM} / text {NUM} per sent; IW-ppl {NUM}$")
    out = run_both(str(corpus), trained, tmp_path, capsys, "-iw_eval", "3", "-seed", "4")
    for name in ("port", "jax"):
        assert len([line for line in out[name][0] if form.match(line)]) == 1, name
    iw = out["port"][1]["iw"]
    assert iw["n_sents"] == 10 and np.isfinite(iw["iw_elbo_per_sent"])
    assert iw["iw_ppl"] > 1.0 and out["port"][1]["iw_s"] > 0
    again = cli_translate.main(translate_args(str(corpus), trained, f"{tmp_path}/b.txt",
                                              "-iw_eval", "3", "-seed", "4", "-device", "cpu"))
    assert again["iw"] == iw  # the draws come from -seed


def test_eval_flags_without_targets_print_jaxs_notes(corpus, trained, tmp_path, capsys):
    d = str(corpus)
    for name, main, extra in (("port", cli_translate.main, ["-device", "cpu"]),
                              ("jax", jax_translate.main, [])):
        args = translate_args(d, trained, f"{tmp_path}/{name}.txt", "-iw_eval", "2",
                              "-latent_diag", *extra)
        i = args.index("-tgt")
        del args[i:i + 2]
        capsys.readouterr()
        main(args)
        notes = lines_with(capsys.readouterr().out.splitlines(), "note:")
        if name == "port":
            mine = notes
    assert mine == notes and len(notes) == 2


def test_mbr_samples_prints_a_line_of_jaxs_form(corpus, trained, tmp_path, capsys):
    form = re.compile(rf"^translated 10 sentences in {NUM}s \({NUM} sent/s, mbr 4 samples\)$")
    out = run_both(str(corpus), trained, tmp_path, capsys, "-mbr_samples", "4",
                   "-sampling_temp", "1.0", "-beam_size", "1", "-n_best", "1")
    for name in ("port", "jax"):
        assert len([line for line in out[name][0] if form.match(line)]) == 1, name
    with open(f"{tmp_path}/port.txt") as f:
        assert len(f.read().splitlines()) == 10
    with pytest.raises(SystemExit, match="-sampling_temp"):
        cli_translate.main(translate_args(str(corpus), trained, f"{tmp_path}/c.txt",
                                          "-mbr_samples", "4", "-device", "cpu"))


def test_valid_iw_reports_the_iw_bound_from_the_trainer(corpus, tmp_path, capsys):
    trainer = cli_train.main(vmmt_c(str(corpus), f"{tmp_path}/ck", "-max_steps", "2",
                                    "-valid_every", "2", "-checkpoint_every", "100",
                                    "-valid_iw", "2"))
    assert trainer.valid_iw == 2
    (val,) = trainer.history
    assert np.isfinite(val["iw_elbo"]) and val["iw_elbo"] < 0.0
    assert trainer.validate()["iw_elbo"] == val["iw_elbo"]  # the same draws each time
