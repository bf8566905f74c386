"""PyTorch port: the FLOP model (``variational_mmt_torch/utils/flops.py``)
equal to the JAX package's, as floats, on the shipped configs at
``bench.py``'s shapes (batch 256 and 32, bucket 32) and on the LSTM,
``input_feed=False``, nmt and image-less variants."""

import dataclasses
import pathlib

import pytest

from variational_mmt_tpu.config import Config as JaxConfig
from variational_mmt_tpu.utils import flops as jax_flops
from variational_mmt_torch.config import Config
from variational_mmt_torch.utils import flops

ROOT = pathlib.Path(__file__).resolve().parent.parent
CONFIGS = ("nmt_multi30k", "vmmt_f_multi30k", "vmmt_c_multi30k")
VARIANTS = {"shipped": {}, "lstm": dict(rnn_type="lstm"), "no_input_feed": dict(input_feed=False),
            "nmt": dict(model_type="nmt", img_feat_dim=0), "no_image": dict(img_feat_dim=0),
            "init+input": dict(z_cond="init+input"), "three_layers": dict(enc_layers=3,
                                                                           dec_layers=3)}


def configs(name: str, over: dict):
    port = Config.from_json((ROOT / "variational_mmt_torch" / "configs" / f"{name}.json")
                            .read_text()).model
    ref = JaxConfig.from_json((ROOT / "variational_mmt_tpu" / "configs" / f"{name}.json")
                              .read_text()).model
    return dataclasses.replace(port, **over), dataclasses.replace(ref, **over)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("B,L_src,L_tgt", [(256, 32, 32), (32, 32, 32), (64, 24, 25)])
def test_flops_equal_jax(name, variant, B, L_src, L_tgt):
    port, ref = configs(name, VARIANTS[variant])
    fwd = flops.forward_flops(port, B, L_src, L_tgt)
    assert fwd > 0
    assert fwd == jax_flops.forward_flops(ref, B, L_src, L_tgt)
    assert flops.train_step_flops(port, B, L_src, L_tgt) == \
        jax_flops.train_step_flops(ref, B, L_src, L_tgt) == 3.0 * fwd


def test_h100_peak():
    assert flops.H100_SXM_BF16_DENSE_PEAK == 989e12
    assert not hasattr(flops, "V5E_BF16_PEAK")
