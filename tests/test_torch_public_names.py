"""Public names of the reference and their counterparts, exact:
`models.ssd.P_or_none` over every rule set (the reference's
PartitionSpec read as a tuple; a `Rules` without a model axis included,
where the reference gives `P(None, None)`, not None),
`kernels.flash_attention.NEG_INF`, `parallel.sharding.SINGLE_POD_AXES`
and the layout modes' defaults (`models.layers.GQA_MODE` and
`XENT_MODE`, `models.moe.DISPATCH_MODE`, `models.rwkv.WKV_MODE`).
"""
import dataclasses
import importlib

import pytest

from repro.models import layers as ref_layers
from repro.models import moe as ref_moe
from repro.models import rwkv as ref_rwkv
from repro.models import ssd as ref_ssd
from repro.parallel import sharding as ref_shd
from repro_torch.models import layers, moe, rwkv, ssd
from repro_torch.parallel import sharding as shd

# The packages' `kernels.flash_attention` attribute is the function, which
# shadows the module of the same name.
ref_fa = importlib.import_module("repro.kernels.flash_attention")
fa = importlib.import_module("repro_torch.kernels.flash_attention")

RULE_SETS = ("NULL_RULES", "TRAIN_RULES", "PREFILL_RULES", "DECODE_RULES",
             "LONG_DECODE_RULES")


def _rules(module, name, no_model_axis):
    rules = getattr(module, name)
    if no_model_axis:
        rules = dataclasses.replace(rules, model_axis=None)
    return rules


# NULL_RULES is no dataclass: it has no model axis to drop.
@pytest.mark.parametrize("name,no_model_axis",
                         [(n, False) for n in RULE_SETS]
                         + [(n, True) for n in RULE_SETS[1:]])
def test_p_or_none_equals_the_reference(name, no_model_axis):
    want = ref_ssd.P_or_none(_rules(ref_shd, name, no_model_axis))
    got = ssd.P_or_none(_rules(shd, name, no_model_axis))
    assert got == (None if want is None else tuple(want))
    assert ssd.mamba_specs(_rules(shd, name, no_model_axis))["conv_w"] == got


@pytest.mark.parametrize("port,ref", [
    (fa.NEG_INF, ref_fa.NEG_INF),
    (shd.SINGLE_POD_AXES, ref_shd.SINGLE_POD_AXES),
    (layers.GQA_MODE, ref_layers.GQA_MODE),
    (layers.XENT_MODE, ref_layers.XENT_MODE),
    (moe.DISPATCH_MODE, ref_moe.DISPATCH_MODE),
    (rwkv.WKV_MODE, ref_rwkv.WKV_MODE)])
def test_constants_equal_the_reference(port, ref):
    assert port == ref and type(port) is type(ref)
