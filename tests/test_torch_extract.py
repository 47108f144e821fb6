"""The port's workload extraction (`repro_torch.core.extract.workload_for`)
against the reference's: the eight family goldens of
`tests/test_extract_golden.py` (the same tiny hand-sized configs, built in
each package), its two `_elec_ops` layer-scaling regressions, and every arch
of the zoo at its published config for train, prefill and decode.

Every scenario of a sweep stands on this extraction, so the workloads must
be the reference's field for field: name, GEMM list, electronic op count,
byte counts. Tolerance: exact (the fields' reprs are compared, so an int
that became a float fails too).
"""
import dataclasses

import pytest

import repro.configs as RC
from repro.configs import base as r_base
from repro.core import extract as r_extract
import repro_torch.configs as PC
from repro_torch.configs import base as p_base
from repro_torch.core import extract as p_extract

S, B = 4, 2           # prefill/train tokens x batch (as the goldens)
CTX, NT = 8, 3        # decode context x generated tokens
VOCAB = 10
KINDS = ("train", "prefill", "decode")


def _cfg(base, spec):
    """A ModelConfig of one package from a spec whose nested configs are
    given as (class name, kwargs)."""
    kw = {k: (getattr(base, v[0])(**v[1]) if isinstance(v, tuple) else v)
          for k, v in spec.items()}
    return base.ModelConfig(**kw)


def _fields(wl):
    return repr(dataclasses.asdict(wl))


def _check_family(spec):
    """Each kind's workload of the port equals the reference's (the
    reference's own goldens pin those numbers by hand)."""
    r_cfg, p_cfg = _cfg(r_base, spec), _cfg(p_base, spec)
    for kind in KINDS:
        seq = CTX if kind == "decode" else S
        r_wl = r_extract.workload_for(
            r_cfg, r_base.ShapeConfig("g", seq, B, kind, new_tokens=NT))
        p_wl = p_extract.workload_for(
            p_cfg, p_base.ShapeConfig("g", seq, B, kind, new_tokens=NT))
        assert _fields(p_wl) == _fields(r_wl), kind
        assert p_wl.total_macs == r_wl.total_macs > 0, kind
        assert p_wl.elec_ops == r_wl.elec_ops > 0, kind


DENSE = dict(name="g-dense", family="dense", n_layers=2, d_model=8,
             n_heads=2, n_kv_heads=1, d_ff=16, vocab=VOCAB)
RWKV = dict(name="g-rwkv", family="rwkv", n_layers=2, d_model=8, n_heads=2,
            d_ff=16, vocab=VOCAB)


def test_dense_family_golden():
    _check_family(DENSE)
    # the literal-number anchor of the reference's suite
    wl = p_extract.workload_for(_cfg(p_base, DENSE),
                                p_base.ShapeConfig("g", S, B, "prefill"))
    assert wl.total_macs == 10880 and wl.elec_ops == 1920


def test_swa_family_golden():
    _check_family(dict(DENSE, name="g-swa", sliding_window=2,
                       swa_pattern=2))


def test_moe_family_golden():
    _check_family(dict(
        name="g-moe", family="moe", n_layers=3, d_model=8, n_heads=2,
        n_kv_heads=2, d_ff=16, vocab=VOCAB,
        moe=("MoEConfig", dict(n_experts=4, top_k=2, d_expert=8, n_shared=1,
                               d_shared=8, first_dense_layers=1))))


def test_mla_moe_family_golden():
    _check_family(dict(
        name="g-mla", family="mla_moe", n_layers=3, d_model=8, n_heads=2,
        d_ff=16, vocab=VOCAB,
        mla=("MLAConfig", dict(q_lora_rank=6, kv_lora_rank=5,
                               rope_head_dim=2, nope_head_dim=4,
                               v_head_dim=4)),
        moe=("MoEConfig", dict(n_experts=4, top_k=2, d_expert=8,
                               first_dense_layers=1))))


def test_hybrid_ssm_family_golden():
    _check_family(dict(
        name="g-ssm", family="hybrid_ssm", n_layers=4, d_model=8,
        n_heads=2, n_kv_heads=2, d_ff=16, vocab=VOCAB,
        ssm=("SSMConfig", dict(d_state=4, d_conv=4, expand=2, head_dim=4,
                               chunk=2, attn_every=2))))


def test_rwkv_family_golden():
    _check_family(RWKV)


def test_encdec_family_golden():
    _check_family(dict(name="g-ed", family="encdec", n_layers=3,
                       enc_layers=2, dec_layers=1, d_model=8, n_heads=2,
                       n_kv_heads=2, d_ff=16, vocab=VOCAB))


def test_vlm_family_golden():
    _check_family(dict(name="g-vlm", family="vlm", n_layers=2, d_model=8,
                       n_heads=2, n_kv_heads=2, d_ff=16, vocab=VOCAB,
                       n_prefix_embeds=3))


@pytest.mark.parametrize("layers", [1, 3])
def test_elec_ops_rwkv_scales_with_layers_argument(layers):
    spec = dict(RWKV, n_layers=7)
    bt = B * S
    expected = (bt * 8 * 10 * layers + bt * 2 * 4 * 4 * 3 * layers
                + bt * 16)
    got = p_extract._elec_ops(_cfg(p_base, spec), S, bt, B, layers)
    assert got == expected == r_extract._elec_ops(_cfg(r_base, spec), S, bt,
                                                  B, layers)


@pytest.mark.parametrize("layers", [1, 3])
def test_elec_ops_hybrid_ssm_scales_with_layers_argument(layers):
    spec = dict(name="g-ssm7", family="hybrid_ssm", n_layers=7, d_model=8,
                d_ff=16, ssm=("SSMConfig", dict(d_state=4, expand=2,
                                                head_dim=4, chunk=2,
                                                attn_every=2)))
    bt, d_in, nh = B * S, 16, 4
    expected = (bt * 8 * 10 * layers
                + bt * nh * 4 * 4 // 2 * 3 * layers
                + bt * d_in * 2 * layers)
    got = p_extract._elec_ops(_cfg(p_base, spec), S, bt, B, layers)
    assert got == expected == r_extract._elec_ops(_cfg(r_base, spec), S, bt,
                                                  B, layers)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", sorted(RC.ARCHS))
def test_zoo_workloads_equal_the_references(arch, kind):
    """Every arch at its published config (seq 2048, batch 8, 16 new
    tokens): the configs are the reference's, and so is each workload."""
    r_cfg, p_cfg = RC.get_config(arch), PC.get_config(arch)
    assert repr(dataclasses.asdict(p_cfg)) == repr(dataclasses.asdict(r_cfg))
    r_wl = r_extract.workload_for(
        r_cfg, r_base.ShapeConfig("s", 2048, 8, kind, new_tokens=16))
    p_wl = p_extract.workload_for(
        p_cfg, p_base.ShapeConfig("s", 2048, 8, kind, new_tokens=16))
    assert _fields(p_wl) == _fields(r_wl)
    assert p_wl.gemm_array.tolist() == r_wl.gemm_array.tolist()
