"""Gradients of the port's `lm_loss` against `jax.value_and_grad` of the
reference for the mla_moe, hybrid_ssm, rwkv and encdec families
(deepseek-v3-671b with its MTP head, zamba2-7b, rwkv6-7b,
seamless-m4t-medium): `tests/test_torch_train_grads.py`'s checks and
tolerances (its docstring says how they were measured), split off so that
each file stays short on one worker. The remat check covers every
rematerialisation boundary the reference has: a layer of each stack, the
MoE body, a hybrid group and the Mamba tail, the encoder and decoder
bodies.
"""
import pytest

from test_torch_train_grads import cases_fixture, check_grads, check_remat

ARCHS = ("deepseek-v3-671b", "zamba2-7b", "rwkv6-7b", "seamless-m4t-medium")


@pytest.fixture(scope="module")
def cases():
    return cases_fixture()


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_grads_match_reference(cases, arch):
    check_grads(cases(arch), arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_changes_no_gradient(cases, arch):
    check_remat(cases(arch))
