"""`examples/serve_photonic_torch.py`, held against the reference.

The example runs in process with `--device cpu --photonic`, and its
photonic LM head (`photonic_head`) and `photonic_report` are compared with
the reference's calls of `examples/serve_photonic.py:51-69`.

The two packages cannot draw the same random numbers (`jax.random` against
torch generators), so the head is handed the same operands: the
reference's embedding table of the reduced qwen2.5-3b
(`repro.models.init_params(jax.random.key(0), cfg)`, carried across by
`interop.params_from_reference`) and a float32 `x` from a numpy seed.

Tolerances:
  * the noise-free head: bit for bit (the DDot path is exact);
  * the float32 product `x @ table.T` it is measured against, and so the
    rel_err: within `F32_RTOL` (a float32 GEMM of length 256; torch and
    XLA sum in different orders);
  * `photonic_report`: the reference's dict exactly (float64);
  * the noisy head (noise_rms 0.02): its shot-noise draws differ, so its
    rel_err is held to `NOISE_BAND` instead, below.
"""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models as RM
from repro.configs import get_config as ref_get_config
from repro.configs import reduced as ref_reduced
from repro.kernels.ops import photonic_matmul as ref_photonic_matmul
from repro.train.serve import photonic_report as ref_photonic_report
import repro_torch.models as M
from repro_torch.configs import get_config, reduced
from repro_torch.interop import params_from_reference

ROOT = Path(__file__).resolve().parents[1]
ARCH = "qwen2.5-3b"
KEYS = range(8)
NOISE = 0.02

#: The noisy head's rel_err over the noise-free head's on the same operands
#: (noise_rms 0.02). The reference's keys 0-7 give 0.99919..1.00150 on this
#: file's operands (`test_noise_band_is_set_from_the_references_keys`
#: recomputes them); the band widens that range by its width on each side.
#: `chip_smoke.py` holds the card's head to the same band.
NOISE_BAND = (0.9968, 1.0039)
F32_RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this file runs (restored after it); every
    result here is exact or held to a band either way."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def example():
    """`examples/serve_photonic_torch.py`, loaded by path."""
    spec = importlib.util.spec_from_file_location(
        "serve_photonic_torch", ROOT / "examples" / "serve_photonic_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def served(example):
    """The example's own run on the CPU, defaults plus --photonic."""
    return example.main(["--photonic", "--device", "cpu"])


@pytest.fixture(scope="module")
def operands():
    """The reference's table (jax) and the port's copy of it (torch), and
    one seeded x as both."""
    cfg = ref_reduced(ref_get_config(ARCH))
    params = RM.init_params(jax.random.key(0), cfg)  # serve_photonic.py:38
    table = params["embed"]["table"]
    port = params_from_reference(params, reduced(get_config(ARCH)),
                                 device="cpu")
    x = np.random.default_rng(1).normal(
        size=(4, cfg.d_model)).astype(np.float32)
    return table, port.embed.table, x


@pytest.fixture(scope="module")
def reference_rel_errs(operands):
    """serve_photonic.py:56-60 on these operands: rel_err of the noise-free
    head and of the noisy head at each key."""
    table, _, x = operands
    tt = table.T.astype(jnp.float32)
    exact = jnp.asarray(x) @ np.asarray(table.T, np.float32)

    def rel(q):
        return float(jnp.linalg.norm(q - exact) / jnp.linalg.norm(exact))
    clean = rel(ref_photonic_matmul(jnp.asarray(x), tt, 0.0, True, 7))
    return clean, [rel(ref_photonic_matmul(jnp.asarray(x), tt, NOISE, True,
                                           k)) for k in KEYS]


def test_it_serves_the_references_requests(served):
    # serve_photonic.py:41-45: 4 requests of 12 new tokens
    assert served["stats"]["tokens"] == 48
    assert len(served["tokens"]) == 12
    vocab = reduced(get_config(ARCH)).vocab
    assert all(0 <= t < vocab for t in served["tokens"])
    assert served["stats"]["ttft_s"] > 0 and \
        served["stats"]["decode_s_per_tok"] > 0


def test_noise_free_head_equals_the_reference_bit_for_bit(example, operands):
    table, port_table, x = operands
    want = ref_photonic_matmul(jnp.asarray(x), table.T.astype(jnp.float32),
                               0.0, True, 7)
    got_q, got_f, _ = example.photonic_head(torch.from_numpy(x), port_table,
                                            0.0, 7, "cpu")
    assert got_q.dtype == torch.float32
    assert np.array_equal(got_q.numpy(), np.asarray(want))
    want_f = np.asarray(jnp.asarray(x) @ np.asarray(table.T, np.float32))
    assert np.allclose(got_f.numpy(), want_f, rtol=F32_RTOL, atol=F32_RTOL)


def test_noise_band_is_set_from_the_references_keys(reference_rel_errs):
    clean, noisy = reference_rel_errs
    ratios = [r / clean for r in noisy]
    width = max(ratios) - min(ratios)
    assert NOISE_BAND[0] <= min(ratios) - width
    assert max(ratios) + width <= NOISE_BAND[1]
    # no wider than that, up to the rounding of its ends
    assert NOISE_BAND[1] - NOISE_BAND[0] <= 3 * width + 2e-4


@pytest.mark.parametrize("key", KEYS)
def test_noisy_head_lies_in_the_band(example, operands, reference_rel_errs,
                                     key):
    _, port_table, x = operands
    clean, noisy = reference_rel_errs
    _, _, port_clean = example.photonic_head(torch.from_numpy(x), port_table,
                                             0.0, key, "cpu")
    _, _, err = example.photonic_head(torch.from_numpy(x), port_table, NOISE,
                                      key, "cpu")
    assert port_clean == pytest.approx(clean, rel=F32_RTOL)
    assert NOISE_BAND[0] <= err / clean <= NOISE_BAND[1]
    # and so within the reference's range widened by its own width
    width = max(noisy) - min(noisy)
    assert min(noisy) - width <= err <= max(noisy) + width


def test_the_examples_head_lies_in_the_band(example, served):
    """The example's own draw (its x and weights, key 7) against the
    noise-free head of the same operands."""
    cfg = reduced(get_config(ARCH))
    params = M.init_params(cfg, device="cpu")
    gen = torch.Generator().manual_seed(1)
    x = torch.randn((4, cfg.d_model), generator=gen)
    _, _, clean = example.photonic_head(x, params.embed.table, 0.0, 7, "cpu")
    assert NOISE_BAND[0] <= served["rel_err"] / clean <= NOISE_BAND[1]


def test_photonic_report_equals_the_references(served):
    # serve_photonic.py:66-67, on the full config
    want = ref_photonic_report(ref_get_config(ARCH), seq_len=64, batch=4,
                               new_tokens=12)
    assert served["report"] == want

