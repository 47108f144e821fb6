"""The port's dense LM and serving path, held against `repro.models` and
`repro.train.serve`.

The reference's random parameters carry across bit for bit
(`interop.lm_params_from_reference`); both sides then run the same
prompts, made from numpy seeds, on the CPU: the reference jitted with
exec-safe (f32) products, as the serving tests run it, the port with
`device="cpu"`.

Tolerance of the logits: LOGIT_ATOL = 0.03 absolute on logits of magnitude
~1 (rtol 0). Both sides round every activation to bf16 (8 significant bits)
at the same places, but XLA fuses elementwise chains and keeps them in f32
where the op-by-op order rounds (excess precision), and the f32 sums run
in other orders; one bf16 ulp moved in the first layer then spreads through
the residual stream. The reference is not closer to itself: its jitted and
op-by-op runs of the same prefill differ by about 0.01 on these logits, and
the port is within that distance of either; the tolerance is three times
it. The caches are bf16 activations of the same kind: CACHE_ATOL = 0.1 on
values of magnitude up to ~4 (about six bf16 ulps there). Greedy tokens
must be equal wherever the reference's top-2 logit margin exceeds twice
LOGIT_ATOL (the sum of both sides' allowed error): each row compares
token by token, and a row may differ only at a step whose margin is
within that bound, after which its contexts differ and the row stops. The
photonic report is host float64 arithmetic on the same workload: equal
field for field.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models as RM
import repro_torch.models as PM
from repro.configs import ARCHS as REF_ARCHS
from repro.configs import get_config as ref_get_config
from repro.configs import reduced as ref_reduced
from repro.models import layers as ref_layers
from repro.train.serve import Request as RefRequest
from repro.train.serve import Server as RefServer
from repro.train.serve import _grow_cache as ref_grow_cache
from repro.train.serve import photonic_report as ref_photonic_report
from repro_torch.configs import get_config, list_archs, reduced
from repro_torch.interop import lm_params_from_reference
from repro_torch.train.serve import Request, Server, photonic_report

LOGIT_ATOL = 0.03
CACHE_ATOL = 0.1
ARCHS = ("qwen2.5-3b", "gemma3-4b", "granite-3-2b")


@pytest.fixture(autouse=True)
def exec_safe():
    prev = ref_layers._EXEC_SAFE
    ref_layers.set_exec_safe(True)
    yield
    ref_layers.set_exec_safe(prev)


@pytest.fixture(scope="module")
def models():
    """Per arch: (reference config, port config, reference params, port
    model), the port's weights carried across from the reference's."""
    out = {}
    for arch in ARCHS:
        rcfg = ref_reduced(ref_get_config(arch))
        pcfg = reduced(get_config(arch))
        params = RM.init_params(jax.random.key(0), rcfg)
        model = lm_params_from_reference(jax.tree.map(np.asarray, params),
                                         pcfg, "cpu")
        out[arch] = (rcfg, pcfg, params, model)
    return out


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _prompts(vocab, n=4, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, size=rng.integers(4, 12)).astype(np.int32)
            for _ in range(n)]


def test_configs_are_the_references():
    assert list_archs() == sorted(REF_ARCHS)
    for arch in list_archs():
        for c in (get_config(arch), reduced(get_config(arch))):
            ref = (ref_get_config(arch) if "reduced" not in c.name
                   else ref_reduced(ref_get_config(arch)))
            assert dataclasses.asdict(c) == dataclasses.asdict(ref)


@pytest.mark.parametrize("arch", ARCHS)
def test_interop_round_trip_is_bit_exact(models, arch):
    rcfg, pcfg, params, model = models[arch]
    flat = jax.tree_util.tree_leaves_with_path(params)
    n_ref = sum(int(np.prod(v.shape)) for _, v in flat)
    assert n_ref == sum(p.numel() for p in model.parameters())
    stack = params["layers"]
    for i, blk in enumerate(model.layers):
        for name in ("wq", "wk", "wv", "wo") + (("bq", "bk", "bv")
                                                if rcfg.qkv_bias else ()):
            want = np.asarray(stack["attn"][name][i])
            got = getattr(blk.attn, name)
            assert got.dtype == torch.bfloat16
            assert np.array_equal(got.view(torch.int16).numpy(),
                                  want.view(np.int16))
        for name in ("wi", "wg", "wo"):
            assert np.array_equal(getattr(blk.mlp, name).view(torch.int16)
                                  .numpy(),
                                  np.asarray(stack["mlp"][name][i])
                                  .view(np.int16))
    assert np.array_equal(model.embed.table.view(torch.int16).numpy(),
                          np.asarray(params["embed"]["table"]).view(np.int16))
    assert (model.head is None) == rcfg.tie_embeddings


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_teacher_forced_decode(models, arch):
    rcfg, pcfg, params, model = models[arch]
    max_len, steps = 24, 6
    toks = np.stack([np.pad(p, (10 - len(p), 0)) for p in
                     (np.arange(1, 11), np.arange(3, 10), np.arange(5, 15),
                      np.arange(20, 24))]).astype(np.int32)
    r_logits, r_cache = jax.jit(lambda p, b: RM.prefill(p, rcfg, b))(
        params, {"tokens": jnp.asarray(toks)})
    with torch.inference_mode():
        p_logits, p_cache = PM.prefill(model, pcfg,
                                       {"tokens": torch.from_numpy(toks)})
    assert p_logits.dtype == torch.float32
    np.testing.assert_allclose(_f32(p_logits), _f32(r_logits), rtol=0,
                               atol=LOGIT_ATOL)
    for key in ("k", "v"):
        assert p_cache[key].shape == r_cache[key].shape
        np.testing.assert_allclose(_f32(p_cache[key]), _f32(r_cache[key]),
                                   rtol=0, atol=CACHE_ATOL)

    from repro_torch.train.serve import _grow_cache
    r_cache = ref_grow_cache(r_cache, max_len)
    p_cache = _grow_cache(p_cache, max_len)
    decode = jax.jit(lambda p, t, pos, c: RM.decode_step(p, rcfg, t, pos, c))
    tok = jnp.argmax(r_logits, -1).astype(jnp.int32)[:, None]
    for j in range(steps):
        pos = toks.shape[1] + j
        r_logits, r_cache = decode(params, tok, jnp.int32(pos), r_cache)
        with torch.inference_mode():
            p_logits, p_cache = PM.decode_step(
                model, pcfg, torch.from_numpy(np.array(tok)), pos, p_cache)
        np.testing.assert_allclose(_f32(p_logits), _f32(r_logits), rtol=0,
                                   atol=LOGIT_ATOL, err_msg=f"step {j}")
        tok = jnp.argmax(r_logits, -1).astype(jnp.int32)[:, None]
    for key in ("k", "v"):
        np.testing.assert_allclose(_f32(p_cache[key]), _f32(r_cache[key]),
                                   rtol=0, atol=CACHE_ATOL)


class _TracingServer(RefServer):
    """The reference server, keeping each step's logits for the margin
    rule."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.steps = []
        prefill, decode = self._prefill, self._decode

        def keep_prefill(*args):
            out = prefill(*args)
            self.steps.append(np.asarray(out[0]))
            return out

        def keep_decode(*args):
            out = decode(*args)
            self.steps.append(np.asarray(out[0]))
            return out

        self._prefill, self._decode = keep_prefill, keep_decode


def _margin(logits):
    top2 = np.sort(logits, axis=-1)[:, -2:]
    return top2[:, 1] - top2[:, 0]


@pytest.mark.parametrize("arch", ARCHS)
def test_server_generate_greedy_tokens(models, arch):
    rcfg, pcfg, params, model = models[arch]
    prompts = _prompts(rcfg.vocab)
    max_new = 12
    ref_reqs = [RefRequest(prompt=p, max_new=max_new) for p in prompts]
    ref_srv = _TracingServer(rcfg, params, batch_size=4, max_len=32)
    ref_stats = ref_srv.generate(ref_reqs)
    reqs = [Request(prompt=p, max_new=max_new) for p in prompts]
    stats = Server(pcfg, model, batch_size=4, max_len=32,
                   device="cpu").generate(reqs)
    assert set(stats) == set(ref_stats) == {"ttft_s", "decode_s_per_tok",
                                            "tokens"}
    assert stats["tokens"] == ref_stats["tokens"] == 4 * max_new
    same = 0
    for i, (r, p) in enumerate(zip(ref_reqs, reqs)):
        assert len(p.out) == len(r.out) == max_new
        for j in range(max_new):
            if p.out[j] != r.out[j]:
                # a legitimate flip: the reference's top two were within
                # both sides' error; the contexts differ from here on
                assert _margin(ref_srv.steps[j])[i] <= 2 * LOGIT_ATOL, (i, j)
                break
            same += 1
    assert same >= 2 * max_new  # most of the tokens compare


def test_photonic_report_equals_the_reference():
    ref = ref_photonic_report(ref_get_config("qwen2.5-3b"), seq_len=64,
                              batch=4, new_tokens=12)
    got = photonic_report(get_config("qwen2.5-3b"), seq_len=64, batch=4,
                          new_tokens=12, device="cpu")
    assert got == ref


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "deepseek-v3-671b",
                                  "zamba2-7b", "rwkv6-7b",
                                  "seamless-m4t-medium"])
def test_other_families_raise(arch):
    cfg = reduced(get_config(arch))
    with pytest.raises(NotImplementedError, match="Queue 1 item 14"):
        PM.init_params(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="Queue 1 item 14"):
        PM.init_cache(cfg, 1, 8, device="cpu")


def test_init_params_follows_the_reference_scales():
    cfg = get_config("qwen2.5-3b")
    cfg = dataclasses.replace(cfg, n_layers=1, vocab=4096)
    gen = torch.Generator().manual_seed(3)
    model = PM.init_params(cfg, gen, device="cpu")
    blk = model.layers[0]
    assert all(p.dtype == torch.bfloat16 for p in model.parameters())
    assert tuple(blk.attn.wq.shape) == (2048, 16, 128)
    assert tuple(blk.attn.wk.shape) == (2048, 2, 128)
    assert float(blk.attn.bq.abs().max()) == 0.0
    assert float((blk.ln1.scale.float() - 1).abs().max()) == 0.0
    for p, scale in ((blk.attn.wq, 2048 ** -0.5), (blk.mlp.wo, 11008 ** -0.5),
                     (model.embed.table, 0.02), (model.head.table, 0.02)):
        assert abs(float(p.float().std()) / scale - 1) < 0.02
    again = PM.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    assert torch.equal(again.layers[0].mlp.wi, blk.mlp.wi)


def test_launcher_serves_a_reduced_config_on_the_cpu(capsys):
    from repro_torch.launch import serve as launch
    launch.main(["tokens", "--arch", "granite-3-2b", "--reduced",
                 "--device", "cpu", "--max-new", "3"])
    out = capsys.readouterr().out
    assert "12 tokens on cpu" in out and "granite-3-2b-decode64b4n3" in out
    # dse (ROADMAP Queue 1 item 11) and scenarios (item 12) are ported
    launch.main(["scenarios", "--model", "granite-3-2b", "--reduced",
                 "--device", "cpu", "--n-z", "3", "--kind", "decode",
                 "--repeat", "1"])
    out = capsys.readouterr().out
    assert "cuda engine on cpu" in out
    assert "2 scenarios (2 cold" in out and "granite-3-2b-reduced/" in out
