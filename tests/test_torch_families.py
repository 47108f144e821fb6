"""The port's model families (moe, mla_moe, hybrid_ssm, rwkv, encdec) and
`forward`/`lm_loss` of every family, held against `repro.models` on the
CPU.

The reference's random parameters carry across bit for bit
(`interop.params_from_reference`); both sides then run the same inputs,
made from numpy seeds: the reference jitted with exec-safe (f32) products
and compiled with XLA's `xla_allow_excess_precision` off (`STRICT`), the
port with `device="cpu"`.

Why `STRICT`: with excess precision on (XLA's default), fusions keep bf16
chains in f32 where the op-by-op program rounds each op. On the MoE
families that moves a router input by a bf16 ulp and sends a token to
another expert, so the reference's default jitted run differs from its
own op-by-op run (`jax.disable_jit()`) by up to 1.35 on a reduced
olmoe-1b-7b block, where the port equals the op-by-op run exactly. With
excess precision off, XLA rounds every bf16 op as written, and the
compiled reference equals its op-by-op run.

Tolerances (`tests/test_torch_lm.py`'s, and why):
  * logits (and deepseek's `mtp_logits`): LOGIT_ATOL = 0.03 absolute.
    Both sides round at the same places; f32 sums run in other orders
    (XLA's and PyTorch's CPU products), so a bf16 rounding now and then
    lands on the other side (one ulp at one element of one layer of the
    reduced qwen2.5-3b), and the residual stream carries it on;
  * bf16 caches: CACHE_ATOL = 0.1 (about six bf16 ulps at the cache's
    largest values, ~4);
  * f32 recurrent states (`h`, `h_tail` of Mamba, `s` of RWKV): within
    STATE_TOL = 2^-5 of the reference state's largest magnitude, absolute.
    A state is an f32 sum of decayed outer products of bf16 activations
    (k v^T, dt B x^T); one bf16 rounding of an input landing on the other
    side moves a product by up to 2^-7 of the largest product, and the
    state's largest entry is at least that: the bound allows four such
    roundings. (A reduced rwkv6-7b shows one: equal to 1e-6 through two
    decode steps, then 0.128 at a state of largest magnitude 10.3.)
  * `lm_loss`: LOSS_ATOL = 2 * LOGIT_ATOL. Each position's loss is
    logsumexp - gold logit, each term within LOGIT_ATOL of the
    reference's; the mean keeps the bound (the MTP term, 0.3 of a loss of
    the same kind, and the MoE aux term, 0.01 of an equal routing's
    statistics, stay inside it at these sizes).
Greedy tokens follow `tests/test_torch_lm.py`'s margin rule. The interop
round trip is exact.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models as RM
import repro_torch.models as PM
from repro.configs import get_config as ref_get_config
from repro.configs import reduced as ref_reduced
from repro.models import layers as ref_layers
from repro.train.serve import Request as RefRequest
from repro.train.serve import Server as RefServer
from repro.train.serve import _grow_cache as ref_grow_cache
from repro_torch.configs import get_config, reduced
from repro_torch.interop import params_from_reference, reference_leaf
from repro_torch.train.serve import Request, Server, _grow_cache

LOGIT_ATOL = 0.03
CACHE_ATOL = 0.1
STATE_TOL = 2.0 ** -5
LOSS_ATOL = 2 * LOGIT_ATOL
STRICT = {"xla_allow_excess_precision": False}
FAMILIES = ("olmoe-1b-7b", "deepseek-v3-671b", "zamba2-7b", "rwkv6-7b",
            "seamless-m4t-medium")
DECODERS = FAMILIES[:4]
F32_STATES = ("h", "h_tail", "s")
SRC_LEN = 8
MAX_LEN = 32


@pytest.fixture(autouse=True)
def exec_safe():
    prev = ref_layers._EXEC_SAFE
    ref_layers.set_exec_safe(True)
    yield
    ref_layers.set_exec_safe(prev)


def _strict(fn):
    """`fn` jitted and compiled with STRICT, once per argument shapes."""
    compiled = {}

    def call(*args):
        key = tuple((tuple(a.shape), str(a.dtype))
                    for a in jax.tree.leaves(args))
        if key not in compiled:
            compiled[key] = jax.jit(fn).lower(*args).compile(STRICT)
        return compiled[key](*args)
    return call


@dataclasses.dataclass
class Pair:
    rcfg: object
    pcfg: object
    params: dict
    model: torch.nn.Module
    loss: object
    prefill: object
    decode: object


@pytest.fixture(scope="module")
def pairs():
    """Per arch, built on first use: the reference's reduced config and
    params, the port's model carrying them, and the reference's strict
    lm_loss, prefill and decode_step."""
    built = {}

    def get(arch):
        if arch not in built:
            rcfg = ref_reduced(ref_get_config(arch))
            pcfg = reduced(get_config(arch))
            # the init compiles at LLVM -O0 (twice as fast; its draws are
            # the weights both sides then share)
            key = jax.random.key(0)
            params = jax.jit(RM.init_params, static_argnums=1).lower(
                key, rcfg).compile({"xla_backend_optimization_level": 0})(key)
            model = params_from_reference(jax.tree.map(np.asarray, params),
                                          pcfg, "cpu")
            built[arch] = Pair(
                rcfg, pcfg, params, model,
                _strict(lambda p, b: RM.lm_loss(p, rcfg, b, remat=False)),
                _strict(lambda p, b: RM.prefill(p, rcfg, b)),
                _strict(lambda p, t, pos, c: RM.decode_step(p, rcfg, t, pos,
                                                            c)))
        return built[arch]
    return get


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _batches(cfg, toks, seed=1):
    """The same batch for both sides: tokens, plus the stub frontends'
    embeddings (vlm prefix, enc-dec source frames) from numpy."""
    rng = np.random.default_rng(seed)
    ref, port = {"tokens": jnp.asarray(toks)}, {"tokens":
                                                 torch.from_numpy(toks)}
    extra = {}
    if cfg.family == "vlm":
        extra["embeds"] = (toks.shape[0], cfg.n_prefix_embeds, cfg.d_model)
    if cfg.family == "encdec":
        extra["src_embeds"] = (toks.shape[0], SRC_LEN, cfg.d_model)
    for name, shape in extra.items():
        a = rng.standard_normal(shape).astype(np.float32)
        ref[name], port[name] = jnp.asarray(a), torch.from_numpy(a)
    return ref, port


def _prompts(vocab, n=4, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, size=rng.integers(4, 12)).astype(np.int32)
            for _ in range(n)]


def _prompt_batch(vocab):
    """The prompts left-padded into one batch, as `Server` pads them (the
    prefill, decode and server tests share the reference's compiled
    functions at these shapes)."""
    prompts = _prompts(vocab)
    plen = max(len(p) for p in prompts)
    return np.stack([np.pad(p, (plen - len(p), 0)) for p in prompts])


def _check_cache(port, ref):
    assert set(port) == set(ref)
    for key in ref:
        assert tuple(port[key].shape) == tuple(ref[key].shape), key
        assert port[key].dtype == (torch.float32 if key in F32_STATES
                                   else torch.bfloat16), key
        if key in F32_STATES:
            want = _f32(ref[key])
            np.testing.assert_allclose(_f32(port[key]), want, rtol=0,
                                       atol=STATE_TOL * np.abs(want).max(),
                                       err_msg=key)
        else:
            np.testing.assert_allclose(_f32(port[key]), _f32(ref[key]),
                                       rtol=0, atol=CACHE_ATOL, err_msg=key)


@pytest.mark.parametrize("arch", FAMILIES)
def test_interop_round_trip_is_bit_exact(pairs, arch):
    pr = pairs(arch)
    ref_leaves = jax.tree_util.tree_leaves(pr.params)
    assert sum(int(np.prod(v.shape)) for v in ref_leaves) \
        == sum(p.numel() for p in pr.model.parameters())
    for name, got in pr.model.named_parameters():
        path, index = reference_leaf(name, pr.pcfg)
        want = pr.params
        for key in path:
            want = want[key]
        want = np.asarray(want)[index]
        assert str(got.dtype).split(".")[1] == want.dtype.name, name
        bits = {2: (torch.int16, np.int16), 4: (torch.int32, np.int32)}
        t_int, n_int = bits[want.dtype.itemsize]
        assert np.array_equal(got.view(t_int).numpy(), want.view(n_int)), name
    # a leaf of another shape or dtype, or one no parameter takes, fails
    leaves = jax.tree.map(np.asarray, pr.params)
    leaves["final_norm"]["scale"] = leaves["final_norm"]["scale"].astype(
        np.float32)
    with pytest.raises(ValueError, match="does not fit"):
        params_from_reference(leaves, pr.pcfg, "cpu")
    leaves = jax.tree.map(np.asarray, pr.params)
    leaves["extra"] = {"scale": leaves["final_norm"]["scale"]}
    with pytest.raises(ValueError, match="extra/scale"):
        params_from_reference(leaves, pr.pcfg, "cpu")


def _forward(pr, seed=0):
    toks = np.random.default_rng(seed).integers(
        0, pr.rcfg.vocab, size=(2, 16)).astype(np.int32)
    ref_b, port_b = _batches(pr.pcfg, toks)
    r_loss, r_out = pr.loss(pr.params, ref_b)
    with torch.inference_mode():
        p_loss, p_out = PM.lm_loss(pr.model, pr.pcfg, port_b)
    return r_loss, r_out, p_loss, p_out


@pytest.mark.parametrize("arch", FAMILIES)
def test_forward_logits(pairs, arch):
    pr = pairs(arch)
    _, r_out, _, p_out = _forward(pr)
    assert set(p_out) == set(r_out)
    assert p_out["n_prefix"] == r_out["n_prefix"] == 0
    for key in ("logits", "mtp_logits"):
        if key in r_out:
            assert p_out[key].dtype == torch.float32
            assert tuple(p_out[key].shape) == tuple(r_out[key].shape)
            np.testing.assert_allclose(_f32(p_out[key]), _f32(r_out[key]),
                                       rtol=0, atol=LOGIT_ATOL, err_msg=key)
    assert ("mtp_logits" in p_out) == (arch == "deepseek-v3-671b")


@pytest.mark.parametrize("arch", FAMILIES)
def test_lm_loss(pairs, arch):
    pr = pairs(arch)
    r_loss, r_out, p_loss, p_out = _forward(pr)
    assert p_loss.dtype == torch.float32 and p_loss.ndim == 0
    assert abs(float(p_loss) - float(r_loss)) <= LOSS_ATOL
    # random weights: about log V a position (and 0.3 more for MTP)
    mtp = 1.3 if "mtp_logits" in p_out else 1.0
    assert abs(float(p_loss) - mtp * np.log(pr.rcfg.vocab)) < 1.0
    if pr.pcfg.moe is None:
        assert p_out["aux_moe"] == r_out["aux_moe"] == 0.0
    else:  # the same routing: the same load statistics
        np.testing.assert_allclose(float(p_out["aux_moe"]),
                                   float(r_out["aux_moe"]), rtol=1e-5)


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "gemma3-4b",
                                  "llava-next-34b"])
def test_dense_and_vlm_forward_and_lm_loss(pairs, arch):
    pr = pairs(arch)
    toks = np.random.default_rng(2).integers(
        0, pr.rcfg.vocab, size=(2, 16)).astype(np.int32)
    ref_b, port_b = _batches(pr.pcfg, toks)
    mask = (np.arange(15)[None] < np.array([[15], [9]])).astype(np.float32)
    ref_b["loss_mask"] = jnp.asarray(mask)
    port_b["loss_mask"] = torch.from_numpy(mask)
    r_loss, r_out = pr.loss(pr.params, ref_b)
    with torch.inference_mode():
        p_loss, p_out = PM.lm_loss(pr.model, pr.pcfg, port_b)
    npre = pr.pcfg.n_prefix_embeds if pr.pcfg.family == "vlm" else 0
    assert p_out["n_prefix"] == r_out["n_prefix"] == npre
    assert tuple(p_out["logits"].shape) == (2, npre + 16, pr.pcfg.vocab)
    np.testing.assert_allclose(_f32(p_out["logits"]), _f32(r_out["logits"]),
                               rtol=0, atol=LOGIT_ATOL)
    assert abs(float(p_loss) - float(r_loss)) <= LOSS_ATOL
    # the mask weighs positions: the unmasked loss is another number
    with torch.inference_mode():
        del port_b["loss_mask"]
        unmasked, _ = PM.lm_loss(pr.model, pr.pcfg, port_b)
    assert float(unmasked) != float(p_loss)


def _prefill(pr):
    toks = _prompt_batch(pr.rcfg.vocab)
    ref_b, port_b = _batches(pr.pcfg, toks)
    r_logits, r_cache = pr.prefill(pr.params, ref_b)
    with torch.inference_mode():
        p_logits, p_cache = PM.prefill(pr.model, pr.pcfg, port_b)
    return toks, r_logits, r_cache, p_logits, p_cache


@pytest.mark.parametrize("arch", FAMILIES)
def test_prefill_logits_and_cache(pairs, arch):
    pr = pairs(arch)
    toks, r_logits, r_cache, p_logits, p_cache = _prefill(pr)
    assert p_logits.dtype == torch.float32
    np.testing.assert_allclose(_f32(p_logits), _f32(r_logits), rtol=0,
                               atol=LOGIT_ATOL)
    _check_cache(p_cache, r_cache)
    # every key has the layout init_cache gives at the prompt's length
    empty = PM.init_cache(pr.pcfg, toks.shape[0], toks.shape[1],
                          src_len=SRC_LEN, device="cpu")
    ref_empty = RM.init_cache(pr.rcfg, toks.shape[0], toks.shape[1],
                              **({"src_len": SRC_LEN}
                                 if arch == "seamless-m4t-medium" else {}))
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[1])
            for k, v in empty.items()} \
        == {k: (tuple(v.shape), v.dtype.name) for k, v in ref_empty.items()} \
        == {k: (tuple(v.shape), str(v.dtype).split(".")[1])
            for k, v in p_cache.items()}


@pytest.mark.parametrize("arch", FAMILIES)
def test_teacher_forced_decode(pairs, arch):
    pr = pairs(arch)
    toks, r_logits, r_cache, _, p_cache = _prefill(pr)
    max_len = MAX_LEN
    r_cache = ref_grow_cache(r_cache, max_len)
    p_cache = _grow_cache(p_cache, max_len)
    tok = jnp.argmax(r_logits, -1).astype(jnp.int32)[:, None]
    for j in range(4):
        pos = toks.shape[1] + j
        r_logits, r_cache = pr.decode(pr.params, tok, jnp.int32(pos),
                                      r_cache)
        with torch.inference_mode():
            p_logits, p_cache = PM.decode_step(
                pr.model, pr.pcfg, torch.from_numpy(np.array(tok)), pos,
                p_cache)
        np.testing.assert_allclose(_f32(p_logits), _f32(r_logits), rtol=0,
                                   atol=LOGIT_ATOL, err_msg=f"step {j}")
        tok = jnp.argmax(r_logits, -1).astype(jnp.int32)[:, None]
    _check_cache(p_cache, r_cache)


class _TracingServer(RefServer):
    """The reference server on the strict reference, keeping each step's
    logits for the margin rule."""

    def __init__(self, pr, *a, **kw):
        super().__init__(pr.rcfg, pr.params, *a, **kw)
        self.steps = []

        def keep(fn):
            def call(*args):
                out = fn(*args)
                self.steps.append(np.asarray(out[0]))
                return out
            return call

        self._prefill, self._decode = keep(pr.prefill), keep(pr.decode)


def _margin(logits):
    top2 = np.sort(logits, axis=-1)[:, -2:]
    return top2[:, 1] - top2[:, 0]


@pytest.mark.parametrize("arch", DECODERS)
def test_server_generate_greedy_tokens(pairs, arch):
    pr = pairs(arch)
    prompts = _prompts(pr.rcfg.vocab)
    max_new = 12
    ref_reqs = [RefRequest(prompt=p, max_new=max_new) for p in prompts]
    ref_srv = _TracingServer(pr, batch_size=4, max_len=MAX_LEN)
    ref_srv.generate(ref_reqs)
    reqs = [Request(prompt=p, max_new=max_new) for p in prompts]
    stats = Server(pr.pcfg, pr.model, batch_size=4, max_len=MAX_LEN,
                   device="cpu").generate(reqs)
    assert stats["tokens"] == 4 * max_new
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


def test_server_fails_on_encdec_as_the_reference_does(pairs):
    # Server sends tokens only; encdec.prefill needs src_embeds
    pr = pairs("seamless-m4t-medium")
    prompts = _prompts(pr.rcfg.vocab, n=2)
    with pytest.raises(KeyError, match="src_embeds"):
        RefServer(pr.rcfg, pr.params, 2, 16).generate(
            [RefRequest(prompt=p, max_new=2) for p in prompts])
    with pytest.raises(KeyError, match="src_embeds"):
        Server(pr.pcfg, pr.model, 2, 16, device="cpu").generate(
            [Request(prompt=p, max_new=2) for p in prompts])


@pytest.mark.parametrize("arch", DECODERS)
def test_launcher_serves_each_family_on_the_cpu(capsys, arch):
    from repro_torch.launch import serve as launch
    launch.main(["tokens", "--arch", arch, "--reduced", "--device", "cpu",
                 "--max-new", "3"])
    out = capsys.readouterr().out
    assert "12 tokens on cpu" in out and f"{arch}-decode64b4n3" in out
