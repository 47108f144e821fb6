"""Cross-path correctness of the port's models, mirroring
`tests/test_model_correctness.py` with its tolerances: prefill + one
decode step against the full forward, the chunked recurrences against
their sequential forms, the MoE dispatches against a per-expert dense
reference and against each other, the MLA cache's rank compression, the
sliding-window mask. The port's own seeded weights (`device="cpu"`);
inputs from numpy seeds. Two checks pin what the port adds to make the
reference's numerics hold on a card: top-k order on ties, and the MoE
combine order (`repro.models.moe` on the same inputs, run op by op, equal
bit for bit).
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
from repro.models import moe as ref_moe
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import MoEConfig
from repro_torch.interop import _tensor, reference_leaf
from repro_torch.models import lm as lm_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import rwkv as rwkv_mod
from repro_torch.models import ssd as ssd_mod
from repro_torch.models.layers import attn_mask
from repro_torch.train.serve import _grow_cache

DECODE_ARCHS = ["qwen2.5-3b", "gemma3-4b", "deepseek-v3-671b", "olmoe-1b-7b",
                "zamba2-7b", "rwkv6-7b", "seamless-m4t-medium"]


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _bf16(a):
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)


def make_batch(cfg, b=2, s=16, seed=1):
    rng = np.random.default_rng(seed)
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab, size=(b, s)).astype(np.int32))}
    if cfg.family == "vlm":
        batch["embeds"] = torch.from_numpy(rng.standard_normal(
            (b, cfg.n_prefix_embeds, cfg.d_model)).astype(np.float32))
    if cfg.family == "encdec":
        batch["src_embeds"] = torch.from_numpy(
            rng.standard_normal((b, 8, cfg.d_model)).astype(np.float32))
    return batch


def _moe_cfg(capacity_factor, **kw):
    return dataclasses.replace(
        reduced(get_config("olmoe-1b-7b")),
        moe=MoEConfig(n_experts=4, top_k=2, d_expert=32,
                      capacity_factor=capacity_factor, **kw))


def _init(module, seed=0):
    """`module` with every submodule's parameters drawn as `init_params`
    draws them."""
    gen = _gen(seed)
    for mod in module.modules():
        if hasattr(mod, "reset_parameters"):
            mod.reset_parameters(gen)
    return module


def _moe(cfg, seed=0):
    return _init(moe_mod.MoE(cfg, "cpu"), seed)


#: Per family, random leaves with the reference's scale (std of its draw)
#: and constant leaves with their value, by `named_parameters` name.
INIT_SCALES = {
    "olmoe-1b-7b": {"layers.0.moe.wi": 128 ** -0.5,
                    "layers.0.moe.wo": 64 ** -0.5,
                    "layers.0.moe.router": 128 ** -0.5},
    "deepseek-v3-671b": {"mtp.proj": 128 ** -0.5,
                         "moe_layers.0.attn.wk_b": 32 ** -0.5,
                         "dense_layers.0.attn.wq_b": 48 ** -0.5,
                         "moe_layers.0.moe.shared.wo": 64 ** -0.5},
    "zamba2-7b": {"mamba_groups.0.m.conv_w": 0.2,
                  "mamba_tail.0.m.out_proj": 256 ** -0.5,
                  "shared_attn.attn.wq": 128 ** -0.5},
    "rwkv6-7b": {"layers.0.time.mu": 0.02, "layers.0.time.w_lora_b": 0.125,
                 "layers.0.channel.wv": 256 ** -0.5},
    "seamless-m4t-medium": {"adapter": 128 ** -0.5,
                            "dec_layers.0.cross_attn.wq": 128 ** -0.5,
                            "head.table": 0.02},
}
INIT_CONSTANTS = {"scale": 1.0, "conv_b": 0.0, "a_log": 0.0, "d_skip": 1.0,
                  "dt_bias": 0.0, "w_base": -1.0, "u": 0.0,
                  "route_bias": 0.0}


@pytest.mark.parametrize("arch", sorted(INIT_SCALES))
def test_init_params_follow_the_reference_layout_and_scales(arch):
    """The port's own seeded parameters of every new family: one per leaf
    of the reference's pytree (shape and dtype, from `jax.eval_shape`),
    the reference's constants, and its scales within 10 %."""
    rcfg = ref_reduced(ref_get_config(arch))
    cfg = reduced(get_config(arch))
    shapes = jax.eval_shape(lambda k: RM.init_params(k, rcfg),
                            jax.random.key(0))
    model = PM.init_params(cfg, _gen(3), device="cpu")
    assert sum(int(np.prod(v.shape)) for v in jax.tree.leaves(shapes)) \
        == sum(p.numel() for p in model.parameters())
    for name, p in model.named_parameters():
        path, index = reference_leaf(name, cfg)
        leaf = shapes
        for key in path:
            leaf = leaf[key]
        assert tuple(p.shape) == leaf.shape[len(index):], name
        assert str(p.dtype).split(".")[1] == leaf.dtype.name, name
        const = INIT_CONSTANTS.get(path[-1])
        if const is not None:
            assert torch.equal(p, torch.full_like(p, const)), name
    params = dict(model.named_parameters())
    for name, scale in INIT_SCALES[arch].items():
        std = float(params[name].float().std())
        assert abs(std / scale - 1) < 0.1, (name, std, scale)
    # the router keeps the bf16 draw in f32
    for name, p in params.items():
        if name.endswith("router"):
            assert p.dtype == torch.float32
            assert torch.equal(p, p.to(torch.bfloat16).float())
    again = PM.init_params(cfg, _gen(3), device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(),
                                                 again.parameters()))


@pytest.mark.parametrize("name", DECODE_ARCHS)
def test_decode_matches_forward(name):
    """Greedy equivalence: prefill on S-1 tokens + one decode step gives the
    full-sequence forward's last-position logits. MoE configs run with a
    large capacity factor: capacity dropping depends on the token count
    (dropped in a 32-token forward, never for one decode token), which is
    expected divergence, not a fault."""
    cfg = reduced(get_config(name))
    if cfg.moe is not None:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=16.0))
    model = PM.init_params(cfg, _gen(), device="cpu")
    b, s = 2, 16
    batch = make_batch(cfg, b, s)
    with torch.inference_mode():
        out_full = PM.forward(model, cfg, batch)
        ref = out_full["logits"][:, -1]
        prefix = dict(batch, tokens=batch["tokens"][:, :-1])
        _, cache = PM.prefill(model, cfg, prefix)
        cache = _grow_cache(cache, s)
        pos = out_full["n_prefix"] + s - 1
        logits_d, _ = PM.decode_step(model, cfg, batch["tokens"][:, -1:], pos,
                                     cache)
    np.testing.assert_allclose(logits_d.numpy(), ref.numpy(), rtol=2e-2,
                               atol=2e-2)


def test_wkv_chunked_matches_scan():
    b, t, h, k = 2, 64, 3, 8
    rng = np.random.default_rng(0)
    r, kk, v, wn = (torch.from_numpy(rng.standard_normal((b, t, h, k))
                                     .astype(np.float32)) for _ in range(4))
    w = torch.sigmoid(wn) * 0.5 + 0.45
    u = torch.full((h, k), 0.3)
    s0 = torch.zeros((b, h, k, k))
    o1, s1 = rwkv_mod._wkv_scan(r, kk, v, w, u, s0)
    o2, s2 = rwkv_mod._wkv_chunked(r, kk, v, w, u, s0, chunk=16)
    np.testing.assert_allclose(o1.numpy(), o2.numpy(), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(s1.numpy(), s2.numpy(), rtol=2e-4, atol=2e-4)
    with pytest.raises(ValueError, match="T % chunk"):
        rwkv_mod._wkv_chunked(r[:, :60], kk[:, :60], v[:, :60], w[:, :60], u,
                              s0, chunk=16)


def test_wkv_chunked_clamps_the_decay():
    """Below exp(-8) a token the chunked form clamps log w (the scan does
    not), so the two differ by design; one token always takes the scan."""
    cfg = reduced(get_config("rwkv6-7b"))
    p = _init(rwkv_mod.RWKVTime(cfg, "cpu"))
    with torch.no_grad():
        p.w_base.fill_(2.5)          # exp(-exp(2.5)) ~ 5e-6 < exp(-8)
    x = _bf16(np.random.default_rng(1).standard_normal((2, 64, cfg.d_model)))
    with torch.inference_mode():
        o_scan, (_, s_scan) = rwkv_mod.apply_rwkv_time(p, cfg, x)
        o_chunk, (_, s_chunk) = rwkv_mod.apply_rwkv_time(p, cfg, x,
                                                         wkv_mode="chunked")
        assert not torch.allclose(s_scan, s_chunk, rtol=1e-3, atol=1e-3)
        one = [rwkv_mod.apply_rwkv_time(p, cfg, x[:, :1], wkv_mode=m)
               for m in ("scan", "chunked")]
    assert torch.equal(one[0][0], one[1][0])
    with pytest.raises(ValueError, match="WKV mode"):
        rwkv_mod.apply_rwkv_time(p, cfg, x, wkv_mode="fast")


def _mamba_sequential_ref(p, cfg, x):
    """Token-by-token reference of the SSD recurrence via decode_mamba."""
    state = ssd_mod.init_mamba_state(cfg, x.shape[0], "cpu")
    outs = []
    for t in range(x.shape[1]):
        y, state = ssd_mod.decode_mamba(p, cfg, x[:, t:t + 1], state)
        outs.append(y)
    return torch.cat(outs, dim=1), state


def test_mamba_chunked_matches_sequential():
    cfg = reduced(get_config("zamba2-7b"))
    p = _init(ssd_mod.Mamba(cfg, "cpu"))
    b, s = 2, 16  # two chunks at reduced chunk=8
    x = _bf16(np.random.default_rng(1).standard_normal((b, s, cfg.d_model))
              * 0.3)
    with torch.inference_mode():
        y_chunked, st = ssd_mod.apply_mamba(p, cfg, x, return_state=True)
        y_seq, st_seq = _mamba_sequential_ref(p, cfg, x)
    np.testing.assert_allclose(y_chunked.float().numpy(),
                               y_seq.float().numpy(), rtol=5e-2, atol=5e-2)
    np.testing.assert_allclose(st["h"].numpy(), st_seq["h"].numpy(),
                               rtol=2e-2, atol=2e-2)
    # the carried conv window is the last d_conv - 1 raw rows
    assert torch.equal(st["conv"], st_seq["conv"])


def test_mamba_padding_keeps_the_final_state():
    """A length off the chunk multiple pads with decay-neutral steps
    (dt = -30): the state equals the sequential one at the true end."""
    cfg = reduced(get_config("zamba2-7b"))
    p = _init(ssd_mod.Mamba(cfg, "cpu"))
    x = _bf16(np.random.default_rng(2).standard_normal((2, 11, cfg.d_model))
              * 0.3)
    with torch.inference_mode():
        y, st = ssd_mod.apply_mamba(p, cfg, x, return_state=True)
        y_seq, st_seq = _mamba_sequential_ref(p, cfg, x)
    assert tuple(y.shape) == (2, 11, cfg.d_model)
    np.testing.assert_allclose(y.float().numpy(), y_seq.float().numpy(),
                               rtol=5e-2, atol=5e-2)
    np.testing.assert_allclose(st["h"].numpy(), st_seq["h"].numpy(),
                               rtol=2e-2, atol=2e-2)


def _moe_dense_reference(p, cfg, x):
    """Per-token loop over experts (no capacity): the ground truth when no
    assignment is dropped."""
    mo = cfg.moe
    b, s, d = x.shape
    xf = x.reshape(-1, d)
    w, ids, _ = moe_mod.route(p, cfg, xf.float())
    out = np.zeros((xf.shape[0], d), np.float32)
    xf32 = xf.float().numpy()
    for t in range(xf.shape[0]):
        for j in range(mo.top_k):
            e = int(ids[t, j])
            h = xf32[t] @ p.wi[e].float().numpy()
            g = xf32[t] @ p.wg[e].float().numpy()
            y = (h * (g / (1 + np.exp(-g)))) @ p.wo[e].float().numpy()
            out[t] += float(w[t, j]) * y
    return out.reshape(b, s, d)


def test_moe_dispatch_matches_dense_reference():
    cfg = _moe_cfg(8.0)  # high capacity: no drops
    p = _moe(cfg)
    x = _bf16(np.random.default_rng(1).standard_normal((2, 8, cfg.d_model))
              * 0.5)
    with torch.inference_mode():
        y, _ = moe_mod.apply_moe(p, cfg, x)
    np.testing.assert_allclose(y.float().numpy(),
                               _moe_dense_reference(p, cfg, x), rtol=3e-2,
                               atol=3e-2)


def test_moe_capacity_drops_tokens():
    cfg = _moe_cfg(0.25)
    p = _moe(cfg)
    x = _bf16(np.random.default_rng(1).standard_normal((2, 16, cfg.d_model)))
    with torch.inference_mode():
        y, _ = moe_mod.apply_moe(p, cfg, x)       # must not error or NaN
        y_all, _ = moe_mod.apply_moe(p, _moe_cfg(8.0), x)
    assert not bool(torch.isnan(y).any())
    # 64 assignments, capacity round_up(int(64 / 4 * 0.25), 8) = 8 an
    # expert: some tokens lose an expert, the others keep both
    lost = (y != y_all).any(-1)
    assert 0 < int(lost.sum()) < 32


def test_sliding_window_mask():
    q = torch.arange(8)[None, :]
    m = attn_mask(q, q, window=3)[0].numpy()
    assert m[5, 5] and m[5, 4] and m[5, 3]
    assert not m[5, 2]          # outside window
    assert not m[2, 5]          # acausal
    # a global layer of a windowed config ignores the window
    assert attn_mask(q, q, window=3, is_local=False)[0].numpy()[5, 0]


def test_gemma_swa_pattern():
    cfg = get_config("gemma3-4b")
    flags = np.asarray(lm_mod.swa_flags(cfg))
    assert flags.sum() == cfg.n_layers - cfg.n_layers // 6  # 5:1 local:global
    assert not flags[5] and flags[0] and flags[4]


def test_mla_cache_is_rank_compressed():
    cfg = reduced(get_config("deepseek-v3-671b"))
    cache = PM.init_cache(cfg, batch=2, max_len=32, device="cpu")
    # the latent cache holds kv_lora_rank + rope dims, not heads * head_dim
    assert cache["c"].shape[-1] == cfg.mla.kv_lora_rank
    assert cache["rope"].shape[-1] == cfg.mla.rope_head_dim
    full_kv = 2 * cfg.n_heads * cfg.mla.v_head_dim
    assert cache["c"].shape[-1] + cache["rope"].shape[-1] < full_kv


@pytest.mark.parametrize("groups", [1, 2, 4])
def test_moe_cumsum_dispatch_matches_sort(groups):
    """The sort-free dispatch equals the sort dispatch when capacity is not
    binding (top-2: the two adds commute)."""
    cfg = _moe_cfg(8.0)
    p = _moe(cfg)
    x = _bf16(np.random.default_rng(1).standard_normal((2, 8, cfg.d_model))
              * 0.5)
    with torch.inference_mode():
        y_sort, _ = moe_mod.apply_moe_dispatch(p, cfg, x)
        y_cs, _ = moe_mod.apply_moe_dispatch(p, cfg, x, groups=groups,
                                             mode="cumsum")
    assert torch.equal(y_sort, y_cs)
    with pytest.raises(ValueError, match="dispatch mode"):
        moe_mod.apply_moe_dispatch(p, cfg, x, mode="a2a")


def test_top_k_keeps_the_lower_index_on_ties():
    """`jax.lax.top_k`'s order, including sigmoid scores saturated to 1.0
    in f32."""
    rng = np.random.default_rng(3)
    x = rng.integers(0, 4, size=(64, 16)).astype(np.float32)
    x[:8] = 1.0                                  # all tied
    x[8:16, ::3] = np.float32(1 / (1 + np.exp(-np.float32(40.0))))  # 1.0
    want_v, want_i = jax.lax.top_k(jnp.asarray(x), 8)
    got_v, got_i = moe_mod.top_k(torch.from_numpy(x), 8)
    assert np.array_equal(got_i.numpy(), np.asarray(want_i))
    assert np.array_equal(got_v.numpy(), np.asarray(want_v))


@pytest.fixture
def exec_safe():
    prev = ref_layers._EXEC_SAFE
    ref_layers.set_exec_safe(True)
    yield
    ref_layers.set_exec_safe(prev)


@pytest.mark.parametrize("mode,groups,aux_free", [
    ("sort", 1, False), ("sort", 1, True), ("cumsum", 1, False),
    ("cumsum", 4, True)])
def test_moe_equals_the_reference_op_by_op(exec_safe, mode, groups,
                                           aux_free):
    """Top-8 of 16 experts with dropped assignments: the port's dispatch
    and combine (index writes, each token's outputs added in bf16 in the
    reference's scatter order) equal `repro.models.moe` run op by op, bit
    for bit."""
    mo = dict(n_experts=16, top_k=8, d_expert=32, capacity_factor=0.5)
    if aux_free:
        mo.update(aux_free_bias=True, route_scale=2.5, n_shared=1,
                  d_shared=32)
    cfg = dataclasses.replace(reduced(get_config("olmoe-1b-7b")),
                              moe=MoEConfig(**mo))
    p = _moe(cfg)
    with torch.no_grad():
        if aux_free:   # a bias that moves routing
            p.route_bias.copy_(torch.linspace(-0.05, 0.05, 16))
    params = {n: np.asarray(t.float().numpy()) for n, t in
              p.named_parameters()}
    ref_p = {"router": jnp.asarray(params["router"])}
    for n in ("wi", "wg", "wo"):
        ref_p[n] = jnp.asarray(params[n], jnp.bfloat16)
    if aux_free:
        ref_p["route_bias"] = jnp.asarray(params["route_bias"])
        ref_p["shared"] = {n: jnp.asarray(params[f"shared.{n}"],
                                          jnp.bfloat16)
                           for n in ("wi", "wg", "wo")}
    x = np.random.default_rng(4).standard_normal((2, 12, cfg.d_model)) * 0.5
    xj = jnp.asarray(x, jnp.bfloat16)
    with jax.disable_jit():
        want, want_aux = ref_moe.apply_moe_dispatch(ref_p, cfg, xj,
                                                    groups=groups, mode=mode)
    with torch.inference_mode():
        got, aux = moe_mod.apply_moe_dispatch(
            p, cfg, _tensor(np.asarray(xj), "cpu"), groups=groups, mode=mode)
    assert np.array_equal(got.float().numpy(), np.asarray(want, np.float32))
    assert float(aux) == pytest.approx(float(want_aux), rel=1e-6)
