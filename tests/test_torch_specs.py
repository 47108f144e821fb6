"""The port's sharding rules and spec trees against the reference's, exact.

Every `Rules` property of the four rule sets (after `for_mesh` on both
production meshes), `rules_for` for every arch x shape x mesh,
`param_specs` / `cache_specs` / `batch_specs` leaf for leaf, and each
cell's per-device argument bytes (the arithmetic on the reference's specs,
sanitized as its `_sds` sanitizes them) equal the reference's. Specs
compare as tuples, a one-axis tuple entry read as the axis name (the
reference's PartitionSpec normalizes it so, and an empty one as None). No
tolerance applies: every
check is exact.

The reference's `launch.dryrun` sets XLA_FLAGS at import; the variable is
restored at once, before any JAX backend starts.
"""
import math
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models as RM
from repro.configs import get_config as ref_get_config
from repro.parallel import sharding as ref_shd
from repro.parallel import specs as ref_specs
from repro_torch.configs import SHAPES_BY_NAME, get_config, list_archs
from repro_torch.interop import reference_leaf
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import destroy_fake_world, make_production_mesh
from repro_torch.models import moe, rwkv
from repro_torch.parallel import sharding as shd
from repro_torch.parallel import specs as port_specs

_saved = os.environ.get("XLA_FLAGS")
import repro.launch.dryrun as ref_dryrun  # noqa: E402  (sets XLA_FLAGS)
if _saved is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _saved

MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}
RULE_SETS = ("TRAIN_RULES", "PREFILL_RULES", "DECODE_RULES",
             "LONG_DECODE_RULES")
FIELDS = ("data_axes", "model_axis", "fsdp", "seq_parallel", "seq_shard_kv",
          "batch_over_model", "all_axes", "expert_axes", "moe_groups",
          "context_parallel")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def meshes():
    yield {k: make_production_mesh(multi_pod=k == "multi", device_type="cpu")
           for k in MESHES}
    destroy_fake_world()


def _ref_mesh(kind):
    shape, names = MESHES[kind]
    return types.SimpleNamespace(axis_names=names, devices=np.empty(shape))


def _norm(spec):
    """A spec as a tuple of entries, a one-axis tuple entry as the name and
    an empty one as None (as PartitionSpec normalizes them)."""
    if spec is None:
        return None
    return tuple(None if e == () else
                 e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in tuple(spec))


def _props(cls):
    return sorted(n for n, v in vars(cls).items() if isinstance(v, property))


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("name", RULE_SETS)
def test_rule_sets_equal_the_reference(meshes, name, mesh):
    ref = ref_shd.for_mesh(getattr(ref_shd, name), _ref_mesh(mesh))
    port = shd.for_mesh(getattr(shd, name), meshes[mesh])
    assert _props(type(port)) == _props(type(ref))
    for prop in _props(type(ref)):
        want, got = getattr(ref, prop), getattr(port, prop)
        if prop == "ep_axes":
            assert tuple(want) == got, prop
        else:
            assert _norm(want) == _norm(got), prop
    for f in FIELDS:
        assert getattr(ref, f) == getattr(port, f), f
    assert _norm(ref.batch) == _norm(port.batch)
    assert shd.NULL_RULES.resid is None and shd.NULL_RULES.fsdp is False


def _specs_by_rules(meshes, mesh, arch):
    out = []
    for s in SHAPES_BY_NAME.values():
        ref = ref_dryrun.rules_for(ref_get_config(arch), s, _ref_mesh(mesh))
        port = D.rules_for(get_config(arch), s, meshes[mesh])
        out.append((s, ref, port))
    return out


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", list_archs())
def test_rules_for_equals_the_reference(meshes, arch, mesh):
    for s, ref, port in _specs_by_rules(meshes, mesh, arch):
        for f in FIELDS:
            assert getattr(ref, f) == getattr(port, f), (s.name, f)
    assert (moe.DISPATCH_MODE, rwkv.WKV_MODE) == ("sort", "scan")


_REF_PARAMS = {}


def _ref_param_shapes(arch):
    if arch not in _REF_PARAMS:
        cfg = ref_get_config(arch)
        _REF_PARAMS[arch] = jax.eval_shape(
            lambda: RM.init_params(jax.random.key(0), cfg))
    return _REF_PARAMS[arch]


def _lookup(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _is_spec(x):
    return x is None or isinstance(x, jax.sharding.PartitionSpec)


@pytest.mark.parametrize("arch", list_archs())
def test_param_cache_batch_specs_equal_the_reference(meshes, arch):
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    pshapes = _ref_param_shapes(arch)
    model = D._meta_model(cfg)
    names = [n for n, _ in model.named_parameters()]
    for mesh in sorted(MESHES):
        for s, ref, port in _specs_by_rules(meshes, mesh, arch):
            rtree = ref_specs.param_specs(rcfg, ref, params_tree=pshapes)
            got = port_specs.param_specs(cfg, port, model)
            assert sorted(got) == sorted(names)
            leaves = {}
            for n in names:
                path, index = reference_leaf(n, cfg)
                want = _lookup(rtree, path)
                assert _norm(want)[len(index):] == _norm(got[n]), (s.name, n)
                leaves["/".join(path)] = 1
            n_ref = len(jax.tree.leaves(rtree, is_leaf=_is_spec))
            assert len(leaves) == n_ref
            rc = ref_specs.cache_specs(rcfg, ref)
            pc = port_specs.cache_specs(cfg, port)
            assert sorted(rc) == sorted(pc)
            assert all(_norm(rc[k]) == _norm(pc[k]) for k in rc), s.name
            rb = ref_specs.batch_specs(rcfg, ref)
            pb = port_specs.batch_specs(cfg, port)
            assert {k: _norm(v) for k, v in rb.items()} == \
                {k: _norm(v) for k, v in pb.items()}


def test_a_missing_spec_raises_the_references_error(meshes):
    cfg = get_config("qwen2.5-3b")
    model = D._meta_model(cfg)
    model.layers[0].attn.extra = torch.nn.Parameter(
        torch.empty(2, device="meta"), requires_grad=False)
    with pytest.raises(KeyError, match="no spec for param 'extra'"):
        port_specs.param_specs(cfg, shd.TRAIN_RULES, model)


def _local_bytes(shape, dtype, spec, sizes):
    spec = ref_shd.sanitize_spec(shape, spec if spec is not None
                                 else jax.sharding.PartitionSpec(), sizes)
    n = 1
    for dim, e in zip(shape, tuple(spec) + (None,) * len(shape)):
        axes = () if e is None else ((e,) if isinstance(e, str) else e)
        n *= dim // math.prod(sizes[a] for a in axes)
    return n * np.dtype(dtype).itemsize


def _ref_argument_bytes(arch, shape, mesh):
    """The reference cell's per-device argument bytes: its `build_cell`'s
    inputs, each laid out as `_sds` lays it out, summed."""
    P = jax.sharding.PartitionSpec
    cfg = ref_get_config(arch)
    m = _ref_mesh(mesh)
    sizes = dict(zip(m.axis_names, m.devices.shape))
    rules = ref_dryrun.rules_for(cfg, shape, m)
    pshapes = _ref_param_shapes(arch)
    pspecs = ref_specs.param_specs(cfg, rules, params_tree=pshapes)

    def tree_bytes(shapes, specs, dtype=None):
        return sum(_local_bytes(s.shape, dtype or s.dtype, sp, sizes)
                   for s, sp in zip(jax.tree.leaves(shapes),
                                    jax.tree.leaves(specs, is_leaf=_is_spec)))

    total = tree_bytes(pshapes, pspecs)
    b, sl = shape.global_batch, shape.seq_len
    bspec = ref_specs.batch_specs(cfg, rules)
    if shape.kind == "train":
        mdt = jnp.bfloat16 if cfg.param_count() > 1e11 else jnp.float32
        total += 2 * tree_bytes(pshapes, pspecs, mdt) + 4     # mu, nu, step
    if shape.kind == "decode":
        total += _local_bytes((b, 1), jnp.int32, P(rules._d(), None), sizes)
        cshapes = jax.eval_shape(lambda: RM.init_cache(
            cfg, b, sl, src_len=sl // 2))
        cspecs = ref_specs.cache_specs(cfg, rules)
        total += sum(_local_bytes(cshapes[k].shape, cshapes[k].dtype,
                                  cspecs[k], sizes) for k in cshapes)
        return total + 4                                      # pos
    n_text = sl
    if cfg.family == "vlm":
        n_text = sl - cfg.n_prefix_embeds
        total += _local_bytes((b, cfg.n_prefix_embeds, cfg.d_model),
                              jnp.float32, bspec["embeds"], sizes)
    if cfg.family == "encdec":
        n_text = sl // 2
        total += _local_bytes((b, sl - n_text, cfg.d_model), jnp.float32,
                              bspec["src_embeds"], sizes)
    return total + _local_bytes((b, n_text), jnp.int32, bspec["tokens"],
                                sizes)


@pytest.mark.parametrize("arch", list_archs())
def test_argument_bytes_equal_the_reference_in_every_cell(meshes, arch):
    cfg = get_config(arch)
    for mesh in sorted(MESHES):
        for s in SHAPES_BY_NAME.values():
            _, args, _ = D.build_cell(cfg, s, meshes[mesh])
            got = D.argument_bytes(args, s)
            assert got == _ref_argument_bytes(arch, s, mesh), (s.name, mesh)


def _spec_of(placements, mesh, ndim):
    """The spec of Shard/Replicate placements on `mesh` (the inverse of
    `placements`), a one-axis entry as the axis name."""
    out = [[] for _ in range(ndim)]
    for name, p in zip(mesh.mesh_dim_names, placements):
        if p.is_shard():
            out[p.dim].append(name)
    return tuple(None if not a else (a[0] if len(a) == 1 else tuple(a))
                 for a in out)


def test_placements_round_trip_every_rule_spec(meshes):
    seen = 0
    for mesh in sorted(MESHES):
        m = meshes[mesh]
        for arch in list_archs():
            for s in SHAPES_BY_NAME.values():
                rules = D.rules_for(get_config(arch), s, m)
                specs = list(port_specs.param_specs(
                    get_config(arch), rules).values())
                specs += list(port_specs.cache_specs(get_config(arch),
                                                     rules).values())
                for spec in specs:
                    if spec is None:
                        continue
                    pl = shd.placements(spec, m)
                    back = _spec_of(pl, m, len(spec))
                    assert _norm(back) == _norm(spec), spec
                    seen += 1
    assert seen > 1000
    with pytest.raises(ValueError, match="mesh order"):
        shd.placements((("model", "data"), None), meshes["single"])
