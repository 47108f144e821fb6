"""Logical sharding rules (the port of `repro/parallel/sharding.py`): DP /
FSDP / TP / SP / EP over a (pod, data, model) or (data, model) mesh.

A spec is a plain tuple with one entry per dimension: None (replicated), a
mesh axis name, or a tuple of axis names sharding that dimension over
several mesh axes (listed in mesh order, major to minor). The layout the
rule sets choose, as in the reference:

  * batch            -> ("pod", "data")   pure DP across pods
  * residual stream  -> sequence-parallel over "model" between blocks
  * attention heads / FFN hidden / experts -> "model" (TP / EP)
  * vocab (embedding + logits)            -> "model"
  * params           -> TP axis + optionally FSDP over "data" (train)
  * decode KV cache  -> sequence-sharded over "model" (over every mesh
                        axis at 500k context, where the batch is 1)

`shard(x, spec)` is the model code's one sharding statement: the identity
on a plain tensor and under `NULL_RULES`, and on a DTensor a redistribution
to the spec's placements (`placements`), the counterpart of GSPMD's
`with_sharding_constraint`. A `Partial` DTensor (a product contracted over
a sharded dimension) is reduced there, as the constraint forces it.

The DSE fan-out shards one dimension over `CANDIDATE_AXIS`;
`sanitize_spec` guards a spec against a concrete shape.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import sys
import threading
from typing import Mapping, Optional, Sequence, Tuple, Union

from torch.utils._python_dispatch import TorchDispatchMode

Spec = Tuple[Optional[Union[str, Tuple[str, ...]]], ...]


@dataclasses.dataclass(frozen=True)
class Rules:
    """The reference's rule set, property for property; every spec is a
    tuple. `data_axes` are the flattened batch axes, `all_axes` the mesh's
    (set by `for_mesh`), `expert_axes` the EP axes (None: the model axis
    alone; huge-E MoE decode spans the mesh), `moe_groups` the cumsum
    dispatch's token groups (the product of the data axes' sizes, set by
    the launchers)."""
    data_axes: Tuple[str, ...] = ("pod", "data")
    model_axis: str = "model"
    fsdp: bool = True               # shard params over data axes too (train)
    seq_parallel: bool = True       # sequence-shard the residual stream
    seq_shard_kv: bool = True       # decode: shard KV cache along sequence
    batch_over_model: bool = False  # long_500k (batch 1): the KV sequence
                                    # shards over every mesh axis
    all_axes: Tuple[str, ...] = ("pod", "data", "model")
    expert_axes: Optional[Tuple[str, ...]] = None
    moe_groups: int = 1
    context_parallel: bool = False  # prefill: shard the query sequence

    def _d(self):
        """Batch axes, or None when the batch is unsharded (long_500k)."""
        return self.data_axes if self.data_axes else None

    @property
    def ep_axes(self) -> Tuple[str, ...]:
        return self.expert_axes or (self.model_axis,)

    # ---- activations ----
    @property
    def batch(self) -> Spec:
        return (self._d(),)

    @property
    def resid(self) -> Spec:          # (B, S, D) between blocks
        if self.seq_parallel:
            return (self._d(), self.model_axis, None)
        return (self._d(), None, None)

    @property
    def heads(self) -> Spec:          # (B, S, H, Dh) inside attention
        if self.context_parallel:
            return (self._d(), self.model_axis, None, None)
        return (self._d(), None, self.model_axis, None)

    @property
    def ffn_hidden(self) -> Spec:     # (B, S, F)
        if self.context_parallel:
            return (self._d(), self.model_axis, None)
        return (self._d(), None, self.model_axis)

    @property
    def kv_heads(self) -> Spec:       # K/V in self-attention
        if self.context_parallel:
            return (self._d(), None, None, None)
        return self.heads

    @property
    def logits(self) -> Spec:         # (B, S, V)
        return (self._d(), None, self.model_axis)

    @property
    def kv_cache(self) -> Spec:       # (B, S, Hkv, Dh) decode cache
        if not self.seq_shard_kv:
            return (self._d(), None, self.model_axis, None)
        if self.batch_over_model:
            return (None, self.all_axes, None, None)
        return (self._d(), self.model_axis, None, None)

    @property
    def ssm_state(self) -> Spec:      # (B, heads, Dh, N) recurrent state
        return (self._d(), self.model_axis, None, None)

    @property
    def expert_tokens(self) -> Spec:  # (E, C, D) grouped expert batches
        if self.expert_axes:
            return (self.ep_axes, None, None)
        return (self.model_axis, self._d(), None)

    # ---- params (w: 2D (in, out) unless noted) ----
    def _maybe_fsdp(self, *spec) -> Spec:
        """FSDP data-sharding on the first None axis, if enabled."""
        if not self.fsdp:
            return tuple(spec)
        out = list(spec)
        for i, s in enumerate(out):
            if s is None:
                out[i] = self.data_axes
                break
        return tuple(out)

    @property
    def w_col(self) -> Spec:          # (D, F): output dim model-sharded
        return self._maybe_fsdp(None, self.model_axis)

    @property
    def w_row(self) -> Spec:          # (F, D): input dim model-sharded
        return self._maybe_fsdp(self.model_axis, None)

    @property
    def w_qkv(self) -> Spec:          # (D, H, Dh)
        return self._maybe_fsdp(None, self.model_axis, None)

    @property
    def w_out(self) -> Spec:          # (H, Dh, D)
        return self._maybe_fsdp(self.model_axis, None, None)

    @property
    def w_expert_in(self) -> Spec:    # (E, D, F)
        return self._maybe_fsdp(self.ep_axes, None, None)

    @property
    def w_expert_out(self) -> Spec:   # (E, F, D)
        return self._maybe_fsdp(self.ep_axes, None, None)

    @property
    def embed(self) -> Spec:          # (V, D)
        return self._maybe_fsdp(self.model_axis, None)

    @property
    def b_model(self) -> Spec:        # (F,) bias on a model-sharded dim
        return (self.model_axis,)

    @property
    def replicated(self) -> Spec:
        return ()


# The rule sets per step kind.
TRAIN_RULES = Rules(fsdp=True, seq_parallel=True)
PREFILL_RULES = Rules(fsdp=False, seq_parallel=True)
DECODE_RULES = Rules(fsdp=False, seq_parallel=False, seq_shard_kv=True)
LONG_DECODE_RULES = Rules(fsdp=False, seq_parallel=False, seq_shard_kv=True,
                          batch_over_model=True, data_axes=())

SINGLE_POD_AXES: Tuple[str, ...] = ("data",)

# The 1-D DSE candidate axis (launch.mesh.make_candidate_mesh).
CANDIDATE_AXIS = "candidates"


def candidate_spec(rank: int, dim: int) -> Spec:
    """Spec sharding dimension `dim` of a rank-`rank` operand over the
    candidate axis, every other dimension replicated. Callers pad the
    candidate dimension to a mesh-size multiple first; `sanitize_spec` with
    the concrete shape guards it."""
    parts = [None] * rank
    parts[dim] = CANDIDATE_AXIS
    return tuple(parts)


def for_mesh(rules: Rules, mesh) -> Rules:
    """Restrict the axis names to the ones `mesh` (anything with
    `mesh_dim_names` or `axis_names`) has."""
    names = _axis_names(mesh)
    axes = tuple(a for a in rules.data_axes if a in names)
    ep = (tuple(a for a in rules.expert_axes if a in names)
          if rules.expert_axes else None)
    return dataclasses.replace(
        rules, data_axes=axes if rules.batch_over_model else (axes or ("data",)),
        all_axes=tuple(names), expert_axes=ep)


def _axis_names(mesh) -> Tuple[str, ...]:
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names if names is not None else mesh.axis_names)


def axis_sizes(mesh) -> dict:
    """{axis name: size} of a DeviceMesh."""
    return dict(zip(_axis_names(mesh), mesh.mesh.shape))


_ACTIVE_AXIS_SIZES = None


def set_active_axis_sizes(sizes) -> None:
    """Mesh axis sizes for `shard()`'s sanitization while a program is
    traced (set by the dry-run around a cell; None disables it)."""
    global _ACTIVE_AXIS_SIZES
    _ACTIVE_AXIS_SIZES = dict(sizes) if sizes else None


_RESHARDING = threading.local()


def resharding() -> bool:
    """True while `shard()` redistributes a DTensor: the FLOP counter
    charges nothing to the redistribution's own local ops."""
    return getattr(_RESHARDING, "depth", 0) > 0


@contextlib.contextmanager
def _resharding():
    _RESHARDING.depth = getattr(_RESHARDING, "depth", 0) + 1
    try:
        yield
    finally:
        _RESHARDING.depth -= 1


def shard(x, spec: Optional[Spec]):
    """The sharding constraint: the identity on a plain tensor or a None
    spec (`NULL_RULES`); a DTensor is redistributed to `spec` on its own
    mesh, the spec first sanitized against its shape when mesh axis sizes
    are active (so 'model' moves off a 2-KV-head axis onto head_dim)."""
    if spec is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    if _ACTIVE_AXIS_SIZES:
        spec = sanitize_spec(x.shape, spec, _ACTIVE_AXIS_SIZES)
    return redistribute(x, placements(spec, x.device_mesh))


def is_strided(p) -> bool:
    """Whether placement `p` is a `_StridedShard`."""
    return type(p).__name__ == "_StridedShard"


def sharded_dim(p):
    """The tensor dimension a placement shards (a strided shard's too), or
    None."""
    return p.dim if p.is_shard() or is_strided(p) else None


def move_shards(x, src: int, dst: int):
    """`x` with the mesh dimensions that shard its dimension `src` sharding
    `dst` instead (an all-to-all); the identity on a plain tensor."""
    from torch.distributed.tensor import DTensor, Shard
    if not isinstance(x, DTensor):
        return x
    return redistribute(x, [Shard(dst) if sharded_dim(p) == src else p
                            for p in x.placements])


def unshard(x, dims):
    """`x` with tensor dimensions `dims` unsharded (each mesh dimension that
    shards one of them replicated instead), for an op DTensor cannot run
    on a sharded dimension: the identity on a plain tensor."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(x, DTensor):
        return x
    dims = {d % x.ndim for d in dims}
    return redistribute(x, [Replicate() if sharded_dim(p) in dims else p
                            for p in x.placements])


def split_dims(x, dim: int) -> Tuple[int, ...]:
    """The mesh dimensions that shard tensor dimension `dim` of `x`, when
    together they span more than one device; else () (a plain tensor, an
    unsharded dimension, or one split over a single device)."""
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return ()
    dim %= x.ndim
    dims = tuple(i for i, p in enumerate(x.placements)
                 if sharded_dim(p) == dim)
    n = 1
    for i in dims:
        n *= x.device_mesh.size(i)
    return dims if n > 1 else ()


def as_dtensor(x, mesh):
    """`x` as a DTensor on `mesh`: a plain tensor is replicated (every rank
    holds it whole, as `implicit_replication` takes it); a DTensor is
    returned as it is."""
    from torch.distributed.tensor import DTensor, Replicate
    if isinstance(x, DTensor):
        return x
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def redistribute(x, target):
    """`x` (a DTensor) redistributed to the placements `target`, `x` itself
    where it has them; the FLOP counter charges nothing to it
    (`resharding`)."""
    target = tuple(target)
    if tuple(x.placements) == target:
        return x
    with _resharding():
        return x.redistribute(x.device_mesh, target)


def partial_to_replicate(x, dims: Sequence[int]):
    """`x` with its Partial placements on mesh dimensions `dims` reduced
    (an all-reduce of its local shape over each), `x` itself where `dims`
    is empty; raises unless `x` is Partial on every one of them, so that a
    sharding DTensor chose otherwise (a gather) cannot pass unnoticed."""
    return partial_to_spec(x, dims, ())


def is_dtensor(t) -> bool:
    """Whether `t` is a DTensor, without importing `torch.distributed`
    (no DTensor can exist before it is imported)."""
    dt = sys.modules.get("torch.distributed.tensor")
    return dt is not None and isinstance(t, dt.DTensor)


def spans_devices(t) -> bool:
    """Whether `t` is a DTensor on a mesh of more than one device."""
    return is_dtensor(t) and t.device_mesh.size() > 1


def partial_dims(x) -> Tuple[int, ...]:
    """The mesh dimensions of more than one device on which `x` holds a
    Partial sum; () for a plain tensor."""
    if not is_dtensor(x):
        return ()
    from torch.distributed.tensor import Partial
    return tuple(i for i, p in enumerate(x.placements)
                 if isinstance(p, Partial) and x.device_mesh.size(i) > 1)


def cast_reduced(x, target, dtype):
    """`x` (a DTensor gradient) cast to `dtype`, its Partial sums
    (`partial_dims`) first reduced in `x`'s own dtype onto the placements
    `target` (its primal's) holds there, except where `target` is Partial
    too: a reduce-scatter where `target` shards a dimension no other mesh
    dimension shards; elsewhere (a replicated target, a strided shard,
    which DTensor reaches from a Partial by an all-reduce and whose views
    it refuses, or a dimension sharded twice) a reduce-scatter over the
    largest dimension that mesh dimension divides and no other shards and,
    after the cast, an all-gather in `dtype` to a replicated gradient
    (from f32 to bf16, 3/4 of an f32 all-reduce's bytes: the
    reduce-scatter and all-gather GSPMD splits an all-reduce into)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    dims = [i for i in partial_dims(x)
            if not isinstance(target[i], Partial)]
    if not dims:
        return x.to(dtype)
    mesh = x.device_mesh
    scatter, final = list(x.placements), list(x.placements)
    for i in dims:
        # DTensor scatters a Partial onto a dimension no other mesh
        # dimension shards
        t = target[i]
        if type(t).__name__ == "Shard" and \
                shard_count(mesh, scatter, t.dim) == 1:
            scatter[i] = final[i] = t
            continue
        fits = [d for d, n in enumerate(x.shape)
                if shard_count(mesh, scatter, d) == 1
                and n % mesh.size(i) == 0]
        scatter[i] = (Shard(max(fits, key=lambda d: x.shape[d])) if fits
                      else Replicate())
        final[i] = Replicate()
    return redistribute(redistribute(x, scatter).to(dtype), final)


def shard_count(mesh, placements, dim: int) -> int:
    """How many shards mesh dimensions with `placements` split tensor
    dimension `dim` into."""
    n = 1
    for j, p in enumerate(placements):
        if sharded_dim(p) == dim:
            n *= mesh.size(j)
    return n


def partial_to_spec(x, dims: Sequence[int], spec: Spec):
    """`partial_to_replicate` onto a sharded target: `x` with its Partial
    placements on mesh dimensions `dims` reduced straight onto `spec`'s
    placements there — a reduce-scatter in `x`'s dtype where `spec` shards
    a dimension over that mesh dimension, an all-reduce where it
    replicates — the other mesh dimensions left as they are. The spec is
    sanitized against `x`'s shape as `shard()` sanitizes it."""
    from torch.distributed.tensor import Partial
    if not dims:
        return x
    if not all(isinstance(x.placements[i], Partial) for i in dims):
        raise RuntimeError(f"expected a Partial result over mesh dimensions "
                           f"{tuple(dims)}, got {tuple(x.placements)}")
    if _ACTIVE_AXIS_SIZES:
        spec = sanitize_spec(x.shape, spec, _ACTIVE_AXIS_SIZES)
    target = placements(spec, x.device_mesh)
    return redistribute(x, [target[i] if i in dims else p
                            for i, p in enumerate(x.placements)])


def reduced_over(local, like, dims: Sequence[int], op: str):
    """The DTensor of `local` — `like`'s local shard reduced by `op`
    ("max" or "sum") over its last dimension, kept as size 1 — whose
    placements are `like`'s with Partial(op) on mesh dimensions `dims` (the
    ones that split that last dimension), reduced there: one all-reduce of
    the local shape on each of `dims`."""
    import torch
    from torch.distributed.tensor import DTensor, Partial
    mesh = like.device_mesh
    pl = [Partial(op) if i in dims else p
          for i, p in enumerate(like.placements)]
    shape = torch.Size(tuple(like.shape[:-1]) + (1,))
    part = DTensor.from_local(local, mesh, pl, run_check=False, shape=shape,
                              stride=torch.empty(shape, device="meta")
                              .stride())
    return partial_to_replicate(part, dims)


@functools.lru_cache(maxsize=64)
def _held(n: int, mesh, placements, coordinate):
    import numpy as np
    import torch
    from torch.distributed.tensor import distribute_tensor
    from torch.utils._python_dispatch import _disable_current_modes
    with _disable_current_modes():
        idx = distribute_tensor(torch.arange(n), mesh, placements,
                                src_data_rank=None).to_local()
        held = tuple(np.asarray(idx.cpu()).tolist())
    return held, {g: i for i, g in enumerate(held)}


def _held_of(x, dim: int):
    from torch.distributed.tensor import Replicate, Shard
    dim %= x.ndim
    pl = []
    for p in x.placements:
        if sharded_dim(p) != dim:
            pl.append(Replicate())
        elif is_strided(p):
            pl.append(type(p)(0, split_factor=p.split_factor))
        else:
            pl.append(Shard(0))
    mesh = x.device_mesh
    return _held(x.shape[dim], mesh, tuple(pl), tuple(mesh.get_coordinate()))


def held_indices(x, dim: int) -> Tuple[int, ...]:
    """The indices along dimension `dim` of `x` (a DTensor) that this rank's
    shard holds, in local order: DTensor's own split of `arange` over the
    mesh dimensions that shard `dim`, left to right, each by its placement
    (a plain Shard chunks contiguously, a `_StridedShard` takes its rows
    from each of `split_factor` pieces), without communication."""
    return _held_of(x, dim)[0]


def local_index(x, dim: int, i: int) -> Optional[int]:
    """Where index `i` of dimension `dim` lies in this rank's shard of `x`
    (`held_indices`), or None where another rank holds it."""
    return _held_of(x, dim)[1].get(i)


def replicated(fn, *args):
    """`fn(*args)` with every DTensor argument replicated and every tensor
    result a replicated DTensor: the replicate-in/replicate-out path of an
    op DTensor has no sharding strategy for, run as `local_map` runs it
    (`fn` on the local tensors, which are whole). Plain tensor arguments
    count as replicated; with no DTensor argument it is `fn(*args)`. The
    inputs' redistributions are `shard()`'s kind (the FLOP counter charges
    them nothing)."""
    import torch
    from torch.distributed.tensor import DTensor, Replicate
    from torch.utils._pytree import tree_leaves, tree_map

    mesh = next((a.device_mesh for a in tree_leaves(args)
                 if isinstance(a, DTensor)), None)
    if mesh is None:
        return fn(*args)
    rep = [Replicate()] * mesh.ndim
    with _resharding():
        local = tree_map(lambda a: a.redistribute(mesh, rep).to_local()
                         if isinstance(a, DTensor) else a, args)
    return tree_map(lambda t: DTensor.from_local(t, mesh, rep,
                                                 run_check=False)
                    if isinstance(t, torch.Tensor) else t, fn(*local))


# What DTensor raises when it cannot shard an op: no strategy
# (NotImplementedError), a view or shape it refuses (RuntimeError), and, in
# some torch versions, an IndexError or KeyError from its propagation rules.
_SHARDING_ERRORS = (RuntimeError, NotImplementedError, IndexError, KeyError)


def _gathered_retry(func, args, kwargs):
    """`func` again after the least gathering that lets DTensor run it:
    one sharded dimension of one DTensor argument unsharded (the last
    dimensions first), else every argument replicated."""
    from torch.distributed.tensor import DTensor
    for i, a in enumerate(args):
        if not isinstance(a, DTensor):
            continue
        dims = sorted({d for d in map(sharded_dim, a.placements)
                       if d is not None}, reverse=True)
        for d in dims:
            trial = list(args)
            trial[i] = unshard(a, (d,))
            try:
                return func(*trial, **kwargs)
            except _SHARDING_ERRORS:
                continue
    return replicated(lambda *a: func(*a, **kwargs), *args)


# Every GatherFallback's retried ops by name, summed over all instances
# (the caller clears it, as the kernels' LAUNCHES counts).
GATHERED: dict = {}


class GatherFallback(TorchDispatchMode):
    """A dispatch mode under which a functional op on DTensors that DTensor
    cannot shard — no sharding strategy, or a view it cannot split on a
    sharded dimension (refused even on a mesh of one device) — runs again
    on gathered inputs (`_gathered_retry`), the layout GSPMD reaches by
    resharding. `counts` holds this instance's retried ops by name (and
    `GATHERED` every instance's); in-place and out= ops are never
    retried."""

    def __init__(self):
        super().__init__()
        self.counts = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        try:
            return func(*args, **kwargs)
        except _SHARDING_ERRORS:
            if func._schema.is_mutable or not any(
                    issubclass(t, DTensor) for t in types):
                raise
        out = _gathered_retry(func, args, kwargs)
        for c in (self.counts, GATHERED):
            c[str(func)] = c.get(str(func), 0) + 1
        return out


class PartialCasts(TorchDispatchMode):
    """A dispatch mode that counts (`count`, by op in `ops`) the casts of
    an f32 DTensor holding a Partial sum over a mesh dimension of more than
    one device to a narrower float type: each rank would round its partial
    sum before the sum, where GSPMD reduces the reference's f32 dot ahead
    of its convert (`models.layers.sum_shards`)."""

    def __init__(self):
        super().__init__()
        self.count = 0
        self.ops = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        import torch
        kwargs = kwargs or {}
        x = args[0] if args else None
        if (func is torch.ops.aten._to_copy.default
                and kwargs.get("dtype") in (torch.bfloat16, torch.float16)
                and getattr(x, "dtype", None) == torch.float32
                and partial_dims(x)):
            self.count += 1
            key = f"{tuple(x.shape)} {tuple(x.placements)}"
            self.ops[key] = self.ops.get(key, 0) + 1
        return func(*args, **kwargs)


_VIEW_OPS = ("aten.view.default", "aten._unsafe_view.default",
             "aten.reshape.default")


def flattens_trailing_shard(x, shape) -> bool:
    """Whether viewing `x` (a DTensor) as `shape` flattens a group of
    dimensions in which one other than the leading one (dimensions of size
    one left out) is sharded: the flatten torch 2.13's DTensor gives a
    `_StridedShard` and torch 2.11's refuses (on a mesh dimension of one
    device too)."""
    from torch.distributed.tensor._ops._view_ops import Flatten, view_groups
    sharded = {sharded_dim(p) for p in x.placements if not is_strided(p)}
    try:
        groups = view_groups(tuple(x.shape), tuple(shape))
    except RuntimeError:    # not a view of x's size: the op itself raises
        return False
    return any(isinstance(spec, Flatten)
               and any(d.input_dim in sharded for d in spec.input_dims[1:])
               for spec in groups)


def model_site() -> str:
    """The innermost line of the port's model code on the stack
    (`models/`, else any `repro_torch` file outside `analysis/` and
    `parallel/`), as "file:line function"."""
    import traceback
    frames = traceback.extract_stack()[:-1]
    port = [f for f in frames if "repro_torch" in f.filename
            and "/analysis/" not in f.filename
            and "/parallel/" not in f.filename]
    models = [f for f in port if "/models/" in f.filename]
    f = (models or port or frames)[-1]
    return f"{f.filename.split('repro_torch/')[-1]}:{f.lineno} {f.name}"


class StridedViews(TorchDispatchMode):
    """A dispatch mode that counts (`count`, by model site in `sites`,
    `model_site`) the views of a DTensor on a mesh of more than one device
    whose output gains a `_StridedShard` that no input had — a flatten of
    a sharded dimension that does not lead its group
    (`flattens_trailing_shard`), which torch 2.13 takes with a strided
    shard and torch 2.11 refuses (a `GatherFallback` then reruns it on
    gathered operands, where GSPMD never gathers). Both are counted, on
    either version, on either side of a `GatherFallback`; a
    `analysis.collectives.CollectiveCounter` hides DTensor ops from the
    modes below it, so enter this one after it."""

    def __init__(self):
        super().__init__()
        self.count = 0
        self.sites = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        x = args[0] if args else None
        if str(func) not in _VIEW_OPS or not spans_devices(x) \
                or any(map(is_strided, x.placements)):
            return func(*args, **kwargs)
        flat = flattens_trailing_shard(x, args[1])
        try:
            out = func(*args, **kwargs)
        except _SHARDING_ERRORS:
            if flat:
                self._record()
            raise
        if flat or (is_dtensor(out)
                    and any(map(is_strided, out.placements))):
            self._record()
        return out

    def _record(self) -> None:
        self.count += 1
        key = model_site()
        self.sites[key] = self.sites.get(key, 0) + 1


def product_strategies(batched: bool, a, b, out_dtype=None) -> list:
    """One mesh dimension's sharding strategies of `aten.mm` (`batched`
    False: (M, K) x (K, N)) or `aten.bmm` ((B, M, K) x (B, K, N)) on
    operands of DTensor specs `a` and `b`, as `register_sharding` lists
    them: (output placements, input placements with None for
    `out_dtype`). They are DTensor's own for `mm.default` / `bmm.default`,
    in its order: all replicated; then for each kind of shard the operands
    hold (plain, or a strided shard of one split factor), the batch
    dimension sharded on both operands (bmm), the contracted dimension
    sharded on both (a Partial sum), either operand's free dimension
    sharded; then, as the product is linear in each operand, one operand
    Partial and the other replicated."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    kinds = {}
    for p in (*a.placements, *b.placements):
        if is_strided(p):
            kinds.setdefault(p.split_factor, functools.partial(
                type(p), split_factor=p.split_factor))
        elif isinstance(p, Shard):
            kinds.setdefault(None, Shard)
    k, r = int(batched), Replicate()
    templates = ([lambda sh: ([sh(0)], [sh(0), sh(0), None])] if batched
                 else [])
    templates += [lambda sh: ([Partial()], [sh(k + 1), sh(k), None]),
                  lambda sh: ([sh(k)], [sh(k), r, None]),
                  lambda sh: ([sh(k + 1)], [r, sh(k + 1), None])]
    out = [([r], [r, r, None])]
    out += [t(sh) for t in templates for sh in kinds.values()]
    for op in Partial.LINEAR_REDUCE_OPS:
        out += [([Partial(op)], [Partial(op), r, None]),
                ([Partial(op)], [r, Partial(op), None])]
    return out


@functools.cache
def register_product_strategies() -> None:
    """Register DTensor sharding strategies for `aten.mm.dtype` and
    `aten.bmm.dtype` — the bf16 route's products, bf16 operands with an f32
    result (`models.layers.bf16_product`), which DTensor has none for — as
    `product_strategies` gives them; a Partial result is reduced in the
    result's f32 and `out_dtype` passes through to the local op. Done once
    a process, where the port first meets a DTensor (`dtensor_run`,
    `parallel.specs.distribute`, the dry-run), so that importing the
    package imports no `torch.distributed`."""
    import torch
    from torch.distributed.tensor.experimental import register_sharding
    aten = torch.ops.aten
    for op, batched in ((aten.mm.dtype, False), (aten.bmm.dtype, True)):
        register_sharding(op)(functools.partial(product_strategies, batched))


def _has_dtensor(trees) -> bool:
    # no DTensor can exist before torch.distributed.tensor is imported
    if sys.modules.get("torch.distributed.tensor") is None:
        return False
    import torch
    from torch.utils._pytree import tree_leaves
    return any(is_dtensor(t) for tree in trees
               for t in (tree.parameters() if isinstance(tree, torch.nn.Module)
                         else tree_leaves(tree)))


_DTENSOR_RUN = threading.local()


@contextlib.contextmanager
def dtensor_run(*trees):
    """The context an entry point runs in: when any tensor of `trees` (a
    module's parameters, or trees of tensors) is a DTensor,
    `implicit_replication` (the plain tensors made inside the models —
    rope tables, masks, constants, scan states — meet DTensors as
    replicated) and a `GatherFallback` (unless one is active already, as
    under `analysis.op_cost.Tracer`, which places its own); else nothing.
    Nested calls leave the outermost's contexts open
    (`implicit_replication` itself does not nest). The bf16 route's
    products get their sharding strategies here
    (`register_product_strategies`)."""
    depth = getattr(_DTENSOR_RUN, "depth", 0)
    if depth or not _has_dtensor(trees):
        yield
        return
    register_product_strategies()
    from torch.distributed.tensor.experimental import implicit_replication
    from torch.utils._python_dispatch import _get_current_dispatch_mode_stack
    with contextlib.ExitStack() as stack:
        stack.enter_context(implicit_replication())
        if not any(isinstance(m, GatherFallback)
                   for m in _get_current_dispatch_mode_stack()):
            stack.enter_context(GatherFallback())
        _DTENSOR_RUN.depth = 1
        try:
            yield
        finally:
            _DTENSOR_RUN.depth = 0


class _NullRules:
    """Stand-in for single-device runs: every spec resolves to None, so every
    `shard()` call is the identity. Lets model code be written once."""

    fsdp = False
    seq_parallel = False
    seq_shard_kv = False
    batch_over_model = False

    def __getattr__(self, name):
        return None

    def _maybe_fsdp(self, *spec):
        return None


NULL_RULES = _NullRules()


def _prod(axes, sizes: Mapping[str, int]) -> int:
    n = 1
    for a in axes:
        n *= sizes[a]
    return n


def sanitize_spec(shape: Sequence[int], spec: Sequence,
                  axis_sizes: Mapping[str, int]) -> Spec:
    """Make `spec` valid for `shape` under divisibility rules.

    A mesh axis shards at most one dimension (its first occurrence). For
    each dimension whose sharded size does not divide it, axes are dropped
    (last first) and re-homed onto the trailing dimension, else the largest
    unsharded one, that they divide; axes that fit nowhere are dropped
    (replicated)."""
    parts = list(spec) + [None] * (len(shape) - len(spec))

    def axes_of(e):
        if e is None:
            return []
        return [e] if isinstance(e, str) else list(e)

    out = [axes_of(e) for e in parts]
    seen = set()
    for axes in out:
        for a in list(axes):
            if a in seen:
                axes.remove(a)
            else:
                seen.add(a)
    homeless = []
    for i, axes in enumerate(out):
        while axes and shape[i] % _prod(axes, axis_sizes) != 0:
            homeless.append(axes.pop())
    for ax in homeless:
        order = sorted(range(len(shape)),
                       key=lambda j: (j != len(shape) - 1, -shape[j]))
        for i in order:
            if not out[i] and shape[i] % axis_sizes[ax] == 0:
                out[i] = [ax]
                break
    return tuple(None if not a else (a[0] if len(a) == 1 else tuple(a))
                 for a in out)


def placements(spec: Spec, mesh) -> tuple:
    """DTensor placements of `spec` on `mesh`, one per mesh dimension:
    Shard(i) where tensor dimension i names that mesh axis, Replicate()
    elsewhere. An entry naming several axes must list them in mesh order
    (JAX's major-to-minor, which DTensor's left-to-right chunking of one
    dimension over several mesh dimensions reproduces); otherwise, and for
    an axis the mesh lacks or one named twice, it raises."""
    from torch.distributed.tensor import Replicate, Shard

    names = _axis_names(mesh)
    dim_of = {}
    for i, entry in enumerate(spec):
        axes = () if entry is None else (
            (entry,) if isinstance(entry, str) else tuple(entry))
        idx = []
        for a in axes:
            if a not in names:
                raise ValueError(f"spec {spec}: mesh {names} has no axis "
                                 f"{a!r}")
            if a in dim_of:
                raise ValueError(f"spec {spec}: axis {a!r} shards two "
                                 f"dimensions")
            dim_of[a] = i
            idx.append(names.index(a))
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: entry {entry} is not in mesh "
                             f"order {names}")
    return tuple(Shard(dim_of[n]) if n in dim_of else Replicate()
                 for n in names)


def local_shape(shape: Sequence[int], spec: Spec,
                axis_sizes_: Mapping[str, int]) -> Tuple[int, ...]:
    """Per-device shape of `shape` under a spec that divides it."""
    parts = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for n, e in zip(shape, parts):
        axes = () if e is None else ((e,) if isinstance(e, str) else e)
        k = _prod(axes, axis_sizes_)
        if n % k:
            raise ValueError(f"{spec} does not divide {tuple(shape)}")
        out.append(n // k)
    return tuple(out)
