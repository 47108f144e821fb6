"""Common transformer layers (the port of `repro/models/layers.py`): RMSNorm,
RoPE, GQA attention (global or sliding window, optional softcap and bias,
bidirectional for the encoder), the gated MLP, embeddings, the
cross-entropy loss.

Parameters live in `nn.Module`s with the reference's names and layouts
(`wq` is (d, H, Dh), `wo` (H, Dh, d), ...), so that a reference pytree
carries across leaf for leaf (`interop.params_from_reference`); the
compute is plain functions on tensors, as in the reference. Mixed
precision follows the reference: parameters and activations bf16; norms,
softmax and RoPE in f32; every product (`matmul32` / `einsum32`) has an
f32 result, cast back to the activation dtype by its caller. The
reference's switch `set_exec_safe` picks how a product multiplies:

  * exec-safe (True): the operands are cast to f32 and multiplied in f32
    (equal to the bf16 product up to summation order, since bf16 embeds
    exactly in f32); the reference's tests, examples and `--reduced`
    launchers run so. TF32 must stay off for it
    (`torch.backends.cuda.matmul.allow_tf32` False, float32 matmul
    precision "highest", PyTorch's defaults).
  * bf16 (False, the default, as in the reference, whose full-width
    launchers run so): on a CUDA device, bf16 operands go into one
    library product with an f32 result (`torch.mm` / `torch.bmm` with
    `out_dtype=torch.float32`; an einsum is lowered to permute, reshape,
    that `bmm`, reshape), the reference's bf16 x bf16 -> f32 dot. Its
    gradient (`_Product`) is the reference's transpose: the f32
    cotangent times the other operand taken as f32, in f32, cast to the
    operand's dtype, which is what the exec-safe path's autograd
    computes. No product here has a bf16 result, so cuBLAS's bf16
    reduced-precision reduction never applies. The route runs on meta
    tensors too (the dry-run, which computes shapes only); an operand in
    f32 makes the product an f32 one in either mode (the reference
    promotes), and on the CPU (which has no kernel for the f32-result
    product) both modes run the exec-safe form, the plain version. An
    equation the lowering cannot take raises. DTensor operands shard as
    `mm` / `bmm` do (`parallel.sharding.register_product_strategies`), so
    a sharded run takes the mode `set_exec_safe` says, as the
    reference's does; its flattens are planned on the operands' layout
    (`_Plan`), and exec-safe products on a mesh take the same lowering
    with an f32 product. `PRODUCTS` counts the route each call took.

Sharding goes through `rules` (`parallel.sharding.Rules`; `NULL_RULES`, the
default, makes every `shard()` the identity) at the reference's places;
`attention_specs` and `mlp_specs` give the parameters' specs. On DTensors
no product's Partial sum meets a cast to bf16 before it is summed, as
GSPMD reduces the reference's f32 dot ahead of its convert: a row-parallel
product's is reduced in f32 by `sum_shards` (all-reduced in decode,
reduce-scattered onto the residual's sequence shards under a
sequence-parallel residual); one that DTensor's choice of strategy would
make (an FSDP weight's contraction sharded, in `matmul16` too) is not
made, the weight being gathered first (`_gathered`), as GSPMD gathers it;
a gradient's is reduced in f32 ahead of its cast to the operand's dtype
(`_cast_like`, `upcast`). The GSPMD layout switches are the reference's:
`set_gqa_mode` ("grouped" evaluates GQA on the (B, S, Hkv, G, D) view,
"repeat_kv" repeats K/V to the full head count first) and `set_xent_mode`
("gather" takes the gold logit by index, "onehot" by a masked sum over
the vocabulary).
"""
from __future__ import annotations

import contextlib
import contextvars
import functools
from typing import Optional

import numpy as np
import torch
from torch import nn

from ..parallel.sharding import (NULL_RULES, as_dtensor, cast_reduced,
                                 is_dtensor, is_strided, move_shards,
                                 partial_dims, partial_to_replicate,
                                 partial_to_spec, redistribute, shard,
                                 shard_count, sharded_dim, spans_devices,
                                 unshard)

DTYPE = torch.bfloat16
NEG_INF = -1e30


# The product mode (module docstring); the reference's default.
_EXEC_SAFE = False
# Products by route since the caller last cleared it: "bf16" (bf16
# operands into the library product, on a card or on meta), "f32"
# (operands in f32, `torch.einsum` / `torch.matmul`) or "f32_lowered" (f32
# operands on a mesh of more than one device, through the lowering).
PRODUCTS = {"bf16": 0, "f32": 0, "f32_lowered": 0}


def set_exec_safe(v: bool) -> None:
    """The reference's switch: True multiplies every product in f32
    (operands cast), False (the default) multiplies bf16 operands on a card
    (or on meta) into an f32 result (module docstring)."""
    global _EXEC_SAFE
    _EXEC_SAFE = bool(v)


def _bf16_route(ops) -> bool:
    """Whether a product of `ops` takes the bf16 route: the mode is off and
    every operand is a bf16 tensor on a CUDA device or on meta (a
    DTensor's own device: its local tensors')."""
    return (not _EXEC_SAFE and len(ops) > 0
            and all(o.dtype == torch.bfloat16
                    and o.device.type in ("cuda", "meta") for o in ops))


def bf16_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The library product with an f32 result: `torch.mm` for (M, K) x
    (K, N), `torch.bmm` for (B, M, K) x (B, K, N). CUDA and meta only
    (PyTorch has no CPU kernel for it)."""
    fn = torch.mm if a.ndim == 2 else torch.bmm
    return fn(a, b, out_dtype=torch.float32)


def _ellipsis_dims(spec: str, ndim: int) -> int:
    """How many dimensions "..." stands for in an einsum operand."""
    if "..." not in spec:
        return 0
    n = ndim - (len(spec) - 3)
    if n < 0:
        raise ValueError(f"einsum operand {spec!r} does not fit {ndim} "
                         f"dimensions")
    return n


class _Plan:
    """A two-operand contraction as one batched product: `a` permuted to
    (batch, left, summed) and `b` to (batch, summed, right) dimensions, each
    group flattened, the (Bt, M, N) product (an (M, N) one without batch
    dimensions) reshaped and permuted to the output. Without a `layout`
    (plain tensors, meshes of one device) the groups are the ones
    `torch.einsum` forms (batch, left and right dimensions in the output's
    order, summed ones in label order), so that with the same f32 product
    the lowering and its gradient compute what `torch.einsum`'s autograd
    computes. With one (`_layout`: DTensors on a mesh of more than one
    device) the labels an operand shards lead their group, in mesh
    dimension order, the batch and summed groups in the same order in both
    operands, so that a group with one sharded label flattens to a plain
    shard: DTensor gives a flatten of a sharded dimension that does not
    lead its group a `_StridedShard` (torch 2.13) or refuses it (torch
    2.11). There the summed group's order, and so the order of the sum,
    can differ from `torch.einsum`'s. `crowded` says that a group holds
    two sharded labels, which no flatten keeps plain (`_on_shards`)."""

    def __init__(self, eq: str, shape_a, shape_b, layout=()):
        if "->" not in eq:
            raise ValueError(f"einsum {eq!r}: the lowering needs an explicit "
                             f"output")
        lhs, out = eq.replace(" ", "").split("->")
        specs = lhs.split(",")
        if len(specs) != 2:
            raise ValueError(f"einsum {eq!r}: the lowering takes two "
                             f"operands")
        if any(c.isupper() for c in eq):
            raise ValueError(f"einsum {eq!r}: the lowering takes lower-case "
                             f"labels")
        # "..." spelled out in upper-case labels, aligned on the right
        fill = "ABCDEFGHIJKLMNOPQRSTUVWXYZ"
        n_a = _ellipsis_dims(specs[0], len(shape_a))
        n_b = _ellipsis_dims(specs[1], len(shape_b))
        n_out = max(n_a, n_b)
        ea = specs[0].replace("...", fill[n_out - n_a:n_out])
        eb = specs[1].replace("...", fill[n_out - n_b:n_out])
        eo = out.replace("...", fill[:n_out])
        size = {}
        for labels, shape in ((ea, shape_a), (eb, shape_b)):
            if len(labels) != len(shape) or len(set(labels)) != len(labels):
                raise ValueError(f"einsum {eq!r}: the lowering takes no "
                                 f"repeated label within an operand")
            for lab, n in zip(labels, shape):
                if size.setdefault(lab, n) != n:
                    raise ValueError(f"einsum {eq!r}: label {lab!r} has "
                                     f"sizes {size[lab]} and {n} (no "
                                     f"broadcasting)")
        if len(set(eo)) != len(eo) or not set(eo) <= set(ea) | set(eb) \
                or not set(ea) ^ set(eb) <= set(eo):
            raise ValueError(f"einsum {eq!r}: the lowering needs every "
                             f"output label in an operand and every label "
                             f"of one operand alone in the output")
        self.labels = ea, eb, eo
        lead = []
        for dims in layout:
            for labels, d in zip((ea, eb), dims):
                if d is not None and labels[d] not in lead:
                    lead.append(labels[d])

        def ordered(group):
            return [c for c in lead if c in group] + \
                [c for c in group if c not in lead]
        batch = ordered([c for c in eo if c in ea and c in eb])
        left = ordered([c for c in eo if c in ea and c not in eb])
        right = ordered([c for c in eo if c in eb and c not in ea])
        summed = ordered(sorted(c for c in ea if c in eb and c not in eo))
        self.crowded = any(sum(c in lead for c in g) > 1
                           for g in (batch, left, summed, right))
        perm_a = [ea.index(c) for c in batch + left + summed]
        perm_b = [eb.index(c) for c in batch + summed + right]
        mid = self.mid = batch + left + right
        self.perm_a, self.perm_b = _moved(perm_a), _moved(perm_b)
        self.perm_out = _moved([mid.index(c) for c in eo])

        def prod(labels):
            n = 1
            for c in labels:
                n *= size[c]
            return n
        # no batch dimension: one `mm` (matmul32's (..., K) x (K, N))
        bt = (prod(batch),) if batch else ()
        m, k, n = prod(left), prod(summed), prod(right)
        self.shape_a3, self.shape_b3 = bt + (m, k), bt + (k, n)
        self.shape_c3 = bt + (m, n)
        self.mid_out = tuple(size[c] for c in mid)
        self.permuted = (tuple(size[ea[i]] for i in perm_a),
                         tuple(size[eb[i]] for i in perm_b))

    def operands(self, a, b):
        return (_permute(a, self.perm_a).reshape(self.shape_a3),
                _permute(b, self.perm_b).reshape(self.shape_b3))

    def output(self, c3):
        return _permuted(c3.view(self.mid_out), self.perm_out)

    def operand_grad(self, k, g3):
        """Operand `k`'s (0: a, 1: b) gradient from its lowered one."""
        perm = (self.perm_a, self.perm_b)[k]
        return _permute(g3.reshape(self.permuted[k]), _inverse(perm))


def _moved(perm):
    """A permutation as a tuple, or None where it moves nothing (the
    lowering then skips the call: decode is bound by the host's calls)."""
    return None if perm == sorted(perm) else tuple(perm)


def _permute(t, perm):
    return t if perm is None else t.permute(perm)


def _permuted(t, perm):
    """`t` permuted by `perm`, and on a mesh of more than one device made
    contiguous: DTensor keeps a permuted result's strides apart from its
    local shard's, which a later elementwise op may lay out afresh, and a
    view after that then fails on the shard."""
    t = _permute(t, perm)
    return t.contiguous() if perm is not None and spans_devices(t) else t


def _inverse(perm):
    return None if perm is None else tuple(sorted(range(len(perm)),
                                                  key=perm.__getitem__))


@functools.lru_cache(maxsize=None)
def _plan(eq: str, shape_a, shape_b, layout=()) -> _Plan:
    return _Plan(eq, shape_a, shape_b, layout)


def _layout(a, b):
    """The layout `_Plan` keys on: for each mesh dimension of more than one
    device, the dimension of `a` and of `b` sharded there (by a `Shard` or
    a `_StridedShard`; None where replicated or Partial). () for plain
    tensors and on meshes of one device, where the plan is `torch.einsum`'s
    own."""
    if not (spans_devices(a) or spans_devices(b)):
        return ()
    mesh = (a if is_dtensor(a) else b).device_mesh
    return tuple(tuple(sharded_dim(t.placements[i]) if is_dtensor(t)
                       else None for t in (a, b))
                 for i in range(mesh.ndim) if mesh.size(i) > 1)


class _Operands(torch.autograd.Function):
    """The lowered operands (bf16 on the bf16 route) as they are, saved for
    `_Product`'s backward. A custom Function's tensors are saved after its
    forward, a library op's inputs before it runs: saved here, ahead of the
    product, they let `torch.utils.checkpoint`'s recompute stop before a
    product whose result nothing after it needs, as it stops before
    `torch.bmm` (a product that saved its own operands would run once
    more in every recompute)."""

    @staticmethod
    def forward(ctx, a3, b3, link):
        ctx.save_for_backward(a3, b3)
        link.append(ctx)
        outs = a3.view_as(a3), b3.view_as(b3)
        ctx.mark_non_differentiable(*(o for o, need in zip(
            outs, ctx.needs_input_grad) if not need))
        return outs

    @staticmethod
    def backward(ctx, ga, gb):
        return ga, gb, None


class _Product(torch.autograd.Function):
    """`product` of lowered operands with the reference's gradient
    (module docstring): the f32 cotangent times the other operand (from
    `_Operands`, reached through `link`) taken as f32, in f32, cast to the
    operand's dtype — `bmm`'s or `mm`'s backward."""

    @staticmethod
    def forward(ctx, a3, b3, link, product):
        ctx.link = link
        return product(a3, b3)

    @staticmethod
    def backward(ctx, g):
        a3, b3 = ctx.link[0].saved_tensors
        g = g.float()
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = _cast_like(g.matmul(b3.float().mT), a3)
        if ctx.needs_input_grad[1]:
            gb = _cast_like(a3.float().mT.matmul(g), b3)
        return ga, gb, None, None


def _cast_like(g, primal):
    """`g`, an f32 gradient of `primal` (a tensor, or a (placements,
    dtype) pair), cast to `primal`'s dtype, its Partial sums first reduced
    in f32 (`parallel.sharding.cast_reduced`), as GSPMD reduces the
    reference's transposed f32 dot ahead of its convert."""
    placements, dtype = (primal if isinstance(primal, tuple)
                         else (getattr(primal, "placements", None),
                               primal.dtype))
    if not partial_dims(g):
        return g.to(dtype)
    return cast_reduced(g, placements, dtype)


class _Upcast(torch.autograd.Function):
    """A DTensor as f32, whose gradient is reduced in f32 onto its
    placements before the cast back to its dtype (`_cast_like`):
    autograd's cast would round each rank's Partial gradient first."""

    @staticmethod
    def forward(ctx, t):
        ctx.primal = t.placements, t.dtype
        return t.float()

    @staticmethod
    def backward(ctx, g):
        return _cast_like(g, ctx.primal)


def upcast(t: torch.Tensor) -> torch.Tensor:
    """`t.float()`; a narrower DTensor that takes a gradient goes through
    `_Upcast`."""
    if (t.dtype != torch.float32 and t.requires_grad and is_dtensor(t)
            and torch.is_grad_enabled()):
        return _Upcast.apply(t)
    return t.float()


def _gathered(eq: str, a, b):
    """`a` and `b`, DTensor operands of `eq`, with a parameter gathered off
    each mesh dimension on which it shards a dimension the product sums
    while the other operand shards one the output keeps (an FSDP weight's
    contraction, sharded over the data axes that shard the batch), as
    GSPMD gathers the weight: DTensor would otherwise shard the
    contraction and sum partial products. A row-parallel product (both
    operands shard the summed dimension) keeps its Partial sum for its
    caller (`sum_shards`)."""
    if not (spans_devices(a) or spans_devices(b)):
        return a, b
    from torch.distributed.tensor import Replicate
    ea, eb, eo = _plan(eq, tuple(a.shape), tuple(b.shape)).labels
    out = [a, b]
    mesh = (a if is_dtensor(a) else b).device_mesh
    for i in range(mesh.ndim):
        if mesh.size(i) == 1:
            continue
        kind = []
        for t, labels in ((a, ea), (b, eb)):
            d = sharded_dim(t.placements[i]) if is_dtensor(t) else None
            kind.append(None if d is None else labels[d] in eo)
        for j in (0, 1):
            if kind[j] is False and kind[1 - j] is True and \
                    isinstance(out[j], nn.Parameter):
                out[j] = redistribute(out[j], [
                    Replicate() if k == i else p
                    for k, p in enumerate(out[j].placements)])
    return tuple(out)


def lowered_einsum(eq: str, a: torch.Tensor, b: torch.Tensor,
                   product=None, given=None) -> torch.Tensor:
    """`eq` over (a, b) as one batched `product` (the bf16 route's lowering;
    `product` defaults to `bf16_product`); raises ValueError for an
    equation it cannot take (more or fewer than two operands, no explicit
    output, a repeated label, broadcasting, a label summed within one
    operand). DTensor operands are planned on their layout (`_Plan`), and
    a group with two sharded labels is multiplied on the local shards
    (`_on_shards`, whose gradients are reduced onto `given`, the operands'
    placements before `_gathered`, where the caller passes them)."""
    product = product or bf16_product
    layout = _layout(a, b)
    if not layout:
        return _lowered(_plan(eq, tuple(a.shape), tuple(b.shape)), a, b,
                        product)
    ops = a, b
    a, b = _resolved(eq, a, b, local=False)
    plan = _plan(eq, tuple(a.shape), tuple(b.shape), _layout(a, b))
    out = (_on_shards(eq, a, b, product, given) if plan.crowded
           else _lowered(plan, a, b, product))
    return _one_device_shards(out, plan.labels, ops)


def _one_device_shards(out, labels, ops):
    """`out` laid out again, on each mesh dimension of one device, as a
    DTensor product of `ops` would lay it out there: Partial where an
    operand is Partial or both shard the same summed label, else sharded
    along an output label an operand shards, else replicated. `_resolved`
    replicates every operand there, and over one device each of these is
    the whole (no collective)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    ea, eb, eo = labels
    mesh, target = out.device_mesh, list(out.placements)
    for i in range(mesh.ndim):
        if mesh.size(i) > 1:
            continue
        pls = [t.placements[i] if is_dtensor(t) else Replicate()
               for t in ops]
        labs = [_label_on(t, ls, i) if is_dtensor(t) else None
                for t, ls in zip(ops, (ea, eb))]
        kept = [(c, p) for c, p in zip(labs, pls)
                if c is not None and c in eo and not is_strided(p)]
        if any(p.is_partial() for p in pls) or (
                labs[0] is not None and labs[0] == labs[1]
                and labs[0] not in eo):
            target[i] = Partial()
        elif kept:
            target[i] = Shard(eo.index(kept[0][0]))
        else:
            target[i] = Replicate()
    if target == list(out.placements):
        return out
    # the shard is unchanged; the gradient of a Partial sum is replicated
    grad = [Replicate() if p.is_partial() else p for p in out.placements]
    return DTensor.from_local(out.to_local(grad_placements=grad), mesh,
                              target, run_check=False, shape=out.shape,
                              stride=out.stride())


def _lowered(plan, a, b, product):
    a3, b3 = plan.operands(a, b)
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        link = []
        a3, b3 = _Operands.apply(a3, b3, link)
        return plan.output(_Product.apply(a3, b3, link, product))
    return plan.output(product(a3, b3))


def f32_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The exec-safe route's product of lowered f32 operands: `torch.mm`
    or `torch.bmm`, what `torch.einsum` decomposes into."""
    return (torch.mm if a.ndim == 2 else torch.bmm)(a, b)


def _label_on(t, labels, i):
    """The label of `labels` (`t`'s) that `t` shards on mesh dimension
    `i`, or None."""
    d = sharded_dim(t.placements[i])
    return None if d is None else labels[d]


def _split_kind(p):
    return p.split_factor if is_strided(p) else 0


def _resolved(eq, a, b, local: bool = True):
    """(a, b), operands of `eq` on a mesh, replicated on its mesh dimensions
    of one device (`_one_device_shards` shards the product there again),
    and without two different labels sharded on one mesh dimension: there
    the operand that shards a summed label is gathered
    where the other's label is kept (no Partial sum comes of it: a
    row-parallel weight beside a sequence-sharded activation, a decode
    token's hidden units beside a head-dim-sharded weight); where both
    labels are kept, `a` (the models' activation: a sequence-sharded input
    of a column-parallel product is gathered over its sequence, as GSPMD
    gathers the reference's, and the product comes out in the heads',
    hidden units' or vocabulary's layout the rules name); where both are
    summed, the one with fewer bytes a device. With `local` (a plain
    operand taken as replicated) they are further laid out so that their
    local shards
    multiply alone: on each mesh dimension of more than one device nothing
    sharded, one label sharded alike in both (a batch or a summed label),
    a label of one operand alone (a left or a right label), or one operand
    Partial beside a replicated one (the product is linear in it; a
    Partial beside anything else is reduced). Where one shards a label the
    other holds whole, the other takes the same shard (a local slice, no
    collective)."""
    from torch.distributed.tensor import Replicate, Shard
    ea, eb, eo = _plan(eq, tuple(a.shape), tuple(b.shape)).labels
    mesh = (a if is_dtensor(a) else b).device_mesh
    ops, labels = [a, b], (ea, eb)
    if local:
        ops = [as_dtensor(t, mesh) for t in ops]

    def place(j, i, p):
        ops[j] = redistribute(ops[j], [p if k == i else q for k, q in
                                       enumerate(ops[j].placements)])

    def nbytes(t):
        return t.to_local().numel() * t.element_size()

    for i in range(mesh.ndim):
        if mesh.size(i) == 1:
            # a shard or a Partial over one device is the whole: replicated
            # (no collective), it makes no strided flatten and no Partial
            for j, t in enumerate(ops):
                if is_dtensor(t) and t.placements[i] != Replicate():
                    place(j, i, Replicate())
            continue
        lab = [_label_on(t, labels[j], i) if is_dtensor(t) else None
               for j, t in enumerate(ops)]
        if None not in lab and lab[0] != lab[1]:
            summed = [c not in eo for c in lab]
            j = (summed.index(True) if sum(summed) == 1 else 0
                 if not any(summed) else
                 min((0, 1), key=lambda j: nbytes(ops[j])))
            place(j, i, Replicate())
            lab[j] = None
        if not local:
            continue
        partial = [t.placements[i].is_partial() for t in ops]
        for j in (0, 1):
            if partial[j] and (lab[1 - j] is not None or partial[1 - j]):
                place(j, i, Replicate())
                partial[j] = False
        if lab[0] == lab[1] and lab[0] is not None and _split_kind(
                ops[0].placements[i]) != _split_kind(ops[1].placements[i]):
            for j in (0, 1):
                place(j, i, Replicate())
                lab[j] = None
        for j in (0, 1):
            o = 1 - j
            if lab[j] is None or lab[o] is not None or \
                    lab[j] not in labels[o]:
                continue
            if is_strided(ops[j].placements[i]):
                place(j, i, Replicate())    # no slice makes a strided one
                lab[j] = None
            else:
                place(o, i, Shard(labels[o].index(lab[j])))
    return ops


def _on_shards(eq, a, b, product, given=None):
    """`eq` over (a, b) where a group of the plan holds two sharded labels
    (`_Plan.crowded`: the batch and sequence of an activation sharded over
    two mesh dimensions, say), which no flatten keeps plain: the operands
    laid out by `_resolved`, then the product of their local shards
    (`_ShardSpec`: `_Plan` on the local shapes, `product`, the result taken
    back as a DTensor whose placements follow the labels; its gradient
    reduced onto the operands' own placements, or `given`)."""
    given = given or _placements(a, b)
    a, b = _resolved(eq, a, b)
    spec = _ShardSpec(eq, a, b, [p or t.placements
                                 for p, t in zip(given, (a, b))])
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        link = []
        a, b = _Operands.apply(a, b, link)
        return _permuted(_ShardProduct.apply(a, b, link, spec, product),
                         spec.perm_out)
    return _permuted(spec.product(a, b, product), spec.perm_out)


class _ShardSpec:
    """The placements of a product of local shards (`_on_shards`) of
    operands `_resolved` laid out, its result in the lowering's order of
    the output labels (`_Plan.mid`; `perm_out` puts them in the output's):
    on each mesh dimension a label sharded in the output keeps its shard,
    a summed one makes a Partial sum (as does a Partial operand beside a
    replicated one), and an operand replicated there while the product is
    sharded takes a
    Partial gradient (its local gradient sums over the other's shard),
    reduced in f32 onto `given`, the placements the operand had before
    `_resolved` gathered or sliced it. `scale` is the number of distinct
    local products, by which a trace charges the local GEMMs
    (`analysis.op_cost.scaled`)."""

    def __init__(self, eq, a, b, given):
        from torch.distributed.tensor import Partial, Replicate, Shard
        plan = _plan(eq, tuple(a.shape), tuple(b.shape))
        (ea, eb, _), mid = plan.labels, plan.mid
        self.eq, self.mesh, self.given = eq, a.device_mesh, given
        self.shape, self.perm_out = torch.Size(plan.mid_out), plan.perm_out
        self.out, self.grads, self.scale = [], ([], []), 1
        for i in range(self.mesh.ndim):
            ps = (a.placements[i], b.placements[i])
            lab = [_label_on(t, ls, i) for t, ls in ((a, ea), (b, eb))]
            j = 0 if lab[0] is not None else 1
            if any(p.is_partial() for p in ps):
                self.out.append(Partial())
                self.scale *= self.mesh.size(i)
                for k in (0, 1):
                    self.grads[k].append(Replicate() if ps[k].is_partial()
                                         else Partial())
                continue
            if lab[j] is None:
                self.out.append(Replicate())
            elif lab[j] in mid:
                p = ps[j]
                self.out.append(type(p)(mid.index(lab[j]),
                                        split_factor=p.split_factor)
                                if is_strided(p) else Shard(mid.index(lab[j])))
            else:
                self.out.append(Partial())
            if lab[j] is not None:
                self.scale *= self.mesh.size(i)
            for k in (0, 1):
                self.grads[k].append(Partial() if lab[k] is None and
                                     lab[j] is not None else ps[k])

    def product(self, a, b, product):
        from torch.distributed.tensor import DTensor

        from ..analysis.op_cost import scaled
        al, bl = a.to_local(), b.to_local()
        plan = _plan(self.eq, tuple(al.shape), tuple(bl.shape))
        with scaled(self.scale):
            c = product(*plan.operands(al, bl)).view(plan.mid_out)
        return DTensor.from_local(c, self.mesh, self.out, run_check=False,
                                  shape=self.shape, stride=_strides(c))

    def backward(self, g, a, b, needs):
        """The f32 gradients of `a` and `b` (None where not needed) from the
        cotangent `g` of `product`'s result (the output before its
        permutation), as `_Product.backward` computes them: the
        f32 cotangent times the other operand as f32, cast to the
        operand's dtype after its Partial sums are reduced in f32."""
        from torch.distributed.tensor import DTensor, Replicate

        from ..analysis.op_cost import scaled
        g = redistribute(as_dtensor(g, self.mesh), [
            Replicate() if p.is_partial() else p for p in self.out])
        al, bl = a.to_local().float(), b.to_local().float()
        plan = _plan(self.eq, tuple(al.shape), tuple(bl.shape))
        a3, b3 = plan.operands(al, bl)
        g3 = g.to_local().float().reshape(plan.shape_c3)
        out = []
        for k, (t, need) in enumerate(zip((a, b), needs)):
            if not need:
                out.append(None)
                continue
            with scaled(self.scale):
                local = plan.operand_grad(
                    k, g3.matmul(b3.mT) if k == 0 else a3.mT.matmul(g3))
            out.append(_cast_like(DTensor.from_local(
                local.contiguous(), self.mesh, self.grads[k],
                run_check=False, shape=t.shape,
                stride=_strides(t)), (self.given[k], t.dtype)))
        return out


def _placements(*ops):
    return [getattr(t, "placements", None) for t in ops]


def _strides(t):
    """The strides of a contiguous tensor of `t`'s (global) shape."""
    return torch.empty(t.shape, device="meta").stride()


class _ShardProduct(torch.autograd.Function):
    """`_ShardSpec.product` with its gradient (`_ShardSpec.backward`), the
    operands saved ahead of it by `_Operands`, as for `_Product`."""

    @staticmethod
    def forward(ctx, a, b, link, spec, product):
        ctx.link, ctx.spec = link, spec
        return spec.product(a, b, product)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.link[0].saved_tensors
        ga, gb = ctx.spec.backward(g, a, b, ctx.needs_input_grad[:2])
        return ga, gb, None, None, None


def einsum32(eq: str, *ops: torch.Tensor) -> torch.Tensor:
    """einsum with an f32 result: bf16 operands on a card (or on meta) in
    bf16 mode, f32 operands otherwise (module docstring). In exec-safe mode
    a two-operand product whose operand spans devices goes through the
    same lowering (`f32_product`, counted under "f32_lowered"), so that its
    flattens are planned on the layout as the bf16 route's are; plain
    tensors keep `torch.einsum`."""
    if _bf16_route(ops):
        PRODUCTS["bf16"] += 1
        if len(ops) != 2:
            raise ValueError(f"einsum {eq!r}: the bf16 route takes two "
                             f"operands, got {len(ops)}")
        return lowered_einsum(eq, *_gathered(eq, *ops),
                              given=_placements(*ops))
    if len(ops) == 2:
        given, ops = _placements(*ops), _gathered(eq, *ops)
        if spans_devices(ops[0]) or spans_devices(ops[1]):
            PRODUCTS["f32_lowered"] += 1
            return lowered_einsum(eq, upcast(ops[0]), upcast(ops[1]),
                                  f32_product, given)
    PRODUCTS["f32"] += 1
    return torch.einsum(eq, *(upcast(o) for o in ops))


def matmul32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with an f32 result, as `einsum32`."""
    eq = "...k,kn->...n"
    given = _placements(a, b)
    if _bf16_route((a, b)):
        PRODUCTS["bf16"] += 1
        return lowered_einsum(eq, *_gathered(eq, a, b), given=given)
    a, b = _gathered(eq, a, b)
    if spans_devices(a) or spans_devices(b):
        PRODUCTS["f32_lowered"] += 1
        return lowered_einsum(eq, upcast(a), upcast(b), f32_product, given)
    PRODUCTS["f32"] += 1
    return torch.matmul(upcast(a), upcast(b))


def dense(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w with f32 accumulation, output in x.dtype."""
    return matmul32(x, w).to(x.dtype)


def sum_shards(y, rules=NULL_RULES):
    """`y`, a (B, S, D) product's f32 result, with a Partial sum (a
    contraction over a sharded dimension: the heads of an output
    projection, the hidden units of a down projection) reduced in f32
    ahead of its caller's cast, as GSPMD reduces the reference's f32 dot
    ahead of its convert. Where the rules keep the residual stream's
    sequence whole (decode and `NULL_RULES`) that is an all-reduce of f32;
    under a sequence-parallel residual (training, prefill) a
    reduce-scatter of f32 straight onto the residual's layout
    (`rules.resid`, `partial_to_spec`), whose backward gathers the f32
    cotangent. Left alone, DTensor casts each rank's partial sum to bf16
    and sums those. The identity on a plain tensor and on mesh dimensions
    of one device."""
    dims = partial_dims(y)
    if rules.seq_parallel:
        return partial_to_spec(y, dims, rules.resid)
    return partial_to_replicate(y, dims)


@contextlib.contextmanager
def f32_reduction():
    """cuBLAS's bf16 reduced-precision reduction off while the context is
    open, restored after: PyTorch's default lets a GEMM with a bf16 result
    reduce in bf16, where the reference's bf16 dots accumulate in f32."""
    flags = torch.backends.cuda.matmul
    prev = flags.allow_bf16_reduced_precision_reduction
    flags.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        flags.allow_bf16_reduced_precision_reduction = prev


class _Matmul16(torch.autograd.Function):
    """a (..., K) @ b (K, N) with its forward and backward GEMMs under
    `f32_reduction`; the backward is `torch.matmul`'s (a folded to
    (-1, K), `mm`'s gradient, unfolded)."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        with f32_reduction():
            return a @ b

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g2 = g.reshape(-1, g.shape[-1])
        ga = gb = None
        with f32_reduction():
            if ctx.needs_input_grad[0]:
                ga = g2.mm(b.t()).view(a.shape)
            if ctx.needs_input_grad[1]:
                gb = a.reshape(-1, a.shape[-1]).t().mm(g2)
        return ga, gb


def matmul16(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (..., K) @ b (K, N) with a result in the operands' dtype: the
    reference's plain `x @ w` (a bf16 dot there accumulates in f32). On a
    card its GEMMs, backward included, run under `f32_reduction`; on the
    CPU (which reduces bf16 in f32) it is `a @ b`. On a mesh of more than
    one device an FSDP weight is gathered first (`_gathered`): DTensor
    would sum the bf16 products of its contraction shards, where GSPMD
    gathers the weight and the reference's dot accumulates in f32."""
    if spans_devices(a) or spans_devices(b):
        a, b = _gathered("...k,kn->...n", a, b)
    if a.device.type != "cuda":
        return a @ b
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        return _Matmul16.apply(a, b)
    with f32_reduction():
        return a @ b


# A trace that charges a loop's body once, times its trip count, sets this
# to a context-manager factory `hook(n)` (`analysis.op_cost.Tracer`).
_SCAN_HOOK: contextvars.ContextVar = contextvars.ContextVar("scan_hook",
                                                            default=None)


@contextlib.contextmanager
def scan_hook(hook):
    """Run `scan` loops under `hook` while the context is open."""
    token = _SCAN_HOOK.set(hook)
    try:
        yield
    finally:
        _SCAN_HOOK.reset(token)


def scan(step, carry, n: int, dim: int = 0):
    """`jax.lax.scan` as a Python loop: `step(carry, t) -> (carry, y)` for
    t in range(n); returns (the last carry, the ys stacked on `dim`). Under
    a `scan_hook` (the dry-run's trace) the body runs once, inside
    `hook(n)`, which charges its cost n times, and its y stands for every
    step's (same shape and layout, a copy of the one step's)."""
    hook = _SCAN_HOOK.get()
    if hook is None or n <= 1:
        ys = []
        for t in range(n):
            carry, y = step(carry, t)
            ys.append(y)
        return carry, torch.stack(ys, dim=dim)
    with hook(n):
        carry, y = step(carry, 0)
    y = y.unsqueeze(dim)
    return carry, y.expand(*y.shape[:dim], n, *y.shape[dim + 1:]).contiguous()


@functools.lru_cache(maxsize=None)
def _f32(x: float, device) -> torch.Tensor:
    """float32(x) as a 0-d tensor on `device`: a Python scalar as JAX's weak
    type rounds it, and a tensor divisor (PyTorch's CUDA division by a
    Python scalar multiplies by its reciprocal instead). Cached: building a
    CUDA tensor from host data synchronizes with the card, once per layer
    and call otherwise. Built outside inference mode, so that a constant
    first made while serving can still be saved for a backward pass."""
    with torch.inference_mode(False):
        return torch.tensor(np.float32(x), device=device)


def _param(shape, device, dtype=DTYPE) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


def _normal_(p: torch.Tensor, generator: torch.Generator, scale: float):
    """The reference's `_normal`: N(0, 1) in f32, times scale, cast to bf16
    (and on to p's dtype: the MoE router keeps the bf16 draw in f32). From
    a torch.Generator: not `jax.random`'s stream. The f32 draw is scaled in
    place and a bf16 parameter takes it by `copy_` (which rounds as `.to`
    does), so a large tensor's build holds one f32 copy of it and no other
    temporary."""
    draw = torch.randn(p.shape, generator=generator, device=p.device,
                       dtype=torch.float32).mul_(scale)
    p.copy_(draw if p.dtype == DTYPE else draw.to(DTYPE))


# --------------------------------------------------------------------------
# RMSNorm
# --------------------------------------------------------------------------

class RMSNorm(nn.Module):
    def __init__(self, d: int, eps: float = 1e-6, device=None):
        super().__init__()
        self.eps = eps
        self.scale = _param((d,), device)

    def reset_parameters(self, generator=None) -> None:
        with torch.no_grad():
            self.scale.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rms_norm(self.scale, x, self.eps)


def rms_norm(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-6):
    xf = upcast(x)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + _f32(eps, x.device))
    return (y * upcast(scale)).to(x.dtype)


# --------------------------------------------------------------------------
# Rotary position embedding
# --------------------------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 10000.0) -> torch.Tensor:
    """x: (B, S, H, D), positions: (B, S) int."""
    d = x.shape[-1]
    half = d // 2
    dev = x.device
    expo = -torch.arange(0, half, dtype=torch.float32, device=dev) \
        / _f32(half, dev)
    freqs = torch.pow(_f32(theta, dev), expo)
    ang = positions[..., None].float() * freqs                  # (B, S, half)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# Attention (GQA; global or sliding-window; optional logit softcap / bias)
# --------------------------------------------------------------------------

def attn_mask(q_pos: torch.Tensor, kv_pos: torch.Tensor, window: int = 0,
              is_local: Optional[bool] = None) -> torch.Tensor:
    """(B, Sq, Skv) bool. Causal, optionally sliding-window: the window
    applies when `window > 0` and the layer is local (`is_local` True, or
    None for "every layer")."""
    causal = kv_pos[:, None, :] <= q_pos[:, :, None]
    if window <= 0 or is_local is False:
        return causal
    in_win = kv_pos[:, None, :] > (q_pos[:, :, None] - window)
    return causal & in_win


def positions_like(x: torch.Tensor) -> torch.Tensor:
    """(B, S) positions 0..S-1 of x (B, S, ...). For a DTensor x, a DTensor
    sharded like x's batch (replicated elsewhere), so that the masks and
    rope tables built from it are split over the batch, not whole on every
    device."""
    from torch.distributed.tensor import DTensor, Replicate
    b, s = x.shape[:2]
    if not isinstance(x, DTensor):
        return torch.arange(s, device=x.device).expand(b, s)
    pl = [p if p.is_shard(0) else Replicate() for p in x.placements]
    n = 1
    for size, p in zip(x.device_mesh.mesh.shape, pl):
        n *= size if p.is_shard(0) else 1
    local = torch.arange(s, device=x.to_local().device).expand(b // n, s)
    return DTensor.from_local(local, x.device_mesh, pl, run_check=False,
                              shape=torch.Size((b, s)), stride=(0, 1))


# GQA evaluation mode, the reference's: "grouped" computes on the
# (B, S, Hkv, G, D) view (no K/V copy; on DTensors the head split is the
# largest source of views DTensor refuses, ROADMAP Queue 3); "repeat_kv"
# repeats K/V to the full head count first (plain multi-head einsums, G
# times the K/V activation).
GQA_MODE = "grouped"


def set_gqa_mode(mode: str) -> None:
    global GQA_MODE
    assert mode in ("grouped", "repeat_kv")
    GQA_MODE = mode


def gqa_attend(q, k, v, mask, softcap: float = 0.0):
    """q: (B, Sq, Hq, D); k, v: (B, Skv, Hkv, D); mask: (B, Sq, Skv) bool.
    By `GQA_MODE`: grouped evaluation on the (B, S, Hkv, G, D) view, or K/V
    repeated to Hq heads (`jnp.repeat` on the head axis). On DTensors,
    either the keys stay split (`key_split`: a decode step's query against
    the sequence-sharded cache, the form GSPMD gives the reference's) or
    K/V are gathered over their sequence and their head_dim first, as
    GSPMD gathers them for the reference's prefill and training: a
    sequence-sharded K/V would make the softmax gather the scores, S_q
    times larger, and a head_dim-sharded one (where "model" moved off too
    few KV heads onto head_dim) the score product reduce the f32 scores as
    a Partial sum. There q's own head_dim sharding moves onto the query
    sequence (`_onto_queries`) and the output's gradient comes back in the
    output's layout (`held`)."""
    b, sq, hq, d = q.shape
    hkv = k.shape[2]
    split = key_split(q, k, 4 * b * sq * hq * d,
                      2 * k.numel() * k.element_size())
    if split:
        q, mask = split_operands(q, k, mask, split)
        if tuple(v.placements) != tuple(k.placements):
            raise RuntimeError(f"K and V are laid out differently: "
                               f"{k.placements} and {v.placements}")
    else:
        k, v = unshard(k, (1, 3)), unshard(v, (1, 3))
        q = _onto_queries(q, 3)
    g = hq // hkv
    if GQA_MODE == "repeat_kv" and g > 1:
        k = torch.repeat_interleave(k, g, dim=2)
        v = torch.repeat_interleave(v, g, dim=2)
        g, hkv = 1, hq
    scale = _f32(d ** -0.5, q.device)

    def probs_of(scores, m):
        if softcap > 0.0:
            cap = _f32(softcap, q.device)
            scores = cap * torch.tanh(scores / cap)
        scores = torch.where(m, scores, torch.full_like(scores, NEG_INF))
        return softmax_keys(scores, split).to(v.dtype)

    # split keys: the value product is a Partial sum there, reduced once in
    # f32 before the cast
    if g == 1:
        probs = probs_of(einsum32("bqhd,bkhd->bhqk", q, k) * scale,
                         mask[:, None, :, :])
        out = partial_to_replicate(einsum32("bhqk,bkhd->bqhd", probs, v),
                                   split)
        return held(out.to(v.dtype))
    qg = _split_heads(q, hkv, g)
    probs = probs_of(einsum32("bqhgd,bkhd->bhgqk", qg, k) * scale,
                     mask[:, None, None, :, :])
    out = partial_to_replicate(einsum32("bhgqk,bkhd->bqhgd", probs, v),
                               split)
    return held(out.reshape(b, sq, hq, d).to(v.dtype))


# --------------------------------------------------------------------------
# Attention over a sequence-sharded K/V, its keys kept split
# --------------------------------------------------------------------------

def key_split(q, k, out_bytes: int, kv_bytes: int):
    """The mesh dimensions over which attention keeps the keys of `k`
    (dimension 1, the sequence) split, or () where it gathers them: split
    when they span more than one device, the query's sequence is not
    sharded, and the attention's f32 output (`out_bytes`), which the split
    form reduces, is smaller than the keys and values (`kv_bytes`), which
    the other gathers. That is a decode step's query against the
    sequence-sharded cache (and its cross-attention against the encoder's
    memory); prefill and training, whose query is as long as the keys,
    gather K/V whole (their sequence and their head_dim), as GSPMD does
    with the reference's."""
    from ..parallel.sharding import split_dims
    dims = split_dims(k, 1)
    if not dims or split_dims(q, 1) or out_bytes >= kv_bytes:
        return ()
    return dims


def split_operands(q, k, mask, split):
    """(q, mask) laid out for attention against `k`'s keys split over mesh
    dimensions `split`: q replicated over them (gathered, where its heads
    or head dimension were sharded there: a decode query is small), its
    other placements kept; the (B, Sq, Skv) mask (None passes through)
    sharded along its keys as `k` is (a plain mask is split locally, with
    no collective) and along its batch where `k`'s batch is."""
    from torch.distributed.tensor import Replicate, Shard

    from ..parallel.sharding import as_dtensor, redistribute, sharded_dim
    mesh = k.device_mesh
    q = as_dtensor(q, mesh)
    q = redistribute(q, [Replicate() if i in split else p
                         for i, p in enumerate(q.placements)])
    target = []
    for i, p in enumerate(k.placements):
        if i in split:
            target.append(type(p)(2, split_factor=p.split_factor)
                          if is_strided(p) else Shard(2))
        elif sharded_dim(p) == 0:
            target.append(p)
        else:
            target.append(Replicate())
    if mask is None:
        return q, None
    return q, redistribute(as_dtensor(mask, mesh), target)


def softmax_keys(scores, split=()):
    """Softmax over the last dimension (the keys). Plain (`split` empty):
    `torch.softmax`. Keys split over mesh dimensions `split`: the
    reference's `exp(s - max) / sum`, the max and the sum taken over each
    shard's keys and reduced across the shards as a Partial("max") and a
    Partial("sum") (all-reduces of the (..., 1) local shape), so that the
    scores are never gathered."""
    if not split:
        return torch.softmax(scores, dim=-1)
    from ..parallel.sharding import reduced_over, sharded_dim
    if not all(sharded_dim(scores.placements[i]) == scores.ndim - 1
               for i in split):
        raise RuntimeError(f"expected the keys split over mesh dimensions "
                           f"{tuple(split)}, got {tuple(scores.placements)}")
    mx = reduced_over(scores.to_local().amax(-1, keepdim=True), scores,
                      split, "max")
    e = torch.exp(scores - mx)
    return e / reduced_over(e.to_local().sum(-1, keepdim=True), e, split,
                            "sum")


def attention_specs(rules):
    return {"wq": rules.w_qkv, "wk": rules.w_qkv, "wv": rules.w_qkv,
            "wo": rules.w_out, "bq": rules.b_model, "bk": rules.replicated,
            "bv": rules.replicated}


class _Held(torch.autograd.Function):
    """The identity, its gradient redistributed onto the forward's
    placements (`held`; a Partial one's gradient is replicated)."""

    @staticmethod
    def forward(ctx, t):
        from torch.distributed.tensor import Replicate
        ctx.placements = tuple(Replicate() if p.is_partial() else p
                               for p in t.placements)
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        if not is_dtensor(g) or partial_dims(g):
            return g
        return redistribute(g, ctx.placements)


def held(t):
    """`t`, whose gradient comes back in `t`'s own placements: the
    identity on a plain tensor, on a mesh of one device and without a
    gradient. The attention's output is held so: DTensor lays out the
    output projection's input gradient as its `mm` strategies fall (over
    the heads, for a replicated cotangent), and where `_split_heads` moved
    q's heads onto the query sequence the softmax's backward then gathers
    the f32 cotangent of the probabilities, (B, Hkv, G, Sq, Skv) whole."""
    if not (spans_devices(t) and t.requires_grad and torch.is_grad_enabled()):
        return t
    return _Held.apply(t)


def _onto_queries(q, dim: int):
    """(B, Sq, ...) `q` with the mesh dimensions that shard its dimension
    `dim` sharding the query sequence instead where they divide it (an
    all-to-all; the scores then stay split along the queries), else
    gathered: the identity where `dim` is whole."""
    if not spans_devices(q):
        return q
    n = shard_count(q.device_mesh, q.placements, dim)
    if n == 1:
        return q
    return move_shards(q, dim, 1) if q.shape[1] % n == 0 \
        else unshard(q, (dim,))


def _split_heads(q, hkv: int, g: int):
    """(B, S, Hkv G, D) -> (B, S, Hkv, G, D). DTensor can split a sharded
    dimension only along its leading factor: a head axis sharded over more
    devices than Hkv divides into moves its sharding to the query sequence
    (then the scores stay split), or, when that does not divide either (a
    decode step), is gathered."""
    if spans_devices(q) and hkv % shard_count(q.device_mesh, q.placements, 2):
        q = _onto_queries(q, 2)
    b, sq, _, d = q.shape
    return q.reshape(b, sq, hkv, g, d)


class Attention(nn.Module):
    """GQA attention parameters: wq (d, H, Dh), wk/wv (d, Hkv, Dh),
    wo (H, Dh, d), and with `qkv_bias` bq (H, Dh), bk/bv (Hkv, Dh)."""

    def __init__(self, cfg, device=None):
        super().__init__()
        d, dh = cfg.d_model, cfg.resolved_head_dim
        self.wq = _param((d, cfg.n_heads, dh), device)
        self.wk = _param((d, cfg.n_kv_heads, dh), device)
        self.wv = _param((d, cfg.n_kv_heads, dh), device)
        self.wo = _param((cfg.n_heads, dh, d), device)
        self.has_bias = bool(cfg.qkv_bias)
        if self.has_bias:
            self.bq = _param((cfg.n_heads, dh), device)
            self.bk = _param((cfg.n_kv_heads, dh), device)
            self.bv = _param((cfg.n_kv_heads, dh), device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        d, h, dh = self.wq.shape
        with torch.no_grad():
            _normal_(self.wq, generator, d ** -0.5)
            _normal_(self.wk, generator, d ** -0.5)
            _normal_(self.wv, generator, d ** -0.5)
            _normal_(self.wo, generator, (h * dh) ** -0.5)
            if self.has_bias:
                for b in (self.bq, self.bk, self.bv):
                    b.zero_()

    def project_kv(self, cfg, x, positions):
        """K/V for cache population (prefill) or appending (decode)."""
        k = einsum32("bsd,dhk->bshk", x, self.wk).to(x.dtype)
        v = einsum32("bsd,dhk->bshk", x, self.wv).to(x.dtype)
        if self.has_bias:
            k = k + self.bk
            v = v + self.bv
        return rope(k, positions, cfg.rope_theta), v

    def forward(self, cfg, x, positions, *, kv=None, kv_positions=None,
                is_local: Optional[bool] = None, causal: bool = True,
                rules=NULL_RULES):
        """Self-attention over x, or attention against the given (k, v)
        (decode: the whole cache, `kv_positions` masking unwritten slots);
        `causal=False` is the encoder's bidirectional attention over the
        valid (non-negative) positions."""
        q = einsum32("bsd,dhk->bshk", x, self.wq).to(x.dtype)
        if self.has_bias:
            q = q + self.bq
        q = shard(rope(q, positions, cfg.rope_theta), rules.heads)
        if kv is None:
            k, v = self.project_kv(cfg, x, positions)
            kv_spec = getattr(rules, "kv_heads", None) or rules.heads
            k, v = shard(k, kv_spec), shard(v, kv_spec)
            kv_positions = positions
        else:
            k, v = kv
        if causal:
            mask = attn_mask(positions, kv_positions, cfg.sliding_window,
                             is_local)
        else:
            mask = (kv_positions >= 0)[:, None, :].expand(
                x.shape[0], x.shape[1], kv_positions.shape[1])
        out = gqa_attend(q, k, v, mask, cfg.attn_logit_softcap)
        return sum_shards(einsum32("bshk,hkd->bsd", out, self.wo),
                          rules).to(x.dtype)


# --------------------------------------------------------------------------
# Gated MLP (SwiGLU / GeGLU)
# --------------------------------------------------------------------------

def mlp_specs(rules):
    return {"wi": rules.w_col, "wg": rules.w_col, "wo": rules.w_row}


class MLP(nn.Module):
    def __init__(self, d: int, d_ff: int, act: str = "silu", device=None):
        super().__init__()
        self.act = act
        self.wi = _param((d, d_ff), device)
        self.wg = _param((d, d_ff), device)
        self.wo = _param((d_ff, d), device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        d, d_ff = self.wi.shape
        with torch.no_grad():
            _normal_(self.wi, generator, d ** -0.5)
            _normal_(self.wg, generator, d ** -0.5)
            _normal_(self.wo, generator, d_ff ** -0.5)

    def forward(self, x: torch.Tensor, rules=NULL_RULES) -> torch.Tensor:
        h = shard(dense(x, self.wi), rules.ffn_hidden)
        g = dense(x, self.wg)
        # gelu is PyTorch's tanh form, not jax.nn.gelu op for op: no
        # ported config uses it
        a = (silu(g) if self.act == "silu"
             else torch.nn.functional.gelu(g, approximate="tanh"))
        y = h * a
        return sum_shards(matmul32(y, self.wo), rules).to(y.dtype)


def silu(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.silu` op for op in x's dtype: x * (1 / (1 + exp(-x))), each
    step rounded to bf16 as XLA does (a fused f32 silu rounds once and
    differs in about a third of the bf16 outputs)."""
    return x * sigmoid(x)


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.sigmoid` as XLA expands it: 1 / (1 + exp(-x)) in x's
    dtype."""
    return 1.0 / (torch.exp(-x) + 1.0)


# --------------------------------------------------------------------------
# Embedding + LM head
# --------------------------------------------------------------------------

class Embedding(nn.Module):
    def __init__(self, vocab: int, d: int, device=None):
        super().__init__()
        self.table = _param((vocab, d), device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            _normal_(self.table, generator, 0.02)


def embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return table[tokens.long()]


def unembed(table: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(B, S, D) -> f32 logits (B, S, V) against the (possibly tied)
    table."""
    return einsum32("bsd,vd->bsv", x, table)


# Gold-logit extraction, the reference's: "gather" takes logits[target];
# "onehot" sums logits where the vocabulary id equals the target (one
# nonzero term: the same value), which keeps a vocabulary-sharded DTensor
# sharded (a partial sum, then a reduction) where a gather needs it whole.
XENT_MODE = "gather"


def set_xent_mode(mode: str) -> None:
    global XENT_MODE
    assert mode in ("gather", "onehot")
    XENT_MODE = mode


def _gold(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """logits[..., target], by `XENT_MODE`. On a DTensor in "gather" mode:
    the vocabulary gathered, then the masked sum over it (which picks the
    same value exactly) — DTensor zero-fills a gather's gradient as a
    full-size replicated tensor (`new_zeros` has no sharded strategy),
    where the mask keeps the batch's sharding."""
    from torch.distributed.tensor import DTensor
    if XENT_MODE != "onehot":
        if not isinstance(logits, DTensor):
            return torch.gather(logits, -1, targets[..., None])[..., 0]
        logits = unshard(logits, (-1,))
    vocab = torch.arange(logits.shape[-1], device=logits.device)
    hit = vocab == targets[..., None]
    return torch.where(hit, logits, torch.zeros((), device=logits.device)
                       ).sum(-1)


def softmax_xent(logits: torch.Tensor, targets: torch.Tensor,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean next-token cross-entropy of f32 logits (B, S, V) against int
    targets (B, S); with `mask`, the mean over its nonzero positions. The
    gold logit by `XENT_MODE` (`_gold`)."""
    logz = torch.logsumexp(logits, dim=-1)
    nll = logz - _gold(logits, targets.long())
    if mask is None:
        return torch.mean(nll)
    mask = mask.float()
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
