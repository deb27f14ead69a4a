"""Logical-axis -> mesh-axis rule tables and their DTensor placements.

Counterpart of ``repro/distributed/sharding.py``.  Profiles:

  train  — FSDP over the dp axes (embed dims of every weight) + Megatron TP
           over "model" (heads / mlp / vocab / experts).  MoE expert
           weights FSDP on their embed dim (gathered per layer inside the
           sharded MoE block).
  serve  — weights stay maximally sharded; MoE expert weights shard their
           *mlp* dim over dp instead (stationary weights, token_gather
           mode), KV caches shard batch over dp and heads over model.

The rules map each logical axis name of the models' parameter specs to a
mesh axis (or a tuple of them, or None), and :func:`_spec_for` turns a
leaf's axes into a spec: a tuple with, for each tensor dim, None, the
mesh axis it is split over, or a tuple of several, as ``jax``'s
``PartitionSpec`` holds them.
:func:`placements` maps a spec to the ``DTensor`` placements of a
``DeviceMesh`` (a dim split over ``("pod", "data")`` is ``Shard(d)`` on
both mesh dims, in mesh order), so a rank's shard is the one ``jax``'s
``NamedSharding`` gives it.  ``param_shardings``, ``batch_shardings`` and
``cache_shardings`` give ``(mesh, placements)`` a leaf; every sharded dim
must divide evenly (``resolve_for_mesh`` pads the model's dims so that
they do).  A mesh here is anything with ``mesh_dim_names`` (a
``DeviceMesh``) or ``axis_names``.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from ..models.common import ShardCtx
from ..tree import map_tree

__all__ = ["make_rules", "param_shardings", "batch_shardings",
           "cache_shardings", "make_ctx", "dp_axes_of", "placements",
           "local_shard", "distribute", "to_dtensor", "wrap_local",
           "spec_tree", "cache_specs", "local_at", "local_call", "spec_of"]

Spec = Tuple[object, ...]


def axis_names(mesh) -> Tuple[str, ...]:
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names if names is not None else mesh.axis_names)


def dp_axes_of(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in axis_names(mesh))


def make_rules(profile: str, mesh,
               kv_heads_sharded: bool = True) -> Dict[str, object]:
    dp = dp_axes_of(mesh)
    fsdp = dp if len(dp) == 1 else dp          # ("data",) or ("pod","data")
    common = {
        "layers": None, "head": None, "conv": None, "state": None,
        "dt": None, "vocab": "model",
        "q_heads": "model",
        # kv_shard="seq": unpadded kv heads replicate over model
        "kv_heads": "model" if kv_heads_sharded else None,
        "mlp": "model",
        "inner": "model", "inner2": "model",
        "expert": "model",
    }
    if profile == "train":
        return {**common, "embed": fsdp,
                "expert_embed": fsdp, "expert_mlp": None}
    if profile == "serve":
        return {**common, "embed": fsdp,
                "expert_embed": None, "expert_mlp": fsdp}
    if profile == "serve_wstation":
        # weight-stationary decode: no FSDP on dense weights (a TP-sharded
        # replica per data row); experts stay fully sharded via
        # (expert->model, expert_mlp->dp) inside the token_gather block
        return {**common, "embed": None,
                "expert_embed": None, "expert_mlp": fsdp}
    raise ValueError(profile)


def _spec_for(axes: Tuple[Optional[str], ...], rules) -> Spec:
    used = set()
    parts = []
    for a in axes:
        r = rules.get(a) if a else None
        # a mesh axis may appear only once per spec
        key = tuple(r) if isinstance(r, (tuple, list)) else (r,)
        if r is None or any(k in used for k in key):
            parts.append(None)
        else:
            used.update(key)
            # one axis is named bare, as PartitionSpec normalizes it
            parts.append(_one(key))
    return tuple(parts)


def _one(axes: Tuple[str, ...]):
    """A spec entry: one axis bare, several as a tuple."""
    return axes if len(axes) > 1 else axes[0]


def _part_axes(part) -> Tuple[str, ...]:
    if part is None:
        return ()
    return tuple(part) if isinstance(part, (tuple, list)) else (part,)


def placements(spec: Sequence, mesh) -> tuple:
    """The DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on
    each mesh dim that tensor dim ``d`` is split over, ``Replicate()`` on
    the others.  A dim split over several mesh axes names them in mesh
    order, as DTensor splits them (the first one major)."""
    names = axis_names(mesh)
    out = [Replicate()] * len(names)
    for d, part in enumerate(spec):
        axes = _part_axes(part)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: dim {d} splits over {axes}, "
                             f"not in the mesh's order {names}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


def spec_of(t) -> Spec:
    """The spec of DTensor ``t``, one entry a dim: the mesh axes that
    split it, in mesh order (the inverse of :func:`placements`)."""
    spec = [()] * t.dim()
    for name, pl in zip(axis_names(t.device_mesh), t.placements):
        if isinstance(pl, Shard):
            spec[pl.dim % t.dim()] += (name,)
        elif not isinstance(pl, Replicate):
            raise ValueError(f"placements {t.placements} hold a pending "
                             "reduction")
    return tuple(spec)


def _ways(mesh, part) -> int:
    names = axis_names(mesh)
    n = 1
    for a in _part_axes(part):
        n *= mesh.size(names.index(a))
    return n


def _check_divides(shape: Sequence[int], spec: Spec, mesh) -> None:
    for d, part in enumerate(spec):
        n = _ways(mesh, part)
        if shape[d] % n:
            raise ValueError(f"dim {d} of {tuple(shape)} does not divide "
                             f"over {part} ({n} ways): pad it "
                             "(resolve_for_mesh)")


def local_shard(t: torch.Tensor, mesh, spec: Spec) -> torch.Tensor:
    """This rank's shard of ``t`` under ``spec`` on ``mesh``.  A plain
    tensor is the global value (the same on every rank): its shard is a
    view.  A DTensor gives its local tensor, redistributed first where its
    placements are not ``spec``'s."""
    if isinstance(t, DTensor):
        want = placements(spec, mesh)
        if tuple(t.placements) != want:
            t = t.redistribute(mesh, want)
        return t.to_local()
    _check_divides(t.shape, spec, mesh)
    names = axis_names(mesh)
    for d, part in enumerate(spec):
        axes = _part_axes(part)
        if not axes:
            continue
        idx, n = 0, 1
        for a in axes:
            size = mesh.size(names.index(a))
            idx, n = idx * size + mesh.get_local_rank(a), n * size
        step = t.shape[d] // n
        t = t.narrow(d, idx * step, step)
    return t


def _contiguous_stride(shape) -> tuple:
    stride, n = [], 1
    for size in reversed(tuple(shape)):
        stride.insert(0, n)
        n *= size
    return tuple(stride)


def wrap_local(local: torch.Tensor, mesh, spec: Spec, shape) -> DTensor:
    """This rank's shard ``local`` of a global tensor of ``shape`` placed
    as ``spec`` on ``mesh``, as a DTensor (no communication): the
    counterpart of ``shard_map`` 's out_specs."""
    return DTensor.from_local(local, mesh, placements(spec, mesh),
                              run_check=False, shape=torch.Size(shape),
                              stride=_contiguous_stride(shape))


def local_at(t: torch.Tensor, mesh, pls) -> torch.Tensor:
    """The local shard of ``t`` (a DTensor, or a plain tensor holding the
    global value, as every rank does) at placements ``pls``."""
    if not isinstance(t, DTensor):
        t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    return t.redistribute(mesh, pls).to_local()


def local_call(mesh, fn, ins, out_spec, shape=None, partial=()):
    """``shard_map`` for one function: each ``(tensor, spec)`` of ``ins``
    (a DTensor or a plain global tensor; None passes through) is
    redistributed to its spec and cut to this rank's shard, ``fn`` runs on
    the shards, and its result, this rank's shard of a global tensor
    placed as ``out_spec``, comes back as a DTensor.  ``shape``: the
    global shape (None: every sharded dim even).  ``partial``: mesh axes
    over which the result is a pending sum (a row-parallel product).  A
    function of several results takes a list of specs (and of shapes and
    of partial axes)."""
    locs = [None if t is None else local_at(t, mesh, placements(s, mesh))
            for t, s in ins]
    out = fn(*locs)
    if isinstance(out_spec, list):
        n = len(out)
        return tuple(_wrap_out(*a) for a in zip(
            out, [mesh] * n, out_spec, shape or [None] * n,
            partial or [()] * n))
    return _wrap_out(out, mesh, out_spec, shape, partial)


def _wrap_out(out, mesh, spec, shape, partial) -> DTensor:
    if shape is None:
        shape = [n * _ways(mesh, part) for n, part in
                 zip(out.shape, tuple(spec) + (None,) * out.dim())]
    if not partial:
        return wrap_local(out, mesh, spec, shape)
    pls = list(placements(spec, mesh))
    for a in partial:
        pls[axis_names(mesh).index(a)] = Partial()
    return DTensor.from_local(out, mesh, pls, run_check=False,
                              shape=torch.Size(shape),
                              stride=_contiguous_stride(shape))


def to_dtensor(t: torch.Tensor, mesh, spec: Spec) -> DTensor:
    """The global tensor ``t`` (the same on every rank) as a DTensor on
    ``mesh`` that holds only this rank's shard, taken without
    communication.  A shard smaller than ``t`` is copied out, so that the
    global tensor's storage can go; a whole one is kept as it is."""
    local = local_shard(t, mesh, spec)
    if local.numel() < t.numel():
        local = local.clone(memory_format=torch.contiguous_format)
    return wrap_local(local, mesh, spec, t.shape)


def distribute(t: torch.Tensor, target) -> DTensor:
    """``t`` onto a ``(mesh, placements)`` target, as ``jax.device_put``
    onto a ``NamedSharding``; every sharded dim must divide evenly."""
    from torch.distributed.tensor import distribute_tensor
    mesh, pls = target
    for i, p in enumerate(pls):
        if isinstance(p, Shard) and t.shape[p.dim] % mesh.size(i):
            raise ValueError(f"dim {p.dim} of {tuple(t.shape)} does not "
                             f"divide over mesh dim {i} ({mesh.size(i)})")
    return distribute_tensor(t, mesh, list(pls))


def spec_tree(specs, mesh, rules) -> dict:
    """The spec (a tuple, one entry a dim) of every leaf of a spec tree
    (``P`` leaves, ``param_specs``) under ``rules``."""
    def leaf(p):
        spec = _spec_for(p.axes, rules)
        _check_divides(p.shape, spec, mesh)
        return spec
    return map_tree(leaf, specs)


def param_shardings(specs, mesh, rules) -> dict:
    """``(mesh, placements)`` for every leaf of a spec tree (``P`` leaves,
    ``param_specs``)."""
    return map_tree(lambda spec: (mesh, placements(spec, mesh)),
                    spec_tree(specs, mesh, rules))


def batch_shardings(mesh, batch_abstract, batch_sharded: bool = True
                    ) -> dict:
    """Inputs: shard dim0 (batch) over the dp axes."""
    dp = dp_axes_of(mesh)
    spec_b = (_one(dp),) if (batch_sharded and dp) else ()

    def leaf(x):
        nd = len(x.shape)
        spec = () if nd == 0 else spec_b + (None,) * (nd - len(spec_b))
        _check_divides(x.shape, spec, mesh)
        return mesh, placements(spec, mesh)

    return map_tree(leaf, batch_abstract)


def _map_with_name(fn, tree, name: str = ""):
    if isinstance(tree, dict):
        return {k: _map_with_name(fn, tree[k], str(k)) for k in sorted(tree)}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_with_name(fn, v, str(i))
                          for i, v in enumerate(tree))
    return fn(name, tree)


def cache_spec(name: str, nd: int, b, kv_shard: str = "heads") -> Spec:
    """A decode-cache leaf's spec by its name; leaves have a leading
    (layers, batch, ...) pair.

      k/v   (L,B,S,H,Dh)   heads -> model    (kv_shard="heads"; kv padded)
                           or S -> model     (kv_shard="seq")
      pos   (L,B,S)
      xk/xv (L,B,S,H,Dh)   heads -> model
      h     (L,B,di,N)     di -> model          (ssm state)
      conv  (L,B,K,di)     di -> model
      s     (L,B,H,Dk,Dv)  heads -> model       (rwkv state)
      tm_last/cm_last (L,B,1,D)
    """
    if name in ("k", "v", "xk", "xv"):
        spec = ((None, b, "model", None, None) if kv_shard == "seq"
                else (None, b, None, "model", None))
    elif name == "pos":
        spec = (None, b, "model") if kv_shard == "seq" else (None, b, None)
    elif name == "h":
        spec = (None, b, "model", None)
    elif name == "conv":
        spec = (None, b, None, "model")
    elif name == "s":
        spec = (None, b, "model", None, None)
    elif name in ("tm_last", "cm_last"):
        spec = (None, b, None, None)
    else:
        spec = (None,) * nd
    assert len(spec) == nd, (name, nd, spec)
    return spec


def cache_specs(mesh, cache_abstract, batch_sharded: bool = True,
                kv_shard: str = "heads") -> dict:
    """The decode cache's spec a leaf, by leaf name (:func:`cache_spec`)."""
    dp = dp_axes_of(mesh)
    b = _one(dp) if (batch_sharded and dp) else None

    def leaf(name, x):
        spec = cache_spec(name, len(x.shape), b, kv_shard)
        _check_divides(x.shape, spec, mesh)
        return spec

    return _map_with_name(leaf, cache_abstract)


def cache_shardings(mesh, cache_abstract, batch_sharded: bool = True,
                    kv_shard: str = "heads") -> dict:
    """The decode cache's ``(mesh, placements)`` a leaf, by leaf name
    (:func:`cache_spec`)."""
    return map_tree(lambda spec: (mesh, placements(spec, mesh)),
                    cache_specs(mesh, cache_abstract, batch_sharded,
                                kv_shard))


def make_ctx(mesh, batch_sharded: bool = True) -> ShardCtx:
    if mesh is None:
        return ShardCtx()
    return ShardCtx(mesh=mesh, dp_axes=dp_axes_of(mesh), tp_axis="model",
                    batch_sharded=batch_sharded)
