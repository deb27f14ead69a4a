"""What one call of a step runs: FLOPs, bytes and collective bytes.

Counterpart of ``repro/roofline/hlo_costs.py``.  :class:`OpCosts` is a
``TorchDispatchMode``: inside ``with OpCosts() as c:`` every ATen op that
reaches the dispatcher is run and counted.  The step runs eagerly, so
every layer is counted where it runs and no loop trip count enters.

  * FLOPs: matrix-product ops only (``mm``, ``addmm``, ``bmm``,
    ``baddbmm``), 2·M·N·K by ``torch.utils.flop_counter``'s formulas, as
    the reference counts only ``dot``s.
  * Bytes: each materialised op's operands read (an expanded operand at
    its unexpanded size) plus its result written; a gather (embedding,
    index, index_select) reads only the rows it writes.  Views count 0, as
    do allocations (the counterpart of ``_NO_MATERIALIZE``).  A composite
    op is counted as the ops it decomposes into.  An in-place or
    ``out=`` op counts the bytes it writes, never its whole destination:
    ``index_put_``/``index_copy_``/``scatter_`` into a cache write their
    rows, ``copy_`` into a slice writes the slice and reads only its
    source.
  * Collective bytes by kind, from the ``c10d.*`` and
    ``_c10d_functional.*`` ops, under the reference's names
    (``all-gather``, ``all-reduce``, ``reduce-scatter``, ``all-to-all``,
    ``collective-permute`` for send/recv; ``broadcast`` beside them): the
    bytes of each one's result, as the reference takes the result shape.
  * The port's CUDA kernels launch through ``ctypes``, which the
    dispatcher never sees: each wrapper reports its work
    (:func:`report_kernel`, with the formulas of ``bounds.py``), which
    adds its bytes to ``bytes`` and its elementwise operations to
    ``kernel_ops`` (not to the matrix FLOPs).

A count is one rank's.  The mode passes every op on a ``DTensor`` on to
DTensor (``NotImplemented``), which runs it as local ops and collectives
on the rank's shards: those are what it counts.  DTensor's sharding
propagation also runs ops, at the global shapes, on fake tensors of a fake
mode of its own: an op on a fake tensor is counted only when the tensor
belongs to the counter's ``fake_mode`` (the dry run's), so those never
are.

With ``where=True`` it also keeps ``rows``: bytes and calls by (kind,
where), ``kind`` the aten op, the kernel or the collective (under the
reference's names) and ``where`` the function of the port that ran it;
``python -m repro_torch.analysis --hlo`` ranks them.

Inside ``with scaled(n):`` every count is taken n times: a loop whose
trips run the same ops at the same shapes on tensors without data (the
dry run's recurrent chunks, ``models/ssm.py::chunked``) runs one trip
there, as the reference's cost analysis scales a loop's body by its trip
count.  ``scale_nodes`` does the same for that trip's autograd nodes, so
that its backward (and a checkpoint's recompute) is counted n times too.

``peak_bytes`` is the high-water mark of the live bytes of the results it
counted (each released when its tensor is: a weak reference a result),
the eager counterpart of a compiler's temporary bytes.
"""

from __future__ import annotations

import collections
import contextlib
import weakref
from typing import Dict, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

__all__ = ["OpCosts", "report_kernel", "counting", "counting_fakes",
           "node_mark",
           "scale_nodes", "scaled"]

aten = torch.ops.aten

#: the counters in force, innermost last
_ACTIVE: List["OpCosts"] = []
#: the trip count that every count is taken times (``scaled``)
_SCALE = [1]
#: autograd node (by sequence number) -> the times its backward counts
_NODE_SCALE: Dict[int, int] = {}

_MATMULS = {aten.mm, aten.addmm, aten.bmm, aten.baddbmm}
# views the schema may not mark as aliasing, and ops that move no data
_ZERO = {aten.empty, aten.empty_like, aten.empty_strided, aten.new_empty,
         aten.new_empty_strided, aten.lift_fresh, aten.detach, aten.alias,
         aten._unsafe_view, aten.t, aten.transpose, aten.permute,
         aten.expand, aten.slice, aten.select, aten.unsqueeze, aten.squeeze,
         aten.as_strided, aten.view, aten.resize_, aten.set_,
         aten.record_stream}
_ALLOC = {aten.empty, aten.empty_like, aten.empty_strided, aten.new_empty,
          aten.new_empty_strided}
# in-place ops whose destination is written without being read
_WRITE_ONLY = {aten.copy_, aten.fill_, aten.zero_, aten.normal_,
               aten.uniform_, aten.random_, aten.exponential_,
               aten.bernoulli_}
# in-place ops that write only the rows their index names
_ROWS = {aten.index_copy_, aten.index_add_, aten.index_reduce_,
         aten.index_put_, aten._index_put_impl_, aten.scatter_,
         aten.scatter_add_, aten.scatter_reduce_, aten.put_}
_ACCUMULATE = {aten.index_add_, aten.index_reduce_, aten.scatter_add_,
               aten.scatter_reduce_}
# ops that read only the rows their index names
_GATHERS = {aten.embedding, aten.index_select, aten.gather, aten.index,
            aten.take}


def _caller() -> str:
    """The innermost function of the port's model, train or serve code on
    the stack, as ``file.py:function`` (past the kernels, the activation
    bundle, the hints and the placement helpers)."""
    import sys
    f = sys._getframe(2)
    while f is not None:
        name = f.f_code.co_filename.replace("\\", "/")
        if "/repro_torch/" in name and not any(
                k in name for k in _PASS_THROUGH):
            return f"{name.rsplit('/', 1)[-1]}:{f.f_code.co_name}"
        f = f.f_back
    return ""


_PASS_THROUGH = ("/roofline/", "/kernels/", "/distributed/",
                 "/models/activations.py", "/models/common.py")


def _dtensor():
    from torch.distributed.tensor import DTensor
    return DTensor


@contextlib.contextmanager
def scaled(n: int):
    """Within the block every count is taken ``n`` times (nested blocks
    multiply)."""
    _SCALE.append(_SCALE[-1] * n)
    try:
        yield
    finally:
        _SCALE.pop()


def _scale() -> int:
    n = _SCALE[-1]
    if _NODE_SCALE:
        node = torch._C._current_autograd_node()
        if node is not None:
            n *= _NODE_SCALE.get(node._sequence_nr(), 1)
    return n


def node_mark() -> int:
    """The sequence number the next autograd node will get."""
    return torch._C._autograd._get_sequence_nr()


def scale_nodes(outputs, mark: int, n: int) -> None:
    """Count ``n`` times the backward of every autograd node made since
    ``mark`` (``node_mark``) on the way to ``outputs`` (a trip run once for
    ``n``, ``scaled``)."""
    todo = [t.grad_fn for t in outputs
            if isinstance(t, torch.Tensor) and t.grad_fn is not None]
    seen = set()
    while todo:
        node = todo.pop()
        if node is None or type(node).__name__ == "AccumulateGrad":
            continue
        nr = node._sequence_nr()
        if nr < mark or nr in seen:
            continue
        seen.add(nr)
        _NODE_SCALE[nr] = n
        todo.extend(f for f, _ in node.next_functions)


def counting_fakes() -> bool:
    """Whether a counter of fake tensors (the dry run's) is in force."""
    return any(c.fake_mode is not None for c in _ACTIVE)


def counting() -> bool:
    """Whether an ``OpCosts`` counter is in force (kernels report only
    then)."""
    return bool(_ACTIVE)


def report_kernel(name: str, shape, work, **info) -> None:
    """A CUDA kernel's launch at input ``shape``: ``work`` = (bytes, int32
    operations, float32 operations) by the formulas of ``bounds.py``;
    ``info`` names what else entered them (dtype, table, mask)."""
    for c in _ACTIVE:
        c._kernel(name, tuple(shape), work, info)


def _read_bytes(t: torch.Tensor) -> int:
    """A tensor's bytes at its unexpanded size (broadcast dims, of stride
    0, read once)."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size()


def _tensors(x) -> list:
    return [t for t in tree_leaves(x) if isinstance(t, torch.Tensor)]


def _nbytes(x) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(x))


def _coll_kind(name: str):
    for keys, kind in ((("allreduce", "all_reduce"), "all-reduce"),
                       (("allgather", "all_gather"), "all-gather"),
                       (("reduce_scatter",), "reduce-scatter"),
                       (("alltoall", "all_to_all"), "all-to-all"),
                       (("recv",), "collective-permute"),
                       (("broadcast",), "broadcast")):
        if any(k in name for k in keys):
            return kind
    return None         # send (its recv counts), barrier, wait_tensor


class OpCosts(TorchDispatchMode):
    """Counts the ops run inside ``with OpCosts() as c:`` (module
    docstring): ``flops``, ``bytes``, ``coll_bytes`` by kind,
    ``kernel_ops`` by kernel ({"int32", "float32"}), ``kernels`` (every
    reported launch: kernel, shape, bytes, operations and what else
    entered the formula) and ``op_bytes`` (bytes by op, to see where they
    go).  ``fake_mode``: the fake mode whose tensors are counted (None:
    no fake tensor is)."""

    def __init__(self, fake_mode=None, where: bool = False):
        super().__init__()
        self.fake_mode = fake_mode
        self.where = where
        #: (collective?, kind, where) -> [bytes, calls]
        self.rows: Dict[tuple, list] = {}
        self.live_bytes = 0
        self.peak_bytes = 0
        self._seen: "weakref.WeakSet" = weakref.WeakSet()
        self.flops = 0
        self.bytes = 0
        self.coll_bytes: Dict[str, int] = collections.Counter()
        self.kernel_ops: Dict[str, Dict[str, float]] = {}
        self.kernels: List[dict] = []
        self.op_bytes: Dict[str, int] = collections.Counter()

    def __enter__(self):
        _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            _ACTIVE.remove(self)

    def _kernel(self, name, shape, work, info) -> None:
        n = _scale()
        nbytes, int_ops, fp_ops = (n * w for w in work)
        self.bytes += nbytes
        self.op_bytes[name] += nbytes
        self._row(False, name, nbytes)
        ops = self.kernel_ops.setdefault(name, {"int32": 0, "float32": 0})
        ops["int32"] += int_ops
        ops["float32"] += fp_ops
        self.kernels.extend(
            dict(kernel=name, shape=shape, bytes=nbytes // n,
                 int_ops=int_ops // n, fp_ops=fp_ops // n, **info)
            for _ in range(n))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, _dtensor()) for t in types):
            return NotImplemented
        if func.namespace == "prim" or self._foreign(args, kwargs):
            return func(*args, **kwargs)
        if func.overloadpacket not in _MATMULS:
            # a composite op (matmul, einsum, linear, reshape: they reach a
            # mode whole under inference_mode) is counted as the ops it
            # runs, with this mode in force again
            TorchDispatchMode.__enter__(self)
            try:
                out = func.decompose(*args, **kwargs)
            finally:
                TorchDispatchMode.__exit__(self, None, None, None)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        self._count(func, args, kwargs, out)
        return out

    def _foreign(self, args, kwargs) -> bool:
        """Whether a tensor of ``args`` or ``kwargs`` is a fake tensor of
        another fake mode than the counter's (DTensor's sharding
        propagation)."""
        from torch._subclasses.fake_tensor import FakeTensor
        return any(isinstance(t, FakeTensor) and t.fake_mode
                   is not self.fake_mode
                   for t in _tensors([args, kwargs]))

    def _track(self, out) -> None:
        """Count ``out`` 's new results as live until they are freed."""
        for t in _tensors(out):
            if t in self._seen:
                continue
            self._seen.add(t)
            n = t.numel() * t.element_size()
            self.live_bytes += n
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
            weakref.finalize(t, self._free, n)

    def _free(self, n: int) -> None:
        self.live_bytes -= n

    def _count(self, func, args, kwargs, out) -> None:
        if self._foreign(out, None):
            return          # a factory op of another fake mode
        packet = func.overloadpacket
        if func.namespace in ("c10d", "_c10d_functional"):
            kind = _coll_kind(packet.__name__)
            if kind is not None:
                # c10d's ops work in place on their first argument
                n = _nbytes(args[0] if func.namespace == "c10d" else out) \
                    * _scale()
                self.coll_bytes[kind] += n
                self._row(True, kind, n)
            return
        if packet in _MATMULS:
            from torch.utils.flop_counter import flop_registry
            self.flops += flop_registry[packet](*args, **kwargs,
                                                out_val=out) * _scale()
        if func.is_view or packet in _ZERO:
            if packet in _ALLOC:
                self._track(out)
            return
        named = {}
        for i, a in enumerate(func._schema.arguments):
            if i < len(args):
                named[a.name] = args[i]
            elif a.name in kwargs:
                named[a.name] = kwargs[a.name]
        dest = {a.name for a in func._schema.arguments
                if a.alias_info is not None and a.alias_info.is_write}
        if packet in _GATHERS:
            # the index, and the rows read as they are written
            nbytes = _nbytes([v for k, v in named.items()
                              if k not in ("self", "weight")]) \
                + 2 * _nbytes(out)
        elif not dest:
            nbytes = (sum(_read_bytes(t) for t in _tensors(list(
                named.values()))) + _nbytes(out))
            self._track(out)
        elif packet in _ROWS:
            nbytes = self._row_bytes(packet, named)
        else:
            srcs = [v for k, v in named.items()
                    if k not in dest or (packet not in _WRITE_ONLY
                                         and k == "self")]
            nbytes = (sum(_read_bytes(t) for t in _tensors(srcs))
                      + _nbytes([named[k] for k in dest if k in named]))
        nbytes *= _scale()
        self.bytes += nbytes
        self.op_bytes[str(packet.__name__)] += nbytes
        self._row(False, str(packet.__name__), nbytes)

    def _row(self, coll: bool, kind: str, nbytes: int) -> None:
        if not self.where:
            return
        row = self.rows.setdefault((coll, kind, _caller()), [0, 0])
        row[0] += nbytes
        row[1] += _scale()

    @staticmethod
    def _row_bytes(packet, named) -> int:
        """Bytes of an in-place op that writes only the rows its index
        names: the rows written (read too where it accumulates), the
        index and the source's part that lands."""
        self_t = named["self"]
        size = self_t.element_size()
        if packet in (aten.index_put_, aten._index_put_impl_):
            idx = [i for i in named["indices"] if i is not None]
            rows = 1
            for s in torch.broadcast_shapes(*(
                    (int(i.sum()),) if i.dtype == torch.bool else i.shape
                    for i in idx)):
                rows *= s
            covered = sum(i.dim() if i is not None and i.dtype == torch.bool
                          else 1 for i in named["indices"])
            per = 1
            for s in self_t.shape[covered:]:
                per *= s
            none_dims = [d for d, i in enumerate(named["indices"])
                         if i is None]
            for d in none_dims:
                per *= self_t.shape[d]
            written = rows * per * size
            reads = _nbytes(idx) + min(_read_bytes(named["values"]),
                                       written)
            if named.get("accumulate"):
                reads += written
            return reads + written
        if packet in (aten.index_copy_, aten.index_add_,
                      aten.index_reduce_):
            written = _nbytes(named["source"])
            reads = written + _nbytes(named["index"])
        else:                              # scatter_*, put_
            index = named["index"]
            written = index.numel() * size
            src = named.get("src", named.get("source"))
            reads = _nbytes(index) + (index.numel() * src.element_size()
                                      if isinstance(src, torch.Tensor)
                                      else 0)
        if packet in _ACCUMULATE:
            reads += written
        return reads + written
