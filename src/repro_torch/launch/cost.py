"""Cost and memory accounting of a step on ``meta`` tensors (counterpart of
``repro.launch.hlo_analysis``, which reads them off XLA's compiled HLO).

:func:`account` runs a step once under a stack of modes below DTensor's
dispatch, so that it sees the aten ops each device runs on its own shards
(for a step over DTensors on the accounting group,
``launch.mesh.accounting_group``: rank 0's local shards; for plain tensors
the whole step on one device). The local tensors are the meta tensors
themselves, or with ``fake=True`` fake tensors (``FakeTensorMode``): a view
of either shares its base's storage, the counts agree (the tests and
``chip_smoke.py`` hold them equal), and nothing is computed or allocated. In that one pass it counts what the reference reads off the
SPMD-compiled step, which is the per-device program:

  * ``cost_summary``'s ``flops``: the matmul and convolution FLOPs of the
    local products (``torch.utils.flop_counter``'s formulas, two a
    multiply-add); XLA also counts one a reduced or elementwise element,
    which this count leaves out. The kernel wrappers' ops on ``meta``
    (``kernels._meta``) bring their own formulas: flash attention counts
    the full S x S products, where the kernel skips the blocks its mask
    drops;
  * ``bytes_accessed``: each aten op's operand and result bytes, views and
    allocations excepted. The ops are eager and unfused, so this is an
    upper bound of XLA's fused count, which does not count the
    intermediates a fusion keeps on chip;
  * ``transcendentals``: result elements of the ops HloCostAnalysis counts
    as such (exp, log, tanh, logistic, erf, sqrt, rsqrt, power, sin, cos
    and their kin; softmax's exponentials);
  * ``memory_summary``'s bytes: the arguments (counted from the start), the
    outputs, the outputs that reuse an argument's storage (the in-place
    train step's params and moments, decode's cache: the reference donates
    both), and the peak of live local storage, kept apart for the forward,
    the backward and what follows it (the optimizer), since a peak is not
    a sum over ops and the dry run, where it extrapolates over depth, fits
    each phase's peak on its own (``launch.dryrun``);
  * the reference's ``collective_bytes`` dict (``hlo_analysis.
    collective_bytes``, which reads XLA's HLO text), read here from the
    functional collectives a step over DTensors issues
    (``torch.ops._c10d_functional.*``, their coalesced forms and DTensor's
    ``shard_dim_alltoall``): the same keys and the same bytes model (per
    participating device, from each op's result bytes, an all-reduce
    twice), and ``cross_pod`` from the ranks of each op's group. On a
    ``fake`` group nothing moves, so a step on the production meshes is
    counted on one CPU process, as the reference counts it on 512
    placeholder devices. The ops are DTensor's choice of collectives, not
    XLA's, so a model step's bytes are not the reference's.

The peak is this storage count's, which is ``torch.distributed._tools.
mem_tracker.MemTracker``'s total on the CPU (the tests hold it against
``MemTracker`` on real tensors over real ranks) without its module hooks,
so it reads the same on every torch version the port runs on.
:func:`cost_summary` (the cost without the memory) and :func:`peak_bytes`
(one device's peak of a step on plain tensors) are the same count for one
question each; :func:`argument_bytes` sums shard shapes, exactly.

Dropped from the reference's summaries: ``generated_code_size_in_bytes``
and ``host_argument_size_in_bytes`` (no compiled program exists, and every
argument lives on the device), and the per-memory-space ``bytes accessed``
entries (one memory space: HBM).
"""
from __future__ import annotations

import contextlib
import weakref
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.common import pytree_utils as pt


def argument_bytes(**trees) -> dict:
    """Per-device bytes of each named tree of ``ShardedStruct``s
    (``launch.api``) and their ``total``."""
    out = {name: sum(s.shard_nbytes for s in pt.leaves(tree))
           for name, tree in trees.items()}
    out["total"] = sum(out.values())
    return out


# the reference's op names (``hlo_analysis._COLLECTIVES``), in its order
COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

# functional collectives (``torch.ops._c10d_functional``, and the autograd
# variants where they reach the mode) -> the reference's op
_FUNCTIONAL = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce", "all_reduce_coalesced_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
}
_NAMESPACES = ("_c10d_functional", "_c10d_functional_autograd", "_dtensor")


def group_ranks(group_name: str):
    """The global ranks of the process group named ``group_name``, or None
    when it cannot be resolved."""
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group

    try:
        return tuple(dist.get_process_group_ranks(_resolve_process_group(group_name)))
    except Exception:  # noqa: BLE001  (an unknown name: unresolved)
        return None


def spans_pods(ranks, pod_size: int) -> bool:
    """True if ``ranks`` hold ranks of more than one pod (``rank //
    pod_size`` differs), and, as the reference does when it finds no
    groups, when the group could not be resolved (``ranks`` None)."""
    if ranks is None:
        return True
    return len({r // pod_size for r in ranks}) > 1


def _nbytes(out) -> int:
    if isinstance(out, torch.Tensor):
        return out.numel() * out.element_size()
    if isinstance(out, (list, tuple)):
        return sum(_nbytes(o) for o in out)
    return 0


class _CollectiveCounter(TorchDispatchMode):
    """Counts each functional collective's result bytes by the reference's
    op name. ``records`` holds ``(op, bytes, ranks)`` per op counted."""

    def __init__(self):
        super().__init__()
        self.records = []
        self._inside_fallback = 0

    def add(self, op: str, nbytes: int, ranks):
        if ranks is not None and len(ranks) == 1:
            return  # a group of one moves nothing (XLA emits no such op)
        self.records.append((op, nbytes * (2 if op == "all-reduce" else 1), ranks))

    def count_collective(self, func, args, kwargs, out):
        op = _FUNCTIONAL.get(func._opname) if func.namespace in _NAMESPACES else None
        if op is not None and not self._inside_fallback:
            name = kwargs.get("group_name", args[-1])
            self.add(op, _nbytes(out), group_ranks(name) if isinstance(name, str)
                     else None)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(t is DTensor for t in types):
            # a mode runs before a subclass: let DTensor turn the op into
            # local ops and collectives first, which then come here
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.count_collective(func, args, kwargs, out)
        return out


@contextlib.contextmanager
def _all_to_all_as_such(counter: _CollectiveCounter):
    """DTensor's all-to-all on a CPU mesh falls back to an all-gather and a
    chunk (Gloo has no all-to-all, ``_collective_utils.shard_dim_alltoall``);
    while counting, that fallback is counted as the all-to-all it stands
    for: its result bytes (the input's, as a real all-to-all's), over the
    mesh dimension's group."""
    from torch.distributed.tensor import placement_types

    original = placement_types.shard_dim_alltoall

    def counted(input, gather_dim, shard_dim, mesh, mesh_dim):
        if mesh.device_type != "cpu":
            return original(input, gather_dim, shard_dim, mesh, mesh_dim)
        group = mesh.get_group(mesh_dim)
        counter.add("all-to-all", _nbytes(input), group_ranks(group.group_name))
        counter._inside_fallback += 1
        try:
            return original(input, gather_dim, shard_dim, mesh, mesh_dim)
        finally:
            counter._inside_fallback -= 1

    placement_types.shard_dim_alltoall = counted
    try:
        yield
    finally:
        placement_types.shard_dim_alltoall = original


def summarize_collectives(records, pod_size=None) -> dict:
    """The reference's dict from ``(op, bytes, ranks)`` records:
    ``{op: bytes, ..., "total", "count"}``, and ``"cross_pod"`` given
    ``pod_size`` (the bytes of ops whose group spans pods)."""
    out = defaultdict(float)
    cross_pod = 0.0
    for op, nbytes, ranks in records:
        out[op] += nbytes
        if pod_size is not None and spans_pods(ranks, pod_size):
            cross_pod += nbytes
    out["total"] = sum(out[c] for c in COLLECTIVES if c in out)
    out["count"] = len(records)
    if pod_size is not None:
        out["cross_pod"] = cross_pod
    return dict(out)


@contextlib.contextmanager
def counting_collectives():
    """Counts the collectives issued inside the block; yields the list of
    ``(op, bytes, ranks)`` records it fills (:func:`summarize_collectives`
    turns them into the reference's dict)."""
    counter = _CollectiveCounter()
    with _all_to_all_as_such(counter), counter:
        yield counter.records


def collective_bytes(fn, *args, pod_size=None, **kwargs) -> dict:
    """Runs ``fn(*args, **kwargs)`` (over DTensors) and returns the
    reference's ``collective_bytes`` dict for the collectives it issued:
    per op ``all-gather``, ``all-reduce`` (result bytes twice),
    ``reduce-scatter``, ``all-to-all`` and ``collective-permute`` bytes per
    participating device, ``total``, ``count``, and with ``pod_size``
    ``cross_pod``: the bytes of ops whose group's ranks span more than one
    ``rank // pod_size``. An op over a group of one rank moves nothing and
    is not counted."""
    with counting_collectives() as records:
        fn(*args, **kwargs)
    return summarize_collectives(records, pod_size)


# aten ops (by overload packet, in place or not) whose every result element
# is one transcendental, as HloCostAnalysis counts exp, expm1, log, log1p,
# logistic, tanh, erf, sqrt, cbrt, rsqrt, power, sin, cos, tan and atan2;
# the activations and softmax's forward and the backwards that evaluate one
_TRANSCENDENTAL = frozenset({
    "exp", "exp2", "expm1", "log", "log1p", "log2", "log10", "tanh", "sigmoid",
    "erf", "erfc", "erfinv", "sqrt", "rsqrt", "sin", "cos", "tan", "atan2",
    "silu", "gelu", "softplus", "elu", "mish", "_softmax", "silu_backward",
    "gelu_backward", "softplus_backward", "_log_softmax_backward_data"})
# ops that read nothing of their first argument, which they only write
_WRITE_ONLY = frozenset({"copy_", "fill_", "zero_"})
# ops that move no bytes: allocations, and a collective's wait
_NO_BYTES = frozenset({"empty", "empty_like", "empty_strided", "new_empty",
                       "new_empty_strided", "wait_tensor"})
PHASES = ("forward", "backward", "after")


def _pass_through_ops():
    """A collective's wait and autograd wrapper (where this torch has them:
    ``torch.distributed`` registers them)."""
    import torch.distributed._functional_collectives  # noqa: F401

    ops = torch.ops._c10d_functional
    return {getattr(ops, name).default for name in ("wait_tensor", "_wrap_tensor_autograd")
            if hasattr(ops, name)}


def _tensors(tree):
    from torch.utils._pytree import tree_leaves

    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def transcendentals(func, args, out) -> int:
    """Transcendentals of one aten op: the result elements of the ops in
    :data:`_TRANSCENDENTAL`, of ``pow`` but at a whole exponent (XLA's
    ``integer_pow`` multiplies), ``_log_softmax``'s exponentials and one
    log a row, ``logsumexp``'s exponentials and logs."""
    name = func._overloadpacket.__name__
    base = name[:-1] if name.endswith("_") and name != "_softmax" else name
    outs = _tensors(out)
    if base in _TRANSCENDENTAL:
        return sum(t.numel() for t in outs)
    if base == "pow":
        exponent = args[1] if len(args) > 1 else None
        if isinstance(exponent, (int, float)) and float(exponent).is_integer():
            return 0
        return sum(t.numel() for t in outs)
    if base == "_log_softmax":
        x, dim = args[0], args[1]
        return x.numel() + x.numel() // max(x.shape[dim], 1) if x.dim() else 2
    if base == "logsumexp":
        return args[0].numel() + sum(t.numel() for t in outs)
    return 0


def _bytes(t) -> int:
    return t.numel() * t.element_size()


def _active_fake_mode():
    from torch._guards import active_fake_mode

    return active_fake_mode()


class _StepCounter(_CollectiveCounter):
    """One device's count of a step, op by op (see the module docstring):
    ``flops`` (and ``flops_by_op``), ``bytes_accessed``, ``transcendentals``,
    the collectives' ``records``, and with ``memory`` the live local
    storage (``current``) and its peak per phase (``peaks``). ``fake_mode``
    is the tensors' own ``FakeTensorMode`` (None for meta tensors): ops
    under another fake mode, and those of DTensor's sharding propagation
    (:func:`_outside_propagation`), are not the device's and are not
    counted."""

    def __init__(self, fake_mode=None, memory=False):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        from repro_torch.kernels import _meta

        self._flop_registry = flop_registry
        self._formulas = _meta.COSTS
        self._pass_through = _pass_through_ops()
        self._fake = fake_mode
        self._memory = memory
        self.flops = 0
        self.flops_by_op = defaultdict(int)
        self.bytes_accessed = 0
        self.transcendentals = 0
        self.current = 0
        self.peaks = {}
        self._live = {}
        self._backward_seen = False
        self._propagating = 0

    def track(self, tensors):
        """Counts the storages of ``tensors`` as live from now on (the
        step's arguments)."""
        for t in tensors:
            self._hold(t)

    def _hold(self, t):
        st = t.untyped_storage()
        key = id(st)
        if key in self._live:
            return
        self._live[key] = st.nbytes()
        self.current += self._live[key]
        weakref.finalize(st, self._release, key)

    def _release(self, key):
        self.current -= self._live.pop(key)

    def phase(self) -> str:
        """``backward`` while autograd's engine runs a node, ``after``
        once it has (the optimizer), ``forward`` before."""
        if torch._C._current_autograd_node() is not None:
            self._backward_seen = True
            return "backward"
        return "after" if self._backward_seen else "forward"

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(t is DTensor for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        if (func not in self._formulas and func._overloadpacket not in self._flop_registry
                and func is not torch.ops.prim.device.default):
            # a composite op (einsum, matmul outside autograd) is counted as
            # the ops it runs, as FlopCounterMode does
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        if func in self._pass_through and args[0].device.type == "meta":
            # on a device a collective's wait and its autograd wrapper hand
            # the result on; their meta kernels make a new tensor
            return args[0]
        out = func(*args, **kwargs)
        if self._propagating or _active_fake_mode() is not self._fake:
            return out
        self._count(func, args, kwargs, out)
        self.count_collective(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out):
        formula = self._formulas.get(func)
        packet = func._overloadpacket
        if formula is not None:
            flops, trans = formula(*args, **kwargs)
        else:
            count = self._flop_registry.get(packet)
            flops = int(count(*args, **kwargs, out_val=out)) if count else 0
            trans = transcendentals(func, args, out)
        if flops:
            self.flops += flops
            self.flops_by_op[str(packet)] += flops
        self.transcendentals += trans
        outs = _tensors(out)
        name = packet.__name__
        if outs and not func.is_view and name not in _NO_BYTES:
            ins = _tensors((args[1:] if name in _WRITE_ONLY else args, kwargs))
            self.bytes_accessed += sum(map(_bytes, ins)) + sum(map(_bytes, outs))
        if self._memory:
            for t in outs:
                self._hold(t)
            phase = self.phase()
            self.peaks[phase] = max(self.peaks.get(phase, 0), self.current)


# ``ShardingPropagator``'s methods that run ops for DTensor's own planning:
# the output's shape by the op on fake tensors of the global shapes, and a
# strategy through the op's decomposition
_PROPAGATION = ("propagate_op_sharding_non_cached", "_propagate_tensor_meta_non_cached")


@contextlib.contextmanager
def _outside_propagation(counter: _StepCounter):
    """DTensor's sharding propagation runs ops on tensors of the global
    shapes (:data:`_PROPAGATION`) once per op signature, in the fake mode
    that is active and under the counter; while it does, the counter
    counts nothing."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    originals = {name: getattr(ShardingPropagator, name) for name in _PROPAGATION}

    def outside(original):
        def propagate(self, *args, **kwargs):
            counter._propagating += 1
            try:
                return original(self, *args, **kwargs)
            finally:
                counter._propagating -= 1

        return propagate

    for name, original in originals.items():
        setattr(ShardingPropagator, name, outside(original))
    try:
        yield
    finally:
        for name, original in originals.items():
            setattr(ShardingPropagator, name, original)


def _local(t):
    """A DTensor's local shard, or the tensor itself."""
    from torch.distributed.tensor import DTensor

    return t._local_tensor if isinstance(t, DTensor) else t


def _storage_bytes(tensors) -> int:
    """Bytes of the distinct storages of ``tensors``."""
    return sum({id(st): st.nbytes() for st in (t.untyped_storage() for t in tensors)}
               .values())


def _fake_args(args, mode):
    """``args`` with every tensor a fake tensor of ``mode``: a plain
    (meta) tensor converted, a DTensor rebuilt over a fake local shard."""
    from torch.distributed.tensor import DTensor

    def one(x):
        if isinstance(x, DTensor):
            out = DTensor.from_local(mode.from_tensor(x._local_tensor), x.device_mesh,
                                     x.placements, run_check=False, shape=x.shape,
                                     stride=x.stride())
            return out.requires_grad_(x.requires_grad)
        return mode.from_tensor(x) if isinstance(x, torch.Tensor) else x

    return pt.tree_map(one, list(args))


def local_bytes(tree) -> int:
    """Bytes of the distinct local storages of the tensors (DTensors: their
    local shards) of ``tree``."""
    return _storage_bytes([_local(t) for t in _tensors(tree)])


def account(fn, *args, pod_size=None, fake=False, keep=None, **kwargs) -> dict:
    """Runs ``fn(*args, **kwargs)`` once on ``args``' meta tensors (local
    shards of DTensors) under the step counter and returns one device's
    count:

      * ``flops``, ``flops_by_op``, ``bytes_accessed``, ``transcendentals``;
      * ``argument_bytes`` (the distinct local storages of ``args``),
        ``output_bytes`` (of the result's), ``alias_bytes`` (the result's
        storages that are an argument's), ``peak_bytes`` and
        ``peak_by_phase`` (:data:`PHASES`), arguments included;
      * ``collectives``: :func:`summarize_collectives` of the records,
        ``cross_pod`` given ``pod_size``.

    ``fake=True`` counts on fake tensors instead (``args`` converted,
    :func:`_fake_args`), ten times slower: the count the tests and
    ``chip_smoke.py`` hold the meta count to. ``keep`` (a dict) receives
    the result under ``"result"``."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    # ``allow_non_fake_inputs`` admits the scalars ``Tensor.new_tensor``
    # makes inside the mode
    mode = FakeTensorMode(allow_non_fake_inputs=True) if fake else None
    if fake:
        args = _fake_args(args, mode)
    inputs = [_local(t) for t in _tensors(args)]
    arguments = _storage_bytes(inputs)
    # weakly: an argument the step lets go of (a gradient laid out anew in
    # its tree) is freed as on a device
    storages = [weakref.ref(t.untyped_storage()) for t in inputs]
    counter = _StepCounter(mode, memory=True)
    counter.track(inputs)
    del inputs
    with mode or contextlib.nullcontext():
        with _all_to_all_as_such(counter), _outside_propagation(counter), counter:
            out = fn(*args, **kwargs)
        outputs = [_local(t) for t in _tensors(out)]
        output_bytes = _storage_bytes(outputs)
        held = {id(st) for st in (ref() for ref in storages) if st is not None}
        alias = _storage_bytes([t for t in outputs if id(t.untyped_storage()) in held])
    if keep is not None:
        keep["result"] = out
    peaks = {p: max(v, arguments) for p, v in counter.peaks.items()}
    return {"flops": counter.flops,
            "flops_by_op": dict(sorted(counter.flops_by_op.items())),
            "bytes_accessed": counter.bytes_accessed,
            "transcendentals": counter.transcendentals,
            "argument_bytes": arguments, "output_bytes": output_bytes,
            "alias_bytes": alias,
            "peak_bytes": max([arguments, *peaks.values()]),
            "peak_by_phase": peaks,
            "collectives": summarize_collectives(counter.records, pod_size)}


def cost_summary(fn, *args, **kwargs) -> dict:
    """``{"flops": matmul and convolution FLOPs of fn(*args, **kwargs),
    "flops_by_op": {aten op: FLOPs}, "bytes_accessed", "transcendentals"}``
    on meta tensors as they are (no memory count)."""
    counter = _StepCounter()
    with counter:
        fn(*args, **kwargs)
    return {"flops": counter.flops,
            "flops_by_op": dict(sorted(counter.flops_by_op.items())),
            "bytes_accessed": counter.bytes_accessed,
            "transcendentals": counter.transcendentals}


def peak_bytes(fn, *args) -> dict:
    """One device's peak while ``fn(*args)`` runs on plain meta tensors
    (:func:`account`'s count, the arguments live from the start). Returns
    ``{"peak_bytes", "arguments_bytes"}``."""
    got = account(fn, *args)
    return {"peak_bytes": got["peak_bytes"], "arguments_bytes": got["argument_bytes"]}
