"""The port's ``lax.while_loop`` and ``lax.cond``, and the captured graph
that runs them on the card (the port's counterpart of ``jax.jit``).

A loop's or branch's carry is a tuple of tensors allocated BEFORE it; the
body updates the carry in place (``copy_``, ``index_copy_``,
``masked_fill_``) and never replaces a tensor of it; a predicate is a 0-d
bool tensor computed on the device, or a :class:`Test`: the loop test in
the form that one kernel launch evaluates on the device (a count under a
limit, and any entry of a conjunction of flags or of ``a != b``), the
counterpart of the one fused computation XLA makes of a ``cond_fun``.
One body serves two drivers:

- the eager driver (the CPU, and the card outside a capture) runs the
  body and reads only the predicate between turns
  (:func:`read_predicate`; a :class:`Test` evaluated by
  :meth:`Test.plain`, its plain torch expression), exactly where a
  conditional node decides;
- the capture driver (the card inside :func:`capture`) adds a CUDA
  conditional node to the graph being captured, a WHILE for a loop and
  an IF for a branch (``cond`` with a false branch is two IFs, on the
  predicate and on its negation, both handles set by one launch),
  captures the body into the node's body graph on a stream of its own,
  and sets the node's handle on the device with :func:`set_cond`
  (``csrc/graph_cond.cu``), which evaluates the test itself. Nothing is
  read on the host.

During a capture every allocation of the capturing thread goes to the
graph's private pool, on the capture stream and on the body streams
alike. A tensor allocated inside a body never outlives the body: results
leave a body only through the carry.

:func:`branches` is ``jax.vmap`` over independent streams of work: in a
capture, each of its calls is a branch of the graph, forked from the
capture stream and joined back to it, on a stream of its own with body
streams of its own (the allocator reuses a freed block only on the stream
that freed it, so two branches that run at once never share memory) and
a row of the device counts of its own (``utils.profiling.count_row``).
Outside a capture the calls run one after another.

:class:`Graph` captures a function once and replays it on new inputs:
the inputs are copied into its static buffers and the outputs cloned out
of it, so a returned tensor never aliases memory that the next replay
writes. A capture or conditional-node failure raises; nothing falls back
to the eager driver. Its captured body is :func:`traced`: the ``graph``
span (``utils.profiling.mark``) from its first node to its last; a call
is the host spans ``entry.copy_in``, ``entry.launch`` (the
``cudaGraphLaunch``) and ``entry.clone``.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import os
import threading
import time
from typing import Any, Callable, List, NamedTuple, Optional, Sequence, Tuple, Union

import torch

from dynamic_direct_lidar_odometry_tpu_torch.core import tree
from dynamic_direct_lidar_odometry_tpu_torch.utils import profiling

# host reads of the eager driver, by construct ("while", "cond"); the
# capture driver makes none
PREDICATE_READS: collections.Counter = collections.Counter()
# nesting of bodies a capture supports (a body stream per level)
MAX_DEPTH = 4
# branches a capture supports (a count row each, after the row outside them)
MAX_BRANCHES = profiling.MAX_COUNT_ROWS - 1

_TLS = threading.local()


class Test(NamedTuple):
    """A loop's or branch's test in the form that :func:`set_cond`
    evaluates on the device in one launch::

        (count is None or count < limit) and any(term(i) for i < n)

    ``term(i)`` is ``a[i] != b[i]`` for ``differ=(a, b)`` (two int32
    arrays of n entries), else the conjunction of ``all_of[k][i]`` and of
    ``not none_of[k][i]`` (bool tensors of n entries each, at most three
    in all; a 0-d flag is n = 1; no flag: true). ``count`` is a 0-d int32
    tensor, ``limit`` an int. :meth:`plain` is the plain torch
    expression, which the eager driver reads."""

    count: Optional[torch.Tensor] = None
    limit: int = 0
    all_of: Tuple[torch.Tensor, ...] = ()
    none_of: Tuple[torch.Tensor, ...] = ()
    differ: Optional[Tuple[torch.Tensor, torch.Tensor]] = None

    def tensors(self) -> list:
        return [x for x in ((self.count,) + self.all_of + self.none_of + tuple(self.differ or ()))
                if x is not None]

    def plain(self) -> torch.Tensor:
        """The test as a 0-d bool tensor, by torch operations."""
        if self.differ is not None:
            term = self.differ[0] != self.differ[1]
        else:
            term = None
            for f in self.all_of:
                term = f if term is None else term & f
            for f in self.none_of:
                term = ~f if term is None else term & ~f
            if term is None:
                term = torch.ones((), dtype=torch.bool, device=self.tensors()[0].device)
        pred = term.any() if term.dim() else term
        return pred if self.count is None else (self.count < self.limit) & pred


Predicate = Union[torch.Tensor, Test]


def _as_test(pred: Predicate) -> Test:
    """A tensor predicate as a test of one 0-d flag."""
    if isinstance(pred, Test):
        return pred
    return Test(all_of=(pred.reshape(()).to(torch.bool),))


def read_predicate(pred: Predicate, kind: str = "while") -> bool:
    """The eager driver's one host read: the predicate (a :class:`Test`
    evaluated by its plain expression), between turns of a loop or before
    a branch."""
    if isinstance(pred, Test):
        pred = pred.plain()
    PREDICATE_READS[kind] += 1
    return bool(pred)


def _lib():
    from dynamic_direct_lidar_odometry_tpu_torch.ops import nn_cuda

    return nn_cuda.build()["graph_cond"].lib


def _check(err: int, what: str) -> None:
    if err == -1:
        raise RuntimeError(f"{what}: the stream is not capturing")
    if err != 0:
        raise RuntimeError(f"{what} failed: CUDA error {err}")


class _Capture:
    """The capture under way on this thread: a body stream per nesting
    level, the level being captured, and each branch's set of streams
    (:func:`branches`)."""

    def __init__(self, device: torch.device, n_branches: int = 0):
        if not 0 <= n_branches <= MAX_BRANCHES:
            raise ValueError(f"control: {n_branches} branches (at most {MAX_BRANCHES})")
        self.own = self.streams = streams(device)[1:]
        self.branch_sets = [streams(device, b + 1) for b in range(n_branches)]
        self.depth = 0


def _active(pred: Predicate):
    """The capture under way if ``pred`` is on the card and its stream is
    capturing; None for the eager driver. A capture that
    :func:`capture` did not begin raises."""
    t = pred.tensors()[0] if isinstance(pred, Test) else pred
    if not t.is_cuda or not torch.cuda.is_current_stream_capturing():
        return None
    cap = getattr(_TLS, "capture", None)
    if cap is None:
        raise RuntimeError(
            "control: a loop or branch inside a CUDA graph capture that "
            "control.capture did not begin"
        )
    return cap


def _handle() -> int:
    """A conditional handle in the graph that the current stream captures."""
    handle = ctypes.c_ulonglong(0)
    _check(_lib().ddlo_cond_handle(torch.cuda.current_stream().cuda_stream, ctypes.byref(handle)),
           "cudaGraphConditionalHandleCreate")
    return handle.value


def _node(is_while: bool, handle: int) -> int:
    """Add a conditional node on ``handle`` after the work the current
    (capturing) stream has captured (its :func:`set_cond`); returns the
    node's body graph."""
    body = ctypes.c_void_p(0)
    _check(_lib().ddlo_cond_node(torch.cuda.current_stream().cuda_stream, int(is_while), handle,
                                 ctypes.byref(body)), "cudaGraphAddNode (conditional)")
    return body.value


def scratch_for(pred: Predicate) -> Optional[torch.Tensor]:
    """The zeroed scratch :func:`set_cond` needs for ``pred`` (one int32
    on its device, which the kernel leaves zeroed), or None: only a
    ``differ`` test over more entries than one block takes. Allocated
    once per call site (in a capture: in the graph's pool)."""
    test = _as_test(pred)
    if test.differ is None:
        return None
    a = test.differ[0]
    if _lib().ddlo_set_cond_blocks(a.numel(), 1) <= 1:
        return None
    return torch.zeros(1, dtype=torch.int32, device=a.device)


def set_cond(pred: Predicate, handles: Sequence[int] = (), out: Optional[torch.Tensor] = None,
             scratch: Optional[torch.Tensor] = None) -> None:
    """Launch ``ddlo_set_cond`` on the current stream: evaluate ``pred``
    (a :class:`Test`, or a tensor as a test of one 0-d flag) on the
    device, set ``handles[0]`` to it and ``handles[1]`` (if given) to its
    negation, and write it to ``out`` (one bool, if given). ``scratch``:
    :func:`scratch_for`'s. The test's plain version is
    :meth:`Test.plain`."""
    from dynamic_direct_lidar_odometry_tpu_torch.ops import nn_cuda

    test = _as_test(pred)
    if not test.tensors():
        raise ValueError("control.set_cond: a test with no tensor has no device")
    if test.differ is not None:
        if test.all_of or test.none_of:
            raise ValueError("control.Test: differ= takes no flags")
        flags, nflags, neg = [x.reshape(-1) for x in test.differ], 0, 0
        want = torch.int32
    else:
        flags = [f.reshape(-1) for f in test.all_of + test.none_of]
        nflags, neg = len(flags), sum(1 << k for k in range(len(test.all_of), len(flags)))
        want = torch.bool
    n = flags[0].numel() if flags else 1
    if len(flags) > 3 or len(handles) > 2 or any(
            f.dtype != want or f.numel() != n or not f.is_contiguous() for f in flags):
        raise ValueError(f"control.set_cond: expected at most three {want} arrays of one size, "
                         f"got {[(f.dtype, tuple(f.shape)) for f in flags]}")
    if test.count is not None and (test.count.dtype != torch.int32 or test.count.numel() != 1):
        raise ValueError(f"control.set_cond: count must be a 0-d int32, got {test.count.dtype}")
    if out is not None and (out.dtype != torch.bool or out.numel() != 1):
        raise ValueError("control.set_cond: out must be one bool")
    flags = flags + [None] * (3 - len(flags))
    h = list(handles) + [0] * (2 - len(handles))
    nn_cuda.run_kernel(_lib().ddlo_set_cond, "set_cond", *flags, nflags, neg,
                       int(test.differ is not None), n, test.count, int(test.limit), h[0], h[1],
                       len(handles), out, scratch)


@contextlib.contextmanager
def _body(cap: _Capture, body: int):
    """Capture the block's work into a conditional node's body graph, on
    the body stream of the next nesting level."""
    if cap.depth >= MAX_DEPTH:
        raise RuntimeError(f"control: bodies nested deeper than {MAX_DEPTH}")
    stream = cap.streams[cap.depth]
    lib = _lib()
    _check(lib.ddlo_capture_into(stream.cuda_stream, body), "cudaStreamBeginCaptureToGraph")
    cap.depth += 1
    try:
        with torch.cuda.stream(stream):
            yield
    finally:
        cap.depth -= 1
        err = lib.ddlo_capture_close(stream.cuda_stream)
    _check(err, "cudaStreamEndCapture (body)")


def while_loop(cond_fn: Callable[..., Predicate], body_fn: Callable[..., None],
               carry: Sequence[torch.Tensor]):
    """``lax.while_loop`` in place: while ``cond_fn(*carry)`` (a 0-d bool
    tensor or a :class:`Test`) holds, ``body_fn(*carry)`` updates the
    carry. Returns the carry."""
    carry = tuple(carry)
    pred = cond_fn(*carry)
    cap = _active(pred)
    if cap is None:
        while read_predicate(pred, "while"):
            body_fn(*carry)
            pred = cond_fn(*carry)
        return carry
    scratch = scratch_for(pred)
    handle = _handle()
    set_cond(pred, (handle,), scratch=scratch)
    with _body(cap, _node(True, handle)):
        body_fn(*carry)
        set_cond(cond_fn(*carry), (handle,), scratch=scratch)
    return carry


def cond(pred: Predicate, true_fn: Callable[..., None],
         false_fn: Callable[..., None] | None, carry: Sequence[torch.Tensor] = ()):
    """``lax.cond`` in place: ``true_fn(*carry)`` if ``pred`` (a 0-d bool
    tensor or a :class:`Test`) holds, else ``false_fn(*carry)`` (None:
    nothing). Returns the carry."""
    carry = tuple(carry)
    cap = _active(pred)
    if cap is None:
        if read_predicate(pred, "cond"):
            true_fn(*carry)
        elif false_fn is not None:
            false_fn(*carry)
        return carry
    # one launch decides both branches before either writes the carry
    handles = (_handle(),) if false_fn is None else (_handle(), _handle())
    set_cond(pred, handles, scratch=scratch_for(pred))
    with _body(cap, _node(False, handles[0])):
        true_fn(*carry)
    if false_fn is not None:
        with _body(cap, _node(False, handles[1])):
            false_fn(*carry)
    return carry


def branches(device: torch.device, n: int, fn: Callable[[int], Any]) -> list:
    """``[fn(b) for b in range(n)]``, each call a branch of its own.

    In a capture (:func:`capture` with ``branches >= n``) the calls are n
    independent branches of the graph, which the card may run at once:
    each forks from the capture stream, runs on its branch's own stream
    with its own body streams and count row, and joins back before the
    capture goes on. Branches do not nest, and are not taken inside a
    loop or branch body. Elsewhere (the CPU, the eager driver) the calls
    run one after another on the current stream."""
    device = torch.device(device)
    if device.type != "cuda" or not torch.cuda.is_current_stream_capturing():
        return [fn(b) for b in range(n)]
    cap = getattr(_TLS, "capture", None)
    if cap is None:
        raise RuntimeError("control.branches inside a CUDA graph capture that control.capture did not begin")
    if cap.depth or cap.streams is not cap.own:
        raise RuntimeError("control.branches inside a loop, a branch body or another branch")
    if n > len(cap.branch_sets):
        raise RuntimeError(f"control.branches: {n} branches in a capture begun with {len(cap.branch_sets)}")
    main = torch.cuda.current_stream()
    fork = main.record_event()
    out = []
    try:
        for b in range(n):
            own = cap.branch_sets[b]
            own[0].wait_event(fork)
            cap.streams = own[1:]
            with torch.cuda.stream(own[0]), profiling.count_row(b + 1):
                out.append(fn(b))
    finally:
        cap.streams = cap.own
    for own in cap.branch_sets[:n]:  # the join
        main.wait_stream(own[0])
    return out


_STREAMS: dict = {}


def streams(device: torch.device, index: int = 0) -> List[torch.cuda.ExternalStream]:
    """This process's own streams on ``device`` (created by
    ``csrc/graph_cond.cu``, never drawn from torch's pool, whose streams
    other code also takes), in sets: set 0's [0] captures a graph, set
    b + 1's [0] runs branch b (:func:`branches`); a set's [1 + d] the
    bodies at nesting level d."""
    key = (device.index if device.index is not None else torch.cuda.current_device(), index)
    if key not in _STREAMS:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("control.streams: new streams inside a capture (their cuBLAS "
                               "workspaces must be made outside it)")
        lib = _lib()
        made = []
        with torch.cuda.device(key[0]):
            for _ in range(MAX_DEPTH + 1):
                ptr = ctypes.c_void_p(0)
                _check(lib.ddlo_stream_create(ctypes.byref(ptr)), "cudaStreamCreate")
                made.append(torch.cuda.ExternalStream(ptr.value, device=torch.device("cuda", key[0])))
        # torch gives each (cuBLAS handle, stream) its workspace at the
        # stream's first cuBLAS call; made inside a conditional body, that
        # allocation breaks the graph (its instantiation crashes). So each
        # stream makes its first calls here, outside any capture.
        for s in made:
            with torch.cuda.stream(s):
                a = torch.ones((8, 8), device=s.device)
                v = torch.ones(8, device=s.device)
                torch.matmul(a, a), torch.bmm(a[None], a[None]), torch.dot(v, v)
                torch.addmm(v, a, a)
        torch.cuda.synchronize(key[0])
        _STREAMS[key] = made
    return _STREAMS[key]


def _allocate_thread_to_pool(device_index: int, pool) -> None:
    """Route every allocation of this thread to ``pool`` (torch's capture
    routes only the capture stream's, by its capture id)."""
    torch._C._cuda_endAllocateToPool(device_index, pool)
    torch._C._cuda_beginAllocateCurrentThreadToPool(device_index, pool)


@contextlib.contextmanager
def capture(graph: torch.cuda.CUDAGraph, device: torch.device, branches: int = 0):
    """Capture the block's work into ``graph``, on this process's capture
    stream of ``device`` (:func:`streams`), with
    ``capture_error_mode="thread_local"`` (another thread's CUDA work
    does not void it), conditional nodes for :func:`while_loop` and
    :func:`cond`, and up to ``branches`` branches for :func:`branches`
    (their streams made before the capture begins). Yields the graph's
    memory pool."""
    if getattr(_TLS, "capture", None) is not None:
        raise RuntimeError("control.capture: a capture is already under way on this thread")
    idx = device.index if device.index is not None else torch.cuda.current_device()
    device = torch.device("cuda", idx)
    cap = _Capture(device, branches)
    stream = streams(device)[0]
    profiling.counts_buffer(device)  # made before the capture, which holds its address
    torch.cuda.synchronize(device)
    pool = torch.cuda.graph_pool_handle()
    with torch.cuda.stream(stream):
        graph.capture_begin(pool=pool, capture_error_mode="thread_local")
        _TLS.capture = cap
        try:
            _allocate_thread_to_pool(idx, pool)
            yield pool
        finally:
            _TLS.capture = None
            graph.capture_end()
            # the reference _allocate_thread_to_pool took on the pool
            torch._C._cuda_releasePool(idx, pool)
    _check_pool_routing_ended(device, pool)


def in_pool(t: torch.Tensor, pool) -> bool:
    """Whether ``t``'s memory lies in a segment of the allocator pool
    ``pool`` (a ``torch.cuda.graph_pool_handle()``)."""
    ptr = t.data_ptr()
    for seg in torch.cuda.memory_snapshot():
        if seg["address"] <= ptr < seg["address"] + seg["total_size"]:  # one address space
            return tuple(seg["segment_pool_id"]) == tuple(pool)
    raise RuntimeError("control: a tensor outside every allocator segment")


def _check_pool_routing_ended(device: torch.device, pool) -> None:
    """The routing of this thread's allocations to the graph's pool rests
    on torch's private entry points (:func:`_allocate_thread_to_pool`)
    and must end with the capture: an allocation now that came from the
    pool would be overwritten by the graph's replays. Raise if it does."""
    probe = torch.empty(1, device=device)
    if in_pool(probe, pool):
        raise RuntimeError(
            f"control.capture: allocations on this thread still go to the graph's pool "
            f"after the capture (torch {torch.__version__})"
        )


class Graph:
    """``fn(*inputs)`` captured once on the card and replayed on new inputs
    of the same structure, shapes and types.

    Construction copies ``inputs`` into static buffers, runs ``fn`` once
    eagerly on the capture stream (the warm-up: kernels built, cuBLAS's
    workspace set, caches filled), then captures it. The warm-up leaves
    the device counts (``utils.profiling.count``) as it found them: only
    replays count. ``branches``: how many :func:`branches` ``fn`` takes.
    :meth:`__call__` copies new inputs into the static buffers, replays,
    and returns a clone of the outputs."""

    def __init__(self, fn: Callable[..., Any], inputs: Sequence[Any], branches: int = 0):
        first = next(x for x in _leaves(inputs) if isinstance(x, torch.Tensor))
        self.device = first.device
        fn = traced(fn, self.device)
        self.stream = streams(self.device)[0]
        self.static_in = tree.map_leaves(_clone, tuple(inputs))
        cur = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(cur)
        counts = profiling.counts_buffer(self.device)
        with torch.cuda.stream(self.stream):
            before = counts.clone()
            fn(*self.static_in)  # warm-up, eager
            counts.copy_(before)
        cur.wait_stream(self.stream)
        self.graph = torch.cuda.CUDAGraph()
        before = torch.cuda.memory_reserved(self.device)
        t0 = time.perf_counter()
        with capture(self.graph, self.device, branches) as self.pool:
            self.static_out = fn(*self.static_in)
        torch.cuda.synchronize(self.device)
        self.capture_s = time.perf_counter() - t0
        self.pool_bytes = torch.cuda.memory_reserved(self.device) - before
        self.replays = 0

    def __call__(self, *inputs: Any) -> Any:
        with _COPY_IN:
            tree.map_leaves(_copy_in, self.static_in, tuple(inputs))
        with _LAUNCH:
            self.graph.replay()
        self.replays += 1
        with _CLONE:
            return tree.map_leaves(_clone, self.static_out)


_COPY_IN = profiling.span("entry.copy_in")
_LAUNCH = profiling.span("entry.launch")
_CLONE = profiling.span("entry.clone")


def traced(fn: Callable[..., Any], device: torch.device) -> Callable[..., Any]:
    """``fn`` inside the ``graph`` span (``device``'s clock, the calling
    thread's count row: 0 outside a branch): the body that :class:`Graph`
    captures, and that the entries run as it is where they run no graph
    (the CPU, the eager step)."""

    def body(*args: Any) -> Any:
        profiling.mark(device, begin="graph")
        out = fn(*args)
        profiling.mark(device, end="graph")
        return out

    return body


class GraphCache:
    """Captured graphs by static signature (a kind, the static arguments,
    the backends chosen by ``DDLO_NN_IMPL`` / ``DDLO_KNN_IMPL``, which
    arguments are None, and every tensor leaf's shape, type and device),
    each captured at its first call; at most ``size`` are kept (each
    holds its memory pool), the least recently used dropped first."""

    def __init__(self, size: int):
        self.size = size
        self.graphs: "collections.OrderedDict[tuple, Graph]" = collections.OrderedDict()

    def get(self, kind: str, static: Any, fn: Callable[..., Any], args: tuple,
            branches: int = 0) -> Graph:
        key = (kind, static, os.environ.get("DDLO_NN_IMPL"), os.environ.get("DDLO_KNN_IMPL"),
               tuple(a is None for a in args), _signature(args))
        g = self.graphs.get(key)
        if g is None:
            while len(self.graphs) >= self.size:
                self.graphs.popitem(last=False)
            g = self.graphs[key] = Graph(fn, args, branches)
        self.graphs.move_to_end(key)
        return g

    def clear(self) -> None:
        """Drop every graph (and with it its memory pool)."""
        self.graphs.clear()

    def stats(self) -> list:
        """Per graph: its kind, capture seconds, the memory its capture
        reserved (bytes) and its replays."""
        return [dict(kind=k[0], capture_s=g.capture_s, pool_bytes=g.pool_bytes,
                     replays=g.replays) for k, g in self.graphs.items()]


def _signature(x) -> tuple:
    out = []
    tree.map_leaves(
        lambda t: out.append((tuple(t.shape), t.dtype, t.device) if isinstance(t, torch.Tensor)
                             else t), x)
    return tuple(out)


def _leaves(x):
    out = []
    tree.map_leaves(lambda leaf: out.append(leaf), x)
    return out


def _clone(x):
    return x.clone() if isinstance(x, torch.Tensor) else x


def _copy_in(dst, src):
    if isinstance(dst, torch.Tensor):
        if not isinstance(src, torch.Tensor) or src.shape != dst.shape or src.dtype != dst.dtype:
            raise ValueError(
                f"Graph: input {getattr(src, 'shape', src)} does not match the "
                f"captured {tuple(dst.shape)} {dst.dtype}"
            )
        dst.copy_(src)
    elif dst != src:
        raise ValueError(f"Graph: a static input changed ({dst!r} -> {src!r})")
    return dst
