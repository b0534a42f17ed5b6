"""The lane tick as one captured device program: the port's counterpart of
`jax.jit` over the tick (the JAX server serves `jax.jit(_tick,
donate_argnums=(0,))`, `mpc_collisionavoidance_tpu/rt/server.py:198`).

A tick is captured at its first call, after one warm-up call on a side
stream, in segments: one `torch.cuda.CUDAGraph` each, all in one memory
pool.  The first segment runs the tick up to its stall escalation, then
each escalation step is a segment of its own, and the last segment runs
the rest.  `csrc/graph.cu` joins them into one graph in which each step's
segment is the body of a conditional IF node on the escalation predicate
(`ops.ipm_lanes.Escalation`), and instantiates it.  A tick is then one
graph launch with no host read in it; a step whose predicate is false is
skipped on the device.  (The torch on the card, 2.11, has no binding for
conditional nodes, so the library builds them with the CUDA runtime.)

Inputs and outputs are static tensors.  A caller's inputs are copied into
the program's input tensors before the launch, never inside the graph (a
view, a broadcast reference among them, is copied into contiguous
memory); the state lives in one set of tensors per state shape.  The
lane engine's captured step and feedback write the new state into them,
as `donate_argnums=(0,)` lets XLA do, so the state and outputs a lane
tick returns stay valid until the next tick of the same solver.  The
per-instance engine (`solver/sqp_rti.py`) captures the same way, one
unconditional segment per program (its IPM has no escalation), and
hands its caller `fresh` copies of the outputs, as `jax.jit` without
donation returns new arrays.

Launch counts: no kernel wrapper runs when a graph launches, so a launch
adds to the kernels' counters what the wrappers counted while the fixed
segments were captured, and `settle_launch_counts()` adds each escalation
step's launches times the steps that ran, read from the device (a sync).
It counts the steps of programs already released too: a program's step
count outlives it until the next settle.  `launches` counts graph
launches.  A capture or launch that fails raises.
"""

import ctypes
import gc
import threading
import time
import weakref

import numpy as np
import torch

from mpc_collisionavoidance_tpu_torch.kernels import (_build, ipm, linearize,
                                                      riccati)
from mpc_collisionavoidance_tpu_torch.ops.ipm_lanes import Escalation

# the kernel wrappers whose `launches` a graph launch adds to
_KERNELS = (riccati, linearize, ipm)

_PACKAGE = __name__.split(".")[0]

launches = 0
_PROGRAMS = weakref.WeakSet()
_RELEASED = []      # the `_Steps` of programs released since the last settle
_SETTLE_LOCK = threading.Lock()


def _counts():
    return tuple(k.launches for k in _KERNELS)


def _check(code, what):
    if code != 0:
        msg = _build.library().nmpc_cuda_error_string(code)
        raise RuntimeError(f"{what}: CUDA error {code} "
                           f"({msg.decode() if msg else '?'})")


def cuda_versions():
    """(runtime, driver) CUDA versions as the kernel library sees them,
    e.g. (12090, 13000); conditional nodes need 12040 for both."""
    runtime, driver = ctypes.c_int(), ctypes.c_int()
    _check(_build.library().nmpc_cuda_versions(ctypes.byref(runtime),
                                               ctypes.byref(driver)),
           "cudaRuntimeGetVersion")
    return runtime.value, driver.value


def settle_launch_counts():
    """Add to the kernels' counters the launches of the escalation steps
    that every program, live or released since, ran since the last call.
    Reads each program's device step count, so it waits for the ticks."""
    with _SETTLE_LOCK:
        for program in list(_PROGRAMS):
            program.settle()
        while _RELEASED:
            _RELEASED.pop().settle()


class _Steps:
    """A program's escalation steps: `total` the device's count of the
    steps its ticks ran, `per_step` the launches of one step, `settled`
    the steps already added to the counters.  It outlives its program: the
    program's finalizer puts it in `_RELEASED` (no device read there)."""

    def __init__(self, total, per_step):
        self.total, self.per_step, self.settled = total, per_step, 0

    def settle(self):
        total = int(self.total)
        for k, n in zip(_KERNELS, self.per_step):
            k.launches += n * (total - self.settled)
        self.settled = total


class SegmentedCapture(Escalation):
    """An `Escalation` that captures each step as a conditional segment.

    `pred` is the device bool every IF node reads: the segment before a
    step writes the predicate there.  That segment is unconditional (a
    child graph between the IF nodes, `csrc/graph.cu`), so with a process
    group every replay runs all `n` of its all-reduces, also after the
    predicate has turned False.  `iters` counts the steps of the last
    tick (zeroed in the first segment), `total` those of every tick.  Each
    segment records the kernel launches its wrappers counted."""

    def __init__(self, device, group=None):
        super().__init__(device, group)
        self.total = torch.zeros((), dtype=torch.int64, device=device)
        self.pred = torch.zeros((), dtype=torch.bool, device=device)
        self.pool = torch.cuda.graph_pool_handle()
        self.segments = []       # (CUDAGraph, conditional)
        self.counts = []         # launches counted in each segment
        self._start = None

    def begin(self, conditional):
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        graph.capture_begin(pool=self.pool, capture_error_mode="thread_local")
        self.segments.append((graph, conditional))
        self._start = _counts()

    def end(self):
        self.segments[-1][0].capture_end()
        self.counts.append(tuple(b - a for a, b in
                                 zip(self._start, _counts())))

    def loop(self, n, stalled, step):
        for _ in range(n):
            self.pred.copy_(self.predicate(stalled))
            self.end()
            self.begin(conditional=True)
            step()
            self.iters += 1
            self.total += 1
        self.end()
        self.begin(conditional=False)


class Program:
    """One captured tick: `fn(escalation) -> (outputs, writes)` over static
    tensors, `writes` the (destination, source) pairs the captured tick
    copies last (the new state into the state's tensors; the warm-up call
    skips them).  `group`: the escalation's process group (a sharded lane
    axis); its all-reduce is captured in the segment that writes the
    predicate, after the warm-up has set up the communicator.  `launch()`
    runs it on the current stream."""

    def __init__(self, fn, device, group=None):
        self.device = device
        stream = torch.cuda.Stream(device)
        stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.device(device), torch.cuda.stream(stream):
            t0 = time.perf_counter()
            fn(Escalation(device, group))    # warm-up, not captured
            torch.cuda.synchronize(device)
            warmup_s = time.perf_counter() - t0
            # a collection during the capture could free an earlier
            # program's graphs and pool, a call a capture may not make:
            # collect now (and hand the dead pools' memory back, as
            # torch.cuda.graph does), and not again until the capture ends
            gc.collect()
            torch.cuda.empty_cache()
            gc_was_enabled = gc.isenabled()
            gc.disable()
            reserved = torch.cuda.memory_reserved(device)
            t1 = time.perf_counter()
            seg = SegmentedCapture(device, group)
            before = _counts()
            try:
                seg.begin(conditional=False)
                seg.iters.zero_()
                self.outputs, writes = fn(seg)
                for dst, src in writes:
                    dst.copy_(src)
                seg.end()
            except BaseException:
                # end a capture the error left open, then re-raise
                if seg.segments and len(seg.counts) < len(seg.segments):
                    try:
                        seg.segments[-1][0].capture_end()
                    except RuntimeError:
                        pass
                raise
            finally:
                for k, n in zip(_KERNELS, before):
                    k.launches = n
                if gc_was_enabled:
                    gc.enable()
            t2 = time.perf_counter()
            self._segments = seg.segments    # keeps the pool's memory
            n = len(seg.segments)
            flags = [int(c) for _, c in seg.segments]
            exec_ = ctypes.c_void_p()
            nodes = ctypes.c_longlong()
            _check(_build.library().nmpc_graph_compose(
                n, (ctypes.c_void_p * n)(*(g.raw_cuda_graph()
                                           for g, _ in seg.segments)),
                (ctypes.c_int * n)(*flags), seg.pred.data_ptr(),
                ctypes.byref(exec_), ctypes.byref(nodes)),
                "joining the captured tick")
            self._exec = exec_.value
            weakref.finalize(self, _build.library().nmpc_graph_destroy,
                             self._exec)
        torch.cuda.current_stream(device).wait_stream(stream)
        # launches of the fixed segments, and of one escalation step
        self.fixed = tuple(map(sum, zip(*(c for c, f in zip(seg.counts, flags)
                                          if not f))))
        steps = {c for c, f in zip(seg.counts, flags) if f}
        if len(steps) > 1:
            raise RuntimeError(f"escalation steps captured different "
                               f"launches: {steps}")
        self.per_step = steps.pop() if steps else (0,) * len(_KERNELS)
        self.escalation = seg
        self.nodes = nodes.value
        self.conditional = sum(flags)
        self.warmup_s, self.capture_s = warmup_s, t2 - t1
        self.instantiate_s = time.perf_counter() - t2
        self.pool_bytes = torch.cuda.memory_reserved(device) - reserved
        self._steps = _Steps(seg.total, self.per_step)
        weakref.finalize(self, _RELEASED.append, self._steps)
        _PROGRAMS.add(self)

    def launch(self):
        global launches
        stream = torch.cuda.current_stream(self.device).cuda_stream
        _check(_build.library().nmpc_graph_launch(self._exec, stream),
               "launching the captured tick")
        launches += 1
        for k, n in zip(_KERNELS, self.fixed):
            k.launches += n

    def settle(self):
        self._steps.settle()


def fresh(tree):
    """`tree` (tensors in tuples) with every tensor copied into memory of
    its own, one copy per distinct tensor (a tensor that appears twice,
    the per-instance state's xbar and its output's xtraj, stays one
    tensor): what a caller keeps of a program's outputs."""
    copies = {}

    def copy(a):
        if isinstance(a, torch.Tensor):
            if id(a) not in copies:
                copies[id(a)] = a.clone(memory_format=torch.contiguous_format)
            return copies[id(a)]
        if isinstance(a, tuple):
            vals = [copy(v) for v in a]
            return type(a)(*vals) if hasattr(a, "_fields") else tuple(vals)
        return a

    return copy(tree)


def state_key(state):
    """The key of a state's static tensors: the shape of every field.  No
    single axis tells states apart: the lane layout's xbar (nx, N+1, L)
    ends in the width, the per-instance (..., N+1, nx) in nx, after any
    batch axes."""
    return tuple(tuple(t.shape) for t in state)


def _held(obj, depth=2):
    """The tensors `obj` holds: itself, its tuples' and lists' items, and
    the attributes of this package's objects, `depth` objects down (a
    per-instance solver's cost blocks live on its QP builder)."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (tuple, list)):
        for v in obj:
            yield from _held(v, depth)
    elif depth and type(obj).__module__.startswith(_PACKAGE):
        for v in vars(obj).values():
            yield from _held(v, depth - 1)


def _storage(t):
    return t.untyped_storage().data_ptr()


def _shape(a):
    """The cache key of an argument: None, a shape, or a tuple of them."""
    if a is None:
        return None
    if isinstance(a, tuple):
        return tuple(_shape(v) for v in a)
    return tuple(a.shape) if isinstance(a, torch.Tensor) else np.shape(a)


class TickGraphs:
    """A solver's captured ticks, keyed like jit's cache: the tick, the
    state's shape (`state_key`), and the shape of every argument (None
    for an optional one not given).  `solver` gives dtype, device and the
    escalation's process group (`LaneRTISolver.group`; none on a solver
    without one).  An output of one of its programs serves as another
    program's input as it is (the lane engine's prepared QP feeds its
    feedback tick without a copy); the solver's own tensors among them
    (the cost blocks in a QP) are never written."""

    def __init__(self, solver):
        self.dtype, self.device = solver.dtype, solver.device
        self.group = getattr(solver, "group", None)
        self.programs = {}
        self.states = {}
        self._owned = {}
        # the tensors stay referenced here, so that no other tensor takes
        # their memory while their addresses mark the solver's own
        self._frozen_tensors = [t for t in _held(solver) if t.numel()]
        self._frozen = {_storage(t) for t in self._frozen_tensors}

    def _own(self, tree):
        if isinstance(tree, torch.Tensor):
            self._owned[id(tree)] = tree
        elif isinstance(tree, tuple):
            for v in tree:
                self._own(v)

    def _static(self, a):
        """The program's input tensor for argument `a`."""
        if a is None:
            return None
        if isinstance(a, tuple):
            vals = [self._static(v) for v in a]
            return type(a)(*vals) if hasattr(a, "_fields") else tuple(vals)
        if self._owned.get(id(a)) is a:
            return a
        a = a if isinstance(a, torch.Tensor) else torch.as_tensor(
            np.asarray(a))
        return a.to(device=self.device, dtype=self.dtype, copy=True,
                    memory_format=torch.contiguous_format)

    def _bind(self, static, a):
        """Copy argument `a` into its static tensor (nothing if it is that
        tensor)."""
        if a is None:
            return
        if isinstance(a, tuple):
            for s, v in zip(static, a):
                self._bind(s, v)
            return
        if isinstance(a, torch.Tensor) and (
                a is static or (a.data_ptr() == static.data_ptr()
                                and a.stride() == static.stride()
                                and a.shape == static.shape
                                and a.dtype == static.dtype)):
            return
        if static.numel() and _storage(static) in self._frozen:
            raise ValueError("a captured tick reads this solver's own "
                             "cost blocks: pass a QP from its prepare_fn")
        static.copy_(a if isinstance(a, torch.Tensor)
                     else torch.as_tensor(np.asarray(a)))

    def state(self, state):
        """The static state of `state`'s shape, holding `state`."""
        key = state_key(state)
        st = self.states.get(key)
        if st is None:
            st = type(state)(*(self._static(t) for t in state))
            self.states[key] = st
            self._own(st)
        else:
            self._bind(st, state)
        return st

    def run(self, name, tick, state, args, donate=True):
        """`tick(state, *args, escalation=...) -> (new state, outputs)` as
        a captured program on the static state of `state`, which the new
        state is written into (`donate`; else `tick` returns None for it
        and `state` is only read).  Returns (the static state, the outputs)
        with `donate`, else the outputs; and the program."""
        st = self.state(state)
        key = (name, state_key(st), tuple(_shape(a) for a in args))
        program = self.programs.get(key)
        if program is None:
            statics = tuple(self._static(a) for a in args)

            def fn(escalation):
                new, out = tick(st, *statics, escalation=escalation)
                writes = () if new is None else tuple(zip(st, new))
                return out, writes

            program = Program(fn, self.device, self.group)
            program.inputs = statics
            self.programs[key] = program
            self._own(program.outputs)
        else:
            self._bind(program.inputs, args)
        program.launch()
        return ((st, program.outputs) if donate else program.outputs), program
