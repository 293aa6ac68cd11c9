"""Captured programs: the port's counterpart of ``jax.jit`` for a
fixed-shape eval or train function.

A function is given as ``Segments`` (``utils/segments.py``): the parts it
runs in order on a carry dict, cut where the host must decide between
them (the greedy decode's early exit, which the JAX package runs as an
on-device ``lax.cond``). ``CapturedFunction`` keeps one set of CUDA
graphs, a graph a segment, per key: the shapes and dtypes of the batch,
the model's identity and config, the addresses of its parameters and
buffers, the addresses of the inputs a graph reads where they lie
(``by_address``: the grid's point and centre tables) and, for a train
step, its optimizer's (``optimizer_state``: Adam's moments and step
counts, each group's hyperparameters, a tensor ``lr`` by address) and
whether it draws dropout masks. A graph bakes in every address it reads,
so a key that matches is a graph that reads the caller's tensors;
in-place updates of the weights (Adam, ``copy_``, ``load_state_dict``)
reach the next replay, and a replaced parameter, an optimizer state
loaded anew (``Optimizer.load_state_dict`` replaces its tensors) or a
changed hyperparameter makes a new key.

Dropout: a train program owns the generators of a key, registered with
its graphs (``CUDAGraph.register_generator_state``): one, or under tensor
parallelism the two of ``models/core.py::SplitGenerators``. A replay draws
from the states those generators hold when it starts and advances them by
what the capture drew. A call loads each caller generator's state into its
own before the replay and writes the advanced states back after, so the
caller's generators end where an eager step would leave them.

Collectives: a step over process groups (``groups_of``: the data-parallel
group, a tensor-parallel model's model and data groups, all NCCL) records
its all-reduces and all-gathers into its graphs, as the JAX package's
``jax.jit`` over a mesh compiles them into its program. The key adds each
group's backend and ranks and the model rank. A capture runs no
collective while a replay waits on its peers, so the ranks must all
capture or all replay: each call first all-gathers one integer a rank
over the gloo side group (``parallel/multihost.py::allgather_ints``), the
fields in which its key is new (``agree``). Ranks that all replay, or all
capture, go on; ranks whose keys are new only in the addresses of their
``by_address`` inputs (an allocator that reused an address on one rank
and not on another) all capture, the others recapturing their live key;
any other mix raises on every rank, naming the ranks and fields, and
never hangs.

The first call of a key runs the function eagerly on a side stream (the
warm-up, whose result that call returns: for a train step, a real
update), then captures each segment on that stream, the graphs sharing
one memory pool; a capture records kernels and runs none. The warm-up does the
one-time work a capture must not: the kernels' launch-info caches and
their once-per-device ``cudaFuncSetAttribute`` opt-ins, and cuBLAS's
workspace for the stream. Every later call copies the batch into the
static inputs, replays the graphs in order (where a segment's test is
true, runs ``skip`` and goes on with the last segment), and returns
copies of the static outputs made on the stream after the replay, so that
outputs a caller keeps are not overwritten by the next replay.

The kernel wrappers count their launches in Python where they launch: the
warm-up counts each launch, and so does the capture, which records it
into a graph. A replay runs no Python and counts nothing; its kernels are
seen on the device (a profile of the replay holds one span for each).

Each call is a ``capture.call`` span (``utils/trace.py``; attributes
``program``, the ``name`` given, and ``captured``) around ``capture.key``
(the key's walk over the parameters, buffers and optimizer state),
``capture.agree`` (with groups), then either ``capture.capture`` (the
warm-up and the capture; ``code_fields``: the fields in which the key
differs from the last live one) or ``capture.load`` (the batch into the
static inputs), a ``capture.replay`` a graph (``k``, its index) and
``capture.outputs`` (the outputs' copies).

Graphs capture with ``capture_error_mode="thread_local"``: the eval
harness copies earlier forwards' outputs to the host on pool threads
(``eval/mul_eval.py``) while the main thread may capture a new key, and
those threads' synchronising copies are legal then only in this mode.
They run on the legacy default stream, which a capture on the side
stream (a non-blocking stream) does not join.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import time
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from spacap3d_tpu_torch.parallel import multihost
from spacap3d_tpu_torch.utils import trace
from spacap3d_tpu_torch.utils.segments import Segments, run_eager

# keys whose graphs a CapturedFunction keeps at once; each holds its
# forward's memory in its pool
MAX_LIVE = 4


class Key(NamedTuple):
    model: int                # id of the model
    static: Tuple             # the model's config, the inputs' shapes, dtypes and devices,
                              # the number of generators that draw dropout masks
    weights: Tuple            # address, shape and dtype of every parameter and buffer,
                              # then the optimizer's state (``optimizer_state``)
    addresses: Tuple          # addresses of the ``by_address`` inputs
    groups: Tuple = ()        # each process group's backend and ranks, the model rank


def graph_key(model: torch.nn.Module, inputs: Dict[str, torch.Tensor],
              by_address: Sequence[str], state: Tuple = (), dropout: int = 0,
              groups: Tuple = ()) -> Key:
    return Key(
        id(model),
        (getattr(model, "cfg", None),
         tuple((k, tuple(v.shape), v.dtype, v.device) for k, v in sorted(inputs.items())),
         dropout),
        tuple((t.data_ptr(), tuple(t.shape), t.dtype)
              for t in (*model.parameters(), *model.buffers())) + state,
        tuple((k, inputs[k].data_ptr()) for k in sorted(by_address) if k in inputs),
        groups)


def group_layout(groups: Sequence, model: torch.nn.Module) -> Tuple:
    """What a step's graphs bake in about its process groups: each group's
    backend and global ranks, and the model's tensor-parallel rank."""
    return (tuple((dist.get_backend(g), tuple(dist.get_process_group_ranks(g)))
                  for g in groups)
            + (getattr(getattr(model, "caption", None), "tp_rank", 0),))


def generators_of(gen) -> Tuple[torch.Generator, ...]:
    """The generators of a dropout argument: none, one ``torch.Generator``,
    or a tuple of them (``SplitGenerators``)."""
    if gen is None:
        return ()
    return tuple(gen) if isinstance(gen, tuple) else (gen,)


def own_generators(gen, device: torch.device):
    """Fresh generators on ``device`` of the same structure as ``gen``."""
    if gen is None:
        return None
    if isinstance(gen, tuple):
        return type(gen)(*(torch.Generator(device=device) for _ in gen))
    return torch.Generator(device=device)


# the bits of a rank's code in ``CapturedFunction.agree``: its key is new,
# it is its first since a ``clear``, and the fields in which it differs from
# the key of the rank's last call
NEW, FIRST = 1, 2
FIELD_BITS = {f: 4 << i for i, f in enumerate(Key._fields)}


def new_key_code(key: Key, last: Optional[Key]) -> int:
    """The code of a rank whose ``key`` is new; ``last`` the key of its
    previous call (None after a ``clear``)."""
    if last is None:
        return NEW | FIRST
    return NEW | sum(bit for f, bit in FIELD_BITS.items()
                     if getattr(key, f) != getattr(last, f))


def code_fields(code: int) -> List[str]:
    return (["first call"] if code & FIRST else []) + [
        f for f, bit in FIELD_BITS.items() if code & bit]


def _key_value(v: Any) -> Any:
    if torch.is_tensor(v):
        return ("tensor", v.data_ptr(), v.dtype, v.device)
    return tuple(v) if isinstance(v, list) else v


def optimizer_state(optimizer: torch.optim.Optimizer) -> Tuple:
    """What a captured train step reads of ``optimizer`` besides the
    parameters: each group's hyperparameters (a tensor ``lr`` by address,
    floats by value: a graph bakes them in) and the addresses of each
    parameter's state tensors (Adam's ``exp_avg``, ``exp_avg_sq``,
    ``step``)."""
    out = []
    for group in optimizer.param_groups:
        out.append(tuple((k, _key_value(v)) for k, v in sorted(group.items()) if k != "params"))
        for p in group["params"]:
            out.append(tuple((k, _key_value(v))
                             for k, v in sorted(optimizer.state.get(p, {}).items())))
    return tuple(out)


class CudaGraphs:
    """The graphs of one key on ``device``: warm-up and capture on one side
    stream, the graphs sharing the first one's memory pool."""

    def __init__(self, device: torch.device, keep_graphs: bool = False):
        self.device = device
        self.keep_graphs = keep_graphs
        self.stream = torch.cuda.Stream(device)
        self.pool = None

    def warm_up(self, fn: Callable[[], Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
        """``fn()`` eagerly on the side stream; its outputs are the
        caller's, on the current stream."""
        current = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            out = fn()
        current.wait_stream(self.stream)
        for t in out.values():
            t.record_stream(current)
        return out

    def capture(self, fn: Callable[[], Any], generators: Sequence[torch.Generator] = ()):
        """-> (graph, ``fn``'s result: the graph's static tensors), with
        ``generators`` registered with the graph (a capture that draws from
        another generator raises). With ``keep_graphs`` the graph keeps its
        ``raw_cuda_graph`` after instantiation, for a caller that inspects
        its nodes."""
        graph = torch.cuda.CUDAGraph(keep_graph=self.keep_graphs)
        for gen in generators:
            graph.register_generator_state(gen)
        with torch.cuda.graph(graph, pool=self.pool, stream=self.stream,
                              capture_error_mode="thread_local"):
            static = fn()
        if self.keep_graphs:
            graph.instantiate()
        if self.pool is None:
            self.pool = graph.pool()
        return graph, static


class StaticInputs(dict):
    """A graph's inputs: copies of the first batch, and the ``by_address``
    inputs (read where the caller's tensors lie, so held only during a
    call). ``load`` takes a batch of the same keys, shapes and dtypes, and
    refuses any other: ``copy_`` would broadcast or cast it."""

    def __init__(self, batch: Dict[str, torch.Tensor], by_address: Sequence[str]):
        super().__init__((k, v if k in by_address else v.clone()) for k, v in batch.items())
        self.by_address = tuple(by_address)
        self.layout = {k: (tuple(v.shape), v.dtype) for k, v in batch.items()}

    def load(self, batch: Dict[str, torch.Tensor]) -> None:
        got = {k: (tuple(v.shape), v.dtype) for k, v in batch.items()}
        if got != self.layout:
            raise ValueError(f"captured inputs are {self.layout}, not {got}")
        for k, v in batch.items():
            if k in self.by_address:
                self[k] = v
            else:
                self[k].copy_(v)

    def release(self) -> None:
        for k in self.by_address:
            self.pop(k, None)


@dataclasses.dataclass
class Entry:
    inputs: StaticInputs
    carry: Dict                           # the segments' state from the capture
    skip: Optional[Callable[[Dict, int], None]]
    graphs: List[Any]
    statics: List[Any]                    # each graph's test, the last its outputs
    capture_s: float
    generators: Any                       # registered with the graphs, where they draw masks:
                                          # None, a generator or a SplitGenerators


class CapturedFunction:
    """``fn(model, inputs, generator=None) -> outputs`` (a dict of device
    tensors in, a dict out) replayed from CUDA graphs, one set a key
    (module docstring).

    ``segments_of(model)`` gives the function's ``Segments``; the graphs
    read the ``by_address`` inputs where the caller's tensors lie, and copy
    the others into static inputs. ``state_of()``, where given, is the
    rest of what the graphs read (a train step's ``optimizer_state``),
    part of the key; ``generator``, where given, is the dropout masks'
    (a ``torch.Generator`` or a ``SplitGenerators``; the parts read it as
    the carry's ``"gen"``). ``groups_of(model)``, where given, are the
    process groups whose collectives the graphs hold; with any, every call
    first agrees with the other ranks on capture or replay (``agree``).
    At most MAX_LIVE keys keep their graphs (the least recently used goes
    first); a new key also drops the graphs of keys that will not come
    back: those of the same model with other weights or optimizer state (a
    replaced parameter, a loaded state), and those that read other
    ``by_address`` inputs (a new point table); ``clear`` drops them all.
    ``backend`` makes the graphs of one key on a device (``CudaGraphs``:
    its ``warm_up`` and ``capture``, a graph's ``replay``), keeping each
    graph's ``raw_cuda_graph`` where ``keep_graphs`` is set.

    ``last`` describes the last call: ``captured`` (a new key's warm-up
    and capture) or not, the indices of the graphs it replayed
    (``replayed``) and the seconds of its key's capture, after the warm-up
    (``capture_s``). ``entries`` holds each key's ``Entry``, the most
    recently used last. ``name`` ("train", "eval") names the program in
    its spans (module docstring)."""

    def __init__(self, segments_of: Callable[[torch.nn.Module], Segments],
                 by_address: Sequence[str] = (), backend=CudaGraphs,
                 state_of: Optional[Callable[[], Tuple]] = None,
                 groups_of: Optional[Callable[[torch.nn.Module], Sequence]] = None,
                 name: str = ""):
        self.segments_of = segments_of
        self.name = name
        self.by_address = tuple(by_address)
        self.backend = backend
        self.state_of = state_of
        self.groups_of = groups_of
        self.keep_graphs = False
        self.entries: "collections.OrderedDict[Key, Entry]" = collections.OrderedDict()
        self.last: Dict[str, Any] = {}

    def key(self, model, inputs, generator, groups: Sequence = ()) -> Key:
        return graph_key(model, inputs, self.by_address,
                         self.state_of() if self.state_of is not None else (),
                         len(generators_of(generator)),
                         group_layout(groups, model) if groups else ())

    def __call__(self, model: torch.nn.Module, inputs: Dict[str, torch.Tensor],
                 generator=None) -> Dict[str, torch.Tensor]:
        with trace.span("capture.call", program=self.name) as call:
            groups = list(self.groups_of(model)) if self.groups_of is not None else []
            with trace.span("capture.key"):
                key = self.key(model, inputs, generator, groups)
            entry = self.entries.get(key)
            if groups:
                with trace.span("capture.agree"):
                    capture = self.agree(key, entry is None, groups)
                if capture and entry is not None:
                    del self.entries[key]       # peers capture: this rank recaptures its key
                    entry = None
            if call:
                call.set(captured=entry is None)
            if entry is None:
                with trace.span("capture.capture") as span:
                    if span:
                        last = next(reversed(self.entries)) if self.entries else None
                        span.set(code_fields=code_fields(new_key_code(key, last)))
                    return self._capture(key, model, inputs, generator)
            self.entries.move_to_end(key)
            return self._replay(entry, inputs, generator)

    def agree(self, key: Key, new: bool, groups: Sequence) -> bool:
        """Whether every rank captures (True) or replays (False) in this
        call, from one integer a rank all-gathered over the gloo side group
        (``new_key_code``; 0: the key is live). The step's groups must span
        the world, whose every rank calls the step at once. Raises on every
        rank where some ranks have a new key and others replay, unless the
        new keys differ from their last only in the ``by_address`` inputs'
        addresses."""
        sizes = 1
        for g in {id(g): g for g in groups}.values():
            sizes *= dist.get_world_size(g)
        if sizes != dist.get_world_size():
            raise ValueError(f"a captured step's groups span {sizes} of the world's "
                             f"{dist.get_world_size()} ranks: every rank of the world runs "
                             f"the step at once, so that the ranks agree on capture or replay")
        last = next(reversed(self.entries)) if self.entries else None
        codes = multihost.allgather_ints(new_key_code(key, last) if new else 0)
        fresh = [r for r, c in enumerate(codes) if c]
        if len(fresh) in (0, len(codes)):
            return bool(fresh)
        if all(code_fields(codes[r]) == ["addresses"] for r in fresh):
            return True
        raise RuntimeError(
            "captured step: the ranks disagree on capture or replay: ranks "
            f"{fresh} have a new graph key ("
            + "; ".join(f"rank {r}: {', '.join(code_fields(codes[r]))} changed" for r in fresh)
            + f"), ranks {[r for r, c in enumerate(codes) if not c]} replay theirs; their "
            "collectives would not match")

    def clear(self) -> None:
        """Drops every key's graphs, which frees their memory pools. Under
        process groups every rank clears at the same call."""
        self.entries.clear()

    def _drop_stale(self, key: Key) -> None:
        for old in list(self.entries):
            if ((old.model == key.model and old.weights != key.weights)
                    or (key.addresses and old.addresses and old.addresses != key.addresses)):
                del self.entries[old]
        while len(self.entries) >= MAX_LIVE:
            self.entries.popitem(last=False)

    def _capture(self, key: Key, model, inputs, generator):
        self._drop_stale(key)
        device = next(iter(inputs.values())).device
        runner = self.backend(device, keep_graphs=self.keep_graphs)
        static = StaticInputs(inputs, self.by_address)
        segments = self.segments_of(model)
        out = runner.warm_up(lambda: run_eager(segments, static, gen=generator))
        t0 = time.perf_counter()
        own = own_generators(generator, device)
        carry = {"inputs": static, "gen": own}
        graphs, statics = [], []
        around = segments.around_capture or (lambda carry: contextlib.nullcontext())
        with around(carry):
            for part in segments.parts:
                graph, st = runner.capture(lambda part=part: part(carry),
                                           generators=generators_of(own))
                graphs.append(graph)
                statics.append(st)
        static.release()
        # the warm-up may have made state the graphs read (Adam's moments
        # at a first step): the key is what the graphs read now
        key = key._replace(weights=self.key(model, inputs, generator).weights)
        self.entries[key] = Entry(static, carry, segments.skip, graphs, statics,
                                  time.perf_counter() - t0, own)
        self.last = {"captured": True, "replayed": [], "capture_s": self.entries[key].capture_s}
        return out

    def _replay(self, entry: Entry, inputs, generator):
        with trace.span("capture.load"):
            entry.inputs.load(inputs)
        pairs = list(zip(generators_of(entry.generators), generators_of(generator)))
        for own, theirs in pairs:
            own.set_state(theirs.get_state())
        try:
            last, k, ran = len(entry.graphs) - 1, 0, []
            while True:
                with trace.span("capture.replay", k=k):
                    entry.graphs[k].replay()
                ran.append(k)
                if k == last:
                    break
                test = entry.statics[k]
                if test is not None and bool(test):
                    entry.skip(entry.carry, k)
                    k = last
                else:
                    k += 1
            with trace.span("capture.outputs"):
                out = {name: t.clone() for name, t in entry.statics[-1].items()}
            for own, theirs in pairs:
                theirs.set_state(own.get_state())
        finally:
            entry.inputs.release()
        self.last = {"captured": False, "replayed": ran, "capture_s": entry.capture_s}
        return out
