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

Dropout: a train program owns one generator a key, registered with its
graphs (``CUDAGraph.register_generator_state``), so that a replay draws
from the state that generator holds when it starts and advances it by
what the capture drew. A call loads the caller's generator state into it
before the replay and writes the advanced state back after, so the
caller's generator ends where an eager step would leave it.

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

from spacap3d_tpu_torch.utils.segments import Segments, run_eager

# keys whose graphs a CapturedFunction keeps at once; each holds its
# forward's memory in its pool
MAX_LIVE = 4


class Key(NamedTuple):
    model: int                # id of the model
    static: Tuple             # the model's config, the inputs' shapes, dtypes and devices,
                              # whether a generator draws dropout masks
    weights: Tuple            # address, shape and dtype of every parameter and buffer,
                              # then the optimizer's state (``optimizer_state``)
    addresses: Tuple          # addresses of the ``by_address`` inputs


def graph_key(model: torch.nn.Module, inputs: Dict[str, torch.Tensor],
              by_address: Sequence[str], state: Tuple = (), dropout: bool = False) -> Key:
    return Key(
        id(model),
        (getattr(model, "cfg", None),
         tuple((k, tuple(v.shape), v.dtype, v.device) for k, v in sorted(inputs.items())),
         dropout),
        tuple((t.data_ptr(), tuple(t.shape), t.dtype)
              for t in (*model.parameters(), *model.buffers())) + state,
        tuple((k, inputs[k].data_ptr()) for k in sorted(by_address) if k in inputs))


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
    generator: Optional[torch.Generator]  # registered with the graphs, where they draw masks


class CapturedFunction:
    """``fn(model, inputs, generator=None) -> outputs`` (a dict of device
    tensors in, a dict out) replayed from CUDA graphs, one set a key
    (module docstring).

    ``segments_of(model)`` gives the function's ``Segments``; the graphs
    read the ``by_address`` inputs where the caller's tensors lie, and copy
    the others into static inputs. ``state_of()``, where given, is the
    rest of what the graphs read (a train step's ``optimizer_state``),
    part of the key; ``generator``, where given, is the dropout masks'
    (the parts read it as the carry's ``"gen"``). At most MAX_LIVE keys
    keep their graphs (the least recently used goes first); a new key also
    drops the graphs of keys that will not come back: those of the same
    model with other weights or optimizer state (a replaced parameter, a
    loaded state), and those that read other ``by_address`` inputs (a new
    point table); ``clear`` drops them all.
    ``backend`` makes the graphs of one key on a device (``CudaGraphs``:
    its ``warm_up`` and ``capture``, a graph's ``replay``), keeping each
    graph's ``raw_cuda_graph`` where ``keep_graphs`` is set.

    ``last`` describes the last call: ``captured`` (a new key's warm-up
    and capture) or not, the indices of the graphs it replayed
    (``replayed``), the capture's seconds and the live keys. ``entries``
    holds each key's ``Entry``, the most recently used last."""

    def __init__(self, segments_of: Callable[[torch.nn.Module], Segments],
                 by_address: Sequence[str] = (), backend=CudaGraphs,
                 state_of: Optional[Callable[[], Tuple]] = None):
        self.segments_of = segments_of
        self.by_address = tuple(by_address)
        self.backend = backend
        self.state_of = state_of
        self.keep_graphs = False
        self.entries: "collections.OrderedDict[Key, Entry]" = collections.OrderedDict()
        self.last: Dict[str, Any] = {}

    def key(self, model, inputs, generator) -> Key:
        return graph_key(model, inputs, self.by_address,
                         self.state_of() if self.state_of is not None else (),
                         generator is not None)

    def __call__(self, model: torch.nn.Module, inputs: Dict[str, torch.Tensor],
                 generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        key = self.key(model, inputs, generator)
        entry = self.entries.get(key)
        if entry is None:
            return self._capture(key, model, inputs, generator)
        self.entries.move_to_end(key)
        return self._replay(entry, inputs, generator)

    def clear(self) -> None:
        """Drops every key's graphs, which frees their memory pools."""
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
        own = None if generator is None else torch.Generator(device=device)
        carry = {"inputs": static, "gen": own}
        graphs, statics = [], []
        around = segments.around_capture or (lambda carry: contextlib.nullcontext())
        with around(carry):
            for part in segments.parts:
                graph, st = runner.capture(lambda part=part: part(carry),
                                           generators=() if own is None else (own,))
                graphs.append(graph)
                statics.append(st)
        static.release()
        # the warm-up may have made state the graphs read (Adam's moments
        # at a first step): the key is what the graphs read now
        key = self.key(model, inputs, generator)
        self.entries[key] = Entry(static, carry, segments.skip, graphs, statics,
                                  time.perf_counter() - t0, own)
        self.last = {"captured": True, "replayed": [], "capture_s": self.entries[key].capture_s,
                     "live": len(self.entries)}
        return out

    def _replay(self, entry: Entry, inputs, generator):
        entry.inputs.load(inputs)
        if entry.generator is not None:
            entry.generator.set_state(generator.get_state())
        try:
            last, k, ran = len(entry.graphs) - 1, 0, []
            while True:
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
            out = {name: t.clone() for name, t in entry.statics[-1].items()}
            if entry.generator is not None:
                generator.set_state(entry.generator.get_state())
        finally:
            entry.inputs.release()
        self.last = {"captured": False, "replayed": ran, "capture_s": entry.capture_s,
                     "live": len(self.entries)}
        return out
