"""CUDA graphs of a module's forward: one a signature of its inputs,
captured once and replayed after.

A host-bound forward (SDXL's UNet: ~2,550 kernel launches, the card idle
most of the time while the host issues them) costs the host one launch
at a time; its graph is one launch.  `Graphs` owns one module's graphs:

* a call's signature is the structure of its arguments (which are None,
  the keys of each dict) and each tensor's shape, dtype, device and
  strides;
* a signature's first call runs eagerly.  Its second runs eagerly on a
  side stream (the warm-up, whose output it returns) and then captures
  the forward there into a graph whose inputs are static buffers, with
  `capture_error_mode="thread_local"` so that CUDA work on other threads
  (a server's handlers) does not break it;
* every later call copies its tensors into the static buffers, replays
  the graph and returns a clone of the static output: a caller may hold
  one call's output across the next;
* at most `MAX_GRAPHS` signatures keep a graph, the least recently used
  dropped first, and a dropped signature runs eagerly from then on: more
  signatures in turn than the cap holds would otherwise recapture at
  every turn.  `clear()` drops them all and forgets them; a dropped
  graph's memory pool goes back to the caching allocator at its next
  `empty_cache` or failed allocation.

The hand-written kernels launch on PyTorch's current stream
(`ops/cuda_build.stream_handle`), so a capture records them as they are.
A call runs eagerly unless the caller allows a graph (`eager=False`),
grad is off, every argument is a tensor, None or a dict, list or tuple of
them, the tensors lie on one CUDA device and no capture runs on it.
Nothing configures this: the module decides from what it sees.

Counters (`telemetry.summary()["graphs"]`): `captures`, `replays` and
`eager` (the calls that ran eagerly, a signature's first two among them).
A replay passes no kernel wrapper, so the wrappers' `.launches` count the
launches the host issued (a capture's among them); what the card ran,
replays included, is counted from its trace (`telemetry.card_kernels`).
"""

from __future__ import annotations

import collections
import threading

import torch

from .. import telemetry

# A job sends one signature (the sampler's batch, CFG batched or not); a
# server's pipeline one a variant's latent shape and CFG mode, at its one
# padded batch size (`serve.pipeline_runner`).  Four holds a few variants.
MAX_GRAPHS = 4


class _Opaque(Exception):
    """An argument that a signature cannot describe."""


def _key(obj, tensors: list):
    if isinstance(obj, torch.Tensor):
        tensors.append(obj)
        return tuple(obj.shape), obj.dtype, obj.device, obj.stride()
    if obj is None:
        return None
    if isinstance(obj, dict):
        return ("dict",) + tuple((k, _key(obj[k], tensors)) for k in sorted(obj))
    if isinstance(obj, (list, tuple)):
        return (type(obj).__name__,) + tuple(_key(v, tensors) for v in obj)
    raise _Opaque(type(obj).__name__)


def _rebuild(obj, tensors):
    """`obj` with its tensors replaced, in `_key`'s order, by the next of
    the iterator `tensors`."""
    if isinstance(obj, torch.Tensor):
        return next(tensors)
    if isinstance(obj, dict):
        return {k: _rebuild(obj[k], tensors) for k in sorted(obj)}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_rebuild(v, tensors) for v in obj)
    return obj


def signature(args: tuple):
    """(key, tensors) of a call's positional arguments: the hashable key
    and the tensors in a fixed order; None where an argument holds other
    than tensors, None, and dicts (str keys), lists and tuples of them."""
    tensors = []
    try:
        return _key(args, tensors), tensors
    except (_Opaque, TypeError):  # TypeError: dict keys that do not sort
        return None


def _card_idle(device: torch.device) -> bool:
    """Whether `device` is a CUDA card with no capture running on its
    current stream."""
    if device.type != "cuda":
        return False
    with torch.cuda.device(device):
        return not torch.cuda.is_current_stream_capturing()


def capturable(tensors: list) -> bool:
    """Whether a call on `tensors` may take a graph: grad off, every tensor
    on one device, and that a card with no capture running."""
    if not tensors or torch.is_grad_enabled():
        return False
    device = tensors[0].device
    return all(t.device == device for t in tensors) and _card_idle(device)


def capture(fn, args: tuple, device: torch.device):
    """`fn(*args)` run once on a side stream (the warm-up), then captured
    on it: (graph, its static output, the warm-up's output, which the
    caller's stream may use)."""
    with torch.cuda.device(device):
        main, side = torch.cuda.current_stream(), torch.cuda.Stream()
        side.wait_stream(main)
        with torch.cuda.stream(side):
            warm = fn(*args)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side, capture_error_mode="thread_local"):
            output = fn(*args)
        main.wait_stream(side)
        warm.record_stream(main)  # freed, its memory waits for the caller's stream
    return graph, output, warm


class _Graph:
    """One signature's graph, static inputs and output."""

    __slots__ = ("graph", "inputs", "output")

    def replay(self, tensors: list) -> torch.Tensor:
        torch._foreach_copy_(self.inputs, tensors)
        self.graph.replay()
        telemetry.count_graphs("replays")
        return self.output.clone()


class Graphs:
    """One module's graphs by signature (module docstring).  Call it as
    `graphs(fn, *args, eager=...)` in the module's forward, `fn` the
    eager forward: it returns `fn(*args)`, replayed where it can."""

    def __init__(self):
        self._graphs = collections.OrderedDict()  # key -> _Graph, least recent first
        self._seen = collections.OrderedDict()  # keys called once, as a set
        self._dropped = set()  # keys whose graph the cap dropped: eager from then on
        self._lock = threading.Lock()  # a replay writes the static inputs

    def __len__(self) -> int:
        return len(self._graphs)

    def __call__(self, fn, *args, eager: bool = False):
        sig = None if eager else signature(args)
        if sig is not None and capturable(sig[1]):
            key, tensors = sig
            with self._lock:
                entry = self._graphs.get(key)
                if entry is not None:
                    self._graphs.move_to_end(key)
                    return entry.replay(tensors)
                if key in self._seen:
                    del self._seen[key]
                    telemetry.count_graphs("eager")
                    return self._capture(key, fn, args, tensors)
                if key not in self._dropped:
                    self._seen[key] = None
                    while len(self._seen) > MAX_GRAPHS:
                        self._seen.popitem(last=False)
        telemetry.count_graphs("eager")
        return fn(*args)

    def _capture(self, key, fn, args: tuple, tensors: list):
        """Capture `fn` on static copies of `tensors`; returns the warm-up's
        output, this call's result."""
        entry = _Graph()
        entry.inputs = [torch.empty_like(t) for t in tensors]
        torch._foreach_copy_(entry.inputs, tensors)
        static_args = _rebuild(args, iter(entry.inputs))
        entry.graph, entry.output, warm = capture(fn, static_args, tensors[0].device)
        telemetry.count_graphs("captures")
        self._graphs[key] = entry
        while len(self._graphs) > MAX_GRAPHS:
            old, dropped = self._graphs.popitem(last=False)
            dropped.graph.reset()
            self._dropped.add(old)
        return warm

    def clear(self) -> None:
        """Drop every graph and forget every signature (new weights, or
        weights moved: a graph holds the old ones' addresses)."""
        with self._lock:
            for entry in self._graphs.values():
                entry.graph.reset()
            self._graphs.clear()
            self._seen.clear()
            self._dropped.clear()
