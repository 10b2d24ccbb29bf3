"""CUDA-graph replay of a function's operator chains between the calls it
keeps eager.

`graphed(fn)` wraps a function of tensors and Python values, walked as a
tree by `torch.utils._pytree` (tuples, lists, dicts, named tuples, and
dataclasses registered with `pytree.register_dataclass`).  On a card the
first two calls with a given key run eagerly, the third captures, and
later ones replay (`Policy`):

- The key (`key_of`) is the arguments' tree: each tensor's shape, strides,
  dtype and device, and every other leaf (a Python scalar, a flag, None)
  as it is, since captured operators bake those in; beside them the
  autograd mode, the float32 matmul precision and the current stream.
- A capture runs fn once on static copies of its tensor arguments, as a
  sequence of CUDA graphs that share one memory pool, cut wherever fn calls
  `call` or enters or leaves a `span`.  Those run eagerly, outside every
  graph: a kernel's wrapper is still called through its module name on
  every call, and a stage span still marks the stream.  Each graph replays
  right after its capture, so the capturing call returns what an eager call
  would.  Each graph is captured under `torch.cuda.set_sync_debug_mode(
  "error")`: an operator that waits for the card fails the capture.
- A replay copies the tensor arguments into the static buffers, replays the
  graphs in order, and between them enters and leaves the spans and makes
  the eager calls again, through the callable `call` resolves at that time;
  a call that returns another tree, or tensors of another shape, dtype or
  device than when it was captured, raises.
- No tensor that leaves the graphed code aliases graph memory: the
  arguments of an eager call and the results are clones of the graphs'
  tensors (one clone per tensor and call), or the caller's own tensor where
  a graph passed one through unchanged (as an eager call would return it).
  The caller may keep them: a later replay writes graph memory only.
- Every mode returns contiguous tensors in canonical strides (an eager
  call's strided views are copied), so that a function fed its own outputs
  sees one key: strides are part of it.

Calls with a tensor off the card or with a value that does not hash, and
keys seen fewer than three times, run eagerly.  A key whose capture fails runs eagerly from
then on, with a warning that names where it failed; the failing call runs
fn again eagerly, and the calls the capture had already made are not made
twice (`_Resume`).  A process-wide LRU (`Policy`) keeps the graphs of at
most MAX_KEYS keys.  The wrapper counts its calls in `.graphs` (each call
one of "captured", "replayed", "eager"; "failed" counts failed captures,
whose calls then ran eagerly).
"""

from __future__ import annotations

import collections
import contextlib
import functools
import inspect
import os
import threading
import traceback
import warnings

import torch
from torch.utils import _pytree as pytree

from . import timing

MAX_KEYS = 8  # keys whose graphs a graphed function keeps
MAX_SEEN = 256  # keys not captured (seen too few times, or failed) it remembers
CAPTURE_AT = 3  # the sighting of a key that captures (`Policy`)
EAGER, CAPTURE, REPLAY = "eager", "capture", "replay"

_EMPTY = "CUDA Graph is empty"  # torch's warning for a capture with no work
_local = threading.local()


# ---------------------------------------------------------------------------
# keys
# ---------------------------------------------------------------------------

def _is_tensor(x) -> bool:
    return isinstance(x, torch.Tensor)


def _tensors(leaves) -> list:
    return [x for x in leaves if _is_tensor(x)]


def _swap(leaves, fn) -> list:
    """leaves with each tensor x replaced by fn(x)."""
    return [fn(x) if _is_tensor(x) else x for x in leaves]


def key_of(spec, leaves):
    """The key of a call whose arguments flatten to (leaves, spec): the
    tree, each tensor's shape, strides (none for an empty tensor, whose
    strides address nothing), dtype and device, each other leaf with its
    type, and the modes its operators depend on; None where a value does not
    hash."""
    tensors = _tensors(leaves)
    stream = (torch.cuda.current_stream(tensors[0].device).cuda_stream
              if tensors and tensors[0].is_cuda else None)
    key = (spec, tuple((x.shape, x.stride() if x.numel() else None, x.dtype, x.device)
                       if _is_tensor(x) else (type(x), x) for x in leaves),
           torch.is_grad_enabled(), torch.is_inference_mode_enabled(),
           torch.get_float32_matmul_precision(), stream)
    try:
        hash(key)
    except TypeError:
        return None
    return key


def on_card(leaves) -> bool:
    """Whether a call on these leaves may run as CUDA graphs: it has
    tensors, all on a card."""
    tensors = _tensors(leaves)
    return bool(tensors) and all(x.is_cuda for x in tensors)


# ---------------------------------------------------------------------------
# policy
# ---------------------------------------------------------------------------

class Policy:
    """Which calls run eagerly, capture or replay, by key: a key runs
    eagerly until its CAPTURE_AT-th sighting, which captures; the graphs of
    at most `max_keys` keys are kept, the least recently used evicted first
    (an evicted key captures again at its next sighting); a key whose
    capture failed runs eagerly.  None (no key) always runs eagerly.

    A capture of the images-in frame costs about three eager calls on an
    H100 at B = 1, a replay a fraction of one, so a key pays for its
    capture only if it comes back several times.  Keys that come in pairs
    are common: dynamic cloning's pixel noise changes at each clone, every
    second frame at 5 Hz clones and 10 Hz frames.  Captured at their second
    sighting such keys would never replay; hence the third."""

    def __init__(self, max_keys: int = MAX_KEYS, max_seen: int = MAX_SEEN):
        self.max_keys, self.max_seen = max_keys, max_seen
        self.graphs = collections.OrderedDict()  # key -> its captured graphs
        self.seen = collections.OrderedDict()  # key -> eager sightings (0: its capture failed)

    def decide(self, key) -> str:
        if key is None:
            return EAGER
        if key in self.graphs:
            self.graphs.move_to_end(key)
            return REPLAY
        n = self.seen.get(key)  # None: not seen; 0: its capture failed
        if n == 0:
            return EAGER
        n = (n or 0) + 1
        if n >= CAPTURE_AT:
            return CAPTURE
        self._remember(key, n)
        return EAGER

    def store(self, key, graphs):
        self.seen.pop(key, None)
        self.graphs[key] = graphs
        while len(self.graphs) > self.max_keys:
            self._remember(self.graphs.popitem(last=False)[0], CAPTURE_AT - 1)

    def failed(self, key):
        self._remember(key, 0)

    def _remember(self, key, n: int):
        self.seen[key] = n
        self.seen.move_to_end(key)
        while len(self.seen) > self.max_seen:
            self.seen.popitem(last=False)


# ---------------------------------------------------------------------------
# capture and replay
# ---------------------------------------------------------------------------

class _Out:
    """What leaves the graphed code in one call: a static tensor maps to the
    caller's tensor it was copied from (`src`), else to its contiguous
    clone, made once per call."""

    def __init__(self):
        self.src, self.memo = {}, {}

    def __call__(self, t):
        x = self.src.get(id(t))
        if x is None:
            x = self.memo.get(id(t))
            if x is None:
                x = self.memo[id(t)] = t.clone(memory_format=torch.contiguous_format)
        return x


def _like(t):
    """An empty tensor of t's shape, strides, dtype and device."""
    return torch.empty_strided(t.shape, t.stride(), dtype=t.dtype, device=t.device)


def _eager_call(out: _Out, event):
    """The eager call of a recorded event ("call", resolve, spec, leaves,
    res_spec, res_static) on what its tensors map to, its results copied
    into res_static; a result of another tree, shape, dtype or device than
    the recorded one raises."""
    _, resolve, spec, leaves, res_spec, res_static = event
    args, kwargs = pytree.tree_unflatten(_swap(leaves, out), spec)
    res_leaves, spec_now = pytree.tree_flatten(resolve()(*args, **kwargs))
    if spec_now != res_spec:
        raise RuntimeError(f"graphs: {resolve()!r} returned another tree than when it was "
                           "captured")
    for s, r in zip(res_static, res_leaves):
        if not _is_tensor(s):
            same = type(r) is type(s) and r == s
        else:
            same = _is_tensor(r) and (r.shape, r.dtype, r.device) == (s.shape, s.dtype, s.device)
        if not same:
            raise RuntimeError(f"graphs: {resolve()!r} returned {r!r:.80} where it returned "
                               f"{s!r:.80} when it was captured")
    for s, r in zip(_tensors(res_static), _tensors(res_leaves)):
        s.copy_(r)
        out.src[id(s)] = r


class _Capture:
    """A call being captured: the graphs so far, cut at each eager call and
    span, on a side stream, into one memory pool; `made` keeps each eager
    call's callable and results, for `_Resume` should the capture fail."""

    def __init__(self, dev):
        self.main = torch.cuda.current_stream(dev)
        self.side = _side_stream(dev)
        self.pool = torch.cuda.graph_pool_handle()
        self.out = _Out()
        self.events = []
        self.made = []
        self.empty = []  # graphs with no work: kept, since their release frees the pool
        self.graph = None
        self.sync_mode = None

    def begin(self):
        self.side.wait_stream(self.main)
        self.sync_mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        torch.cuda.set_stream(self.side)
        self.graph = torch.cuda.CUDAGraph()
        self.graph.capture_begin(pool=self.pool)

    def _leave(self):
        torch.cuda.set_stream(self.main)
        torch.cuda.set_sync_debug_mode(self.sync_mode)

    def cut(self):
        """End the graph being captured and replay it; an empty one is
        dropped."""
        g, self.graph = self.graph, None
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                g.capture_end()
        finally:
            self._leave()
        empty = False
        for w in caught:
            if _EMPTY in str(w.message):
                empty = True
            else:
                warnings.warn_explicit(w.message, w.category, w.filename, w.lineno)
        if empty:
            self.empty.append(g)
        else:
            self.main.wait_stream(self.side)
            g.replay()
            self.events.append(("graph", g))

    def abort(self):
        """End a capture under way without keeping it."""
        g, self.graph = self.graph, None
        if g is None:
            return
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                g.capture_end()
        except RuntimeError:
            pass
        finally:
            self._leave()

    def call(self, resolve, args, kwargs):
        self.cut()
        leaves, spec = pytree.tree_flatten((args, kwargs))
        fn = resolve()
        args, kwargs = pytree.tree_unflatten(_swap(leaves, self.out), spec)
        res = fn(*args, **kwargs)
        self.made.append((fn, res))
        res_leaves, res_spec = pytree.tree_flatten(res)
        res_static = _swap(res_leaves, _like)
        for s, r in zip(_tensors(res_static), _tensors(res_leaves)):
            s.copy_(r)
            self.out.src[id(s)] = r
        self.events.append(("call", resolve, spec, leaves, res_spec, res_static))
        self.begin()
        return pytree.tree_unflatten(res_static, res_spec)

    @contextlib.contextmanager
    def span(self, name: str):
        self.cut()
        cm = timing.span(name)
        cm.__enter__()
        self.events.append(("enter", name))
        self.begin()
        try:
            yield
            self.cut()
        except BaseException:
            self.abort()
            cm.__exit__(None, None, None)
            raise
        cm.__exit__(None, None, None)
        self.events.append(("exit",))
        self.begin()


class _Resume:
    """The eager rerun of a call whose capture failed: the eager calls the
    capture made return their results again, in order, instead of being
    made twice (a kernel's counter and whoever wraps it see each call once);
    the calls after them are made."""

    def __init__(self, made):
        self.made = collections.deque(made)

    def call(self, resolve, args, kwargs):
        fn = resolve()
        if self.made and self.made[0][0] is fn:
            return self.made.popleft()[1]
        self.made.clear()
        return fn(*args, **kwargs)

    def span(self, name: str):
        return timing.span(name)


class Captured:
    """One key's graphs: the static inputs, the recorded events (graphs,
    eager calls, span entries and exits) and the outputs."""

    def __init__(self, cap: _Capture, static_in, out_spec, out_leaves):
        self.pool, self.events, self.empty = cap.pool, cap.events, cap.empty
        self.static_in, self.out_spec, self.out_leaves = static_in, out_spec, out_leaves

    def replay(self, leaves):
        out = _Out()
        for s, x in zip(_tensors(self.static_in), _tensors(leaves)):
            s.copy_(x)
            out.src[id(s)] = x
        spans = []
        try:
            for ev in self.events:
                kind = ev[0]
                if kind == "graph":
                    ev[1].replay()
                elif kind == "call":
                    _eager_call(out, ev)
                elif kind == "enter":
                    spans.append(timing.span(ev[1]))
                    spans[-1].__enter__()
                else:
                    spans.pop().__exit__(None, None, None)
        finally:
            while spans:
                spans.pop().__exit__(None, None, None)
        return pytree.tree_unflatten(_swap(self.out_leaves, out), self.out_spec)


def _canonical(t) -> bool:
    """t has a contiguous tensor's strides, to the stride of a size-1 dim
    (which `is_contiguous` lets differ, and the key sees)."""
    expect = 1
    for size, stride in zip(reversed(t.shape), reversed(t.stride())):
        if stride != expect:
            return False
        expect *= max(size, 1)
    return True


def _contiguous(x):
    """x with every tensor contiguous, in canonical strides (a copy where a
    tensor is not)."""
    leaves, spec = pytree.tree_flatten(x)
    if all(_canonical(t) for t in _tensors(leaves)):
        return x
    return pytree.tree_unflatten(
        _swap(leaves, lambda t: t if _canonical(t) else t.clone(
            memory_format=torch.contiguous_format)), spec)


@functools.cache
def _side_stream(dev):
    """The stream captures run on (a capture cannot use the default one)."""
    return torch.cuda.Stream(dev)


@contextlib.contextmanager
def _running(state):
    """Make state (a `_Capture` or a `_Resume`) the one `call` and `span`
    go through."""
    _local.state = state
    try:
        yield state
    finally:
        _local.state = None


def _capture(fn, cap: _Capture, spec, leaves):
    """Capture fn on static copies of the tensors among `leaves`: (Captured,
    fn's outputs)."""
    static_in = _swap(leaves, _like)
    for s, x in zip(_tensors(static_in), _tensors(leaves)):
        s.copy_(x)
        cap.out.src[id(s)] = x
    with _running(cap):
        cap.begin()
        try:
            result = fn(**pytree.tree_unflatten(static_in, spec))
            cap.cut()
        except BaseException:
            cap.abort()
            raise
    out_leaves, out_spec = pytree.tree_flatten(result)
    out = pytree.tree_unflatten(_swap(out_leaves, cap.out), out_spec)
    return Captured(cap, static_in, out_spec, out_leaves), out


def _where(e: BaseException) -> str:
    """file:line of the innermost frame of e's traceback outside torch and
    this module: the operator that failed a capture."""
    skip = (os.path.dirname(torch.__file__), __file__)
    frames = [f for f in traceback.extract_tb(e.__traceback__) if not f.filename.startswith(skip)]
    return f"{frames[-1].filename}:{frames[-1].lineno}" if frames else "an unknown line"


# ---------------------------------------------------------------------------
# what graphed code calls
# ---------------------------------------------------------------------------

def call(resolve, *args, **kwargs):
    """resolve()(*args, **kwargs), outside every CUDA graph.  `resolve`
    returns the callable (e.g. `lambda: module.fn`) and is asked again at
    every replay, so that a rebinding of the name takes effect."""
    state = getattr(_local, "state", None)
    if state is None:
        return resolve()(*args, **kwargs)
    return state.call(resolve, args, kwargs)


def span(name: str):
    """`utils/timing.span(name)`, entered and left outside every CUDA
    graph."""
    state = getattr(_local, "state", None)
    return timing.span(name) if state is None else state.span(name)


def graphed(fn):
    """fn, run as CUDA graphs where its key repeats (module docstring).  fn
    takes no *args or **kwargs; the wrapper has `.graphs` (the counts) and
    `.policy` (its `Policy`, which a caller may replace by a fresh one)."""
    sig = inspect.signature(fn)
    if any(p.kind not in (p.POSITIONAL_OR_KEYWORD, p.KEYWORD_ONLY)
           for p in sig.parameters.values()):
        raise TypeError(f"graphed: {fn.__qualname__} takes *args, **kwargs or positional-only "
                        "parameters")

    @functools.wraps(fn)
    def run(*args, **kwargs):
        policy, counts = run.policy, run.graphs
        bound = sig.bind(*args, **kwargs)
        bound.apply_defaults()
        leaves, spec = pytree.tree_flatten(dict(bound.arguments))
        key = key_of(spec, leaves) if on_card(leaves) else None
        mode = policy.decide(key)
        if mode == REPLAY:
            counts["replayed"] += 1
            return _contiguous(policy.graphs[key].replay(leaves))
        resume = None
        if mode == CAPTURE:
            cap = _Capture(_tensors(leaves)[0].device)
            n_spans = len(timing._RECORDER.done)
            try:
                captured, out = _capture(fn, cap, spec, leaves)
            except Exception as e:  # the call runs eagerly instead, and says so
                policy.failed(key)
                counts["failed"] += 1
                del timing._RECORDER.done[n_spans:]  # the rerun records the call's spans
                resume = _Resume(cap.made)
                warnings.warn(f"{fn.__qualname__}: CUDA graph capture failed at {_where(e)} "
                              f"({e!r}); this key runs eagerly", RuntimeWarning, stacklevel=2)
            else:
                policy.store(key, captured)
                counts["captured"] += 1
                return _contiguous(out)
        counts["eager"] += 1
        if resume is None:
            return _contiguous(fn(*args, **kwargs))
        with _running(resume):
            return _contiguous(fn(*args, **kwargs))

    run.graphs = {"captured": 0, "replayed": 0, "eager": 0, "failed": 0}
    run.policy = Policy()
    return run
