"""The CUDA-graph policy of the port's images-in frame, on the CPU.

`plviwo_tpu_torch.utils.graphs` decides per call whether `fused_frame`
runs eagerly, captures its CUDA graphs or replays them.  The capture and
the replay need a card (tests/test_torch_cuda.py); what decides between
them is plain Python and is tested here: the tree walk, the key (the
Python values the captured operators bake in, each tensor's shape,
strides and dtype), which tensors a graph may take, the third-sighting
and LRU policy, a failed capture's eager rerun, the check of an eager
call's results at a replay, and that a call on CPU tensors never
captures.  The frame itself returns contiguous tensors, so that a
sequence of frames fed their own outputs keeps one key from its first
frame on, and issues no operator that reads a value back from the device
(on a card each would fail the capture).
"""

import dataclasses
import math
import traceback
from typing import NamedTuple

import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode, _disable_current_modes

from plviwo_tpu_torch import examples
from plviwo_tpu_torch.core import frame
from plviwo_tpu_torch.core.layout import StateLayout
from plviwo_tpu_torch.core.state import FilterState
from plviwo_tpu_torch.sim.simulator import SimConfig, Simulator
from plviwo_tpu_torch.utils import graphs, timing

torch.set_num_threads(1)


class _Pair(NamedTuple):
    x: torch.Tensor
    y: float


def _key(*args, **kwargs):
    leaves, spec = pytree.tree_flatten((args, kwargs))
    return graphs.key_of(spec, leaves)


def _tensors(x):
    return [t for t in pytree.tree_leaves(x) if isinstance(t, torch.Tensor)]


def test_frame_states_are_trees():
    """The frame's FilterState and TrackState flatten to their fields (the
    layout a value of the key), and come back with the same tensors in the
    same places; beside them named tuples, dicts, lists and None."""
    sim = Simulator(SimConfig(duration=2.0, n_landmarks=50, n_lines=0, seed=3))
    layout = StateLayout(n_clones=4, n_cams=1, use_wheel=True, n_gps=1)
    st = FilterState.from_numpy([examples.seed_state(sim, layout, 1.0)] * 2, layout, "cpu")
    ts = frame.make_track_state(48, 64, 8, 4, 3, batch=2, device="cpu")
    x = {"st": st, "ts": ts, "pair": _Pair(torch.arange(3), 1.5), "seq": [None, (2, 3.0)]}
    leaves, spec = pytree.tree_flatten(x)
    values = [v for v in leaves if not isinstance(v, torch.Tensor) and v is not None]
    assert values == [layout, 1.5, 2, 3.0]
    assert len(_tensors(x)) == len(dataclasses.fields(st)) - 1 + len(dataclasses.fields(ts)) + 1
    y = pytree.tree_unflatten(leaves, spec)
    assert isinstance(y["st"], FilterState) and y["st"].cov is st.cov and y["st"].layout == layout
    assert isinstance(y["ts"], frame.TrackState) and y["ts"].pyr0 is ts.pyr0
    assert isinstance(y["pair"], _Pair) and y["pair"].x is x["pair"].x and y["pair"].y == 1.5
    assert y["seq"] == [None, (2, 3.0)]
    other = StateLayout(n_clones=5, n_cams=1, use_wheel=True, n_gps=1)
    assert _key(x) == _key(pytree.tree_unflatten(leaves, spec))
    assert _key(x) != _key(dict(x, st=dataclasses.replace(st, layout=other)))


@pytest.mark.parametrize("name,a,b", [
    ("sigma_pix", (1.5,), (2.0,)),
    ("chi2_mult", (8.0,), (9999.0,)),
    ("flag", (True,), (False,)),
    ("int vs float", (1,), (1.0,)),
    ("None vs tensor", (None,), (torch.zeros(2),)),
    ("tuple of noises", ((0.2, 0.5, 0.1),), ((0.2, 0.5, 0.2),)),
])
def test_baked_values_give_two_keys(name, a, b):
    """Two calls that differ only in a value the captured operators bake in
    (or in a tensor's presence) have two keys; the same call, one."""
    x = torch.zeros(4, 3)
    assert _key(x, *a) == _key(x.clone(), *a)
    assert _key(x, *a) != _key(x, *b), name


@pytest.mark.parametrize("other", [
    torch.zeros(5, 3),  # shape
    torch.zeros(4, 3, dtype=torch.float64),  # dtype
    torch.zeros(3, 4).t(),  # strides
])
def test_tensor_layout_is_part_of_the_key(other):
    assert _key(torch.zeros(4, 3), 1.5) != _key(other, 1.5)


def test_empty_tensor_strides_are_not_part_of_the_key():
    empty = torch.zeros(1, 0, 3)
    assert _key(empty, 1.5) == _key(torch.zeros(3).expand(1, 0, 3), 1.5)


def test_unhashable_value_has_no_key():
    assert _key(torch.zeros(2), np.zeros(3)) is None


def test_canonical_strides():
    assert graphs._canonical(torch.zeros(2, 3)) and graphs._canonical(torch.zeros(2, 0, 3))
    assert graphs._canonical(torch.zeros(()))
    one = torch.zeros(2, 124)[:1, 4:8]  # contiguous, but not in canonical strides
    assert one.is_contiguous() and not graphs._canonical(one)
    assert graphs._canonical(graphs._contiguous({"x": one})["x"])


def test_which_tensors_a_graph_may_take():
    """Only calls with tensors, all on a card: none on the CPU, and a call
    of values alone has nothing to capture."""
    x = torch.zeros(2, 124)
    assert not graphs.on_card([x, 1.5])
    assert not graphs.on_card([])
    assert not graphs.on_card([1.5, None])


def test_policy_captures_at_the_second_sighting():
    """Not at the second sighting: at the third (CAPTURE_AT), so that keys
    that come in pairs (dynamic cloning's pixel noise) run eagerly and pay
    for no capture."""
    p = graphs.Policy()
    assert graphs.CAPTURE_AT == 3
    assert p.decide(None) == graphs.EAGER and p.decide(None) == graphs.EAGER
    assert p.decide("k") == graphs.EAGER and p.decide("k") == graphs.EAGER
    assert p.decide("k") == graphs.CAPTURE
    p.store("k", object())
    assert p.decide("k") == graphs.REPLAY and p.decide("k") == graphs.REPLAY
    assert p.decide("other") == graphs.EAGER


def test_policy_lru_evicts():
    """At most max_keys keys keep graphs, the least recently used evicted
    first; an evicted key captures again at its next sighting."""
    p = graphs.Policy(max_keys=2)
    for k in ("a", "b"):
        p.decide(k)
        p.decide(k)
        p.store(k, object())
    assert p.decide("a") == graphs.REPLAY  # now b is the least recently used
    p.decide("c")
    p.store("c", object())
    assert list(p.graphs) == ["a", "c"]
    assert p.decide("b") == graphs.CAPTURE


def test_policy_remembers_few_keys_seen_once():
    p = graphs.Policy(max_seen=3)
    for k in range(5):
        assert p.decide(k) == graphs.EAGER
    assert list(p.seen) == [2, 3, 4]
    assert p.decide(0) == graphs.EAGER  # forgotten: a first sighting again


def test_policy_failed_key_runs_eagerly():
    p = graphs.Policy()
    p.decide("k")
    p.decide("k")
    assert p.decide("k") == graphs.CAPTURE
    p.failed("k")
    assert p.decide("k") == graphs.EAGER and p.decide("k") == graphs.EAGER


def test_cpu_calls_never_capture(monkeypatch):
    """A graphed function on CPU tensors runs eagerly every time and counts
    so; its eager calls and spans run where the function makes them, and
    its outputs come back contiguous."""
    made = []

    @graphs.graphed
    def fn(x, scale: float = 2.0):
        with graphs.span("fn"):
            y = graphs.call(lambda: torch.mul, x, scale)
        made.append(y)
        return {"y": y, "t": y.t()}

    x = torch.arange(6.0).reshape(2, 3)
    for _ in range(3):
        out = fn(x)
        assert torch.equal(out["y"], 2.0 * x) and graphs._canonical(out["t"])
        assert torch.equal(out["t"], (2.0 * x).t())
    assert fn.graphs == {"captured": 0, "replayed": 0, "eager": 3, "failed": 0}
    assert not fn.policy.graphs and not fn.policy.seen
    assert graphs.span("x") is timing.span("x")  # no capture under way, no profiler


def test_graphed_takes_no_star_args():
    with pytest.raises(TypeError):
        graphs.graphed(lambda *a: a)


@pytest.mark.parametrize("B", [1, 2])
def test_frame_sequence_keeps_one_key(B):
    """Three frames of the images-in frame on the CPU at batch B: every call
    eager (the counter says so), outputs contiguous in canonical strides (a
    size-1 dim's stride included, as at B = 1), and the key of each frame's
    call (the next frame fed the last one's outputs) the same from the first
    frame on, so that on a card the third frame captures."""
    sim = Simulator(SimConfig(duration=3.0, n_landmarks=350, n_lines=40, seed=3))
    layout = StateLayout(n_clones=6, n_cams=1, use_wheel=True, n_gps=1)
    frames = examples.frame_inputs(sim, B, 3, torch.Generator().manual_seed(1), t0=1.7)
    gravity = torch.tensor([0.0, 0.0, 9.81], dtype=torch.float64)
    st = FilterState.from_numpy([examples.seed_state(sim, layout, 1.7)] * B, layout, "cpu")
    ts = frame.make_track_state(480, 640, 32, 8, 3, batch=B, device="cpu")
    before = dict(frame.fused_frame.graphs)
    keys = []
    for f in frames:
        args = (st, ts, f["img"], *f["imu"], f["t_new"], *f["wheel"],
                torch.ones(B, dtype=torch.bool), gravity, (1.7e-4, 2.0e-3, 1.9e-5, 3.0e-3), 1.5,
                8.0, 2.0, (0.05, 0.05, 0.02))
        kw = dict(use_gps=True, gps_t=f["gps"][0], gps_p=f["gps"][1], gps_valid=f["gps"][2],
                  sigma_gps=sim.cfg.sigma_gps, gps_chi2_mult=8.0)
        keys.append(_key(*args, **kw))
        st, ts, m = frame.fused_frame(*args, **kw)
        assert all(graphs._canonical(t) for t in _tensors((st, ts, m)))
    assert keys[0] is not None and keys[0] == keys[1] == keys[2]
    assert frame.fused_frame.graphs["eager"] == before["eager"] + 3
    assert frame.fused_frame.graphs["captured"] == before["captured"]
    assert math.isfinite(float(st.p.sum()))


def test_failed_capture_reruns_without_repeating_calls(monkeypatch):
    """A capture that fails (here after its span's entry and first eager
    call, as a synchronizing operator would) counts as failed and warns
    where it failed.  The call then reruns eagerly: it takes the result of
    the eager call the capture made instead of making it twice, makes the
    calls after it, and records its span once.  The key runs eagerly from
    then on."""
    made = []

    def kernel(x):
        made.append(x)
        return x * 2

    @graphs.graphed
    def fn(x):
        with graphs.span("fn"):
            y = graphs.call(lambda: kernel, x)
            return graphs.call(lambda: kernel, y) + 1

    class _FailingCapture:
        def __init__(self, dev):
            self.made = []

    def failing_capture(fn_, cap, spec, leaves):
        with timing.span("fn"):
            x = _tensors(leaves)[0]
            cap.made.append((kernel, kernel(x)))
            raise RuntimeError("called a synchronizing CUDA operation")

    monkeypatch.setattr(graphs, "on_card", lambda leaves: True)
    monkeypatch.setattr(graphs, "key_of", lambda spec, leaves: "key")
    monkeypatch.setattr(graphs, "_Capture", _FailingCapture)
    monkeypatch.setattr(graphs, "_capture", failing_capture)
    x = torch.arange(3.0)
    for _ in range(2):  # the first two sightings: eager
        assert torch.equal(fn(x), 4 * x + 1) and len(made) == 2
        made.clear()
    timing.spans(clear=True)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with pytest.warns(RuntimeWarning, match=r"capture failed at .*test_torch_graphs\.py:\d+"):
            out = fn(x)
    assert torch.equal(out, 4 * x + 1)
    assert len(made) == 2 and made[0] is x and torch.equal(made[1], 2 * x)
    assert [s.name for s in timing.spans(clear=True)] == ["fn"]
    assert fn.graphs == {"captured": 0, "replayed": 0, "eager": 3, "failed": 1}
    made.clear()
    assert torch.equal(fn(x), 4 * x + 1) and len(made) == 2
    assert fn.graphs == {"captured": 0, "replayed": 0, "eager": 4, "failed": 1}


@pytest.mark.parametrize("what,result", [
    ("dtype", lambda t: (2 * t.double(), 1)),
    ("shape", lambda t: (2 * t[:2], 1)),
    ("tree", lambda t: (2 * t,)),
    ("value", lambda t: (2 * t, 2)),
    ("tensor for a value", lambda t: (2 * t, t)),
])
def test_replayed_call_returns_what_it_captured(what, result):
    """An eager call between graphs, made again at a replay, must return
    the tree, shapes, dtypes and values it returned at the capture (the
    graphs after it read those buffers): it is copied into them, or
    raises."""
    x = torch.arange(3.0)
    leaves, spec = pytree.tree_flatten(((x,), {}))
    res_leaves, res_spec = pytree.tree_flatten((2 * x, 1))
    static = graphs._swap(res_leaves, graphs._like)
    out = graphs._Out()
    graphs._eager_call(out, ("call", lambda: lambda t: (2 * t, 1), spec, leaves, res_spec,
                             static))
    assert torch.equal(static[0], 2 * x) and static[1] == 1
    with pytest.raises(RuntimeError, match="returned"):
        graphs._eager_call(out, ("call", lambda: result, spec, leaves, res_spec, static))


# operators that wait for the card where they run on one: they read a device
# value back to the host (a scalar, a count of true elements, a check of
# linalg's error codes) or copy host data in
_READS_BACK = {"_local_scalar_dense", "is_nonzero", "equal", "nonzero", "nonzero_numpy",
               "argwhere", "masked_select", "_unique", "_unique2", "unique_dim",
               "unique_consecutive", "unique_dim_consecutive", "_linalg_check_errors"}


class _ReadBacks(TorchDispatchMode):
    """Records the operators in _READS_BACK, boolean-mask indexing (a
    `nonzero`), `repeat_interleave` without its output size, and tensors
    made from host data of more than one element, with their call site."""

    def __init__(self):
        super().__init__()
        self.found = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func._schema.name.split("::")[-1]
        hit = name in _READS_BACK
        if name in ("index", "index_put", "index_put_"):
            hit = any(isinstance(i, torch.Tensor) and i.dtype == torch.bool
                      for i in args[1] if i is not None)
        elif name == "repeat_interleave":
            hit = kwargs.get("output_size") is None
        elif name == "lift_fresh":
            hit = args[0].dim() > 0
        if hit:
            site = [f for f in traceback.extract_stack() if "plviwo_tpu_torch" in f.filename][-1]
            self.found.append(f"{name} at {site.filename}:{site.lineno}")
        return func(*args, **kwargs)


@pytest.mark.parametrize("variant", ["mono", "points", "stereo", "dynamic"])
def test_frame_reads_nothing_back_from_the_device(monkeypatch, variant):
    """The images-in frame's second call (the one a card captures), with
    the kernels' calls left out (they run eagerly, outside every graph),
    issues no operator that reads a value back from the device or copies
    host data in: on a card each would fail the capture.  Mono with lines,
    wheel and GPS; points and wheel only; stereo; dynamic cloning."""
    B = 2
    sim = Simulator(SimConfig(duration=3.0, n_landmarks=350, n_lines=40, seed=3))
    stereo = variant == "stereo"
    layout = StateLayout(n_clones=6, n_cams=2 if stereo else 1, use_wheel=True,
                         n_gps=int(variant != "points"))
    frames = examples.frame_inputs(sim, B, 2, torch.Generator().manual_seed(1), t0=1.7,
                                   stereo=stereo)
    gravity = torch.tensor([0.0, 0.0, 9.81], dtype=torch.float64)
    st = FilterState.from_numpy([examples.seed_state(sim, layout, 1.7)] * B, layout, "cpu")
    ts = frame.make_track_state(480, 640, 32, 8, 3, batch=B, device="cpu")

    def eager(resolve, *args, **kwargs):
        with _disable_current_modes():
            return resolve()(*args, **kwargs)

    monkeypatch.setattr(graphs, "call", eager)
    for i, f in enumerate(frames):
        kw = dict(use_lines=False)
        if variant != "points":
            kw = dict(use_gps=True, gps_t=f["gps"][0], gps_p=f["gps"][1],
                      gps_valid=f["gps"][2], sigma_gps=sim.cfg.sigma_gps, gps_chi2_mult=8.0)
        if stereo:
            kw.update(use_stereo=True, use_lines=False, img_r=f["img_r"])
        if variant == "dynamic":
            kw.update(use_dynamic=True, do_clone=torch.tensor([i % 2 == b for b in range(B)]))
        reads = _ReadBacks()
        with reads:
            st, ts, _ = frame.fused_frame(
                st, ts, f["img"], *f["imu"], f["t_new"], *f["wheel"],
                torch.ones(B, dtype=torch.bool), gravity, (1.7e-4, 2.0e-3, 1.9e-5, 3.0e-3),
                1.5, 8.0, 2.0, (0.05, 0.05, 0.02), **kw)
    assert reads.found == []
    assert math.isfinite(float(st.p.sum()))
