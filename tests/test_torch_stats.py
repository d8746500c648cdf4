"""The port's spans and launch counts (``romis_tpu_torch.utils.stats``):
off, a span is one shared no-op and records nothing; under
``torch.profiler`` each ``romis.*`` span is a CPU operation (never a user
annotation, which the profiler would also put on the device's timeline),
with its parent and frame recorded, and each frame holds exactly its
mode's spans; ``ops._build.launch`` counts each C entry point's launches.
The frames are 8 x 8 on the CPU, where the plain versions draw on the
host: their one read of the device is the camera's copy."""

from collections import Counter
from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from romis_tpu_torch import Features, RayTraceMode
from romis_tpu_torch.ops import _build, ris
from romis_tpu_torch.render.pipeline import render_frame
from romis_tpu_torch.scene.scene import flagship_camera, flagship_scene
from romis_tpu_torch.utils import stats

H = W = 8
RESTIR = Features()
ROMIS = Features(ray_trace_mode=RayTraceMode.ROMIS)
# Each frame's spans by mode: 5 MIS iterations, R-OMIS direct solves α
# once; the differentiable R-OMIS frame draws its iterations' seeds on the
# host (``render.rmis.draw_seeds``).
FRAME_SPANS = {
    "restir": (RESTIR, {"romis.frame": 1, "romis.trace": 1,
                        "romis.sync.camera": 1, "romis.ris": 1,
                        "romis.temporal": 1, "romis.spatial": 1,
                        "romis.shade": 1}),
    "romis": (ROMIS, {"romis.frame": 1, "romis.select": 1,
                      "romis.sync.camera": 1, "romis.mis_iter": 5,
                      "romis.alpha_solve": 1}),
    "romis_differentiable": (
        ROMIS.replace(fused_resampling=False),
        {"romis.frame": 1, "romis.select": 1, "romis.sync.camera": 1,
         "romis.sync.mis_seeds": 1, "romis.mis_iter": 5,
         "romis.alpha_solve": 1}),
    "rmis": (Features(ray_trace_mode=RayTraceMode.RMIS),
             {"romis.frame": 1, "romis.select": 1, "romis.sync.camera": 1,
              "romis.mis_iter": 5}),
}


@pytest.fixture(scope="module")
def scene():
    return flagship_scene("cpu"), flagship_camera(H, W, "cpu")


def frames(scene, features, n: int, seed: int = 0, traced: bool = True):
    """``n`` frames (ReSTIR's state carried) → (images, the profiler's
    events or None, the spans recorded)."""
    sc, cam = scene
    gen = torch.Generator().manual_seed(seed)
    stats.clear()
    state, imgs = None, []

    def run():
        nonlocal state
        for _ in range(n):
            img, state = render_frame(gen, cam, sc, H, W, features, state)
            imgs.append(img)

    if not traced:
        run()
        return imgs, None, stats.records()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run()
    return imgs, prof.events(), stats.records()


def test_off_a_span_is_the_shared_noop(scene):
    stats.clear()
    a = stats.span("romis.trace", torch.device("cpu"))
    assert a is stats.span(stats.FRAME)
    with a as rec:
        assert rec is None
    _, _, recs = frames(scene, RESTIR, 1, traced=False)
    assert recs == []


def test_spans_are_cpu_ops_not_user_annotations(scene):
    _, events, recs = frames(scene, RESTIR, 1)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        ris._seed(torch.Generator().manual_seed(3))
    named = [e for e in list(events) + list(prof.events())
             if e.name.startswith("romis.")]
    assert {e.name for e in named} == {r.name for r in recs} | {
        "romis.sync.ris_key"}
    for e in named:
        assert e.is_user_annotation is False, e.name
        assert e.device_type == torch.autograd.DeviceType.CPU, e.name


def test_parents_and_frame_ids(scene):
    """Over two R-OMIS and two ReSTIR frames each frame span is a root and
    begins the next frame id; every other span lies in its frame's tree,
    within its parent's host interval."""
    for features in (ROMIS, RESTIR):
        got = frames(scene, features, 2)[2]
        assert sorted({r.frame for r in got}) == [1, 2]
        roots = [i for i, r in enumerate(got) if r.parent is None]
        assert [got[i].name for i in roots] == [stats.FRAME] * 2
        for i, r in enumerate(got):
            assert r.start_ns <= r.end_ns and r.device_ms is None
            if r.parent is None:
                continue
            p = got[r.parent]
            assert p.frame == r.frame and r.parent < i
            assert p.start_ns <= r.start_ns <= r.end_ns <= p.end_ns
            top = r
            while top.parent is not None:
                top = got[top.parent]
            assert top.name == stats.FRAME and top.frame == r.frame
        parent = {r.name: got[r.parent].name for r in got
                  if r.parent is not None}
        assert parent["romis.sync.camera"] == (
            "romis.trace" if features is RESTIR else "romis.select")


@pytest.mark.parametrize("mode", sorted(FRAME_SPANS))
def test_each_frame_holds_exactly_its_spans(scene, mode, monkeypatch):
    """Each frame holds exactly its mode's spans, and only the spans a
    metric reads as device time are given a device to time on:
    ``romis.temporal`` (``temporal_ms.frame``) and ``romis.alpha_solve``
    (``alpha_solve_ms.frame``)."""
    timed, span = set(), stats.span

    def spy(name, device=None):
        if device is not None:
            timed.add(name)
        return span(name, device)

    monkeypatch.setattr(stats, "span", spy)
    features, want = FRAME_SPANS[mode]
    _, _, recs = frames(scene, features, 2)
    for frame in (1, 2):
        got = Counter(r.name for r in recs if r.frame == frame)
        assert got == Counter(want)
    assert timed == set(want) & {"romis.temporal", "romis.alpha_solve"}


def test_sync_spans_a_frame(scene):
    """The reads of the device a frame (``romis.sync.*``, as the benchmark's
    ``syncs.frame`` counts them): on the CPU the camera's copy alone in the
    ReSTIR and R-OMIS frames; the kernels' RIS key (``ops.ris._seed``, not
    reached on CPU tensors) records its own."""
    for features in (RESTIR, ROMIS):
        _, _, recs = frames(scene, features, 2)
        syncs = [r.frame for r in recs if r.name.startswith(stats.SYNC)]
        assert syncs == [1, 2]
    stats.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        key = ris._seed(torch.Generator().manual_seed(3))
    assert isinstance(key, int)
    assert [r.name for r in stats.records()] == ["romis.sync.ris_key"]


def test_records_hold_one_profiling_session(scene):
    """A frame run with the profiler off ends the session: the next traced
    frame clears the records, and the frame ids begin again at 1."""
    frames(scene, RESTIR, 2)
    sc, cam = scene
    gen = torch.Generator().manual_seed(1)
    render_frame(gen, cam, sc, H, W, RESTIR)
    assert len({r.frame for r in stats.records()}) == 2
    with profile(activities=[ProfilerActivity.CPU]):
        render_frame(gen, cam, sc, H, W, RESTIR)
    recs = stats.records()
    assert {r.frame for r in recs} == {1}
    assert Counter(r.name for r in recs) == Counter(FRAME_SPANS["restir"][1])


def test_records_are_bounded(scene, monkeypatch):
    """Past ``MAX_RECORDS`` spans, the next frame begins the records anew."""
    per_frame = sum(FRAME_SPANS["restir"][1].values())
    monkeypatch.setattr(stats, "MAX_RECORDS", 2 * per_frame)
    _, _, recs = frames(scene, RESTIR, 5)
    assert [r.name for r in recs].count(stats.FRAME) == 1
    assert {r.frame for r in recs} == {1} and recs[0].parent is None
    assert all(r.parent is None or r.parent < i for i, r in enumerate(recs))


def test_tracing_leaves_the_frames_unchanged(scene):
    for features in (RESTIR, ROMIS):
        off = frames(scene, features, 2, seed=5, traced=False)[0]
        on = frames(scene, features, 2, seed=5)[0]
        assert all(torch.equal(a, b) for a, b in zip(off, on))


def test_launch_counts_by_entry(monkeypatch):
    calls = []

    class Lib:
        def __getattr__(self, name):
            def entry(*args):
                calls.append((name, args))
                return 7 if name == "romis_fails" else 0
            return entry

    monkeypatch.setattr(_build, "library", Lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: SimpleNamespace(cuda_stream=11))
    stats.launches.clear()
    _build.launch("romis_ris", 1, 2)
    _build.launch("romis_ris", 3, 4)
    _build.launch("romis_spatial_pass", 5)
    _build.launch("romis_spatial_pass", 6, mode="unbiased")
    with pytest.raises(RuntimeError, match="CUDA error 7"):
        _build.launch("romis_fails")
    assert stats.launches == {"romis_ris": 2, "romis_spatial_pass": 1,
                              "romis_spatial_pass:unbiased": 1}
    assert calls[0] == ("romis_ris", (1, 2, 11))
    assert calls[3] == ("romis_spatial_pass", (6, 11))
    stats.launches.clear()
