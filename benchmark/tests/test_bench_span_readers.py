"""The five readers of the program's spans (``source: program_span``) on
hand-built records: what each reads, and None where the window had no
device activity, where the frames counted differ from the traced units,
and where the program records no spans (an older checkout)."""

import pytest

from harness import spans
from harness.manifest import Manifest
from harness.trace import Trace
from romis_tpu_torch.utils import stats
from romis_tpu_torch.utils.stats import Span

NAMES = ["enqueue_ms.frame", "sync_ms.frame", "syncs.frame",
         "temporal_ms.frame", "alpha_solve_ms.frame"]
MS = 1_000_000  # ns


def _span(name, parent, frame, start_ms, end_ms, device_ms=None):
    return Span(name, parent, frame, int(start_ms * MS), int(end_ms * MS),
                device_ms)


def _records():
    """Two frames of 10 and 12 ms. Frame 1: a trace span holding a 1-ms
    camera read, a 2-ms key read holding a 0.5-ms read (counted once, as
    its outer read), a temporal span of 3 device ms and an α solve of 0.25;
    frame 2: one 1.5-ms read, a temporal span of 4 device ms and two α
    solves of 0.25. A read after the frames is no frame's."""
    return [
        _span("romis.frame", None, 1, 0, 10),
        _span("romis.trace", 0, 1, 0, 2, device_ms=1.5),
        _span("romis.sync.camera", 1, 1, 0.5, 1.5),
        _span("romis.sync.ris_key", 0, 1, 3, 5),
        _span("romis.sync.inner", 3, 1, 3.5, 4),
        _span("romis.temporal", 0, 1, 5, 8, device_ms=3.0),
        _span("romis.alpha_solve", 0, 1, 8, 9, device_ms=0.25),
        _span("romis.frame", None, 2, 10, 22),
        _span("romis.sync.ris_key", 7, 2, 11, 12.5),
        _span("romis.temporal", 7, 2, 13, 17, device_ms=4.0),
        _span("romis.alpha_solve", 7, 2, 17, 18, device_ms=0.25),
        _span("romis.alpha_solve", 7, 2, 18, 19, device_ms=0.25),
        _span("romis.sync.ris_key", None, 2, 23, 30),
    ]


def _trace(units=2, busy_s=0.01):
    return Trace(units=units, window_s=0.03, busy_s=busy_s, device_ops={},
                 idle_gaps=[])


@pytest.fixture
def readers(monkeypatch):
    recs = _records()
    monkeypatch.setattr(stats, "records", lambda: list(recs))
    man = Manifest.load()
    return {n: man.reader(n) for n in NAMES}


def test_each_reader_reads_its_spans(readers):
    got = {n: r.read(_trace()) for n, r in readers.items()}
    assert got["syncs.frame"] == pytest.approx(3 / 2)
    assert got["sync_ms.frame"] == pytest.approx((1 + 2 + 1.5) / 2)
    assert got["enqueue_ms.frame"] == pytest.approx(
        (10 + 12 - (1 + 2 + 1.5)) / 2)
    assert got["temporal_ms.frame"] == pytest.approx((3 + 4) / 2)
    assert got["alpha_solve_ms.frame"] == pytest.approx(0.75 / 2)


def test_no_device_activity_reads_nothing(readers):
    for n, r in readers.items():
        assert r.read(_trace(busy_s=0)) is None, n


@pytest.mark.parametrize("units", [1, 3])
def test_frames_unlike_the_units_read_nothing(readers, units):
    for n, r in readers.items():
        assert r.read(_trace(units=units)) is None, n


def test_a_program_without_spans_reads_nothing(readers, monkeypatch):
    monkeypatch.delattr(stats, "records")
    for n, r in readers.items():
        assert r.read(_trace()) is None, n


def test_a_phase_not_timed_on_the_device_reads_nothing(monkeypatch):
    """Spans without event pairs (off the card) give no device time."""
    recs = [_span("romis.frame", None, 1, 0, 5),
            _span("romis.temporal", 0, 1, 1, 2)]
    monkeypatch.setattr(stats, "records", lambda: recs)
    assert Manifest.load().reader("temporal_ms.frame").read(
        _trace(units=1)) is None
    assert spans.device_ms(recs, "romis.alpha_solve") is None
