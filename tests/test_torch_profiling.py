"""The port's phase registry (``shotgun_tpu_torch/utils/profiling.py``) on
the CPU: while enabled a phase is timed into ``stats`` and is a
``user_annotation`` of the same name in a ``torch.profiler`` trace,
nested phases nest there, a disabled registry records and emits nothing,
threads lose no calls; the stream's spans (fill, fill wait, staging,
launches and the per-sample steps) are recorded as often as the stream
does each step, nest on the main thread, and change no summary; a device
phase (the sort join's) is timed by events kept pending until
``settle``, and a disabled one makes no event."""

import io
import json
import os
import sys
import threading

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from shotgun_tpu_torch import cli
from shotgun_tpu_torch.aligner import _lpad
from shotgun_tpu_torch.io import native
from shotgun_tpu_torch.ops.kernels import build as kbuild
from shotgun_tpu_torch.utils.profiling import PROFILER, Profiler, parse_report

torch.set_num_threads(2)

HERE = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(HERE, "golden", "data")
FA = os.path.join(DATA, "corpus.fa")
FQ = os.path.join(DATA, "corpus.fq")
CPU = torch.device("cpu")
#: reads of corpus.fq, and the batch the stream tests take
READS, BATCH = 50, 16
#: the stream's spans: once a batch, and once a sample
PER_BATCH = ("stage", "enqueue")
PER_SAMPLE = ("stream_open", "stream_align", "validate", "carry_fetch", "host_merge",
              "summary")


def _annotations(prof):
    """[(tid, start, end, name)] of the trace's ``user_annotation`` events."""
    path = os.path.join(os.environ.get("TMPDIR", "/tmp"), f"trace-{os.getpid()}-"
                        f"{threading.get_ident()}.json")
    prof.export_chrome_trace(path)
    try:
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
    finally:
        os.remove(path)
    return [(e["tid"], e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
            if e.get("ph") == "X" and e.get("cat") == "user_annotation"]


def _nested(spans) -> bool:
    """Whether each thread's spans nest: no two overlap unless one holds
    the other."""
    for a in spans:
        for b in spans:
            if a is b or a[0] != b[0] or a[2] <= b[1] or b[2] <= a[1]:
                continue
            if not (a[1] <= b[1] and b[2] <= a[2]) and not (b[1] <= a[1] and a[2] <= b[2]):
                return False
    return True


@pytest.fixture
def registry():
    """The process-global registry, enabled and empty; disabled and
    emptied after the test."""
    PROFILER.stats.clear()
    PROFILER.enable()
    yield PROFILER
    PROFILER.enabled = False
    PROFILER.stats.clear()


def test_phase_records_and_annotates_the_trace():
    prof_reg = Profiler()
    prof_reg.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with prof_reg.phase("outer", items=7):
            with prof_reg.phase("inner"):
                torch.ones(8).sum()
            with prof_reg.phase("inner"):
                pass
    spans = _annotations(prof)
    names = [s[3] for s in spans]
    assert sorted(names) == ["inner", "inner", "outer"]
    (outer,) = [s for s in spans if s[3] == "outer"]
    assert all(outer[1] <= s[1] and s[2] <= outer[2] for s in spans if s[3] == "inner")
    assert _nested(spans)
    assert list(prof_reg.stats) == ["inner", "outer"]
    assert prof_reg.stats["inner"].calls == 2 and prof_reg.stats["outer"].items == 7
    assert prof_reg.stats["outer"].seconds >= prof_reg.stats["inner"].seconds > 0


def test_disabled_phase_records_and_emits_nothing():
    prof_reg = Profiler()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with prof_reg.phase("quiet", items=3):
            torch.ones(8).sum()
    assert not prof_reg.stats
    assert not [s for s in _annotations(prof) if s[3] == "quiet"]
    buf = io.StringIO()
    prof_reg.report(buf)
    assert buf.getvalue() == ""


def test_counter_has_calls_and_items_and_no_time():
    prof_reg = Profiler()
    prof_reg.count("quiet", 5)
    assert not prof_reg.stats
    prof_reg.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with prof_reg.phase("timed"):
            prof_reg.count("walks", 3)
            prof_reg.count("walks", 4)
    assert not [s for s in _annotations(prof) if s[3] == "walks"]
    st = prof_reg.stats["walks"]
    assert (st.calls, st.items, st.seconds, st.counter) == (2, 7, 0.0, True)
    buf = io.StringIO()
    prof_reg.report(buf)
    lines = buf.getvalue().splitlines()
    assert lines[1].split() == ["walks", "x2", "7", "items"]
    assert list(parse_report(buf.getvalue())) == ["timed"]


def test_phase_ends_its_span_when_the_body_raises():
    prof_reg = Profiler()
    prof_reg.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with pytest.raises(ValueError):
            with prof_reg.phase("failing"):
                raise ValueError("x")
        with prof_reg.phase("after"):
            pass
    spans = _annotations(prof)
    assert sorted(s[3] for s in spans) == ["after", "failing"] and _nested(spans)
    assert prof_reg.stats["failing"].calls == 1


def test_threads_lose_no_calls():
    """More threads than cores, a short switch interval: every thread's
    updates of the same names are counted."""
    prof_reg = Profiler()
    prof_reg.enable()
    n_threads, per_thread = 16, 400
    start = threading.Barrier(n_threads)

    def work():
        start.wait(timeout=30)
        for i in range(per_thread):
            with prof_reg.phase("shared", items=1):
                pass
            with prof_reg.phase(f"name{i % 3}"):
                pass

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert prof_reg.stats["shared"].calls == n_threads * per_thread
    assert prof_reg.stats["shared"].items == n_threads * per_thread
    assert sum(prof_reg.stats[f"name{j}"].calls for j in range(3)) == n_threads * per_thread


def _sample(ref, gates=(1, 1, None, None, None)):
    """One sample through the CLI's stream route; its summary."""
    aln = cli.create_alignment_from_reference(ref, FQ, CPU, *gates, batch_size=BATCH)
    return aln.get_summary()


@pytest.mark.parametrize("gates", [(1, 1, None, None, None), (2, 1, 53, 60, 2)])
def test_stream_spans_once_a_batch_and_a_sample(registry, gates):
    PROFILER.enabled = False
    ref = cli.dumpalign_reference(FA, 11, False, 0.0, CPU)
    want = _sample(ref, gates)
    assert not registry.stats
    PROFILER.enable()
    samples = 2
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(samples):
            assert _sample(ref, gates) == want
    stats = registry.stats
    batches = -(-READS // BATCH)
    for name in PER_BATCH:
        assert stats[name].calls == samples * batches, name
    # each stream pulls once more for its end, and its fill calls once more
    assert stats["fill_wait"].calls == samples * (batches + 1)
    assert stats["fill"].calls == samples * (batches + 1)
    for name in PER_SAMPLE + ("table_build",):
        assert stats[name].calls == samples, name
    spans = _annotations(prof)
    assert _nested(spans)
    main = {s[0] for s in spans if s[3] == "stream_align"}
    assert len(main) == 1
    aligns = [s for s in spans if s[3] == "stream_align"]
    for s in spans:
        if s[3] in ("fill_wait", "validate", "carry_fetch", "host_merge") + PER_BATCH:
            assert s[0] in main and any(a[1] <= s[1] and s[2] <= a[2] for a in aligns), s
    # the fill runs on the producer thread, never inside a main-thread span's nesting
    assert not [s for s in spans if s[3] == "fill" and s[0] in main]


def test_packed_reads_record_the_batch_spans(registry):
    """``align_packed_reads`` (the container route) stages, enqueues and
    fetches through the same steps, without a stream."""
    from shotgun_tpu_torch.aligner import PseudoAlignment
    from shotgun_tpu_torch.io.data_file import FASTAQFile

    ref = cli.dumpalign_reference(FA, 11, False, 0.0, CPU)
    aln = PseudoAlignment(ref, CPU)
    aln.align_reads_from_container(FASTAQFile(FQ).container, batch_size=BATCH,
                                   store_reads=False)
    assert registry.stats["stage"].calls == registry.stats["enqueue"].calls == -(-READS // BATCH)
    assert registry.stats["carry_fetch"].calls == registry.stats["host_merge"].calls == 1
    assert "fill_wait" not in registry.stats and "stream_open" not in registry.stats


def test_device_build_records_its_host_prep(registry, monkeypatch):
    monkeypatch.setenv("SHOTGUN_TPU_DEVICE_BUILD_MIN", "0")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        ref = cli.dumpalign_reference(FA, 11, False, 0.0, CPU)
    assert ref._built is not None
    assert registry.stats["db_host_prep"].calls == 1
    assert registry.stats["db_build_device"].seconds >= registry.stats["db_host_prep"].seconds
    spans = _annotations(prof)
    (build,) = [s for s in spans if s[3] == "db_build_device"]
    (prep,) = [s for s in spans if s[3] == "db_host_prep"]
    assert build[1] <= prep[1] and prep[2] <= build[2] and _nested(spans)


def test_kernel_library_load_is_a_phase(registry, monkeypatch):
    """``load_library`` times its first build and load as ``kernel_build``
    (here a stand-in library: the host one), and a loaded library not
    again."""
    assert native.available()
    monkeypatch.setattr(kbuild, "_LIB", None)
    monkeypatch.setattr(kbuild, "build", lambda: kbuild.BuildResult(
        native.library_path(), 0.0, ""))
    lib = kbuild.load_library()
    assert kbuild.load_library() is lib
    assert registry.stats["kernel_build"].calls == 1


class _FakeEvent:
    """A stand-in for ``torch.cuda.Event``: ``done`` says whether the
    device has passed it; ``made`` counts the events made."""

    made = 0

    def __init__(self, enable_timing=False):
        assert enable_timing
        type(self).made += 1
        self.t, self.done, self.stream = None, False, None

    def record(self, stream=None):
        self.t, self.stream = time_ms(), stream

    def query(self):
        return self.done

    def elapsed_time(self, end):
        assert self.done and end.done
        return end.t - self.t


_CLOCK = [0.0]


def time_ms():
    _CLOCK[0] += 2.5
    return _CLOCK[0]


@pytest.fixture
def fake_cuda(monkeypatch):
    _FakeEvent.made = 0
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: "stream")
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **kw: pytest.fail("synced"))
    return _FakeEvent


def test_device_phase_keeps_events_pending_until_settled(fake_cuda):
    """On a CUDA device the phase records two events on the current
    stream and nothing else: no stat until ``settle``, which folds only
    the pairs the device has passed, in order, and never waits."""
    prof_reg = Profiler()
    prof_reg.settle()  # nothing pending: a no-op
    assert not prof_reg.stats
    prof_reg.enable()
    cuda = torch.device("cuda", 0)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            with prof_reg.device_phase("join", cuda):
                pass
    assert fake_cuda.made == 6 and not prof_reg.stats
    assert [s[3] for s in _annotations(prof)] == ["join"] * 3
    pairs = list(prof_reg._pending)
    assert all(a.stream == b.stream == "stream" for _, a, b in pairs)
    for _, a, b in pairs[:2]:
        a.done = b.done = True
    prof_reg.settle()
    st = prof_reg.stats["join_device"]
    assert (st.calls, st.seconds) == (2, pytest.approx(2 * 2.5e-3))
    assert prof_reg._pending == pairs[2:]
    pairs[2][1].done = pairs[2][2].done = True
    prof_reg.settle()
    assert prof_reg.stats["join_device"].calls == 3 and not prof_reg._pending
    assert list(prof_reg.stats) == ["join_device"]


def test_enable_drops_pairs_left_pending(fake_cuda):
    """A run that never settled leaves its pairs pending; turning the
    profiler on for the next window drops them, so they are never folded
    into that window's stat."""
    prof_reg = Profiler()
    prof_reg.enable()
    with prof_reg.device_phase("join", torch.device("cuda", 0)):
        pass
    (_, start, end), = prof_reg._pending
    start.done = end.done = True
    prof_reg.stats.clear()
    prof_reg.enable()
    prof_reg.settle()
    assert not prof_reg._pending and not prof_reg.stats


def test_disabled_device_phase_makes_no_event(fake_cuda):
    prof_reg = Profiler()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with prof_reg.device_phase("join", torch.device("cuda", 0)):
            torch.ones(4).sum()
    prof_reg.settle()
    assert fake_cuda.made == 0 and not prof_reg.stats and not prof_reg._pending
    assert not [s for s in _annotations(prof) if s[3] == "join"]


def test_device_phase_off_cuda_takes_the_host_time():
    prof_reg = Profiler()
    prof_reg.enable()
    with prof_reg.device_phase("join", CPU):
        torch.ones(8).sum()
    with prof_reg.device_phase("join", CPU):
        pass
    st = prof_reg.stats["join_device"]
    assert st.calls == 2 and st.seconds > 0 and not prof_reg._pending


@pytest.mark.parametrize("k", [11, 35])
def test_sort_join_is_a_device_phase_and_a_counter(registry, k):
    """Each batch on the sort join records ``sort_join_device`` and
    ``sort_join_rows`` (the batch's windows, padded reads included: the
    table's rows no longer enter the join), and a span ``sort_join``
    inside ``enqueue``; the summary is unchanged."""
    PROFILER.enabled = False
    ref = cli.dumpalign_reference(FA, k, False, 0.0, CPU)
    want = _sample(ref)
    PROFILER.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert _sample(ref) == want
    batches = -(-READS // BATCH)
    stats = registry.stats
    assert stats["sort_join_device"].calls == batches
    assert 0 < stats["sort_join_device"].seconds <= stats["enqueue"].seconds
    rows = stats["sort_join_rows"]
    with open(FQ) as fh:
        longest = max(len(line.strip()) for i, line in enumerate(fh) if i % 4 == 1)
    assert rows.counter and rows.calls == batches
    assert rows.items == batches * BATCH * (_lpad(longest, k) - k + 1)
    spans = _annotations(prof)
    enqueues = [s for s in spans if s[3] == "enqueue"]
    joins = [s for s in spans if s[3] == "sort_join"]
    assert len(joins) == batches and _nested(spans)
    assert all(any(e[1] <= j[1] and j[2] <= e[2] for e in enqueues) for j in joins)


def test_k35_device_build_counts_its_words(registry, monkeypatch):
    monkeypatch.setenv("SHOTGUN_TPU_DEVICE_BUILD_MIN", "0")
    ref = cli.dumpalign_reference(FA, 35, False, 0.0, CPU)
    assert ref._built is not None and len(ref.sort_columns()[0]) == 2
    st = registry.stats["db_build_words"]
    assert st.counter and (st.calls, st.items) == (1, 2)
    assert registry.stats["db_host_prep"].calls == 1
    registry.stats.clear()
    cli.dumpalign_reference(FA, 31, False, 0.0, CPU)
    assert "db_build_words" not in registry.stats
