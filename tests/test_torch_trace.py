"""``profiling/trace.py`` on the CPU: ``kernel_events`` takes a trace
again where the profiler dropped records (no kernel at all, or fewer of
this package's kernels than ``expected`` says ran); after
``PROFILE_ATTEMPTS`` such traces it uses the most complete one, and
raises only if every trace was empty.  ``device_ms_per_call(alone=True)``
takes a call's time as the mean of its one kernel's recorded launches.
A fake profiler hands out the traces; the real one needs a card
(``chip_smoke.py``)."""

import json

import pytest
import torch

from deepspeed_tpu_torch.profiling import trace


def _kernel(name, ts, dur):
    return {"cat": "kernel", "name": name, "ts": ts, "dur": dur}


OURS = "void dstt::decode_kernel<__nv_bfloat16>(...)"
GEMM = "nvjet_tst_64x8_64x16"


@pytest.fixture
def traces(monkeypatch):
    """The traces the fake profiler returns, one a window, in order."""
    queue = []

    class FakeProfile:
        def __init__(self, activities):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def export_chrome_trace(self, path):
            with open(path, "w") as f:
                json.dump({"traceEvents": queue.pop(0)}, f)

    monkeypatch.setattr(torch.profiler, "profile", FakeProfile)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    return queue


def test_kernel_events_retakes_a_trace_that_dropped_records(traces,
                                                            tmp_path):
    """Two of the package's kernels ran; the first trace holds one, the
    second both: the second is returned, and ``fn`` ran twice."""
    full = [_kernel(OURS, 0, 5), _kernel(GEMM, 6, 3), _kernel(OURS, 10, 5)]
    traces += [full[:2], full]
    runs = []
    got = trace.kernel_events(lambda: runs.append(1), tmp_path / "t.json",
                              expected=lambda: 2)
    assert got == full and len(runs) == 2 and not traces


def test_kernel_events_raises_after_every_attempt_missed(traces, tmp_path):
    """Every one of ``PROFILE_ATTEMPTS`` traces is empty: an error, not an
    empty list of kernels."""
    traces += [[]] * trace.PROFILE_ATTEMPTS
    with pytest.raises(RuntimeError, match="recorded no device kernels"):
        trace.kernel_events(lambda: None, tmp_path / "t.json",
                            expected=lambda: 2)
    assert not traces


def test_kernel_events_uses_the_most_complete_near_trace(traces,
                                                        tmp_path):
    """2,000 of the package's kernels ran; every trace misses some: the
    one missing 2 is used, not the ones missing 5 or 10."""
    def window(n):
        return [_kernel(OURS, 2 * i, 1) for i in range(n)]

    traces += [window(1995), window(1998), window(1990)]
    got = trace.kernel_events(lambda: None, tmp_path / "t.json",
                              expected=lambda: 2000)
    assert len(got) == 1998 and not traces


def test_kernel_events_uses_a_far_short_trace_after_every_attempt(
        traces, tmp_path):
    """240 ran; the traces hold 229, 191 and 239 of them (an H100's
    profiler did so in one run): the one with 239 is used."""
    def window(n):
        return [_kernel(OURS, 2 * i, 1) for i in range(n)]

    traces += [window(229), window(191), window(239)]
    got = trace.kernel_events(lambda: None, tmp_path / "t.json",
                              expected=lambda: 240)
    assert len(got) == 239 and not traces


def test_device_ms_per_call_holds_the_kernels_of_each_call(traces,
                                                           tmp_path):
    """``alone=True`` over 2 calls: a trace with one of the package's
    kernels is taken again; the time is the mean of its launches."""
    traces += [[_kernel(OURS, 0, 4)],
               [_kernel(OURS, 0, 4), _kernel(OURS, 8, 6)]]
    ms = trace.device_ms_per_call(lambda: None, 2, tmp_path / "t.json",
                                  name="decode_kernel", alone=True)
    assert ms == pytest.approx((4 + 6) / 1e3 / 2)
    assert not traces


def test_device_ms_per_call_alone_is_unbiased_by_dropped_records(
        traces, tmp_path):
    """4 calls, every trace drops one launch: the mean of the 3 recorded
    launches of the most complete trace is the time per call."""
    short = [_kernel(OURS, 10 * i, 5) for i in range(3)]
    traces += [short[:1], short[:2], short]
    ms = trace.device_ms_per_call(lambda: None, 4, tmp_path / "t.json",
                                  name="decode_kernel", alone=True)
    assert ms == pytest.approx(5 / 1e3)
    assert not traces


@pytest.mark.parametrize("window", [
    [_kernel(OURS, 0, 4), _kernel(GEMM, 5, 2)],
    [_kernel(OURS, 0, 4), _kernel(OURS, 5, 4), _kernel(OURS, 9, 4)]],
    ids=["another kernel", "two a call"])
def test_device_ms_per_call_alone_refuses_a_call_of_more_kernels(
        traces, tmp_path, window):
    """``alone=True`` over 1 call: a trace holding another kernel, or
    more launches than calls, is an error, not a time."""
    traces += [window]
    with pytest.raises(RuntimeError, match="not one"):
        trace.device_ms_per_call(lambda: None, 1, tmp_path / "t.json",
                                 name="decode_kernel", alone=True)
