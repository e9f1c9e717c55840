"""The trace reader on a made-up trace: busy time, idle gaps and their
labels, device time by span."""

from dataclasses import dataclass

import pytest
from torch.autograd import DeviceType

from perfbench import devtrace


@dataclass
class Ev:
    n: str
    dev: bool
    s: int
    d: int
    corr: int = 0
    tid: int = 1

    def name(self):
        return self.n

    def device_type(self):
        return DeviceType.CUDA if self.dev else DeviceType.CPU

    def start_ns(self):
        return self.s

    def duration_ns(self):
        return self.d

    def correlation_id(self):
        return self.corr

    def linked_correlation_id(self):
        return 0

    def start_thread_id(self):
        return self.tid


def test_a_request_read_from_its_trace():
    off = 1_000_000  # the trace clock runs 1 ms ahead of the host clock
    spans = [devtrace.Span(0, "request", 7, 100, 1000), devtrace.Span(0, "search", 7, 150, 990),
             devtrace.Span(0, "scan", 7, 250, 980)]  # the program's scan stage
    events = [
        Ev("bench:anchor", False, 50 + off, 1),
        # launches on the client thread, then what they ran on the device
        Ev("cudaMemcpyAsync", False, 160 + off, 5, corr=1, tid=9),
        Ev("cudaLaunchKernel", False, 300 + off, 5, corr=2, tid=9),
        Ev("cudaMemcpyAsync", False, 700 + off, 5, corr=3, tid=9),
        Ev("cudaMemcpyAsync", False, 720 + off, 5, corr=4, tid=9),
        Ev("Memcpy DtoD (Device -> Device)", True, 200 + off, 100, corr=1),
        Ev("tilemax_kernel", True, 400 + off, 200, corr=2),
        Ev("Memcpy DtoH (Device -> Pageable)", True, 800 + off, 50, corr=3),
        # a copy launched once the scan stage began is the scan's
        Ev("Memcpy DtoD (Device -> Device)", True, 860 + off, 40, corr=4),
    ]
    s = devtrace.summarize(events, spans, 50)
    assert s.staged
    assert s.window_s == pytest.approx(900e-9)
    assert s.busy_s == pytest.approx(390e-9)
    assert s.seconds("search", corpus=True) == pytest.approx(100e-9)
    assert s.seconds("search", corpus=False) == pytest.approx(290e-9)  # kernel, copies after it
    idle = dict(s.idle)
    assert idle["search:corpus"] == pytest.approx((100 + 100) * 1e-9)  # 100-200, 300-400
    assert idle["search:scan"] == pytest.approx((200 + 10) * 1e-9)  # 600-800, 850-860
    assert idle["search:results"] == pytest.approx(100e-9)  # after the last copy
    assert s.by_name[0] == ("tilemax_kernel", pytest.approx(200e-9))


def test_no_anchor_no_summary():
    s = devtrace.summarize([], [devtrace.Span(0, "request", 1, 0, 10)], 0)
    assert s.window_s == 0 and s.busy_s == 0 and not s.launched_in("search")


def test_two_clients_idle_gaps_are_listed_apart():
    spans = [devtrace.Span(0, "request", 1, 100, 300), devtrace.Span(0, "search", 1, 110, 290),
             devtrace.Span(1, "request", 2_000_001, 100, 1000),
             devtrace.Span(1, "search", 2_000_001, 120, 990)]
    events = [
        Ev("bench:anchor", False, 50, 1),
        Ev("cudaLaunchKernel", False, 150, 5, corr=1, tid=7),
        Ev("cudaLaunchKernel", False, 500, 5, corr=2, tid=8),
        Ev("k0", True, 200, 50, corr=1),
        Ev("k1", True, 600, 100, corr=2),
    ]
    s = devtrace.summarize(events, spans, 50)
    assert not s.staged and s.seconds("search", corpus=True) == 0  # no scan stage seen
    assert s.busy_s == pytest.approx(150e-9)
    idle = dict(s.idle)
    # gaps 100-200, 250-600 and 700-1000, each labelled at its middle: client
    # 0 searches at 150 and is between requests at 425 and 850
    assert idle["client 0: search:corpus"] == pytest.approx(100e-9)
    assert idle["client 0: between requests"] == pytest.approx(650e-9)
    assert idle["client 1: search:corpus"] == pytest.approx(450e-9)  # before its kernel at 600
    assert idle["client 1: search:results"] == pytest.approx(300e-9)
    for c in (0, 1):
        assert sum(v for k, v in s.idle if k.startswith(f"client {c}:")) == \
            pytest.approx(s.window_s - s.busy_s)


def test_busy_seconds_are_the_union_of_the_device_s_intervals():
    events = [
        Ev("cudaLaunchKernel", False, 0, 500),  # the host's call is not device time
        Ev("k1", True, 100, 200),
        Ev("k2", True, 250, 100),  # overlaps k1: 100-350
        Ev("copy", True, 400, 50),  # 400-450
        Ev("empty", True, 460, 0),
    ]
    assert devtrace.busy_seconds(events) == pytest.approx(300e-9)
    assert devtrace.busy_seconds([Ev("cudaLaunchKernel", False, 0, 5)]) == 0.0
