"""The trace's reduction: busy time as a union, idle gaps labelled by the
host event around them."""

from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

import pb_tiny  # noqa: F401
from portbench import trace


def _ev(name, a, b, dev):
    return SimpleNamespace(name=name, time_range=SimpleNamespace(
        start=a, end=b), device_type=dev, is_user_annotation=False)


def test_union_and_gaps():
    cpu, cuda = DeviceType.CPU, DeviceType.CUDA
    events = [
        _ev("portbench.search", 0, 1000, cpu),
        _ev("cudaStreamSynchronize", 500, 600, cpu),
        _ev("k1", 0, 100, cuda), _ev("k2", 50, 200, cuda),   # overlap
        _ev("k1", 300, 400, cuda),                           # gap 200-300
        _ev("k3", 650, 700, cuda),                           # gap 400-650
        _ev("k3", 702, 705, cuda),                           # short gap
    ]
    s = trace.summarize(events, window_s=1e-3)
    assert s.busy_s == pytest.approx((200 + 100 + 50 + 3) / 1e6)
    assert s.ops["k1"] == pytest.approx(200 / 1e6)
    assert s.op_seconds("k") == pytest.approx((100 + 150 + 100 + 50 + 3)
                                              / 1e6)
    # 100 + 250 between device events, and the window's end after 705
    assert s.gaps["portbench.search"] == pytest.approx((350 + 295) / 1e6)
    assert sum(s.gaps.values()) == pytest.approx((100 + 250 + 2 + 295)
                                                 / 1e6)
    assert s.idle_percent() == pytest.approx(100 * (1 - 0.353))
    b = s.breakdown()
    assert b["device_ops"][0][0] == "k2" or b["device_ops"][0][0] == "k1"
    assert len(b["device_ops"]) <= trace.TOP


def test_window_ends_are_labelled():
    """The time from the window's start marker to the first device event
    (labelled by what the host did as the device started) and from the
    last one to the window's end (by what it did as the device stopped)
    are gaps, so the gaps sum to the idle time; the idle share reads as it
    did without the ends."""
    cpu, cuda = DeviceType.CPU, DeviceType.CUDA
    events = [
        _ev(trace.START, 1000, 1001, cpu),
        _ev("portbench.add", 1005, 1900, cpu),
        _ev("hnsw.build.plan", 1005, 1200, cpu),
        _ev("k1", 1200, 1500, cuda), _ev("k2", 1600, 1700, cuda),
        _ev("cudaStreamSynchronize", 1700, 1950, cpu),
        _ev(trace.END, 2000, 2001, cpu),
    ]
    s = trace.summarize(events, window_s=1000e-6)
    assert s.busy_s == pytest.approx(400e-6)
    assert s.gaps == pytest.approx({"hnsw.build.plan": 200e-6,
                                    "portbench.add": 100e-6,
                                    "cudaStreamSynchronize": 300e-6})
    assert sum(s.gaps.values()) == pytest.approx(s.window_s - s.busy_s)
    assert s.idle_percent() == pytest.approx(60.0)


def test_union_seconds():
    assert trace.union_seconds([(0, 2), (1, 3), (5, 6)]) == 4


def test_kernel_names_kept_apart():
    """Kernels in anonymous namespaces keep their own names, and a reader
    finds a kernel by its name."""
    cuda = DeviceType.CUDA
    k3 = ("void hnsw::(anonymous namespace)::vec_dist_bytes_kernel<true, "
          "false, 16>(unsigned char const*, long, int)")
    k1 = ("void hnsw::(anonymous namespace)::beam_warp_kernel<2>(float "
          "const*, int const*)")
    events = [_ev(k3, 0, 30, cuda), _ev(k1, 40, 50, cuda),
              _ev("Memcpy HtoD (Pageable -> Device)", 60, 61, cuda)]
    s = trace.summarize(events, window_s=1e-4)
    assert s.op_seconds("vec_dist_bytes_kernel") == pytest.approx(30e-6)
    names = [n for n, _ in s.breakdown()["device_ops"]]
    assert names == ["hnsw::vec_dist_bytes_kernel<true, false, 16>",
                     "hnsw::beam_warp_kernel<2>",
                     "Memcpy HtoD (Pageable -> Device)"]
