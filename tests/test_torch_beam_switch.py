"""The reference's kill-switch ``HNSW_TPU_BEAM_KERNEL=0`` in the port: the
legacy multi-op beam on every device, as ``hnsw_tpu.search`` takes it
(``_beam_kernel_mode`` returns "legacy", so ``fused`` is false). With the
variable set for both packages, the port's search of a shared graph (the
port's save loaded into the reference) matches the reference's legacy
beam, unpacked and packed 8-bit, at the legacy-beam parity tests' bars
(tests/test_torch_search.py); and under "0" the port's result differs
from its default (the fused beam) on the same graph, so the switch was
read."""

import numpy as np
import pytest
import torch

import hnsw_tpu
import hnsw_tpu_torch
from hnsw_tpu.utils.recall import recall_at_k

from conftest import exact_knn

K, EF = 10, 48


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the module (tests/test_torch_mutable.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def shared():
    """A port-built 2,000 x 32 index, the reference's load of its save,
    the workload and its exact top 10."""
    wl = hnsw_tpu_torch.synthetic_workload(2000, 32, n_queries=100,
                                           metric="l2", seed=7)
    port = hnsw_tpu_torch.HnswIndex(32, 8, "l2", device="cpu",
                                    capacity=2048, ef_construction=80)
    port.add(wl.base)
    ref = hnsw_tpu.HnswIndex.from_bytes(port.to_bytes())
    _, gt = exact_knn(wl.base, wl.queries, K, "l2")
    return port, ref, wl, gt


def search_both(shared, packed, monkeypatch, flag):
    port, ref, wl, _ = shared
    for idx in (port, ref):
        if packed and not idx.packed_enabled:
            idx.enable_packed(bits=8)
        elif not packed and idx.packed_enabled:
            idx.disable_packed()
    monkeypatch.setenv("HNSW_TPU_BEAM_KERNEL", flag)
    got = port.search(wl.queries, K, ef_search=EF, with_stats=True)
    want = ref.search(wl.queries, K, ef_search=EF, with_stats=True)
    return got, want


@pytest.mark.parametrize("packed", [False, True], ids=["unpacked", "packed8"])
def test_kill_switch_matches_reference_legacy_beam(shared, monkeypatch,
                                                   packed):
    """ids equal in >= 99% of positions, distances of matched ids within
    rtol 1e-5, recall within 0.005, hops equal, the distance count within
    0.5% (tests/test_torch_search.py ``_assert_same_search``)."""
    (d, i, st), (rd, ri, rst) = search_both(shared, packed, monkeypatch, "0")
    gt = shared[3]
    same = i == ri
    assert same.mean() >= 0.99, same.mean()
    np.testing.assert_allclose(d[same], rd[same], rtol=1e-5, atol=1e-5)
    assert abs(recall_at_k(i, gt, K) - recall_at_k(ri, gt, K)) <= 0.005
    assert st.hops == int(rst.hops)
    ndis, rndis = int(st.ndis.sum()), int(np.asarray(rst.ndis).sum())
    assert abs(ndis - rndis) <= 0.005 * rndis, (ndis, rndis)


@pytest.mark.parametrize("packed", [False, True], ids=["unpacked", "packed8"])
def test_kill_switch_is_read(shared, monkeypatch, packed):
    """Under "0" the port runs the legacy beam, under any other value the
    fused beam, on the same graph: the engine that ran is read from
    ``ops/beam.py``. Packed, the legacy beam's bf16 merge keys take
    another path than the fused beam's f32 keys (other distance counts
    here); unpacked both merge in f32 and agree to the distance count (the
    engines are outcome-equivalent there)."""
    from hnsw_tpu_torch.ops import beam
    port, _, wl, _ = shared
    ran = []
    for name in ("beam_search", "beam_search_fused"):
        fn = getattr(beam, name)
        monkeypatch.setattr(beam, name, lambda *a, _n=name, _f=fn, **kw:
                            ran.append(_n) or _f(*a, **kw))
    (d0, i0, st0), _ = search_both(shared, packed, monkeypatch, "0")
    assert ran == ["beam_search"]
    outs = {}
    for flag in ("", "1", "anything"):
        ran.clear()
        monkeypatch.setenv("HNSW_TPU_BEAM_KERNEL", flag)
        outs[flag] = port.search(wl.queries, K, ef_search=EF,
                                 with_stats=True)
        assert ran == ["beam_search_fused"], flag
    d, i, st = outs[""]
    for flag in ("1", "anything"):
        np.testing.assert_array_equal(outs[flag][1], i)
        np.testing.assert_array_equal(outs[flag][0], d)
    if packed:
        assert not (np.array_equal(i0, i) and np.array_equal(d0, d)
                    and np.array_equal(st0.ndis, st.ndis))
