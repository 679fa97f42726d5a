"""K1's hop entry (``beam_kernel.beam_hop``) on the CPU, where it runs its
plain version, against the fused beam's hop as plain PyTorch composed it
around ``beam_update`` before the hop moved into the kernel: the step
below (``composed_step``), which kept one hop count for the batch and
masked each output with the batch-wide condition. Bit for bit: buffers,
``cur``, ``ndis`` and the hop count (the new state's largest ``steps``).

Also on the CPU: the distance kernels' by-node forms (K3 reading the
adjacency row itself; K2 and K4 skipping a row whose cur is -1) against
their ids forms, the wrappers' checks, and the counters of the hop path a
search took. The kernel is held against this plain version on the card
by tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

from hnsw_tpu_torch import graphs, trace
from hnsw_tpu_torch.ops import _cuda, beam, beam_kernel, dist_kernel
from hnsw_tpu_torch.ops.beam_kernel import beam_update_plain

from torch_threads import one_torch_thread  # noqa: F401  (a fixture)

INF = float("inf")
N_NODES, K = 500, 16


def composed_step(s, nbrs0, cand_d, ef, ef_live, limit):
    """The fused beam's hop as it was composed of plain PyTorch ops: the
    batch-wide condition, the expand's gather and masks, ``beam_update``
    at the full width, the slots past ef_live killed after it, and every
    output kept where the condition is false."""
    q = s["buf_d"].shape[0]
    live = (s["cur"] >= 0).any() & (s["hops"] < limit)
    cur = s["cur"]
    step_ok = cur >= 0
    nbrs = nbrs0[torch.where(step_ok, cur, 0)[:, None].long()]   # [Q, 1, K]
    nbrs = nbrs.reshape(q, -1)
    nbrs = torch.where((nbrs >= 0) & step_ok[:, None], nbrs, -1)
    d, p, c, nd = beam_update_plain(s["buf_d"], s["buf_p"], nbrs,
                                    cand_d.contiguous(), ef)
    if ef_live is not None:
        dead = torch.arange(ef)[None, :] >= ef_live
        d = torch.where(dead, INF, d)
        p = torch.where(dead, -1, p)
        c = torch.where(((p >> 1) == c[:, None]).any(1), c, -1)
    return {"buf_d": torch.where(live, d, s["buf_d"]),
            "buf_p": torch.where(live, p, s["buf_p"]),
            "cur": torch.where(live, c, cur),
            "ndis": s["ndis"] + torch.where(live, nd, 0),
            "hops": s["hops"] + live.to(torch.int32)}


def new_step(s, nbrs0, cand_d, ef_live, limit):
    lim = torch.tensor(limit, dtype=torch.int64)
    live = None if ef_live is None else torch.tensor(ef_live,
                                                      dtype=torch.int64)
    d, p, c, nd, st = beam_kernel.beam_hop(
        s["buf_d"], s["buf_p"], s["cur"], s["ndis"], s["steps"], nbrs0,
        cand_d, live, lim)
    return {"buf_d": d, "buf_p": p, "cur": c, "ndis": nd, "steps": st}


def graph(rng, k: int = K) -> torch.Tensor:
    """A random adjacency [N_NODES, k]: distinct ids a row, a -1 tail of
    random length."""
    nbrs = np.stack([rng.choice(N_NODES, k, replace=False)
                     for _ in range(N_NODES)]).astype(np.int32)
    tail = rng.integers(0, k // 2, N_NODES)
    nbrs[np.arange(k)[None, :] >= k - tail[:, None]] = -1
    return torch.from_numpy(nbrs)


KINDS = ("live", "seeds", "converged", "padded")


def state(rng, kinds, ef, ef_live, hops):
    """A mid-search state of the fused beam, one row of each given kind:

      * live: a sorted buffer, expanded and unexpanded slots, cur the id of
        an expanded slot, steps = hops;
      * seeds: the first hop's state, slot 0 expanded and cur, 1..E-1
        waiting unexpanded;
      * converged: every finite slot expanded, cur -1, steps <= hops;
      * padded: an empty row, cur -1, steps 0.

    Slots at or past ef_live are empty, as the search keeps them. Row 0 is
    a converged row with steps = hops, so the composed hop count equals
    the largest steps."""
    width = ef if ef_live is None else ef_live
    q = len(kinds)
    buf_d = np.full((q, ef), np.inf, np.float32)
    buf_p = np.full((q, ef), -1, np.int32)
    cur = np.full(q, -1, np.int32)
    steps = np.zeros(q, np.int32)
    for r, kind in enumerate(kinds):
        if kind == "padded":
            continue
        n = int(rng.integers(1, min(width, N_NODES // 2) + 1)) \
            if kind != "seeds" else int(rng.integers(1, min(width, 8) + 1))
        ids = rng.choice(N_NODES, n, replace=False).astype(np.int32)
        # small integer keys: ties between buffer and candidates
        buf_d[r, :n] = np.sort(rng.integers(0, 40, n)).astype(np.float32)
        if kind == "live":
            exp = rng.random(n) < 0.5
            j = int(rng.integers(0, n))
            exp[j] = True
            cur[r] = ids[j]
            steps[r] = hops
        elif kind == "seeds":
            exp = np.zeros(n, bool)
            exp[0] = True
            cur[r] = ids[0]
            steps[r] = hops
        else:
            exp = np.ones(n, bool)
            steps[r] = hops if r == 0 else int(rng.integers(0, hops + 1))
        buf_p[r, :n] = (ids << 1) | exp
    t = torch.from_numpy
    s = {"buf_d": t(buf_d), "buf_p": t(buf_p), "cur": t(cur),
         "ndis": t(rng.integers(0, 500, q).astype(np.int32))}
    return s, t(steps)


def hop_case(counts: dict, ef: int, ef_live, hops: int, seed: int,
             k: int = K):
    """(state, steps, adjacency, candidate distances) of one hop: row 0
    converged (steps = hops), then the rows of each kind in ``counts`` in
    a random order; the first ten stepping rows' nodes list three ids of
    their buffer first (candidates that are not fresh)."""
    rng = np.random.default_rng(seed)
    nbrs0 = graph(rng, k)
    kinds = ["converged"] + [kd for kd in KINDS
                             for _ in range(counts.get(kd, 0))]
    kinds = [kinds[0]] + list(rng.permutation(kinds[1:]))
    s, steps = state(rng, kinds, ef, ef_live, hops)
    for r in np.nonzero(s["cur"].numpy() >= 0)[0][:10]:
        ids = s["buf_p"][r][s["buf_p"][r] >= 0] >> 1
        nbrs0[s["cur"][r], :3] = ids[:3].repeat(3)[:3]
    cd = torch.from_numpy(rng.integers(0, 40, (len(kinds), k)).astype(
        np.float32))
    return s, steps, nbrs0, cd


def assert_same(got, want, tag=""):
    for name in ("buf_d", "buf_p", "cur", "ndis"):
        assert torch.equal(got[name], want[name]), (tag, name)
    assert int(got["steps"].max()) == int(want["hops"]), tag


# (rows of each kind, ef, ef_live, hops before the hop, limit)
HOP_CASES = {
    "random": ({"live": 40, "converged": 10, "padded": 6}, 32, None, 5, 40),
    "ef_live": ({"live": 40, "converged": 10, "padded": 6}, 64, 37, 5, 45),
    "seeds": ({"seeds": 30, "converged": 4, "padded": 10}, 32, None, 0, 40),
    "seeds_ef_live": ({"seeds": 30, "padded": 10}, 32, 5, 0, 13),
    "wide": ({"live": 20, "converged": 4}, 256, 200, 9, 208),
    "at_hop_limit": ({"live": 30, "converged": 8}, 32, None, 40, 40),
    "past_condition": ({"converged": 30, "padded": 8}, 32, None, 12, 40),
    "first_hop_at_limit_zero": ({"seeds": 8, "padded": 2}, 32, None, 0, 0),
}


@pytest.mark.parametrize("case", list(HOP_CASES))
def test_hop_entry_equals_composed_step(case):
    """One hop on a mid-search state: converged rows (cur -1), padded
    rows, ef_live < ef, seeds waiting unexpanded, a hop at hop_limit and a
    hop past the condition (nothing changes, the hop is not counted)."""
    counts, ef, ef_live, hops, limit = HOP_CASES[case]
    s, steps, nbrs0, cd = hop_case(counts, ef, ef_live, hops,
                                   sorted(HOP_CASES).index(case))
    want = composed_step(dict(s, hops=torch.tensor(hops, dtype=torch.int32)),
                         nbrs0, cd, ef, ef_live, limit)
    got = new_step(dict(s, steps=steps), nbrs0, cd, ef_live, limit)
    assert_same(got, want, case)
    changed = not torch.equal(got["buf_p"], s["buf_p"])
    assert changed == (case not in ("at_hop_limit", "past_condition",
                                    "first_hop_at_limit_zero")), case


def composed_beam(entry_ids, entry_dists, nbrs0, dist, *, ef, limit,
                  ef_live, bound, chunk):
    """The fused beam's loop before the hop moved into K1 (its
    initialisation is the one ``beam_search_fused`` keeps), each hop
    ``composed_step``."""
    q, e = entry_ids.shape
    col = torch.arange(e)[None, :]
    active = entry_ids >= 0
    if ef_live is not None:
        active = active & (col < ef_live)
    buf_d = torch.full((q, ef), INF)
    buf_d[:, :e] = torch.where(active, entry_dists, INF)
    buf_p = torch.full((q, ef), -1, dtype=torch.int32)
    buf_p[:, :e] = torch.where(active, (entry_ids << 1) | (col == 0).int(),
                               -1)
    s = {"buf_d": buf_d, "buf_p": buf_p,
         "cur": torch.where(active[:, 0], entry_ids[:, 0], -1).int(),
         "ndis": torch.zeros(q, dtype=torch.int32),
         "hops": torch.zeros((), dtype=torch.int32)}

    def cond(s):
        return (s["cur"] >= 0).any() & (s["hops"] < limit)

    def step(s):
        safe = torch.where(s["cur"] >= 0, s["cur"], 0)
        return composed_step(s, nbrs0, dist(safe), ef, ef_live, limit)

    return graphs.EagerLoop(chunk).run(cond, step, s, bound)


# (ef, ef_live, limit, bound, loop chunk, entry seeds)
LOOP_CASES = {
    "bounded": (32, None, 40, 40, 16, 1),
    "ef_live": (64, 41, 49, 72, 16, 1),
    "hop_limit": (32, None, 6, 40, 16, 1),
    "seeds_unbounded": (32, None, 1 << 30, None, 16, 8),
    "seeds_ef_live_chunk_1": (32, 20, 28, None, 1, 8),
}


@pytest.mark.parametrize("case", list(LOOP_CASES))
def test_fused_beam_equals_composed_loop(case):
    """Whole searches of ``beam_search_fused`` against the composed loop,
    on a random graph whose nodes are points of a plane: the bounded loop
    (every step run) and the unbounded one (its condition read once a
    chunk), ef_live < ef, a hop limit hit mid-search, multi-seed entries,
    padded query rows."""
    ef, ef_live, limit, bound, chunk, n_seed = LOOP_CASES[case]
    rng = np.random.default_rng(len(case))
    nbrs0 = graph(rng)
    pts = torch.from_numpy(rng.normal(size=(N_NODES, 4)).astype(np.float32))
    q = 48
    qs = torch.from_numpy(rng.normal(size=(q, 4)).astype(np.float32))

    def dist(cur):
        return dist_kernel.gathered_vec_dist_cur(pts, nbrs0, cur, qs,
                                                 metric="l2")

    seeds = torch.from_numpy(np.stack([
        rng.choice(N_NODES, n_seed, replace=False)
        for _ in range(q)]).astype(np.int32))
    sd = dist_kernel.gathered_vec_dist_plain(pts, seeds, qs, metric="l2")
    sd, o = torch.sort(sd, dim=1, stable=True)
    seeds = torch.gather(seeds, 1, o)
    seeds[-5:], sd[-5:] = -1, INF                    # padded rows
    want = composed_beam(seeds, sd, nbrs0, dist, ef=ef, limit=limit,
                         ef_live=ef_live, bound=bound, chunk=chunk)
    got = beam.beam_search_fused(
        seeds, sd, nbrs0, dist, ef=ef, max_hops=4 * ef + 16,
        ef_live=ef_live, hop_limit=limit, bound=bound,
        loop=graphs.EagerLoop(chunk))
    assert torch.equal(got.buf_ids, want["buf_p"] >> 1)
    assert torch.equal(got.buf_dist, want["buf_d"])
    assert torch.equal(got.buf_exp, (want["buf_p"] & 1) == 1)
    assert torch.equal(got.ndis, want["ndis"])
    assert int(got.hops) == int(want["hops"]) > 0
    if case == "hop_limit":
        assert int(got.hops) == limit


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "sq8"])
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_vec_dist_by_node_equals_ids_form(dtype, metric):
    """K3 by node: query q's candidates are the adjacency row nbrs[cur[q]];
    where cur and the id are not -1 the distance is the ids form's bit for
    bit, else +inf."""
    rng = np.random.default_rng(3)
    nbrs0 = graph(rng)
    table = torch.from_numpy(rng.normal(size=(N_NODES, 12)).astype(
        np.float32))
    dequant = None
    if dtype == "bfloat16":
        table = table.to(torch.bfloat16)
    elif dtype == "sq8":
        table = torch.from_numpy(rng.integers(0, 256, (N_NODES, 12)).astype(
            np.uint8))
        dequant = (torch.rand(12), torch.rand(12) / 100)
    cur = torch.from_numpy(rng.integers(-1, N_NODES, 64).astype(np.int32))
    cur[:4] = -1
    qs = torch.randn(64, 12)
    got = dist_kernel.gathered_vec_dist_cur(table, nbrs0, cur, qs, dequant,
                                            metric=metric)
    ids = nbrs0[cur.clamp(min=0).long()]
    ok = (cur[:, None] >= 0) & (ids >= 0)
    want = dist_kernel.gathered_vec_dist_ids(
        table, torch.where(ok, ids, 0), qs, dequant, metric=metric)
    assert torch.equal(got[ok], want[ok])
    assert torch.isinf(got[~ok]).all() and (got[~ok] > 0).all()
    assert (~ok).any() and ok.any()


def test_packed_kernels_skip_rows_without_a_node():
    """K2 and K4 read no row for a cur of -1 and give +inf there; every
    other row is the one they gave before."""
    rng = np.random.default_rng(4)
    codes = torch.from_numpy(rng.integers(0, 256, (30, 16 * 8)).astype(
        np.uint8))
    nbr_sq = torch.rand(30, 16)
    qs = torch.randn(10, 8)
    cur = torch.from_numpy(rng.integers(0, 30, 10).astype(np.int32))
    safe = dist_kernel.packed_row_dist_ids(codes, nbr_sq, cur, qs, bits=8,
                                           metric="l2")
    words = codes.view(torch.int32)
    dots = dist_kernel.packed_row_dist_words_ids(words, cur, qs, wp=2,
                                                 bits=8)
    cur[[2, 7]] = -1
    got = dist_kernel.packed_row_dist_ids(codes, nbr_sq, cur, qs, bits=8,
                                          metric="l2")
    got_w = dist_kernel.packed_row_dist_words_ids(words, cur, qs, wp=2,
                                                  bits=8)
    for g, w in ((got, safe), (got_w, dots)):
        keep = cur >= 0
        assert torch.equal(g[keep], w[keep])
        assert torch.isinf(g[~keep]).all()


def test_hop_wrappers_refuse_what_the_kernel_does_not_take():
    s = {"buf_d": torch.zeros((4, 32)),
         "buf_p": torch.full((4, 32), -1, dtype=torch.int32),
         "cur": torch.full((4,), -1, dtype=torch.int32),
         "ndis": torch.zeros(4, dtype=torch.int32),
         "steps": torch.zeros(4, dtype=torch.int32)}
    nbrs0 = torch.zeros((9, K), dtype=torch.int32)
    lim = torch.tensor(3)
    args = (s["buf_d"], s["buf_p"], s["cur"], s["ndis"], s["steps"], nbrs0,
            torch.zeros((4, K)))
    with pytest.raises(ValueError, match="limit"):
        beam_kernel.beam_hop(*args, None, 3)
    with pytest.raises(ValueError, match="ef_live"):
        beam_kernel.beam_hop(*args, torch.tensor(3, dtype=torch.int32), lim)
    with pytest.raises(ValueError, match="cand_d"):
        beam_kernel.beam_hop(*args[:6], torch.zeros((4, K + 1)), None, lim)
    with pytest.raises(ValueError, match="steps"):
        beam_kernel.beam_hop(*args[:4], s["steps"].long(), *args[5:], None,
                             lim)
    with pytest.raises(ValueError, match="cur"):
        dist_kernel.gathered_vec_dist_cur(
            torch.zeros((9, 4)), nbrs0, s["cur"].long(), torch.zeros((4, 4)),
            metric="l2")
    _cuda.reset_launch_counts()
    out = beam_kernel.beam_hop(*args, None, lim)
    assert all(torch.equal(a, b) for a, b in zip(out, args[:5]))
    assert _cuda.launch_counts()["beam_update"] == 0


def test_hop_wrapper_launches_in_place(monkeypatch):
    """On the card (faked: ``on_cpu`` answers False, launches recorded and
    not run) the hop is one launch of K1's hop entry, counted as K1's
    under the tag "hop", on the state's own tensors, which it returns."""
    launched = []
    monkeypatch.setattr(beam_kernel, "on_cpu", lambda *tensors: False)
    monkeypatch.setattr(beam_kernel._BEAM_UPDATE, "launch",
                        lambda *a, symbol=None: launched.append((symbol, a)))
    monkeypatch.setattr(beam_kernel._BEAM_UPDATE, "by_tag", {})
    s = [torch.zeros((4, 64)), torch.zeros((4, 64), dtype=torch.int32)] + \
        [torch.zeros(4, dtype=torch.int32) for _ in range(3)]
    nbrs0 = torch.zeros((9, K), dtype=torch.int32)
    lim, live = torch.tensor(5), torch.tensor(40)
    out = beam_kernel.beam_hop(*s, nbrs0, torch.zeros((4, K)), live, lim)
    assert all(a is b for a, b in zip(out, s))
    (symbol, a), = launched
    assert symbol == "hnsw_beam_hop"
    assert a[3] == 9 and a[5:8] == (4, 64, K)
    assert a[8] == live.data_ptr() and a[9] == lim.data_ptr()
    assert beam_kernel._BEAM_UPDATE.by_tag == {"hop": 1}


def test_searches_count_their_hop_path():
    """A fused-beam search on the CPU counts one ``searches.composed_hop``
    (none ``searches.kernel_hop``); a legacy-beam search counts neither."""
    from hnsw_tpu_torch import HnswIndex, synthetic_workload
    wl = synthetic_workload(600, 8, n_queries=20, seed=1)
    idx = HnswIndex(8, 8, capacity=700, ef_construction=40, device="cpu")
    idx.add(wl.base)
    with trace.collect() as t:
        idx.search(wl.queries, 5, ef_search=32)
        idx.n_expand = 2
        idx.search(wl.queries, 5, ef_search=32)
    assert t.counters.get("searches.composed_hop") == 1
    assert "searches.kernel_hop" not in t.counters
