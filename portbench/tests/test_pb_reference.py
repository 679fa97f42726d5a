"""The plain reference against brute force in NumPy at a tiny size."""

import numpy as np
import torch

import pb_tiny  # noqa: F401  (puts the repository on sys.path)
from portbench import reference


def _data(n=700, q=40, d=12, seed=5):
    r = np.random.default_rng(seed)
    return (r.normal(size=(n, d)).astype(np.float32),
            r.normal(size=(q, d)).astype(np.float32))


def test_exact_topk_equals_brute_force(monkeypatch):
    base, qs = _data()
    monkeypatch.setattr(reference, "Q_BLOCK", 16)
    monkeypatch.setattr(reference, "N_BLOCK", 128)    # merges across blocks
    ids, d = reference.exact_topk(torch.from_numpy(qs),
                                  torch.from_numpy(base), 10)
    full = ((qs[:, None, :].astype(np.float64) - base[None]) ** 2).sum(-1)
    want = np.argsort(full, axis=1, kind="stable")[:, :10]
    assert (ids.numpy() == want).mean() > 0.99
    np.testing.assert_allclose(d.numpy(), np.take_along_axis(full, want, 1),
                               rtol=1e-4, atol=1e-4)


def test_sq8_rederived_round_to_grid():
    base, _ = _data(n=300)
    off, sc = reference.sq8_params(torch.from_numpy(base[:200]))
    lo, hi = base[:200].min(0), base[:200].max(0)
    np.testing.assert_array_equal(off.numpy(), lo)
    np.testing.assert_array_equal(
        sc.numpy(), np.maximum(hi - lo, np.float32(1e-20)) / np.float32(255))
    xh = reference.sq8_decode(torch.from_numpy(base), off, sc).numpy()
    u = np.clip(np.round((base - lo) / sc.numpy()), 0, 255).astype(np.float32)
    np.testing.assert_array_equal(xh, lo + sc.numpy() * u)
    assert len(np.unique(u)) <= 256 and u.min() >= 0 and u.max() <= 255
    # rows past the training range clip to the end codes
    assert np.abs(xh - base).max() <= np.abs(base).max()
    rows = reference.stored_rows({"dtype": "sq8", "sq_train_rows": 200},
                                 torch.from_numpy(base)).numpy()
    np.testing.assert_array_equal(rows, xh)
    f32 = torch.from_numpy(base)
    assert reference.stored_rows({"dtype": "float32"}, f32) is f32


def test_tf32_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11,
                      1.0 + 2 ** -12, -3.14159265, 1e-30])
    y = reference.tf32(x)
    bits = y.view(torch.int32)
    assert bool(((bits & 0x1FFF) == 0).all())
    assert y[0] == 1.0 and y[1] == 1.0 + 2 ** -10
    assert y[2] == 1.0                       # a tie rounds to even
    assert y[3] == 1.0 + 2 ** -9             # a tie rounds to even (up)
    assert y[4] == 1.0
    assert abs(float(y[5]) + 3.14159265) < 2e-3


def test_pair_dist_and_hits():
    q = torch.tensor([[0.0, 0.0], [1.0, 1.0]])
    rows = torch.tensor([[[3.0, 4.0], [0.0, 1.0]], [[1.0, 1.0], [2.0, 3.0]]])
    np.testing.assert_array_equal(reference.pair_dist(q, rows).numpy(),
                                  [[25.0, 1.0], [0.0, 5.0]])
    ids = torch.tensor([[1, 2, 3], [4, 5, 6]])
    truth = torch.tensor([[3, 2, 9], [7, 8, 9]])
    assert reference.hits(ids, truth) == 2
