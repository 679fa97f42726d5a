"""The plain reference of the benchmark: exact k-nearest-neighbour search
in plain PyTorch, float32 with TF32 off, and the 8-bit scalar quantizer
that the sq8 configuration states (per-dimension [min, max] over the
training rows, codes rounded to the nearest of 256 grid points, decoded at
the grid point: x̂ = offset + scale * code) worked out again from the
benchmark's own data. That codec is the port's, not faiss's QT_8bit, which
floors a code and decodes at its cell's middle.

It imports nothing of the program. It takes the f32 vectors and queries
the benchmark made and, to judge them, the program's outputs (ids,
distances, stored rows, adjacency).

``tf32`` rounds operands to TF32's 10-bit mantissa: the control, the
reference computed one precision below the configuration's float32.
"""

from __future__ import annotations

from contextlib import contextmanager

import torch

Q_BLOCK = 4096          # query rows of one exact-search block
N_BLOCK = 1 << 18       # base rows of one exact-search block


@contextmanager
def no_tf32():
    """float32 matrix products in float32, not TF32."""
    m = torch.backends.cuda.matmul.allow_tf32
    c = torch.backends.cudnn.allow_tf32
    p = torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c
        torch.set_float32_matmul_precision(p)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to nearest (ties to even) on TF32's 10-bit
    mantissa, as a TF32 tensor core reads its operands."""
    b = x.float().contiguous().view(torch.int32)
    b = b + (0x0FFF + ((b >> 13) & 1))
    return (b & -0x2000).view(torch.float32)


def sq8_params(train: torch.Tensor):
    """(offset, scale) f32 [d] of the sq8 codec on ``train`` rows: the
    per-dim minimum and (max - min) / 255, floored above 0."""
    t = train.float()
    lo, hi = t.amin(0), t.amax(0)
    return lo, torch.clamp(hi - lo, min=1e-20) / 255.0


def sq8_decode(x: torch.Tensor, offset: torch.Tensor,
               scale: torch.Tensor) -> torch.Tensor:
    """x̂ = offset + scale * u, u = clip(round((x - offset) / scale), 0,
    255), each step rounded to float32 on its own."""
    u = torch.clamp(torch.round((x.float() - offset) / scale), 0, 255)
    return offset + scale * u


def stored_rows(cfg: dict, base: torch.Tensor) -> torch.Tensor:
    """The rows the configuration stores, worked out from ``base``: x̂ for
    sq8 (its codec trained on the first ``sq_train_rows`` rows), else the
    f32 rows themselves."""
    if cfg["dtype"] == "sq8":
        off, sc = sq8_params(base[:cfg["sq_train_rows"]])
        return sq8_decode(base, off, sc)
    return base


def control_topk(cfg: dict, base, queries, device):
    """The control's answers, host arrays (ids [Q, k], distances [Q, k]):
    the exact top-k of each query over the stored rows by distances whose
    products take TF32 operands."""
    rows = stored_rows(cfg, torch.from_numpy(base).to(device))
    ids, d = exact_topk(torch.from_numpy(queries).to(device), rows,
                        cfg["k"], rounding=tf32)
    return ids.cpu().numpy(), d.cpu().numpy()


def exact_topk(queries: torch.Tensor, base: torch.Tensor, k: int, *,
               rounding=None):
    """(ids int64 [Q, k], squared L2 f32 [Q, k]) of the exact k nearest
    rows of ``base``, ascending, in blocks. ``rounding`` (the control)
    is applied to both operands of the dot products."""
    q_all = queries.float()
    out_i, out_d = [], []
    with no_tf32():
        xn = (base.float() ** 2).sum(1)
        xb = base.float() if rounding is None else rounding(base)
        for q0 in range(0, len(q_all), Q_BLOCK):
            q = q_all[q0:q0 + Q_BLOCK]
            qn = (q ** 2).sum(1, keepdim=True)
            qr = q if rounding is None else rounding(q)
            best_d = best_i = None
            for n0 in range(0, len(base), N_BLOCK):
                x = xb[n0:n0 + N_BLOCK]
                d = xn[n0:n0 + N_BLOCK][None, :] - 2.0 * (qr @ x.T) + qn
                kk = min(k, d.shape[1])
                dv, di = torch.topk(d, kk, dim=1, largest=False)
                di = di + n0
                if best_d is not None:
                    dv = torch.cat([best_d, dv], 1)
                    di = torch.cat([best_i, di], 1)
                    dv, o = torch.topk(dv, min(k, dv.shape[1]), dim=1,
                                       largest=False)
                    di = torch.gather(di, 1, o)
                best_d, best_i = dv, di
            o = torch.argsort(best_d, dim=1, stable=True)
            out_d.append(torch.gather(best_d, 1, o))
            out_i.append(torch.gather(best_i, 1, o))
    return torch.cat(out_i), torch.cat(out_d)


def pair_dist(queries: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Squared L2 of each query [Q, d] to its rows [Q, k, d], summed in
    float64 (the reading that a returned distance is held to)."""
    diff = rows.double() - queries.double()[:, None, :]
    return (diff * diff).sum(-1)


def hits(ids: torch.Tensor, truth: torch.Tensor) -> int:
    """Returned ids [Q, k] that are among the true k of their row."""
    return int((ids[:, :, None] == truth[:, None, :]).any(2).sum())
