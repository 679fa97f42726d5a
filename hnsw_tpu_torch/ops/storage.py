"""The stored rows of an index and their codec: ``Storage``.

Rows are f32 or bf16 values, sq8 uint8 codes under a per-dim affine
``x̂ = offset + scale · u`` (faiss ``IndexHNSWSQ``) or PQ codes under
per-subspace codebooks (faiss ``IndexHNSWPQ``). Every build, search and
vacuum distance is exact over the stored x̂, and this is the one place
where the codec meets the kernels: the host encode to x̂, the write of x̂
as codes, decoding, the exact distance route (K3, K5, ADC), the capture
key's tensors, the codec's save arrays and ``grow``.

The codec's tensors live on the rows' device and are made once, when the
codec is set (trained, copied or loaded): a capture keys on their
identity, so nothing here makes a codec tensor per call. The numpy copies
stay here, for the host encode and for saving.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import HnswConfig
from .dist_kernel import gathered_vec_dist_cur, gathered_vec_dist_ids
from .distances import brute_force_topk, decode_rows
from .hop_kernel import fused_gather_distances
from .packed import quantization_params, quantize_codes
from .pq import adc_distance, decode_pq, encode_pq, pq_lut, train_pq

SQ_KEYS, PQ_KEY = ("sq_offset", "sq_scale"), "pq_codebooks"  # npz keys


def _host(a) -> np.ndarray:
    """A codec array as an f32 numpy copy (a tensor's from the host)."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.array(a, np.float32)


class Storage:
    """``rows`` [capacity, d] (f32 / bf16 values or sq8 codes) or
    [capacity, pq_m] (PQ codes), and the codec: ``sq`` = (offset [d],
    scale [d]) or ``pq`` = codebooks [pq_m, ksub, dsub], f32 tensors on
    ``rows.device`` (None where unset). ``Storage(rows, sq=..., pq=...)``
    takes the codec as numpy arrays or tensors."""

    def __init__(self, rows: torch.Tensor, *, sq=None, pq=None):
        self.rows = rows
        self.sq = self.pq = None
        self._host: dict = {}       # the codec's save arrays, f32 numpy
        if sq is not None:
            self.set_codec(dict(zip(SQ_KEYS, sq)))
        if pq is not None:
            self.set_codec({PQ_KEY: pq})

    @classmethod
    def empty(cls, cfg: HnswConfig, device) -> "Storage":
        """Zero rows of ``cfg``'s storage dtype and width, no codec yet."""
        return cls(torch.zeros((cfg.capacity, cfg.storage_width),
                               dtype=getattr(torch, cfg.storage_dtype),
                               device=device))

    @classmethod
    def load(cls, rows: np.ndarray, cfg: HnswConfig, device,
             arrays) -> "Storage":
        """Saved rows of either package as ``cfg``'s storage on ``device``
        (bf16 from the reference's 2-byte void items' bits, as int16 or not,
        or from widened f32), with the codec from its save ``arrays``."""
        if rows.dtype.kind == "V" and rows.dtype.itemsize == 2:
            rows = rows.view(np.int16)
        t = torch.from_numpy(np.ascontiguousarray(rows))
        if cfg.storage_dtype == "bfloat16" and t.dtype == torch.int16:
            t = t.view(torch.bfloat16)
        out = cls(t.to(device, getattr(torch, cfg.storage_dtype)))
        out.set_codec(arrays)
        return out

    # -- the codec ----------------------------------------------------------
    def train(self, x: np.ndarray, cfg: HnswConfig) -> None:
        """The codec of ``cfg``'s storage from f32 ``x`` [n, d], on the
        rows' device: sq8 the per-dim [min, max] range (faiss
        ``ScalarQuantizer::train``, QT_8bit), PQ the per-subspace k-means
        codebooks (``ops/pq.py`` ``train_pq``); flat storage has none."""
        dev = self.rows.device
        if cfg.is_pq:
            self.set_codec({PQ_KEY: train_pq(x, cfg.pq_m, ksub=cfg.pq_ksub,
                                             seed=cfg.seed, device=dev)})
        elif cfg.is_sq:
            self.set_codec(dict(zip(SQ_KEYS, quantization_params(
                torch.from_numpy(x).to(dev),
                torch.ones(len(x), dtype=torch.bool, device=dev), 8))))

    def set_codec(self, arrays) -> None:
        """The codec from its save arrays (``SQ_KEYS`` or ``PQ_KEY`` in a
        dict or an open npz; without them nothing is set): f32 numpy copies
        kept here, and their tensors made once on the rows' device."""
        host = {k: _host(arrays[k]) for k in (*SQ_KEYS, PQ_KEY)
                if k in arrays}
        if not host:
            return
        self._host, dev = host, self.rows.device
        if PQ_KEY in host:
            self.pq = torch.from_numpy(host[PQ_KEY]).to(dev)
        else:
            self.sq = tuple(torch.from_numpy(host[k]).to(dev)
                            for k in SQ_KEYS)

    def codec_arrays(self) -> dict:
        """The codec's save arrays under the reference's npz keys (empty
        with no codec)."""
        return dict(self._host)

    @property
    def coded(self) -> bool:
        """An sq8 or PQ codec is set."""
        return bool(self._host)

    @property
    def dim(self) -> int:
        """Width of a decoded row."""
        pq = self.pq
        return self.rows.shape[1] if pq is None else pq.shape[0] * pq.shape[2]

    def refs(self) -> list:
        """The tensors a capture that reads the rows keys on."""
        return [self.rows, *(self.sq or ()),
                *(() if self.pq is None else (self.pq,))]

    def grow(self, capacity: int) -> None:
        """Zero rows up to ``capacity``; the codec's tensors stay."""
        extra = capacity - self.rows.shape[0]
        if extra > 0:
            self.rows = torch.cat([self.rows, self.rows.new_zeros(
                (extra, *self.rows.shape[1:]))])

    # -- encode, write, read --------------------------------------------------
    def encode(self, x: np.ndarray) -> np.ndarray:
        """f32 rows -> x̂ on the host (sq8 in numpy, bit for bit the
        reference's; PQ through the codes on the rows' device; flat rows as
        they are). The builder sees x̂, so every build distance is what a
        search measures, and ``write`` encodes x̂ back to the same codes."""
        if self.sq is not None:
            off, sc = (self._host[k] for k in SQ_KEYS)
            u = np.clip(np.round((x - off) / sc), 0, 255).astype(np.float32)
            return off + sc * u
        if self.pq is not None:
            codes = encode_pq(torch.from_numpy(x).to(self.rows.device),
                              self.pq)
            return decode_pq(codes, self.pq).cpu().numpy()
        return x

    def write(self, ids, x: torch.Tensor) -> None:
        """Store f32 rows ``x`` (x̂ for a codec) at ``ids`` (anything that
        indexes ``rows``): sq8 or PQ codes, else ``x`` in the rows'
        dtype."""
        if self.sq is not None:
            codes = quantize_codes(x, self.sq[0], self.sq[1], 8)
        elif self.pq is not None:
            codes = encode_pq(x, self.pq)
        else:
            codes = x.to(self.rows.dtype)
        self.rows[ids] = codes

    def decode(self, rows: torch.Tensor) -> torch.Tensor:
        """Stored rows -> f32 (x̂ for a codec)."""
        return decode_rows(rows, self.sq, self.pq)

    def read(self, ids: torch.Tensor) -> torch.Tensor:
        """f32 x̂ of the rows ``ids`` (valid row ids)."""
        return self.decode(self.rows[ids])

    def pq_codes(self, codebooks: torch.Tensor, start: int = 0,
                 stop: int | None = None) -> torch.Tensor:
        """PQ codes of rows [start, stop) under other ``codebooks``."""
        return encode_pq(self.rows[start:stop], codebooks, dequant=self.sq)

    # -- exact distances ------------------------------------------------------
    def distance_fn(self, queries: torch.Tensor, metric: str,
                    pallas_hop: bool = False):
        """distance_to(ids [Q, K], mask) -> f32 [Q, K] surrogate distances
        of ``queries`` to the rows ``ids``, exact over x̂: K3 on f32, bf16
        and sq8 rows (the affine in the kernel), K5 instead on f32 and bf16
        rows with ``pallas_hop`` (for every d: the reference's d % 128 gate
        is a TPU lane limit), ADC lookups in per-query tables built once
        here on PQ codes. On CPU tensors each kernel runs its plain
        version. Masked ids read row 0 and are to be ignored."""
        qf = queries.float().contiguous()
        rows, sq = self.rows, self.sq
        if self.pq is not None:
            lut = pq_lut(qf, self.pq, metric)                    # [Q, m, ksub]
            return lambda ids, mask: adc_distance(
                lut, rows[torch.where(mask, ids, 0).long()])
        k5 = pallas_hop and sq is None

        def distance_to(ids: torch.Tensor, mask: torch.Tensor):
            safe = torch.where(mask, ids, 0).to(torch.int32)
            if k5:
                return fused_gather_distances(rows, safe, qf, metric=metric)
            return gathered_vec_dist_ids(rows, safe, qf, sq, metric=metric)

        return distance_to

    def hop_distances(self, queries: torch.Tensor, neighbors0: torch.Tensor,
                      metric: str, distance_to):
        """The fused beam's dist(cur [Q]) -> f32 [Q, m0]: K3 by node (it
        reads the adjacency row ``neighbors0[cur]``); on PQ codes
        ``distance_fn``'s ``distance_to`` over the gathered row (a cur of
        -1 reads the last row, not to be read)."""
        if self.pq is not None:
            def dist(cur: torch.Tensor) -> torch.Tensor:
                nbrs = neighbors0[cur]
                return distance_to(nbrs, nbrs >= 0)

            return dist
        qf = queries.float().contiguous()
        rows, sq = self.rows, self.sq

        def dist(cur: torch.Tensor) -> torch.Tensor:
            return gathered_vec_dist_cur(rows, neighbors0, cur, qf, sq,
                                         metric=metric)

        return dist

    def rerank(self, ids: torch.Tensor, queries: torch.Tensor,
               metric: str) -> torch.Tensor:
        """Exact surrogate distances f32 [Q, W] of f32 ``queries`` to an id
        buffer int32 [Q, W] (-1 reads row 0): K3, or ADC on PQ codes."""
        safe = ids.clamp(min=0)
        if self.pq is not None:
            return adc_distance(pq_lut(queries, self.pq, metric),
                                self.rows[safe.long()])
        return gathered_vec_dist_ids(self.rows, safe, queries, self.sq,
                                     metric=metric)

    def exact_topk(self, queries: torch.Tensor, k: int, metric: str,
                   n_valid: int):
        """``brute_force_topk`` over x̂ of rows [0, n_valid)."""
        return brute_force_topk(queries, self.rows, k, metric=metric,
                                n_valid=n_valid, dequant=self.sq, pq=self.pq)
