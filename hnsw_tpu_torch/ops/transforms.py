"""Vector transforms — faiss ``VectorTransform`` (L2norm, random rotation,
PCA / PCAW / PCAR, OPQ), ported from ``hnsw_tpu.ops.transforms``.

faiss preprocesses vectors before they reach an index: L2 normalization
(cosine over an IP index), random rotations, PCA (optionally whitened or
rotated) and OPQ, the learned rotation that minimizes product-quantization
error (Ge et al., "Optimized Product Quantization", CVPR 2013).
``models/pretransform.py`` chains them in front of any index.

Every linear transform is one ``[n, d_in] @ [d_in, d_out]`` product in exact
f32 (the package turns TF32 off) on the transform's ``device`` (the card
unless the caller passes ``device="cpu"``). ``apply`` takes numpy (and
returns numpy, computed on ``device``) or a tensor (and returns a tensor,
computed on the tensor's own device). Training accumulates its factors
(the sum and ``XᵀX`` of PCA, OPQ's Procrustes cross term ``XᵀX̂``) on the
device in f32 chunks; only the d x d ``eigh`` / SVD runs on the host in
float64, as the reference's. The random rotation is the reference's numpy
draw, so it equals it bit for bit.

``state()`` / ``VectorTransform.from_state`` read and write the reference's
dicts key for key, so a transform trained in one package loads in the
other.
"""

from __future__ import annotations

import numpy as np
import torch

from ._cuda import default_device


class VectorTransform:
    """Base: maps f32 [n, d_in] -> f32 [n, d_out]. faiss surface:
    ``is_trained``, ``train(x)``, ``apply(x)``, ``reverse_transform(y)``
    (best-effort inverse, exact for orthonormal maps)."""

    def __init__(self, d_in: int, d_out: int, *, device=None):
        self.d_in = int(d_in)
        self.d_out = int(d_out)
        self.device = torch.device(device) if device is not None \
            else default_device()
        self.is_trained = False

    def train(self, x: np.ndarray) -> None:  # pragma: no cover - interface
        self.is_trained = True

    def apply(self, x):
        raise NotImplementedError

    def reverse_transform(self, y):
        raise NotImplementedError

    def _check(self, x) -> torch.Tensor:
        """x (numpy or tensor) as a contiguous f32 tensor: numpy on
        ``self.device``, a tensor on its own device."""
        if isinstance(x, torch.Tensor):
            t = x.float().contiguous()
        else:
            t = torch.from_numpy(np.ascontiguousarray(
                np.asarray(x, np.float32))).to(self.device)
        if t.dim() != 2 or t.shape[1] != self.d_in:
            raise ValueError(f"expected [n, {self.d_in}], got "
                             f"{tuple(t.shape)}")
        if not self.is_trained:
            raise RuntimeError(f"{type(self).__name__} must be trained "
                               "before apply() (faiss VectorTransform "
                               "parity)")
        return t

    # persistence: each transform serializes to a dict of arrays + kind tag
    def state(self) -> dict:
        raise NotImplementedError

    @staticmethod
    def from_state(st: dict, device=None) -> "VectorTransform":
        kind = str(st["kind"])
        cls = {"l2norm": NormalizationTransform,
               "linear": LinearTransform,
               "rr": RandomRotation,
               "pca": PCAMatrix,
               "opq": OPQMatrix}[kind]
        return cls._from_state(st, device)


def _like_input(y: torch.Tensor, x):
    """The result in the caller's form: numpy for numpy input."""
    return y if isinstance(x, torch.Tensor) else y.cpu().numpy()


class NormalizationTransform(VectorTransform):
    """faiss ``NormalizationTransform`` (factory ``L2norm``): row-normalize.
    In front of an IP index this turns inner product into cosine
    similarity."""

    def __init__(self, d: int, norm: float = 2.0, *, device=None):
        super().__init__(d, d, device=device)
        self.norm = float(norm)
        self.is_trained = True  # train-free

    def apply(self, x):
        t = self._check(x)
        n = torch.linalg.vector_norm(t, ord=self.norm, dim=1, keepdim=True)
        return _like_input(t / n.clamp(min=1e-20), x)

    def reverse_transform(self, y):
        # the scale is lost; the direction is kept
        return y.float() if isinstance(y, torch.Tensor) \
            else np.asarray(y, np.float32)

    def state(self) -> dict:
        return {"kind": "l2norm", "d": np.int64(self.d_in),
                "norm": np.float64(self.norm)}

    @classmethod
    def _from_state(cls, st: dict, device=None):
        return cls(int(st["d"]), float(st["norm"]), device=device)


class LinearTransform(VectorTransform):
    """y = A x + b with A [d_out, d_in] (faiss ``LinearTransform``), one f32
    product on the device; ``reverse_transform`` uses Aᵀ, exact when A is
    orthonormal (every trainer here gives orthonormal rows). ``a`` and
    ``b`` read as numpy (the state); setting either also copies it once to
    ``device``, where ``apply`` and ``reverse_transform`` use it."""

    def __init__(self, d_in: int, d_out: int, a: np.ndarray | None = None,
                 b: np.ndarray | None = None, *, device=None):
        super().__init__(d_in, d_out, device=device)
        self.a = a
        self.b = np.zeros(d_out, np.float32) if b is None else b
        if self.a is not None:
            if self.a.shape != (d_out, d_in):
                raise ValueError(f"A shape {self.a.shape} != "
                                 f"{(d_out, d_in)}")
            self.is_trained = True

    def _set(self, name: str, v) -> None:
        v = None if v is None else np.ascontiguousarray(
            np.asarray(v, np.float32))
        setattr(self, "_" + name, v)
        setattr(self, "_" + name + "_dev", None if v is None
                else torch.from_numpy(v).to(self.device))

    a = property(lambda self: self._a, lambda self, v: self._set("a", v))
    b = property(lambda self: self._b, lambda self, v: self._set("b", v))

    def apply(self, x):
        t = self._check(x)
        y = torch.matmul(t, self._a_dev.to(t.device).T) + \
            self._b_dev.to(t.device)
        return _like_input(y, x)

    def reverse_transform(self, y):
        t = y.float() if isinstance(y, torch.Tensor) else \
            torch.from_numpy(np.asarray(y, np.float32)).to(self.device)
        x = torch.matmul(t - self._b_dev.to(t.device),
                         self._a_dev.to(t.device))
        return _like_input(x, y)

    def state(self) -> dict:
        return {"kind": "linear", "a": self.a, "b": self.b}

    @classmethod
    def _from_state(cls, st: dict, device=None):
        a = np.asarray(st["a"])
        return cls(a.shape[1], a.shape[0], a=a, b=np.asarray(st["b"]),
                   device=device)


def _random_rotation(d_in: int, d_out: int, seed: int) -> np.ndarray:
    """Orthonormal [d_out, d_in] (rows) by QR of a seeded Gaussian, sign-fixed
    so the draw does not depend on the BLAS build: the reference's numpy
    code, so ``a`` equals its bit for bit."""
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((d_in, max(d_in, d_out))).astype(np.float64)
    q, r = np.linalg.qr(g)
    q = q * np.sign(np.diagonal(r))[None, :]
    return np.ascontiguousarray(q[:, :d_out].T.astype(np.float32))


class RandomRotation(LinearTransform):
    """faiss ``RandomRotationMatrix`` (factory ``RR{d}``): a seeded
    orthonormal rotation or projection, train-free."""

    def __init__(self, d_in: int, d_out: int | None = None, seed: int = 42,
                 *, device=None):
        d_out = d_in if d_out is None else int(d_out)
        self.seed = int(seed)
        super().__init__(d_in, d_out, a=_random_rotation(d_in, d_out, seed),
                         device=device)

    def state(self) -> dict:
        return {"kind": "rr", "a": self.a, "b": self.b,
                "seed": np.int64(self.seed)}

    @classmethod
    def _from_state(cls, st: dict, device=None):
        a = np.asarray(st["a"])
        t = cls(a.shape[1], a.shape[0], seed=int(st["seed"]), device=device)
        t.a, t.b = a, np.asarray(st["b"])
        return t


def _chunked_xty(x: torch.Tensor, y: torch.Tensor, chunk: int) -> np.ndarray:
    """Xᵀ Y accumulated in f32 over ``chunk``-row slices on the tensors'
    device, returned in float64 on the host."""
    g = torch.zeros((x.shape[1], y.shape[1]), dtype=torch.float32,
                    device=x.device)
    for c0 in range(0, x.shape[0], chunk):
        g += torch.matmul(x[c0:c0 + chunk].T, y[c0:c0 + chunk])
    return g.cpu().numpy().astype(np.float64)


class PCAMatrix(LinearTransform):
    """faiss ``PCAMatrix`` (factory ``PCA{d}`` / ``PCAW{d}`` whitened /
    ``PCAR{d}`` + random rotation): center, project onto the top ``d_out``
    eigenvectors of the covariance, optionally scale by λ^eigen_power
    (whitening = -0.5) and re-rotate. The sum and ``XᵀX`` are accumulated
    on the device in f32 chunks of min(n, 65,536) rows; the d x d ``eigh``
    runs on the host in float64."""

    def __init__(self, d_in: int, d_out: int, *, eigen_power: float = 0.0,
                 random_rotation: bool = False, seed: int = 42, device=None):
        if d_out > d_in:
            raise ValueError(f"PCA d_out {d_out} > d_in {d_in}")
        VectorTransform.__init__(self, d_in, d_out, device=device)
        self.a, self.b = None, np.zeros(d_out, np.float32)
        self.eigen_power = float(eigen_power)
        self.random_rotation = bool(random_rotation)
        self.seed = int(seed)
        self.eigenvalues: np.ndarray | None = None

    def train(self, x: np.ndarray) -> None:
        x = np.ascontiguousarray(np.asarray(x, np.float32))
        if x.ndim != 2 or x.shape[1] != self.d_in:
            raise ValueError(f"expected [n, {self.d_in}], got {x.shape}")
        n = len(x)
        if n < self.d_out:
            raise ValueError(f"PCA training needs >= d_out={self.d_out} "
                             f"points, got {n}")
        chunk = min(n, 65536)
        xt = torch.from_numpy(x).to(self.device)
        s = torch.zeros(self.d_in, dtype=torch.float32, device=self.device)
        for c0 in range(0, n, chunk):
            s += xt[c0:c0 + chunk].sum(0)
        g = _chunked_xty(xt, xt, chunk)
        mean = s.cpu().numpy().astype(np.float64) / n
        cov = g / n - np.outer(mean, mean)
        w, v = np.linalg.eigh(cov)                    # ascending
        w, v = w[::-1][: self.d_out], v[:, ::-1][:, : self.d_out]
        a = v.T                                       # [d_out, d_in] rows
        if self.eigen_power != 0.0:
            a = a * np.maximum(w, 1e-10)[:, None] ** self.eigen_power
        if self.random_rotation:
            a = _random_rotation(self.d_out, self.d_out, self.seed) @ a
        self.eigenvalues = w.astype(np.float32)
        self.a = np.ascontiguousarray(a.astype(np.float32))
        self.b = -(self.a @ mean.astype(np.float32))
        self.is_trained = True

    def state(self) -> dict:
        return {"kind": "pca", "a": self.a, "b": self.b,
                "eigen_power": np.float64(self.eigen_power),
                "random_rotation": np.bool_(self.random_rotation),
                "seed": np.int64(self.seed),
                "eigenvalues": (self.eigenvalues if self.eigenvalues
                                is not None else np.zeros(0, np.float32))}

    @classmethod
    def _from_state(cls, st: dict, device=None):
        a = np.asarray(st["a"])
        t = cls(a.shape[1], a.shape[0],
                eigen_power=float(st["eigen_power"]),
                random_rotation=bool(st["random_rotation"]),
                seed=int(st["seed"]), device=device)
        t.a, t.b = a, np.asarray(st["b"])
        ev = np.asarray(st["eigenvalues"])
        t.eigenvalues = ev if ev.size else None
        t.is_trained = True
        return t


class OPQMatrix(LinearTransform):
    """faiss ``OPQMatrix`` (factory ``OPQ{m}`` / ``OPQ{m}_{d}``): the learned
    orthonormal rotation minimizing PQ reconstruction error, trained by the
    non-parametric alternation of Ge et al. (CVPR 2013), as faiss does:

        repeat: (1) a few Lloyd steps of the m-subspace PQ on X R;
                (2) X̂ = decode(encode(X R)); solve the orthogonal
                    Procrustes problem min_R ‖X R − X̂‖_F by the SVD of
                    Xᵀ X̂ (host, d x d); R ← U Vᵀ.

    The PQ steps are ``ops/pq.py`` (``train_pq`` warm-started from the last
    codebooks, ``encode_pq``, ``decode_pq``) on the device, and so is the
    cross term. With ``d_out < d_in`` the rotation starts from PCA (faiss
    does the same for dimension-reducing OPQ)."""

    def __init__(self, d_in: int, m: int, d_out: int | None = None, *,
                 ksub: int = 256, niter: int = 16, pq_iters: int = 4,
                 max_points: int = 32768, seed: int = 42, device=None):
        d_out = d_in if d_out is None else int(d_out)
        if d_out % m:
            raise ValueError(f"OPQ m={m} must divide d_out={d_out}")
        VectorTransform.__init__(self, d_in, d_out, device=device)
        self.a, self.b = None, np.zeros(d_out, np.float32)
        self.m = int(m)
        self.ksub = int(ksub)
        self.niter = int(niter)
        self.pq_iters = int(pq_iters)
        self.max_points = int(max_points)
        self.seed = int(seed)

    def train(self, x: np.ndarray) -> None:
        x = np.ascontiguousarray(np.asarray(x, np.float32))
        if x.ndim != 2 or x.shape[1] != self.d_in:
            raise ValueError(f"expected [n, {self.d_in}], got {x.shape}")
        rng = np.random.default_rng(self.seed)
        if len(x) > self.max_points:
            x = x[rng.choice(len(x), self.max_points, replace=False)]
        ksub = min(self.ksub, max(len(x) // 2, 2))
        if self.d_out < self.d_in:
            # the PCA's bias is dropped: OPQ is a pure rotation in faiss,
            # and centering would shift IP-metric semantics
            pca = PCAMatrix(self.d_in, self.d_out, seed=self.seed,
                            device=self.device)
            pca.train(x)
            a = pca.a.astype(np.float64)
        else:
            a = _random_rotation(self.d_in, self.d_out,
                                 self.seed).astype(np.float64)
        x_dev = torch.from_numpy(x).to(self.device)
        cb = None
        for _ in range(self.niter):
            a, cb = self.alternate(x_dev, a, cb, ksub)
        self.a = np.ascontiguousarray(a.astype(np.float32))
        self.is_trained = True

    def alternate(self, x_dev: torch.Tensor, a: np.ndarray, cb, ksub: int):
        """One step of the alternation from rotation ``a`` (float64 [d_out,
        d_in]) and codebooks ``cb`` (None on the first): returns the next
        (a, cb)."""
        from .pq import decode_pq, encode_pq, train_pq
        a_t = torch.from_numpy(a.T.astype(np.float32)).to(x_dev.device)
        xr = torch.matmul(x_dev, a_t)
        cb = train_pq(xr.cpu().numpy(), self.m, ksub=ksub,
                      iters=self.pq_iters, seed=self.seed, init_cb=cb,
                      max_points=self.max_points, device=x_dev.device)
        cb_dev = torch.from_numpy(cb).to(x_dev.device)
        xh = decode_pq(encode_pq(xr, cb_dev), cb_dev)          # [n, d_out]
        g = _chunked_xty(x_dev, xh, min(len(x_dev), 32768))
        u, _, vt = np.linalg.svd(g, full_matrices=False)
        return (u @ vt).T, cb                                  # [d_out, d_in]

    def state(self) -> dict:
        return {"kind": "opq", "a": self.a, "b": self.b,
                "m": np.int64(self.m), "ksub": np.int64(self.ksub),
                "niter": np.int64(self.niter),
                "pq_iters": np.int64(self.pq_iters),
                "max_points": np.int64(self.max_points),
                "seed": np.int64(self.seed)}

    @classmethod
    def _from_state(cls, st: dict, device=None):
        a = np.asarray(st["a"])
        t = cls(a.shape[1], int(st["m"]), a.shape[0],
                ksub=int(st["ksub"]), niter=int(st["niter"]),
                pq_iters=int(st["pq_iters"]),
                max_points=int(st["max_points"]), seed=int(st["seed"]),
                device=device)
        t.a, t.b = a, np.asarray(st["b"])
        t.is_trained = True
        return t
