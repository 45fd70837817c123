"""Learning tasks of the Fig. 2 and Fig. 3 experiments (counterparts of
``repro.fl.tasks.SoftmaxRegressionTask``, ``MLPTask`` and
``SyntheticHighDimTask``).

Every task is an ``nn.Module`` with one protocol:

  init_params(seed=None, device=...) -> flat f64 w0 (d,)
  device_grads(w32 (K, d), xs (N, n, F), ys (N, n)) -> clipped f32 (K, N, d)
  device_grads_at(w32, xs, ys, idx (K, N, B)) -> the same on mini-batches
  loss / accuracy(w32 (K, d), x, y) -> f32 (K,)

``device_grads_at`` gathers each trial's own (K, N, B, F) batches (the K
models no longer share one product with the data), and
``device_grads_at_weighted`` takes per-row weights (N, B) in place of
the mean: the engine's mixed full/mini-batch regime.

The functional methods take a flat f32 ``w32`` so the engine can batch
Monte-Carlo trials as a leading dimension. The module's buffers hold one
model for ``forward`` and for carrying state to and from the reference
(``repro_torch.interop``); their row-major flattenings, concatenated in
registration order, are the reference's flat w in R^d.

Assumption 1 (||g|| <= G_max) is enforced by clipping each device
gradient to norm G_max, in f32, as the reference's ``_clip_to``.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..core import rngstream


def _clip(g: torch.Tensor, g_max: float) -> torch.Tensor:
    """Scale each row of g (..., d) to norm at most g_max (``_clip_to``)."""
    nrm = torch.linalg.vector_norm(g, dim=-1, keepdim=True)
    return g * torch.clamp(g_max / torch.clamp(nrm, min=1e-12), max=1.0)


def _gather(w32, xs, ys, idx, dim):
    """The (K, N, B, F) / (K, N, B) batches of K models: idx (N, B) shared
    by the models or (K, N, B) one a model."""
    K = w32.reshape(-1, dim).shape[0]
    idx = idx.expand((K,) + tuple(idx.shape[-2:]))
    rows = torch.arange(xs.shape[0], device=xs.device)[:, None]
    return xs[rows, idx], ys[rows, idx]


def _residual(logits, yb, wt):
    """d(loss)/d(logits) of the mean nll over the batch axis (-2), or of
    the weighted sum -sum(wt * logp[y]) with wt (N, B)."""
    r = torch.softmax(logits, dim=-1)
    r = r - nn.functional.one_hot(yb, logits.shape[-1]).to(r.dtype)
    return r / logits.shape[-2] if wt is None else r * wt[..., None]


class SoftmaxRegressionTask(nn.Module):
    """l2-regularized softmax regression, phi(w,(x,l)) = mu/2 ||w||^2 -
    log softmax_l(x^T W): mu-strongly convex, L = 2 + mu smooth (paper
    Sec. V-A). One (C, F+1) weight — class rows, bias last — so
    d = C*(F+1)."""

    def __init__(self, n_features: int, n_classes: int = 10,
                 mu: float = 0.01, g_max: float = 20.0):
        super().__init__()
        self.n_features = n_features
        self.n_classes = n_classes
        self.mu = mu
        self.smooth_l = 2.0 + mu
        self.g_max = g_max
        self.dim = n_classes * (n_features + 1)
        self.register_buffer(
            "weight", torch.zeros(n_classes, n_features + 1,
                                  dtype=torch.float64))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Logits (n, C) of the module's own weight."""
        w = self.weight.to(x.dtype)
        return x @ w[:, :-1].T + w[:, -1]

    def init_params(self, seed=None, device="cpu") -> torch.Tensor:
        """Flat f64 initial model w0 = 0 (d,); the seed is not used."""
        return torch.zeros(self.dim, dtype=torch.float64, device=device)

    def _logits(self, w32: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """w32 (K, d), x (n, F) -> logits (K, n, C), as one (n, F) @ (F, K*C)
        product so x is never copied per model."""
        W = w32.reshape(-1, self.n_features + 1)             # (K*C, F+1)
        logits = x @ W[:, :-1].T + W[:, -1]                  # (n, K*C)
        return logits.reshape(x.shape[0], -1, self.n_classes).transpose(0, 1)

    def loss(self, w32: torch.Tensor, x: torch.Tensor,
             y: torch.Tensor) -> torch.Tensor:
        """Global objective F(w) in f32; w32 (d,) or (K, d) -> () or (K,)."""
        logp = torch.log_softmax(self._logits(w32, x), dim=-1)
        nll = -logp.gather(-1, y.expand(logp.shape[0], -1)[..., None]
                           ).squeeze(-1).mean(-1)
        out = nll + 0.5 * self.mu * (w32.reshape(-1, self.dim) ** 2).sum(-1)
        return out.reshape(w32.shape[:-1])

    def accuracy(self, w32: torch.Tensor, x: torch.Tensor,
                 y: torch.Tensor) -> torch.Tensor:
        """Test accuracy in f32; w32 (d,) or (K, d) -> () or (K,)."""
        hit = self._logits(w32, x).argmax(-1) == y
        return hit.to(torch.float32).mean(-1).reshape(w32.shape[:-1])

    def device_grads(self, w32: torch.Tensor, xs: torch.Tensor,
                     ys: torch.Tensor) -> torch.Tensor:
        """Clipped full-batch f32 gradients of every device.

        w32: (d,) or (K, d) (K trials); xs: (N, n, F); ys: (N, n) int64.
        Returns (N, d) or (K, N, d).
        """
        C, F = self.n_classes, self.n_features
        N, n = ys.shape
        W = w32.reshape(-1, C, F + 1)                          # (K, C, F+1)
        K = W.shape[0]
        # the K models share one (N, n, F) @ (F, K*C) product
        logits = xs @ W[..., :-1].reshape(K * C, F).T + W[..., -1].reshape(-1)
        logits = logits.reshape(N, n, K, C)
        # d(mean nll)/d logits = (softmax - onehot) / n
        r = torch.softmax(logits, dim=-1)
        r = r - nn.functional.one_hot(ys, C)[:, :, None, :].to(r.dtype)
        r = r / n
        g_w = r.reshape(N, n, K * C).transpose(1, 2) @ xs      # (N, K*C, F)
        g = torch.cat([g_w.reshape(N, K, C, F), r.sum(1)[..., None]], dim=-1)
        g = (g + self.mu * W).transpose(0, 1).reshape(K, N, self.dim)
        g = _clip(g, self.g_max)
        return g.reshape(w32.shape[:-1] + g.shape[1:])

    def device_grads_at(self, w32: torch.Tensor, xs: torch.Tensor,
                        ys: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        """Clipped f32 gradients of every device on its mini-batch: rows
        ``idx`` (N, B) or (K, N, B) of the stacked (N, n, F) data. Returns
        (N, d) for w32 (d,), else (K, N, d)."""
        return self._grads_at(w32, xs, ys, idx, None)

    def device_grads_at_weighted(self, w32, xs, ys, idx,
                                 wt: torch.Tensor) -> torch.Tensor:
        """:meth:`device_grads_at` of the weighted-sum loss
        -sum(wt * logp[y]) + mu/2 ||w||^2, wt (N, B) f32."""
        return self._grads_at(w32, xs, ys, idx, wt)

    def _grads_at(self, w32, xs, ys, idx, wt):
        C, F = self.n_classes, self.n_features
        W = w32.reshape(-1, C, F + 1)                          # (K, C, F+1)
        K = W.shape[0]
        xb, yb = _gather(w32, xs, ys, idx, self.dim)        # (K, N, B, F)
        N, B = yb.shape[1:]
        logits = (xb.reshape(K, N * B, F) @ W[..., :-1].transpose(1, 2)
                  + W[:, None, :, -1]).reshape(K, N, B, C)
        r = _residual(logits, yb, wt)
        g = torch.cat([r.transpose(-1, -2) @ xb, r.sum(2)[..., None]],
                      dim=-1)                               # (K, N, C, F+1)
        g = _clip((g + self.mu * W[:, None]).reshape(K, N, self.dim),
                  self.g_max)
        return g.reshape(w32.shape[:-1] + g.shape[1:])


class MLPTask(nn.Module):
    """One-hidden-layer ReLU MLP with l2 regularization: the smooth
    non-convex task of Sec. V-B (Fig. 3), F -> H -> C.

    Buffers W1 (F, H), b1 (H,), W2 (H, C), b2 (C,) in f64; their flattening
    in that order is the reference's ``unpack`` layout, d = F*H + H + H*C +
    C. ``init_params`` draws He-normal W1 and W2 (zero biases) from
    ``np.random.default_rng(seed)`` exactly as the reference, so both start
    from the same bits.
    """

    def __init__(self, n_features: int, hidden: int = 64, n_classes: int = 10,
                 mu_nc: float = 0.01, g_max: float = 49.0, seed: int = 0):
        super().__init__()
        self.n_features, self.hidden, self.n_classes = (n_features, hidden,
                                                        n_classes)
        self.mu_nc, self.g_max = mu_nc, g_max
        self.dim = (n_features * hidden + hidden
                    + hidden * n_classes + n_classes)
        self._seed = seed
        f64 = torch.float64
        self.register_buffer("W1", torch.zeros(n_features, hidden, dtype=f64))
        self.register_buffer("b1", torch.zeros(hidden, dtype=f64))
        self.register_buffer("W2", torch.zeros(hidden, n_classes, dtype=f64))
        self.register_buffer("b2", torch.zeros(n_classes, dtype=f64))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Logits (n, C) of the module's own weights."""
        h = torch.relu(x @ self.W1.to(x.dtype) + self.b1.to(x.dtype))
        return h @ self.W2.to(x.dtype) + self.b2.to(x.dtype)

    def init_params(self, seed=None, device="cpu") -> torch.Tensor:
        """Flat f64 w0 (d,): He-normal weights, zero biases, the
        reference's draws from ``default_rng(seed or the task's seed)``."""
        F, H, C = self.n_features, self.hidden, self.n_classes
        rng = np.random.default_rng(self._seed if seed is None else seed)
        w = np.zeros(self.dim)
        w[:F * H] = rng.normal(scale=np.sqrt(2.0 / F), size=F * H)
        w[F * H + H:F * H + H + H * C] = rng.normal(scale=np.sqrt(2.0 / H),
                                                    size=H * C)
        return torch.as_tensor(w, device=device)

    def _unpack(self, w32: torch.Tensor):
        """(K, d) -> W1 (K, F, H), b1 (K, H), W2 (K, H, C), b2 (K, C)."""
        F, H, C = self.n_features, self.hidden, self.n_classes
        W1, b1, W2, b2 = torch.split(w32, [F * H, H, H * C, C], dim=-1)
        K = w32.shape[0]
        return (W1.reshape(K, F, H), b1, W2.reshape(K, H, C), b2)

    def _logits(self, w32: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """w32 (K, d), x (n, F) -> logits (K, n, C); the K models share one
        (n, F) @ (F, K*H) product."""
        F, H = self.n_features, self.hidden
        W1, b1, W2, b2 = self._unpack(w32)
        K = w32.shape[0]
        pre = (x @ W1.transpose(0, 1).reshape(F, K * H)).reshape(
            x.shape[0], K, H).transpose(0, 1) + b1[:, None]
        return torch.relu(pre) @ W2 + b2[:, None]

    def loss(self, w32: torch.Tensor, x: torch.Tensor,
             y: torch.Tensor) -> torch.Tensor:
        """Global objective F(w) in f32; w32 (d,) or (K, d) -> () or (K,)."""
        w2 = w32.reshape(-1, self.dim)
        logp = torch.log_softmax(self._logits(w2, x), dim=-1)
        nll = -logp.gather(-1, y.expand(logp.shape[0], -1)[..., None]
                           ).squeeze(-1).mean(-1)
        out = nll + 0.5 * self.mu_nc * (w2 ** 2).sum(-1)
        return out.reshape(w32.shape[:-1])

    def accuracy(self, w32: torch.Tensor, x: torch.Tensor,
                 y: torch.Tensor) -> torch.Tensor:
        """Test accuracy in f32; w32 (d,) or (K, d) -> () or (K,)."""
        hit = self._logits(w32.reshape(-1, self.dim), x).argmax(-1) == y
        return hit.to(torch.float32).mean(-1).reshape(w32.shape[:-1])

    def device_grads(self, w32: torch.Tensor, xs: torch.Tensor,
                     ys: torch.Tensor) -> torch.Tensor:
        """Clipped full-batch f32 gradients of every device, by explicit
        backprop in batched products.

        w32: (d,) or (K, d) (K trials); xs: (N, n, F); ys: (N, n) int64.
        Returns (N, d) or (K, N, d). The ReLU passes gradient where the
        pre-activation is > 0 (``jax.nn.relu``'s derivative is 0 at 0);
        mu*w covers the whole flat w, biases included.
        """
        F, H, C = self.n_features, self.hidden, self.n_classes
        N, n = ys.shape
        w2 = w32.reshape(-1, self.dim)
        K = w2.shape[0]
        W1, b1, W2, b2 = self._unpack(w2)
        # the K models share one (N*n, F) @ (F, K*H) product
        pre = (xs.reshape(N * n, F) @ W1.transpose(0, 1).reshape(F, K * H)
               ).reshape(N, n, K, H) + b1
        hdn = torch.relu(pre)
        logits = torch.einsum("inkh,khc->inkc", hdn, W2) + b2
        # d(mean nll)/d logits = (softmax - onehot) / n
        r = torch.softmax(logits, dim=-1)
        r = (r - nn.functional.one_hot(ys, C)[:, :, None, :].to(r.dtype)) / n
        g_W2 = torch.einsum("inkh,inkc->kihc", hdn, r)           # (K,N,H,C)
        g_b2 = r.sum(1).transpose(0, 1)                          # (K,N,C)
        dpre = torch.einsum("inkc,khc->inkh", r, W2) * (pre > 0).to(r.dtype)
        g_W1 = (xs.transpose(1, 2) @ dpre.reshape(N, n, K * H)
                ).reshape(N, F, K, H).permute(2, 0, 1, 3)        # (K,N,F,H)
        g_b1 = dpre.sum(1).transpose(0, 1)                       # (K,N,H)
        g = torch.cat([g_W1.reshape(K, N, F * H), g_b1,
                       g_W2.reshape(K, N, H * C), g_b2], dim=-1)
        g = _clip(g + self.mu_nc * w2[:, None], self.g_max)
        return g.reshape(w32.shape[:-1] + g.shape[1:])

    def device_grads_at(self, w32: torch.Tensor, xs: torch.Tensor,
                        ys: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        """Clipped f32 gradients of every device on its mini-batch: rows
        ``idx`` (N, B) or (K, N, B) of the stacked (N, n, F) data. Returns
        (N, d) for w32 (d,), else (K, N, d)."""
        return self._grads_at(w32, xs, ys, idx, None)

    def device_grads_at_weighted(self, w32, xs, ys, idx,
                                 wt: torch.Tensor) -> torch.Tensor:
        """:meth:`device_grads_at` of the weighted-sum loss
        -sum(wt * logp[y]) + mu_nc/2 ||w||^2, wt (N, B) f32."""
        return self._grads_at(w32, xs, ys, idx, wt)

    def _grads_at(self, w32, xs, ys, idx, wt):
        F, H, C = self.n_features, self.hidden, self.n_classes
        w2 = w32.reshape(-1, self.dim)
        K = w2.shape[0]
        W1, b1, W2, b2 = self._unpack(w2)
        xb, yb = _gather(w32, xs, ys, idx, self.dim)        # (K, N, B, F)
        N, B = yb.shape[1:]
        pre = (xb.reshape(K, N * B, F) @ W1 + b1[:, None]
               ).reshape(K, N, B, H)
        hdn = torch.relu(pre)
        logits = (hdn.reshape(K, N * B, H) @ W2 + b2[:, None]
                  ).reshape(K, N, B, C)
        r = _residual(logits, yb, wt)
        dpre = (r.reshape(K, N * B, C) @ W2.transpose(1, 2)).reshape(
            K, N, B, H) * (pre > 0).to(r.dtype)
        g = torch.cat([(xb.transpose(-1, -2) @ dpre).reshape(K, N, F * H),
                       dpre.sum(2),
                       (hdn.transpose(-1, -2) @ r).reshape(K, N, H * C),
                       r.sum(2)], dim=-1)
        g = _clip(g + self.mu_nc * w2[:, None], self.g_max)
        return g.reshape(w32.shape[:-1] + g.shape[1:])


class SyntheticHighDimTask(nn.Module):
    """Payload-scale synthetic task f_m(w) = 1/2 ||w - c_m||^2 (the
    reference's, for d up to 10^7): gradients ``clip(w - c_m)``, no
    dataset. A device's "data" is its id: ``device_data`` gives (N, 1, 1)
    xs holding the ids and dummy (N, 1) ys. Each center c_m is the f32
    threefry normal of ``fold_in(PRNGKey(seed), m)``, drawn when needed
    (the port's ``rngstream.normal``: within 3 ulp of JAX's)."""

    def __init__(self, dim: int, g_max: float = 1e9, seed: int = 0):
        super().__init__()
        self.dim = dim
        self.g_max = g_max
        self._seed = seed
        self._base = rngstream.prng_key(seed)

    def init_params(self, seed=None, device="cpu") -> torch.Tensor:
        """Flat f64 w0 = 0 (d,)."""
        return torch.zeros(self.dim, dtype=torch.float64, device=device)

    def device_data(self, n_devices: int):
        """(xs, ys) stand-in dataset: xs[m] = [[m]] (the id), ys dummy."""
        xs = np.arange(n_devices, dtype=np.float32).reshape(n_devices, 1, 1)
        ys = np.zeros((n_devices, 1), dtype=np.int32)
        return xs, ys

    def centers(self, ids: torch.Tensor) -> torch.Tensor:
        """(len(ids), d) f32 centers of the device ids."""
        ids = ids.to(torch.int64)
        k0, k1 = rngstream.threefry2x32(self._base[0], self._base[1], 0,
                                        ids & 0xFFFFFFFF)
        return rngstream.normal((k0[:, None], k1[:, None]), (self.dim,),
                                device=ids.device)

    def device_grads(self, w32: torch.Tensor, xs: torch.Tensor,
                     ys: torch.Tensor) -> torch.Tensor:
        """clip(w - c_m) of every device: (N, d) or (K, N, d)."""
        g = _clip(w32.reshape(-1, 1, self.dim)
                  - self.centers(xs[:, 0, 0])[None], self.g_max)
        return g.reshape(w32.shape[:-1] + g.shape[1:])

    def device_grads_at(self, w32, xs, ys, idx) -> torch.Tensor:
        """A batch of a device's one row is that row: the full gradient."""
        return self.device_grads(w32, xs, ys)

    def loss(self, w32: torch.Tensor, x: torch.Tensor,
             y: torch.Tensor) -> torch.Tensor:
        """1/2 ||w - c||^2 of the center of x's first id, in f32."""
        c = self.centers(x.reshape(-1)[:1])[0]
        return 0.5 * ((w32 - c) ** 2).sum(-1)

    def accuracy(self, w32: torch.Tensor, x, y) -> torch.Tensor:
        return torch.zeros(w32.shape[:-1], dtype=torch.float32,
                           device=w32.device)
