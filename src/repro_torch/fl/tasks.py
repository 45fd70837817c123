"""Learning tasks of the Fig. 2 and Fig. 3 experiments (counterparts of
``repro.fl.tasks.SoftmaxRegressionTask`` and ``MLPTask``).

Every task is an ``nn.Module`` with one protocol:

  init_params(seed=None, device=...) -> flat f64 w0 (d,)
  device_grads(w32 (K, d), xs (N, n, F), ys (N, n)) -> clipped f32 (K, N, d)
  loss / accuracy(w32 (K, d), x, y) -> f32 (K,)

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


def _clip(g: torch.Tensor, g_max: float) -> torch.Tensor:
    """Scale each row of g (..., d) to norm at most g_max (``_clip_to``)."""
    nrm = torch.linalg.vector_norm(g, dim=-1, keepdim=True)
    return g * torch.clamp(g_max / torch.clamp(nrm, min=1e-12), max=1.0)


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
