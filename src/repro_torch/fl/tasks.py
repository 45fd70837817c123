"""Learning task of the Fig. 2 experiments (counterpart of
``repro.fl.tasks.SoftmaxRegressionTask``).

l2-regularized softmax regression, phi(w,(x,l)) = mu/2 ||w||^2 -
log softmax_l(x^T W): mu-strongly convex, L = 2 + mu smooth (paper
Sec. V-A). The parameters are a (C, F+1) weight — class rows, bias last —
whose row-major flattening is the reference's flat w in R^d,
d = C*(F+1). The functional methods take a flat f32 ``w32`` so the engine
can batch Monte-Carlo trials as a leading dimension; the module's own
``weight`` buffer holds one model for ``forward`` and for carrying state
to and from the reference (``repro_torch.interop``).

Assumption 1 (||g|| <= G_max) is enforced by clipping each device
gradient to norm G_max, in f32, as the reference's ``_clip_to``.
"""
from __future__ import annotations

import torch
from torch import nn


class SoftmaxRegressionTask(nn.Module):
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

    def init_params(self, device="cpu") -> torch.Tensor:
        """Flat f64 initial model w0 = 0 (d,)."""
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
        nrm = torch.linalg.vector_norm(g, dim=-1, keepdim=True)
        g = g * torch.clamp(self.g_max / torch.clamp(nrm, min=1e-12), max=1.0)
        return g.reshape(w32.shape[:-1] + g.shape[1:])
