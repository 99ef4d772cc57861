"""Plain GCN training: the yardstick of ``gcn_arxiv.train``.

Three layers ``H' = A_hat (H W) + b`` with ReLU and inverted dropout
between them (Kipf and Welling, as OGB's ``examples/nodeproppred/arxiv/
gnn.py`` trains it, without its BatchNorm), the mean cross-entropy over
the training rows, and Adam (Kingma and Ba, with PyTorch's placement of
eps) written out. Plain PyTorch: no module of the program, nothing the
program made. ``A_hat = D^-1/2 (A + I) D^-1/2`` is worked out here from
the raw edge list; the SpMM is an ``index_add_`` over the edges; the
dropout masks are drawn as the program draws them, ``torch.rand`` of
each hidden layer's shape from a ``torch.Generator`` seeded alike, on
the same device, in the same order.

The reference runs in float64. Run in float32 with TF32 on, it is the
control: the precision below what the configuration states.
"""
from __future__ import annotations

import torch


def gcn_adjacency(src, dst, n: int, dtype=torch.float64):
    """``(rows, cols, vals)`` of A_hat for the undirected graph of the
    edges ``src -> dst`` (duplicates once, a self-loop on every node)."""
    ar = torch.arange(n, device=src.device)
    rows = torch.cat([dst, src, ar])
    cols = torch.cat([src, dst, ar])
    key = torch.unique(rows * n + cols)
    rows, cols = key // n, key % n
    deg = torch.bincount(rows, minlength=n).to(dtype)
    dinv = deg.rsqrt()
    return rows, cols, dinv[rows] * dinv[cols]


class _SpMM(torch.autograd.Function):
    """``A @ h`` over the edges (rows, cols, vals); its gradient is
    ``A^T @ g``."""

    @staticmethod
    def forward(ctx, h, rows, cols, vals):
        ctx.save_for_backward(rows, cols, vals)
        out = torch.zeros(h.shape, dtype=h.dtype, device=h.device)
        return out.index_add_(0, rows, vals[:, None] * h[cols])

    @staticmethod
    def backward(ctx, g):
        rows, cols, vals = ctx.saved_tensors
        out = torch.zeros(g.shape, dtype=g.dtype, device=g.device)
        return out.index_add_(0, cols, vals[:, None] * g[rows]), None, None, None


def forward(adj, h, params, p: float, generator=None):
    """Logits; dropout after each hidden layer when ``generator`` is
    given (training)."""
    rows, cols, vals = adj
    last = len(params) - 1
    for i, (w, b) in enumerate(params):
        h = _SpMM.apply(h @ w, rows, cols, vals) + b
        if i < last:
            h = torch.relu(h)
            if generator is not None:
                keep = torch.rand(h.shape, generator=generator,
                                  device=h.device) < 1.0 - p
                h = torch.where(keep, h / (1.0 - p),
                                torch.zeros((), dtype=h.dtype,
                                            device=h.device))
    return h


def loss_fn(logits, labels, train_rows):
    logp = torch.log_softmax(logits[train_rows], dim=1)
    return -logp.gather(1, labels[train_rows][:, None]).mean()


def train(data: dict, init: dict, cfg: dict, dropout_seed: int, steps: int,
          dtype=torch.float64, tf32: bool = False) -> dict:
    """``steps`` steps of full-graph training from the weights ``init``
    (``{"layers.{i}.w" / "b": tensor}``) on ``data`` (``src``, ``dst``,
    ``num_nodes``, ``features``, ``labels``, ``train_mask``).

    Returns ``{"losses": [each step's loss], "accs": [the accuracy on
    ``val_mask``'s rows after each step, without dropout], "grad_norms":
    {leaf: the norm of its first gradient}, "change_norms": {leaf: the
    norm of its change over the steps}}``."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        return _train(data, init, cfg, dropout_seed, steps, dtype)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def _train(data, init, cfg, dropout_seed, steps, dtype):
    device = data["features"].device
    adj = gcn_adjacency(data["src"], data["dst"], data["num_nodes"], dtype)
    x = data["features"].to(dtype)
    labels = data["labels"]
    train_rows = torch.nonzero(data["train_mask"] > 0)[:, 0]
    val_rows = torch.nonzero(data["val_mask"] > 0)[:, 0]
    names = list(init)
    params = [init[k].to(device, dtype).clone().requires_grad_(True)
              for k in names]
    start = [t.detach().clone() for t in params]
    pairs = list(zip(params[0::2], params[1::2]))
    lr, eps = float(cfg["lr"]), float(cfg["eps"])
    b1, b2 = (float(b) for b in cfg["betas"])
    m = [torch.zeros_like(t) for t in params]
    v = [torch.zeros_like(t) for t in params]
    gen = torch.Generator(device).manual_seed(dropout_seed)
    losses, accs, grad_norms = [], [], {}
    for t in range(1, steps + 1):
        loss = loss_fn(forward(adj, x, pairs, float(cfg["dropout"]), gen),
                       labels, train_rows)
        grads = torch.autograd.grad(loss, params)
        losses.append(loss.item())
        if t == 1:
            grad_norms = {k: float(gr.norm()) for k, gr in zip(names, grads)}
        with torch.no_grad():
            for p, g, mi, vi in zip(params, grads, m, v):
                mi.mul_(b1).add_(g, alpha=1 - b1)
                vi.mul_(b2).addcmul_(g, g, value=1 - b2)
                m_hat = mi / (1 - b1 ** t)
                v_hat = vi / (1 - b2 ** t)
                p.sub_(lr * m_hat / (v_hat.sqrt() + eps))
            logits = forward(adj, x, pairs, 0.0)[val_rows]
            accs.append(float((logits.argmax(dim=1) == labels[val_rows])
                              .to(dtype).mean()))
    change = {k: float((p.detach() - s).norm())
              for k, p, s in zip(names, params, start)}
    return dict(losses=losses, accs=accs, grad_norms=grad_norms,
                change_norms=change)
