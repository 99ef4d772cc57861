"""Training utilities: node-classification loss, step, epochs, eval.

The port of ``loops_tpu/models/train.py``. The model and optimizer hold
their state (``nn.Module`` parameters, a ``torch.optim`` optimizer such as
``torch.optim.Adam``, whose update is optax's ``adam``: bias-corrected
moments, eps outside the square root); a step is a plain function that
updates them in place and returns the loss. PyTorch runs eagerly, so
there is nothing to batch per dispatch: ``make_train_epochs`` is a loop.
"""
from __future__ import annotations

import numpy as np
import torch

from loops_tpu_torch.utils.trace import annotate


def cross_entropy(logits, labels, mask=None):
    logp = torch.log_softmax(logits, dim=1)
    nll = -torch.take_along_dim(logp, labels[:, None].long(), dim=1)[:, 0]
    if mask is not None:
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()


def accuracy(logits, labels, mask=None):
    hit = (logits.argmax(dim=1) == labels).to(torch.float32)
    if mask is not None:
        return (hit * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return hit.mean()


def as_tensor(a, device, dtype=None):
    """``a`` (a tensor or an array) on ``device``, in ``dtype`` where
    given."""
    if not isinstance(a, torch.Tensor):
        a = torch.from_numpy(np.asarray(a))
    return a.to(device, dtype) if dtype is not None else a.to(device)


def _prepared(model, features) -> torch.Tensor:
    """The features the model's forward takes: ``prepare_features``'s
    where the model has one, else float32 on the model's device."""
    prep = getattr(model, "prepare_features", None)
    if prep is not None:
        return prep(features)
    return as_tensor(features, model.device, torch.float32)


def make_train_step(model, optimizer, features, labels, train_mask,
                    weight_decay: float = 0.0,
                    generator: torch.Generator | None = None):
    """Full-graph training step: ``step() -> loss`` (a detached 0-d
    tensor), updating ``model``'s parameters through ``optimizer``.

    Features are prepared once where the model has
    ``prepare_features`` (GCN's ``precompute_first`` hoists ``A @ X`` out
    of every step). A model with ``loss_rows`` propagates its last layer
    only to those rows, which must be the train mask's. A model with
    ``dropout`` draws it from ``generator`` (one on the model's device; by
    default seeded with 0); a model without (GraphSAGE, GAT, GATv2) is
    called without one. ``weight_decay`` adds the squared sum of each
    layer's ``w``, and raises ``ValueError`` for a model whose layers have
    none.
    """
    device = model.device
    if weight_decay and not all(hasattr(layer, "w")
                                for layer in model.layers):
        raise ValueError(f"weight_decay reads each layer's w, and "
                         f"{type(model).__name__}'s layers have none")
    features = _prepared(model, features)
    labels = as_tensor(labels, device).long()
    train_mask = as_tensor(train_mask, device, torch.float32)
    kw = {}
    if hasattr(model, "dropout"):
        kw["generator"] = (torch.Generator(device).manual_seed(0)
                           if generator is None else generator)

    # the masked cross-entropy over full logits equals the plain mean over
    # the compacted rows exactly
    loss_rows = getattr(model, "loss_rows", None)
    use_masked = loss_rows is not None
    if use_masked:
        mask_np = train_mask.cpu().numpy() > 0
        if not np.array_equal(np.nonzero(mask_np)[0], np.asarray(loss_rows)):
            raise ValueError("model.loss_rows must be the train_mask's rows")
        labels_m = labels[torch.from_numpy(np.asarray(loss_rows)).to(device)]

    def step():
        model.train()
        optimizer.zero_grad(set_to_none=True)
        with annotate("train.forward"):
            if use_masked:
                logits_m = model(features, masked_output=True, **kw)
                loss = cross_entropy(logits_m, labels_m)
            else:
                logits = model(features, **kw)
                loss = cross_entropy(logits, labels, train_mask)
            if weight_decay:
                l2 = sum((layer.w ** 2).sum() for layer in model.layers)
                loss = loss + weight_decay * l2
        with annotate("train.backward"):
            loss.backward()
        with annotate("train.optimizer"):
            optimizer.step()
        return loss.detach()

    return step


def make_train_epochs(model, optimizer, features, labels, train_mask,
                      steps_per_call: int = 10, weight_decay: float = 0.0,
                      generator: torch.Generator | None = None):
    """``epochs() -> loss``: ``steps_per_call`` training steps in a row,
    returning the last step's loss."""
    step = make_train_step(model, optimizer, features, labels, train_mask,
                           weight_decay, generator)

    def epochs():
        loss = None
        for _ in range(steps_per_call):
            loss = step()
        return loss

    return epochs


def evaluate(model, features, labels, mask) -> float:
    """Accuracy of the full-graph forward (every layer's full
    propagation) at the rows of ``mask``, in ``eval()`` mode without
    gradients: the inference path. The model's mode is restored."""
    device = model.device
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad():
            with annotate("eval.forward"):
                logits = model(_prepared(model, features))
                acc = accuracy(logits, as_tensor(labels, device).long(),
                               as_tensor(mask, device, torch.float32))
            with annotate("eval.read"):
                return float(acc)
    finally:
        model.train(was_training)
