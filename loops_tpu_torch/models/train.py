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


def _tensor(a, device, dtype=None):
    if not isinstance(a, torch.Tensor):
        a = torch.from_numpy(np.asarray(a))
    return a.to(device, dtype) if dtype is not None else a.to(device)


def make_train_step(model, optimizer, features, labels, train_mask,
                    weight_decay: float = 0.0,
                    generator: torch.Generator | None = None):
    """Full-graph training step: ``step() -> loss`` (a detached 0-d
    tensor), updating ``model``'s parameters through ``optimizer``.

    Features are prepared once (``model.prepare_features``: GCN's
    ``precompute_first`` hoists ``A @ X`` out of every step). A model with
    ``loss_rows`` propagates its last layer only to those rows, which
    must be the train mask's. Dropout draws from ``generator`` (one on
    the model's device; by default seeded with 0).
    """
    device = model.device
    prep = getattr(model, "prepare_features", None)
    features = (prep(features) if prep is not None
                else _tensor(features, device, torch.float32))
    labels = _tensor(labels, device).long()
    train_mask = _tensor(train_mask, device, torch.float32)
    if generator is None:
        generator = torch.Generator(device).manual_seed(0)

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
        if use_masked:
            logits_m = model(features, masked_output=True,
                             generator=generator)
            loss = cross_entropy(logits_m, labels_m)
        else:
            logits = model(features, generator=generator)
            loss = cross_entropy(logits, labels, train_mask)
        if weight_decay:
            l2 = sum((layer.w ** 2).sum() for layer in model.layers)
            loss = loss + weight_decay * l2
        loss.backward()
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
            logits = model(model.prepare_features(features))
            return float(accuracy(logits, _tensor(labels, device).long(),
                                  _tensor(mask, device, torch.float32)))
    finally:
        model.train(was_training)
