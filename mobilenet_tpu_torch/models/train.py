"""Training step for MobileNet-V1, -V2 and -V3 on the folded form: the port
of the JAX package's `models/train.py`.

An SGD step over the folded parameterization (conv weight + per-channel
bias; training these is training conv + frozen BN) with torch autograd. The
forward is always the plain route (`dw_backend="plain"`): the kernels are
inference-only (they have no backward), as the Pallas kernels are in the
JAX package. Training runs in float32 whatever the config's compute dtype.
It never goes through a pipeline: their entries run under
`torch.inference_mode()`, which records no graph.

The whole step (forward, backward and the update) runs under
`ops.conv.no_tf32`: the plain ops guard only their own forward call, and
autograd runs the backward after those guards have exited, where cuDNN's
TF32 default (the stem's gradients) and a float32 matmul precision of
"high" (the pointwise and fc gradients) would apply. The JAX package
computes every float32 dot at Precision.HIGHEST.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

import torch
import torch.nn.functional as F

from ..ops.conv import no_tf32
from . import mobilenet_v1, mobilenet_v2, mobilenet_v3


def model_forward(params: Dict[str, Any], images: torch.Tensor, config) -> torch.Tensor:
    """Differentiable float32 forward of any family's config (ModelConfig,
    V2Config or V3Config), always on the plain route."""
    x = images.float()
    if isinstance(config, mobilenet_v2.V2Config):
        return mobilenet_v2.forward_v2(params, x, config, dw_backend="plain")
    if isinstance(config, mobilenet_v3.V3Config):
        return mobilenet_v3.forward_v3(params, x, config, dw_backend="plain")
    return mobilenet_v1.forward(params, x, config, dw_backend="plain")


def tree_leaves(tree) -> List[torch.Tensor]:
    """The tensors of a nested dict/list tree, in key-insertion order."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tree_leaves(v)]
    return [tree]


def tree_map(fn: Callable, tree):
    """`tree` with every tensor replaced by fn(tensor)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def _nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean negative log-likelihood of `labels` under float32 log-softmax."""
    logp = F.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, labels.long()[:, None])[:, 0].mean()


def cross_entropy_loss(params: Dict[str, Any], images: torch.Tensor,
                       labels: torch.Tensor, config) -> torch.Tensor:
    return _nll(model_forward(params, images, config), labels)


def sgd_train_step(params: Dict[str, Any], images: torch.Tensor, labels: torch.Tensor,
                   config, lr: float = 1e-2) -> Tuple[Dict[str, Any], torch.Tensor]:
    """One plain SGD step: returns (updated params, loss). `params` is left
    as it was."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    it = iter(leaves)
    live = tree_map(lambda _: next(it), params)
    with no_tf32(images):
        loss = cross_entropy_loss(live, images, labels, config)
        grads = torch.autograd.grad(loss, leaves)
        it = iter([(p - lr * g).detach() for p, g in zip(leaves, grads)])
    return tree_map(lambda _: next(it), params), loss.detach()


def sgd_trainer(forward_fn: Callable, params: Dict[str, Any], lr: float, momentum: float,
                weight_decay: float):
    """step(images, labels) -> (loss, top1) of `forward_fn(params, images)`
    -> logits under torch.optim.SGD; the leaves of `params` are trained in
    place.

    torch.optim.SGD(lr, momentum, weight_decay=wd) (dampening 0, no
    Nesterov) is the JAX package's optax.chain(add_decayed_weights(wd),
    sgd(lr, momentum)) step for step: both add wd * p to the gradient before
    the momentum, both start the momentum buffer at that first decayed
    gradient (optax: 0 * momentum + u), then buf = momentum * buf + u and p
    = p - lr * buf. tests/test_torch_train.py holds two steps of each equal
    within float32 tolerance."""
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    opt = torch.optim.SGD(leaves, lr=lr, momentum=momentum, weight_decay=weight_decay)

    def step(images: torch.Tensor, labels: torch.Tensor):
        with no_tf32(images):
            opt.zero_grad(set_to_none=True)
            logits = forward_fn(params, images)
            loss = _nll(logits, labels)
            loss.backward()
            opt.step()
        top1 = (logits.detach().argmax(-1) == labels).float().mean()
        return loss.detach(), top1

    return step


def make_trainer(config, params: Dict[str, Any], lr: float = 1e-2,
                 momentum: float = 0.9, weight_decay: float = 4e-5):
    """SGD-momentum trainer (the MobileNet paper's weight decay 4e-5) for
    any family's config, the counterpart of the JAX package's
    `make_optax_trainer`. `params`: a float32 device tree (checkpoints.
    to_device), trained in place. Returns step(images, labels) -> (loss,
    top1), each a 0-dim tensor."""
    return sgd_trainer(lambda p, x: model_forward(p, x, config), params, lr, momentum,
                       weight_decay)
