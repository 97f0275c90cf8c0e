"""The train step and its state (counterpart of
``yolo_tpu/train/trainer.py``).

``grad_fn`` runs the train forward (``Darknet.forward_train``, BN on batch
statistics), the loss in the NHWC head layout scaled by ``loss_scale``,
and ``backward``, which adds into the parameters' ``.grad`` (gradient
accumulation, as JAX's ``grad_accum``); it adds the BN-gamma L1
subgradient ``s*sign(gamma)`` of the sparse layers and writes the new BN
running statistics into the model's buffers. ``update_fn`` runs the
optimizer on the accumulated gradients, then the EMA, then clears the
gradients. Neither reads a value back to the host.

Not ported (see ROADMAP.md): the KD loss term, QAT's quantized apply and
the remat policies; they raise ``NotImplementedError``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..compress.quant import unported
from ..ir import NetworkIR
from ..models.network import Darknet
from .ema import EMAState, ema_init, ema_update
from .loss import LossHyp, compute_loss
from .optim import PerGroupScalars, make_optimizer


@dataclass
class TrainState:
    """The trainable model (f32 master parameters, BN statistics in its
    buffers, gradients accumulated in ``.grad``), its optimizer, the EMA
    copy and the count of ``grad_fn`` calls since the last update."""
    model: Darknet
    optimizer: torch.optim.Optimizer
    ema: EMAState | None
    accum_count: int = 0

    @property
    def params(self) -> dict:
        """{layer: {field: Parameter}}, the JAX package's keys."""
        return {k: dict(m.named_parameters(recurse=False))
                for k, m in self.model.layer.items()
                if any(True for _ in m.parameters(recurse=False))}

    @property
    def bn_state(self) -> dict:
        """{layer: {'mean', 'var'}}: the BN running statistics (buffers)."""
        return {k: dict(m.named_buffers(recurse=False))
                for k, m in self.model.layer.items()
                if any(True for _ in m.buffers(recurse=False))}

    @property
    def opt_state(self) -> dict:
        return self.optimizer.state_tree()


def init_train_state(net: NetworkIR, params, bn_state, *,
                     optimizer: str = 'sgd', use_ema: bool = True,
                     compute_dtype: torch.dtype | None = torch.bfloat16,
                     maxabsscaler: bool = False, device='cuda',
                     base_lr: float | None = None) -> TrainState:
    """A ``TrainState`` on ``device`` that owns copies of ``params`` and
    ``bn_state`` (f32); ``compute_dtype`` is the dtype of the convs
    (``None``: f32). ``optimizer`` is 'sgd', 'adam' or 'adabound' (which
    needs ``base_lr``)."""
    model = Darknet(net, params, bn_state, maxabsscaler=maxabsscaler,
                    dtype=compute_dtype, trainable=True)
    model = model.to(torch.device(device), memory_format=torch.channels_last)
    st = TrainState(model=model, optimizer=None, ema=None)
    st.optimizer = make_optimizer(optimizer, st.params, base_lr=base_lr)
    if use_ema:
        st.ema = ema_init(st.params, st.bn_state)
    return st


def make_train_functions(net: NetworkIR, anchor_vecs, nc: int, hyp: LossHyp,
                         *, sparsity_s: float = 0.0,
                         sparse_gamma_layers: tuple[int, ...] = (),
                         kd_loss_fn=None, remat=False, quant_apply=None):
    """(grad_fn, update_fn) for a ``TrainState``.

    grad_fn(state, imgs, targets, valid, gr, loss_scale) -> (state, items)
        imgs an NHWC f32 batch on the model's device, targets (T, 6) and
        valid (T,) there too; ``gr`` and ``loss_scale`` host floats. Adds
        the gradients of ``loss * loss_scale`` into ``.grad`` and updates
        the BN running statistics; items (4,) = [lbox, lobj, lcls, total],
        detached, on the device.
    update_fn(state, scalars: PerGroupScalars) -> state
        the optimizer step on the accumulated gradients, the EMA update,
        gradients cleared.

    ``sparse_gamma_layers`` with ``sparsity_s`` > 0 add ``s*sign(gamma)``
    to those layers' BN-gamma gradients at every ``grad_fn`` call (sparse
    training before pruning)."""
    if kd_loss_fn is not None:
        raise unported('the KD loss term of the trainer')
    if quant_apply is not None:
        raise unported('QAT training (a quantized apply in the trainer)')
    if remat not in (False, None, 'none', ''):
        raise unported(f'remat={remat!r} (the remat policies)')
    anchors: dict = {}
    sparse_keys = tuple(str(i) for i in sparse_gamma_layers) \
        if sparsity_s > 0 else ()

    def grad_fn(state: TrainState, imgs, targets, valid, gr: float,
                loss_scale: float):
        model = state.model
        dev = imgs.device
        if dev not in anchors:
            anchors[dev] = [torch.as_tensor(a, dtype=torch.float32,
                                            device=dev) for a in anchor_vecs]
        (yolo_p, _), new_bn = model.forward_train(imgs, head_layout='nhwc')
        loss, items = compute_loss(yolo_p, targets, valid, anchors[dev], nc,
                                   hyp, gr, layout='nhwc')
        (loss * loss_scale).backward()
        if sparse_keys:
            gammas = [model.layer[k].gamma for k in sparse_keys
                      if k in model.layer and hasattr(model.layer[k], 'gamma')]
            with torch.no_grad():
                torch._foreach_add_(
                    [g.grad for g in gammas],
                    torch._foreach_mul(torch._foreach_sign(gammas),
                                       sparsity_s))
        with torch.no_grad():
            bufs, vals = [], []
            for k, d in new_bn.items():
                t = model.layer[k]
                bufs += [t.mean, t.var]
                vals += [d['mean'], d['var']]
            if bufs:
                torch._foreach_copy_(bufs, vals)
        state.accum_count += 1
        return state, items

    def update_fn(state: TrainState, scalars: PerGroupScalars):
        state.optimizer.set_scalars(scalars)
        state.optimizer.step()
        if state.ema is not None:
            ema_update(state.ema, state.params, state.bn_state)
        state.optimizer.zero_grad(set_to_none=True)
        state.accum_count = 0
        return state

    return grad_fn, update_fn
