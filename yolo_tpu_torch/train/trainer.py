"""The train step and its state (counterpart of
``yolo_tpu/train/trainer.py``).

``grad_fn`` runs the train forward (``Darknet.forward_train``, BN on batch
statistics), the loss in the NHWC head layout (unless QAT or KD set
another) scaled by ``loss_scale``,
and ``backward``, which adds into the parameters' ``.grad`` (gradient
accumulation, as JAX's ``grad_accum``); it adds the BN-gamma L1
subgradient ``s*sign(gamma)`` of the sparse layers and writes the new BN
running statistics into the model's buffers. ``update_fn`` runs the
optimizer on the accumulated gradients, then the EMA, then clears the
gradients. Neither reads a value back to the host.

QAT: given a ``quant_apply`` (``compress/quant.make_quant_apply``),
``grad_fn`` runs it in train mode on the model's f32 master parameters
(TPSQ's scale params among them), its BN state and the ``TrainState``'s
``qstate``, in the apply's head layout; the new quantizer state replaces
``qstate`` without a gradient.

KD: given a ``kd_loss_fn`` (``train/kd.make_kd_loss_fn``), the loss adds
``kd_loss_fn(yolo_p, feats, targets, valid, imgs)`` (the teacher runs
inside it); the heads take the quant apply's layout if there is one, else
the KD function's.

Data parallelism: given a ``mesh`` (``parallel.make_mesh``), each rank's
``grad_fn`` runs its block of the global batch, and every batch-wide
quantity is the global batch's: the train-mode BN statistics (of the
student, the KD teacher and the QAT BN fold), the loss's normalisers, the
QAT range trackers and the KD terms' counts, through the collectives of
``parallel/collectives.py``. ``update_fn`` sums the accumulated gradients
over the data group in one flattened bucket, then every rank runs the same
optimizer and EMA update on the same gradient, so the replicas stay equal.
This is not ``DistributedDataParallel``, which averages per-rank
gradients of per-rank statistics and hooks ``forward`` only.

Tensor parallelism: under a mesh with a model axis, the state is split by
``parallel.shard_state`` and the model's split convs gather their outputs
(``Darknet.model_group``), so every rank of a data index computes the same
loss from the same rows, and the gradient of each tensor it holds, split
or whole, is already the whole of it. ``update_fn`` sums the gradients
over the data group, then averages over the model group what every rank
of it holds whole (the gradients and BN statistics of the convs that are
not split): each rank computed its own copy, and a backward that sums in
another order on one rank would otherwise set the copies apart for good.
QAT under a model axis runs the quant apply with the model group
(``make_quant_apply``'s ``model_group``): each split conv runs its block
and gathers its activation before the quantizer, and the per-tensor
reductions of its weight span the model group, so the quantizer state
comes out the same on every rank of the group; TPSQ's scales of a split
conv, whole on every rank, get the gradient of the whole tensor there
(``copy_to_model``). A batch split by rows
(``parallel.shard_spatial``) is for inference alone.

``remat`` (JAX's policies): 'blocks' recomputes in the backward every run
of layers between two block boundaries (shortcuts, multi-route concats)
and keeps only the runs' inputs, 'full' (or True) keeps only the batch;
for QAT both recompute the whole quant apply. The recompute runs the
train-mode BN's collectives again (the same ones in the same order on
every rank), and its BN statistics and quantizer state are dropped: the
update is the first forward's.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from torch.utils.checkpoint import checkpoint

from ..ir import NetworkIR
from ..models.network import Darknet
from .ema import EMAState, ema_init, ema_update
from .loss import LossHyp, compute_loss
from ..parallel.collectives import average_tensors, sum_gradients
from .optim import PerGroupScalars, make_optimizer
from ..utils.profiler import span


@dataclass
class TrainState:
    """The trainable model (f32 master parameters, BN statistics in its
    buffers, gradients accumulated in ``.grad``), its optimizer, the EMA
    copy, the count of ``grad_fn`` calls since the last update and, for
    QAT, the quantizer state."""
    model: Darknet
    optimizer: torch.optim.Optimizer
    ema: EMAState | None
    accum_count: int = 0
    qstate: dict | None = None

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
                     base_lr: float | None = None,
                     qstate: dict | None = None) -> TrainState:
    """A ``TrainState`` on ``device`` that owns copies of ``params`` and
    ``bn_state`` (f32) and of ``qstate`` (QAT); ``compute_dtype`` is the
    dtype of the float model's convs (``None``: f32). ``optimizer`` is
    'sgd', 'adam' or 'adabound' (which needs ``base_lr``)."""
    device = torch.device(device)
    model = Darknet(net, params, bn_state, maxabsscaler=maxabsscaler,
                    dtype=compute_dtype, trainable=True)
    model = model.to(device, memory_format=torch.channels_last)
    st = TrainState(model=model, optimizer=None, ema=None,
                    qstate=None if qstate is None else _tree_copy(qstate,
                                                                  device))
    st.optimizer = make_optimizer(optimizer, st.params, base_lr=base_lr)
    if use_ema:
        st.ema = ema_init(st.params, st.bn_state)
    return st


def _tree_copy(tree, device=None):
    if isinstance(tree, dict):
        return {k: _tree_copy(v, device) for k, v in tree.items()}
    return tree.detach().to(device, copy=True)


def _tree_detach(tree):
    if isinstance(tree, dict):
        return {k: _tree_detach(v) for k, v in tree.items()}
    return tree.detach()


def make_train_functions(net: NetworkIR, anchor_vecs, nc: int, hyp: LossHyp,
                         *, sparsity_s: float = 0.0,
                         sparse_gamma_layers: tuple[int, ...] = (),
                         kd_loss_fn=None, remat=False, quant_apply=None,
                         mesh=None):
    """(grad_fn, update_fn) for a ``TrainState``.

    grad_fn(state, imgs, targets, valid, gr, loss_scale) -> (state, items)
        imgs an NHWC f32 batch on the model's device, targets (T, 6) and
        valid (T,) there too; ``gr`` and ``loss_scale`` host floats. Adds
        the gradients of ``loss * loss_scale`` into ``.grad`` and updates
        the BN running statistics; items (4,) = [lbox, lobj, lcls, total],
        detached, on the device. Under a ``mesh`` the arguments are this
        rank's block of the global batch (image indices local), and items
        are this rank's share: their sum over the data group is the global
        batch's.
    update_fn(state, scalars: PerGroupScalars) -> state
        the gradients summed over the mesh's data group, the optimizer step
        on them, the EMA update, gradients cleared.

    ``sparse_gamma_layers`` with ``sparsity_s`` > 0 add ``s*sign(gamma)``
    to those layers' BN-gamma gradients at every ``grad_fn`` call (sparse
    training before pruning).

    ``quant_apply``: QAT; the forward is that apply in train mode (see the
    module docstring), the loss in its ``head_layout``. ``kd_loss_fn``:
    its term is added to the loss; with QAT both must use one layout.

    ``mesh``: data parallelism over its data group, and tensor parallelism
    over its model group (module docstring); the sparsity term is added on
    data index 0 alone, so that the sum over the data group holds it once.

    ``remat``: False/None/'none', 'blocks', or True/'full' (module
    docstring).

    Spans (``utils/profiler.py``): each call of ``grad_fn`` is the
    top-level span ``train.grad`` over ``train.forward`` (the forward or
    the QAT apply), ``train.loss`` (with the KD term) and
    ``train.backward``; each call of ``update_fn`` is ``train.update``."""
    if remat in (False, None, 'none', ''):
        remat = None
    elif remat in (True, 'full'):
        remat = 'full'
    elif remat != 'blocks':
        raise ValueError(f'remat={remat!r}: none, blocks or full')
    anchors: dict = {}
    group = None if mesh is None else mesh.data_group
    model_group = None if mesh is None else mesh.model_group
    sparse_keys = tuple(str(i) for i in sparse_gamma_layers) \
        if sparsity_s > 0 and (mesh is None or mesh.data_index == 0) else ()
    if quant_apply is not None:
        layout = getattr(quant_apply, 'head_layout', 'anchor_major')
    elif kd_loss_fn is not None:
        layout = getattr(kd_loss_fn, 'layout', 'anchor_major')
    else:
        layout = 'nhwc'
    if quant_apply is not None and kd_loss_fn is not None:
        assert getattr(kd_loss_fn, 'layout', 'anchor_major') == layout, \
            (getattr(kd_loss_fn, 'layout', None), layout)

    def grad_fn(state: TrainState, imgs, targets, valid, gr: float,
                loss_scale: float):
        with span('train.grad'):
            return _grad(state, imgs, targets, valid, gr, loss_scale)

    def _grad(state, imgs, targets, valid, gr, loss_scale):
        model = state.model
        dev = imgs.device
        if dev not in anchors:
            anchors[dev] = [torch.as_tensor(a, dtype=torch.float32,
                                            device=dev) for a in anchor_vecs]
        with span('train.forward'):
            if quant_apply is None:
                (yolo_p, feats), new_bn = model.forward_train(
                    imgs, head_layout=layout, group=group, remat=remat)
            else:
                args = (state.params, state.bn_state, state.qstate, imgs, True)
                kw = dict(group=group, model_group=model_group)
                (yolo_p, feats), new_bn, new_q = (
                    quant_apply(*args, **kw) if remat is None else
                    checkpoint(quant_apply, *args, **kw, use_reentrant=False))
                state.qstate = _tree_detach(new_q)
        with span('train.loss'):
            loss, items = compute_loss(yolo_p, targets, valid, anchors[dev],
                                       nc, hyp, gr, layout=layout,
                                       group=group)
            if kd_loss_fn is not None:
                loss = loss + kd_loss_fn(yolo_p, feats, targets, valid, imgs,
                                         group=group)
        with span('train.backward'):
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
        with span('train.update'):
            return _update(state, scalars)

    def _update(state, scalars):
        sum_gradients([p for g in state.optimizer.param_groups
                       for p in g['params']], group)
        if model_group is not None:
            average_tensors(_whole_on_each_rank(state.model, net),
                            model_group)
        state.optimizer.set_scalars(scalars)
        state.optimizer.step()
        if state.ema is not None:
            ema_update(state.ema, state.params, state.bn_state)
        state.optimizer.zero_grad(set_to_none=True)
        state.accum_count = 0
        return state

    return grad_fn, update_fn


def _whole_on_each_rank(model: Darknet, net: NetworkIR) -> list:
    """The gradients and buffers of the layers that tensor parallelism
    leaves whole (every layer but the convs whose weight holds a block of
    the filters, ``Darknet._layer``'s rule)."""
    out = []
    for k, m in model.layer.items():
        w = getattr(m, 'w', None)
        if w is not None and w.shape[0] != net.layers[int(k)].filters:
            continue
        for p in m.parameters(recurse=False):
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            out.append(p.grad)
        out += list(m.buffers(recurse=False))
    return out
