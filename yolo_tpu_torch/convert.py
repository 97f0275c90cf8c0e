"""Move weights between the JAX package's pytrees and the port's tensors,
and the weight-format CLI, ``python -m yolo_tpu_torch.convert``
(counterpart of the root ``convert.py``, which belongs to the JAX
package):

    python -m yolo_tpu_torch.convert --cfg cfg/yolov3/yolov3.cfg \
        --weights weights/last.npz [--output weights/last.weights]

converts by extension: a .npz checkpoint to darknet .weights (or to the
``--output`` given: .npz, .weights, or a reference .pt), .weights and
reference .pt files to .npz. A training checkpoint exports its EMA pair,
the deployable weights. Conversion runs on the host; ``--device``,
``--img_size`` and ``--gray-scale`` are accepted as the root CLI accepts
them.

Both sides are ``{layer_index_str: {field: array}}`` dicts for params and
for BN state. Conv weights are HWIO in JAX and OIHW here (for a grouped
conv I = in_channels // groups on both sides, and the output channels of a
group are contiguous on both sides, so one transpose converts every group).
BN gamma/beta/mean/var, conv biases, weighted-shortcut ``w``, SE
``fc1``/``fc2`` (already in torch ``Linear`` layout) and TPSQ's 0-d
``w_scale``/``b_scale``/``a_scale`` params are copied as they are.

The quantizer state (``qstate``) of every scheme is a nested dict of
scalars and vectors (a concat's ``float_max``, cos-PTQ's ``votes``):
``qstate_from_jax``/``qstate_to_jax`` copy it leaf by leaf as f32.

The optimizer state (``opt_state_from_jax``/``opt_state_to_jax``) holds
params-shaped trees under the JAX package's names, ``momentum_buf`` (SGD)
or ``m`` and ``v`` with a ``step`` count (Adam, AdaBound), converted as
the params are. The EMA pair is a (params, state) pair: ``from_jax`` and
``to_jax`` carry it.
"""

from __future__ import annotations

import numpy as np
import torch

from .ir import NetworkIR

_CONV_KINDS = ('conv', 'depthwise')


def _conv_keys(net: NetworkIR) -> set[str]:
    return {str(l.index) for l in net.layers if l.kind in _CONV_KINDS}


def from_jax(net: NetworkIR, params, state):
    """JAX (params, state) of numpy-convertible arrays -> f32 CPU tensors."""
    convs = _conv_keys(net)

    def conv(k, f, a):
        a = np.asarray(a, np.float32)
        if k in convs and f == 'w':
            a = a.transpose(3, 2, 0, 1)                       # HWIO -> OIHW
        return torch.tensor(a)                                # a copy

    return ({k: {f: conv(k, f, a) for f, a in d.items()}
             for k, d in params.items()},
            {k: {f: conv(k, f, a) for f, a in d.items()}
             for k, d in state.items()})


def to_jax(net: NetworkIR, params, state):
    """Inverse of ``from_jax``: tensors -> numpy f32 arrays in JAX layout."""
    convs = _conv_keys(net)

    def conv(k, f, t):
        a = t.detach().to('cpu', torch.float32).numpy()
        if k in convs and f == 'w':
            a = a.transpose(2, 3, 1, 0)                       # OIHW -> HWIO
        # (np.ascontiguousarray would make a 0-d scale 1-d)
        return a if a.flags.c_contiguous else np.ascontiguousarray(a)

    return ({k: {f: conv(k, f, t) for f, t in d.items()}
             for k, d in params.items()},
            {k: {f: conv(k, f, t) for f, t in d.items()}
             for k, d in state.items()})


def qstate_from_jax(qstate, device=None):
    """JAX qstate (nested dicts of numpy-convertible scalars and vectors,
    e.g. 0-d arrays from a .npz) -> the same tree of f32 tensors."""
    if isinstance(qstate, dict):
        return {k: qstate_from_jax(v, device) for k, v in qstate.items()}
    return torch.tensor(np.asarray(qstate, np.float32), device=device)


def qstate_to_jax(qstate):
    """Inverse of ``qstate_from_jax``: tensors -> numpy f32 arrays."""
    if isinstance(qstate, dict):
        return {k: qstate_to_jax(v) for k, v in qstate.items()}
    return np.asarray(qstate.detach().to('cpu', torch.float32).numpy())


# the fields of the JAX package's optimizer-state NamedTuples, in order: a
# checkpoint it writes holds them as a list
_OPT_FIELDS = {1: ('momentum_buf',), 3: ('step', 'm', 'v')}


def opt_state_from_jax(net: NetworkIR, opt_state):
    """JAX optimizer state -> ``{'momentum_buf': tree}`` or ``{'step': int,
    'm': tree, 'v': tree}`` of f32 CPU tensors in the port's layout. Takes
    the NamedTuple, a dict of its fields, or the positional list that a
    JAX checkpoint holds."""
    if hasattr(opt_state, '_fields'):
        opt_state = opt_state._asdict()
    elif isinstance(opt_state, (list, tuple)):
        opt_state = dict(zip(_OPT_FIELDS[len(opt_state)], opt_state))
    out = {}
    for name, tree in opt_state.items():
        out[name] = (int(np.asarray(tree)) if name == 'step'
                     else from_jax(net, tree, {})[0])
    return out


def opt_state_to_jax(net: NetworkIR, opt_state):
    """Inverse of ``opt_state_from_jax``: the port optimizer's
    ``state_tree()`` -> a dict of the JAX field names with numpy trees in
    the JAX layout (``step`` an int32 array)."""
    out = {}
    for name, tree in opt_state.items():
        out[name] = (np.asarray(int(tree), np.int32) if name == 'step'
                     else to_jax(net, tree, {})[0])
    return out


def main(argv=None):
    from .ir import build_ir
    from .models.darknet_io import load_darknet_weights, save_darknet_weights
    from .models.network import init_params
    from .models.torch_import import (load_torch_checkpoint,
                                      save_torch_checkpoint)
    from .utils.checkpoint import load_checkpoint, save_checkpoint
    from .utils.cli import FlexParser

    p = FlexParser()
    p.add_argument('--cfg', type=str, default='cfg/yolov3/yolov3.cfg')
    p.add_argument('--weights', type=str, required=True,
                   help='.npz -> .weights or .weights -> .npz by extension')
    p.add_argument('--output', type=str, default='',
                   help='target path (default: source path with the '
                        'extension swapped)')
    p.add_argument('--img_size', '--img-size', dest='img_size', type=int,
                   default=416, help='accepted for CLI compat; weight '
                                     'conversion is size-independent')
    p.add_argument('--gray-scale', '--gray_scale', dest='gray_scale',
                   action='store_true',
                   help='accepted for CLI compat; channel count comes from '
                        'the cfg')
    p.add_argument('--device', type=str, default='cuda',
                   help='accepted for CLI compat; conversion runs on the '
                        'host')
    opt = p.parse_args(argv)

    net = build_ir(opt.cfg)
    params, state = init_params(net)
    stem = opt.weights.rsplit('.', 1)[0]

    def write(target, params, state, meta=None):
        meta = meta or {}
        if target.endswith('.npz'):
            p_, s_ = to_jax(net, params, state)
            save_checkpoint(target, params=p_, state=s_,
                            epoch=meta.get('epoch', -1))
        elif target.endswith('.weights'):
            save_darknet_weights(net, params, state, target)
        elif target.endswith(('.pt', '.pth')):
            save_torch_checkpoint(net, params, state, target,
                                  epoch=meta.get('epoch', -1),
                                  best_fitness=meta.get('best_fitness', 0.0))
        else:
            raise SystemExit(f'Error: unsupported target extension {target}')
        print(f"Success: converted '{opt.weights}' to '{target}'")
        return target

    if opt.weights.endswith('.npz'):
        ck = load_checkpoint(opt.weights)
        # the EMA pair when the checkpoint holds one: the reference's
        # checkpoint 'model' is the EMA state_dict, the weights whose mAP
        # the run reported
        if ck.get('ema') is not None and ck.get('ema_state') is not None:
            src = from_jax(net, ck['ema'], ck['ema_state'])
        else:
            src = from_jax(net, ck['params'], ck['state'])
        return write(opt.output or stem + '.weights', *src,
                     {'epoch': int(ck.get('epoch', -1))})
    if opt.weights.endswith('.weights'):
        params, state, _, _ = load_darknet_weights(net, params, state,
                                                   opt.weights)
        return write(opt.output or stem + '.npz', params, state)
    if opt.weights.endswith(('.pt', '.pth')):
        params, state, _, meta = load_torch_checkpoint(net, params, state,
                                                        opt.weights)
        return write(opt.output or stem + '.npz', params, state, meta)
    print('Error: extension not supported.')
    return None


if __name__ == '__main__':
    main()
