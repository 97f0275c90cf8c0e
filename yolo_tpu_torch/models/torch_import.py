"""Read and write ``.pt`` checkpoints of the PyTorch reference (counterpart
of yolo_tpu/models/torch_import.py).

A reference checkpoint is ``{'epoch', 'best_fitness', 'training_results',
'model': state_dict, 'optimizer'}``, or a bare state_dict (an EMA save).
Its keys follow the cfg walk; they map onto the port's dicts as:

  module_list.{i}.Conv2d.weight        -> params[i]['w']   (OIHW, as is)
  module_list.{i}.Conv2d.bias          -> params[i]['b']
  module_list.{i}.DepthWise2d.*        -> the same fields
  module_list.{i}.BatchNorm2d.weight   -> params[i]['gamma']
  module_list.{i}.BatchNorm2d.bias     -> params[i]['beta']
  module_list.{i}.BatchNorm2d.running_mean/var -> state[i]['mean'/'var']
  module_list.{i}.{Conv2d,DepthWise2d}.{gamma,beta,running_mean,running_var}
                                       -> the same (quantized BN-fold layout)
  module_list.{i}.se.fc.0.weight       -> params[i]['fc1']
  module_list.{i}.se.fc.2.weight       -> params[i]['fc2']
  module_list.{i}.w                    -> params[i]['w'] (weighted shortcut)

The quantizer trackers (``activation/weight/bias_quantizer.*``, and the
shortcut and concat requant buffers) map onto the google-scheme qstate
(``compress/quant.py`` ``init_quant_state``) when one is passed. A
``module.`` prefix (a DDP save) is dropped. Every tensor is read as f32.
"""

from __future__ import annotations

import torch

from ..ir import NetworkIR

_CONV_NAMES = ('Conv2d', 'DepthWise2d')


def _f32(t):
    return torch.as_tensor(t).detach().to('cpu', torch.float32).clone()


def _strip_module_prefix(sd):
    if sd and all(k.startswith('module.') for k in sd):
        return {k[len('module.'):]: v for k, v in sd.items()}
    return dict(sd)


def _tracker_from(sd, prefix, first_key):
    """A reference range tracker's buffers -> the port's tracker fields."""
    out = {}
    pairs = {'min': 'range_tracker.min_val', 'max': 'range_tracker.max_val',
             'first': f'range_tracker.{first_key}', 'scale': 'scale',
             'zp': 'zero_point', 'step': 'step'}
    for ours, theirs in pairs.items():
        k = f'{prefix}.{theirs}'
        if k in sd:
            out[ours] = _f32(sd[k]).reshape(())
    return out


def load_torch_checkpoint(net: NetworkIR, params, state, path, qstate=None):
    """Read a reference ``.pt`` checkpoint into copies of (params, state),
    and of ``qstate`` where one is given.

    Returns (params, state, qstate, meta); meta holds ``epoch``,
    ``best_fitness`` and ``training_results`` (-1, 0.0 and '' when the file
    is a bare state_dict)."""
    ck = torch.load(path, map_location='cpu', weights_only=False)
    meta = {'epoch': -1, 'best_fitness': 0.0, 'training_results': ''}
    if isinstance(ck, dict) and 'model' in ck:
        if ck.get('epoch') is not None:
            meta['epoch'] = int(ck['epoch'])
        if ck.get('best_fitness') is not None:
            meta['best_fitness'] = float(torch.as_tensor(
                ck['best_fitness']).max())
        if ck.get('training_results'):
            meta['training_results'] = str(ck['training_results'])
        sd = ck['model']
    elif isinstance(ck, dict) and any(k.startswith(('module_list', 'module.'))
                                      for k in ck):
        sd = ck
    else:
        raise ValueError(f'{path}: not a reference checkpoint '
                         '(no model state_dict found)')
    sd = _strip_module_prefix(sd)

    params = {k: dict(v) for k, v in params.items()}
    state = {k: dict(v) for k, v in state.items()}
    if qstate is not None:
        qstate = {k: {f: (dict(v) if isinstance(v, dict) else v)
                      for f, v in d.items()} for k, d in qstate.items()}

    def take(key):
        return _f32(sd[key])

    for lyr in net.layers:
        k = str(lyr.index)
        pre = f'module_list.{lyr.index}'
        if lyr.kind in ('conv', 'depthwise'):
            base = next((f'{pre}.{n}' for n in _CONV_NAMES
                         if f'{pre}.{n}.weight' in sd), None)
            if base is None:
                raise KeyError(f'{path}: layer {lyr.index} ({lyr.kind}) has '
                               f'no conv weight under {pre}')
            params[k]['w'] = take(f'{base}.weight')
            if f'{base}.bias' in sd:
                params[k]['b'] = take(f'{base}.bias')
            if lyr.bn:
                # float layout: a BatchNorm2d module; quantized BN-fold
                # layout: the same tensors on the conv module itself
                if f'{pre}.BatchNorm2d.weight' in sd:
                    bn = f'{pre}.BatchNorm2d'
                    gkey, bkey = f'{bn}.weight', f'{bn}.bias'
                else:
                    bn = base
                    gkey, bkey = f'{bn}.gamma', f'{bn}.beta'
                params[k]['gamma'] = take(gkey)
                params[k]['beta'] = take(bkey)
                state[k]['mean'] = take(f'{bn}.running_mean')
                state[k]['var'] = take(f'{bn}.running_var')
            if qstate is not None and k in qstate:
                qs = qstate[k]
                for ours, theirs, fk in (('aq', 'activation_quantizer',
                                          'first_a'),
                                         ('wq', 'weight_quantizer', 'first_w'),
                                         ('bq', 'bias_quantizer', 'first_w')):
                    if ours in qs and f'{base}.{theirs}.scale' in sd:
                        qs[ours] = {**qs[ours], **_tracker_from(
                            sd, f'{base}.{theirs}', fk)}
                for f in ('first_bn', 'step'):
                    if f in qs and f'{base}.{f}' in sd:
                        qs[f] = take(f'{base}.{f}').reshape(())
        elif lyr.kind == 'batchnorm':
            bn = f'{pre}.BatchNorm2d'
            params[k]['gamma'] = take(f'{bn}.weight')
            params[k]['beta'] = take(f'{bn}.bias')
            state[k]['mean'] = take(f'{bn}.running_mean')
            state[k]['var'] = take(f'{bn}.running_var')
        elif lyr.kind == 'se':
            params[k]['fc1'] = take(f'{pre}.se.fc.0.weight')
            params[k]['fc2'] = take(f'{pre}.se.fc.2.weight')
        elif lyr.kind == 'shortcut':
            if lyr.weighted and f'{pre}.w' in sd:
                params[k]['w'] = take(f'{pre}.w')
            if qstate is not None and k in qstate:
                for f in ('scale', 'input_scale'):
                    if f in qstate[k] and f'{pre}.{f}' in sd:
                        qstate[k][f] = take(f'{pre}.{f}').reshape(())
        elif lyr.kind == 'route' and qstate is not None and k in qstate:
            if f'{pre}.float_max_list' in sd:
                qstate[k]['float_max'] = take(f'{pre}.float_max_list')
            if f'{pre}.scale' in sd:
                qstate[k]['scale'] = take(f'{pre}.scale').reshape(())
    return params, state, qstate, meta


def save_torch_checkpoint(net: NetworkIR, params, state, path, *,
                          epoch: int = -1, best_fitness: float = 0.0,
                          training_results: str = ''):
    """Write (params, state) as a float reference ``.pt`` checkpoint (the
    inverse key map), f32 tensors on the CPU."""
    sd = {}

    def put(key, t):
        sd[key] = _f32(t)

    def put_bn(bn, p, st):
        put(f'{bn}.weight', p['gamma'])
        put(f'{bn}.bias', p['beta'])
        put(f'{bn}.running_mean', st['mean'])
        put(f'{bn}.running_var', st['var'])
        sd[f'{bn}.num_batches_tracked'] = torch.zeros((), dtype=torch.long)

    for lyr in net.layers:
        k = str(lyr.index)
        pre = f'module_list.{lyr.index}'
        p = params.get(k, {})
        if lyr.kind in ('conv', 'depthwise'):
            base = f'{pre}.{"DepthWise2d" if lyr.kind == "depthwise" else "Conv2d"}'
            put(f'{base}.weight', p['w'])
            if 'b' in p:
                put(f'{base}.bias', p['b'])
            if lyr.bn:
                put_bn(f'{pre}.BatchNorm2d', p, state[k])
        elif lyr.kind == 'batchnorm':
            put_bn(f'{pre}.BatchNorm2d', p, state[k])
        elif lyr.kind == 'se':
            put(f'{pre}.se.fc.0.weight', p['fc1'])
            put(f'{pre}.se.fc.2.weight', p['fc2'])
        elif lyr.kind == 'shortcut' and lyr.weighted and 'w' in p:
            put(f'{pre}.w', p['w'])
    torch.save({'epoch': epoch, 'best_fitness': best_fitness,
                'training_results': training_results, 'model': sd,
                'optimizer': None}, path)
