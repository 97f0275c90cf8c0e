""".npz checkpoints, in the format of ``yolo_tpu/utils/checkpoint.py``.

The port's own copy (numpy only). A checkpoint stores nested dicts of
arrays as flat path-keyed arrays in one ``.npz`` (no pickle): ``params``,
``state`` and, where present, ``opt_state``, ``ema``, ``ema_state`` and
``qstate`` (quantizer calibration), plus a JSON ``__meta__`` record.
Files written by either package load in the other. ``strip_optimizer``
turns a training checkpoint into a deployable one in place.
"""

from __future__ import annotations

import json
import os
from typing import Any

import numpy as np

_SEP = '/'
_META_KEY = '__meta__'


def _flatten(tree, prefix=''):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f'{prefix}{k}{_SEP}'))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f'{prefix}#{i}{_SEP}'))
    elif tree is None:
        out[prefix.rstrip(_SEP) + '!none'] = np.zeros(0)
    else:
        out[prefix.rstrip(_SEP)] = np.asarray(tree)
    return out


def _unflatten(flat: dict):
    tree: dict = {}
    for path, arr in flat.items():
        if path.endswith('!none'):
            path, arr = path[:-len('!none')], None
        parts = path.split(_SEP)
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr

    def fix(node):
        if not isinstance(node, dict):
            return node
        keys = list(node.keys())
        if keys and all(k.startswith('#') for k in keys):
            return [fix(node[f'#{i}']) for i in range(len(keys))]
        return {k: fix(v) for k, v in node.items()}
    return fix(tree)


def save_checkpoint(path, *, params, state, epoch: int = -1,
                    best_fitness: float = 0.0, training_results: str = '',
                    opt_state: Any = None, ema: Any = None,
                    ema_state: Any = None, qstate: Any = None,
                    extra: dict | None = None):
    """Write numpy-convertible trees (JAX layout) to ``path``."""
    os.makedirs(os.path.dirname(str(path)) or '.', exist_ok=True)
    payload = {'params': params, 'state': state}
    for key, tree in (('opt_state', opt_state), ('ema', ema),
                      ('ema_state', ema_state), ('qstate', qstate)):
        if tree is not None:
            payload[key] = tree
    flat = _flatten(payload)
    meta = {'epoch': int(epoch), 'best_fitness': float(best_fitness),
            'training_results': training_results, **(extra or {})}
    flat[_META_KEY] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    np.savez(str(path), **flat)


def load_checkpoint(path):
    """Returns a dict with params/state[/opt_state][/ema][/ema_state]
    [/qstate] trees of numpy arrays, plus the meta fields."""
    data = np.load(str(path), allow_pickle=False)
    flat = {k: data[k] for k in data.files if k != _META_KEY}
    tree = _unflatten(flat)
    meta = (json.loads(bytes(data[_META_KEY]).decode())
            if _META_KEY in data.files else {})
    tree.update(meta)
    return tree


def strip_optimizer(path):
    """Rewrite a training checkpoint in place as a deployable one: the
    optimizer state dropped (the named form the port writes or the JAX
    package's positional one), and the EMA pair, when the file holds both
    its params and its BN state, promoted to params/state (the pair that
    each epoch's evaluation ran on). The result does not resume."""
    ck = load_checkpoint(path)
    if ck.get('ema') is not None and ck.get('ema_state') is not None:
        params, state = ck['ema'], ck['ema_state']
    else:
        params, state = ck['params'], ck['state']
    save_checkpoint(path, params=params, state=state,
                    epoch=ck.get('epoch', -1),
                    best_fitness=ck.get('best_fitness', 0.0),
                    training_results=ck.get('training_results', ''),
                    qstate=ck.get('qstate'))
