"""BN-gamma channel / layer pruning as graph-IR passes over host arrays
(counterpart of ``yolo_tpu/compress/prune.py``).

The passes work on the typed ``NetworkIR`` and on host numpy copies of the
port's params and state (``host_tree``; conv weights OIHW). A prune emits
a new, smaller graph (a cfg with fewer filters, or fewer layers) and
sliced arrays; ``compress/prune_drivers.py`` puts them back on the
caller's device.

Pass inventory:
- prunable_sets_normal/_shortcut/_layer: which conv layers may be pruned;
- gather_bn_gammas + global_threshold: the global-percent gamma ranking;
- obtain_filters_mask: per-layer masks with a layer_keep floor;
- merge_masks_across_shortcuts: union of the masks along each shortcut
  chain, optionally snapped to a multiple;
- bias_compensation: masks gamma/beta and moves each dead channel's
  constant activation act((1-m)*beta) into the consumer conv's running
  mean or bias, so the masked network keeps its output without finetune;
- compact_network: the smaller NetworkIR and the sliced arrays;
- layer_prune_blocks + copy_params_subset: shortcut-block removal with
  route re-indexing.

Masks, cfg text and arrays are bit-equal to the JAX package's on the same
weights. The two reductions whose order depends on the weight layout (the
conv sums of ``bias_compensation`` here and the filters' L1 of EagleEye)
run in numpy on a contiguous HWIO copy (``hwio``), the same calls on the
same layout as in the JAX package; the slicing itself is layout-free.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, field

import numpy as np
import torch

from ..ir import NetworkIR, build_ir

# numpy versions of the activations used for the constant dead-channel value
_ACT_NP = {
    'leaky': lambda x: np.where(x > 0, x, 0.1 * x),
    'relu': lambda x: np.maximum(x, 0),
    'relu6': lambda x: np.clip(x, 0, 6),
    'h_swish': lambda x: x * np.clip(x + 3, 0, 6) / 6,
    'mish': lambda x: x * np.tanh(np.log1p(np.exp(-np.abs(x))) + np.maximum(x, 0)),
    'swish': lambda x: x / (1 + np.exp(-x)),
    'linear': lambda x: x,
}


def _np(v) -> np.ndarray:
    """A host numpy view or copy of a tensor or array."""
    if torch.is_tensor(v):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def host_tree(tree) -> dict:
    """``{k: {f: array}}`` -> the same dicts of host f32 numpy copies."""
    return {k: {f: np.array(_np(v), np.float32) for f, v in d.items()}
            for k, d in tree.items()}


def hwio(w) -> np.ndarray:
    """A contiguous HWIO numpy copy of an OIHW conv weight."""
    return np.ascontiguousarray(_np(w).transpose(2, 3, 1, 0))


@dataclass
class PruneSets:
    cbl_idx: list[int] = field(default_factory=list)     # conv+BN layers
    other_idx: list[int] = field(default_factory=list)   # conv w/o BN, dw, se
    prune_idx: list[int] = field(default_factory=list)   # actually prunable
    shortcut_idx: dict[int, int] = field(default_factory=dict)
    shortcut_all: set[int] = field(default_factory=set)


def prunable_sets_normal(net: NetworkIR) -> PruneSets:
    """Skip convs feeding shortcuts (both sides), upsample-preceding,
    spp-preceding, depthwise-preceding and group-route-preceding convs."""
    ps = PruneSets()
    L = net.layers
    ignore: set[int] = set()
    for i, lyr in enumerate(L):
        if lyr.kind == 'conv':
            (ps.cbl_idx if lyr.bn else ps.other_idx).append(i)
            if i + 2 < len(L) and L[i + 1].kind == 'maxpool' and L[i + 2].kind == 'route':
                ignore.add(i)           # spp-entry conv
            if i + 1 < len(L) and L[i + 1].kind == 'route' and L[i + 1].route_groups:
                ignore.add(i)
        elif lyr.kind == 'depthwise':
            ps.other_idx.append(i)
            ignore.add(i - 1)
        elif lyr.kind == 'se':
            ps.other_idx.append(i)
        elif lyr.kind == 'shortcut':
            ignore.add(i - 1)
            src = lyr.layers[0]
            if L[src].kind == 'conv':
                ignore.add(src)
            elif L[src].kind == 'shortcut':
                ignore.add(src - 1)
        elif lyr.kind == 'upsample':
            ignore.add(i - 1)
    ps.prune_idx = [i for i in ps.cbl_idx if i not in ignore]
    return ps


def prunable_sets_shortcut(net: NetworkIR) -> PruneSets:
    """Shortcut-adjacent convs stay prunable; their masks are linked
    through ``shortcut_idx`` chains."""
    ps = PruneSets()
    L = net.layers
    ignore: set[int] = set()
    for i, lyr in enumerate(L):
        if lyr.kind == 'conv':
            (ps.cbl_idx if lyr.bn else ps.other_idx).append(i)
            if i + 2 < len(L) and L[i + 1].kind == 'maxpool' and L[i + 2].kind == 'route':
                ignore.add(i)
            if i + 1 < len(L) and L[i + 1].kind == 'route' and L[i + 1].route_groups:
                ignore.add(i)
        elif lyr.kind == 'depthwise':
            ps.other_idx.append(i)
            ignore.add(i - 1)
        elif lyr.kind == 'se':
            ps.other_idx.append(i)
        elif lyr.kind == 'upsample':
            ignore.add(i - 1)
        elif lyr.kind == 'shortcut':
            src = lyr.layers[0]
            if L[src].kind == 'conv':
                ps.shortcut_idx[i - 1] = src
                ps.shortcut_all.add(src)
            elif L[src].kind == 'shortcut':
                ps.shortcut_idx[i - 1] = src - 1
                ps.shortcut_all.add(src - 1)
            ps.shortcut_all.add(i - 1)
    ps.prune_idx = [i for i in ps.cbl_idx if i not in ignore]
    return ps


def prunable_sets_layer(net: NetworkIR):
    """(cbl_idx, conv_idx, shortcut_preceding_idx)."""
    cbl, conv, sc = [], [], []
    for i, lyr in enumerate(net.layers):
        if lyr.kind == 'conv':
            (cbl if lyr.bn else conv).append(i)
        elif lyr.kind == 'shortcut':
            sc.append(i - 1)
    return cbl, conv, sc


def gather_bn_gammas(params, prune_idx) -> np.ndarray:
    return np.concatenate([np.abs(_np(params[str(i)]['gamma']))
                           for i in prune_idx]) if prune_idx else np.zeros(0)


def global_threshold(params, prune_idx, percent: float):
    """The global gamma percentile threshold, the highest safe threshold
    and the percent it allows."""
    bn = gather_bn_gammas(params, prune_idx)
    sorted_bn = np.sort(bn)
    thre_index = int(len(sorted_bn) * percent)
    thre = sorted_bn[min(thre_index, len(sorted_bn) - 1)]
    highest = min(float(np.abs(_np(params[str(i)]['gamma'])).max())
                  for i in prune_idx)
    percent_limit = float((sorted_bn < highest).sum()) / max(len(bn), 1)
    return float(thre), float(highest), percent_limit


def obtain_filters_mask(net: NetworkIR, params, thre: float, cbl_idx,
                        prune_idx, *, layer_keep: float = 0.0,
                        filter_multiple: int = 1, min_top: int = 0):
    """Per-layer channel masks from the gamma threshold.

    layer_keep: per-layer minimum keep fraction. filter_multiple: snap the
    remaining channels up to a multiple; min_top: keep at least the top-k
    channels if everything is pruned. Returns ({idx: mask},
    {idx: n_remaining}).
    """
    masks, filters = {}, {}
    for idx in cbl_idx:
        gamma = np.abs(_np(params[str(idx)]['gamma']))
        ch = gamma.shape[0]
        if idx in prune_idx:
            # >= : channels at exactly the threshold are kept
            mask = (gamma >= thre).astype(np.float32)
            min_keep = max(int(ch * layer_keep), 1) if layer_keep > 0 else 0
            remain = int(mask.sum())
            if filter_multiple > 1:
                target = remain
                if target % filter_multiple:
                    target = min(ch, ((target // filter_multiple) + 1)
                                 * filter_multiple)
                target = max(target, min_top or filter_multiple)
                target = min(target, ch)
                top = np.argsort(-gamma)[:target]
                mask = np.zeros(ch, np.float32)
                mask[top] = 1.0
            elif remain < min_keep:
                top = np.argsort(-gamma)[:min_keep]
                mask[top] = 1.0
            elif remain == 0:
                if min_top:
                    top = np.argsort(-gamma)[:min_top]
                    mask[top] = 1.0
                else:
                    raise RuntimeError(
                        f'layer {idx}: all channels would be pruned')
        else:
            mask = np.ones(ch, np.float32)
        masks[idx] = mask
        filters[idx] = int(mask.sum())
    return masks, filters


def _nearest_multiple(num: int, base: int) -> int:
    down = num % base
    up = base - down
    return num + up if down >= up else num - down


def merge_masks_across_shortcuts(net: NetworkIR, masks, filters, base: int = 1):
    """Union of the masks along every shortcut chain; base>1 snaps the
    union's count to a multiple."""
    L = net.layers
    visited: set[int] = set()
    for i in range(len(L) - 1, -1, -1):
        if L[i].kind != 'shortcut' or i in visited:
            continue
        chain_masks = []
        members: list[int] = []
        j = i
        while L[j].kind == 'shortcut':
            visited.add(j)
            if L[j - 1].kind == 'conv' and L[j - 1].bn:
                chain_masks.append(masks[j - 1])
                members.append(j - 1)
            j = L[j].layers[0]
            if L[j].kind == 'conv' and L[j].bn:
                chain_masks.append(masks[j])
                members.append(j)
        if not chain_masks:
            continue
        stacked = np.stack(chain_masks, 0)
        summed = stacked.sum(0)
        if base == 1:
            merged = (summed > 0).astype(np.float32)
        else:
            n = int((summed > 0).sum())
            n = max(_nearest_multiple(n, base), base)
            n = min(n, len(summed))
            top = np.argsort(-summed)[:n]
            merged = np.zeros_like(summed)
            merged[top] = 1.0
        for m in members:
            masks[m] = merged
            filters[m] = int(merged.sum())
    return masks, filters


def get_input_mask(net: NetworkIR, idx: int, masks):
    """The input-channel mask of layer ``idx``, composed by walking its
    producers."""
    L = net.layers
    if idx == 0:
        return np.ones(net.in_channels, np.float32)
    prev = L[idx - 1]
    k = prev.kind
    if k == 'conv':
        return masks[idx - 1]
    if k == 'maxpool':
        if L[idx - 2].kind == 'route':       # v4-tiny
            return get_input_mask(net, idx - 1, masks)
        return masks[idx - 2]               # v3-tiny
    if k == 'se':
        return masks[idx - 3]
    if k == 'depthwise':
        return masks[idx - 2]
    if k == 'shortcut':
        return masks[idx - 2]
    if k == 'route':
        srcs = list(prev.layers)
        if len(srcs) == 1:
            m = masks[srcs[0]]
            if prev.route_groups:
                return m[m.shape[0] // 2:]
            return m
        if len(srcs) == 2:
            if L[srcs[1] - 1].kind == 'maxpool':   # tiny topology
                return np.concatenate([masks[srcs[0] - 1], masks[srcs[1]]])
            if L[srcs[0]].kind == 'upsample':
                m1 = masks[srcs[0] - 1]
            else:                                  # conv
                m1 = masks[srcs[0]]
            m2 = (masks[srcs[1]] if L[srcs[1]].kind == 'conv'
                  else masks[srcs[1] - 1])
            return np.concatenate([m1, m2])
        if len(srcs) == 4:                         # spp tail route
            m = masks[srcs[-1]]
            return np.concatenate([m, m, m, m])
        raise ValueError(f'unsupported route fan-in at layer {idx}')
    raise ValueError(f'cannot derive input mask through {k} at layer {idx}')


def bias_compensation(net: NetworkIR, params, state, prune_idx, masks):
    """Mask BN gamma/beta and push the dead channels' constant activations
    into the consumer conv. Returns new host (params, state)."""
    L = net.layers
    params = host_tree(params)
    state = host_tree(state)

    def push_offset(i, activation):
        nxt = i + 1
        if nxt >= len(L) or L[nxt].kind != 'conv':
            return
        conv_sum = hwio(params[str(nxt)]['w']).sum(axis=(0, 1))   # (I, O)
        offset = activation @ conv_sum                             # (O,)
        if L[nxt].bn:
            state[str(nxt)]['mean'] -= offset
        else:
            params[str(nxt)]['b'] += offset

    acts: list[np.ndarray | None] = []
    for i, lyr in enumerate(L):
        k = lyr.kind
        if k in ('conv', 'depthwise', 'se'):
            activation = np.zeros(lyr.filters, np.float32)
            if i in prune_idx:
                mask = masks[i]
                p = params[str(i)]
                p['gamma'] *= mask
                dead = (1.0 - mask) * p['beta']
                fn = _ACT_NP.get(lyr.activation, _ACT_NP['linear'])
                activation = fn(dead).astype(np.float32)
                push_offset(i, activation)
                p['beta'] *= mask
            acts.append(activation)
        elif k == 'shortcut':
            a = acts[i - 1] + acts[lyr.layers[0]]
            push_offset(i, a)
            acts.append(a)
        elif k == 'route':
            srcs = list(lyr.layers)
            parts = [acts[s] if acts[s] is not None
                     else np.zeros(L[s].filters, np.float32) for s in srcs]
            a = np.concatenate(parts) if len(parts) > 1 else parts[0]
            if lyr.route_groups and len(parts) == 1:
                a = a[a.shape[0] // 2:]
            push_offset(i, a)
            acts.append(a)
        elif k == 'upsample':
            acts.append(acts[i - 1])
        elif k == 'maxpool':
            if i + 1 < len(L) and L[i + 1].kind == 'route':
                acts.append(np.zeros(lyr.filters, np.float32))  # spp branch
            else:
                a = acts[i - 1]
                push_offset(i, a)
                acts.append(a)
        else:
            acts.append(np.zeros(lyr.filters, np.float32)
                        if lyr.filters else None)
    return params, state


def compact_network(net: NetworkIR, params, state, cbl_idx, other_idx, masks,
                    filters):
    """The pruned graph and its sliced host arrays (OIHW convs)."""
    new_defs = copy.deepcopy(net.module_defs)
    for idx in cbl_idx:
        assert new_defs[idx + 1]['type'] == 'convolutional'
        new_defs[idx + 1]['filters'] = int(filters[idx])
    compact = build_ir(new_defs, is_gray_scale=(net.in_channels == 1),
                       cfg_name=net.cfg_name)

    new_params: dict = {}
    new_state: dict = {}
    for i, lyr in enumerate(net.layers):
        k = str(i)
        if k not in params and k not in state:
            continue
        if lyr.kind == 'conv' and lyr.bn and i in masks:
            out_idx = np.nonzero(masks[i])[0]
            in_idx = np.nonzero(get_input_mask(net, i, masks))[0]
            p = params[k]
            new_params[k] = {
                'w': _np(p['w'])[out_idx][:, in_idx],
                'gamma': _np(p['gamma'])[out_idx],
                'beta': _np(p['beta'])[out_idx],
            }
            new_state[k] = {
                'mean': _np(state[k]['mean'])[out_idx],
                'var': _np(state[k]['var'])[out_idx],
            }
        elif lyr.kind == 'conv':        # no-BN conv: slice input only
            in_idx = np.nonzero(get_input_mask(net, i, masks))[0]
            p = params[k]
            new_params[k] = {'w': _np(p['w'])[:, in_idx],
                             'b': _np(p['b']).copy()}
        else:                          # depthwise / se / shortcut-w / lone BN
            if k in params:
                new_params[k] = {f: _np(v).copy()
                                 for f, v in params[k].items()}
            if k in state:
                new_state[k] = {f: _np(v).copy()
                                for f, v in state[k].items()}
    return compact, new_params, new_state


def layer_prune_blocks(net: NetworkIR, params, n_shortcuts: int):
    """Rank shortcut blocks by the mean |gamma| of the CBL before the
    shortcut and remove the weakest [idx-1, idx, idx+1] triples, re-indexing
    absolute routes. Returns (prune_shortcut_indices, index_remain,
    compact_module_defs)."""
    _, _, sc_idx = prunable_sets_layer(net)   # CBL indices preceding shortcuts
    means = np.array([np.abs(_np(params[str(i)]['gamma'])).mean()
                      for i in sc_idx])
    order = np.argsort(means)
    prune_sc = [sc_idx[int(j)] for j in order[:n_shortcuts]]

    # triple = [cbl-1, cbl, shortcut]: the block's two convs and the shortcut
    index_prune: list[int] = []
    for c in prune_sc:
        index_prune.extend([c - 1, c, c + 1])
    index_all = list(range(len(net.layers)))
    index_remain = [i for i in index_all if i not in index_prune]

    defs = copy.deepcopy(net.module_defs)
    body = defs[1:]
    for j, md in enumerate(body):
        if md['type'] != 'route':
            continue
        srcs = [int(s) for s in md['layers']]
        if len(srcs) == 1 and srcs[0] > 0:
            srcs[0] -= sum(1 for i in index_prune if i <= srcs[0])
            md['layers'] = srcs
        elif len(srcs) == 2:
            if srcs[1] > 0:
                srcs[1] -= sum(1 for i in index_prune if i <= srcs[1])
            else:
                srcs[1] += sum(1 for i in index_prune
                               if j + srcs[1] < i < j)
            md['layers'] = srcs
    compact_defs = [defs[0]] + [body[i] for i in index_remain]
    return prune_sc, index_remain, compact_defs


def copy_params_subset(net: NetworkIR, params, state, index_remain):
    """Re-key the arrays of the surviving layers to their new indices after
    layer removal (host copies)."""
    remap = {old: new for new, old in enumerate(index_remain)}
    new_params, new_state = {}, {}
    for old, new in remap.items():
        k_old, k_new = str(old), str(new)
        if k_old in params:
            new_params[k_new] = {f: np.array(_np(v))
                                 for f, v in params[k_old].items()}
        if k_old in state:
            new_state[k_new] = {f: np.array(_np(v))
                                for f, v in state[k_old].items()}
    return new_params, new_state


def write_cfg(path, module_defs, anchors_str: str | None = None):
    """Serialise module_defs back to a .cfg file."""
    import os
    os.makedirs(os.path.dirname(str(path)) or '.', exist_ok=True)
    with open(path, 'w') as f:
        for md in module_defs:
            f.write(f"[{md['type']}]\n")
            for key, value in md.items():
                if key in ('type', 'is_access'):
                    continue
                if key == 'anchors' and anchors_str is not None:
                    value = anchors_str
                elif key == 'anchors':
                    value = ', '.join(
                        f'{int(a)},{int(b)}' if float(a).is_integer() else f'{a},{b}'
                        for a, b in np.asarray(value).reshape(-1, 2))
                elif isinstance(value, (list, tuple, np.ndarray)):
                    value = ','.join(str(int(v)) for v in value)
                f.write(f'{key}={value}\n')
            f.write('\n')
    return str(path)
