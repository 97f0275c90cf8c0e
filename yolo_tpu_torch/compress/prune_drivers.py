"""High-level pruning drivers (counterpart of
``yolo_tpu/compress/prune_drivers.py``): the channel methods (normal,
regular, shortcut, slim, slim_regular), shortcut-block removal, the two
combined, and EagleEye's random search, each as one call.

Each driver takes the port's (params, state), tensors on any device, works
on one host numpy copy of them (``prune.host_tree``) and returns a
``PruneResult`` whose ``params``/``state`` (and ``loose_params``/
``loose_state``) are tensors on the device of the input, ready for
``evaluate``, ``ModelBundle`` and ``save_darknet_weights``. The masks stay
host numpy. The results are bit-equal to the JAX package's on the same
weights; EagleEye draws its rates from the caller's ``np.random.Generator``
in the JAX package's order.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np
import torch

from ..ir import NetworkIR, build_ir
from ..utils.profiling import count_macs, count_params
from . import prune as P


@dataclass
class PruneResult:
    net: NetworkIR
    params: Any
    state: Any
    masks: dict
    module_defs: list
    report: dict = field(default_factory=dict)
    # the bias-compensated (masked, same-size) weights, for no-finetune eval
    loose_params: Any = None
    loose_state: Any = None


def device_of(params) -> torch.device:
    """The device of the first tensor in ``params`` (the CPU for arrays)."""
    for d in params.values():
        for v in d.values():
            if torch.is_tensor(v):
                return v.device
    return torch.device('cpu')


def _to_device(tree, device) -> dict:
    return {k: {f: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                for f, v in d.items()} for k, d in tree.items()}


def _result(device, net, params, state, masks, report, loose=None):
    loose_params = loose_state = None
    if loose is not None:
        loose_params, loose_state = (_to_device(t, device) for t in loose)
    return PruneResult(net=net, params=_to_device(params, device),
                       state=_to_device(state, device), masks=masks,
                       module_defs=net.module_defs, report=report,
                       loose_params=loose_params, loose_state=loose_state)


def channel_prune(net: NetworkIR, params, state, *, method: str = 'normal',
                  percent: float = 0.5, layer_keep: float = 0.01,
                  img_size: int = 416) -> PruneResult:
    """Channel pruning family.

    method:
      'normal'   — global-percent threshold, shortcut-adjacent convs skipped
      'regular'  — + per-layer channel counts snapped up to 32-multiples,
                   top-8 floor
      'shortcut' — prunes through shortcuts, linked layers copy their
                   partner's mask
      'slim'     — per-layer layer_keep floor + mask union across each
                   shortcut chain
      'slim_regular' — slim with 32-multiple snapping in the merge
    """
    device = device_of(params)
    params, state = P.host_tree(params), P.host_tree(state)
    if method in ('normal', 'regular'):
        sets = P.prunable_sets_normal(net)
    else:
        sets = P.prunable_sets_shortcut(net)

    thre, highest, percent_limit = P.global_threshold(params, sets.prune_idx,
                                                      percent)
    info = {'threshold': thre, 'highest_safe_threshold': highest,
            'percent_limit': percent_limit}

    if method == 'normal':
        masks, filters = P.obtain_filters_mask(net, params, thre,
                                               sets.cbl_idx, sets.prune_idx)
    elif method == 'regular':
        masks, filters = P.obtain_filters_mask(
            net, params, thre, sets.cbl_idx, sets.prune_idx,
            filter_multiple=32, min_top=8)
    elif method == 'shortcut':
        masks, filters = _shortcut_linked_masks(net, params, thre, sets)
    else:  # slim / slim_regular
        masks, filters = P.obtain_filters_mask(
            net, params, thre, sets.cbl_idx, sets.prune_idx,
            layer_keep=layer_keep)
        base = 32 if method == 'slim_regular' else 1
        masks, filters = P.merge_masks_across_shortcuts(net, masks, filters,
                                                        base=base)

    loose_params, loose_state = P.bias_compensation(net, params, state,
                                                    sets.prune_idx, masks)
    compact, cp, cs = P.compact_network(net, loose_params, loose_state,
                                        sets.cbl_idx, sets.other_idx, masks,
                                        filters)

    report = _report(net, compact, img_size)
    report.update(info)
    return _result(device, compact, cp, cs, masks, report,
                   loose=(loose_params, loose_state))


def _shortcut_linked_masks(net, params, thre, sets: P.PruneSets):
    """Per-layer thresholds; layers linked via shortcut_idx copy their
    partner's mask."""
    masks, filters = {}, {}
    linked: dict[int, np.ndarray] = {}
    for idx in sets.cbl_idx:
        gamma = np.abs(params[str(idx)]['gamma'])
        if idx in sets.prune_idx:
            if idx not in sets.shortcut_idx:
                mask = (gamma > thre).astype(np.float32)
                linked[idx] = mask
            else:
                mask = linked[sets.shortcut_idx[idx]]
                linked[idx] = mask
            if mask.sum() == 0:
                raise RuntimeError(f'layer {idx}: all channels pruned')
        else:
            mask = np.ones_like(gamma, dtype=np.float32)
        masks[idx] = mask
        filters[idx] = int(mask.sum())
    return masks, filters


def layer_prune(net: NetworkIR, params, state, *, n_shortcuts: int = 8,
                img_size: int = 416) -> PruneResult:
    """Remove the weakest shortcut blocks and copy the surviving layers'
    weights to their new indices."""
    device = device_of(params)
    params, state = P.host_tree(params), P.host_tree(state)
    prune_sc, index_remain, compact_defs = P.layer_prune_blocks(
        net, params, n_shortcuts)
    compact = build_ir(compact_defs, is_gray_scale=(net.in_channels == 1),
                       cfg_name=net.cfg_name)
    cp, cs = P.copy_params_subset(net, params, state, index_remain)
    report = _report(net, compact, img_size)
    report['pruned_shortcuts'] = prune_sc
    return _result(device, compact, cp, cs, {}, report)


def layer_channel_prune(net: NetworkIR, params, state, *,
                        percent: float = 0.5, layer_keep: float = 0.01,
                        n_shortcuts: int = 8, regular: bool = False,
                        img_size: int = 416) -> PruneResult:
    """slim channel masks + shortcut-block removal + one compact slice.

    Masks are computed and bias-compensated on the full graph, the layer
    triples are removed next, and the channels are sliced once on the
    post-removal topology: slicing twice would mis-align input channels
    where a removed block re-wires producers.
    """
    device = device_of(params)
    params, state = P.host_tree(params), P.host_tree(state)
    sets = P.prunable_sets_shortcut(net)
    thre, _, _ = P.global_threshold(params, sets.prune_idx, percent)
    masks, filters = P.obtain_filters_mask(
        net, params, thre, sets.cbl_idx, sets.prune_idx, layer_keep=layer_keep)
    masks, filters = P.merge_masks_across_shortcuts(
        net, masks, filters, base=32 if regular else 1)

    loose_params, loose_state = P.bias_compensation(net, params, state,
                                                    sets.prune_idx, masks)

    prune_sc, index_remain, compact_defs = P.layer_prune_blocks(
        net, loose_params, n_shortcuts)
    params_r, state_r = P.copy_params_subset(net, loose_params, loose_state,
                                             index_remain)
    mid = build_ir(compact_defs, is_gray_scale=(net.in_channels == 1),
                   cfg_name=net.cfg_name)

    remap = {old: new for new, old in enumerate(index_remain)}
    masks_n = {remap[i]: m for i, m in masks.items() if i in remap}
    filters_n = {remap[i]: f for i, f in filters.items() if i in remap}
    cbl_n = [i for i, l in enumerate(mid.layers) if l.kind == 'conv' and l.bn]
    other_n = [i for i, l in enumerate(mid.layers)
               if (l.kind == 'conv' and not l.bn) or l.kind in ('depthwise', 'se')]
    for i in cbl_n:      # every CBL needs a mask entry
        masks_n.setdefault(i, np.ones(mid.layers[i].filters, np.float32))
        filters_n.setdefault(i, mid.layers[i].filters)

    compact, cp, cs = P.compact_network(mid, params_r, state_r, cbl_n,
                                        other_n, masks_n, filters_n)
    report = _report(net, compact, img_size)
    report['pruned_shortcuts'] = prune_sc
    return _result(device, compact, cp, cs, masks, report,
                   loose=(loose_params, loose_state))


def eagle_eye_prune(net: NetworkIR, params, state, *, remain_ratio: float = 0.5,
                    delta: float = 0.02, candidates: int = 10,
                    img_size: int = 416, rng=None,
                    recalibrate_fn: Callable | None = None,
                    eval_fn: Callable | None = None,
                    method: str = 'normal', layer_keep: float = 0.01,
                    max_tries: int = 200) -> PruneResult:
    """EagleEye random search:

    1. draw random per-layer prune rates, mask channels by the L1 of the
       conv filters;
    2. keep candidates whose compact-model MACs ratio is within
       remain_ratio +/- delta;
    3. ``recalibrate_fn(result)`` (adaptive BN) if given;
    4. pick the best ``eval_fn(result) -> mAP`` of ``candidates`` survivors.

    With no eval callback the first feasible candidate is returned
    (structural search only). ``method`` selects the mask post-processing
    (normal / regular / slim). Each candidate is a ``PruneResult`` on the
    device of the input.
    """
    rng = np.random.default_rng() if rng is None else rng
    device = device_of(params)
    params, state = P.host_tree(params), P.host_tree(state)
    if method in ('normal', 'regular'):
        sets = P.prunable_sets_normal(net)
    else:
        sets = P.prunable_sets_shortcut(net)
    origin_macs = count_macs(net, img_size)
    # each filter's L1 in the JAX package's reduction order (HWIO), and its
    # ranking, are the same for every draw
    order = {idx: np.argsort(-np.abs(P.hwio(params[str(idx)]['w']))
                             .sum(axis=(0, 1, 2)))
             for idx in sets.prune_idx}

    best, best_map = None, -1.0
    found = 0
    tries = 0
    while found < candidates and tries < max_tries:
        tries += 1
        masks, filters = {}, {}
        for idx in sets.cbl_idx:
            ch = params[str(idx)]['w'].shape[0]            # OIHW
            mask = np.ones(ch, np.float32)
            if idx in sets.prune_idx:
                rate = rng.uniform(0.0, 1.0)
                n_retain = max(int(ch * (1 - rate)), 1)
                mask = np.zeros(ch, np.float32)
                mask[order[idx][:n_retain]] = 1.0
            masks[idx] = mask
            filters[idx] = int(mask.sum())
        if method == 'regular':
            for idx in sets.prune_idx:
                n = filters[idx]
                ch = len(masks[idx])
                if n % 32:
                    n = min(ch, (n // 32 + 1) * 32)
                masks[idx] = np.zeros(ch, np.float32)
                masks[idx][order[idx][:n]] = 1.0
                filters[idx] = n
        elif method == 'slim':
            masks, filters = P.merge_masks_across_shortcuts(net, masks, filters)

        # structural feasibility: MACs gate
        defs = copy.deepcopy(net.module_defs)
        for idx in sets.cbl_idx:
            defs[idx + 1]['filters'] = int(filters[idx])
        cand_ir = build_ir(defs, is_gray_scale=(net.in_channels == 1),
                           cfg_name=net.cfg_name)
        ratio = count_macs(cand_ir, img_size) / origin_macs
        if not (remain_ratio - delta <= ratio <= remain_ratio + delta):
            continue
        found += 1

        # EagleEye masks gamma AND beta, with no bias compensation
        masked_params = {k: {f: v.copy() for f, v in d.items()}
                         for k, d in params.items()}
        for idx in sets.prune_idx:
            masked_params[str(idx)]['gamma'] *= masks[idx]
            masked_params[str(idx)]['beta'] *= masks[idx]

        compact, cp, cs = P.compact_network(net, masked_params, state,
                                            sets.cbl_idx, sets.other_idx,
                                            masks, filters)
        result = _result(device, compact, cp, cs, masks,
                         _report(net, compact, img_size))
        result.report['macs_ratio'] = ratio
        if recalibrate_fn is not None:
            result = recalibrate_fn(result) or result
        if eval_fn is None:
            return result
        m = float(eval_fn(result))
        if m > best_map:
            best, best_map = result, m
    if best is None:
        raise RuntimeError('EagleEye: no candidate within MACs gate '
                           f'({tries} tries)')
    best.report['best_map'] = best_map
    best.report['candidates_evaluated'] = found
    return best


def _report(before: NetworkIR, after: NetworkIR, img_size) -> dict:
    return {
        'params_before': count_params(before),
        'params_after': count_params(after),
        'macs_before': count_macs(before, img_size),
        'macs_after': count_macs(after, img_size),
    }
