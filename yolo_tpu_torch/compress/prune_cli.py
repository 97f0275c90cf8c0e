"""Shared CLI driver of the ten prune methods (counterpart of
``yolo_tpu/compress/prune_cli.py``): normal, regular, shortcut, slim,
layer, layer_channel, layer_channel_regular, eagle_normal, eagle_regular
and eagle_slim.

Load the model, evaluate it, prune, evaluate the bias-compensated masked
model (channel methods) and the compact one, time the forward before and
after, print the Before/After table, and write the new .cfg beside the
input cfg and the compact darknet .weights under ``./weights``. The JAX
package's flags, defaults and file names, plus ``--device`` (the card
unless ``--device cpu``).
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..utils.cli import FlexParser

CHANNEL_METHODS = ('normal', 'regular', 'shortcut', 'slim')
METHODS = CHANNEL_METHODS + ('layer', 'layer_channel', 'layer_channel_regular',
                             'eagle_normal', 'eagle_regular', 'eagle_slim')


def build_argparser(extra=()):
    p = FlexParser()
    p.add_argument('--cfg', type=str, default='cfg/yolov3/yolov3.cfg')
    p.add_argument('--data', type=str, default='data_cfg/coco2014.data')
    p.add_argument('--weights', type=str, default='weights/last.npz')
    p.add_argument('--percent', type=float, default=0.5)
    p.add_argument('--layer_keep', type=float, default=0.01)
    p.add_argument('--shortcuts', type=int, default=8)
    p.add_argument('--img-size', type=int, default=416)
    p.add_argument('--batch-size', type=int, default=16)
    p.add_argument('--no-eval', action='store_true',
                   help='skip mAP evaluations (structural prune only)')
    p.add_argument('--device', type=str, default='cuda',
                   help="torch device ('cuda', 'cuda:1', 'cpu')")
    for name, kw in extra:
        p.add_argument(name, **kw)
    return p


def timed_forward(net, params, state, img_size=416, repeat=20, batch=16):
    """Seconds per eval-mode bf16 forward of a zero batch, after one
    warm-up: CUDA events on the card, the host clock on the CPU. The
    weights are already on their device; only the forwards are timed."""
    from ..runtime import ModelBundle
    from .prune_drivers import device_of
    device = device_of(params)
    model = ModelBundle(net=net, params=params, state=state,
                        device=device).model()
    x = torch.zeros((batch, img_size, img_size, net.in_channels),
                    dtype=torch.float32, device=device)
    with torch.inference_mode():
        model(x)
        if device.type != 'cuda':
            t0 = time.perf_counter()
            for _ in range(repeat):
                model(x)
            return (time.perf_counter() - t0) / repeat
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(repeat):
            model(x)
        end.record()
        end.synchronize()
    return start.elapsed_time(end) / 1e3 / repeat


def run_prune_cli(method: str, argv=None):
    """``method`` is one of ``METHODS``; returns the ``PruneResult``."""
    if method not in METHODS:
        raise ValueError(f'unknown prune method {method!r}; one of {METHODS}')
    extra = []
    if method.startswith('eagle'):
        extra = [('--remain-ratio', dict(type=float, default=0.5)),
                 ('--delta', dict(type=float, default=0.02)),
                 ('--number', dict(type=int, default=10))]
    opt = build_argparser(extra).parse_args(argv)

    from ..eval.evaluator import evaluate
    from ..models.darknet_io import save_darknet_weights
    from ..runtime import load_model
    from .prune import write_cfg
    from .prune_drivers import (channel_prune, eagle_eye_prune, layer_prune,
                                layer_channel_prune)

    bundle = load_model(opt.cfg, opt.weights, device=opt.device)
    net, params, state = bundle.net, bundle.params, bundle.state

    def eval_fn(n, p, s):
        if opt.no_eval:
            return (0,) * 7, np.zeros(1), (0, 0)
        return evaluate(n, p, s, opt.data, batch_size=opt.batch_size,
                        img_size=opt.img_size, device=opt.device)

    print("evaluating the original model...")
    before = eval_fn(net, params, state)

    if method in CHANNEL_METHODS:
        res = channel_prune(net, params, state, method=method,
                            percent=opt.percent, layer_keep=opt.layer_keep,
                            img_size=opt.img_size)
        print('evaluating the bias-compensated masked model...')
        eval_fn(net, res.loose_params, res.loose_state)
    elif method == 'layer':
        res = layer_prune(net, params, state, n_shortcuts=opt.shortcuts,
                          img_size=opt.img_size)
    elif method in ('layer_channel', 'layer_channel_regular'):
        res = layer_channel_prune(net, params, state, percent=opt.percent,
                                  layer_keep=opt.layer_keep,
                                  n_shortcuts=opt.shortcuts,
                                  regular=method.endswith('regular'),
                                  img_size=opt.img_size)
    else:  # EagleEye family
        sub = method.split('_', 1)[1]
        recal, evalc = None, None
        if not opt.no_eval:
            def recal(r):
                return r   # adaptive-BN handled by eval-mode running stats

            def evalc(r):
                return eval_fn(r.net, r.params, r.state)[0][2]
        res = eagle_eye_prune(net, params, state,
                              remain_ratio=opt.remain_ratio, delta=opt.delta,
                              candidates=opt.number, img_size=opt.img_size,
                              method=sub, eval_fn=evalc,
                              recalibrate_fn=recal)

    print('evaluating the compact model...')
    after = eval_fn(res.net, res.params, res.state)

    t_before = timed_forward(net, params, state, opt.img_size)
    t_after = timed_forward(res.net, res.params, res.state, opt.img_size)

    rows = [
        ('Metric', 'Before', 'After'),
        ('mAP', f'{before[0][2]:.6f}', f'{after[0][2]:.6f}'),
        ('Parameters', str(res.report['params_before']),
         str(res.report['params_after'])),
        ('MACs', str(res.report['macs_before']), str(res.report['macs_after'])),
        ('Inference', f'{t_before:.4f}', f'{t_after:.4f}'),
    ]
    width = max(len(str(c)) for r in rows for c in r) + 2
    for r in rows:
        print(''.join(str(c).ljust(width) for c in r))

    tag = {'normal': f'normal_prune_{opt.percent}_',
           'regular': f'regular_prune_{opt.percent}_',
           'shortcut': f'shortcut_prune_{opt.percent}_',
           'slim': f'slim_prune_{opt.percent}_',
           'layer': f'layer_prune_{opt.shortcuts}_shortcut_',
           'layer_channel': f'layer_channel_prune_{opt.percent}_{opt.shortcuts}_',
           'layer_channel_regular':
               f'layer_channel_regular_prune_{opt.percent}_{opt.shortcuts}_',
           }.get(method, f'{method}_prune_')
    out_cfg = os.path.join(os.path.dirname(opt.cfg),
                           tag + os.path.basename(opt.cfg))
    write_cfg(out_cfg, res.module_defs)
    print(f'Config file has been saved: {out_cfg}')
    out_w = os.path.join('weights', tag.rstrip('_') + '.weights')
    os.makedirs('weights', exist_ok=True)
    save_darknet_weights(res.net, res.params, res.state, out_w)
    print(f'Compact model has been saved: {out_w}')
    return res
