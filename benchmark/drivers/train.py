"""Training: the step ``run_training`` takes each batch, ``grad_fn`` then
``update_fn`` of ``yolo_tpu_torch.train.trainer.make_train_functions``,
over a pool of batches made on the device from the seed and cycled (the
loader is left out: it is another layer's). The optimizer is fixed:
nesterov SGD (the workload's ``optimizer``: lr, momentum and weight
decay, the decay on the conv kernels alone), one gradient an update, and the EMA of the
parameters and BN statistics on, with its decay ramped as the port
documents (``reference/loss.py`` ``ema_step``).

Set-up builds the one train state the window uses and drives it through
its first ``check.steps`` steps on distinct batches, which also warm up
every shape; the program's readings are taken on the way: each step's
loss, each leaf's first gradient as the optimizer got it (its momentum
after one step, less the weight decay's share), and each leaf's change
over those steps: the parameters, the EMA's leaves and the BN running
statistics. After the window the reference follows the same steps from
the same weights and batches in f32 (``benchmark/compare.py``).

Faults (tests and controls): ``unchanged`` makes ``update_fn`` leave the
state as it is, ``ema`` leaves the EMA as it is, ``bn`` makes ``grad_fn``
leave the BN running statistics as they are, ``half`` drops the second
half of each batch (the loss the mean over the rest), ``control`` trains
the reference in float8 in the program's place.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.profiler import record_function

from benchmark import compare, counts, inputs
from benchmark.common import Context, cfg_path, fp8, nchw, sync
from benchmark.reference import darknet
from benchmark.reference.loss import ema_step, sgd_step, yolo_loss

RANGES = ('grad_fn', 'update_fn')


class State:
    pass


def _scalars(wl):
    o = wl['optimizer']
    return o['lr'], o['weight_decay'], o['momentum']


def _norms(now, before, keys=None):
    return {k: float((now[k].detach().float() - before[k]).norm())
            for k in (keys or before)}


def _leaves(params):
    return {f'{k}.{f}': t for k, d in params.items() for f, t in d.items()}


def _decay(wl):
    """A leaf's weight decay: the conv kernels' group alone has one."""
    wd = wl['optimizer']['weight_decay']
    return lambda field: wd if field == 'w' else 0.0


class Reference:
    """The train step in plain PyTorch on f32 copies of the weights and BN
    running statistics, with the EMA of both, optionally with float8 conv
    operands (``cast``)."""

    def __init__(self, s, cast=None, start=None):
        hyp = s.wl['hyp']
        if (hyp['cls_pw'], hyp['obj_pw'], hyp['fl_gamma'],
                hyp['smooth_eps']) != (1.0, 1.0, 0.0, 0.0):
            raise ValueError('the reference loss has no positive weights, '
                             'focal term or label smoothing')
        self.s, self.cast = s, cast
        start = start or {'params': _leaves(s.params),
                          'running': _leaves(s.state), 'momenta': {},
                          'updates': 0}
        self.params = {k: v.detach().clone().requires_grad_(True)
                       for k, v in start['params'].items()}
        self.running = {k: v.clone() for k, v in start['running'].items()}
        self.ema = {k: v.detach().clone() for k, v in start.get(
            'ema', {**self.params, **self.running}).items()}
        self.momenta = {k: v.clone() for k, v in start['momenta'].items()}
        self.grads, self.updates = {}, start['updates']

    def tree(self):
        out = {}
        for key, t in self.params.items():
            k, f = key.split('.')
            out.setdefault(k, {})[f] = t
        return out

    def grad(self, x_nchw, tgt):
        s = self.s
        stats = {}
        heads = darknet.forward_train(s.layers, self.tree(), x_nchw,
                                      self.cast, stats)
        loss = yolo_loss(heads, s.layers, tgt, s.wl['hyp'], s.size)[3]
        (loss * s.loss_scale).backward()
        self.grads = {k: p.grad for k, p in self.params.items()}
        mom = darknet.BN_MOMENTUM
        for k, d in stats.items():
            for f, t in d.items():
                r = self.running[f'{k}.{f}']
                r.mul_(1.0 - mom).add_(t, alpha=mom)
        return loss.detach()

    def update(self):
        wl = self.s.wl
        sgd_step(self.params, self.grads, self.momenta,
                 lambda f: wl['optimizer']['lr'], _decay(wl),
                 wl['optimizer']['momentum'])
        self.updates += 1
        ema_step(self.ema, {**self.params, **self.running}, self.updates)
        for p in self.params.values():
            p.grad = None


def setup(ctx: Context):
    from yolo_tpu_torch.ir import build_ir
    from yolo_tpu_torch.train.loss import LossHyp
    from yolo_tpu_torch.train.optim import PerGroupScalars
    from yolo_tpu_torch.train.trainer import (init_train_state,
                                              make_train_functions)
    s = State()
    s.ctx, s.wl, s.dev = ctx, ctx.workload, ctx.device
    cf = ctx.config
    s.form = cf['forms'][s.wl['form']]
    s.layers = darknet.build(cf['darknet_cfg'])
    s.size, s.bs, n_pool = cf['img_size'], s.wl['batch'], s.wl['pool']
    s.loss_scale = s.bs / 64.0
    s.params, s.state = inputs.weights(s.layers, ctx.seed, s.form['init'],
                                       s.dev)
    nc = s.layers[-1].nc
    s.x = [nchw(inputs.images(ctx.seed * 16 + k, s.bs, s.size, s.dev))
           .permute(0, 2, 3, 1).contiguous() for k in range(n_pool)]
    cap = s.wl['targets']['most'] * s.bs
    s.targets = []
    for k in range(n_pool):
        t = inputs.targets(ctx.seed, k, s.bs, nc, s.wl['targets']['mean_extra'],
                           s.wl['targets']['most'])
        padded = np.zeros((cap, 6), np.float32)
        padded[:len(t)] = t
        valid = np.arange(cap) < len(t)
        s.targets.append((torch.from_numpy(padded).to(s.dev),
                          torch.from_numpy(valid).to(s.dev)))
    lr, wd, mu = _scalars(s.wl)
    n_check = s.wl['check']['steps']
    if ctx.fault == 'control':
        ref = Reference(s, fp8)

        def grad_fn(ts, x, tgt, valid, gr, scale):
            return ts, ref.grad(x.permute(0, 3, 1, 2), tgt[valid])

        def update_fn(ts, sc):
            ref.update()
            return ts
        s.ts = None
        s.momentum = lambda: ref.momenta
        s.current = lambda: ref.params
        s.averaged = lambda: ref.ema
        s.running = lambda: ref.running
        s.updates = lambda: ref.updates
    else:
        net = build_ir(cfg_path(ctx))
        anchors = [np.asarray(l.anchors) / l.yolo_stride
                   for l in net.layers if l.kind == 'yolo']
        grad_fn, update_fn = make_train_functions(
            net, anchors, nc, LossHyp(**s.wl['hyp']))
        s.ts = init_train_state(net, s.params, s.state,
                                compute_dtype=getattr(torch, s.form['dtype']),
                                device=s.dev)
        opt = s.ts.optimizer
        s.momentum = lambda: {f'{k}.{f}': opt.state[p].get(
                                  'momentum_buffer', torch.zeros_like(p))
                              for g in opt.param_groups
                              for p, (k, f) in zip(g['params'], g['keys'])}
        s.current = lambda: _leaves(s.ts.params)
        s.averaged = lambda: {**_leaves(s.ts.ema.params),
                              **_leaves(s.ts.ema.state)}
        s.running = lambda: _leaves(s.ts.bn_state)
        s.updates = lambda: int(s.ts.ema.updates)
    s.grad_fn, s.update_fn = _broken(grad_fn, update_fn, ctx.fault, s.bs)
    s.scalars = PerGroupScalars(lr=(lr,) * 4, weight_decay=(wd, 0.0, 0.0, 0.0),
                                momentum=mu)
    s.events = {'grad_fn': [], 'update_fn': []}
    s.timed = False
    losses = []
    decay = _decay(s.wl)
    p0, st0 = _leaves(s.params), _leaves(s.state)
    for i in range(n_check):
        losses.append(_step(s, i))
        if i == 0:
            s.prog = {'grad': {k: float((v - decay(k.split('.')[1]) * p0[k])
                                        .norm()) / s.loss_scale
                               for k, v in s.momentum().items()}}
    s.prog.update(change=_norms(s.current(), p0),
                  ema=_norms(s.averaged(), {**p0, **st0}),
                  bn=_norms(s.running(), st0),
                  loss=[float(l) for l in losses])
    s.offset, s.next = n_check, 0
    s.timed = ctx.trace
    return s


def _kept(trees_of):
    """A wrapper that restores the leaves of ``trees_of(ts)`` after a
    call."""
    def leaves(ts):
        return [t for tree in trees_of(ts) for t in _leaves(tree).values()]

    def wrap(fn):
        def kept(ts, *args):
            before = [t.clone() for t in leaves(ts)]
            out = fn(ts, *args)
            with torch.no_grad():
                for t, b in zip(leaves(ts), before):
                    t.copy_(b)
            return out
        return kept
    return wrap


def _broken(grad_fn, update_fn, fault, bs):
    if fault == 'unchanged':
        return grad_fn, lambda ts, sc: ts
    if fault == 'ema':
        return grad_fn, _kept(lambda ts: (ts.ema.params,
                                          ts.ema.state))(update_fn)
    if fault == 'bn':
        return _kept(lambda ts: (ts.bn_state,))(grad_fn), update_fn
    if fault == 'half':
        def half(ts, x, tgt, valid, gr, scale):
            keep = valid & (tgt[:, 0] < bs // 2)
            return grad_fn(ts, x[:bs // 2], tgt, keep, gr, scale)
        return half, update_fn
    return grad_fn, update_fn


def _step(s, i):
    k = i % len(s.x)
    tgt, valid = s.targets[k]
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)] \
        if s.timed and s.dev.type == 'cuda' else None
    if ev:
        ev[0].record()
    with record_function('grad_fn'):
        s.ts, items = s.grad_fn(s.ts, s.x[k], tgt, valid, 1.0, s.loss_scale)
    if ev:
        ev[1].record()
    with record_function('update_fn'):
        s.ts = s.update_fn(s.ts, s.scalars)
    if ev:
        ev[2].record()
        s.events['grad_fn'].append((ev[0], ev[1]))
        s.events['update_fn'].append((ev[1], ev[2]))
    return items[3] if items.dim() else items


def step(s, i):
    _step(s, s.offset + i)
    s.next = i + 1
    return s.bs


def finish(s):
    sync(s.dev)


def end_to_end(window):
    return {'train_images_per_s': window['items'] / window['seconds'],
            'setup_s': window['setup_s']}


def record(s, window):
    convs = darknet.macs(s.layers, s.size)
    return {'driver': 'train', 'bs': s.bs,
            # a forward and the two products of its backward
            'conv_ops': 3 * counts.conv_ops(convs, s.bs),
            'peak_ops_per_s': counts.BF16_OPS_PER_S,
            'events_ms': {n: [a.elapsed_time(b) for a, b in v]
                          for n, v in s.events.items()}}


def _readings(loss, grad, now, start):
    """A step's loss, first gradient norms and changes from ``start``."""
    return {'loss': [float(loss)], 'grad': grad,
            'change': _norms(now['params'], start['params']),
            'ema': _norms(now['ema'], start['ema']),
            'bn': _norms(now['running'], start['running'])}


def _late_step(s):
    """One more step through the window's calls on the state the window
    left, after a snapshot of that state; the program's readings."""
    def snap(d):
        return {k: v.detach().float().clone() for k, v in d.items()}
    start = {'params': snap(s.current()), 'momenta': snap(s.momentum()),
             'running': snap(s.running()), 'ema': snap(s.averaged()),
             'updates': s.updates()}
    s.timed = False
    i = s.offset + s.next
    loss = _step(s, i)
    decay, mu = _decay(s.wl), s.wl['optimizer']['momentum']
    p0, v0 = start['params'], start['momenta']
    # the momentum's step, less its carried part and the weight decay's
    grad = {k: float((v.float() - mu * v0[k] - decay(k.split('.')[1]) * p0[k])
                     .norm()) / s.loss_scale
            for k, v in s.momentum().items()}
    now = {'params': s.current(), 'ema': s.averaged(),
           'running': s.running()}
    return i % len(s.x), start, _readings(loss, grad, now, start)


def check(s):
    """The first steps again in the reference, after the program is
    freed; its loss, first gradients and change held to the program's.
    Then the step after the window (``late_*``): the program takes one
    more step on the state the window left, and the reference follows it
    from a snapshot of that state, the program's own."""
    k, start, late = _late_step(s)
    s.ts = s.grad_fn = s.update_fn = None
    s.momentum = s.current = s.averaged = s.running = s.updates = None
    if s.dev.type == 'cuda':
        torch.cuda.empty_cache()
    ref = Reference(s)
    p0, st0 = _leaves(s.params), _leaves(s.state)
    want = {'loss': []}
    for i in range(s.wl['check']['steps']):
        tgt, valid = s.targets[i]
        want['loss'].append(float(ref.grad(s.x[i].permute(0, 3, 1, 2),
                                           tgt[valid])))
        if i == 0:
            want['grad'] = {k: float(g.norm()) / s.loss_scale
                            for k, g in ref.grads.items()}
        ref.update()
    want.update(change=_norms(ref.params, p0),
                ema=_norms(ref.ema, {**p0, **st0}),
                bn=_norms(ref.running, st0))
    got = compare.training(s.prog, want)
    ref = Reference(s, start=start)
    tgt, valid = s.targets[k]
    loss = ref.grad(s.x[k].permute(0, 3, 1, 2), tgt[valid])
    grad = {n: float(g.norm()) / s.loss_scale for n, g in ref.grads.items()}
    ref.update()
    now = {'params': ref.params, 'ema': ref.ema, 'running': ref.running}
    got.update({f'late_{n}': v for n, v in compare.training(
        late, _readings(loss, grad, now, start)).items()})
    lim = s.wl['check']['limits']
    return {n: (v, lim.get(n)) for n, v in got.items()}
