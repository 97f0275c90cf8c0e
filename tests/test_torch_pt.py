"""``.pt`` interchange of the port (``models/torch_import.py``, and the
``.pt``, ``prefer_ema`` and ``pt`` arguments of ``runtime.load_model``)
against the JAX package's, on the CPU.

Checkpoints are written here by the code under test (no session has
network access): by JAX's ``save_torch_checkpoint`` and read by the port,
by the port's and read by JAX, and, for a quantized model, as the PyTorch
reference lays out a BN-fold quantized model with its range trackers.
"""

import numpy as np
import pytest
import torch

from _torch_port import TOY_CFG, random_jax_weights

MOBILE = 'yolov3tiny-mobilenet-small/yolov3tiny-mobilenet-small-coco.cfg'


@pytest.fixture(scope='module')
def cfgs(tmp_path_factory, repo_root):
    p = tmp_path_factory.mktemp('ptcfg') / 'toy.cfg'
    p.write_text(TOY_CFG)
    return {'toy': str(p), 'mobilenet': f'{repo_root}/cfg/{MOBILE}'}


def _assert_trees_equal(got, want, what=''):
    """Port tensors ``got`` against a tree of port tensors ``want``."""
    assert got.keys() == want.keys(), what
    for k in want:
        if isinstance(want[k], dict):
            _assert_trees_equal(got[k], want[k], f'{what}/{k}')
        else:
            assert torch.equal(got[k], want[k]), f'{what}/{k}'


def _init(net, seed):
    from yolo_tpu_torch.models.network import init_params
    return init_params(net, torch.Generator().manual_seed(seed))


@pytest.mark.parametrize('name', ['toy', 'mobilenet'])
def test_jax_pt_loads_in_port(name, cfgs, tmp_path):
    """A .pt from JAX's ``save_torch_checkpoint`` (the toy: conv+BN, a
    plain conv with bias, weighted shortcuts; the mobilenet: depthwise
    convs, SE fcs) loads equal to ``from_jax`` of the same pytrees, with
    JAX's meta."""
    from yolo_tpu.models.torch_import import load_torch_checkpoint as jload
    from yolo_tpu.models.torch_import import save_torch_checkpoint as jsave
    from yolo_tpu_torch.convert import from_jax
    from yolo_tpu_torch.ir import build_ir
    from yolo_tpu_torch.models.torch_import import load_torch_checkpoint
    net = build_ir(cfgs[name])
    pj, sj = random_jax_weights(net, seed=3)
    path = tmp_path / 'jax.pt'
    jsave(net, pj, sj, path, epoch=7, best_fitness=0.25,
          training_results='r')
    p0, s0 = _init(net, 1)
    got_p, got_s, qs, meta = load_torch_checkpoint(net, p0, s0, path)
    want_p, want_s = from_jax(net, pj, sj)
    _assert_trees_equal(got_p, want_p, 'params')
    _assert_trees_equal(got_s, want_s, 'state')
    assert qs is None
    assert meta == jload(net, pj, sj, path)[3] == {
        'epoch': 7, 'best_fitness': 0.25, 'training_results': 'r'}


@pytest.mark.parametrize('name', ['toy', 'mobilenet'])
def test_port_pt_loads_in_jax(name, cfgs, tmp_path):
    """The reverse: the port's ``save_torch_checkpoint`` read by JAX's
    loader gives the pytrees ``to_jax`` gives; a DDP-prefixed bare
    state_dict of the same file loads the same in the port."""
    from yolo_tpu.models.torch_import import load_torch_checkpoint as jload
    from yolo_tpu_torch.convert import to_jax
    from yolo_tpu_torch.ir import build_ir
    from yolo_tpu_torch.models.torch_import import (load_torch_checkpoint,
                                                    save_torch_checkpoint)
    net = build_ir(cfgs[name])
    pt, st = _init(net, 2)
    path = tmp_path / 'port.pt'
    save_torch_checkpoint(net, pt, st, path, epoch=3)
    pj0, sj0 = random_jax_weights(net, seed=9)
    got_p, got_s, _, meta = jload(net, pj0, sj0, path)
    want_p, want_s = to_jax(net, pt, st)
    for got, want in ((got_p, want_p), (got_s, want_s)):
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].keys() == want[k].keys(), k
            for f in want[k]:
                np.testing.assert_array_equal(np.asarray(got[k][f]),
                                              want[k][f])
    assert meta['epoch'] == 3
    sd = torch.load(path, weights_only=False)['model']
    bare = tmp_path / 'bare.pt'
    torch.save({f'module.{k}': v for k, v in sd.items()}, bare)
    p2, s2, _, meta2 = load_torch_checkpoint(net, *_init(net, 5), bare)
    _assert_trees_equal(p2, pt, 'params')
    _assert_trees_equal(s2, st, 'state')
    assert meta2 == {'epoch': -1, 'best_fitness': 0.0, 'training_results': ''}


def _reference_quant_state_dict(net, params, state, qstate):
    """A state_dict laid out as the PyTorch reference's BN-fold quantized
    model: BN tensors on the conv module, its three range trackers, the
    shortcut and concat requant buffers."""
    sd = {}
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32).copy())
    for lyr in net.layers:
        k, pre = str(lyr.index), f'module_list.{lyr.index}'
        if lyr.kind in ('conv', 'depthwise'):
            base = f'{pre}.Conv2d'
            p = params[k]
            sd[f'{base}.weight'] = t(np.asarray(p['w']).transpose(3, 2, 0, 1))
            if 'b' in p:
                sd[f'{base}.bias'] = t(p['b'])
            if lyr.bn:
                sd[f'{base}.gamma'], sd[f'{base}.beta'] = t(p['gamma']), t(
                    p['beta'])
                sd[f'{base}.running_mean'] = t(state[k]['mean'])
                sd[f'{base}.running_var'] = t(state[k]['var'])
            qs = qstate[k]
            for ours, theirs, fk in (('aq', 'activation_quantizer', 'first_a'),
                                     ('wq', 'weight_quantizer', 'first_w'),
                                     ('bq', 'bias_quantizer', 'first_w')):
                q = f'{base}.{theirs}'
                sd[f'{q}.range_tracker.min_val'] = t(qs[ours]['min'])
                sd[f'{q}.range_tracker.max_val'] = t(qs[ours]['max'])
                sd[f'{q}.range_tracker.{fk}'] = t(qs[ours]['first'])
                sd[f'{q}.scale'] = t([qs[ours]['scale']])
                sd[f'{q}.zero_point'] = t([qs[ours]['zp']])
                sd[f'{q}.step'] = t(qs[ours]['step'])
            sd[f'{base}.first_bn'] = t([qs['first_bn']])
            sd[f'{base}.step'] = t(qs['step'])
        elif lyr.kind == 'shortcut' and k in qstate:
            if lyr.weighted:
                sd[f'{pre}.w'] = t(params[k]['w'])
            sd[f'{pre}.scale'] = t([qstate[k]['scale']])
            sd[f'{pre}.input_scale'] = t([qstate[k]['input_scale']])
        elif lyr.kind == 'route' and k in qstate:
            sd[f'{pre}.float_max_list'] = t(qstate[k]['float_max'])
            sd[f'{pre}.scale'] = t([qstate[k]['scale']])
    return sd


def _calibrated_qstate(net):
    """A google qstate of 2 calibration steps (JAX), and its weights."""
    import jax
    import jax.numpy as jnp
    from _torch_port import images
    from yolo_tpu.compress import quant as JQ
    pj, sj = random_jax_weights(net, seed=0)
    cfg = JQ.QuantConfig(steps=100)
    apply = JQ.make_quant_apply(net, cfg, compute_dtype=None)
    step = jax.jit(lambda p, s, q, x: apply(p, s, q, x, True)[1:])
    qs = JQ.init_quant_state(net, cfg)[0]
    x = jnp.asarray(images(1, 1, 64).astype(np.float32) / 256.0)
    for _ in range(2):
        sj, qs = step(pj, sj, qs, x)
    return pj, sj, qs


def test_quantized_pt_restores_qstate_as_jax(cfgs, tmp_path):
    """A reference-layout quantized .pt: ``load_model(quantized=1)`` of the
    port restores the weights, the BN statistics and every tracker, scale,
    step and requant buffer of the google qstate as JAX's ``load_model``
    does."""
    from yolo_tpu import runtime as jrt
    from yolo_tpu.ir import build_ir
    from yolo_tpu_torch import runtime as trt
    from yolo_tpu_torch.convert import from_jax, qstate_from_jax
    net = build_ir(cfgs['toy'])
    pj, sj, qs = _calibrated_qstate(net)
    path = tmp_path / 'quant.pt'
    torch.save({'epoch': 1, 'model': _reference_quant_state_dict(
        net, pj, sj, qs)}, path)
    jb = jrt.load_model(cfgs['toy'], str(path), quantized=1, steps=100)
    tb = trt.load_model(cfgs['toy'], str(path), device='cpu', quantized=1,
                        steps=100)
    want_p, want_s = from_jax(tb.net, jb.params, jb.state)
    _assert_trees_equal(tb.params, want_p, 'params')
    _assert_trees_equal(tb.state, want_s, 'state')
    _assert_trees_equal(tb.qstate, qstate_from_jax(jb.qstate), 'qstate')
    # the restored calibration is the one written
    assert float(tb.qstate['3']['aq']['scale']) == float(qs['3']['aq']['scale'])
    assert float(tb.qstate['3']['step']) == 2.0


def test_load_model_pt_matches_jax(cfgs, tmp_path):
    """``load_model(x.pt)`` of the port serves the model JAX's
    ``load_model(x.pt)`` serves (depthwise and SE weights included)."""
    from yolo_tpu import runtime as jrt
    from yolo_tpu.ir import build_ir
    from yolo_tpu.models.torch_import import save_torch_checkpoint as jsave
    from yolo_tpu_torch import runtime as trt
    from yolo_tpu_torch.convert import from_jax
    net = build_ir(cfgs['mobilenet'])
    pj, sj = random_jax_weights(net, seed=6)
    path = tmp_path / 'm.pth'
    jsave(net, pj, sj, path)
    jb = jrt.load_model(cfgs['mobilenet'], str(path))
    tb = trt.load_model(cfgs['mobilenet'], str(path), device='cpu')
    want_p, want_s = from_jax(tb.net, jb.params, jb.state)
    _assert_trees_equal(tb.params, want_p, 'params')
    _assert_trees_equal(tb.state, want_s, 'state')


def test_prefer_ema_false_loads_the_raw_pair(cfgs, tmp_path):
    """A .npz with both pairs: ``prefer_ema=False`` reads params/state, as
    JAX's does; the default reads ema/ema_state."""
    from yolo_tpu import runtime as jrt
    from yolo_tpu.ir import build_ir
    from yolo_tpu.utils.checkpoint import save_checkpoint
    from yolo_tpu_torch import runtime as trt
    from yolo_tpu_torch.convert import from_jax
    net = build_ir(cfgs['toy'])
    pj, sj = random_jax_weights(net, seed=8)
    ema = {k: {f: a * 0.5 for f, a in d.items()} for k, d in pj.items()}
    ema_state = {k: {f: a + 0.25 for f, a in d.items()}
                 for k, d in sj.items()}
    path = str(tmp_path / 'ema.npz')
    save_checkpoint(path, params=pj, state=sj, ema=ema, ema_state=ema_state)
    for prefer_ema, src in ((False, (pj, sj)), (True, (ema, ema_state))):
        tb = trt.load_model(cfgs['toy'], path, device='cpu',
                            prefer_ema=prefer_ema)
        jb = jrt.load_model(cfgs['toy'], path, prefer_ema=prefer_ema)
        for want in (from_jax(tb.net, jb.params, jb.state),
                     from_jax(tb.net, *src)):
            _assert_trees_equal(tb.params, want[0], 'params')
            _assert_trees_equal(tb.state, want[1], 'state')


def test_pt_flag_skips_the_coco_heads(repo_root, tmp_path):
    """``pt=True`` on a darknet .weights file skips the 255-channel head
    convs, as JAX's loader does: every other layer loads from the file,
    the heads keep their init."""
    from yolo_tpu import runtime as jrt
    from yolo_tpu.ir import build_ir
    from yolo_tpu.models.darknet_io import save_darknet_weights
    from yolo_tpu_torch import runtime as trt
    from yolo_tpu_torch.convert import from_jax
    cfg = f'{repo_root}/cfg/yolov3tiny/yolov3-tiny.cfg'
    net = build_ir(cfg)
    pj, sj = random_jax_weights(net, seed=10)
    path = str(tmp_path / 'tiny.weights')
    save_darknet_weights(net, pj, sj, path)
    jb = jrt.load_model(cfg, path, pt=True)
    tb = trt.load_model(cfg, path, device='cpu', pt=True,
                        generator=torch.Generator().manual_seed(4))
    init_p, _ = _init(tb.net, 4)
    want_p, want_s = from_jax(tb.net, pj, sj)
    jgot_p, _ = from_jax(tb.net, jb.params, jb.state)
    heads = [str(l.index) for l in net.layers
             if l.kind == 'conv' and not l.bn and l.filters == 255]
    assert len(heads) == 2
    for k in want_p:
        src = init_p if k in heads else want_p
        _assert_trees_equal(tb.params[k], src[k], k)
        if k not in heads:
            _assert_trees_equal(jgot_p[k], want_p[k], k)
    _assert_trees_equal(tb.state, want_s, 'state')
