"""The port's FPGA export and weight-format CLIs
(``yolo_tpu_torch.compress.fpga_export``, ``make_quant_apply(capture_trace
=True)``, ``bn_fuse_weights``, ``python -m yolo_tpu_torch.detect
--quantizer_output``, ``python -m yolo_tpu_torch.convert_fpga`` and
``python -m yolo_tpu_torch.convert``) against the JAX package, on the CPU.

Both packages load the same files: ``PLAIN_CFG`` (leaky convs, plain
shortcuts, a concat, an upsample) calibrated by the JAX package (google and
cos-PTQ from 3 calibration steps, TPSQ from its warmup), written as an
.npz and its ``_qstate.npz``. Everything is held bit for bit: the traces
of every layer of the f32 sim, the fused weights, every byte of the
exported binaries (google, ptq_cos and tpsq at 8 bits, google at 16, with
and without the TM/TN reorder) and of the ``quantizer_output`` trees with
activations, and the files the CLIs write beside the root CLIs' ones,
but for the detect CLIs' activation dumps past the first shortcut: both
CLIs run the sim in bf16, where the frameworks' CPU convs round
differently (``ACT_DIRS``).
"""

import os
import sys

import numpy as np
import pytest
import torch

from _torch_port import images
from test_torch_augment import write_jpeg_set
from test_torch_quant_schemes import PLAIN_CFG, _weights

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

NUM = {'google': 1, 'tpsq': 2, 'ptq_cos': 3}


@pytest.fixture(scope='module', autouse=True)
def _setup():
    import jax
    old = (torch.get_num_threads(), jax.config.jax_default_matmul_precision)
    torch.set_num_threads(2)
    jax.config.update('jax_default_matmul_precision', 'highest')
    yield
    torch.set_num_threads(old[0])
    jax.config.update('jax_default_matmul_precision', old[1])


def _calibrate(net, scheme, bits, x):
    """JAX params/state/qstate of ``scheme`` at ``bits``: 3 calibration
    steps, or TPSQ's warmup."""
    import jax
    import jax.numpy as jnp
    from yolo_tpu.compress import quant as JQ
    pj, sj = _weights(net, scheme)
    cfg = JQ.QuantConfig(scheme=scheme, steps=100, a_bits=bits, w_bits=bits)
    qj = JQ.init_quant_state(net, cfg)[0]
    if scheme == 'tpsq':
        pj = JQ.tpsq_warmup(net, cfg, pj, sj, qj, jnp.asarray(x))
    else:
        apply = jax.jit(JQ.make_quant_apply(net, cfg, compute_dtype=None),
                        static_argnums=4)
        for _ in range(3):
            _, sj, qj = apply(pj, sj, qj, jnp.asarray(x), True)
    host = lambda t: jax.tree.map(np.asarray, jax.device_get(t))
    return host(pj), host(sj), host(qj)


@pytest.fixture(scope='module')
def files(tmp_path_factory):
    """{(scheme, bits): .npz path} (each with its ``_qstate.npz``), the
    cfg, and 4 seeded JPEG files with their .data."""
    from yolo_tpu.ir import build_ir
    from yolo_tpu.utils.checkpoint import save_checkpoint
    root = tmp_path_factory.mktemp('fpga')
    cfg = str(root / 'plain.cfg')
    with open(cfg, 'w') as f:
        f.write(PLAIN_CFG)
    net = build_ir(cfg)
    x = images(2, 2, 64).astype(np.float32) / 256.0
    out = {}
    for scheme, bits in (('google', 8), ('ptq_cos', 8), ('tpsq', 8),
                         ('google', 16)):
        pj, sj, qj = _calibrate(net, scheme, bits, x)
        path = str(root / f'{scheme}{bits}.npz')
        save_checkpoint(path, params=pj, state=sj)
        save_checkpoint(path.replace('.npz', '_qstate.npz'), params=qj,
                        state={})
        out[scheme, bits] = path
    lst = write_jpeg_set(str(root), n=4, nc=2, seed=3)
    with open(root / 'names', 'w') as f:
        f.write('a\nb\n')
    data = str(root / 'set.data')
    with open(data, 'w') as f:
        f.write(f'classes=2\ntrain={lst}\nvalid={lst}\nnames={root}/names\n')
    return out, cfg, str(root / 'images'), data


def _bundles(files, scheme, bits=8, dtype='f32', maxabsscaler=False):
    """(JAX bundle, port bundle) loaded from the same files."""
    import jax.numpy as jnp
    from yolo_tpu import runtime as jrt
    from yolo_tpu_torch import runtime as trt
    paths, cfg, _, _ = files
    kw = dict(quantized=NUM[scheme], a_bit=bits, w_bit=bits,
              maxabsscaler=maxabsscaler)
    jb = jrt.load_model(cfg, paths[scheme, bits], compute_dtype=(
        jnp.float32 if dtype == 'f32' else jnp.bfloat16), **kw)
    tb = trt.load_model(cfg, paths[scheme, bits], device='cpu', dtype=(
        torch.float32 if dtype == 'f32' else torch.bfloat16), **kw)
    return jb, tb


def _tree(root):
    """{relative path: bytes} of every file under ``root``."""
    out = {}
    for d, _, fs in os.walk(root):
        for f in fs:
            p = os.path.join(d, f)
            with open(p, 'rb') as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def _assert_trees_equal(a, b):
    ta, tb = _tree(a), _tree(b)
    assert sorted(ta) == sorted(tb)
    bad = [k for k in ta if ta[k] != tb[k]]
    assert not bad, bad[:10]
    return ta


@pytest.mark.parametrize('scheme', ['google', 'ptq_cos', 'tpsq'])
def test_capture_trace_matches_jax(scheme, files):
    """``make_quant_apply(capture_trace=True)``: the trace holds every
    layer's output under its index, in eval and in train mode, each equal
    to JAX's bit for bit (f32); the rest of the return is the plain
    apply's; ``heads_only`` refuses it."""
    import jax
    import jax.numpy as jnp
    from yolo_tpu.compress.quant import make_quant_apply as jmake
    from yolo_tpu_torch.compress.quant import make_quant_apply
    jb, tb = _bundles(files, scheme)
    x = images(4, 2, 64).astype(np.float32) / 256.0
    japply = jax.jit(jmake(jb.net, jb.qcfg, compute_dtype=None,
                           capture_trace=True), static_argnums=4)
    tapply = make_quant_apply(tb.net, tb.qcfg, capture_trace=True)
    plain = make_quant_apply(tb.net, tb.qcfg)
    for train in (False, True):
        jout = japply(jb.params, jb.state, jb.qstate, jnp.asarray(x), train)
        with torch.no_grad():
            tout = tapply(tb.params, tb.state, tb.qstate,
                          torch.from_numpy(x), train)
            pout = plain(tb.params, tb.state, tb.qstate,
                         torch.from_numpy(x), train)
        assert len(tout) == len(pout) + 1 == len(jout)
        jt, tt = jax.device_get(jout[-1]), tout[-1]
        assert sorted(tt) == sorted(jt) == sorted(
            str(l.index) for l in tb.net.layers)
        for k in jt:
            np.testing.assert_array_equal(tt[k].numpy(), np.asarray(jt[k]),
                                          err_msg=f'layer {k}')
        heads = tout[0][0] if train else tout[1]
        for a, b in zip(heads, pout[0][0] if train else pout[1]):
            assert torch.equal(a, b)
    with pytest.raises(AssertionError):
        make_quant_apply(tb.net, tb.qcfg, capture_trace=True,
                         heads_only=True)


@pytest.mark.parametrize('scheme', ['google', 'tpsq'])
def test_bn_fuse_weights_matches_jax(scheme, files):
    """The export fold, {layer: (HWIO w, b)} numpy f32, bit-equal."""
    from yolo_tpu.compress.quant import bn_fuse_weights as jfuse
    from yolo_tpu_torch.compress.quant import bn_fuse_weights
    jb, tb = _bundles(files, scheme)
    want = jfuse(jb.net, jb.params, jb.state)
    got = bn_fuse_weights(tb.net, tb.params, tb.state)
    assert sorted(got) == sorted(want)
    for k, (w, b) in want.items():
        assert got[k][0].dtype == got[k][1].dtype == np.float32
        np.testing.assert_array_equal(got[k][0], np.asarray(w))
        np.testing.assert_array_equal(got[k][1], np.asarray(b))


@pytest.mark.parametrize('reorder', [False, True])
@pytest.mark.parametrize('case', [('google', 8), ('ptq_cos', 8),
                                  ('tpsq', 8), ('google', 16)],
                         ids=lambda c: f'{c[0]}{c[1]}')
def test_export_fpga_weights_byte_equal(case, reorder, files, tmp_path):
    """The six binaries of ``export_fpga_weights`` byte-equal to JAX's:
    ``<i1`` (``<i2`` at 16 bits) weights and biases, ``<i4`` shifts."""
    from yolo_tpu.compress.fpga_export import export_fpga_weights as jexp
    from yolo_tpu_torch.compress.fpga_export import export_fpga_weights
    jb, tb = _bundles(files, *case)
    jexp(jb, str(tmp_path / 'j'), reorder=reorder, TM=8, TN=8)
    export_fpga_weights(tb, str(tmp_path / 't'), reorder=reorder, TM=8, TN=8)
    tree = _assert_trees_equal(tmp_path / 'j', tmp_path / 't')
    assert sorted(tree) == sorted(f'{n}.bin' for n in (
        'weights', 'biases', 'w_scale', 'b_scale', 'a_scale', 's_scale'))
    n_w = sum(int(np.prod(l.size * l.size * l.in_channels * l.filters))
              for l in tb.net.layers if l.kind in ('conv', 'depthwise'))
    if not reorder:
        assert len(tree['weights.bin']) == n_w * (case[1] // 8)
    assert np.frombuffer(tree['a_scale.bin'], '<i4')[0] == (
        14 if case[1] == 16 else 7)


@pytest.mark.parametrize('scheme', ['google', 'ptq_cos', 'tpsq'])
def test_dump_quantizer_output_byte_equal(scheme, files, tmp_path):
    """``dump_quantizer_output`` with an input and the reorder, then
    ``upsample_activation_dumps``: every file of both trees byte-equal;
    with ``layer_idx`` one layer's files alone."""
    import jax.numpy as jnp
    from yolo_tpu.compress import fpga_export as J
    from yolo_tpu_torch.compress import fpga_export as T
    jb, tb = _bundles(files, scheme)
    x = images(6, 1, 64).astype(np.float32) / 256.0
    J.dump_quantizer_output(jb, jnp.asarray(x), str(tmp_path / 'j'),
                            reorder=True, TM=8, TN=8)
    T.dump_quantizer_output(tb, torch.from_numpy(x), str(tmp_path / 't'),
                            reorder=True, TM=8, TN=8)
    assert (J.upsample_activation_dumps(jb.net, str(tmp_path / 'j'), TN=8)
            == T.upsample_activation_dumps(tb.net, str(tmp_path / 't'),
                                           TN=8) != [])
    tree = _assert_trees_equal(tmp_path / 'j', tmp_path / 't')
    n_conv = sum(l.kind == 'conv' for l in tb.net.layers)
    assert sum(k.startswith('q_activation_out') for k in tree) == n_conv
    J.dump_quantizer_output(jb, jnp.asarray(x), str(tmp_path / 'j1'),
                            layer_idx=3)
    T.dump_quantizer_output(tb, torch.from_numpy(x), str(tmp_path / 't1'),
                            layer_idx=3)
    tree = _assert_trees_equal(tmp_path / 'j1', tmp_path / 't1')
    assert all('0003_conv' in k for k in tree) and len(tree) == 10


@pytest.mark.parametrize('bits', [8, 6])
def test_dump_input_artifacts_byte_equal(bits, tmp_path):
    """The --maxabsscaler input dumps byte-equal (at 8 bits not0_count is
    0; at 6 the grid is coarser than the pixels)."""
    from yolo_tpu.compress.fpga_export import dump_input_artifacts as J
    from yolo_tpu_torch.compress.fpga_export import dump_input_artifacts as T
    img = images(8, 1, 16)[0]
    J(img, bits, str(tmp_path / 'j'))
    T(img, bits, str(tmp_path / 't'))
    tree = _assert_trees_equal(tmp_path / 'j', tmp_path / 't')
    assert len(tree) == 5
    assert (float(np.loadtxt(tmp_path / 't' / 'not0_count.txt')) == 0) == (
        bits == 8)


def test_unquantized_export_raises(files):
    """A float bundle has nothing to dump."""
    from yolo_tpu_torch import runtime as trt
    from yolo_tpu_torch.compress.fpga_export import dump_quantizer_output
    _, cfg, _, _ = files
    with pytest.raises(AssertionError, match='quantized'):
        dump_quantizer_output(trt.load_model(cfg, device='cpu'))


# ------------------------------------------------------------ the CLIs

def _in_dir(path, fn, *args):
    old = os.getcwd()
    os.makedirs(path, exist_ok=True)
    os.chdir(path)
    try:
        return fn(*args)
    finally:
        os.chdir(old)


# the activation dumps that follow a bf16 sim's values: the CLIs run the
# sim in bf16 (the root CLI's default), where the two frameworks' CPU
# convs round their sums differently once a conv's input is a shortcut's
# f32 sum (measured on google: 2% of layer 5's values a quantum apart,
# 27-51% of the later layers', up to 6 quanta); the f32 trees are held
# byte for byte above
ACT_DIRS = ('q_activation_out', 'q_activation_max', 'max_activation_count',
            'q_activation_reorder')


@pytest.mark.parametrize('scheme,extra', [
    ('google', ['--reorder', '--maxabsscaler']), ('ptq_cos', []),
    ('tpsq', ['--layer_idx', '11'])], ids=['google', 'ptq_cos', 'tpsq'])
def test_detect_quantizer_output_cli_matches_root(scheme, extra, files,
                                                  tmp_path):
    """``python -m yolo_tpu_torch.detect --quantizer_output`` (its
    ``main``, bf16 as the root CLI's default) beside the root
    ``detect.py``, each in its own directory: the same files; the weight,
    bias, scale and input dumps byte-equal, the activations of the convs
    before the first shortcut too (``ACT_DIRS``); and the port's tree
    byte-equal to ``dump_quantizer_output`` (+ the input and upsample
    dumps) of the same bf16 bundle on the first letterboxed image. The
    detections are drawn."""
    import detect as jdetect
    from yolo_tpu_torch.compress import fpga_export as T
    from yolo_tpu_torch.data.datasets import LoadImages
    from yolo_tpu_torch.detect import main as tdetect
    from yolo_tpu_torch.runtime import preprocess
    paths, cfg, imgs, data = files
    argv = ['--cfg', cfg, '--data', data, '--weights', paths[scheme, 8],
            '--quantized', str(NUM[scheme]), '--source', imgs,
            '--img-size', '64', '--conf-thres', '0.01', '--output', 'out',
            '--batch-size', '2', '--quantizer_output', '--TM', '8', '--TN',
            '8'] + extra
    _in_dir(tmp_path / 'j', jdetect.main, argv)
    _in_dir(tmp_path / 't', tdetect, argv + ['--device', 'cpu'])
    jt = _tree(tmp_path / 'j' / 'quantizer_output')
    tt = _tree(tmp_path / 't' / 'quantizer_output')
    assert sorted(tt) == sorted(jt)
    first = ('0000', '0001', '0002', '0003')
    bad = [k for k in jt if jt[k] != tt[k] and (
        not k.startswith(ACT_DIRS) or any(f'{i}_conv' in k for i in first))]
    assert not bad, bad[:10]
    assert ('img_bin' in tt) == ('--maxabsscaler' in extra)
    assert any(k.endswith('_upsample_q_bin') for k in tt) == (
        '--layer_idx' not in extra)
    assert len(os.listdir(tmp_path / 't' / 'out')) == 4

    _, tb = _bundles(files, scheme, dtype='bf16',
                     maxabsscaler='--maxabsscaler' in extra)
    img = next(iter(LoadImages(imgs, img_size=64)))[1]
    x_u8 = np.ascontiguousarray(img.transpose(1, 2, 0))[None]
    lib = tmp_path / 'lib'
    T.dump_quantizer_output(
        tb, preprocess(x_u8, tb.maxabsscaler, device='cpu'), str(lib),
        reorder='--reorder' in extra, TM=8, TN=8,
        layer_idx=int(extra[1]) if '--layer_idx' in extra else -1)
    if tb.maxabsscaler:
        T.dump_input_artifacts(x_u8[0], 8, str(lib))
    if '--layer_idx' not in extra:
        T.upsample_activation_dumps(tb.net, str(lib), TN=8)
    _assert_trees_equal(lib, tmp_path / 't' / 'quantizer_output')


def test_detect_quantizer_output_float_model_skips(files, tmp_path, capsys):
    from yolo_tpu_torch.detect import main as tdetect
    _, cfg, imgs, data = files
    _in_dir(tmp_path, tdetect, ['--cfg', cfg, '--data', data, '--weights',
                                '', '--source', imgs, '--img-size', '64',
                                '--quantizer_output', '--device', 'cpu'])
    assert 'quantizer_output ignored' in capsys.readouterr().out
    assert not (tmp_path / 'quantizer_output').exists()


@pytest.mark.parametrize('scheme,extra', [
    ('ptq_cos', []), ('google', ['--reorder', '--TM', '8', '--TN', '8'])])
def test_convert_fpga_cli_matches_root(scheme, extra, files, tmp_path):
    """``python -m yolo_tpu_torch.convert_fpga`` (its ``main``) beside the
    root ``convert_FPGA.py`` on the same .npz and ``_qstate.npz``: the six
    binaries byte-equal; the root CLI's ignored flags parse; ``--device``
    defaults to cuda."""
    import convert_FPGA as jfpga
    from yolo_tpu_torch.convert_fpga import main, parse_args
    paths, cfg, _, _ = files
    argv = ['--cfg', cfg, '--weights', paths[scheme, 8], '--quantized',
            str(NUM[scheme]), '--img_size', '64', '--FPGA', '--data', 'x',
            '--conf-thres', '0.3'] + extra
    jfpga.main(argv + ['--out', str(tmp_path / 'j')])
    main(argv + ['--out', str(tmp_path / 't'), '--device', 'cpu'])
    assert len(_assert_trees_equal(tmp_path / 'j', tmp_path / 't')) == 6
    assert parse_args([]).device == 'cuda'


def test_convert_cli_matches_root(files, tmp_path):
    """``python -m yolo_tpu_torch.convert`` beside the root
    ``convert.py``: .npz -> .weights byte-equal (a training checkpoint
    exports its EMA pair), .weights -> .npz and .pt -> .npz the same
    arrays, ``--output`` to a .pt the same state_dict."""
    import convert as jconvert
    from yolo_tpu.ir import build_ir
    from yolo_tpu.utils.checkpoint import load_checkpoint, save_checkpoint
    from yolo_tpu_torch.convert import main
    from _torch_port import random_jax_weights
    _, cfg, _, _ = files
    net = build_ir(cfg)
    pj, sj = random_jax_weights(net, seed=1)
    ema, ema_s = random_jax_weights(net, seed=2)
    for name in ('j', 't'):
        d = tmp_path / name
        d.mkdir()
        save_checkpoint(str(d / 'm.npz'), params=pj, state=sj, ema=ema,
                        ema_state=ema_s, epoch=3)
    run = {'j': jconvert.main, 't': main}
    for name, fn in run.items():
        d = tmp_path / name
        fn(['--cfg', cfg, '--weights', str(d / 'm.npz')])
        fn(['--cfg', cfg, '--weights', str(d / 'm.weights'),
            '--output', str(d / 'back.npz')])
        fn(['--cfg', cfg, '--weights', str(d / 'm.npz'),
            '--output', str(d / 'm.pt')])
        fn(['--cfg', cfg, '--weights', str(d / 'm.pt'),
            '--output', str(d / 'pt.npz')])
    j, t = tmp_path / 'j', tmp_path / 't'
    assert (t / 'm.weights').read_bytes() == (j / 'm.weights').read_bytes()
    for f in ('back.npz', 'pt.npz'):
        a, b = load_checkpoint(str(j / f)), load_checkpoint(str(t / f))
        assert a['epoch'] == b['epoch']
        for tree in ('params', 'state'):
            assert sorted(a[tree]) == sorted(b[tree])
            for k in a[tree]:
                for fld in a[tree][k]:
                    np.testing.assert_array_equal(b[tree][k][fld],
                                                  a[tree][k][fld])
    back = load_checkpoint(str(t / 'back.npz'))
    np.testing.assert_array_equal(back['params']['0']['w'], ema['0']['w'])
    sa = torch.load(j / 'm.pt', weights_only=False)
    sb = torch.load(t / 'm.pt', weights_only=False)
    assert sa['epoch'] == sb['epoch'] == 3
    assert sorted(sa['model']) == sorted(sb['model'])
    for k, v in sa['model'].items():
        assert torch.equal(torch.as_tensor(np.asarray(v)),
                           torch.as_tensor(np.asarray(sb['model'][k]))), k
