"""The port's pruning toolchain (``yolo_tpu_torch.compress.prune``,
``prune_drivers``, ``prune_cli``, ``utils.profiling``, ``info``) against
the JAX package, on the CPU.

- counts and sets: ``count_params``, ``count_macs`` (two sizes) and
  ``prunable_sets_{normal,shortcut,layer}`` equal JAX's on every cfg under
  ``cfg/``; ``python -m yolo_tpu_torch.info`` prints root ``info.py``'s
  table on yolov3-tiny;
- channel methods (normal, regular, shortcut, slim, slim_regular) on
  ``tests/test_prune.py``'s MINI_CFG and on yolov3-tiny: the threshold,
  masks, filter counts and module_defs equal, the ``write_cfg`` text and
  the compact ``.weights`` byte for byte, the compact and loose weights
  bit for bit; the port's compact f32 forward equals its loose one within
  rtol 1e-3 / atol 1e-4 (the bound of ``tests/test_prune.py``: the sliced
  convs sum fewer terms);
- layer methods: ``layer_prune`` on RES_CFG and on yolov3 (re-indexed
  routes) and ``layer_channel_prune`` (both variants), bit for bit;
- EagleEye with ``default_rng(0)``: JAX's masks, ratio and weights exactly;
  with an ``eval_fn`` through the port's ``evaluate`` on a labelled set on
  disk, the candidate with the highest of its own mAPs;
- the CLI: all ten methods on the CPU in a temporary directory (nine with
  ``--no-eval``, normal with evaluation through the file loader), normal's
  and layer's cfg and ``.weights`` byte-equal to JAX's ``run_prune_cli``;
- ``save_darknet_weights`` of a model whose BN statistics sit in
  ``params``, byte-equal to JAX's.
"""

import glob
import os
import shutil
import sys

import numpy as np
import pytest
import torch

from _torch_port import images, random_jax_weights
from test_prune import RES_CFG, _mini, _shrink_gammas

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

TINY_CFG = os.path.join(ROOT, 'cfg', 'yolov3tiny', 'yolov3-tiny.cfg')
YOLOV3_CFG = os.path.join(ROOT, 'cfg', 'yolov3', 'yolov3.cfg')
ALL_CFGS = sorted(os.path.relpath(p, ROOT) for p in
                  glob.glob(os.path.join(ROOT, 'cfg', '**', '*.cfg'),
                            recursive=True))
# the port's compact forward against its loose forward, f32 on the CPU
FWD_TOL = dict(rtol=1e-3, atol=1e-4)
SIZE = 64


@pytest.fixture(scope='module', autouse=True)
def _few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _port(net, params, state):
    """The port's (net, params, state) of JAX weights (CPU tensors)."""
    from yolo_tpu_torch.convert import from_jax
    from yolo_tpu_torch.ir import build_ir
    tnet = build_ir(net.cfg_name, is_gray_scale=net.in_channels == 1)
    return (tnet, *from_jax(tnet, params, state))


def _shrunk(net, params, state, frac, seed):
    from yolo_tpu.compress import prune as JP
    sets = JP.prunable_sets_shortcut(net)      # a superset of normal's
    return net, _shrink_gammas(params, sets.prune_idx, frac, seed), state


@pytest.fixture(scope='module')
def mini(tmp_path_factory):
    """tests/test_prune.py's MINI_CFG weights with 40% of each prunable
    layer's gammas pushed near 0, as JAX's (net, params, state)."""
    return _shrunk(*_mini(tmp_path_factory), 0.4, 0)


@pytest.fixture(scope='module')
def resnet(tmp_path_factory):
    return _shrunk(*_mini(tmp_path_factory, RES_CFG, 'res.cfg'), 0.3, 7)


@pytest.fixture(scope='module')
def tiny():
    from yolo_tpu.ir import build_ir
    net = build_ir(TINY_CFG)
    return _shrunk(net, *random_jax_weights(net, seed=1), 0.3, 2)


def _assert_trees_equal(got, want, what):
    """Two {k: {f: array}} trees, bit for bit (f32 on both sides)."""
    assert sorted(got) == sorted(want), what
    for k in want:
        assert sorted(got[k]) == sorted(want[k]), (what, k)
        for f in want[k]:
            g, w = np.asarray(got[k][f]), np.asarray(want[k][f])
            assert g.dtype == np.float32 and w.dtype == np.float32, (what, k, f)
            assert g.shape == w.shape, (what, k, f, g.shape, w.shape)
            assert np.array_equal(g.view(np.uint32), w.view(np.uint32)), \
                (what, k, f, float(np.abs(g - w).max()))


def _assert_port_equals_jax(tnet, tparams, tstate, jnet, jparams, jstate,
                            what):
    from yolo_tpu_torch.convert import to_jax
    p, s = to_jax(tnet, tparams, tstate)
    _assert_trees_equal(p, jparams, what + ' params')
    _assert_trees_equal(s, jstate, what + ' state')


def _assert_defs_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert list(g) == list(w), (g, w)
        for k in w:
            assert np.array_equal(np.asarray(g[k]), np.asarray(w[k])), (k, g, w)


def _assert_masks_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], want[k], err_msg=str(k))


def _cfg_text(write_cfg, defs, path):
    write_cfg(path, defs)
    return open(path, 'rb').read()


def _assert_files_equal(tmp_path, jres, tres):
    """The write_cfg text and the compact .weights of both packages."""
    from yolo_tpu.compress.prune import write_cfg as jwrite
    from yolo_tpu.models.darknet_io import save_darknet_weights as jsave
    from yolo_tpu_torch.compress.prune import write_cfg as twrite
    from yolo_tpu_torch.models.darknet_io import save_darknet_weights as tsave
    assert (_cfg_text(twrite, tres.module_defs, tmp_path / 't.cfg')
            == _cfg_text(jwrite, jres.module_defs, tmp_path / 'j.cfg'))
    jsave(jres.net, jres.params, jres.state, tmp_path / 'j.weights')
    tsave(tres.net, tres.params, tres.state, tmp_path / 't.weights')
    assert ((tmp_path / 't.weights').read_bytes()
            == (tmp_path / 'j.weights').read_bytes())


def _io(net, params, state, x):
    """The port's f32 eval forward (BN unfused) on the CPU."""
    from yolo_tpu_torch.runtime import ModelBundle
    m = ModelBundle(net=net, params=params, state=state, device='cpu',
                    dtype=torch.float32).model()
    with torch.inference_mode():
        return m(x).numpy()


# ---------------------------------------------------------- counts and sets

def _sets_or_error(fn, net):
    try:
        out = fn(net)
    except Exception as e:          # both packages must fail the same way
        return type(e).__name__
    return out if isinstance(out, tuple) else (
        out.cbl_idx, out.other_idx, out.prune_idx, out.shortcut_idx,
        out.shortcut_all)


@pytest.mark.parametrize('cfg', ALL_CFGS)
def test_counts_and_sets_match_jax(cfg):
    from yolo_tpu.compress import prune as JP
    from yolo_tpu.ir import build_ir as jbuild
    from yolo_tpu.utils import profiling as JPF
    from yolo_tpu_torch.compress import prune as TP
    from yolo_tpu_torch.ir import build_ir as tbuild
    from yolo_tpu_torch.utils import profiling as TPF
    path = os.path.join(ROOT, cfg)
    jnet, tnet = jbuild(path), tbuild(path)
    assert TPF.count_params(tnet) == JPF.count_params(jnet)
    for size in (416, (320, 192)):
        assert TPF.count_macs(tnet, size) == JPF.count_macs(jnet, size)
    assert TPF.model_info(tnet, 608) == JPF.model_info(jnet, 608)
    for name in ('prunable_sets_normal', 'prunable_sets_shortcut',
                 'prunable_sets_layer'):
        assert (_sets_or_error(getattr(TP, name), tnet)
                == _sets_or_error(getattr(JP, name), jnet)), name


def test_info_cli_prints_root_table(capsys):
    import info as root_info
    from yolo_tpu_torch import info
    argv = ['--cfg', TINY_CFG, '--img-size', '416']
    want = root_info.main(argv)
    want_out = capsys.readouterr().out
    got = info.main(argv)
    assert got == want
    assert capsys.readouterr().out == want_out
    assert 'Model Summary: 24 layers' in want_out


# ------------------------------------------------------------ channel prune

CHANNEL_METHODS = ['normal', 'regular', 'shortcut', 'slim', 'slim_regular']


@pytest.mark.parametrize('model', ['mini', 'tiny'])
@pytest.mark.parametrize('method', CHANNEL_METHODS)
def test_channel_prune_matches_jax(request, tmp_path, model, method):
    from yolo_tpu.compress.prune_drivers import channel_prune as jprune
    from yolo_tpu_torch.compress.prune_drivers import channel_prune
    jnet, jparams, jstate = request.getfixturevalue(model)
    tnet, tparams, tstate = _port(jnet, jparams, jstate)
    size = SIZE if model == 'mini' else 128
    kw = dict(method=method, percent=0.3, img_size=size)
    want = jprune(jnet, jparams, jstate, **kw)
    got = channel_prune(tnet, tparams, tstate, **kw)
    assert got.report == want.report
    # on the mini cfg 'regular' snaps its two prunable layers (16 and 24
    # channels) up to their full width
    full = method == 'regular' and model == 'mini'
    assert (got.report['params_after'] < got.report['params_before']
            or full)
    _assert_masks_equal(got.masks, want.masks)
    _assert_defs_equal(got.module_defs, want.module_defs)
    assert ([l.filters for l in got.net.layers]
            == [l.filters for l in want.net.layers])
    _assert_port_equals_jax(got.net, got.params, got.state, want.net,
                            want.params, want.state, 'compact')
    _assert_port_equals_jax(tnet, got.loose_params, got.loose_state, jnet,
                            want.loose_params, want.loose_state, 'loose')
    _assert_files_equal(tmp_path, want, got)
    for t in (*got.params.values(), *got.loose_params.values()):
        assert all(v.device.type == 'cpu' for v in t.values())

    x = torch.from_numpy(np.random.default_rng(5).normal(
        0, 0.3, (1, size, size, 3)).astype(np.float32))
    io_loose = _io(tnet, got.loose_params, got.loose_state, x)
    io_compact = _io(got.net, got.params, got.state, x)
    np.testing.assert_allclose(io_compact, io_loose, **FWD_TOL)


def test_channel_prune_leaves_its_input_untouched(mini):
    from yolo_tpu_torch.compress.prune_drivers import channel_prune
    tnet, tparams, tstate = _port(*mini)
    clone = lambda t: {k: {f: v.clone() for f, v in d.items()}
                       for k, d in t.items()}
    before = clone(tparams), clone(tstate)
    channel_prune(tnet, tparams, tstate, method='slim', percent=0.3,
                  img_size=SIZE)
    for tree, old in zip((tparams, tstate), before):
        for k, d in tree.items():
            for f, v in d.items():
                assert torch.equal(v, old[k][f]), (k, f)


# -------------------------------------------------------------- layer prune

@pytest.mark.parametrize('model', ['resnet', 'yolov3'])
def test_layer_prune_matches_jax(request, tmp_path, model):
    from yolo_tpu.compress import prune as JP
    from yolo_tpu.compress.prune_drivers import layer_prune as jprune
    from yolo_tpu_torch.compress import prune as TP
    from yolo_tpu_torch.compress.prune_drivers import layer_prune
    if model == 'yolov3':
        from yolo_tpu.ir import build_ir
        jnet = build_ir(YOLOV3_CFG)
        jparams, jstate = random_jax_weights(jnet, seed=3)
        n, size = 8, SIZE
    else:
        jnet, jparams, jstate = request.getfixturevalue(model)
        n, size = 1, SIZE
    tnet, tparams, tstate = _port(jnet, jparams, jstate)
    blocks = TP.layer_prune_blocks(tnet, tparams, n)
    jblocks = JP.layer_prune_blocks(jnet, jparams, n)
    assert blocks[:2] == jblocks[:2]
    _assert_defs_equal(blocks[2], jblocks[2])
    want = jprune(jnet, jparams, jstate, n_shortcuts=n, img_size=size)
    got = layer_prune(tnet, tparams, tstate, n_shortcuts=n, img_size=size)
    assert got.report == want.report
    assert len(got.net.layers) == len(tnet.layers) - 3 * n
    for r in got.net.layers:
        if r.kind == 'route':
            assert all(0 <= src < r.index for src in r.layers)
    _assert_port_equals_jax(got.net, got.params, got.state, want.net,
                            want.params, want.state, 'compact')
    _assert_files_equal(tmp_path, want, got)
    if model == 'resnet':
        x = torch.from_numpy(np.random.default_rng(1).normal(
            0, 0.3, (1, size, size, 3)).astype(np.float32))
        assert np.isfinite(_io(got.net, got.params, got.state, x)).all()


@pytest.mark.parametrize('regular', [False, True])
def test_layer_channel_prune_matches_jax(resnet, tmp_path, regular):
    from yolo_tpu.compress.prune_drivers import layer_channel_prune as jprune
    from yolo_tpu_torch.compress.prune_drivers import layer_channel_prune
    jnet, jparams, jstate = resnet
    tnet, tparams, tstate = _port(*resnet)
    kw = dict(percent=0.3, n_shortcuts=1, regular=regular, img_size=SIZE)
    want = jprune(jnet, jparams, jstate, **kw)
    got = layer_channel_prune(tnet, tparams, tstate, **kw)
    assert got.report == want.report
    _assert_masks_equal(got.masks, want.masks)
    _assert_defs_equal(got.module_defs, want.module_defs)
    _assert_port_equals_jax(got.net, got.params, got.state, want.net,
                            want.params, want.state, 'compact')
    _assert_port_equals_jax(tnet, got.loose_params, got.loose_state, jnet,
                            want.loose_params, want.loose_state, 'loose')
    _assert_files_equal(tmp_path, want, got)
    x = torch.from_numpy(np.random.default_rng(3).normal(
        0, 0.3, (1, SIZE, SIZE, 3)).astype(np.float32))
    assert np.isfinite(_io(got.net, got.params, got.state, x)).all()


# ------------------------------------------------------------------ EagleEye

# (method, model, remain_ratio, delta): windows the JAX search reaches with
# default_rng(0) at 64 px (mini) / 128 px (tiny). On the mini cfg 'regular'
# snaps both prunable layers (16 and 24 channels) up to their full width,
# so every draw lands on ratio 1; yolov3-tiny gives it real snapping.
EAGLE_CASES = [('normal', 'mini', 0.8, 0.1), ('regular', 'mini', 1.0, 0.02),
               ('slim', 'mini', 0.6, 0.1), ('regular', 'tiny', 0.6, 0.1)]


@pytest.mark.parametrize('method,model,ratio,delta', EAGLE_CASES)
def test_eagle_eye_matches_jax(request, method, model, ratio, delta):
    from yolo_tpu.compress.prune_drivers import eagle_eye_prune as jprune
    from yolo_tpu_torch.compress.prune_drivers import eagle_eye_prune
    jnet, jparams, jstate = request.getfixturevalue(model)
    tnet, tparams, tstate = _port(jnet, jparams, jstate)
    kw = dict(method=method, remain_ratio=ratio, delta=delta, candidates=2,
              img_size=SIZE if model == 'mini' else 128)
    want = jprune(jnet, jparams, jstate, rng=np.random.default_rng(0), **kw)
    got = eagle_eye_prune(tnet, tparams, tstate,
                          rng=np.random.default_rng(0), **kw)
    assert got.report == want.report
    assert abs(got.report['macs_ratio'] - ratio) <= delta
    _assert_masks_equal(got.masks, want.masks)
    _assert_defs_equal(got.module_defs, want.module_defs)
    _assert_port_equals_jax(got.net, got.params, got.state, want.net,
                            want.params, want.state, 'compact')


@pytest.fixture(scope='module')
def labelled(mini, tmp_path_factory):
    """A labelled set on disk for the mini model: PNG images, and labels
    from the unpruned model's own top detections."""
    from test_torch_eval import _write_set
    from yolo_tpu_torch.runtime import ModelBundle, preprocess
    tnet, tparams, tstate = _port(*mini)
    imgs = images(4, 6, SIZE)
    infer = ModelBundle(net=tnet, params=tparams, state=tstate, device='cpu',
                        dtype=torch.float32).make_infer(conf_thres=0.001)
    dets = infer(preprocess(imgs, device='cpu')).numpy()
    assert (dets[..., 4] > 0).sum(1).min() >= 5
    return _write_set(tmp_path_factory.mktemp('labelled'), imgs, dets)


def test_eagle_eye_eval_keeps_best_candidate(mini, labelled):
    """An eval_fn through the port's evaluate on the file set: the search
    returns the candidate with the highest of its own mAPs, and the
    evaluator's model cache holds each candidate's own model, bounded."""
    from yolo_tpu_torch.compress.prune_drivers import eagle_eye_prune
    from yolo_tpu_torch.eval import evaluator as E
    tnet, tparams, tstate = _port(*mini)
    seen = []

    def eval_fn(r):
        res = E.evaluate(r.net, r.params, r.state, labelled, batch_size=4,
                         img_size=SIZE, compute_dtype=torch.float32,
                         device='cpu')
        model = E.eval_model(r.net, r.params, r.state, fused=False,
                             compute_dtype=torch.float32, maxabsscaler=False,
                             device='cpu')
        assert model.net is r.net
        seen.append((r, res[0][2]))
        return res[0][2]

    best = eagle_eye_prune(tnet, tparams, tstate, method='slim',
                           remain_ratio=0.6, delta=0.1, candidates=6,
                           img_size=SIZE, rng=np.random.default_rng(0),
                           eval_fn=eval_fn)
    maps = [m for _, m in seen]
    assert len(seen) == 6 == best.report['candidates_evaluated']
    assert len(set(maps)) > 1, maps
    assert best is seen[int(np.argmax(maps))][0]
    assert best.report['best_map'] == max(maps)
    assert len(E._CACHE) <= E._CACHE_SIZE


# ----------------------------------------------------------------------- CLI

def _checkpoint(net, params, state, path):
    from yolo_tpu_torch.utils.checkpoint import save_checkpoint
    tree = lambda t: {k: {f: np.asarray(v, np.float32) for f, v in d.items()}
                      for k, d in t.items()}
    save_checkpoint(str(path), params=tree(params), state=tree(state))
    return str(path)


def _cli_dir(root, name, model):
    """A working directory with a copy of the model's cfg and its .npz."""
    net, params, state = model
    d = root / name
    (d / 'cfg').mkdir(parents=True)
    cfg = d / 'cfg' / os.path.basename(net.cfg_name)
    shutil.copy(net.cfg_name, cfg)
    return d, str(cfg), _checkpoint(net, params, state, d / 'model.npz')


# (method, model, extra argv, the file tag); the layer methods on RES_CFG,
# one shortcut block
P3 = ['--percent', '0.3']
CLI_CASES = [
    ('normal', 'mini', P3, 'normal_prune_0.3'),
    ('regular', 'mini', P3, 'regular_prune_0.3'),
    ('shortcut', 'mini', P3, 'shortcut_prune_0.3'),
    ('slim', 'mini', P3, 'slim_prune_0.3'),
    ('layer', 'resnet', ['--shortcuts', '1'], 'layer_prune_1_shortcut'),
    ('layer_channel', 'resnet', ['--shortcuts', '1', *P3],
     'layer_channel_prune_0.3_1'),
    ('layer_channel_regular', 'resnet', ['--shortcuts', '1', *P3],
     'layer_channel_regular_prune_0.3_1'),
    # windows almost every draw reaches: the CLI's rng is unseeded
    ('eagle_normal', 'mini', ['--remain-ratio', '0.75', '--delta', '0.25',
                              '--number', '1'], 'eagle_normal_prune'),
    ('eagle_regular', 'mini', ['--remain-ratio', '1.0', '--delta', '0.02',
                               '--number', '1'], 'eagle_regular_prune'),
    ('eagle_slim', 'mini', ['--remain-ratio', '0.6', '--delta', '0.4',
                            '--number', '1'], 'eagle_slim_prune'),
]


@pytest.mark.parametrize('method,model,extra,tag', CLI_CASES)
def test_prune_cli_every_method(request, tmp_path, monkeypatch, capsys,
                                method, model, extra, tag):
    """``run_prune_cli`` on the CPU in a temporary directory: the cfg is
    written beside the input cfg and the compact weights under
    ./weights; both load back and run. normal evaluates through the file
    loader. normal's and layer's files equal those of JAX's CLI."""
    from yolo_tpu_torch.compress.prune_cli import run_prune_cli
    from yolo_tpu_torch.runtime import load_model
    jmodel = request.getfixturevalue(model)
    d, cfg, npz = _cli_dir(tmp_path, 'port', jmodel)
    argv = ['--cfg', cfg, '--weights', npz, '--img-size', str(SIZE),
            '--batch-size', '4', '--device', 'cpu', *extra]
    if method == 'normal':
        argv += ['--data', request.getfixturevalue('labelled')]
    else:
        argv += ['--no-eval']
    monkeypatch.chdir(d)
    res = run_prune_cli(method, argv)
    out = capsys.readouterr().out
    out_cfg = os.path.join(os.path.dirname(cfg),
                           tag + '_' + os.path.basename(cfg))
    out_w = d / 'weights' / f'{tag}.weights'
    assert os.path.isfile(out_cfg) and out_w.is_file(), os.listdir(d)
    assert f'Config file has been saved: {out_cfg}' in out
    b = load_model(out_cfg, str(out_w), device='cpu', dtype=torch.float32)
    assert [l.filters for l in b.net.layers] == [
        l.filters for l in res.net.layers]
    x = torch.from_numpy(images(9, 1, SIZE).astype(np.float32) / 256)
    with torch.inference_mode():
        assert np.isfinite(b.model()(x).numpy()).all()
    if method == 'normal':          # evaluated through the file loader
        from yolo_tpu_torch.eval.evaluator import evaluate
        m = load_model(cfg, npz, device='cpu')
        r = evaluate(m.net, m.params, m.state, argv[argv.index('--data') + 1],
                     batch_size=4, img_size=SIZE, device='cpu')[0]
        row = next(l for l in out.splitlines() if l.startswith('mAP'))
        assert row.split()[1] == f'{r[2]:.6f}' and r[2] > 0, (row, r)
    if method in ('normal', 'layer'):
        from yolo_tpu.compress.prune_cli import run_prune_cli as jcli
        jd, jcfg, jnpz = _cli_dir(tmp_path, 'jax', jmodel)
        monkeypatch.chdir(jd)
        jargv = ['--cfg', jcfg, '--weights', jnpz, '--img-size', str(SIZE),
                 '--no-eval', *extra]
        jcli(method, jargv)
        jout = os.path.join(os.path.dirname(jcfg),
                            tag + '_' + os.path.basename(jcfg))
        assert open(out_cfg, 'rb').read() == open(jout, 'rb').read()
        assert out_w.read_bytes() == (
            jd / 'weights' / f'{tag}.weights').read_bytes()


def test_prune_module_entry_point(mini, tmp_path, monkeypatch):
    """``python -m yolo_tpu_torch.prune --method ...`` dispatches to the
    method's CLI."""
    from yolo_tpu_torch import prune
    d, cfg, npz = _cli_dir(tmp_path, 'entry', mini)
    monkeypatch.chdir(d)
    res = prune.main(['--method', 'shortcut', '--cfg', cfg, '--weights', npz,
                      '--img-size', str(SIZE), '--no-eval', '--device', 'cpu',
                      '--percent', '0.3'])
    assert res.report['params_after'] < res.report['params_before']
    assert (d / 'weights' / 'shortcut_prune_0.3.weights').is_file()
    with pytest.raises(SystemExit):
        prune.main(['--method', 'unknown'])


# ----------------------------------------------------------- darknet weights

def test_save_darknet_weights_reads_bn_stats_from_params(mini, tmp_path):
    """A model whose BN statistics sit in ``params`` (no ``state`` entry)
    writes the same file as JAX's ``save_darknet_weights``."""
    from yolo_tpu.models.darknet_io import save_darknet_weights as jsave
    from yolo_tpu_torch.convert import from_jax
    from yolo_tpu_torch.models.darknet_io import save_darknet_weights
    jnet, jparams, jstate = mini
    folded = {k: {**d, **jstate.get(k, {})} for k, d in jparams.items()}
    tnet, _, _ = _port(*mini)
    tparams, _ = from_jax(tnet, folded, {})
    jsave(jnet, folded, {}, tmp_path / 'j.weights')
    save_darknet_weights(tnet, tparams, {}, tmp_path / 't.weights')
    got = (tmp_path / 't.weights').read_bytes()
    assert got == (tmp_path / 'j.weights').read_bytes()
    jsave(jnet, jparams, jstate, tmp_path / 'j2.weights')
    assert got == (tmp_path / 'j2.weights').read_bytes()
