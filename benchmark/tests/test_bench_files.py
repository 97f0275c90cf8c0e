"""The benchmark's files: BENCHMARK.json against the shapes it must have,
every configuration, workload and metric file in place and loadable, and
the counts against the figures chip_smoke.py measured them by."""

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import BENCH, REPO

from benchmark import counts
from benchmark.reference import darknet

NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')
B = json.load(open(os.path.join(REPO, 'BENCHMARK.json')))


def test_names_units_and_keys():
    assert set(B) == {'command', 'paths', 'run_seconds', 'configs',
                      'workloads', 'end_to_end', 'per_layer'}
    metrics = B['end_to_end'] + B['per_layer']
    for item in B['configs'] + B['workloads'] + metrics:
        assert NAME.match(item['name']), item['name']
    for m in metrics:
        assert UNIT.match(m['unit']), m['unit']
        assert m['better'] in ('lower', 'higher')
    for c in B['workloads']:
        assert NAME.match(c['config']) and NAME.match(c['traffic'])
        assert c['chips'] in (1, 4) and 0 < len(c['why']) <= 200
    names = [m['name'] for m in metrics]
    assert len(names) == len(set(names))
    assert 'setup_s' in names
    for m in B['end_to_end']:
        assert 0 < m['bound'] <= 0.25 and m['source'] in ('host_clock',
                                                          'device_trace')


@pytest.mark.parametrize('cell', [c['name'] for c in B['workloads']])
def test_every_cell_has_its_files(cell):
    wl = json.load(open(os.path.join(BENCH, 'workloads', f'{cell}.json')))
    entry = next(c for c in B['workloads'] if c['name'] == cell)
    assert wl['config'] == entry['config']
    cfg = json.load(open(os.path.join(BENCH, 'configs',
                                      f'{wl["config"]}.json')))
    assert cfg['name'] == wl['config']
    assert os.path.exists(os.path.join(BENCH, 'drivers',
                                       f'{wl["driver"]}.py'))
    assert set(wl['check']['limits']) and all(
        v > 0 for v in wl['check']['limits'].values())
    e2e = {m['name'] for m in B['end_to_end']
           if cell in m.get('workloads', [cell])}
    assert 'setup_s' in e2e and len(e2e) >= 2
    assert any(cell in m['workloads'] for m in B['per_layer'])


@pytest.mark.parametrize('metric', [m['name'] for m in B['per_layer']])
def test_every_metric_has_a_reader(metric):
    from benchmark.run import load_module
    mod = load_module(os.path.join(BENCH, 'metrics', f'{metric}.py'), metric)
    assert callable(mod.read)
    moves = next(m['moves'] for m in B['per_layer'] if m['name'] == metric)
    assert moves in {m['name'] for m in B['end_to_end']}


@pytest.mark.parametrize('config', [c['name'] for c in B['configs']])
def test_configs_build(config):
    entry = next(c for c in B['configs'] if c['name'] == config)
    cfg = json.load(open(os.path.join(REPO, entry['file'])))
    layers = darknet.build(cfg['darknet_cfg'])
    assert len(darknet.convs(layers)) == cfg['convs']
    assert sum(l.kind == 'yolo' for l in layers) == len(cfg['heads_strides'])
    assert entry['reduced'] == []


def config_lines(config):
    """A configuration's cfg lines, or a cfg file's under cfg/."""
    if config.endswith('.cfg'):
        return [l.split('#')[0].strip() for l in open(os.path.join(REPO, config))
                if l.split('#')[0].strip()]
    path = os.path.join(BENCH, 'configs', f'{config}.json')
    return json.load(open(path))['darknet_cfg']


@pytest.mark.parametrize('config,size,ops,n_k2,bound', [
    ('yolov3-608', 608, 1.120e12, 74, 0.7097),
    ('yolov4-608', 608, 1.022e12, 109, 0.8195),
    ('cfg/yolov3-mobilenet/yolov3-mobilenet-visdrone.cfg', 416, None, 46,
     0.1118)])
def test_k2_counts_match_the_smoke_run(config, size, ops, n_k2, bound):
    """chip_smoke.py's K2 figures: int8 operations a batch of 8 and the
    bound of its K2 calls (yolov3-mobilenet @416: phase 8's)."""
    layers = darknet.build(config_lines(config))
    convs = darknet.macs(layers, size)
    k2 = counts.k2_calls(convs, layers)
    assert len(k2) == n_k2
    if ops is not None:
        assert counts.conv_ops(k2, 8) == pytest.approx(ops, rel=5e-4)
    assert counts.k2_bound_ms(convs, layers, 8) == pytest.approx(bound,
                                                                 abs=5e-5)


def test_k1_bound_matches_the_smoke_run():
    """chip_smoke.py phase 3: k=512, bs=8, its seeded candidates: 13.34 M
    f32 operations, 0.221 MB, 0.000199 ms."""
    sys.path.insert(0, REPO)
    import chip_smoke
    boxes, scores, valid = chip_smoke.candidate_arrays(
        np.random.default_rng(0), 8, 512)
    valid_t = torch.from_numpy(valid)
    _, pairs = chip_smoke.fixpoint_sweeps(
        torch.from_numpy(boxes) * valid_t[..., None], valid_t, 0.6)
    b = counts.k1_bound_ms(8, 512, valid.sum(1).tolist(), pairs)
    assert b == pytest.approx(0.000199, abs=2e-6)


def test_no_jax_in_the_harness_and_no_port_in_the_reference():
    """Top-level module names compared whole: yolo_tpu_torch is the
    program, yolo_tpu the JAX package."""
    code = ('import sys, runpy; {imports}; '
            'print(sorted({{m.split(".")[0] for m in sys.modules}}))')
    harness = ('import benchmark.run, benchmark.control, benchmark.trace; '
               'from benchmark.run import load_module; import glob; '
               '[load_module(p, p) for p in glob.glob("benchmark/drivers/*.py")'
               ' + glob.glob("benchmark/metrics/*.py")]; '
               'import yolo_tpu_torch.runtime, yolo_tpu_torch.train.trainer')
    reference = ('import benchmark.reference.darknet, '
                 'benchmark.reference.detect, benchmark.reference.loss')
    env = {**os.environ, 'PYTHONPATH': REPO}
    for imports, banned in ((harness, {'jax', 'jaxlib', 'flax', 'yolo_tpu'}),
                            (reference, {'jax', 'jaxlib', 'flax', 'yolo_tpu',
                                         'yolo_tpu_torch'})):
        out = subprocess.run([sys.executable, '-c',
                              code.format(imports=imports)], cwd=REPO,
                             env=env, capture_output=True, text=True,
                             check=True).stdout
        loaded = set(eval(out.strip().splitlines()[-1]))
        assert not loaded & banned, loaded & banned
