"""A copy of the benchmark folder with tiny cells dropped in as data files:
yolov3-tiny at 96 px (yolov4 itself at 256 px for bf16 serving, whose
float8 control a network as shallow as yolov3-tiny does not tell apart;
yolov3-mobilenet at 96 px for the mobile backbone's depthwise convs, SE
blocks and float edges), batches of 2, on the CPU, where the port's
kernels run their plain twins.
Each tiny cell is a copy of a real workload file with its sizes cut and
its limits kept, so the harness, the drivers, the reference and the
limits run as in a real cell. The bf16 serving workload, which is no cell
of BENCHMARK.json yet, reports the metrics of the yolov4 int8 cell."""

import json
import os
import shutil
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(BENCH)
if REPO not in sys.path:
    sys.path.insert(0, REPO)

TINY_SIZE = 96
# tiny cell -> (the workload it copies, its tiny config, the cell of
# BENCHMARK.json whose metrics it reports)
TINY = {'tiny.int8-serve': ('yolov3-608.int8-serve', 'tiny',
                            'yolov3-608.int8-serve'),
        'tiny.int8-serve-cos': ('yolov4-608.int8-serve', 'tiny-cos',
                                'yolov4-608.int8-serve'),
        'tiny.bf16-serve': ('yolov4-608.bf16-serve', 'tiny-v4',
                            'yolov4-608.int8-serve'),
        'tiny.train': ('yolov3-608.train', 'tiny', 'yolov3-608.train'),
        'tiny-mobile.int8-serve': ('yolov3-608.int8-serve', 'tiny-mobile',
                                   'yolov3-608.int8-serve')}
MOBILE_CFG = os.path.join('cfg', 'yolov3-mobilenet',
                          'yolov3-mobilenet-visdrone.cfg')


def cfg_lines(path):
    return [l.split('#')[0].strip() for l in open(path)
            if l.split('#')[0].strip()]


def build_tiny(dst):
    root = os.path.join(dst, 'benchmark')
    shutil.copytree(BENCH, root, ignore=shutil.ignore_patterns(
        '.cache', '__pycache__', 'tests'))
    lines = cfg_lines(os.path.join(REPO, 'cfg', 'yolov3tiny',
                                   'yolov3-tiny.cfg'))
    mobile = cfg_lines(os.path.join(REPO, MOBILE_CFG))
    for name, real, dk in (('tiny', 'yolov3-608', lines),
                           ('tiny-cos', 'yolov4-608', lines),
                           ('tiny-mobile', 'yolov3-608', mobile)):
        cfg = json.load(open(os.path.join(root, 'configs', f'{real}.json')))
        cfg.update(name=name, img_size=TINY_SIZE, darknet_cfg=dk)
        cfg['forms']['int8'].update(calibration_batches=2)
        json.dump(cfg, open(os.path.join(root, 'configs', f'{name}.json'),
                            'w'))
    cfg = json.load(open(os.path.join(root, 'configs', 'yolov4-608.json')))
    cfg.update(name='tiny-v4', img_size=256)
    json.dump(cfg, open(os.path.join(root, 'configs', 'tiny-v4.json'), 'w'))
    bench = json.load(open(os.path.join(REPO, 'BENCHMARK.json')))
    for cell, (real, config, listed) in TINY.items():
        wl = json.load(open(os.path.join(root, 'workloads', f'{real}.json')))
        wl.update(config=config, batch=2, pool=4,
                  trace={'steps': 2})
        if 'batches' in wl['check']:
            wl['check']['batches'] = 2
        json.dump(wl, open(os.path.join(root, 'workloads', f'{cell}.json'),
                           'w'))
        bench['workloads'].append({'name': cell, 'config': config,
                                   'traffic': real.split('.')[1], 'chips': 1,
                                   'why': 'tiny CPU copy of ' + real})
        for m in bench['end_to_end'] + bench['per_layer']:
            if listed in m.get('workloads', ()):
                m['workloads'].append(cell)
    json.dump(bench, open(os.path.join(dst, 'BENCHMARK.json'), 'w'))
    return root


@pytest.fixture(scope='session')
def tiny_root(tmp_path_factory):
    return build_tiny(str(tmp_path_factory.mktemp('bench')))
