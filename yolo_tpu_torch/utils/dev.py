"""Maintenance helpers run by hand from a REPL (the port's copy of
``yolo_tpu/utils/dev.py``; no CLI calls them).

Host-side numpy, OpenCV and matplotlib code over label directories,
images, ``evolve.txt``, ``results*.txt`` and the port's ``.npz``
checkpoints. ``print_model_biases`` takes the port's params (torch
tensors) and ``apply_classifier`` any second-stage classifier.
"""

from __future__ import annotations

import glob
import os
import random
import shutil
from pathlib import Path

import numpy as np


def print_model_biases(net, params, log=print):
    """Bias summary of the conv before each YOLO head: mean +/- std of
    its regression, objectness and classification bias groups."""
    log('\nModel Bias Summary: %8s%18s%18s%18s' %
        ('layer', 'regression', 'objectness', 'classification'))
    for li in net.yolo_layers:
        lyr = net.layers[li]
        src = net.layers[li - 1]
        p = params.get(str(src.index), {})
        if 'b' not in p:
            continue
        b = p['b'].detach().float().cpu().numpy().reshape(lyr.na, -1)
        fmt = lambda v: '%5.2f+/-%-5.2f' % (v.mean(), v.std())
        log(' ' * 20 + '%8g %18s%18s%18s' %
            (li, fmt(b[:, :4]), fmt(b[:, 4]), fmt(b[:, 5:])))


def create_backbone(f='weights/last.npz', out='weights/backbone.npz'):
    """A checkpoint stripped down to re-trainable weights: its raw
    params and state (and quantizer state), no optimizer state, no
    results, the epoch reset."""
    from .checkpoint import load_checkpoint, save_checkpoint
    ck = load_checkpoint(f)
    save_checkpoint(out, params=ck['params'], state=ck['state'], epoch=-1,
                    best_fitness=0.0, training_results='', opt_state=None,
                    qstate=ck.get('qstate'))
    return out


def coco_class_count(path, nc: int = 80):
    """Per-class occurrence histogram over a darknet label directory:
    the (nc,) counts."""
    x = np.zeros(nc, dtype='int32')
    for file in sorted(glob.glob('%s/*.*' % path)):
        labels = np.loadtxt(file, dtype=np.float32).reshape(-1, 5)
        x += np.bincount(labels[:, 0].astype('int32'), minlength=nc)
    return x


def coco_only_people(path):
    """Label files whose boxes are all class 0: [(n_boxes, path), ...]."""
    out = []
    for file in sorted(glob.glob('%s/*.*' % path)):
        labels = np.loadtxt(file, dtype=np.float32).reshape(-1, 5)
        if len(labels) and all(labels[:, 0] == 0):
            out.append((labels.shape[0], file))
    return out


def select_best_evolve(path='evolve*.txt', log=print):
    """The fittest row of each evolve file: [(file, row), ...]."""
    from ..eval.metrics import fitness
    best = []
    for file in sorted(glob.glob(path)):
        x = np.loadtxt(file, dtype=np.float32, ndmin=2)
        row = x[fitness(x).argmax()]
        log(file, row)
        best.append((file, row))
    return best


def crop_images_random(path, scale=0.50, seed=None):
    """Crop every image in ``path`` to a random square of at most
    ``scale`` of its height. Overwrites the images."""
    import cv2
    rnd = random.Random(seed)
    for file in sorted(glob.glob('%s/*.*' % path)):
        img = cv2.imread(file)
        if img is None:
            continue
        h, w = img.shape[:2]
        a = 30
        mask_h = rnd.randint(a, int(max(a, h * scale)))
        mask_w = mask_h
        xmin = max(0, rnd.randint(0, w) - mask_w // 2)
        ymin = max(0, rnd.randint(0, h) - mask_h // 2)
        xmax = min(w, xmin + mask_w)
        ymax = min(h, ymin + mask_h)
        cv2.imwrite(file, img[ymin:ymax, xmin:xmax])


def coco_single_class_labels(path, label_class=43, out_dir='new'):
    """A single-class dataset from darknet labels: only the images that
    hold ``label_class``, its rows remapped to class 0, the images copied
    and an image list written, under ``out_dir``."""
    if os.path.exists(out_dir):
        shutil.rmtree(out_dir)
    os.makedirs(os.path.join(out_dir, 'labels'))
    os.makedirs(os.path.join(out_dir, 'images'))
    for file in sorted(glob.glob('%s/*.*' % path)):
        with open(file) as f:
            labels = np.array([x.split() for x in f.read().splitlines()],
                              dtype=np.float32).reshape(-1, 5)
        i = labels[:, 0] == label_class
        if not i.any():
            continue
        img_file = file.replace('labels', 'images').replace('txt', 'jpg')
        labels[:, 0] = 0
        with open(os.path.join(out_dir, 'images.txt'), 'a') as f:
            f.write(img_file + '\n')
        with open(os.path.join(out_dir, 'labels', Path(file).name), 'a') as f:
            for l in labels[i]:
                f.write('%g %.6f %.6f %.6f %.6f\n' % tuple(l))
        dst = os.path.join(out_dir, 'images',
                           Path(file).name.replace('txt', 'jpg'))
        if os.path.exists(img_file):
            shutil.copyfile(img_file, dst)


def apply_classifier(dets, classify_fn, img_shape_hw, im0_list):
    """Filter each image's detections by a second-stage classifier: each
    box squared and padded, cropped from the original image, resized to
    224, and kept where the classifier's class matches.
    ``classify_fn(batch NHWC float in [0, 1]) -> (n,) class indices``."""
    import cv2
    from ..ops.boxes import scale_coords
    out = []
    for i, d in enumerate(dets):
        if d is None or not len(d):
            out.append(d)
            continue
        d = np.array(d, np.float32)
        b = d[:, :4].copy()
        cxy = (b[:, :2] + b[:, 2:4]) / 2
        wh = (b[:, 2:4] - b[:, :2])
        side = wh.max(1) * 1.3 + 30                      # square + pad
        d[:, 0], d[:, 1] = cxy[:, 0] - side / 2, cxy[:, 1] - side / 2
        d[:, 2], d[:, 3] = cxy[:, 0] + side / 2, cxy[:, 1] + side / 2
        d[:, :4] = np.asarray(scale_coords(
            img_shape_hw, d[:, :4], im0_list[i].shape[:2]))
        ims = []
        for a in d:
            x1, y1, x2, y2 = (int(max(v, 0)) for v in a[:4])
            cutout = im0_list[i][y1:y2, x1:x2]
            if cutout.size == 0:
                cutout = np.zeros((8, 8, 3), np.uint8)
            im = cv2.resize(cutout, (224, 224))[:, :, ::-1]
            ims.append(np.ascontiguousarray(im, np.float32) / 255.0)
        cls2 = np.asarray(classify_fn(np.stack(ims)))
        out.append(np.array(dets[i], np.float32)[d[:, 5].astype(int) == cls2])
    return out


def plot_wh_methods(save='comparison.png'):
    """The exp and the sigmoid-power wh decodes side by side, saved."""
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt
    x = np.arange(-4.0, 4.0, .1)
    ya = np.exp(x)
    yb = 1.0 / (1.0 + np.exp(-x)) * 2
    fig = plt.figure(figsize=(6, 3), dpi=150)
    plt.plot(x, ya, '.-', label='yolo method')
    plt.plot(x, yb ** 2, '.-', label='^2 power method')
    plt.plot(x, yb ** 2.5, '.-', label='^2.5 power method')
    plt.xlim(left=-4, right=4)
    plt.ylim(bottom=0, top=6)
    plt.xlabel('input')
    plt.ylabel('output')
    plt.legend()
    fig.tight_layout()
    fig.savefig(save, dpi=200)
    plt.close(fig)
    return save


def plot_test_txt(txt='test.txt'):
    """xy-centre histograms of logged test boxes (hist2d.png, hist1d.png
    in the working directory)."""
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt
    x = np.loadtxt(txt, dtype=np.float32).reshape(-1, 4)
    cx = (x[:, 0] + x[:, 2]) / 2
    cy = (x[:, 1] + x[:, 3]) / 2
    fig, ax = plt.subplots(1, 1, figsize=(6, 6))
    ax.hist2d(cx, cy, bins=600, cmax=10, cmin=0)
    ax.set_aspect('equal')
    fig.tight_layout()
    plt.savefig('hist2d.png', dpi=300)
    plt.close(fig)
    fig, ax = plt.subplots(1, 2, figsize=(12, 6))
    ax[0].hist(cx, bins=600)
    ax[1].hist(cy, bins=600)
    fig.tight_layout()
    plt.savefig('hist1d.png', dpi=200)
    plt.close(fig)


def plot_targets_txt(txt='targets.txt', save='targets.jpg'):
    """Histograms of logged target xywh, saved."""
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt
    x = np.loadtxt(txt, dtype=np.float32).reshape(-1, 4).T
    s = ['x targets', 'y targets', 'width targets', 'height targets']
    fig, ax = plt.subplots(2, 2, figsize=(8, 8))
    ax = ax.ravel()
    for i in range(4):
        ax[i].hist(x[i], bins=100,
                   label='%.3g +/- %.3g' % (x[i].mean(), x[i].std()))
        ax[i].legend()
        ax[i].set_title(s[i])
    fig.tight_layout()
    plt.savefig(save, dpi=200)
    plt.close(fig)
    return save


def plot_results_overlay(start=0, stop=0, pattern='results*.txt'):
    """Train and val loss curves of every results file overlaid; saves
    <name>.png next to each txt."""
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt
    s = ['train', 'train', 'train', 'Precision', 'mAP@0.5',
         'val', 'val', 'val', 'Recall', 'F1']
    t = ['GIoU', 'Objectness', 'Classification', 'P-R', 'mAP-F1']
    saved = []
    for f in sorted(glob.glob(pattern)):
        # results.txt columns: epoch, mloss(4), P, R, mAP, F1, val(3)
        results = np.loadtxt(
            f, usecols=[1, 2, 3, 5, 7, 9, 10, 11, 6, 8], ndmin=2).T
        n = results.shape[1]
        x = range(start, min(stop, n) if stop else n)
        fig, ax = plt.subplots(1, 5, figsize=(14, 3.5))
        ax = ax.ravel()
        for i in range(5):
            for j in (i, i + 5):
                y = results[j, list(x)].astype(np.float64)
                if i in (0, 1, 2):
                    y[y == 0] = np.nan
                ax[i].plot(x, y, marker='.', label=s[j])
            ax[i].set_title(t[i])
            ax[i].legend()
            if i == 0:
                ax[i].set_ylabel(f)
        fig.tight_layout()
        out = f.replace('.txt', '.png')
        fig.savefig(out, dpi=200)
        plt.close(fig)
        saved.append(out)
    return saved
