"""Detection CLI of the PyTorch port: images and videos from a file or a
directory, forward + decode + NMS on one device, boxes rescaled to the
original frames, drawn and saved.

    python -m yolo_tpu_torch.detect --cfg cfg/yolov3/yolov3.cfg \\
        --weights weights/last.npz --source data/samples --device cuda

    python -m yolo_tpu_torch.detect --cfg cfg/yolov3/yolov3.cfg \\
        --weights weights/calibrated.npz --quantized 1 --source data/samples

    python -m yolo_tpu_torch.detect --cfg cfg/yolov3/yolov3.cfg \\
        --weights weights/best.pt --augment --source data/samples

The flags are those of the root ``detect.py``. ``--weights`` takes a .npz
of the JAX package, a .pt of the PyTorch reference or darknet .weights.
``--quantized 1`` runs the true-int8 engine on a calibrated google-scheme
checkpoint (its ``qstate`` key or a sibling ``_qstate.npz``).
``--augment`` runs test-time augmentation on a float model. Other schemes
and stream sources are not ported yet (see ROADMAP.md).
"""

from __future__ import annotations

import os
import time
from pathlib import Path

import numpy as np
import torch

from .utils.cli import FlexParser


def parse_args(argv=None):
    p = FlexParser()
    p.add_argument('--cfg', type=str, default='cfg/yolov3/yolov3.cfg')
    p.add_argument('--data', type=str, default='data_cfg/coco2014.data')
    p.add_argument('--weights', type=str, default='weights/last.npz')
    p.add_argument('--source', type=str, default='data/samples')
    p.add_argument('--output', type=str, default='output')
    p.add_argument('--img-size', type=int, default=416)
    p.add_argument('--batch-size', type=int, default=1,
                   help='frames per forward (the last partial batch is '
                        'padded by repeating its last frame)')
    p.add_argument('--conf-thres', type=float, default=0.3)
    p.add_argument('--iou-thres', type=float, default=0.6)
    p.add_argument('--classes', nargs='+', type=int)
    p.add_argument('--agnostic-nms', action='store_true')
    p.add_argument('--save-txt', action='store_true')
    p.add_argument('--gray-scale', '--gray_scale', dest='gray_scale',
                   action='store_true')
    p.add_argument('--maxabsscaler', '-mas', action='store_true')
    p.add_argument('--names', type=str, default='',
                   help='*.names path (overrides the .data names entry)')
    p.add_argument('--rect', action='store_true',
                   help='rectangular letterbox (minimal 64-multiple pad)')
    p.add_argument('--fourcc', type=str, default='mp4v',
                   help='output video codec')
    p.add_argument('--device', type=str, default='',
                   help="torch device ('cuda', 'cuda:1', 'cpu'); default: "
                        "cuda")
    p.add_argument('--quantized', type=int, default=-1,
                   help='-1 float; 1 the int8 engine (google scheme)')
    p.add_argument('--a-bit', '--a_bit', dest='a_bit', type=int, default=8)
    p.add_argument('--w-bit', '--w_bit', dest='w_bit', type=int, default=8)
    p.add_argument('--shortcut_way', type=int, default=1)
    p.add_argument('--augment', action='store_true',
                   help='test-time augmentation (float models)')
    return p.parse_args(argv)


def main(argv=None):
    opt = parse_args(argv)
    # OpenCV is needed only here, for reading and drawing images
    import cv2
    from .config import load_classes, parse_data_cfg
    from .data.datasets import LoadImages
    from .utils.plots import color_for_class, plot_one_box

    from .ops.boxes import scale_coords
    from .ops.nms import to_host_detections
    from .runtime import load_model, preprocess

    device = torch.device(opt.device or 'cuda')
    os.makedirs(opt.output, exist_ok=True)
    names = load_classes(opt.names or parse_data_cfg(opt.data)['names'])
    bundle = load_model(opt.cfg, opt.weights, device=device,
                        quantized=opt.quantized, a_bit=opt.a_bit,
                        w_bit=opt.w_bit, shortcut_way=opt.shortcut_way,
                        is_gray_scale=opt.gray_scale,
                        maxabsscaler=opt.maxabsscaler)
    if not bundle.quantized:
        bundle = bundle.fuse()
    infer = bundle.make_infer(conf_thres=opt.conf_thres,
                              iou_thres=opt.iou_thres,
                              agnostic=opt.agnostic_nms, augment=opt.augment,
                              classes=tuple(opt.classes) if opt.classes
                              else None)
    dataset = LoadImages(opt.source, img_size=opt.img_size,
                         is_gray_scale=opt.gray_scale, rect=opt.rect)
    vid_writer = None
    bs = max(1, opt.batch_size)

    def handle(path, shape_hw, det, im0, vid_cap, dt):
        nonlocal vid_writer
        s = f'{path}: {shape_hw[1]}x{shape_hw[0]} '
        save_path = str(Path(opt.output) / Path(path).name)
        if det is not None and len(det):
            det[:, :4] = scale_coords(shape_hw, det[:, :4], im0.shape[:2]).numpy()
            for c in np.unique(det[:, 5].astype(int)):
                s += f'{int((det[:, 5] == c).sum())} {names[c]}s, '
            for *xyxy, conf, cls in det:
                plot_one_box(xyxy, im0, label=f'{names[int(cls)]} {conf:.2f}',
                             color=color_for_class(int(cls)))
                if opt.save_txt:
                    with open(save_path.rsplit('.', 1)[0] + '.txt', 'a') as f:
                        f.write(('%g ' * 6 + '\n') % (*xyxy, cls, conf))
        print(f'{s}Done. ({dt:.3f}s)')
        if dataset.mode == 'images':
            cv2.imwrite(save_path, im0)
            return
        if vid_writer is None:
            fps = vid_cap.get(cv2.CAP_PROP_FPS) if vid_cap else 30
            h, w = im0.shape[:2]
            vid_writer = cv2.VideoWriter(
                save_path, cv2.VideoWriter_fourcc(*opt.fourcc), fps, (w, h))
        vid_writer.write(im0)

    def flush(buf):
        if not buf:
            return
        x = np.stack([np.ascontiguousarray(b[1].transpose(1, 2, 0))
                      for b in buf])
        if len(buf) < bs:
            x = np.concatenate([x, np.repeat(x[-1:], bs - len(buf), axis=0)])
        t0 = time.time()
        dets = to_host_detections(
            infer(preprocess(x, opt.maxabsscaler, device=device)))
        dt = (time.time() - t0) / len(buf)
        for (path, img, im0, vid_cap), det in zip(buf, dets):
            handle(path, img.shape[1:3], det, im0, vid_cap, dt)

    try:
        buf = []
        for item in dataset:
            if buf and item[1].shape != buf[0][1].shape:
                flush(buf)
                buf = []
            buf.append(item)
            if len(buf) >= bs:
                flush(buf)
                buf = []
        flush(buf)
    finally:
        if vid_writer is not None:
            vid_writer.release()
    print(f'Results saved to {opt.output}')


if __name__ == '__main__':
    main()
