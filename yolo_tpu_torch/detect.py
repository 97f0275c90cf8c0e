"""Detection CLI of the PyTorch port: images and videos from a file or a
directory, or live sources, forward + decode + NMS on one device, boxes
rescaled to the original frames, drawn and saved.

    python -m yolo_tpu_torch.detect --cfg cfg/yolov3/yolov3.cfg \\
        --weights weights/last.npz --source data/samples --device cuda

    python -m yolo_tpu_torch.detect --cfg cfg/yolov3/yolov3.cfg \\
        --weights weights/calibrated.npz --quantized 1 --source data/samples

    python -m yolo_tpu_torch.detect --cfg cfg/yolov3/yolov3.cfg \\
        --weights weights/best.pt --augment --source data/samples

    python -m yolo_tpu_torch.detect --cfg cfg/yolov3/yolov3.cfg \\
        --weights weights/last.npz --source streams.txt

The flags are those of the root ``detect.py``. ``--weights`` takes a .npz
of the JAX package, a .pt of the PyTorch reference or darknet .weights.
``--quantized N`` (1-6, the schemes of ``compress/quant.SCHEMES``) serves a
quantized checkpoint (its ``qstate`` key or a sibling ``_qstate.npz``): the
true-int8 engine for google (1) and cos-PTQ (3), the fake-quant sim for
the others. ``--augment`` runs test-time augmentation on a float model.
``--quantizer_output`` (with ``--reorder``, ``--TM``, ``--TN`` and
``--layer_idx``) dumps the FPGA cross-check artifacts of a quantized model
into ``./quantizer_output`` once, on the first preprocessed image
(``compress/fpga_export.py``): the per-layer integer weights, biases,
shift exponents and activations, the input dumps under ``--maxabsscaler``
and, for the whole net, the upsample layers' streams.
``--source 0`` reads the local camera (``LoadWebcam``); an ``rtsp://`` or
``http://`` URL, or a ``.txt`` listing such sources (or video files) one a
line, reads them all at once (``LoadStreams``): each frame step of every
stream goes through one forward, and each stream's frames are drawn and
written into a video of its name (``--fourcc``), as a video file's are.
The JAX package's CLI writes them with ``cv2.imwrite`` instead, which
OpenCV refuses for a video's name. ``--view-img`` and ``--FPGA`` are accepted
and ignored, as the JAX package's CLI does.
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
    p.add_argument('--view-img', action='store_true',
                   help='accepted and ignored, as in the root detect.py')
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
                   help='-1 float, 1 google QAT, 2 TPSQ, 3 cos-PTQ, '
                        '4 DoReFa, 5 binary-W, 6 ternary-W')
    p.add_argument('--a-bit', '--a_bit', dest='a_bit', type=int, default=8)
    p.add_argument('--w-bit', '--w_bit', dest='w_bit', type=int, default=8)
    p.add_argument('--shortcut_way', type=int, default=1)
    p.add_argument('--augment', action='store_true',
                   help='test-time augmentation (float models)')
    p.add_argument('--quantizer_output', action='store_true',
                   help='dump per-layer FPGA cross-check artifacts')
    p.add_argument('--reorder', action='store_true')
    p.add_argument('--TM', type=int, default=32)
    p.add_argument('--TN', type=int, default=32)
    p.add_argument('--layer_idx', type=int, default=-1,
                   help='restrict --quantizer_output dumps to one layer')
    p.add_argument('--FPGA', action='store_true',
                   help='accepted and ignored, as in the root detect.py')
    return p.parse_args(argv)


def main(argv=None):
    opt = parse_args(argv)
    # OpenCV is needed only here, for reading and drawing images
    import cv2
    from .config import load_classes, parse_data_cfg
    from .data import datasets
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
    src = opt.source
    if src == '0':
        dataset = datasets.LoadWebcam(0, img_size=opt.img_size)
    elif src.startswith(('rtsp', 'http')) or src.endswith('.txt'):
        dataset = datasets.LoadStreams(src, img_size=opt.img_size)
    else:
        dataset = datasets.LoadImages(src, img_size=opt.img_size,
                                      is_gray_scale=opt.gray_scale,
                                      rect=opt.rect)
    vid_writers = {}            # save path -> its cv2.VideoWriter
    bs = max(1, opt.batch_size)
    dump_pending = bool(opt.quantizer_output)

    def maybe_dump(x_u8):
        """The FPGA dumps, once, on the first preprocessed image."""
        nonlocal dump_pending
        if not dump_pending:
            return
        dump_pending = False
        if not bundle.quantized:
            print('--quantizer_output ignored: model is not quantized')
            return
        from .compress.fpga_export import (dump_input_artifacts,
                                           dump_quantizer_output,
                                           upsample_activation_dumps)
        xin = preprocess(x_u8[:1], opt.maxabsscaler, device=device)
        dump_quantizer_output(bundle, x=xin, reorder=opt.reorder, TM=opt.TM,
                              TN=opt.TN, layer_idx=opt.layer_idx)
        if opt.maxabsscaler:
            dump_input_artifacts(x_u8[0], bundle.qcfg.a_bits)
        if opt.layer_idx == -1:
            upsample_activation_dumps(bundle.net, TN=opt.TN)

    def handle(path, shape_hw, det, im0, vid_cap, dt, video=False):
        """Draw ``det`` on ``im0`` and save it: an image as an image, a
        frame of a video, the camera or a stream (``video``) into the
        video of its name."""
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
        if dataset.mode == 'images' and not video:
            cv2.imwrite(save_path, im0)
            return
        if save_path not in vid_writers:
            fps = vid_cap.get(cv2.CAP_PROP_FPS) if vid_cap else 30
            h, w = im0.shape[:2]
            vid_writers[save_path] = cv2.VideoWriter(
                save_path, cv2.VideoWriter_fourcc(*opt.fourcc), fps, (w, h))
        vid_writers[save_path].write(im0)

    def detect(x):
        """Detections of the uint8 NHWC batch ``x`` and the seconds an
        image."""
        maybe_dump(x)
        t0 = time.time()
        dets = to_host_detections(
            infer(preprocess(x, opt.maxabsscaler, device=device)))
        return dets, (time.time() - t0) / len(x)

    def flush(buf):
        if not buf:
            return
        x = np.stack([np.ascontiguousarray(b[1].transpose(1, 2, 0))
                      for b in buf])
        if len(buf) < bs:
            x = np.concatenate([x, np.repeat(x[-1:], bs - len(buf), axis=0)])
        dets, dt = detect(x)
        for (path, img, im0, vid_cap), det in zip(buf, dets):
            handle(path, img.shape[1:3], det, im0, vid_cap, dt)

    try:
        buf = []
        for item in dataset:
            if item[1].ndim == 4:
                # a frame of every stream (S, 3, H, W): one forward
                paths, img, im0s, _ = item
                dets, dt = detect(np.ascontiguousarray(
                    img.transpose(0, 2, 3, 1)))
                for path, det, im0 in zip(paths, dets, im0s):
                    handle(path, img.shape[2:4], det, im0, None, dt,
                           video=True)
                continue
            if buf and item[1].shape != buf[0][1].shape:
                flush(buf)
                buf = []
            buf.append(item)
            if len(buf) >= bs:
                flush(buf)
                buf = []
        flush(buf)
    finally:
        for w in vid_writers.values():
            w.release()
    print(f'Results saved to {opt.output}')


if __name__ == '__main__':
    main()
