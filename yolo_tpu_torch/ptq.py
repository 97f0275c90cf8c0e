"""Post-training quantization CLI of the PyTorch port, ``python -m
yolo_tpu_torch.ptq`` (counterpart of the root ``PTQ.py``, which belongs to
the JAX package).

    python -m yolo_tpu_torch.ptq --cfg cfg/yolov4/yolov4.cfg \\
        --data data_cfg/coco2014.data --weights weights/yolov4.npz \\
        --img-size 608 --batch-size 8 --subset-len 32 --int8-engine

Loads the float model and its cos-PTQ twin (``quantized=3``) from the same
weights, evaluates the float model, calibrates the twin with train-mode
forwards over ``--subset-len`` train images (each batch votes for every
quantizer's pow-2 scale by cosine similarity; the BN running statistics
are an EMA of the batches), evaluates the fake-quant sim and, with
``--int8-engine``, the true-int8 engine (K2 convs, K1 in the NMS), then
writes ``--out`` (params and BN state) and ``<out>_qstate.npz`` (the
quantizer state) in the ``.npz`` layout both packages read. It runs on the
card unless ``--device cpu``; ``--no-eval`` skips the evaluations.
"""

from __future__ import annotations

from .utils.cli import FlexParser


def parse_args(argv=None):
    p = FlexParser()
    p.add_argument('--cfg', type=str, default='cfg/yolov3/yolov3.cfg')
    p.add_argument('--data', type=str, default='data_cfg/coco2014.data')
    p.add_argument('--weights', type=str, default='weights/last.npz')
    p.add_argument('--img-size', type=int, default=416)
    p.add_argument('--batch-size', type=int, default=16)
    p.add_argument('--subset-len', '--subset_len', dest='subset_len',
                   type=int, default=32,
                   help='calibration images drawn from the train set')
    p.add_argument('--gray-scale', '--gray_scale', dest='gray_scale',
                   action='store_true')
    p.add_argument('--maxabsscaler', '-mas', action='store_true')
    p.add_argument('--single-cls', action='store_true')
    p.add_argument('--augment', action='store_true',
                   help='accepted for CLI compat; calibration always runs '
                        'single-pass')
    p.add_argument('--device', type=str, default='cuda',
                   help="torch device ('cuda', 'cuda:1', 'cpu')")
    p.add_argument('--a-bit', type=int, default=8)
    p.add_argument('--w-bit', type=int, default=8)
    p.add_argument('--shortcut_way', type=int, default=1)
    p.add_argument('--out', type=str, default='weights/PTQ.npz')
    p.add_argument('--no-eval', action='store_true')
    p.add_argument('--int8-engine', action='store_true',
                   help='also evaluate the calibrated model on the true-int8 '
                        'engine (K2 convs, int8 edges)')
    return p.parse_args(argv)


def main(argv=None):
    """Run the PTQ flow; returns {'float', 'sim', 'engine': the evaluate
    results tuple (P, R, mAP@0.5, F1, val losses) or None}."""
    opt = parse_args(argv)
    from .config import parse_data_cfg
    from .convert import qstate_to_jax, to_jax
    from .data.datasets import BatchLoader, DetectionDataset
    from .eval.evaluator import evaluate, int8_engine_apply
    from .runtime import load_model, preprocess
    from .utils.checkpoint import save_checkpoint

    data_dict = parse_data_cfg(opt.data)
    common = dict(device=opt.device, is_gray_scale=opt.gray_scale,
                  maxabsscaler=opt.maxabsscaler)
    float_bundle = load_model(opt.cfg, opt.weights, **common)
    q_bundle = load_model(opt.cfg, opt.weights, quantized=3, a_bit=opt.a_bit,
                          w_bit=opt.w_bit, shortcut_way=opt.shortcut_way,
                          **common)
    net, dev = q_bundle.net, q_bundle.device
    ev = dict(batch_size=opt.batch_size, img_size=opt.img_size,
              single_cls=opt.single_cls, is_gray_scale=opt.gray_scale,
              maxabsscaler=opt.maxabsscaler, device=dev)
    results = {'float': None, 'sim': None, 'engine': None}

    if not opt.no_eval:
        print('evaluating the float model...')
        results['float'] = evaluate(net, float_bundle.params,
                                    float_bundle.state, opt.data, **ev)[0]
    del float_bundle

    # calibration: train-mode forwards run the cos-similarity scale search
    with open(data_dict['train']) as f:
        n_train = sum(1 for _ in f)
    ds = DetectionDataset(data_dict['train'], opt.img_size, opt.batch_size,
                          subset_len=min(opt.subset_len, n_train),
                          is_gray_scale=opt.gray_scale, seed=0)
    for imgs, _, _, _, _ in BatchLoader(ds, opt.batch_size):
        q_bundle.apply(preprocess(imgs, opt.maxabsscaler, device=dev),
                       train=True)

    if not opt.no_eval:
        print('evaluating the quantized model...')
        results['sim'] = evaluate(net, q_bundle.params, q_bundle.state,
                                  opt.data, quant_apply=q_bundle.quant_apply(),
                                  qstate=q_bundle.qstate, **ev)[0]

    if opt.int8_engine and not opt.no_eval:
        print('evaluating the true-int8 engine...')
        arrays, eng = int8_engine_apply(net, q_bundle.params, q_bundle.state,
                                        q_bundle.qstate, q_bundle.qcfg, dev)
        results['engine'] = evaluate(net, arrays, {}, opt.data,
                                     quant_apply=eng, qstate=None, **ev)[0]

    params, state = to_jax(net, q_bundle.params, q_bundle.state)
    save_checkpoint(opt.out, params=params, state=state,
                    extra={'quantized': 3, 'a_bit': opt.a_bit,
                           'w_bit': opt.w_bit})
    stem = opt.out[:-len('.npz')] if opt.out.endswith('.npz') else opt.out
    save_checkpoint(stem + '_qstate.npz', params=qstate_to_jax(q_bundle.qstate),
                    state={})
    print(f'saved calibrated model to {opt.out}')
    return results


if __name__ == '__main__':
    main()
