"""FPGA artifacts of a quantized model (counterpart of
``yolo_tpu/compress/fpga_export.py``): the per-layer ``quantizer_output``
dumps, the TM/TN tiled reorder, and the packed weight/bias binaries of
``python -m yolo_tpu_torch.convert_fpga``.

The exporter is numpy on the host, over the IR, the BN-fused weights
(``quant.bn_fuse_weights``, HWIO) and the quantizer state; only the
activation dump runs the model (``collect_activations``: the fake-quant
sim with ``capture_trace`` in eval mode, on the bundle's device). The
files it writes have the JAX exporter's names, formats and bytes.

Artifacts per conv layer (name = '%04d_conv' % layer_idx):
  q_weight_out/q_weight_<name>.txt       integer weights (flattened OIHW)
  w_scale_out/w_scale_<name>.txt         shift exponent  (-log2 scale)
  q_bias_out/q_bias_<name>.txt, b_scale_out/b_scale_<name>.txt
  q_weight_max/, max_weight_count/       overflow statistics
  q_weight_reorder/<name>_bias_weight_q_bin   TM*TN-tiled int8 stream
  a_scale_out/a_scale_<name>.txt + q_activation_* (when an input is given)
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from ..ir import NetworkIR
from .quant import QuantConfig, qrange


def _host_float(v) -> float:
    return float(v.detach().cpu()) if torch.is_tensor(v) else float(
        np.asarray(v))


def _shift_exponent(scale: float) -> float:
    return -math.log2(scale) if scale > 0 else 0.0


def reorder_weights(w_oihw: np.ndarray, TM: int, TN: int,
                    linear: bool = False) -> np.ndarray:
    """TM x TN tiled weight reorder of the FPGA's SRAM layout: per (TM,
    TN) tile, K^2-major then TM, TN. First-layer (Cin in {1, 3}) tiles are
    zero-padded to TN."""
    O, I, kh, kw = w_oihw.shape
    k2 = kh * kw
    num_TM, rem_TM = divmod(O, TM)
    num_TN, rem_TN = divmod(I, TN)
    chunks = []
    if linear:
        for k in range(num_TN):
            t = w_oihw[0:rem_TM, k * TN:(k + 1) * TN].reshape(rem_TM, TN, k2)
            chunks.append(t.transpose(2, 0, 1).reshape(-1))
    elif I in (1, 3):
        for j in range(num_TM):
            t = w_oihw[j * TM:(j + 1) * TM, num_TN * TN:num_TN * TN + rem_TN]
            t = t.reshape(TM, rem_TN, k2)
            fill = np.zeros((TM, TN, k2), t.dtype)
            fill[:, :rem_TN] = t
            chunks.append(fill.transpose(2, 0, 1).reshape(-1))
    else:
        for j in range(num_TM):
            for k in range(num_TN):
                t = w_oihw[j * TM:(j + 1) * TM, k * TN:(k + 1) * TN]
                t = t.reshape(TM, TN, k2)
                chunks.append(t.transpose(2, 0, 1).reshape(-1))
    return np.concatenate(chunks) if chunks else np.zeros(0, w_oihw.dtype)


def reorder_activations(a_chw: np.ndarray, TN: int,
                        linear: bool = False) -> np.ndarray:
    """Activation tile reorder: per TN channel group, HWC-flattened."""
    C = a_chw.shape[0]
    num_TN, rem_TN = divmod(C, TN)
    chunks = []
    if linear:
        t = a_chw[0:rem_TN]
        chunks.append(t.transpose(1, 2, 0).reshape(-1))
    else:
        for k in range(num_TN):
            t = a_chw[k * TN:(k + 1) * TN]
            chunks.append(t.transpose(1, 2, 0).reshape(-1))
    return np.concatenate(chunks) if chunks else np.zeros(0, a_chw.dtype)


def _write_txt(path, arr):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savetxt(path, np.asarray(arr).reshape(1, -1), delimiter='\n')


def _write_bin(path, arr, dtype=np.int8):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.asarray(arr).astype(dtype).tofile(path)


def _conv_scales(bundle, k):
    """Per-site ((w_step, w_scale), (b_step, b_scale), (a_step, a_scale))
    of conv layer ``k``: *step* quantizes (divide + round), *scale*
    dequantizes (what the hardware multiplies by; the shift files carry
    its exponent).

    google/ptq_cos: the tracker scales of qstate, step == scale.
    tpsq: the pow-2 ranges of the scale params (``search_pow2``'s value),
    quant step p2/(2^{b-1}-1) saturating at the grid edge, dequant grid
    p2/2^{b-1}, as the int8 engine's plan takes them. Other schemes
    (dorefa/binary/ternary) have no pow-2 grid: step=scale=1."""
    cfg = bundle.qcfg
    if cfg.scheme == 'tpsq':
        from ..models.int8_engine import _tpsq_p2
        p = bundle.params[k]
        wq, wd = (1 << (cfg.w_bits - 1)) - 1, 1 << (cfg.w_bits - 1)
        aq, ad = (1 << (cfg.a_bits - 1)) - 1, 1 << (cfg.a_bits - 1)
        p2w, p2b, p2a = (_tpsq_p2(p['w_scale']), _tpsq_p2(p['b_scale']),
                         _tpsq_p2(p['a_scale']))
        return ((p2w / wq, p2w / wd), (p2b / wq, p2b / wd),
                (p2a / aq, p2a / ad))
    qs = (bundle.qstate or {}).get(k, {})

    def pair(site):
        s = _host_float(qs.get(site, {}).get('scale', 1.0))
        return s, s

    return pair('wq'), pair('bq'), pair('aq')


def dump_quantizer_output(bundle, x=None, outdir='./quantizer_output', *,
                          reorder=False, TM=32, TN=32, layer_idx=-1):
    """Dump per-layer quantized weights and biases (and activations if an
    NHWC input ``x`` is given) for hardware cross-checking; ``layer_idx``
    other than -1 dumps that layer alone. ``bundle`` is a quantized
    ``runtime.ModelBundle``."""
    from .quant import bn_fuse_weights
    assert bundle.quantized, 'quantizer_output requires a quantized model'
    cfg: QuantConfig = bundle.qcfg
    net: NetworkIR = bundle.net
    fused = bn_fuse_weights(net, bundle.params, bundle.state)
    qmin_w, qmax_w = qrange(cfg.w_bits, True)

    acts = None
    if x is not None:
        acts = collect_activations(bundle, x)

    for lyr in net.layers:
        if lyr.kind not in ('conv', 'depthwise'):
            continue
        if layer_idx != -1 and lyr.index != layer_idx:
            continue
        name = f'{lyr.index:04d}_conv'
        w, b = fused[lyr.index]
        ((w_step, w_scale), (b_step, b_scale),
         (a_step, a_scale)) = _conv_scales(bundle, str(lyr.index))

        q_w = np.clip(np.sign(w / w_step) * np.floor(np.abs(w / w_step) + 0.5),
                      qmin_w, qmax_w)
        q_b = np.clip(np.sign(b / b_step) * np.floor(np.abs(b / b_step) + 0.5),
                      qmin_w, qmax_w)
        q_w_oihw = q_w.transpose(3, 2, 0, 1)          # HWIO -> OIHW

        _write_txt(f'{outdir}/w_scale_out/w_scale_{name}.txt',
                   [_shift_exponent(w_scale)])
        _write_txt(f'{outdir}/b_scale_out/b_scale_{name}.txt',
                   [_shift_exponent(b_scale)])
        _write_txt(f'{outdir}/a_scale_out/a_scale_{name}.txt',
                   [_shift_exponent(a_scale)])
        _write_txt(f'{outdir}/q_weight_out/q_weight_{name}.txt', q_w_oihw)
        _write_txt(f'{outdir}/q_bias_out/q_bias_{name}.txt', q_b)
        _write_txt(f'{outdir}/q_weight_max/max_w_{name}.txt', [q_w_oihw.max()])
        _write_txt(f'{outdir}/max_weight_count/max_w_count_{name}.txt',
                   [int((np.abs(q_w_oihw) >= qmax_w).sum())])
        if reorder:
            rw = reorder_weights(q_w_oihw, TM, TN,
                                 linear=(lyr.activation == 'linear'))
            _write_txt(f'{outdir}/q_weight_reorder/w_reorder_{name}.txt', rw)
            b_pad = np.zeros(2048, int)
            b_pad[:q_b.size] = q_b.reshape(-1)
            _write_txt(f'{outdir}/q_bias_reorder/q_b_reorder_{name}.txt', b_pad)
            _write_bin(f'{outdir}/q_weight_reorder/{name}_bias_weight_q_bin',
                       np.concatenate([b_pad, rw]))

        if acts is not None and lyr.index in acts:
            a = acts[lyr.index]                        # (h, w, c) float
            q_a = np.clip(np.sign(a / a_step) *
                          np.floor(np.abs(a / a_step) + 0.5),
                          *qrange(cfg.a_bits, True))
            q_a_chw = q_a.transpose(2, 0, 1)
            _write_txt(f'{outdir}/q_activation_out/q_activation_{name}.txt',
                       q_a_chw)
            _write_txt(f'{outdir}/q_activation_max/q_a_max_{name}.txt',
                       [q_a_chw.max()])
            _write_txt(f'{outdir}/max_activation_count/max_a_count_{name}.txt',
                       [int((np.abs(q_a_chw) >= (1 << (cfg.a_bits - 1)) - 1)
                            .sum())])
            if reorder:
                ra = reorder_activations(q_a_chw, TN,
                                         linear=(lyr.activation == 'linear'))
                _write_txt(f'{outdir}/q_activation_reorder/a_reorder_{name}.txt',
                           ra)
                _write_bin(f'{outdir}/q_activation_reorder/{name}_activation_q_bin',
                           ra)
    return outdir


def collect_activations(bundle, x):
    """Every conv layer's post-activation output of the first batch
    element, (h, w, c) numpy on the host, from the fake-quant sim with
    ``capture_trace`` in eval mode (the deployed graph: the BN fold on the
    running statistics) on the bundle's device, the MACs in its dtype.
    Head convs are dumped too."""
    from .quant import make_quant_apply
    apply = make_quant_apply(
        bundle.net, bundle.qcfg,
        compute_dtype=None if bundle.dtype == torch.float32 else bundle.dtype,
        capture_trace=True)
    x = torch.as_tensor(x).to(bundle.device)
    with torch.inference_mode():
        *_, trace = apply(bundle.params, bundle.state, bundle.qstate, x,
                          False)
        return {l.index: _host_array(trace[str(l.index)][0])
                for l in bundle.net.layers
                if l.kind in ('conv', 'depthwise')}


def _host_array(t):
    """A tensor as a numpy array of its own dtype; bf16, which numpy
    lacks, widens to f32."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def export_fpga_weights(bundle, outdir='fpga_export', *, reorder=False,
                        TM=32, TN=32):
    """The packed integer weight and bias streams and the per-layer shift
    exponents of every conv (``python -m yolo_tpu_torch.convert_fpga``).

    weights.bin/biases.bin: the little-endian int stream (``<i1``, ``<i2``
    at 16 bits) of the BN-fused, pow-2-quantized values in graph order,
    each conv's weights OIHW (or TM/TN-tiled with ``reorder``); the scale
    files are ``<i4`` shift exponents (-log2 scale, truncated toward zero),
    a_scale.bin prefixed by the input's Q (7 at 8 bits, 14 at 16) and
    s_scale.bin carrying the quantized shortcuts' post-sum scales."""
    from .quant import bn_fuse_weights
    cfg = bundle.qcfg
    bits = cfg.w_bits if cfg else 8
    dtype = np.dtype('<i1') if bits <= 8 else np.dtype('<i2')
    os.makedirs(outdir, exist_ok=True)
    fused = bn_fuse_weights(bundle.net, bundle.params, bundle.state)
    qmin, qmax = qrange(bits, True)

    all_w, all_b = [], []
    w_shifts, b_shifts, s_shifts = [], [], []
    a_shifts = [14 if bits == 16 else 7]      # input Q prefix (Q14 / Q7)
    for lyr in bundle.net.layers:
        k = str(lyr.index)
        qs = (bundle.qstate or {}).get(k, {})
        if lyr.kind == 'shortcut':
            if 'scale' in qs:                 # quantized shortcut only
                s_shifts.append(_shift_exponent(_host_float(qs['scale'])))
            continue
        if lyr.kind not in ('conv', 'depthwise'):
            continue
        ((w_step, w_scale), (b_step, b_scale),
         (a_step, a_scale)) = _conv_scales(bundle, k)
        w, b = fused[lyr.index]
        q_w = np.clip(np.sign(w / w_step) * np.floor(np.abs(w / w_step) + .5),
                      qmin, qmax).transpose(3, 2, 0, 1)
        q_b = np.clip(np.sign(b / b_step) * np.floor(np.abs(b / b_step) + .5),
                      qmin, qmax)
        if reorder:
            q_w_flat = reorder_weights(q_w, TM, TN,
                                       linear=(lyr.activation == 'linear'))
        else:
            q_w_flat = q_w.reshape(-1)
        all_w.append(q_w_flat.astype(dtype))
        all_b.append(q_b.reshape(-1).astype(dtype))
        w_shifts.append(_shift_exponent(w_scale))
        b_shifts.append(_shift_exponent(b_scale))
        a_shifts.append(_shift_exponent(a_scale))

    np.concatenate(all_w).tofile(os.path.join(outdir, 'weights.bin'))
    np.concatenate(all_b).tofile(os.path.join(outdir, 'biases.bin'))
    np.asarray(w_shifts, '<i4').tofile(os.path.join(outdir, 'w_scale.bin'))
    np.asarray(b_shifts, '<i4').tofile(os.path.join(outdir, 'b_scale.bin'))
    np.asarray(a_shifts, '<i4').tofile(os.path.join(outdir, 'a_scale.bin'))
    np.asarray(s_shifts, '<i4').tofile(os.path.join(outdir, 's_scale.bin'))
    return outdir


def dump_input_artifacts(img_hwc, a_bits=8, outdir='./quantizer_output'):
    """The ``--maxabsscaler`` input dumps: ``img_input.txt``/``img_bin``,
    the raw 0-255 CHW stream; ``q_img_input.txt``/``q_img_bin``, the
    (x/256·2-1)·2^(a_bits-1) grid the first conv consumes;
    ``not0_count.txt``, the positions where the hardware's integer path
    (x-128) disagrees with the software quantization (0 at 8 bits). The
    float CHW stream is cast with numpy's wrapping int8 conversion, as the
    reference does."""
    os.makedirs(outdir, exist_ok=True)
    img = np.asarray(img_hwc, np.float32).transpose(2, 0, 1).reshape(-1)
    _write_txt(os.path.join(outdir, 'img_input.txt'), img)
    _write_bin(os.path.join(outdir, 'img_bin'), img)
    q_img = (img / 256.0 * 2.0 - 1.0) * float(1 << (a_bits - 1))
    delt = (img - 128.0) - q_img
    _write_txt(os.path.join(outdir, 'not0_count.txt'),
               [int((np.abs(delt) > 0).sum())])
    _write_txt(os.path.join(outdir, 'q_img_input.txt'), q_img)
    _write_bin(os.path.join(outdir, 'q_img_bin'), q_img)
    return outdir


def upsample_activation_dumps(net, outdir='./quantizer_output', *, TN=32):
    """Nearest upsample + TN reorder of the dumped activations of each
    conv that feeds an upsample layer, after a ``--quantizer_output``
    forward, so the upsample layers' SRAM streams are dumped too. The
    channel count comes from the IR and the spatial size from the dump
    (square); a partial TN tile is dropped, as the reference drops it.
    Per upsample layer L: q_activation_reorder/{L}_upsample_reorder.txt,
    {L}_upsample_q_bin, and a_scale_out/{L}_upsample_scale.txt (the source
    conv's shift exponent: nearest upsampling keeps the scale). Returns
    the upsample layers written, None without activation dumps."""
    src_dir = os.path.join(outdir, 'q_activation_out')
    if not os.path.isdir(src_dir):
        return None
    rdir = os.path.join(outdir, 'q_activation_reorder')
    os.makedirs(rdir, exist_ok=True)
    written = []
    for lyr in net.layers:
        if lyr.kind != 'upsample' or lyr.index == 0:
            continue
        src = net.layers[lyr.index - 1]
        if src.kind not in ('conv', 'depthwise'):
            continue
        name = f'{src.index:04d}_conv'
        act_f = os.path.join(src_dir, f'q_activation_{name}.txt')
        if not os.path.isfile(act_f):
            continue
        flat = np.loadtxt(act_f)
        c = src.filters
        side = int(round((flat.size // c) ** 0.5))
        a_chw = flat.reshape(c, side, side)
        s = int(lyr.stride)
        up = np.repeat(np.repeat(a_chw, s, axis=1), s, axis=2)
        ra = reorder_activations(up, TN)
        _write_txt(os.path.join(rdir, f'{lyr.index}_upsample_reorder.txt'),
                   ra)
        _write_bin(os.path.join(rdir, f'{lyr.index}_upsample_q_bin'), ra)
        scale_f = os.path.join(outdir, 'a_scale_out', f'a_scale_{name}.txt')
        if os.path.isfile(scale_f):
            _write_txt(os.path.join(outdir, 'a_scale_out',
                                    f'{lyr.index}_upsample_scale.txt'),
                       np.loadtxt(scale_f))
        written.append(lyr.index)
    return written
