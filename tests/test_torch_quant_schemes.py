"""The port's quantization schemes (yolo_tpu_torch/compress/quant.py and
quant_legacy.py: TPSQ, cos-PTQ, DoReFa, binary, BWN, ternary, min/max PTQ)
and the int8 engine's ptq_cos and tpsq plans, against the JAX package, on
the CPU. JAX runs at 'highest' matmul precision.

Tolerances:

- the quantizers: values bit-equal (they sit on their grids), gradients
  within 1e-6 of their magnitude, with inputs placed exactly on TPSQ's
  ±p2 and on the clip edges (the port takes JAX's derivatives at kinks:
  0.5 at a clip's edge, 1 for |x| at 0);
- the scale searches (TPSQ's warmup search, cos-PTQ's votes): the same
  winners; each test asserts that its inputs' best two cosines are apart
  by more than f32 rounding (``MARGIN``), since the sums run in other
  orders;
- ``make_quant_apply`` of all six schemes in f32 on ``PLAIN_CFG`` (the toy
  with its mish conv made leaky, as tests/test_torch_qat.py explains, and
  its weighted shortcut plain): two train steps, the train heads
  (``HEAD_OFF``), qstate (scales exactly) and BN state within 1e-5 of
  their norms, the gradient of a linear loss on the heads within 1e-4 of
  the whole gradient's norm (each tensor within 1e-2 of its own,
  ``GRAD_TOL``); the eval heads on ``LEAKY_CFG`` on JAX's state within
  1e-5 of their norm. With mish (``TOY_CFG``) the google sim's eval heads stay
  within one quantum;
- the ptq_cos and TPSQ engines through K2's plain version against JAX's
  engine on its XLA backend: w8, the dequantized bias and every scale
  equal, the int8 heads bit-equal.
"""

import numpy as np
import pytest
import torch

from _torch_port import TOY_CFG, images, random_jax_weights
from test_torch_qat import LEAKY_CFG, _grads_close, _qstate_equal
from test_torch_train_step import _close_to_norm

SCHEMES = ['google', 'tpsq', 'ptq_cos', 'dorefa', 'wbin', 'ternary']
# the best two cosines of a scale search must be this far apart
MARGIN = 1e-5
# LEAKY_CFG with its weighted shortcut made plain: the frameworks' sigmoid
# of the fusion weights differ by ulps, and a float shortcut (TPSQ, the
# legacy schemes) carries them into the BN batch statistics of the next
# conv, which moves every folded weight
PLAIN_CFG = LEAKY_CFG.replace('weights_type=per_feature\n', '')
assert PLAIN_CFG != LEAKY_CFG
# the share of train-head values that may differ (by more than 1e-5 of the
# norm): DoReFa's weights are not powers of two, so its conv sums round in
# other orders, and an activation on a rounding boundary of its 255 levels
# moves by one (0.1% of the toy's second head measured)
HEAD_OFF = 5e-3


@pytest.fixture(scope='module', autouse=True)
def _setup():
    import jax
    old = (torch.get_num_threads(), jax.config.jax_default_matmul_precision)
    torch.set_num_threads(2)
    jax.config.update('jax_default_matmul_precision', 'highest')
    yield
    torch.set_num_threads(old[0])
    jax.config.update('jax_default_matmul_precision', old[1])


@pytest.fixture(scope='module')
def nets(tmp_path_factory):
    from yolo_tpu.ir import build_ir
    root = tmp_path_factory.mktemp('schemes')
    out = {}
    for name, text in (('leaky', LEAKY_CFG), ('toy', TOY_CFG),
                       ('plain', PLAIN_CFG)):
        p = root / f'{name}.cfg'
        p.write_text(text)
        out[name] = build_ir(str(p))
    return out


def _t(a, grad=False):
    t = torch.tensor(np.asarray(a, np.float32))
    return t.requires_grad_(True) if grad else t


def _vjp_jax(fn, x, ct):
    import jax
    import jax.numpy as jnp
    y, pull = jax.vjp(fn, jnp.asarray(x))
    return np.asarray(y), np.asarray(pull(jnp.asarray(ct))[0])


def _vjp_torch(fn, x, ct):
    xt = _t(x, grad=True)
    y = fn(xt)
    (y * _t(ct)).sum().backward()
    return y.detach().numpy(), xt.grad.numpy()


def _same(got, want, rtol=1e-6, what=''):
    """Values bit-equal, a gradient within rtol of its magnitude."""
    np.testing.assert_array_equal(got[0], want[0], err_msg=what)
    _close_to_norm(got[1], want[1], rtol, what)


# ------------------------------------------------------------------ TPSQ

def test_search_pow2_matches_jax():
    """Forward pow2_snap(clip(s, 2^-5, 2^13)) bit-equal; backward
    g * out / s (s == 0 read as 1, no gradient through the clip) within
    1e-6, on ties (1.5, 3.0 go to the lower power), exact powers, both
    clip edges, 0 and a negative value. (Above 2^12 XLA's CPU exp2 is off
    by an ulp, so the upper edge is left out.)"""
    import jax
    from yolo_tpu.compress import quant as JQ
    from yolo_tpu_torch.compress import quant as TQ
    s = np.array([0.01, 2.0 ** -5, 0.03, 1.0, 1.4, 1.5, 3.0, 5.9, 4096.0,
                  0.0, -1.0, 0.37], np.float32)
    want_y = np.asarray(jax.vmap(JQ.search_pow2)(s))
    want_g = np.asarray(jax.vmap(jax.grad(JQ.search_pow2))(s))
    st = _t(s, grad=True)
    y = TQ.search_pow2(st)
    y.sum().backward()
    np.testing.assert_array_equal(y.detach().numpy(), want_y)
    np.testing.assert_allclose(st.grad.numpy(), want_g, rtol=1e-6)
    np.testing.assert_array_equal(want_y[[1, 3, 4, 5, 6]],
                                  [2.0 ** -5, 1.0, 1.0, 1.0, 2.0])


@pytest.mark.parametrize('bits', [8, 4])
@pytest.mark.parametrize('scale', [1.4, 3.0, 0.3])
def test_tpsq_quantize_matches_jax(bits, scale):
    """tpsq_quantize's value and its gradients in x and in the scale, with
    x exactly on ±p2, at 0, on the rounding boundaries of the grid and far
    outside the clamp."""
    import jax
    import jax.numpy as jnp
    from yolo_tpu.compress import quant as JQ
    from yolo_tpu_torch.compress import quant as TQ
    p2 = float(JQ.search_pow2(jnp.float32(scale)))
    qr = (1 << (bits - 1)) - 1
    rng = np.random.default_rng(bits)
    x = np.concatenate([[p2, -p2, 0.0, 2 * p2, -3 * p2, 0.5 * p2 / qr,
                         -1.5 * p2 / qr], rng.normal(0, p2, 500)]
                       ).astype(np.float32)
    ct = rng.normal(size=x.shape).astype(np.float32)
    fn_j = lambda xx, ss: JQ.tpsq_quantize(xx, ss, bits)
    y_j, pull = jax.vjp(fn_j, jnp.asarray(x), jnp.float32(scale))
    gx_j, gs_j = (np.asarray(g) for g in pull(jnp.asarray(ct)))
    xt, stt = _t(x, grad=True), _t(scale, grad=True)
    y = TQ.tpsq_quantize(xt, stt, bits)
    (y * _t(ct)).sum().backward()
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(y_j))
    _close_to_norm(xt.grad.numpy(), gx_j, 1e-6, 'd/dx')
    np.testing.assert_allclose(float(stt.grad), float(gs_j), rtol=1e-6)
    # at ±p2 the soft clamp's |x ± p2| sits on its kink: JAX's slope 1
    assert gx_j[0] != 0 or gx_j[1] != 0


def _search_margin(x, bits):
    """The gap between the best cosine of the TPSQ search on ``x`` and the
    best of a candidate that snaps to another power of two (candidates of
    one power quantize alike and tie exactly; the first wins), in float64
    from the f32 candidates' values."""
    from yolo_tpu_torch.compress import quant as TQ
    flat = torch.tensor(np.asarray(x, np.float32)).reshape(-1)
    step = torch.max(flat) / 100.0
    xn = flat.double() / flat.double().norm()
    best = {}
    for i in range(1, 100):
        p2 = float(TQ.search_pow2(step * float(i)))
        dq = TQ.tpsq_quantize(flat, step * float(i), bits).double()
        best[p2] = max(best.get(p2, -2.0),
                       float(dq @ xn / max(float(dq.norm()), 1e-12)))
    cos = np.sort(np.asarray(list(best.values())))[::-1]
    return cos[0] - cos[1]


@pytest.mark.parametrize('case', ['normal', 'heavy', 'weights'])
def test_tpsq_search_scale_matches_jax(case):
    """The warmup's search of 99 candidates picks the same scale (the
    inputs' best two cosines are MARGIN apart)."""
    from yolo_tpu.compress import quant as JQ
    from yolo_tpu_torch.compress import quant as TQ
    rng = np.random.default_rng(7)
    x = {'normal': rng.normal(0, 1, 4096),
         'heavy': rng.standard_t(3, 4096) * 0.5,
         'weights': rng.normal(0, 0.05, (3, 3, 16, 8))}[case]
    x = np.asarray(x, np.float32)
    assert _search_margin(x, 8) > MARGIN
    want = float(JQ._tpsq_search_scale(x, 8))
    got = float(TQ._tpsq_search_scale(_t(x), 8))
    assert got == want


def test_tpsq_search_scale_nonpositive_step_as_jax():
    """A tensor with no positive value has a step of 0 or less; the search
    returns what JAX's does there (no 'fix')."""
    from yolo_tpu.compress import quant as JQ
    from yolo_tpu_torch.compress import quant as TQ
    for x in (-np.abs(np.random.default_rng(1).normal(size=64)),
              np.zeros(16)):
        x = x.astype(np.float32)
        want = float(JQ._tpsq_search_scale(x, 8))
        got = float(TQ._tpsq_search_scale(_t(x), 8))
        assert got == want or (np.isnan(got) and np.isnan(want))


# ------------------------------------------------------------- cos-PTQ

def _cospt_margin(x, bits):
    from yolo_tpu_torch.compress.quant import qrange, round_half_away
    qmin, qmax = qrange(bits)
    flat = torch.tensor(np.asarray(x, np.float32)).reshape(-1)
    xn = flat.double() / flat.double().norm()
    cos = []
    for i in range(bits + 7):
        sc = np.float32(2.0 ** (i - 5)) / np.float32(128)
        dq = (torch.clamp(round_half_away(flat / float(sc)), qmin, qmax)
              * float(sc)).double()
        cos.append(float(dq @ xn / max(float(dq.norm()), 1e-12)))
    cos = np.sort(np.asarray(cos))[::-1]
    return cos[0] - cos[1]


def test_cospt_quantize_matches_jax():
    """Four train-mode calls on tensors of different ranges (the votes
    split, then the most-voted scale wins), then an eval call: votes,
    scale, step and the fake-quantized values equal."""
    import jax.numpy as jnp
    from yolo_tpu.compress import quant as JQ
    from yolo_tpu_torch.compress import quant as TQ
    rng = np.random.default_rng(2)
    xs = [rng.normal(0, s, 2048).astype(np.float32)
          for s in (1.0, 0.2, 1.1, 3.0)]
    for x in xs:
        assert _cospt_margin(x, 8) > MARGIN
    qj, qt = JQ.cospt_init(8), TQ.cospt_init(8)
    for x in xs:
        yj, qj = JQ.cospt_quantize(jnp.asarray(x), qj, bits=8, train=True)
        yt, qt = TQ.cospt_quantize(_t(x), qt, bits=8, train=True)
        np.testing.assert_array_equal(yt.numpy(), np.asarray(yj))
        for f in ('votes', 'scale', 'step'):
            np.testing.assert_array_equal(qt[f].numpy(), np.asarray(qj[f]))
    assert float(qt['votes'].max()) == 2 and float(qt['step']) == 4
    yj, _ = JQ.cospt_quantize(jnp.asarray(xs[3]), qj, bits=8, train=False)
    yt, q2 = TQ.cospt_quantize(_t(xs[3]), qt, bits=8, train=False)
    np.testing.assert_array_equal(yt.numpy(), np.asarray(yj))
    assert q2 is qt


# ------------------------------------------------------- the legacy family

def _legacy_cases():
    from yolo_tpu.compress import quant_legacy as JL
    from yolo_tpu_torch.compress import quant_legacy as TL
    return {
        'quantize_k': (lambda L: lambda x: L.quantize_k(x, 4), 'unit'),
        'dorefa_weight': (lambda L: lambda x: L.dorefa_weight(x, 8),
                          'normal'),
        'dorefa_weight_4': (lambda L: lambda x: L.dorefa_weight(x, 4),
                            'normal'),
        'dorefa_activation': (lambda L: lambda x: L.dorefa_activation(x, 8),
                              'edges'),
        'binary_weight': (lambda L: L.binary_weight, 'normal'),
        'bwn_weight': (lambda L: L.bwn_weight, 'normal'),
        'ternary_weight': (lambda L: L.ternary_weight, 'normal'),
        'minmax_sym': (lambda L: lambda x: L.minmax_ptq(x, 8), 'normal'),
        'minmax_asym': (lambda L: lambda x: L.minmax_ptq(x, 8, sym=False),
                        'normal'),
        'minmax_pow2': (lambda L: lambda x: L.minmax_ptq(x, 8, pow2=True),
                        'normal'),
    }, JL, TL


@pytest.mark.parametrize('name', list(_legacy_cases()[0]))
def test_legacy_quantizers_match_jax(name):
    """Each transform's value bit-equal (BWN's and ternary's magnitude,
    a mean of |w|, within rtol 1e-6) and its straight-through gradient
    within 1e-6; dorefa_activation also on its clip edges (x * 0.1 == 0
    and == 1), where JAX's derivative is 0.5."""
    cases, JL, TL = _legacy_cases()
    make, kind = cases[name]
    rng = np.random.default_rng(list(cases).index(name))
    x = {'unit': rng.uniform(0, 1, 400),
         'normal': rng.normal(0, 0.3, (4, 3, 3, 5)),
         'edges': np.concatenate([[0.0, 10.0, -3.0, 12.0, 5.0],
                                  rng.normal(3, 5, 400)])}[kind]
    x = np.asarray(x, np.float32)
    ct = rng.normal(size=x.shape).astype(np.float32)
    want = _vjp_jax(make(JL), x, ct)
    got = _vjp_torch(make(TL), x, ct)
    if name in ('bwn_weight', 'ternary_weight'):
        # the magnitude a is a mean of |w|, summed in another order
        np.testing.assert_allclose(got[0], want[0], rtol=1e-6)
        np.testing.assert_array_equal(np.sign(got[0]), np.sign(want[0]))
        _close_to_norm(got[1], want[1], 1e-6, name)
    else:
        _same(got, want, what=name)
    if kind == 'edges':
        np.testing.assert_allclose(got[1][:2], 0.5 * ct[:2] * 0.1, rtol=1e-6)


def test_legacy_weight_grids():
    """wbin weights on {-1, +1}, ternary on {-a, 0, +a}, DoReFa on the
    255-level tanh grid in [-1, 1] (the JAX package's grid test)."""
    from yolo_tpu_torch.compress import quant_legacy as TL
    w = _t(np.random.default_rng(0).normal(0, 0.1, (8, 4, 3, 3)))
    assert set(np.unique(TL.binary_weight(w).numpy())) <= {-1.0, 1.0}
    # {-a, 0, +a} up to the ulp of the straight-through sum w + (t - w)
    t = np.unique(np.round(TL.ternary_weight(w).numpy(), 6))
    assert len(t) <= 3 and 0.0 in t
    d = TL.dorefa_weight(w, 8).numpy()
    assert d.min() >= -1 and d.max() <= 1
    lv = np.unique(np.round((d + 1) / 2 * 255, 4))
    np.testing.assert_allclose(lv, np.round(lv), atol=1e-3)
    with pytest.raises(ValueError, match='1-bit'):
        TL.dorefa_weight(w, 1)
    with pytest.raises(ValueError, match='1-bit'):
        TL.dorefa_activation(w, 1)


def test_quantize_input_16bit_matches_jax():
    from yolo_tpu.compress import quant as JQ
    from yolo_tpu_torch.compress import quant as TQ
    x = np.concatenate([[0.123456789, -0.5, 0.9999, 2.0 ** -15, 3 * 2.0 ** -15],
                        np.random.default_rng(3).uniform(-1, 1, 300)]
                       ).astype(np.float32)
    np.testing.assert_array_equal(TQ.quantize_input_16bit(_t(x)).numpy(),
                                  np.asarray(JQ.quantize_input_16bit(x)))


# ------------------------------------------------------- the quantized nets

@pytest.mark.parametrize('scheme', SCHEMES)
def test_init_quant_state_matches_jax(nets, scheme):
    """The qstate tree and the extra params (TPSQ's scales) of every scheme
    have the JAX package's keys, shapes and values."""
    from yolo_tpu.compress import quant as JQ
    from yolo_tpu_torch.compress import quant as TQ
    net = nets['leaky']
    qj, ej = JQ.init_quant_state(net, JQ.QuantConfig(scheme=scheme))
    qt, et = TQ.init_quant_state(net, TQ.QuantConfig(scheme=scheme))
    assert _qstate_equal(qt, qj) == sum(
        1 for _ in __import__('jax').tree_util.tree_leaves(qj))
    assert _qstate_equal(et, ej) == (3 * 11 if scheme == 'tpsq' else 0)


def _weights(net, scheme, seed=0):
    """JAX-layout numpy params with the scheme's extra params, BN state."""
    from yolo_tpu.compress import quant as JQ
    pj, sj = random_jax_weights(net, seed=seed, conv_scale=1.0)
    _, extra = JQ.init_quant_state(net, JQ.QuantConfig(scheme=scheme))
    for k, v in extra.items():
        pj[k] = {**pj[k], **{f: np.asarray(a) for f, a in v.items()}}
    return pj, sj


def _heads_close(got, want, what):
    """At most HEAD_OFF of the values off by more than 1e-5 of the norm,
    none by more than 1e-2 of it."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    d = np.abs(got - want) / max(np.abs(want).max(), 1e-12)
    assert (d > 1e-5).mean() <= HEAD_OFF and d.max() <= 1e-2, (
        what, (d > 1e-5).mean(), d.max())


def _jnp_tree(tree):
    import jax
    import jax.numpy as jnp
    return jax.tree.map(jnp.asarray, tree)


@pytest.mark.parametrize('scheme', SCHEMES)
def test_quant_apply_matches_jax(nets, scheme):
    """Two f32 train steps of both applies from the same weights (TPSQ
    from JAX's warmup scales) on PLAIN_CFG: the heads (``_heads_close``),
    qstate (scales exactly) and BN state (1e-5 of the norm); the gradient
    of a linear loss on the heads from JAX's state (``GRAD_TOL``); then the
    eval heads on LEAKY_CFG, weighted shortcut included, on JAX's
    calibrated state within 1e-5 of their norm. JAX runs jitted, but
    eagerly for DoReFa: jitted, XLA fuses its tanh into other code and
    moves its values by up to 1e-2 (so DoReFa's network gradient, which
    would need JAX's backward run eagerly, is left to its quantizers'
    tests)."""
    import jax
    import jax.numpy as jnp
    from yolo_tpu.compress import quant as JQ
    from yolo_tpu_torch.compress import quant as TQ
    from yolo_tpu_torch.convert import from_jax, qstate_from_jax
    jcfg = JQ.QuantConfig(scheme=scheme, steps=100)
    tcfg = TQ.QuantConfig(scheme=scheme, steps=100)
    x = images(5, 2, 64).astype(np.float32) / 256.0
    for name in ('plain', 'leaky'):
        net = nets[name]
        pj, sj = _weights(net, scheme)
        qj = JQ.init_quant_state(net, jcfg)[0]
        if scheme == 'tpsq':
            pj = jax.tree.map(np.asarray, JQ.tpsq_warmup(
                net, jcfg, pj, sj, qj, jnp.asarray(x)))
        japply = JQ.make_quant_apply(net, jcfg, compute_dtype=None)
        if scheme != 'dorefa':
            japply = jax.jit(japply, static_argnums=4)
        tapply = TQ.make_quant_apply(net, tcfg)
        pt, st = from_jax(net, pj, sj)
        qt = qstate_from_jax(jax.tree.map(np.asarray, qj))
        js, jq = _jnp_tree(sj), qj
        for step in range(2):
            xs = x[::-1].copy() if step else x
            (yj, _), js, jq = japply(pj, js, jq, jnp.asarray(xs), True)
            with torch.no_grad():
                (yt, _), st, qt = tapply(pt, st, qt, torch.from_numpy(xs),
                                         True)
            if name == 'leaky':
                continue
            for a, b in zip(yj, yt):
                _heads_close(b.numpy(), np.asarray(a), f'heads {step}')
            _qstate_equal(qt, jax.device_get(jq))
            bn = from_jax(net, {}, jax.device_get(js))[1]
            for k, d in bn.items():
                for f, w in d.items():
                    _close_to_norm(st[k][f].numpy(), w.numpy(), 1e-5,
                                   f'{k}/{f}')
        st_j, q_j = from_jax(net, {}, jax.device_get(js))[1], \
            qstate_from_jax(jax.device_get(jq))
        if name == 'plain' and scheme == 'dorefa':
            # its quantizers' gradients are held above, one by one; the
            # network's gradient would need JAX's backward run eagerly
            continue
        if name == 'leaky':
            y_j = japply(pj, js, jq, jnp.asarray(x), False)[1]
            with torch.no_grad():
                y_t = tapply(pt, st_j, q_j, torch.from_numpy(x), False)[1]
            for a, b in zip(y_j, y_t):
                _close_to_norm(b.numpy(), np.asarray(a), 1e-5, 'eval heads')
            continue
        # the gradient of a linear loss on the train heads, from JAX's state
        (y0, _), _, _ = japply(pj, js, jq, jnp.asarray(x), True)
        rng = np.random.default_rng(0)
        cts = [rng.normal(size=np.shape(o)).astype(np.float32)
               / float(np.abs(np.asarray(o)).max()) for o in y0]

        def jloss(p):
            (yp, _), _, _ = japply(p, js, jq, jnp.asarray(x), True)
            return sum(jnp.sum(o * c) for o, c in zip(yp, cts))

        jg = jax.device_get(jax.jit(jax.grad(jloss))(_jnp_tree(pj)))
        pg = {k: {f: v.clone().requires_grad_(True) for f, v in d.items()}
              for k, d in pt.items()}
        (yp, _), _, _ = tapply(pg, st_j, q_j, torch.from_numpy(x), True)
        sum(torch.sum(o * torch.from_numpy(c))
            for o, c in zip(yp, cts)).backward()
        _grads_close(pg, from_jax(net, jg, {})[0])


def test_google_sim_with_mish_within_a_quantum(nets):
    """TOY_CFG (mish at layer 3), google, 2 calibration steps of both: the
    scales equal, and the eval heads on JAX's state within one quantum of
    the head's grid on at most 1% of their values (a mish output an ulp
    apart can round to the next step)."""
    import jax
    import jax.numpy as jnp
    from yolo_tpu.compress import quant as JQ
    from yolo_tpu_torch.compress import quant as TQ
    from yolo_tpu_torch.convert import from_jax, qstate_from_jax
    net = nets['toy']
    pj, sj = _weights(net, 'google')
    jcfg = JQ.QuantConfig(steps=100)
    japply = jax.jit(JQ.make_quant_apply(net, jcfg, compute_dtype=None),
                     static_argnums=4)
    x = jnp.asarray(images(5, 2, 64).astype(np.float32) / 256.0)
    js, jq = sj, JQ.init_quant_state(net, jcfg)[0]
    for _ in range(2):
        _, js, jq = japply(pj, js, jq, x, True)
    js, jq = jax.device_get(js), jax.device_get(jq)
    hj = jax.jit(JQ.make_quant_apply(net, jcfg, compute_dtype=None,
                                     heads_only=True), static_argnums=4)(
        pj, js, jq, x, False)[0]
    pt, st = from_jax(net, pj, js)
    ht = TQ.make_quant_apply(net, TQ.QuantConfig(steps=100),
                             heads_only=True)(pt, st, qstate_from_jax(jq),
                                              torch.from_numpy(np.asarray(x)),
                                              False)[0]
    heads_conv = [l.index - 1 for l in net.layers if l.kind == 'yolo']
    for a, b, k in zip(hj, ht, heads_conv):
        q = float(jq[str(k)]['aq']['scale'])
        d = np.abs(b.numpy() - np.asarray(a)) / q
        assert d.max() <= 1 + 1e-6 and (d > 0.5).mean() <= 0.01, (
            d.max(), (d > 0.5).mean())


def test_tpsq_warmup_matches_jax(nets):
    """The warmup's scales: search_pow2 of each equal to JAX's, the raw
    values within rtol 1e-5 (each is a candidate index times max / 100,
    and the max of a BN-folded weight sums in another order)."""
    import jax
    import jax.numpy as jnp
    from yolo_tpu.compress import quant as JQ
    from yolo_tpu_torch.compress import quant as TQ
    from yolo_tpu_torch.convert import from_jax, qstate_from_jax
    net = nets['leaky']
    pj, sj = _weights(net, 'tpsq')
    cfg = JQ.QuantConfig(scheme='tpsq', steps=100)
    qj = JQ.init_quant_state(net, cfg)[0]
    x = images(6, 2, 64).astype(np.float32) / 256.0
    want = jax.device_get(JQ.tpsq_warmup(net, cfg, pj, sj, qj, jnp.asarray(x)))
    pt, st = from_jax(net, pj, sj)
    got = TQ.tpsq_warmup(net, TQ.QuantConfig(scheme='tpsq', steps=100), pt,
                         st, qstate_from_jax(jax.tree.map(np.asarray, qj)),
                         torch.from_numpy(x))
    n = 0
    for k, d in want.items():
        for f in ('w_scale', 'b_scale', 'a_scale'):
            if f in d:
                w, g = float(d[f]), float(got[k][f])
                assert w != 1.0
                np.testing.assert_allclose(g, w, rtol=1e-5, err_msg=(k, f))
                assert (float(TQ.search_pow2(torch.tensor(g)))
                        == float(JQ.search_pow2(jnp.float32(w)))), (k, f)
                n += 1
    assert n == 33


def test_qat_bf16_matches_f32_calibration(nets):
    """bf16 MACs with f32 quantizer math (the QAT default): 4 calibration
    steps land on the f32 path's pow-2 scales and on JAX's bf16 scales,
    and the eval io stays as close to the f32 path's as JAX's bf16 io
    stays to its own (the mean probability difference at most 1.5 times
    JAX's, which is 7.8e-3 on these inputs: both round each conv's output
    to bf16)."""
    import jax
    import jax.numpy as jnp
    from yolo_tpu.compress import quant as JQ
    from yolo_tpu_torch.compress import quant as TQ
    from yolo_tpu_torch.convert import from_jax
    net = nets['toy']
    pj, sj = random_jax_weights(net, seed=0)
    pt, st0 = from_jax(net, pj, sj)
    x = images(2, 2, 64).astype(np.float32) / 256.0
    outs = {}
    for which, dt in (('t32', None), ('tbf', torch.bfloat16), ('j32', None),
                      ('jbf', jnp.bfloat16)):
        if which[0] == 't':
            cfg = TQ.QuantConfig(steps=100)
            apply = TQ.make_quant_apply(net, cfg, compute_dtype=dt)
            st, qs = st0, TQ.init_quant_state(net, cfg)[0]
            with torch.no_grad():
                for _ in range(4):
                    _, st, qs = apply(pt, st, qs, torch.from_numpy(x), True)
                io = apply(pt, st, qs, torch.from_numpy(x), False)[0]
            qs = {k: {q: float(d[q]['scale']) for q in ('aq', 'wq', 'bq')}
                  for k, d in qs.items() if 'aq' in d}
            outs[which] = qs, io.float().numpy()
        else:
            cfg = JQ.QuantConfig(steps=100)
            apply = jax.jit(JQ.make_quant_apply(net, cfg, compute_dtype=dt
                                                or jnp.float32),
                            static_argnums=4)
            st, qs = sj, JQ.init_quant_state(net, cfg)[0]
            for _ in range(4):
                _, st, qs = apply(pj, st, qs, jnp.asarray(x), True)
            io = apply(pj, st, qs, jnp.asarray(x), False)[0]
            qs = {k: {q: float(d[q]['scale']) for q in ('aq', 'wq', 'bq')}
                  for k, d in qs.items() if 'aq' in d}
            outs[which] = qs, np.asarray(io, np.float32)
    assert outs['tbf'][0] == outs['t32'][0] == outs['jbf'][0]
    drift = lambda a, b: np.abs(outs[a][1][..., 4:] - outs[b][1][..., 4:]).mean()
    assert drift('tbf', 't32') <= 1.5 * drift('jbf', 'j32') + 1e-4, (
        drift('tbf', 't32'), drift('jbf', 'j32'))


# ---------------------------------------------------------- the int8 engine

def test_k2_plain_takes_the_callers_multiplier():
    """fused_conv_int8 (its plain version here) with ``out_mult``: the
    requant multiplies by that value rounded once to f32 and clips to
    [qmin, qmax], TPSQ's grid [-127, 127]; without it 1 / out_scale."""
    from yolo_tpu_torch.ops.conv_int8 import fused_conv_int8
    rng = np.random.default_rng(0)
    x8 = torch.from_numpy(rng.integers(-128, 128, (1, 9, 9, 16), np.int8))
    w8 = torch.from_numpy(rng.integers(-128, 128, (24, 3, 3, 16), np.int8))
    b = torch.from_numpy(rng.normal(0, 50, 24).astype(np.float32))
    sa = 2.0 ** -3 / 128
    mult = (127 / 128.0) / sa
    y = fused_conv_int8(x8, w8, b, 2.0 ** -14, sa, stride=1, act='linear',
                        out_q=False)
    q = fused_conv_int8(x8, w8, b, 2.0 ** -14, sa, stride=1, act='linear',
                        qmin=-127, qmax=127, out_mult=mult)
    v = y.numpy() * np.float32(mult)
    want = np.clip(np.sign(v) * np.floor(np.abs(v) + 0.5), -127, 127)
    np.testing.assert_array_equal(q.numpy(), want.astype(np.int8))
    assert int(q.min()) == -127 and int(q.max()) == 127
    plain = fused_conv_int8(x8, w8, b, 2.0 ** -14, sa, stride=1, act='linear')
    v = y.numpy() * np.float32(1.0 / sa)
    np.testing.assert_array_equal(
        plain.numpy(), np.clip(np.sign(v) * np.floor(np.abs(v) + 0.5), -128,
                               127).astype(np.int8))


def _calibrated(net, scheme):
    """JAX params/state/qstate of ``scheme``: ptq_cos from 3 calibration
    steps, TPSQ from its warmup (as tests/test_int8_engine.py makes
    them)."""
    import jax
    import jax.numpy as jnp
    from yolo_tpu.compress import quant as JQ
    pj, sj = _weights(net, scheme)
    cfg = JQ.QuantConfig(scheme=scheme, steps=100)
    qj = JQ.init_quant_state(net, cfg)[0]
    x = images(2, 2, 64).astype(np.float32) / 256.0
    if scheme == 'tpsq':
        pj = JQ.tpsq_warmup(net, cfg, pj, sj, qj, jnp.asarray(x))
    else:
        apply = jax.jit(JQ.make_quant_apply(net, cfg, compute_dtype=None),
                        static_argnums=4)
        for _ in range(3):
            _, sj, qj = apply(pj, sj, qj, jnp.asarray(x), True)
    return (cfg, jax.tree.map(np.asarray, jax.device_get(pj)),
            jax.tree.map(np.asarray, jax.device_get(sj)),
            jax.tree.map(np.asarray, jax.device_get(qj)), x)


@pytest.mark.parametrize('scheme', ['ptq_cos', 'tpsq'])
def test_engine_scheme_matches_jax(nets, scheme):
    """prepare_int8 of both packages on the same JAX-calibrated weights:
    w8 element for element, the dequantized bias exact, every meta scale
    equal (TPSQ's from its params); the heads of the port's engine through
    K2's plain version bit-equal to JAX's XLA engine, the dense io within
    1e-4. TPSQ runs K2's plain version on its [-127, 127] grid with the
    127/128 multiplier, and its float shortcuts and concat put the convs
    after them on float edges."""
    import jax
    import jax.numpy as jnp
    from yolo_tpu.models import int8_engine as JE
    from yolo_tpu_torch.compress.quant import QuantConfig
    from yolo_tpu_torch.convert import from_jax, qstate_from_jax
    from yolo_tpu_torch.models import int8_engine as TE
    from yolo_tpu_torch.ops.conv_int8 import float_edge_conv
    net = nets['leaky']
    cfg, pj, sj, qj, x = _calibrated(net, scheme)
    jplan = JE.prepare_int8(net, pj, sj, qj, cfg)
    pt, st = from_jax(net, pj, sj)
    plan = TE.prepare_int8(net, pt, st, qstate_from_jax(qj),
                           QuantConfig(scheme=scheme, steps=100),
                           device='cpu')
    assert plan.meta == jplan.meta and plan.scheme == scheme
    n = 0
    for k, v in jplan.arrays.items():
        if 'w8' in v:
            np.testing.assert_array_equal(
                plan.arrays[k]['w8'].numpy(),
                np.asarray(v['w8']).transpose(3, 0, 1, 2))
            np.testing.assert_array_equal(plan.arrays[k]['bias'].numpy(),
                                          np.asarray(v['bias']))
            n += 1
    assert n == 11
    if scheme == 'tpsq':
        assert max(int(np.abs(np.asarray(v['w8'])).max())
                   for v in jplan.arrays.values() if 'w8' in v) <= 127
    hj, oj = jax.jit(JE.make_int8_apply(net, jplan, backend='xla',
                                        heads_only=True))(jplan.arrays,
                                                          jnp.asarray(x))
    eng = TE.make_int8_apply(net, plan, heads_only=True)
    assert eng.head_scales == tuple(
        JE.make_int8_apply(net, jplan, backend='xla',
                           heads_only=True).head_scales)
    f0 = float_edge_conv.calls
    ht, ot = eng(plan.arrays, torch.from_numpy(x))
    # the stem, and for TPSQ the convs after the 3 shortcuts and the concat
    assert float_edge_conv.calls - f0 == (5 if scheme == 'tpsq' else 1)
    for a, b, oa, ob in zip(hj, ht, oj, ot):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
        np.testing.assert_array_equal(ob.numpy(), np.asarray(oa))
    io_j = np.asarray(jax.jit(JE.make_int8_apply(net, jplan, backend='xla'))(
        jplan.arrays, jnp.asarray(x))[0])
    io_t = TE.make_int8_apply(net, plan)(plan.arrays, torch.from_numpy(x))[0]
    np.testing.assert_allclose(io_t.numpy(), io_j, rtol=1e-4, atol=1e-4)


def test_engine_refuses_stateless_schemes(nets):
    from yolo_tpu_torch.compress.quant import QuantConfig, init_quant_state
    from yolo_tpu_torch.convert import from_jax
    from yolo_tpu_torch.models.int8_engine import prepare_int8
    net = nets['leaky']
    pt, st = from_jax(net, *random_jax_weights(net))
    cfg = QuantConfig(scheme='dorefa')
    with pytest.raises(ValueError, match='engine'):
        prepare_int8(net, pt, st, init_quant_state(net, cfg)[0], cfg)
