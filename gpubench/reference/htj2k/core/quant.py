"""Quantization parameter derivation for encoding.

Builds QCD/QCC marker contents: reversible exponents from BIBO gains of
the lifting analysis cascade, and irreversible step sizes from energy
gains.  The gain tables are the standard 5/3 and 9/7 filter-cascade
constants used across JPEG 2000 implementations (see Taubman &
Marcellin, "JPEG2000", ch. 10); parity checked against
OpenJPH src/core/codestream/ojph_params.cpp:497-595,1495-1612.
"""
import math
from typing import List

from .markers import Qcd, DWT_REV53
from .message import error as _err

# sqrt of energy gain of the synthesis cascade, per decomposition count.
# index = number of decompositions (0..33)
SQRT_ENERGY_GAIN_97_L = [
    1.0000e+00, 1.4021e+00, 2.0304e+00, 2.9012e+00, 4.1153e+00, 5.8245e+00,
    8.2388e+00, 1.1652e+01, 1.6479e+01, 2.3304e+01, 3.2957e+01, 4.6609e+01,
    6.5915e+01, 9.3217e+01, 1.3183e+02, 1.8643e+02, 2.6366e+02, 3.7287e+02,
    5.2732e+02, 7.4574e+02, 1.0546e+03, 1.4915e+03, 2.1093e+03, 2.9830e+03,
    4.2185e+03, 5.9659e+03, 8.4371e+03, 1.1932e+04, 1.6874e+04, 2.3864e+04,
    3.3748e+04, 4.7727e+04, 6.7496e+04, 9.5454e+04]
SQRT_ENERGY_GAIN_97_H = [
    1.4425e+00, 1.9669e+00, 2.8839e+00, 4.1475e+00, 5.8946e+00, 8.3472e+00,
    1.1809e+01, 1.6701e+01, 2.3620e+01, 3.3403e+01, 4.7240e+01, 6.6807e+01,
    9.4479e+01, 1.3361e+02, 1.8896e+02, 2.6723e+02, 3.7792e+02, 5.3446e+02,
    7.5583e+02, 1.0689e+03, 1.5117e+03, 2.1378e+03, 3.0233e+03, 4.2756e+03,
    6.0467e+03, 8.5513e+03, 1.2093e+04, 1.7103e+04, 2.4187e+04, 3.4205e+04,
    4.8373e+04, 6.8410e+04, 9.6747e+04, 1.3682e+05]
SQRT_ENERGY_GAIN_53_L = [
    1.0000e+00, 1.2247e+00, 1.3229e+00, 1.5411e+00, 1.7139e+00, 1.9605e+00,
    2.2044e+00, 2.5047e+00, 2.8277e+00, 3.2049e+00, 3.6238e+00, 4.1033e+00,
    4.6423e+00, 5.2548e+00, 5.9462e+00, 6.7299e+00, 7.6159e+00, 8.6193e+00,
    9.7544e+00, 1.1039e+01, 1.2493e+01, 1.4139e+01, 1.6001e+01, 1.8108e+01,
    2.0493e+01, 2.3192e+01, 2.6246e+01, 2.9702e+01, 3.3614e+01, 3.8041e+01,
    4.3051e+01, 4.8721e+01, 5.5138e+01, 6.2399e+01]
SQRT_ENERGY_GAIN_53_H = [
    1.0458e+00, 1.3975e+00, 1.4389e+00, 1.7287e+00, 1.8880e+00, 2.1841e+00,
    2.4392e+00, 2.7830e+00, 3.1341e+00, 3.5576e+00, 4.0188e+00, 4.5532e+00,
    5.1494e+00, 5.8301e+00, 6.5963e+00, 7.4663e+00, 8.4489e+00, 9.5623e+00,
    1.0821e+01, 1.2247e+01, 1.3860e+01, 1.5685e+01, 1.7751e+01, 2.0089e+01,
    2.2735e+01, 2.5729e+01, 2.9117e+01, 3.2952e+01, 3.7292e+01, 4.2203e+01,
    4.7761e+01, 5.4051e+01, 6.1170e+01, 6.9226e+01]

# BIBO (bounded-input bounded-output) gains of the analysis cascade
BIBO_GAIN_97_L = [
    1.0000e+00, 1.3803e+00, 1.3328e+00, 1.3067e+00, 1.3028e+00] + \
    [1.3001e+00, 1.2993e+00, 1.2992e+00] + [1.2992e+00] * 26
BIBO_GAIN_97_H = [
    1.2976e+00, 1.3126e+00, 1.2757e+00, 1.2352e+00, 1.2312e+00] + \
    [1.2285e+00, 1.2280e+00, 1.2278e+00] + [1.2278e+00] * 26
BIBO_GAIN_53_L = [
    1.0000e+00, 1.5000e+00, 1.6250e+00, 1.6875e+00, 1.6963e+00, 1.7067e+00,
    1.7116e+00, 1.7129e+00, 1.7141e+00, 1.7145e+00, 1.7151e+00, 1.7152e+00,
    1.7155e+00, 1.7155e+00, 1.7156e+00] + [1.7156e+00] * 19
BIBO_GAIN_53_H = [
    2.0000e+00, 2.5000e+00, 2.7500e+00, 2.8047e+00, 2.8198e+00, 2.8410e+00,
    2.8558e+00, 2.8601e+00, 2.8628e+00, 2.8656e+00, 2.8662e+00, 2.8667e+00,
    2.8669e+00, 2.8670e+00, 2.8671e+00] + [2.8671e+00] * 19


def _f32(x: float) -> float:
    """Round to float32 like the reference's float tables."""
    import struct as _s
    return _s.unpack('f', _s.pack('f', x))[0]


def _atk_bibo_gains(kernel, levels: int):
    """Linearized per-level BIBO gains (max absolute row sums) of the
    analysis cascade of an arbitrary lifting kernel.

    The reference ships precomputed tables for the two Part-1 kernels
    (ojph_params.cpp:497-595) and has no ATK write path; for our write
    path with custom kernels the exponents must bound the actual
    cascade gain, so we measure it: apply the linearized analysis
    (reversible step (a, b, e) ~ a/2^e, rounding absorbed by the guard
    bits) to an identity matrix and take row-wise L1 norms.  Returns
    (gl, gh) with gl[d] the low-chain gain after d levels and gh[d-1]
    the high band gain at depth d, matching the reference's table
    indexing."""
    import numpy as _np
    from .atk import AtkKernel
    from ..ops.dwt import fwd_atk_1d
    if kernel.reversible:
        steps = tuple(a / float(1 << e) for (a, b, e) in kernel.steps)
    else:
        steps = tuple(float(a) for a in kernel.steps)
    lin = AtkKernel(index=max(2, kernel.index), reversible=False,
                    steps=steps, K=float(kernel.K), coeff_type=2)
    n = max(64, 1 << (levels + 4))
    T = _np.eye(n, dtype=_np.float64)
    gl: List[float] = [1.0]
    gh: List[float] = []
    for _ in range(levels):
        L, H = fwd_atk_1d(T, True, 0, lin)
        gl.append(float(_np.abs(L).sum(axis=1).max()))
        gh.append(float(_np.abs(H).sum(axis=1).max()))
        T = L
    return gl, gh


def _atk_energy_gains(kernel, levels: int):
    """Per-level sqrt energy gains of the synthesis basis functions of
    an arbitrary irreversible kernel (the reference's
    sqrt_energy_gains tables, ojph_params.cpp:400-460, measured
    instead of tabulated): the maximum L2 norm over synthesis impulse
    responses, used to scale the per-band quantization delta."""
    import numpy as _np
    from ..ops.dwt import inv_atk_1d
    n = max(64, 1 << (levels + 4))
    cur = _np.eye(n, dtype=_np.float64)  # maps level-d L coeffs -> signal
    gl: List[float] = [1.0]
    gh: List[float] = []
    for _ in range(levels):
        m = cur.shape[1]
        ml, mh = (m + 1) >> 1, m >> 1
        syn_l = inv_atk_1d(_np.eye(ml), _np.zeros((mh, ml)), True, 0,
                           kernel)
        syn_h = inv_atk_1d(_np.zeros((ml, mh)), _np.eye(mh), True, 0,
                           kernel)
        full_l = cur @ syn_l
        full_h = cur @ syn_h
        gl.append(float(_np.sqrt((full_l ** 2).sum(axis=0)).max()))
        gh.append(float(_np.sqrt((full_h ** 2).sum(axis=0)).max()))
        cur = full_l
    return gl, gh


def _level_types(num_decomps: int, dfs) -> List[int]:
    """Per-resolution (coarsest-above-LL first) decomposition types, as
    param_dfs::get_subband_idx orders SPqcd entries; all-BIDIR without a
    DFS marker."""
    from .markers import Dfs
    if dfs is None:
        return [Dfs.BIDIR_DWT] * num_decomps
    # resolution r uses decomposition level num_decomps - r + 1 = d,
    # and the d-index doubles as the gain-table depth below
    return [dfs.get_dwt_type(d) for d in range(num_decomps, 0, -1)]


def make_rev_qcd(num_decomps: int, bit_depth: int, employs_rct: bool,
                 comp_idx=None, dfs=None, kernel=None) -> Qcd:
    """Reversible quantization exponents (ojph_params.cpp:1495-1539).

    With a Part-2 ``dfs``, each level contributes the band entries its
    decomposition type produces (3 for BIDIR, 1 for HORZ/VERT, 0 for
    NO_DWT); the bidirectional BIBO gain at the same depth is a safe
    upper bound for the partial cascades (the reference has no DFS
    write path — this layout matches its param_dfs::get_subband_idx
    read order).  With a custom reversible ``kernel`` (Part-2 ATK) the
    gains are measured from the actual cascade instead of the 5/3
    tables."""
    from .markers import Dfs
    B = bit_depth + (1 if employs_rct else 0)
    if kernel is not None and kernel.index >= 2:
        gl, gh = _atk_bibo_gains(kernel, num_decomps)
    else:
        gl = [_f32(v) for v in BIBO_GAIN_53_L[:num_decomps + 1]]
        gh = [_f32(v) for v in BIBO_GAIN_53_H[:num_decomps]]
    exps: List[int] = []
    X = math.ceil(math.log2(gl[num_decomps] * gl[num_decomps]))
    # Clamp the LL gain exponent to >=1: at num_decomps=0 the
    # reference writes B+0 (set_rev_quant, ojph_params.cpp:1495),
    # which makes Kmax = B-1 — one bitplane short of the DC-shifted
    # minimum -2^(B-1), so a 0 sample round-trips to +2^(B-1) (the
    # reference's own compress|expand pair reproduces this).  One
    # extra bitplane restores exact lossless behavior; with any
    # decomposition the 5/3 BIBO gain already gives X>=1, so only
    # the 0-decomposition stream differs from the reference's.
    exps.append(B + max(1, X))
    types = _level_types(num_decomps, dfs)
    for i, d in enumerate(range(num_decomps, 0, -1)):
        t = types[i]
        if t == Dfs.NO_DWT:
            continue
        bl = gl[d]
        bh = gh[d - 1]
        X = math.ceil(math.log2(bh * bl))
        if t == Dfs.BIDIR_DWT:
            exps.append(B + X)
            exps.append(B + X)
            X = math.ceil(math.log2(bh * bh))
            exps.append(B + X)
        else:  # HORZ/VERT: one mixed low/high band
            exps.append(B + X)
    max_bx = max(exps)
    if max_bx > 38:
        _err(0x00050151, 'the specified combination of bit_depth, colour '
             'transform, and type of wavelet transform requires more than '
             f'38 bits; it requires {max_bx} bits')
    guard_bits = max(1, max_bx - 31)
    sqcd = guard_bits << 5
    spqcd = [((e - guard_bits) & 0xFF) << 3 for e in exps]
    return Qcd(sqcd, spqcd, comp_idx)


def _encode_spqcd(delta: float) -> int:
    """Float delta -> (exp<<11 | mantissa) (ojph_params.cpp:1602-1612)."""
    exp = 0
    while delta < 1.0:
        exp += 1
        delta *= 2.0
    mantissa = int(round(delta * (1 << 11))) - (1 << 11)
    mantissa = mantissa if mantissa < (1 << 11) else 0x7FF
    return (exp << 11) | mantissa


def make_irrev_qcd(num_decomps: int, base_delta: float,
                   comp_idx=None, dfs=None, kernel=None) -> Qcd:
    """Irreversible (9/7) quantization steps (ojph_params.cpp:1542-1599).

    Visual weighting (Qfactor) is not applied here; see make_qfactor_qcd.
    With a Part-2 ``dfs``, entries follow the DFS band layout (see
    make_rev_qcd).  With a custom irreversible ``kernel`` (Part-2 ATK)
    the deltas are scaled by the measured synthesis energy gains, and
    the guard bits bound the measured analysis BIBO gain so no
    coefficient overflows the Kmax range (samples are normalized to
    [-0.5, 0.5); the representable magnitude is ~2^(guard-1))."""
    from .markers import Dfs
    custom = kernel is not None and kernel.index >= 2
    guard_bits = 1
    if custom:
        el, eh = _atk_energy_gains(kernel, num_decomps)
        bl, bh = _atk_bibo_gains(kernel, num_decomps)
        max_g = max([bl[num_decomps] ** 2]
                    + [bh[d - 1] * bl[d] for d in range(1, num_decomps + 1)]
                    + [bh[d - 1] ** 2 for d in range(1, num_decomps + 1)])
        guard_bits = min(7, max(1, math.ceil(math.log2(max_g))))
    else:
        el = [_f32(v) for v in SQRT_ENERGY_GAIN_97_L[:num_decomps + 1]]
        eh = [_f32(v) for v in SQRT_ENERGY_GAIN_97_H[:num_decomps]]
    sqcd = (guard_bits << 5) | 0x2
    sp: List[int] = []
    gl = el[num_decomps]
    sp.append(_encode_spqcd(base_delta / (gl * gl)))
    types = _level_types(num_decomps, dfs)
    for i, d in enumerate(range(num_decomps, 0, -1)):
        t = types[i]
        if t == Dfs.NO_DWT:
            continue
        gl = el[d]
        gh = eh[d - 1]
        if t == Dfs.BIDIR_DWT:
            sp.append(_encode_spqcd(base_delta / (gh * gl)))
            sp.append(_encode_spqcd(base_delta / (gl * gh)))
            sp.append(_encode_spqcd(base_delta / (gh * gh)))
        else:
            sp.append(_encode_spqcd(base_delta / (gh * gl)))
    return Qcd(sqcd, sp, comp_idx)


def default_irrev_delta(bit_depth: int) -> float:
    """Default qstep when unspecified (ojph_params.cpp:1456-1459)."""
    return 1.0 / (1 << min(16, bit_depth))


# ---------------------------------------------------------------------------
# Qfactor visual weighting (ojph_params.cpp:599-800)
# ---------------------------------------------------------------------------

COMP_Y, COMP_CB, COMP_CR = 0, 1, 2

_VW = {
    # (ctype, format): 19 weights — 3 per level (HH, LH, HL) for levels
    # 1..6 then LL (visual_weights tables, ojph_params.cpp:738-794)
    (COMP_CB, '420'): [0.2724, 0.5128, 0.5128, 0.6692, 0.9382, 0.9382,
                       1.0888, 1.3046, 1.3046, 1.4156, 1.5594, 1.5594,
                       2.0, 2.0, 2.0, 2.0, 2.0, 2.0, 2.0],
    (COMP_CR, '420'): [0.5196, 0.8260, 0.8260, 1.0080, 1.2928, 1.2928,
                       1.4440, 1.6508, 1.6508, 1.7538, 1.8848, 1.8848,
                       2.0, 2.0, 2.0, 2.0, 2.0, 2.0, 2.0],
    (COMP_CB, '422'): [0.1220, 0.1220, 0.3626, 0.3626, 0.3626, 0.6634,
                       0.6634, 0.6634, 0.9225, 0.9225, 0.9225, 1.1027,
                       1.1027, 1.1027, 1.4142, 1.4142, 1.4142, 1.4142,
                       1.4142],
    (COMP_CR, '422'): [0.2595, 0.2595, 0.5841, 0.5841, 0.5841, 0.9141,
                       0.9141, 0.9141, 1.1673, 1.1673, 1.1673, 1.3328,
                       1.3328, 1.3328, 1.4142, 1.4142, 1.4142, 1.4142,
                       1.4142],
    (COMP_CB, '444'): [0.0263, 0.0863, 0.0863, 0.1362, 0.2564, 0.2564,
                       0.3346, 0.4691, 0.4691, 0.5444, 0.6523, 0.6523,
                       0.7078, 0.7797, 0.7797, 1.0, 1.0, 1.0, 1.0],
    (COMP_CR, '444'): [0.0773, 0.1835, 0.1835, 0.2598, 0.4130, 0.4130,
                       0.5040, 0.6464, 0.6464, 0.7220, 0.8254, 0.8254,
                       0.8769, 0.9424, 0.9424, 1.0, 1.0, 1.0, 1.0],
}
_VW_Y = [0.0901, 0.2758, 0.2758, 0.7018, 0.8378, 0.8378,
         1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0,
         1.0]
_VW_GAIN = {COMP_Y: 1.0, COMP_CB: 1.8051 / 1.7321,
            COMP_CR: 1.5734 / 1.7321}


def _vw_weight(weights, level: int, subband_idx: int) -> float:
    """visual_weights::get_weight (ojph_params.cpp:660-673)."""
    if subband_idx == 0:
        return weights[18]
    level = min(level, 6)
    return weights[(level - 1) * 3 + (3 - subband_idx)]


def _qfactor_delta_ref(qfactor: int, bit_depth: int):
    """visual_weights::get_delta_ref (ojph_params.cpp:690-724).
    Returns (delta_ref, power), float32 semantics."""
    t0, t1 = 65, 97
    alpha_t0, alpha_t1 = _f32(0.04), _f32(0.10)
    m_t0 = _f32(2.0 * (1.0 - t0 / 100.0))
    m_t1 = _f32(2.0 * (1.0 - t1 / 100.0))
    if qfactor < 50:
        m_q = _f32(50.0 / qfactor)
    else:
        m_q = _f32(2.0 * (1.0 - _f32(qfactor / 100.0)))
    if qfactor <= t0:
        power = 1.0
        alpha_q = alpha_t0
    elif qfactor < t1:
        power = _f32(_f32(math.log(m_q) - math.log(m_t1))
                     / _f32(math.log(m_t0) - math.log(m_t1)))
        alpha_q = _f32(alpha_t1 * _f32(math.pow(alpha_t0 / alpha_t1,
                                                power)))
    else:
        power = 0.0
        alpha_q = alpha_t1
    eps = _f32(math.sqrt(0.5) * math.ldexp(1.0, -bit_depth))
    return _f32(_f32(alpha_q * m_q) + eps), power


def make_qfactor_qcd(num_decomps: int, bit_depth: int, qfactor: int,
                     ctype: int, sampling=(1, 1), comp_idx=None) -> Qcd:
    """Irreversible QCD/QCC with Qfactor visual weighting
    (param_qcd::set_irrev_quant, ojph_params.cpp:1542-1599)."""
    if sampling == (2, 2):
        fmt = '420'
    elif sampling == (2, 1):
        fmt = '422'
    elif sampling == (1, 1):
        fmt = '444'
    else:
        _err(0x00050161, 'Qfactor can only be used on components with '
             '4:4:4, 4:2:2 or 4:2:0 sampling')
    g_c = _f32(_VW_GAIN[ctype])
    delta_ref, power = _qfactor_delta_ref(qfactor, bit_depth)
    weights = _VW_Y if ctype == COMP_Y else _VW[(ctype, fmt)]

    guard_bits = 1
    sqcd = (guard_bits << 5) | 0x2
    sp: List[int] = []
    gl = _f32(SQRT_ENERGY_GAIN_97_L[num_decomps])
    w_b = _f32(math.pow(_f32(_vw_weight(weights, num_decomps, 0)), power))
    sp.append(_encode_spqcd(delta_ref / (gl * gl * g_c * w_b)))
    for d in range(num_decomps, 0, -1):
        gl = _f32(SQRT_ENERGY_GAIN_97_L[d])
        gh = _f32(SQRT_ENERGY_GAIN_97_H[d - 1])
        w_b = _f32(math.pow(_f32(_vw_weight(weights, d, 1)), power))
        sp.append(_encode_spqcd(delta_ref / (gh * gl * g_c * w_b)))
        w_b = _f32(math.pow(_f32(_vw_weight(weights, d, 2)), power))
        sp.append(_encode_spqcd(delta_ref / (gl * gh * g_c * w_b)))
        w_b = _f32(math.pow(_f32(_vw_weight(weights, d, 3)), power))
        sp.append(_encode_spqcd(delta_ref / (gh * gh * g_c * w_b)))
    return Qcd(sqcd, sp, comp_idx)
