"""JPEG 2000 / HTJ2K marker-segment parsing and serialization.

This is the codestream *syntax* layer: typed dataclasses for every marker
segment the framework supports (SOC/SIZ/CAP/COD/COC/QCD/QCC/COM/NLT/DFS/
ATK/SOT/SOD/TLM/EOC), with byte-exact big-endian serialization.

Field semantics follow ITU-T T.800/T.814; parity with the reference
implementation is checked against ojph_params.cpp
(OpenJPH src/core/codestream/ojph_params.cpp:805-2460) and
ojph_params_local.h.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass, field
from enum import IntEnum
from typing import Dict, List, Optional, Tuple

from .atk import AtkKernel, builtin_kernel
from .message import error as _err, warn as _warn


class Marker(IntEnum):
    SOC = 0xFF4F
    CAP = 0xFF50
    SIZ = 0xFF51
    COD = 0xFF52
    COC = 0xFF53
    TLM = 0xFF55
    PRF = 0xFF56
    PLM = 0xFF57
    PLT = 0xFF58
    CPF = 0xFF59
    QCD = 0xFF5C
    QCC = 0xFF5D
    RGN = 0xFF5E
    POC = 0xFF5F
    PPM = 0xFF60
    PPT = 0xFF61
    CRG = 0xFF63
    COM = 0xFF64
    DFS = 0xFF72
    ADS = 0xFF73
    NLT = 0xFF76
    ATK = 0xFF79
    SOT = 0xFF90
    SOP = 0xFF91
    EPH = 0xFF92
    SOD = 0xFF93
    EOC = 0xFFD9


class ProgOrder(IntEnum):
    LRCP = 0
    RLCP = 1
    RPCL = 2
    PCRL = 3
    CPRL = 4


# Rsiz flags (ojph_params_local.h:170-174)
RSIZ_NLT_FLAG = 0x200
RSIZ_HT_FLAG = 0x4000
RSIZ_EXT_FLAG = 0x8000

# block style flags (ojph_params_local.h:394-397)
VERT_CAUSAL_MODE = 0x8
HT_MODE = 0x40

# wavelet kernels (ojph_params_local.h:407-410)
DWT_IRV97 = 0
DWT_REV53 = 1


def _u8(b, off):
    if off + 1 > len(b):
        raise EOFError('truncated marker segment')
    return b[off], off + 1


def _u16(b, off):
    if off + 2 > len(b):
        raise EOFError('truncated marker segment')
    return (b[off] << 8) | b[off + 1], off + 2


def _u32(b, off):
    if off + 4 > len(b):
        raise EOFError('truncated marker segment')
    return struct.unpack_from('>I', b, off)[0], off + 4


@dataclass
class CompInfo:
    bit_depth: int = 8
    is_signed: bool = False
    dx: int = 1
    dy: int = 1

    @property
    def ssiz(self) -> int:
        return (self.bit_depth - 1) | (0x80 if self.is_signed else 0)


@dataclass
class Siz:
    """SIZ marker (T.800 A.5.1); ojph_params.cpp:805-928."""
    rsiz: int = RSIZ_HT_FLAG
    xsiz: int = 0
    ysiz: int = 0
    xosiz: int = 0
    yosiz: int = 0
    xtsiz: int = 0
    ytsiz: int = 0
    xtosiz: int = 0
    ytosiz: int = 0
    comps: List[CompInfo] = field(default_factory=list)

    @property
    def num_comps(self) -> int:
        return len(self.comps)

    def comp_width(self, c: int) -> int:
        d = self.comps[c].dx
        return -(-self.xsiz // d) - (-(-self.xosiz // d))

    def comp_height(self, c: int) -> int:
        d = self.comps[c].dy
        return -(-self.ysiz // d) - (-(-self.yosiz // d))

    def to_bytes(self) -> bytes:
        lsiz = 38 + 3 * self.num_comps
        out = struct.pack('>HHHIIIIIIIIH', Marker.SIZ, lsiz, self.rsiz,
                          self.xsiz, self.ysiz, self.xosiz, self.yosiz,
                          self.xtsiz, self.ytsiz, self.xtosiz, self.ytosiz,
                          self.num_comps)
        for c in self.comps:
            out += struct.pack('>BBB', c.ssiz, c.dx, c.dy)
        return out

    @classmethod
    def from_bytes(cls, body: bytes) -> 'Siz':
        # body excludes the marker and Lsiz
        rsiz, o = _u16(body, 0)
        if (rsiz & RSIZ_HT_FLAG) == 0:
            _err(0x00050044, 'Rsiz bit 14 is not set (this is not a '
                 'JPH file)')
        if (rsiz & 0x8000) != 0 and (rsiz & 0xD5F) != 0:
            # ojph_params.cpp:868-870
            _warn(0x00050001, 'Rsiz in SIZ has unimplemented fields')
        vals = struct.unpack_from('>IIIIIIII', body, o)
        o += 32
        csiz, o = _u16(body, o)
        comps = []
        for _ in range(csiz):
            ssiz, o = _u8(body, o)
            dx, o = _u8(body, o)
            dy, o = _u8(body, o)
            if dx == 0 or dy == 0:
                # ojph_params.cpp:918-921 (0x00050055/0x00050056)
                _err(0x00050055 if dx == 0 else 0x00050056,
                     'wrong SIZ XRsiz/YRsiz value of 0')
            comps.append(CompInfo((ssiz & 0x7F) + 1, (ssiz & 0x80) != 0,
                                  dx, dy))
        return cls(rsiz, *vals, comps=comps)


@dataclass
class Cap:
    """CAP marker (T.814 A.2); ojph_params.cpp:968-1013."""
    pcap: int = 0x00020000
    ccap: Tuple[int, ...] = (0,)

    def to_bytes(self) -> bytes:
        n = bin(self.pcap).count('1')
        out = struct.pack('>HHI', Marker.CAP, 6 + 2 * n, self.pcap)
        for i in range(n):
            out += struct.pack('>H', self.ccap[i])
        return out

    @classmethod
    def from_bytes(cls, body: bytes) -> 'Cap':
        pcap, o = _u32(body, 0)
        if pcap & 0xFFFDFFFF:
            _err(0x00050063,
                 'Pcap in CAP has options that are not supported')
        if (pcap & 0x00020000) == 0:
            _err(0x00050064, 'Pcap should have its 15th MSB set, Pcap^15; '
                 'this is not a JPH file')
        n = bin(pcap).count('1')
        ccap = []
        for _ in range(n):
            v, o = _u16(body, o)
            ccap.append(v)
        return cls(pcap, tuple(ccap))


@dataclass
class Cod:
    """COD / COC marker (T.800 A.6.1/A.6.2); ojph_params.cpp:1035-1276.

    For COC, ``comp_idx`` is set and ``prog_order``/``num_layers``/
    ``mc_trans`` are inherited from the main COD.
    """
    scod: int = 0
    prog_order: int = ProgOrder.RPCL
    num_layers: int = 1
    mc_trans: int = 0
    num_decomps: int = 5
    log_block_w: int = 6           # actual log2 of codeblock width
    log_block_h: int = 6
    block_style: int = HT_MODE
    wavelet_kern: int = DWT_REV53
    precinct_sizes: List[int] = field(default_factory=list)  # PPx | PPy<<4
    comp_idx: Optional[int] = None  # None for COD, component index for COC
    dfs_idx: Optional[int] = None   # Part-2 DFS index (COC only; signaled
    #                                 by num_decomp bit 0x80, T.801 A.6.5 /
    #                                 param_cod::is_dfs_defined)
    atk: Optional[AtkKernel] = None  # resolved wavelet kernel (ATK markers
    #                                  for wavelet_kern >= 2)

    @property
    def uses_precincts(self) -> bool:
        return (self.scod & 1) != 0

    @property
    def uses_sop(self) -> bool:
        return (self.scod & 2) != 0

    @property
    def uses_eph(self) -> bool:
        return (self.scod & 4) != 0

    @property
    def is_reversible(self) -> bool:
        if self.atk is not None:
            return self.atk.reversible
        return self.wavelet_kern == DWT_REV53

    @property
    def kernel(self) -> AtkKernel:
        """The lifting kernel in effect (param_cod::access_atk)."""
        return self.atk if self.atk is not None \
            else builtin_kernel(self.wavelet_kern)

    @property
    def uses_dfs(self) -> bool:
        return self.dfs_idx is not None

    @property
    def vert_causal(self) -> bool:
        return (self.block_style & VERT_CAUSAL_MODE) != 0

    def log_precinct_size(self, res_num: int) -> Tuple[int, int]:
        """(log PPx, log PPy) for a resolution; 15,15 if no precincts."""
        if not self.uses_precincts:
            return (15, 15)
        v = self.precinct_sizes[res_num]
        return (v & 0xF, v >> 4)

    def to_bytes(self, num_comps: int = 0) -> bytes:
        pp = bytes(self.precinct_sizes[:self.num_decomps + 1]) \
            if self.uses_precincts else b''
        if self.comp_idx is None:
            lcod = 12 + len(pp)
            return struct.pack('>HHBBHBBBBBB', Marker.COD, lcod, self.scod,
                               self.prog_order, self.num_layers,
                               self.mc_trans, self.num_decomps,
                               self.log_block_w - 2, self.log_block_h - 2,
                               self.block_style, self.wavelet_kern) + pp
        else:
            if num_comps < 257:
                lcod = 9 + len(pp)
                head = struct.pack('>HHB', Marker.COC, lcod, self.comp_idx)
            else:
                lcod = 10 + len(pp)
                head = struct.pack('>HHH', Marker.COC, lcod, self.comp_idx)
            nd_byte = self.num_decomps if self.dfs_idx is None \
                else 0x80 | (self.dfs_idx & 0xF)
            return head + struct.pack('>BBBBBB', self.scod, nd_byte,
                                      self.log_block_w - 2,
                                      self.log_block_h - 2,
                                      self.block_style,
                                      self.wavelet_kern) + pp

    @classmethod
    def from_bytes(cls, body: bytes) -> 'Cod':
        scod, o = _u8(body, 0)
        po, o = _u8(body, o)
        layers, o = _u16(body, o)
        mct, o = _u8(body, o)
        nd, o = _u8(body, o)
        bw, o = _u8(body, o)
        bh, o = _u8(body, o)
        bs, o = _u8(body, o)
        wk, o = _u8(body, o)
        cod = cls(scod, po, layers, mct, nd, bw + 2, bh + 2, bs, wk)
        cod._validate()
        if scod & 1:
            for i in range(nd + 1):
                v, o = _u8(body, o)
                if i and ((v & 0xF) == 0 or (v >> 4) == 0):
                    _err(0x0005007F, 'precinct width or height for '
                         'resolutions other than the coarsest must be '
                         'larger than 1')
                cod.precinct_sizes.append(v)
        return cod

    @classmethod
    def coc_from_bytes(cls, body: bytes, num_comps: int,
                       main: 'Cod') -> 'Cod':
        o = 0
        if num_comps < 257:
            cidx, o = _u8(body, o)
        else:
            cidx, o = _u16(body, o)
        scod, o = _u8(body, o)
        if scod & 0xFE:
            # only bit 0 (precincts defined) is meaningful in Scoc
            # (ojph_params.cpp, 0x00050011)
            _warn(0x00050011,
                  'unsupported options in Scoc field of the COC segment')
        nd, o = _u8(body, o)
        bw, o = _u8(body, o)
        bh, o = _u8(body, o)
        bs, o = _u8(body, o)
        wk, o = _u8(body, o)
        dfs_idx = None
        if nd & 0x80:
            # DFS signaled: low nibble is the DFS marker index and the
            # decomposition count comes from the main COD
            # (param_cod::is_dfs_defined/get_num_decompositions,
            # ojph_params_local.h:504-519,613-618)
            dfs_idx = nd & 0xF
            nd = main.num_decomps
        coc = cls(scod, main.prog_order, main.num_layers, main.mc_trans,
                  nd, bw + 2, bh + 2, bs, wk, comp_idx=cidx,
                  dfs_idx=dfs_idx)
        coc._validate()
        if scod & 1:
            for i in range(nd + 1):
                v, o = _u8(body, o)
                if i and ((v & 0xF) == 0 or (v >> 4) == 0):
                    _err(0x0005007F, 'precinct width or height for '
                         'resolutions other than the coarsest must be '
                         'larger than 1')
                coc.precinct_sizes.append(v)
        return coc

    def _validate(self):
        if (self.num_decomps > 32 or self.log_block_w > 10
                or self.log_block_h > 10
                or self.log_block_w + self.log_block_h > 12
                or (self.block_style & 0x40) != 0x40
                or (self.block_style & 0xB7) != 0x00):
            _err(0x0005007E,
                 'wrong or unsupported settings in a COD/COC SPcod '
                 'parameter')


@dataclass
class Qcd:
    """QCD / QCC marker (T.800 A.6.4/A.6.5); ojph_params.cpp:1778-2008.

    ``spqcd`` holds raw per-subband entries: u8 exponents<<3 for
    reversible (Sqcd&0x1F == 0), u16 (exp<<11|mantissa) for scalar
    expounded (== 2).
    """
    sqcd: int = 0
    spqcd: List[int] = field(default_factory=list)
    comp_idx: Optional[int] = None  # None for QCD, component index for QCC

    @property
    def num_guard_bits(self) -> int:
        return self.sqcd >> 5

    @property
    def quant_style(self) -> int:
        return self.sqcd & 0x1F

    @property
    def num_subbands(self) -> int:
        return len(self.spqcd)

    def get_kmax(self, resolution: int, subband: int,
                 idx: Optional[int] = None) -> int:
        """Kmax = maximum magnitude bits (ojph_params.cpp:1715-1748).

        ``idx`` overrides the subband index for Part-2 DFS band layouts
        (param_dfs::get_subband_idx)."""
        if idx is None:
            idx = (resolution - 1) * 3 + subband if resolution else 0
        idx = min(idx, self.num_subbands - 1)
        style = self.quant_style
        if style == 0:
            nb = self.spqcd[idx] >> 3
            nb = 0 if nb == 0 else nb - 1
        elif style == 2:
            nb = (self.spqcd[idx] >> 11) - 1
        else:
            _err(0x00050088, 'wrong Sqcd value in QCD/QCC marker')
        return nb + self.num_guard_bits

    def get_largest_kmax(self) -> int:
        style = self.quant_style
        nb = 0
        for v in self.spqcd:
            if style == 0:
                t = v >> 3
                nb = max(nb, 0 if t == 0 else t - 1)
            else:
                nb = max(nb, (v >> 11) - 1)
        return nb + self.num_guard_bits

    def get_irrev_delta(self, resolution: int, subband: int,
                        idx: Optional[int] = None) -> float:
        """Base quantization delta (ojph_params.cpp:1650-1681)."""
        if self.quant_style != 2:
            _err(0x0005008C, 'reversible Sqcd for irreversible transform')
        gain = (1.0, 2.0, 2.0, 4.0)[subband]
        if idx is None:
            idx = (resolution - 1) * 3 + subband if resolution else 0
        idx = min(idx, self.num_subbands - 1)
        eps = self.spqcd[idx] >> 11
        mantissa = float((self.spqcd[idx] & 0x7FF) | 0x800) * gain
        return mantissa / (1 << 11) / (1 << eps)

    def get_magb(self) -> int:
        """Largest magnitude-bits value for CAP (ojph_params.cpp:1615)."""
        b = 0
        nd = (self.num_subbands - 1) // 3
        for i, v in enumerate(self.spqcd):
            if self.quant_style == 0:
                t = (v >> 3) + self.num_guard_bits - 1
            else:
                nb = nd - ((i - 1) // 3 if i else 0)
                t = (v >> 11) + self.num_guard_bits - nb
            b = max(b, t)
        return b

    def propose_precision(self) -> int:
        """Block-coder sample precision (ojph_params.cpp:1684-1706)."""
        return self.get_largest_kmax() + 2

    def to_bytes(self, num_comps: int = 0) -> bytes:
        style = self.quant_style
        if style == 0:
            payload = bytes(self.spqcd)
        elif style == 2:
            payload = b''.join(struct.pack('>H', v) for v in self.spqcd)
        else:
            _err(0x00050088, 'wrong Sqcd value in QCD/QCC marker')
        if self.comp_idx is None:
            return struct.pack('>HHB', Marker.QCD, 3 + len(payload),
                               self.sqcd) + payload
        if num_comps < 257:
            return struct.pack('>HHBB', Marker.QCC, 4 + len(payload),
                               self.comp_idx, self.sqcd) + payload
        return struct.pack('>HHHB', Marker.QCC, 5 + len(payload),
                           self.comp_idx, self.sqcd) + payload

    @classmethod
    def from_bytes(cls, body: bytes, comp_idx: Optional[int] = None,
                   num_comps: int = 0) -> 'Qcd':
        o = 0
        if comp_idx is not None:
            if num_comps < 257:
                comp_idx, o = _u8(body, o)
            else:
                comp_idx, o = _u16(body, o)
        sqcd, o = _u8(body, o)
        style = sqcd & 0x1F
        sp = []
        if style == 0:
            while o < len(body):
                v, o = _u8(body, o)
                sp.append(v)
        elif style == 2:
            while o < len(body):
                v, o = _u16(body, o)
                sp.append(v)
        else:
            _err(0x00050088, 'wrong Sqcd value in QCD/QCC marker')
        if not sp:
            _err(0x0005008A, 'QCD/QCC marker segment that specifies no '
                 'quantization information')
        return cls(sqcd, sp, comp_idx)


@dataclass
class Com:
    """COM marker (T.800 A.9.2)."""
    rcom: int = 1  # 1 = Latin text
    data: bytes = b''

    def to_bytes(self) -> bytes:
        return struct.pack('>HHH', Marker.COM, len(self.data) + 4,
                           self.rcom) + self.data

    @classmethod
    def from_bytes(cls, body: bytes) -> 'Com':
        rcom, o = _u16(body, 0)
        return cls(rcom, bytes(body[o:]))


@dataclass
class NltSegment:
    """One NLT marker segment (T.801); ojph_params.cpp:2210-2266."""
    cnlt: int = 0xFFFF   # component, 0xFFFF = all components
    bdnlt: int = 0
    tnlt: int = 0        # 0 = none, 3 = binary complement to sign-magnitude

    def to_bytes(self) -> bytes:
        return struct.pack('>HHHBB', Marker.NLT, 6, self.cnlt,
                           self.bdnlt, self.tnlt)

    @classmethod
    def from_bytes(cls, body: bytes) -> 'NltSegment':
        cnlt, o = _u16(body, 0)
        bdnlt, o = _u8(body, o)
        tnlt, o = _u8(body, o)
        if tnlt not in (0, 3):
            # ojph_params.cpp nonlinearity check (0x00050171)
            _err(0x00050171, f'nonlinearities other than type 0 and 3 are '
                 f'not supported; found type {tnlt}')
        return cls(cnlt, bdnlt, tnlt)


class Nlt:
    """Collection of NLT segments with per-component lookup."""

    def __init__(self):
        self.segments: Dict[int, NltSegment] = {}

    def type3_for(self, comp: int) -> bool:
        seg = self.segments.get(comp, self.segments.get(0xFFFF))
        return seg is not None and seg.tnlt == 3

    def add(self, seg: NltSegment):
        self.segments[seg.cnlt] = seg


@dataclass
class Sot:
    """SOT marker (T.800 A.4.2); ojph_params.cpp:2343-2460."""
    isot: int = 0
    psot: int = 0
    tpsot: int = 0
    tnsot: int = 1

    @property
    def payload_length(self) -> int:
        return self.psot - 12 if self.psot > 0 else 0

    def to_bytes(self) -> bytes:
        return struct.pack('>HHHIBB', Marker.SOT, 10, self.isot, self.psot,
                           self.tpsot, self.tnsot)

    @classmethod
    def from_bytes(cls, body: bytes) -> 'Sot':
        isot, o = _u16(body, 0)
        psot, o = _u32(body, o)
        tpsot, o = _u8(body, o)
        tnsot, o = _u8(body, o)
        if isot == 0xFFFF:
            _err(0x00050094, 'tile index in SOT marker cannot be 0xFFFF')
        return cls(isot, psot, tpsot, tnsot)


@dataclass
class Tlm:
    """TLM marker (T.800 A.7.1); ojph_params.cpp:2472-2519."""
    pairs: List[Tuple[int, int]] = field(default_factory=list)  # (Ttlm, Ptlm)

    def to_bytes(self) -> bytes:
        out = struct.pack('>HHBB', Marker.TLM, 4 + 6 * len(self.pairs),
                          0, 0x60)
        for t, p in self.pairs:
            out += struct.pack('>HI', t, p)
        return out


@dataclass
class Dfs:
    """DFS marker (T.801 A.3.5); ojph_params.cpp:2530-2660.

    ``ddfs`` packs one 2-bit decomposition type per sub-level, MSB
    first; levels beyond ``ids`` repeat the last entry
    (param_dfs::get_dwt_type clamps decomp_level to Ids).
    """
    sdfs: int = 0
    ids: int = 0
    ddfs: bytes = b''

    NO_DWT, BIDIR_DWT, HORZ_DWT, VERT_DWT = 0, 1, 2, 3

    def get_dwt_type(self, decomp_level: int) -> int:
        decomp_level = min(decomp_level, self.ids)
        d = decomp_level - 1
        return (self.ddfs[d >> 2] >> (6 - 2 * (d & 3))) & 0x3

    def get_subband_idx(self, num_decomps: int, resolution: int,
                        subband: int) -> int:
        """Index into the QCD/QCC subband array for (resolution, band)
        (param_dfs::get_subband_idx, ojph_params.cpp:2550-2572)."""
        ns = (0, 3, 1, 1)  # bands contributed per decomposition type
        idx = 0
        if resolution > 0:
            i = 1
            while i < resolution:
                idx += ns[self.get_dwt_type(num_decomps - i + 1)]
                i += 1
            t = self.get_dwt_type(num_decomps - i + 1)
            idx += subband
            if t == self.VERT_DWT and subband == 2:
                idx -= 1
        return idx

    def get_res_downsamp(self, skipped_resolutions: int):
        """(x, y) downsampling factor after skipping resolutions
        (param_dfs::get_res_downsamp, ojph_params.cpp:2575-2594)."""
        fx = fy = 1
        for level in range(1, skipped_resolutions + 1):
            t = self.get_dwt_type(level)
            if t == self.BIDIR_DWT:
                fx *= 2
                fy *= 2
            elif t == self.HORZ_DWT:
                fx *= 2
            elif t == self.VERT_DWT:
                fy *= 2
        return fx, fy

    def to_bytes(self) -> bytes:
        n = (self.ids + 3) >> 2
        return struct.pack('>HHHB', Marker.DFS, 5 + n, self.sdfs,
                           self.ids) + self.ddfs[:n]

    @classmethod
    def from_types(cls, sdfs: int, types) -> 'Dfs':
        """Build from a list of per-level decomposition types (level 1 =
        finest resolution first)."""
        if not 0 <= sdfs <= 15:
            _err(0x000500D3, f'the DFS-Sdfs parameter is {sdfs}, which is '
                 'larger than the permissible 15')
        ids = len(types)
        if not 1 <= ids <= 32:
            _err(0x000500D8, 'the value of the Ids member in the DFS '
                 'marker segment must be in 1..32')
        buf = bytearray((ids + 3) >> 2)
        for i, t in enumerate(types):
            if not 0 <= t <= 3:
                _err(0x000500D9, f'bad DFS decomposition type {t}')
            buf[i >> 2] |= t << (6 - 2 * (i & 3))
        return cls(sdfs, ids, bytes(buf))


def write_main_header(siz: Siz, cod: Cod, qcd: Qcd,
                      cocs: List[Cod] = (), qccs: List[Qcd] = (),
                      nlts: List[NltSegment] = (),
                      comments: List[Com] = (),
                      version_comment: bytes = b'',
                      atks: List[AtkKernel] = (),
                      dfs_list: List[Dfs] = ()) -> bytes:
    """Serialize SOC + main header markers in the reference's order
    (ojph_codestream_local.cpp:643-703)."""
    out = struct.pack('>H', Marker.SOC)
    out += siz.to_bytes()
    # CAP depends on COD/QCD (param_cap::check_validity,
    # ojph_params_local.h:929-945)
    ccap0 = 0
    # the reference's CAP flags "irreversible" for anything other than
    # the hardwired 5/3, including reversible ATK kernels
    # (param_cap::check_validity, ojph_params_local.h:929-945)
    if cod.wavelet_kern != DWT_REV53:
        ccap0 |= 0x0020
    magb = qcd.get_magb()
    for q in qccs:
        magb = max(magb, q.get_magb())
    bp = 0 if magb <= 8 else (magb - 8 if magb < 28 else 13 + (magb >> 2))
    ccap0 |= bp
    out += Cap(ccap=(ccap0,)).to_bytes()
    for atk in atks:
        out += atk.to_bytes()
    for dfs in dfs_list:
        out += dfs.to_bytes()
    out += cod.to_bytes()
    for coc in cocs:
        if coc.comp_idx is not None and coc.comp_idx < siz.num_comps:
            out += coc.to_bytes(siz.num_comps)
    out += qcd.to_bytes()
    for qcc in qccs:
        if qcc.comp_idx is not None and qcc.comp_idx < siz.num_comps:
            out += qcc.to_bytes(siz.num_comps)
    for nlt in nlts:
        out += nlt.to_bytes()
    if version_comment:
        out += Com(1, version_comment).to_bytes()
    for com in comments:
        out += com.to_bytes()
    return out


class MainHeader:
    """Parsed main header contents."""

    def __init__(self):
        self.siz: Optional[Siz] = None
        self.cod: Optional[Cod] = None
        self.cocs: Dict[int, Cod] = {}
        self.qcd: Optional[Qcd] = None
        self.qccs: Dict[int, Qcd] = {}
        self.nlt = Nlt()
        self.dfs: List[Dfs] = []
        self.atks: Dict[int, AtkKernel] = {}
        self.comments: List[Com] = []
        self.header_size = 0  # offset of first SOT

    def get_cod(self, comp: int) -> Cod:
        return self.cocs.get(comp, self.cod)

    def get_qcd(self, comp: int) -> Qcd:
        return self.qccs.get(comp, self.qcd)

    def get_dfs(self, idx: int) -> Optional[Dfs]:
        for d in self.dfs:
            if d.sdfs == idx:
                return d
        return None


def read_main_header(buf: bytes) -> MainHeader:
    """Parse the main header up to (and excluding) the first SOT.

    Mirrors the marker loop of local::codestream::read_headers
    (ojph_codestream_local.cpp:769-880).
    """
    hdr = MainHeader()
    if len(buf) < 4 or struct.unpack_from('>H', buf, 0)[0] != Marker.SOC:
        _err(0x00030041, 'error reading marker: the codestream does '
             'not start with SOC')
    o = 2
    while o + 4 <= len(buf):
        mrk = struct.unpack_from('>H', buf, o)[0]
        if mrk == Marker.SOT:
            hdr.header_size = o
            break
        ln = struct.unpack_from('>H', buf, o + 2)[0]
        if ln < 2 or o + 2 + ln > len(buf):
            _err(0x00030041, 'error reading marker: truncated marker '
                 'segment in main header')
        body = buf[o + 4: o + 2 + ln]
        try:
            _read_one_marker(hdr, mrk, body)
        except (IndexError, struct.error):
            # a marker whose Lmar-delimited body is shorter than its
            # fields require (fuzzed/corrupt input)
            _err(0x00030041, 'error reading marker: truncated marker '
                 'segment in main header')
        o += 2 + ln
    else:
        _err(0x00030051, 'file ended before finding a tile segment '
             '(no SOT marker)')
    if hdr.siz is None or hdr.cod is None or hdr.qcd is None:
        _err(0x00030052, 'markers error: SIZ, COD and QCD are required')
    _resolve_kernels(hdr)
    return hdr


def _read_one_marker(hdr, mrk, body):
    if mrk in (Marker.COC, Marker.QCC) and hdr.siz is None:
        _err(0x00030052, 'COC/QCC before SIZ in main header')
    if mrk == Marker.SIZ:
        hdr.siz = Siz.from_bytes(body)
    elif mrk == Marker.CAP:
        Cap.from_bytes(body)
    elif mrk == Marker.COD:
        hdr.cod = Cod.from_bytes(body)
        if hdr.cod.num_layers != 1:
            # multi-layer packet headers would misparse silently
            # (ojph_codestream_local.cpp:794-798)
            _err(0x00030053,
                 'The current implementation supports 1 quality layer '
                 'only.  This codestream has %d quality layers'
                 % hdr.cod.num_layers)
    elif mrk == Marker.COC:
        coc = Cod.coc_from_bytes(body, hdr.siz.num_comps, hdr.cod)
        hdr.cocs[coc.comp_idx] = coc
    elif mrk == Marker.QCD:
        hdr.qcd = Qcd.from_bytes(body)
    elif mrk == Marker.QCC:
        qcc = Qcd.from_bytes(body, comp_idx=0,
                             num_comps=hdr.siz.num_comps)
        hdr.qccs[qcc.comp_idx] = qcc
    elif mrk == Marker.NLT:
        hdr.nlt.add(NltSegment.from_bytes(body))
    elif mrk == Marker.COM:
        hdr.comments.append(Com.from_bytes(body))
    elif mrk in (Marker.DFS,):
        sdfs = (body[0] << 8) | body[1]
        if sdfs > 15:
            _err(0x000500D3, f'the DFS-Sdfs parameter is {sdfs}, '
                             'permissible 15')
        ids = body[2]
        hdr.dfs.append(Dfs(sdfs, ids, bytes(body[3:3 + ((ids + 3) >> 2)])))
    elif mrk == Marker.ATK:
        atk = AtkKernel.from_bytes(body)
        if atk.index in hdr.atks:
            _err(0x000500F3, f'repeated ATK marker index '
                 f'{atk.index}; it would be unclear which segment '
                 'to employ')
        hdr.atks[atk.index] = atk
    # TLM/PLM/PPM/CRG/PRF/CPF: skipped (TLM is advisory on read)


def _resolve_kernels(hdr):
    # resolve wavelet kernels (param_cod::update_atk,
    # ojph_params.cpp:1278-1298) and DFS references
    for c in [hdr.cod] + list(hdr.cocs.values()):
        if c.wavelet_kern >= 2:
            if c.wavelet_kern not in hdr.atks:
                # 0x00050131 (COD) / 0x00050132 (COC),
                # ojph_params.cpp update_atk
                _err(0x00050131 if c.comp_idx is None else 0x00050132,
                     f'a COD/COC segment employs the DWT kernel atk = '
                     f'{c.wavelet_kern}, but a corresponding ATK segment '
                     'cannot be found')
            c.atk = hdr.atks[c.wavelet_kern]
        if c.dfs_idx is not None and hdr.get_dfs(c.dfs_idx) is None:
            _err(0x000500DA,
                 f'COC specifies the use of a DFS marker with index '
                 f'{c.dfs_idx}, but there is no such marker in the main '
                 'header')
    return hdr
