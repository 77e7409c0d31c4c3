"""decode.pack_reuse_share: the share of the raw packs in the traced window
(the port's stage `decode.host_prep.pack`, a call a burst) that wrote into
the video decoder's host buffer as it stood, without growing it first
(`decode.pack.grow`, a call a growth), in %: 100 x (1 - growths / packs).
A program that records no pack stage, or no burst span, has nothing to
read; one that packs into a fresh buffer every burst records no growth,
so it reads 100 as well."""
from gpubench.harness.spans import BURST

PACK, GROW = 'decode.host_prep.pack', 'decode.pack.grow'


def read(rec, metric):
    st = rec.stages
    if not st or BURST not in st:
        return None
    packs = st.get(PACK, {}).get('calls', 0)
    if not packs:
        return None
    return 100.0 * (1.0 - st.get(GROW, {}).get('calls', 0) / packs)
