"""decode.t2_walk_share: the share of the tile-parts parsed in the traced
window that Tier-2 walked in one native call (the port's stage
`decode.t2.walk`, a call a tile-part), over those and the tile-parts
parsed a packet at a time (`decode.t2.packets`), in %.  A program that
records neither stage, or none under a burst span, has nothing to
read."""
from gpubench.harness.spans import BURST

WALK, PACKETS = 'decode.t2.walk', 'decode.t2.packets'


def read(rec, metric):
    st = rec.stages
    if not st or BURST not in st:
        return None
    walks = st.get(WALK, {}).get('calls', 0)
    parts = walks + st.get(PACKETS, {}).get('calls', 0)
    if not parts:
        return None
    return 100.0 * walks / parts
