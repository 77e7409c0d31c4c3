"""decode.rest_graph_share: the share of the rest of graph's dispatches
(the port's stage `decode.dispatch.rest`) that replayed a CUDA graph
captured before them in the traced window, in %: replays (stage
`decode.rest_graph.replay`) less the captures (`decode.rest_graph.capture`,
each of which also replays), over dispatches.  So a capture in the window
reads below 100 as an eager launch does.  A program whose rest of graph
records none of the `decode.rest_graph.*` stages has nothing to read; one
that ran it eagerly throughout (on the CPU, say) reads 0.0."""
from gpubench.harness.spans import BURST

STAGES = ('decode.rest_graph.eager', 'decode.rest_graph.capture',
          'decode.rest_graph.replay')


def read(rec, metric):
    st = rec.stages
    if not st or BURST not in st or not any(s in st for s in STAGES):
        return None
    calls = st.get('decode.dispatch.rest', {}).get('calls', 0)
    if not calls:
        return None

    def n(stage):
        return st.get(stage, {}).get('calls', 0)

    return 100.0 * max(0, n('decode.rest_graph.replay')
                       - n('decode.rest_graph.capture')) / calls
