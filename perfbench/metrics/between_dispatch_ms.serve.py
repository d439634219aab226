"""Device idle between pipeline dispatches: for each pair of consecutive
``perfbench.dispatch`` spans in the traced window, the time from the last
kernel the first launched to the first kernel the next launched, less the
time other kernels (the semantic predictor, the next clips' noise) ran in
between; the mean over the pairs, in ms. The host's work between dispatches
(replies, GIF hand-off, gathering the next group) shows here."""

LAYER = "server"
MOVES = "clips_per_s"


def read(run):
    t = run.trace
    if t is None:
        return None
    spans = sorted(s for s in t.spans.get("perfbench.dispatch", ())
                   if t.window[0] <= s[0] and s[1] <= t.window[1])
    edges = []
    for span in spans:
        ks = [k for k in t.in_window() if k[3] is not None and k[4] == span[2]
              and span[0] <= k[3] <= span[1]]
        if ks:
            edges.append((min(k[0] for k in ks), max(k[1] for k in ks)))
    if len(edges) < 2:
        return None
    idle = 0.0
    for (_, end), (start, _) in zip(edges, edges[1:]):
        if start > end:
            between = [(max(k[0], end), min(k[1], start)) for k in t.in_window()
                       if k[1] > end and k[0] < start]
            idle += (start - end) / 1e6 - t.busy_s([(a, b) for a, b in between if b > a])
    return 1e3 * idle / (len(edges) - 1)
