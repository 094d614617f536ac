"""JLN: the share of the planes P2PNet, the soft-argmax and WeightNet's
pool ran on that belong to people the HDN kept: 3 planes for each kept
person of the window's answers (their `mask`) over the program's
`jln_planes` counted in the traced window."""

from fvpbench import spans


def read(run):
    inside = spans.window_spans(run)
    if not inside:
        return None
    planes = spans.counted(inside, "jln_planes")
    if not planes:
        return None
    live = sum(int(o["mask"].sum()) for _, o in run.outputs)
    return 100.0 * 3 * live / planes
