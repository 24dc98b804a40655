"""Mean fixpoint iterations a dispatch, from ``engine_fixpoint_iterations``
(sum / count over the window). The fused list path records none."""


def read(rec):
    total, n = rec["hists"].get("engine_fixpoint_iterations", (0.0, 0))
    return total / n if n else None
