"""The 90th percentile (nearest rank) of one sample's wall time, open to
summary, over every sample of the window."""

from shotbench.yardstick import nearest_rank


def read(run):
    if run.kind != "resident" or not run.requests:
        return None
    return nearest_rank([r.wall_s for r in run.requests], 0.9)
