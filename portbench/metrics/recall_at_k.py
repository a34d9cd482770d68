"""recall_at_k: mean recall@k of the window's answers against the exact f32
cosine top-k of their queries, worked out by the reference after the window."""

import math


def read(run):
    return run.recall if math.isfinite(run.recall) else None
