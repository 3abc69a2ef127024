"""train_vertices_per_s: training-set vertices of every pass the window's
train() calls completed, over the window's seconds (host clock).
Evaluation passes count as time, not as work."""


def read(ctx):
    c = ctx["counters"]
    passes = sum(call["passes"] for call in c["calls"])
    if not passes:
        return None
    return passes * c["per_pass"]["train_n"] / ctx["window_s"]
