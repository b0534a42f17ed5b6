"""Device ms per per-instance tick: CUDA events around each captured
`RTISolver.step_fn` replay (with the copy of its outputs), averaged over
the traced ticks."""


def read(rec):
    ms = rec.get("instance_replay_ms")
    return sum(ms) / len(ms) if ms else None
