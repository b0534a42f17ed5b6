"""Device ms per per-instance tick from its start to the QP built: the
captured `RTISolver.step_fn` tick's stamps `tick.start` and `qp.built`
(the linearization and the QP's assembly), averaged over the window's
ticks."""

from port_bench.metrics._trace import MS, point, ticks, trace_of


def read(rec):
    trace = trace_of(rec)
    if trace is None:
        return None
    qp = [point(t, "qp.built")[1] - t["start"]
          for t in ticks(trace, "instance.step") if point(t, "qp.built")]
    return MS * sum(qp) / len(qp) if qp else None
