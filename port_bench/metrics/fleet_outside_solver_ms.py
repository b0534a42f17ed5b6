"""ms per fleet tick outside the solver's call: the synced host span of
each traced fleet tick minus the synced span around its
`solver.step_fn` call, averaged over the ticks (runner `fleet_mission`)."""


def read(rec):
    tick, solve = rec.get("fleet_tick_ms"), rec.get("solver_call_ms")
    if not tick or not solve or len(tick) != len(solve):
        return None
    return sum(t - s for t, s in zip(tick, solve)) / len(tick)
