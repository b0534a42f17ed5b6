"""Pieces the runners share: the configuration's OCP and engine, the
seed's streams, the hull's starts, the sampled solves the reference
judges, and the judging itself."""

import math

import numpy as np
import torch

from port_bench.reference.qp import OCP

F64 = torch.float64


def spec_and_engine(cfg, kind):
    """The configuration's OCP, held to its stated sizes (`nx`, `nu`, `nh`),
    and its `kind` engine ("lane" or "instance"): `engines[kind]` holds the
    port's `SolverConfig` fields, so the configuration names what runs."""
    from mpc_collisionavoidance_tpu_torch.config import SolverConfig
    from mpc_collisionavoidance_tpu_torch.ocp import builders
    spec = builders.build(cfg["ocp"], Tf=cfg["Tf"], N=cfg["N"])
    built = dict(nx=spec.model.nx, nu=spec.model.nu, nh=spec.model.nh)
    stated = {k: cfg[k] for k in built}
    if built != stated:
        raise SystemExit(f"configuration {cfg['name']}: the OCP builds "
                         f"{built}, the configuration states {stated}")
    return spec, SolverConfig(**cfg["engines"][kind])


def rng_of(seed, stream=0):
    """numpy's generator for `seed` (any whole number) and a stream."""
    return np.random.default_rng([seed % 2**64, stream])


def lane_order(seed, n):
    """The seed's order of a traffic's `n` tracks over the lanes (lane l
    runs track `order[l]`).  The tracks themselves are drawn from the
    traffic's own `set_seed`, the same for every seed, so every seed does
    the same work: a seed that drew the tracks too would change the
    escalation the batch needs, and with it the rate, by up to 5%."""
    return rng_of(seed, 9).permutation(n)


def next_of_track(track, restarts, first, spare):
    """The index into a pool of `first` first items and `spare` spare ones
    that a track takes at its `restarts`-th restart (from 0): its own
    sequence, whichever lane runs it."""
    return first + (track + restarts * first) % spare


def path_starts(rng, n, spec):
    """`n` starts on the hull's path (`spec`: the traffic's `starts`):
    along-track uniform over the segment, cross-track N(0, sd), heading
    the segment's plus N(0, sd), at rest (the reference's start, u =
    0.001); a start nearer an obstacle centre than `clearance` is drawn
    again.  Returns (n, 14) float64."""
    x1, y1, x2, y2 = spec["segment"]
    ak = math.atan2(y2 - y1, x2 - x1)
    length = math.hypot(x2 - x1, y2 - y1)
    obs = np.asarray(spec["obstacles"], float).reshape(-1, 2)
    out = np.zeros((n, 14))
    for i in range(n):
        while True:
            s = rng.uniform(0.0, length)
            ye = rng.normal(0.0, spec["cross_track_sd"])
            psi = ak + rng.normal(0.0, spec["heading_sd"])
            px = x1 + s * math.cos(ak) - ye * math.sin(ak)
            py = y1 + s * math.sin(ak) + ye * math.cos(ak)
            if np.min(np.hypot(obs[:, 0] - px, obs[:, 1] - py)) \
                    >= spec["clearance"]:
                break
        out[i] = (psi, math.sin(psi), math.cos(psi), 0.001, 0.0, 0.0, ye,
                  x1, y1, ak, px, py, 0.0, 0.0)
    return out


def path_problem(spec, nx, nu):
    """The path scenario's obstacle parameters (np,), bounds (nh,) and
    stage reference (ny,): head along the segment at `speed`
    (sim/scenarios.py:101-121's pf_ca_default)."""
    x1, y1, x2, y2 = spec["segment"]
    ak = math.atan2(y2 - y1, x2 - x1)
    p = np.asarray(spec["obstacles"], float).reshape(-1)
    lh = np.asarray(spec["radii"], float)
    yref = np.zeros(nx + nu)
    yref[1], yref[2], yref[3] = math.sin(ak), math.cos(ak), spec["speed"]
    return p, lh, yref


def sample_ticks(rng, traffic, seconds):
    """The window's ticks whose solves the reference judges: `ticks` of
    them, drawn from the ticks that every run of the cell reaches
    (`min_ticks_per_s` times the window)."""
    c = traffic["check"]
    reach = max(int(c["min_ticks_per_s"] * seconds), c["ticks"] + 1)
    return set(int(t) for t in rng.choice(reach, c["ticks"], replace=False))


class Solves:
    """The sampled solves of a run, per-instance shaped, on the host in
    float64: the warm start each started from, its inputs, the program's
    answer and status."""

    def __init__(self):
        self.prior, self.answer, self.status = [], [], []

    def add(self, prior, answer, status):
        self.prior.append({k: v.detach().to("cpu", F64)
                           for k, v in prior.items()})
        self.answer.append({k: v.detach().to("cpu", F64)
                            for k, v in answer.items()})
        self.status.append(status.detach().to("cpu").reshape(-1))

    def cat(self):
        prior = {k: torch.cat([p[k] for p in self.prior])
                 for k in self.prior[0]}
        answer = {k: torch.cat([a[k] for a in self.answer])
                  for k in self.answer[0]}
        return prior, answer, torch.cat(self.status)


def judge(ocp_name, solves, device, control=False, block=64):
    """The reference's readings of the sampled solves: `feas` and
    `cost_gap` over the answers that report status 0 (the others said
    they did not converge), the count judged, the count of non-finite
    answers that report status 0, and `frozen`, the count of finite
    answers of any status that are their warm start unchanged (a tick
    always moves its iterate; a lane left out of the step does not, and
    may report that it did not converge).  `control`: the control's
    readings on the same ticks instead."""
    if not solves.prior:
        return dict(feas=math.inf, cost_gap=math.inf, judged=0,
                    nonfinite_ok=0, frozen=0, ref_unconverged=0)
    prior, answer, status = solves.cat()
    same = torch.stack([(answer[k] == prior[k]).flatten(1).all(1)
                        for k in ("xbar", "ubar")]).all(0)
    frozen = int(same.sum())
    finite = torch.stack([torch.isfinite(answer[k]).flatten(1).all(1)
                          for k in answer]).all(0)
    # a non-finite answer that reports status 0 says the wrong thing
    nonfinite_ok = int(((status == 0) & ~finite).sum())
    sel = ((status == 0) & finite).nonzero().flatten()
    ocp = OCP(ocp_name, device)
    feas, gap, unconv = [], [], 0
    for i in range(0, sel.numel(), block):
        idx = sel[i:i + block]
        pr = {k: v[idx].to(device) for k, v in prior.items()}
        an = {k: v[idx].to(device) for k, v in answer.items()}
        r = ocp.judge(pr, an, control=control)
        feas.append(r["feas"].cpu())
        ok = r["ref_ok"].cpu()
        unconv += int((~ok).sum())
        gap.append(torch.where(ok, r["cost_gap"].cpu(), 0.0))
    if not feas:
        return dict(feas=math.inf, cost_gap=math.inf, judged=0,
                    nonfinite_ok=nonfinite_ok, frozen=frozen,
                    ref_unconverged=0)
    return dict(feas=float(torch.cat(feas).max()),
                cost_gap=float(torch.cat(gap).max()),
                judged=int(sel.numel()), nonfinite_ok=nonfinite_ok,
                frozen=frozen, ref_unconverged=unconv)


def out_mismatch(out, state, lanes):
    """Entries of the lane engine's outputs u0 and x1 at `lanes` that
    differ from the new state's first control and second state, the
    values they are taken from (NaN matches NaN: a non-finite answer is
    the same answer in both)."""
    def differ(a, b):
        return int(((a != b) & ~(torch.isnan(a) & torch.isnan(b))).sum())
    return (differ(out.u0[:, lanes], state.ubar[:, 0, lanes])
            + differ(out.x1[:, lanes], state.xbar[:, 1, lanes]))


def free_device():
    """Hand the program's cached device memory back before the reference
    runs."""
    import gc
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
