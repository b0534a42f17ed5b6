"""Real-time serving engine: a UDS/TCP server around the lane-engine RTI
solver (counterpart of `mpc_collisionavoidance_tpu/rt/server.py`).

Plays the role the generated `acados_solve()` + node main loop play in the
reference (one low-latency solve per 20 Hz tick per vehicle):

- each client connection is one vehicle, and owns one lane of a
  fixed-width lane engine (`max_batch` lanes) whose SQP-RTI warm start is
  held on the device between ticks;
- requests from concurrent vehicles within a batching window are served by
  ONE tick of every lane; vehicles beyond `max_batch` get
  `STATUS_OVER_CAPACITY` replies until a lane frees up, and a freed lane
  is parked on a benign far-away problem;
- the asyncio loop is the transport and touches only host rows; one solve
  thread owns every device tensor and runs the ticks.

Transports (same frames on both): a Unix domain socket (default), or TCP
for a `host:port` address, with TCP_NODELAY per connection.  Frames: v1
(the flagship node's fixed frames) and v2 (any served model, runtime
dims, optional stage-constant yref), byte-identical to the JAX package's
(`rt/protocol.py`).

The device picks the kernels: on a CUDA device every tick runs the
hand-written kernels (the linearization kernel, then the Riccati kernel
per IPM iteration, or the fused whole-IPM kernel with `riccati="fused"`)
as one captured CUDA graph per tick, preparation and feedback
(`solver/capture.py`; `warmup()` captures them, as the JAX server's
compiles its jitted ticks); on the CPU their plain PyTorch versions, op by
op.  A CUDA device that is not there is an error, never a fallback.  Not
ported yet: the per-instance "vmap" engine (it needs `RTISolver`, ROADMAP
A7).

Run:  python -m mpc_collisionavoidance_tpu_torch.rt.server /tmp/nmpc.sock
  or: python -m mpc_collisionavoidance_tpu_torch.rt.server 0.0.0.0:8490
"""

import asyncio
import collections
import concurrent.futures
import dataclasses
import inspect
import logging
import os
import socket
import struct
import tempfile
import threading
import time
from typing import Dict, Optional

import numpy as np
import torch

from mpc_collisionavoidance_tpu_torch.config import production_engine
from mpc_collisionavoidance_tpu_torch.ocp import builders
from mpc_collisionavoidance_tpu_torch.rt import protocol
from mpc_collisionavoidance_tpu_torch.solver.batch import LaneRTISolver

#: reply status when every lane is taken; distinct from the solver's
#: 0 ok / 1 not converged / 2 NaN codes
STATUS_OVER_CAPACITY = 3

_log = logging.getLogger(__name__)


@dataclasses.dataclass
class _Req:
    """Version-normalized request (v1 flagship frame or v2 generic)."""
    version: int
    seq: int
    x0: tuple
    params: tuple
    lh: tuple
    yref: tuple        # () = builder's static references


def require_device(device) -> torch.device:
    """`device` as a torch.device; raise ValueError for a CUDA device on a
    host that has none (the server never runs on the CPU instead)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise ValueError(f"device '{device}': this host has no CUDA device "
                         "(torch.cuda.is_available() is False)")
    return device


def _resolve(fut, buf):
    if not fut.done():
        fut.set_result(buf)


class RTServer:
    def __init__(self, path: str, N: int = 100, Tf: float = 5.0,
                 ipm_iters: int = 8, batch_window_ms: float = 2.0,
                 max_batch: int = 128, engine: str = "lane",
                 riccati: str = "sweep", centering: str = "fixed",
                 rti_split: bool = False, model: str = "usv_guidance_ca1",
                 mu0=1.0, extra_iters: int = 0,
                 stall_tol: Optional[float] = None, ipm_tol: float = 1e-7,
                 *, device):
        """One server = one OCP `model` on one `device`, solved in float32
        by a lane engine of fixed width `max_batch`.  `riccati`,
        `centering`, `mu0`, `ipm_iters`, `extra_iters`, `stall_tol`,
        `ipm_tol`: the IPM schedule (`LaneRTISolver`).  `rti_split`: after
        replying to a tick, linearize for the next one at once, so the
        next request pays only the IPM (its obstacle table and references
        are then one tick old, the acados trade-off)."""
        if engine == "vmap":
            raise NotImplementedError(
                "the per-instance 'vmap' engine needs RTISolver, which is "
                "not ported yet (ROADMAP A7); use engine='lane'")
        if engine != "lane":
            raise ValueError(f"unknown engine {engine!r}")
        if model not in builders.BUILDERS:
            raise ValueError(f"unknown model {model!r}; the port serves "
                             f"{sorted(builders.BUILDERS)}")
        self.device = require_device(device)
        self.path = path
        spec = builders.build(model, Tf=Tf, N=N)
        self.model = model
        self.model_id = protocol.MODEL_IDS[model]
        self.nx = spec.model.nx
        self.nu = spec.model.nu
        self.np_ = spec.model.np_
        self.nh = spec.model.nh
        self.ny = spec.cost.ny
        self._default_yref = np.asarray(spec.cost.yref, np.float32)
        self._yref_e_len = int(np.asarray(spec.cost.yref_e).shape[0])
        self.batch_window = batch_window_ms / 1e3
        self.max_batch = max_batch
        self.rti_split = bool(rti_split)
        self.lane_solver = LaneRTISolver(
            spec, ipm_iters=ipm_iters, ipm_tol=ipm_tol, riccati=riccati,
            centering=centering, mu0=mu0, extra_iters=extra_iters,
            stall_tol=stall_tol, device=self.device, dtype=torch.float32)
        # per-tick device time [ms] (upload, solve, fetch), appended by the
        # solve thread: a client-side latency minus this is the serving
        # stack's own cost
        self.solve_ms = collections.deque(maxlen=4096)
        self._queue: asyncio.Queue = asyncio.Queue()
        self._server: Optional[asyncio.AbstractServer] = None
        self._next_id = 0
        # the one thread that touches device tensors: ticks are serialized
        # anyway (one device), and warmup() runs on it too
        self._executor = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="nmpc-solve")

        L = max_batch
        # the lock covers lane assignment and the host rows: the event-loop
        # thread parks freed lanes' rows under it, so a tick's snapshot of
        # the rows cannot tear
        self._lane_lock = threading.Lock()
        self._lanes_free = list(reversed(range(L)))
        self._lane_of: Dict[int, int] = {}
        # host-side last-request rows (lane-indexed); sentinel obstacle
        # params keep unassigned lanes on benign far-away problems
        self._x0_rows = np.zeros((L, self.nx), np.float32)
        self._p_rows = np.full((L, self.np_), 100.0, np.float32)
        self._lh_rows = np.zeros((L, self.nh), np.float32)
        self._yref_rows = np.broadcast_to(
            self._default_yref, (L, self.ny)).copy()
        self._lane_state = self.lane_solver.init_state(self._x0_rows)
        # rti_split: ONE fleet-wide prepared LaneQP for the next tick,
        # dropped by a lane seed (it belongs to the pre-seed warm start)
        self._lane_qp = None
        # on a CUDA device the host rows go up through one pinned staging
        # buffer into one device buffer, sized for the widest upload (the
        # packed tick rows); `_staged` marks when the last upload has left
        # the staging buffer
        self._staging = self._rows_dev = self._staged = None
        if self.device.type == "cuda":
            n = L * (self.nx + self.np_ + self.nh + self.ny)
            self._staging = torch.empty(n, dtype=torch.float32,
                                        pin_memory=True)
            self._rows_dev = torch.empty(n, dtype=torch.float32,
                                         device=self.device)
            self._staged = torch.cuda.Event()

    # ------------------------------------------------------------------
    # device side: run on the solve thread only
    def _upload(self, rows):
        """Host float32 rows -> the device, one copy (through the pinned
        staging buffer on a CUDA device)."""
        if self._staging is None:
            return torch.from_numpy(rows).to(self.device)
        n = rows.size
        self._staged.synchronize()
        host = self._staging[:n].view(rows.shape)
        host.numpy()[...] = rows
        dev = self._rows_dev[:n].view(rows.shape)
        dev.copy_(host, non_blocking=True)
        self._staged.record()
        return dev

    def _fetch(self, outs):
        """u0, x1 and status as ONE (nu + nx + 1, L) host array (one
        device->host copy, which also waits for the tick)."""
        out = torch.cat([outs.u0, outs.x1,
                         outs.status[None].to(outs.u0.dtype)], dim=0)
        return out.cpu().numpy()

    def _split_params(self, d):
        """(L, np+nh+ny) device rows -> params (np, L), lh (nh, L),
        yref (ny, L)."""
        NP, NH = self.np_, self.nh
        return d[:, :NP].T, d[:, NP:NP + NH].T, d[:, NP + NH:].T

    def _tick(self, packed):
        """Full RTI step of every lane from the packed (L, nx+np+nh+ny)
        host rows; returns the host outputs."""
        d = self._upload(packed)
        pL, lhL, yL = self._split_params(d[:, self.nx:])
        self._lane_state, outs = self.lane_solver.step_fn(
            self._lane_state, d[:, :self.nx].T, pL, lhL, yref=yL,
            yref_e=yL[:self._yref_e_len])
        return self._fetch(outs)

    def _feedback(self, x0_rows):
        """Feedback phase of the prepared QP at fresh (L, nx) x0 rows."""
        self._lane_state, outs = self.lane_solver.feedback_fn(
            self._lane_state, self._lane_qp, self._upload(x0_rows).T)
        return self._fetch(outs)

    def _prepare(self, packed_pl):
        """Preparation phase for the next tick from (L, np+nh+ny) rows."""
        pL, lhL, yL = self._split_params(self._upload(packed_pl))
        self._lane_qp = self.lane_solver.prepare_fn(
            self._lane_state, pL, lhL, yref=yL,
            yref_e=yL[:self._yref_e_len])

    def _seed(self, lane, x0):
        """Cold lane: warm start at x0 on every stage, zero controls.  The
        state is written in place, so the prepared QP (built from the
        pre-seed state) is dropped and this tick runs the full step."""
        x = torch.as_tensor(x0, dtype=torch.float32).to(self.device)
        self._lane_state.xbar[:, :, lane] = x[:, None]
        self._lane_state.ubar[:, :, lane] = 0.0
        self._lane_qp = None

    def _packed(self):
        return np.concatenate([self._x0_rows, self._p_rows, self._lh_rows,
                               self._yref_rows], axis=1)

    def _packed_params(self):
        return np.concatenate([self._p_rows, self._lh_rows,
                               self._yref_rows], axis=1)

    # ------------------------------------------------------------------
    def warmup(self):
        """Run one throwaway tick (and a preparation + feedback under
        rti_split) on the solve thread, then restore the parked lanes.  The
        first kernel use builds the CUDA kernels (nvcc), and on a CUDA
        device the first tick, preparation and feedback capture their
        graphs: all of it lands here, not in a vehicle's first tick."""
        def _warm():
            with self._lane_lock:
                self._seed(0, self._x0_rows[0])
                packed = self._packed()
                packed_pl = self._packed_params()
            self._tick(packed)
            if self.rti_split:
                self._prepare(packed_pl)
                self._feedback(packed[:, :self.nx].copy())
            # back to the parked warm start, in the captured ticks' state
            init = self.lane_solver.init_state(self._x0_rows)
            for dst, src in zip(self._lane_state, init):
                dst.copy_(src)
            self._lane_qp = None

        self._executor.submit(_warm).result()

    # ------------------------------------------------------------------
    @staticmethod
    def parse_tcp(path: str):
        """`host:port` or `tcp://host:port` -> (host, port), else None
        (UDS path).  Any spec containing '/' (except the explicit
        `tcp://` scheme) is a filesystem path, as in the C++ client's
        addr_is_tcp (rt_client/nmpc_rt_client.cpp)."""
        if path.startswith("tcp://"):
            path = path[len("tcp://"):]
        elif "/" in path:
            return None
        host, sep, port = path.rpartition(":")
        if sep and host and port.isdigit():
            return host, int(port)
        return None

    async def start(self):
        tcp = self.parse_tcp(self.path)
        if tcp:
            self._server = await asyncio.start_server(
                self._handle_client, host=tcp[0], port=tcp[1])
        else:
            self._server = await asyncio.start_unix_server(
                self._handle_client, path=self.path)
        self._batcher = asyncio.create_task(self._batch_loop())

    @property
    def bound_port(self) -> Optional[int]:
        """Listening TCP port (resolves port 0 requests), None for UDS."""
        if self._server is None or not self.parse_tcp(self.path):
            return None
        return self._server.sockets[0].getsockname()[1]

    async def stop(self):
        """Stop listening, then wait for the solve thread to finish what it
        runs (a preparation under rti_split) and exit."""
        self._batcher.cancel()
        self._server.close()
        await self._server.wait_closed()
        await asyncio.get_running_loop().run_in_executor(
            None, self._executor.shutdown)

    # ------------------------------------------------------------------
    async def _handle_client(self, reader: asyncio.StreamReader,
                             writer: asyncio.StreamWriter):
        # TCP transport: disable Nagle — the 20 Hz request/reply frames
        # are far smaller than an MSS and coalescing would add ~40 ms
        sock = writer.get_extra_info("socket")
        if sock is not None and sock.family in (socket.AF_INET,
                                                socket.AF_INET6):
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)

        vid = self._next_id
        self._next_id += 1
        try:
            while True:
                magic_buf = await reader.readexactly(4)
                (magic,) = struct.unpack("<I", magic_buf)
                if magic == protocol.REQ_MAGIC:
                    buf = magic_buf + await reader.readexactly(
                        protocol.REQ_SIZE - 4)
                    r1 = protocol.unpack_request(buf)
                    if self.model != "usv_guidance_ca1":
                        # v1 frames ARE the flagship node's boundary
                        writer.write(protocol.pack_response(
                            protocol.Response(
                                seq=r1.seq,
                                status=protocol.STATUS_BAD_REQUEST,
                                u0=0.0, x1=(0.0,) * protocol.NX)))
                        await writer.drain()
                        continue
                    req = _Req(1, r1.seq, r1.x0, r1.p_obs, r1.r_obs, ())
                elif magic == protocol.REQ2_MAGIC:
                    hdr_buf = magic_buf + await reader.readexactly(
                        protocol.REQ2_HDR_SIZE - 4)
                    hdr = protocol.unpack_request2_header(hdr_buf)
                    seq, mid, nx, np_, nh, ny = hdr
                    payload = await reader.readexactly(
                        4 * (nx + np_ + nh + ny))
                    if (mid != self.model_id or nx != self.nx
                            or np_ != self.np_ or nh != self.nh
                            or ny not in (0, self.ny)):
                        # reply with the server's own dims so the client
                        # can print a useful mismatch message
                        writer.write(protocol.pack_response2(
                            protocol.Response2(
                                seq=seq,
                                status=protocol.STATUS_BAD_REQUEST,
                                u0=(0.0,) * self.nu,
                                x1=(0.0,) * self.nx)))
                        await writer.drain()
                        continue
                    r2 = protocol.unpack_request2_payload(hdr, payload)
                    req = _Req(2, seq, r2.x0, r2.params, r2.lh, r2.yref)
                else:
                    raise ValueError(f"bad request magic 0x{magic:08x}")
                fut = asyncio.get_running_loop().create_future()
                await self._queue.put((vid, req, fut))
                writer.write(await fut)       # fut resolves to wire bytes
                await writer.drain()
        except (asyncio.IncompleteReadError, ConnectionResetError):
            pass
        except ValueError as e:
            # malformed frame / bad magic: log before closing so client
            # protocol bugs are diagnosable server-side
            _log.warning("rt client vid=%d protocol error: %s; "
                         "closing connection", vid, e)
        finally:
            self._release_vehicle(vid)
            writer.close()

    # ------------------------------------------------------------------
    async def _batch_loop(self):
        """Collect requests for up to `batch_window`, serve them with one
        lane-engine tick on the solve thread, fan the replies back out."""
        loop = asyncio.get_running_loop()
        while True:
            vid, req, fut = await self._queue.get()
            batch = [(vid, req, fut)]
            deadline = loop.time() + self.batch_window
            while len(batch) < self.max_batch:
                timeout = deadline - loop.time()
                if timeout <= 0:
                    break
                try:
                    batch.append(await asyncio.wait_for(
                        self._queue.get(), timeout))
                except asyncio.TimeoutError:
                    break
            await loop.run_in_executor(self._executor, self._solve_batch,
                                       batch)

    def _solve_batch(self, batch):
        """One fixed-width lane-engine tick serving every queued request.

        All `max_batch` lanes solve every tick (flat cost); requests update
        their lane's rows first, replies read their lane's column of the
        outputs.  Idle lanes re-solve their last request, which only
        deepens their warm start."""
        live = []
        with self._lane_lock:
            for vid, req, fut in batch:
                lane = self._lane_of.get(vid)
                if lane is None:
                    if not self._lanes_free:
                        self._reply(fut, req, STATUS_OVER_CAPACITY,
                                    np.zeros(self.nu, np.float32),
                                    np.zeros(self.nx, np.float32))
                        continue
                    lane = self._lanes_free.pop()
                    self._lane_of[vid] = lane
                    self._seed(lane, np.asarray(req.x0, np.float32))
                self._x0_rows[lane] = req.x0
                self._p_rows[lane] = req.params
                self._lh_rows[lane] = req.lh
                self._yref_rows[lane] = (req.yref if len(req.yref)
                                         else self._default_yref)
                live.append((lane, req, fut))
            if not live:
                return
            use_split = self._lane_qp is not None
            if use_split:
                x0_rows = self._x0_rows.copy()
            else:
                packed = self._packed()

        t_solve = time.perf_counter()
        # feedback only when a QP was prepared after the previous tick's
        # replies (one-tick-old params/yref, fresh x0)
        out = self._feedback(x0_rows) if use_split else self._tick(packed)
        self._lane_qp = None
        self.solve_ms.append((time.perf_counter() - t_solve) * 1e3)
        nu = out.shape[0] - self.nx - 1
        u0, x1 = out[:nu], out[nu:nu + self.nx]
        status = out[-1].astype(np.int32)
        for lane, req, fut in live:
            self._reply(fut, req, status[lane], u0[:, lane], x1[:, lane])

        if self.rti_split:
            # preparation phase for the NEXT tick, after the replies are
            # on their way
            with self._lane_lock:
                packed_pl = self._packed_params()
            self._prepare(packed_pl)

    def _release_vehicle(self, vid):
        with self._lane_lock:
            lane = self._lane_of.pop(vid, None)
            if lane is not None:
                self._lanes_free.append(lane)
                # park the freed lane on the benign sentinel problem
                self._x0_rows[lane] = 0.0
                self._p_rows[lane] = 100.0
                self._lh_rows[lane] = 0.0
                self._yref_rows[lane] = self._default_yref

    @staticmethod
    def _reply(fut, req, status, u0, x1):
        """Resolve `fut` with the WIRE BYTES in the request's own protocol
        version (v1 replies carry the scalar first input, the flagship
        node's command convention; v2 replies the full u0 vector)."""
        u0 = np.asarray(u0, np.float32).reshape(-1)
        x1 = np.asarray(x1, np.float32).reshape(-1)
        if req.version == 1:
            buf = protocol.pack_response(protocol.Response(
                seq=req.seq, status=int(status),
                u0=float(u0[0]), x1=tuple(x1)))
        else:
            buf = protocol.pack_response2(protocol.Response2(
                seq=req.seq, status=int(status),
                u0=tuple(u0), x1=tuple(x1)))
        fut.get_loop().call_soon_threadsafe(_resolve, fut, buf)


def resolve_engine_args(riccati=None, centering=None, ipm_iters=None,
                        extra_iters=None, mu0=None, stall_tol=None,
                        ipm_tol=None):
    """Resolve unset server CLI engine flags to the production schedule
    (`config.production_engine()`); explicit values pass through.  `mu0`
    is a float or "auto" (a string from the command line is parsed)."""
    eng = dataclasses.asdict(production_engine())
    given = dict(riccati=riccati, centering=centering, ipm_iters=ipm_iters,
                 extra_iters=extra_iters, mu0=mu0, stall_tol=stall_tol,
                 ipm_tol=ipm_tol)
    eng.update({k: v for k, v in given.items() if v is not None})
    if eng["mu0"] != "auto":
        eng["mu0"] = float(eng["mu0"])
    return eng


async def _serve(server: RTServer):
    await server.start()
    print(f"rt server listening on {server.path} ({server.device})",
          flush=True)
    await asyncio.Event().wait()


def main(argv=None):
    import argparse
    parser = argparse.ArgumentParser(
        description="NMPC real-time server (PyTorch port, lane engine)",
        epilog="The JAX server's --platform, --linearize and --warm-all "
               "have no counterpart: the device picks the kernels (the "
               "CUDA kernels on a CUDA device, their plain PyTorch "
               "versions on the CPU) and there is one tick to warm.  Its "
               "--riccati lax and pallas are --riccati sweep here; its "
               "--riccati pscan (ROADMAP A8) and --engine vmap (ROADMAP "
               "A7) are not ported yet.")
    parser.add_argument("socket", nargs="?",
                        default=os.path.join(tempfile.gettempdir(),
                                             "nmpc_rt.sock"),
                        help="UDS path, or host:port for a TCP listener "
                             "(cross-machine deployment; same frames)")
    parser.add_argument("--device", default="cuda",
                        help="torch device to serve on (default cuda; a "
                             "host without CUDA is an error, never a "
                             "fallback to the CPU)")
    parser.add_argument("--model", default="usv_guidance_ca1",
                        choices=sorted(builders.BUILDERS),
                        help="OCP model this server solves (one server = "
                             "one model); non-flagship models are reached "
                             "through the v2 frames")
    parser.add_argument("-N", type=int, default=None,
                        help="horizon stages (default: the model builder's "
                             "own value)")
    parser.add_argument("--tf", type=float, default=None,
                        help="horizon length in seconds (default: the "
                             "model builder's own value)")
    # engine flags default to None = the production schedule
    # (config.production_engine()); explicit flags override single fields
    parser.add_argument("--ipm-iters", type=int, default=None)
    parser.add_argument("--extra-iters", type=int, default=None,
                        help="stall-escalation budget: extra IPM "
                             "iterations run only while some lane's gap "
                             "is above --stall-tol")
    parser.add_argument("--ipm-tol", type=float, default=None,
                        help="convergence tolerance (status-0 gate)")
    parser.add_argument("--stall-tol", type=float, default=None,
                        help="escalation gate on the duality gap")
    parser.add_argument("--mu0", default=None,
                        help="initial barrier weight: a float or 'auto'")
    parser.add_argument("--centering", default=None,
                        choices=("fixed", "adaptive", "mehrotra"),
                        help="IPM centering schedule (mehrotra: two "
                             "Riccati sweeps per iteration)")
    parser.add_argument("--riccati", default=None,
                        choices=("sweep", "fused"),
                        help="IPM backend: sweep (one Riccati kernel per "
                             "iteration) or fused (the whole IPM in one "
                             "kernel; needs --centering fixed, a float "
                             "--mu0 and --extra-iters 0)")
    parser.add_argument("--max-batch", type=int, default=128,
                        help="lane width: vehicles served at once")
    parser.add_argument("--rti-split", action="store_true",
                        help="acados-style RTI preparation/feedback split: "
                             "linearize for the next tick right after "
                             "replying, so a request pays only the IPM")
    args = parser.parse_args(argv)
    try:
        device = require_device(args.device)
    except ValueError as exc:
        parser.error(str(exc))
    eng = resolve_engine_args(args.riccati, args.centering, args.ipm_iters,
                              args.extra_iters, args.mu0, args.stall_tol,
                              args.ipm_tol)
    # unset -N/--tf resolve to the served model's own (Tf, N)
    sig = inspect.signature(builders.BUILDERS[args.model]).parameters
    N = args.N if args.N is not None else sig["N"].default
    Tf = args.tf if args.tf is not None else sig["Tf"].default
    server = RTServer(args.socket, N=N, Tf=Tf, max_batch=args.max_batch,
                      rti_split=args.rti_split, model=args.model,
                      device=device, **eng)
    server.warmup()
    asyncio.run(_serve(server))


if __name__ == "__main__":
    main()
