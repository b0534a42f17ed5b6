"""Wire protocol of the real-time client boundary (copy of
`mpc_collisionavoidance_tpu/rt/protocol.py`, `struct` only: the JAX
package's `__init__` imports jax, so the port cannot import it).

The frames are fixed-size and little-endian, and byte-identical to the JAX
package's; the C++ client (`rt_client/nmpc_rt_client.h`) mirrors them and
static-asserts the sizes.

Request frame  (REQ_MAGIC):  magic u32 | seq u32 | x0 f32[8] |
                             p_obs f32[16] | r_obs f32[8]
Response frame (RESP_MAGIC): magic u32 | seq u32 | status u32 |
                             u0 f32 | x1 f32[8]

A `seq` echo lets the client detect stale replies after timeouts.  One
connection = one vehicle = one warm-start lane on the server.
"""

import struct
from typing import NamedTuple

REQ_MAGIC = 0x4E4D5043   # "NMPC"
RESP_MAGIC = 0x4E4D5052  # "NMPR"

NX = 8
NP = 16
NH = 8

REQ_FMT = "<II8f16f8f"
RESP_FMT = "<III f 8f".replace(" ", "")
REQ_SIZE = struct.calcsize(REQ_FMT)     # 136
RESP_SIZE = struct.calcsize(RESP_FMT)   # 48


class Request(NamedTuple):
    seq: int
    x0: tuple
    p_obs: tuple
    r_obs: tuple


class Response(NamedTuple):
    seq: int
    status: int
    u0: float
    x1: tuple


def pack_request(req: Request) -> bytes:
    return struct.pack(REQ_FMT, REQ_MAGIC, req.seq,
                       *req.x0, *req.p_obs, *req.r_obs)


def unpack_request(buf: bytes) -> Request:
    vals = struct.unpack(REQ_FMT, buf)
    if vals[0] != REQ_MAGIC:
        raise ValueError(f"bad request magic 0x{vals[0]:08x}")
    return Request(seq=vals[1], x0=vals[2:2 + NX],
                   p_obs=vals[2 + NX:2 + NX + NP],
                   r_obs=vals[2 + NX + NP:])


def pack_response(resp: Response) -> bytes:
    return struct.pack(RESP_FMT, RESP_MAGIC, resp.seq, resp.status,
                       resp.u0, *resp.x1)


def unpack_response(buf: bytes) -> Response:
    vals = struct.unpack(RESP_FMT, buf)
    if vals[0] != RESP_MAGIC:
        raise ValueError(f"bad response magic 0x{vals[0]:08x}")
    return Response(seq=vals[1], status=vals[2], u0=vals[3], x1=vals[4:])


# ---------------------------------------------------------------------------
# Protocol v2: variant-generic frames.
#
# The v1 frames above are the flagship node's boundary (fixed nx=8 state,
# 8-obstacle table, scalar command).  The reference, however, ships a NODE
# PER VARIANT (SURVEY.md section 2.1 N6-N16: thrust-level, path-following,
# five guidance laws, ...), each with its own state/command widths and its
# own per-tick references.  v2 serves ANY model in the zoo: the request
# carries the dims it believes, the server validates them against the
# model it was started with (one server = one generated-solver role, like
# one acados .so per reference node), and the payload optionally includes
# a stage-constant yref (the reference nodes push yref every tick, e.g.
# src/nmpc_low_level.cpp:206-248).
#
# Request v2:  magic u32 | seq u32 | model_id u16 | nx u16 | np u16 |
#              nh u16 | ny u16 | reserved u16 |
#              f32[nx + np + nh + ny]          (ny = 0 -> builder yref)
# Response v2: magic u32 | seq u32 | status u32 | nu u16 | nx u16 |
#              f32[nu + nx]
#
# Both sides read the fixed header first, then the payload; dims mismatch
# is answered with STATUS_BAD_REQUEST and the server's own dims.

REQ2_MAGIC = 0x4E4D5032   # "NMP2"
RESP2_MAGIC = 0x4E4D5233  # "NMR3"

REQ2_HDR_FMT = "<IIHHHHHH"
REQ2_HDR_SIZE = struct.calcsize(REQ2_HDR_FMT)    # 20
RESP2_HDR_FMT = "<IIIHH"
RESP2_HDR_SIZE = struct.calcsize(RESP2_HDR_FMT)  # 16

#: stable wire ids for every model in the zoo (mirrored in the C++ header)
MODEL_IDS = {
    "usv_guidance_ca1": 1,
    "usv_guidance_ca": 2,
    "usv_guidance": 3,
    "usv_guidance2": 4,
    "usv_guidance3": 5,
    "usv_guidance4": 6,
    "usv_guidance5": 7,
    "usv_low_level": 8,
    "usv_pf": 9,
    "usv_pf_ca": 10,
    "usv_acados": 11,
    "usv_position_control": 12,
    "race_cars": 13,
    "race_cars_dev": 14,
}

STATUS_BAD_REQUEST = 4   # dims/model mismatch (v1 statuses: 0/1/2, 3 = over capacity)


class Request2(NamedTuple):
    seq: int
    model_id: int
    x0: tuple
    params: tuple
    lh: tuple
    yref: tuple       # () = use the builder's static references


class Response2(NamedTuple):
    seq: int
    status: int
    u0: tuple
    x1: tuple


def pack_request2(req: Request2) -> bytes:
    payload = tuple(req.x0) + tuple(req.params) + tuple(req.lh) \
        + tuple(req.yref)
    hdr = struct.pack(REQ2_HDR_FMT, REQ2_MAGIC, req.seq, req.model_id,
                      len(req.x0), len(req.params), len(req.lh),
                      len(req.yref), 0)
    return hdr + struct.pack(f"<{len(payload)}f", *payload)


def unpack_request2_header(buf: bytes):
    """-> (seq, model_id, nx, np, nh, ny); raises on bad magic."""
    magic, seq, mid, nx, np_, nh, ny, _ = struct.unpack(REQ2_HDR_FMT, buf)
    if magic != REQ2_MAGIC:
        raise ValueError(f"bad v2 request magic 0x{magic:08x}")
    return seq, mid, nx, np_, nh, ny


def unpack_request2_payload(hdr, payload: bytes) -> Request2:
    seq, mid, nx, np_, nh, ny = hdr
    vals = struct.unpack(f"<{nx + np_ + nh + ny}f", payload)
    return Request2(seq=seq, model_id=mid, x0=vals[:nx],
                    params=vals[nx:nx + np_],
                    lh=vals[nx + np_:nx + np_ + nh],
                    yref=vals[nx + np_ + nh:])


def pack_response2(resp: Response2) -> bytes:
    hdr = struct.pack(RESP2_HDR_FMT, RESP2_MAGIC, resp.seq, resp.status,
                      len(resp.u0), len(resp.x1))
    vals = tuple(resp.u0) + tuple(resp.x1)
    return hdr + struct.pack(f"<{len(vals)}f", *vals)


def unpack_response2(hdr_buf: bytes, payload: bytes) -> Response2:
    magic, seq, status, nu, nx = struct.unpack(RESP2_HDR_FMT, hdr_buf)
    if magic != RESP2_MAGIC:
        raise ValueError(f"bad v2 response magic 0x{magic:08x}")
    vals = struct.unpack(f"<{nu + nx}f", payload)
    return Response2(seq=seq, status=status, u0=vals[:nu], x1=vals[nu:])
