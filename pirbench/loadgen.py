"""Closed-loop TCP clients of a PIR server, in a process of their own.

    python3 pirbench/loadgen.py   (the harness starts it; it talks over pipes)

Reads from standard input one JSON line {"port", "m", "seed", "conns",
"kept"} and, for each connection in "conns", one length-framed real query
made by the program's client. Opens the connections to 127.0.0.1:port,
reads each one's set-up (seed, hint, filter parameters), sends each its
real query and keeps the answer, then writes "ready". On "go <seconds>"
every connection sends queries in a closed loop until that many seconds
have passed: uniform u32 vectors of m words drawn from the seed, with
word 0 the connection's send counter and word 1 the connection, so no two
are equal. Then one JSON line reports the counts, the first send and last
answer (time.monotonic, one clock for every process of the machine), the
real answers and a sample of the others, chosen from the seed. Imports
neither torch nor the program: these clients never touch the card.
"""

from __future__ import annotations

import asyncio
import base64
import json
import struct
import sys
import time

import numpy as np

FRAME = struct.Struct("<I")
STREAM = 4  # the seed's stream of the connections' queries
KEPT_STREAM = 5  # the seed's stream of the sampled answers


def base_query(seed: int, conn: int, m: int) -> np.ndarray:
    return np.random.default_rng([seed, STREAM, conn]).integers(0, 1 << 32, size=m, dtype=np.uint32)


def query_of(base: np.ndarray, conn: int, counter: int) -> np.ndarray:
    """The vector a connection sends as its counter-th uniform query."""
    q = base.copy()
    q[0], q[1] = counter & 0xFFFFFFFF, conn
    return q


async def read_frame(reader: asyncio.StreamReader) -> bytes:
    (length,) = FRAME.unpack(await reader.readexactly(FRAME.size))
    return await reader.readexactly(length)


def read_frame_sync(stream) -> bytes:
    (length,) = FRAME.unpack(stream.read(FRAME.size))
    return stream.read(length)


async def closed_loop(conn: int, reader, writer, base, seconds_left, kept: int, seed: int) -> dict:
    header = struct.pack("<II", 1, base.size)
    q = base.copy()
    q[1] = conn
    rng = np.random.default_rng([seed, KEPT_STREAM, conn])
    sample: list = []
    sent = done = 0
    first = last = None
    deadline = time.monotonic() + seconds_left
    while time.monotonic() < deadline:
        q[0] = sent & 0xFFFFFFFF
        payload = header + q.tobytes()
        t0 = time.monotonic()
        first = first if first is not None else t0
        writer.write(FRAME.pack(len(payload)))
        writer.write(payload)
        sent += 1
        await writer.drain()
        answer = await read_frame(reader)
        last = time.monotonic()
        # a reservoir of the answers, drawn from the seed
        if done < kept:
            sample.append((done, answer))
        else:
            j = int(rng.integers(0, done + 1))
            if j < kept:
                sample[j] = (done, answer)
        done += 1
    return {"conn": conn, "sent": sent, "done": done, "first": first, "last": last,
            "kept": [[conn, c, base64.b64encode(a).decode()] for c, a in sample]}


async def main() -> None:
    stdin = sys.stdin.buffer
    job = json.loads(stdin.readline())
    reals = [read_frame_sync(stdin) for _ in job["conns"]]
    opened = []
    for _ in job["conns"]:
        reader, writer = await asyncio.open_connection("127.0.0.1", job["port"])
        await reader.readexactly(32)
        await read_frame(reader)  # the hint
        await read_frame(reader)  # the filter parameters
        opened.append((reader, writer))
    answers = []
    for (reader, writer), real in zip(opened, reals):
        writer.write(FRAME.pack(len(real)))
        writer.write(real)
        await writer.drain()
        answers.append(base64.b64encode(await read_frame(reader)).decode())
    bases = [base_query(job["seed"], conn, job["m"]) for conn in job["conns"]]
    sys.stdout.write("ready\n")
    sys.stdout.flush()
    go = await asyncio.get_running_loop().run_in_executor(None, stdin.readline)
    seconds = float(go.split()[1])
    rows = await asyncio.gather(*[closed_loop(conn, r, w, base, seconds, job["kept"], job["seed"])
                                  for conn, (r, w), base in zip(job["conns"], opened, bases)])
    for _, writer in opened:
        writer.close()
    sys.stdout.write(json.dumps({"conns": rows, "real": answers}) + "\n")
    sys.stdout.flush()


if __name__ == "__main__":
    asyncio.run(main())
