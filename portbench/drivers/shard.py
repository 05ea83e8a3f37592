"""One client shard of the closed-loop scoring load: a spawned process
with its own event loop and ``connections`` keep-alive HTTP/1.1
connections, each sending its next request as soon as the last one is
answered.

A shard draws its pool of request bodies from ``(seed, shard)``: ``pool``
bodies of ``rows`` rows of ``features`` float32 features uniform on
``x_range``, in the binary row framing (a little-endian ``u32 n_rows,
u32 n_features`` header, then the rows as little-endian f32). Connection
``c`` sends the pool's bodies in turn from body ``c``. Every response
body is read whole and hashed; the first of each distinct answer to a
body is kept, and each request names its answer, so that the reference
judges every answer of the window.

Protocol with the driver over a pipe: the shard draws its pool while
the service boots, waits for ``"connect"``, warms each connection and
sends ``"ready"``; it receives ``(t_start, t_end)`` on the
machine-wide monotonic clock, sends from ``t_start`` until ``t_end``,
waits for the answers in flight, and sends its results.
"""
from __future__ import annotations

import asyncio
import hashlib
import struct
import time

import numpy as np

#: the binary row framing's content type and header
CONTENT_TYPE = "application/x-bodywork-rows"
HEADER = struct.Struct("<II")
#: seconds an answer in flight at the window's end may still take
DRAIN_S = 60.0


def pool_rows(seed: int, shard: int, pool: int, rows: int, features: int,
              x_range) -> list:
    """The shard's request rows, ``pool`` float32 ``(rows, features)``
    arrays drawn from ``(seed, shard)``."""
    rng = np.random.default_rng([seed, shard])
    lo, hi = x_range
    return [rng.uniform(lo, hi, (rows, features)).astype(np.float32) for _ in range(pool)]


def encode(X: np.ndarray) -> bytes:
    return HEADER.pack(*X.shape) + np.ascontiguousarray(X, dtype="<f4").tobytes()


class Connection:
    def __init__(self, host: str, port: int, path: str):
        self.host, self.port, self.path = host, port, path
        self.reader = self.writer = None

    async def open(self):
        self.reader, self.writer = await asyncio.open_connection(self.host, self.port)

    def close(self):
        if self.writer is not None:
            self.writer.close()
            self.writer = None

    async def post(self, body: bytes) -> tuple[int, bytes]:
        """One request: ``(status, response body)``; reopens the
        connection where the server closed it."""
        if self.writer is None:
            await self.open()
        head = (f"POST {self.path} HTTP/1.1\r\nHost: {self.host}\r\n"
                f"Content-Type: {CONTENT_TYPE}\r\nContent-Length: {len(body)}\r\n\r\n")
        self.writer.write(head.encode("latin-1") + body)
        blob = await self.reader.readuntil(b"\r\n\r\n")
        lines = blob.decode("latin-1").split("\r\n")
        status = int(lines[0].split(" ", 2)[1])
        headers = {}
        for line in lines[1:]:
            name, _sep, value = line.partition(":")
            headers[name.strip().lower()] = value.strip()
        payload = await self.reader.readexactly(int(headers.get("content-length", "0")))
        if headers.get("connection", "").lower() == "close":
            self.close()
        return status, payload


async def _drive(conn_pipe, p: dict):
    bodies = [encode(X) for X in pool_rows(p["seed"], p["shard"], p["pool"], p["rows"],
                                           p["features"], p["x_range"])]
    conns = [Connection(p["host"], p["port"], p["path"]) for _ in range(p["connections"])]
    if conn_pipe.recv() != "connect":
        raise RuntimeError("the driver did not ask the shard to connect")
    for c in conns:
        await c.open()
    for i in range(p["warmup"]):
        results = await asyncio.gather(*(c.post(bodies[(j + i) % len(bodies)])
                                         for j, c in enumerate(conns)))
        bad = [s for s, _b in results if s != 200]
        if bad:
            raise RuntimeError(f"warm-up request answered {bad[0]}")
    conn_pipe.send("ready")
    t_start, t_end = conn_pipe.recv()
    sends, dones, statuses, answer_ids = [], [], [], []
    #: (body, digest) -> (answer id, the first response body)
    answers: dict = {}

    async def loop(c: Connection, first: int):
        i = first
        delay = t_start - time.monotonic()
        if delay > 0:
            await asyncio.sleep(delay)
        while time.monotonic() < t_end:
            k = i % len(bodies)
            i += 1
            t0 = time.monotonic()
            try:
                status, payload = await c.post(bodies[k])
            except (OSError, asyncio.IncompleteReadError, ValueError):
                c.close()
                status, payload = -1, b""
            t1 = time.monotonic()
            answer = -1
            if status == 200:
                key = (k, hashlib.blake2b(payload, digest_size=16).digest())
                if key not in answers:
                    answers[key] = (len(answers), payload)
                answer = answers[key][0]
            sends.append(t0)
            dones.append(t1)
            statuses.append(status)
            answer_ids.append(answer)

    cpu0 = time.process_time()
    await asyncio.wait_for(asyncio.gather(*(loop(c, j) for j, c in enumerate(conns))),
                           timeout=t_end - time.monotonic() + DRAIN_S)
    cpu_s = time.process_time() - cpu0
    for c in conns:
        c.close()
    return {"send": np.array(sends), "done": np.array(dones),
            "status": np.array(statuses, dtype=np.int32),
            "answer": np.array(answer_ids, dtype=np.int64),
            "answers": [(k, payload) for (k, _d), (_i, payload) in
                        sorted(answers.items(), key=lambda kv: kv[1][0])],
            "cpu_s": cpu_s}


def shard_main(conn_pipe, params: dict) -> None:
    """The spawned shard's entry point."""
    try:
        result = asyncio.run(_drive(conn_pipe, params))
    except Exception as exc:  # reported to the driver, which fails the run
        conn_pipe.send({"error": f"{type(exc).__name__}: {exc}"})
    else:
        conn_pipe.send(result)
    finally:
        conn_pipe.close()
