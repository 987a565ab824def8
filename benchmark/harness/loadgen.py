"""The open-loop load generator, a process of its own.

    python3 loadgen.py <plan.json> <results.json>

The plan holds the server's port and the requests, each with the second
(from the start of the window) it is due and its JSON body. Every request is
sent at its due time whatever the replies before it, each on a kept-alive
HTTP/1.1 connection that is idle, or on a new one: the generator never
waits for a reply before sending. It prints ``ready`` once its connections
are open, waits for ``go`` on its standard input, and writes for each
request when it was due, when it was sent and when its reply was complete
(``time.monotonic()`` seconds from the start), the reply's status and body.
A request whose reply has not come ``grace_s`` after the last due time is
written with no reply. Standard library only.
"""
from __future__ import annotations

import asyncio
import json
import sys
import time


class Pool:
    def __init__(self, port: int):
        self.port = port
        self.idle = []
        self.opened = 0

    async def get(self):
        if self.idle:
            return self.idle.pop()
        self.opened += 1
        return await asyncio.open_connection("127.0.0.1", self.port)

    def put(self, conn):
        self.idle.append(conn)


async def exchange(conn, body: bytes):
    reader, writer = conn
    writer.write(b"POST /score HTTP/1.1\r\nHost: localhost\r\n"
                 b"Content-Type: application/json\r\nContent-Length: %d\r\n\r\n"
                 % len(body) + body)
    await writer.drain()
    status = int((await reader.readline()).split()[1])
    length = 0
    while True:
        line = await reader.readline()
        if line in (b"\r\n", b"\n", b""):
            break
        k, _, v = line.decode("latin1").partition(":")
        if k.strip().lower() == "content-length":
            length = int(v.strip())
    return status, await reader.readexactly(length)


async def main(plan_path: str, out_path: str) -> None:
    with open(plan_path) as f:
        plan = json.load(f)
    pool = Pool(plan["port"])
    conns = [await pool.get() for _ in range(plan["connections"])]
    for c in conns:
        pool.put(c)
    print("ready", flush=True)
    await asyncio.get_running_loop().run_in_executor(None, sys.stdin.readline)
    t0 = time.monotonic()
    records = [None] * len(plan["requests"])

    async def one(i, req):
        delay = req["due"] - (time.monotonic() - t0)
        if delay > 0:
            await asyncio.sleep(delay)
        sent = time.monotonic() - t0
        rec = {"due": req["due"], "sent": sent, "done": None, "status": None, "body": None}
        records[i] = rec
        conn = await pool.get()
        try:
            status, body = await exchange(conn, json.dumps(req["body"]).encode())
            rec.update(done=time.monotonic() - t0, status=status, body=json.loads(body))
            pool.put(conn)
        except (OSError, ValueError, asyncio.IncompleteReadError) as e:
            rec["error"] = repr(e)

    tasks = [asyncio.ensure_future(one(i, r)) for i, r in enumerate(plan["requests"])]
    last = max((r["due"] for r in plan["requests"]), default=0.0)
    await asyncio.wait(tasks, timeout=last + plan["grace_s"] + 1.0)
    for t in tasks:
        t.cancel()
    with open(out_path, "w") as f:
        json.dump({"records": records, "connections": pool.opened}, f)


if __name__ == "__main__":
    asyncio.run(main(sys.argv[1], sys.argv[2]))
