"""TCP PIR client on the port (reference: chalametpir_client/examples/client.rs).

Run: python -m chalametpir_tpu_torch.net.client --key banana [--host ... --port ...]
     [--device cuda] [--prg-mode stream] [--pool N]

The framing and the per-key query helper are the JAX package's
(chalametpir_tpu/net/), imported; the client is the port's, with its s . A
engine on `device`.
"""

from __future__ import annotations

import argparse
import asyncio
import sys

from chalametpir_tpu.net.client import _query_or_none
from chalametpir_tpu.net.framing import read_frame, write_frame
from chalametpir_tpu.params import SEED_BYTE_LEN

from ..models.client import Client


async def fetch(
    host: str, port: int, keys: list[bytes], prg_mode: str = "stream",
    device="cuda", pool: int = 0,
) -> dict[bytes, bytes | None]:
    """Fetch `keys` from a PIR server; a key that fails maps to None.
    Client.setup runs in a worker thread (in stream mode it expands A with
    the host XOF, seconds at 2^20 entries), so the event loop stays free.
    pool > 0 runs FrodoPIR's offline query preprocessing for that many
    queries right after setup (one batched s . A)."""
    reader, writer = await asyncio.open_connection(host, port)
    print(f"Connected to PIR server @ {host}:{port}", file=sys.stderr)
    results: dict[bytes, bytes | None] = {}
    try:
        seed = await reader.readexactly(SEED_BYTE_LEN)
        # bound what a hostile or faulty server can make us buffer: the hint
        # is 1774 x cols x 4 B, the filter params 68 B
        hint = await read_frame(reader, max_len=1 << 30)
        filter_params = await read_frame(reader, max_len=4096)
        print(f"Received setup data ({len(hint)} B hint)", file=sys.stderr)
        client = await asyncio.to_thread(
            Client.setup, seed, hint, filter_params, prg_mode=prg_mode, device=device,
            prepared_queries=min(pool, len(keys)) if pool else 0,
        )
        # a valid response is exactly (1, cols) u32 + the 8-byte header
        max_response_frame = client._hint_mat_m.shape[1] * 4 + 64
        for key in keys:
            query = _query_or_none(client, key)
            if query is None:
                results.setdefault(key, None)
                continue
            try:
                write_frame(writer, query)
                await writer.drain()
                response = await read_frame(reader, max_response_frame)
            except (asyncio.IncompleteReadError, ConnectionError, ValueError) as exc:
                # the connection is gone: the keys left cannot succeed, the
                # values already retrieved are kept
                print(f"Connection lost fetching {key!r}: {exc!r}", file=sys.stderr)
                for k in keys:
                    results.setdefault(k, None)
                break
            try:
                results[key] = client.process_response(key, response)
            except Exception as exc:  # noqa: BLE001 - report per-key failure
                print(f"Failed to retrieve {key!r}: {exc}", file=sys.stderr)
                results[key] = None
    finally:
        writer.close()
        try:
            await writer.wait_closed()
        except ConnectionError:
            pass
    return results


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--key", action="append", default=[], help="key to fetch (repeatable)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where A's planes live and s . A runs (cpu: the plain versions)")
    ap.add_argument("--prg-mode", default="stream", choices=("stream", "ctr"),
                    help="must match the server's --prg-mode")
    ap.add_argument("--pool", type=int, default=0, metavar="N",
                    help="precompute N query pairs after setup (FrodoPIR offline phase)")
    args = ap.parse_args(argv)
    keys = [k.encode() for k in args.key] or [b"banana"]

    results = asyncio.run(fetch(args.host, args.port, keys, prg_mode=args.prg_mode,
                                device=args.device, pool=args.pool))
    for key, value in results.items():
        if value is None:
            print(f"{key.decode(errors='replace')}: <failed>")
        else:
            print(f"{key.decode(errors='replace')}: {value.decode(errors='replace')}")


if __name__ == "__main__":
    main()
