"""Process-boundary query-stream endpoint on the port (counterpart of
`genomicsdb_tpu.query.stream_server`; the JNI InputStream's socket-era
replacement).

The reference's main external consumer is GATK4/htsjdk reading a
java.io.InputStream of BCF2 bytes through JNI
(src/main/jni/src/genomicsdb_GenomicsDBQueryStream.cc:29-106,
reader/GenomicsDBQueryStream.java:38).  This module provides the same
byte contract over a socket so ANY external process (a JVM
FeatureReader, a pipe consumer, another language) can attach without
in-process bindings:

  client -> server : one line of JSON — the export/query configuration
                     (the reference's query JSON / loader JSON keys)
  server -> client : the BCF2 stream: "BCF\\2\\2" + header block, then
                     encoded records, then EOF (socket close)

A query with "persistent": true keeps the connection open and frames
its response as [u32 len][bytes]... ending in a zero frame; errors come
in-band as "GDBERR <message>" (framed in persistent mode).

The server owns one torch device, given at construction, on which every
query's block engine combines.  Stores are opened per the query JSON and
cached across connections, so their store-wide layouts, device slabs
and serving indexes are paid once per store.  `serve_forever` handles
each connection in a thread; the resumable generator behind bcf_stream
yields bytes incrementally, so a slow reader applies back-pressure
through the socket instead of buffering the result.

    python -m genomicsdb_tpu_torch.query.stream_server [--host H]
        [--port P] [--base-dir DIR] [--device cuda|cpu]
"""

from __future__ import annotations

import json
import socket
import socketserver
import struct
import threading
from typing import Dict, Optional, Tuple

from ..core.config import QueryParams
from ..core.vid import VidMapper
from ..device import resolve_device
from ..store.import_pipeline import import_callsets
from . import driver
from .stream import CombinedRecordStream


class _StoreCache:
    """(vid_file, callset_file, workspace, array) -> (vid, store)."""

    def __init__(self):
        self._cache: Dict[Tuple, Tuple] = {}
        self._lock = threading.Lock()

    def get(self, qp: QueryParams):
        key = (qp.resolve(qp.vid_mapping_file),
               qp.resolve(qp.callset_mapping_file),
               qp.workspace, qp.array_name)
        with self._lock:
            got = self._cache.get(key)
            if got is None:
                vid = VidMapper.from_files(key[0], key[1])
                if qp.workspace and qp.array_name:
                    from ..store import workspace as ws
                    store = ws.open_array(qp.resolve(qp.workspace),
                                          qp.array_name)
                else:
                    store = import_callsets(vid, base_dir=qp.base_dir)
                got = (vid, store)
                self._cache[key] = got
            return got


class QueryStreamServer:
    """TCP server streaming BCF2 bytes per query (newline-delimited JSON
    requests; one-shot or persistent connections), combining on
    `device`."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 base_dir: str = "", device="cuda",
                 pack: Optional[bool] = None):
        self.base_dir = base_dir
        self.device = resolve_device(device)
        self.pack = pack
        cache = self._cache = _StoreCache()
        outer = self

        class Handler(socketserver.StreamRequestHandler):
            def _run_query(self, doc):
                qp = QueryParams.from_dict(doc)
                if not qp.base_dir:
                    qp.base_dir = outer.base_dir
                vid, store = cache.get(qp)
                qc = driver.make_query_config(qp, vid)
                template = qp.resolve(qp.vcf_header_filename) \
                    if qp.vcf_header_filename else None
                refg = qp.resolve(qp.reference_genome) \
                    if qp.reference_genome else None
                stream = CombinedRecordStream(
                    store, qc, qp, vid, outer.device,
                    template_path=template, reference_path=refg,
                    engine=doc.get("engine", "block"), pack=outer.pack)
                return stream.bcf_stream()

            def handle(self):
                # small-interval queries are latency-sensitive (the
                # GATK split pattern): disable Nagle and coalesce
                # writes to >=64 KiB sends
                self.connection.setsockopt(socket.IPPROTO_TCP,
                                           socket.TCP_NODELAY, 1)
                while True:
                    line = self.rfile.readline()
                    if not line or not line.strip():
                        return
                    persistent = False
                    try:
                        doc = json.loads(line)
                        # persistent mode: the connection serves MANY
                        # queries (the GATK/Spark split pattern fires
                        # thousands against one store) — each response
                        # is framed [u32 len][bytes]..., end = zero
                        # frame, so the reader never needs EOF
                        persistent = bool(doc.get("persistent"))
                        buf = bytearray()
                        for chunk in self._run_query(doc):
                            if persistent:
                                buf += struct.pack("<I", len(chunk))
                            buf += chunk
                            if len(buf) >= (64 << 10):
                                self.wfile.write(buf)
                                buf = bytearray()
                        if persistent:
                            buf += struct.pack("<I", 0)
                        if buf:
                            self.wfile.write(buf)
                    except BrokenPipeError:
                        return
                    except Exception as e:   # report errors in-band
                        try:
                            msg = f"GDBERR {e}\n".encode()
                            if persistent:
                                self.wfile.write(
                                    struct.pack("<I", len(msg)) + msg
                                    + struct.pack("<I", 0))
                            else:
                                self.wfile.write(msg)
                        except OSError:
                            return
                    if not persistent:
                        return   # one-shot: EOF terminates the stream

        class Server(socketserver.ThreadingTCPServer):
            daemon_threads = True
            allow_reuse_address = True

        self._server = Server((host, port), Handler)
        self.address = self._server.server_address

    def serve_forever(self):
        self._server.serve_forever()

    def start_background(self) -> threading.Thread:
        t = threading.Thread(target=self._server.serve_forever,
                             daemon=True)
        t.start()
        return t

    def shutdown(self):
        self._server.shutdown()
        self._server.server_close()


class QueryStreamClient:
    """Persistent-connection client: one TCP connection serves many
    interval queries (each response framed [u32 len][bytes]... + zero
    frame), killing the per-query connect + teardown of the one-shot
    contract.  Use as a context manager."""

    def __init__(self, host: str, port: int,
                 timeout: Optional[float] = 60.0):
        self._sock = socket.create_connection((host, port),
                                              timeout=timeout)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._rfile = self._sock.makefile("rb")

    def query(self, query: dict) -> bytes:
        doc = dict(query)
        doc["persistent"] = True
        self._sock.sendall(json.dumps(doc).encode() + b"\n")
        chunks = []
        while True:
            hdr = self._rfile.read(4)
            if len(hdr) < 4:
                raise ConnectionError("stream server closed connection")
            (n,) = struct.unpack("<I", hdr)
            if n == 0:
                break
            got = self._rfile.read(n)
            if len(got) < n:
                raise ConnectionError("short read from stream server")
            chunks.append(got)
        data = b"".join(chunks)
        if data.startswith(b"GDBERR"):
            raise RuntimeError(data.decode(errors="replace"))
        return data

    def close(self):
        try:
            self._rfile.close()
        finally:
            self._sock.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_query_stream(host: str, port: int, query: dict,
                      timeout: Optional[float] = 60.0) -> bytes:
    """Client: send one query, read the full BCF2 stream (the htsjdk
    InputStream contract: read until EOF)."""
    with socket.create_connection((host, port), timeout=timeout) as s:
        s.sendall(json.dumps(query).encode() + b"\n")
        chunks = []
        while True:
            got = s.recv(1 << 16)
            if not got:
                break
            chunks.append(got)
    data = b"".join(chunks)
    if data.startswith(b"GDBERR"):
        raise RuntimeError(data.decode(errors="replace"))
    return data


def main(argv=None):
    import argparse
    p = argparse.ArgumentParser(prog="gdb_query_stream_server")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=24242)
    p.add_argument("--base-dir", default="")
    p.add_argument("--device", default="cuda",
                   help="torch device every query combines on ('cuda' "
                        "default, or 'cpu'); 'cuda' without a visible "
                        "card exits before the server listens")
    args = p.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except (RuntimeError, ValueError) as e:
        raise SystemExit(f"gdb_query_stream_server: {e}")
    srv = QueryStreamServer(args.host, args.port, args.base_dir, device)
    print(f"query-stream server on {srv.address[0]}:{srv.address[1]} "
          f"(device {device})", flush=True)
    srv.serve_forever()


if __name__ == "__main__":
    main()
