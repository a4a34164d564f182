"""Minimal HTTP parse server over a bundle (stdlib only).

The port's counterpart of cliora_tpu/scripts/serve.py.  Serves a bundle
of scripts/export_model.py with no model code on the request path -- the
program is the model::

    python -m cliora_tpu_torch.scripts.serve --bundle log/<exp>/bundle \\
        [--host 127.0.0.1] [--port 8000] [--device cpu]

API (JSON over POST /parse):

    {"sentences": [[7, 3, 9], ...]}        token ids, or
    {"texts": ["the dog runs", ...]}       whitespace words (needs the
                                           bundle's vocab.json)
    -> {"trees": [...]} nested [start, end] span lists (leaves are word
       positions or words, matching the request form)

GET /healthz returns the bundle's manifest.  Concurrent /parse requests
are micro-batched: a dispatcher thread coalesces everything queued
within ``--max_wait_ms`` into one program call (serving.MicroBatcher).
At start the server captures a CUDA graph per (bucket, row count) shape
(``ExportedParser.warmup``); a restart captures them again, as a CUDA
graph cannot be kept on disk.
"""

from __future__ import annotations

import argparse
import json
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from cliora_tpu_torch.analysis.trees import replace_leaves
from cliora_tpu_torch.serving import ExportedParser, MicroBatcher


def _tupleize(tree):
    """Nested tuples -> JSON-serializable nested lists."""
    if isinstance(tree, tuple):
        return [_tupleize(t) for t in tree]
    return tree


class _Server(ThreadingHTTPServer):
    # the listen backlog: socketserver's default of 5 drops the connection
    # attempts of a burst of clients, and each dropped SYN costs its client
    # a 1 s retransmit
    request_queue_size = 128


def make_server(bundle: str, host: str = "127.0.0.1", port: int = 8000,
                max_batch: int = 64, max_wait_ms: float = 5.0,
                warm: bool = True, warm_async: bool = False, device=None):
    """A ``ThreadingHTTPServer`` over ``bundle`` on ``device`` (default
    the card; raises without one).  ``srv.parser`` is the
    :class:`ExportedParser`, ``srv.batcher`` its :class:`MicroBatcher`
    (stop it with ``close()``)."""
    parser = ExportedParser(bundle, device=device)
    if parser.meta["use_obj"]:
        raise SystemExit(
            "serve.py handles text bundles; CLIORA bundles need region "
            "features per request -- use "
            "cliora_tpu_torch.serving.ExportedParser directly")
    if warm and warm_async:
        # serve at once; shapes warm up in the background (a request of
        # a shape not yet captured runs the program eagerly)
        parser.warmup_async(max_batch)
        print("warmup: running in background (--warm_async)", flush=True)
    elif warm:
        # every (bucket, quantized-batch) shape captured before the first
        # request; sound because warmup's max_batch and MicroBatcher's
        # share one unit (sentence rows)
        t0 = time.time()
        n = parser.warmup(max_batch)
        print(f"warmup: {n} shapes in {time.time() - t0:.1f}s", flush=True)
    batcher = MicroBatcher(parser, max_batch=max_batch,
                           max_wait_ms=max_wait_ms)

    def parse_request(req):
        """texts/sentences -> trees; tokenization happens on the handler
        thread, only the device call is funneled through the batcher."""
        if "texts" in req:
            toks, words = parser.tokenize(req["texts"])
            trees = batcher.submit(toks)
            return [replace_leaves(t, ws) for t, ws in zip(trees, words)]
        return batcher.submit(req["sentences"])

    class Handler(BaseHTTPRequestHandler):
        def _reply(self, code: int, obj) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):  # quiet by default
            pass

        def do_GET(self):
            if self.path == "/healthz":
                self._reply(200, {"ok": True, "meta": parser.meta})
            else:
                self._reply(404, {"error": "unknown path"})

        def do_POST(self):
            if self.path != "/parse":
                self._reply(404, {"error": "unknown path"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n))
                trees = parse_request(req)
                self._reply(200, {"trees": [_tupleize(t) for t in trees]})
            except Exception as e:  # noqa: BLE001 -- surface to client
                self._reply(400, {"error": f"{type(e).__name__}: {e}"})

    srv = _Server((host, port), Handler)
    srv.parser = parser
    srv.batcher = batcher
    return srv


def main(args=None):
    p = argparse.ArgumentParser()
    p.add_argument("--bundle", required=True)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", default=8000, type=int)
    p.add_argument("--device", default="cuda", type=str,
                   help="'cuda' (default; raises without a card) or 'cpu'")
    p.add_argument("--max_batch", default=64, type=int,
                   help="max sentences (rows) coalesced per device call; "
                        "also the warmup row budget, so a warmed server "
                        "only replays captured graphs")
    p.add_argument("--max_wait_ms", default=5.0, type=float,
                   help="micro-batching window: extra latency the first "
                        "request in a batch may pay to collect peers")
    p.add_argument("--no_warm", action="store_true",
                   help="skip the startup warmup (each shape then runs "
                        "the program eagerly)")
    p.add_argument("--warm_async", action="store_true",
                   help="warm shapes on a background thread and accept "
                        "requests at once")
    options = p.parse_args(args)
    srv = make_server(options.bundle, options.host, options.port,
                      max_batch=options.max_batch,
                      max_wait_ms=options.max_wait_ms,
                      warm=not options.no_warm,
                      warm_async=options.warm_async,
                      device=options.device)
    print(f"serving {options.bundle} on "
          f"http://{options.host}:{srv.server_address[1]}", flush=True)
    srv.serve_forever()


if __name__ == "__main__":
    main()
