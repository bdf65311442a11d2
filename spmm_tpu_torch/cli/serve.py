"""HTTP serving front-end over the dynamic-batching layer (stdlib only).

Counterpart of ``spmm_tpu.cli.serve``.  Endpoints (JSON in/out):

  POST /pv2smiles   {"pv": [53 floats], "normalized": false}
                    -> {"smiles": "..."}
                    Raw property values by default, z-normalized with the
                    bundled stats (reference d_pv2smiles_batched.py:64-66);
                    "normalized": true sends pre-normalized values.  Partial
                    conditioning (reference d_pv2smiles_single.py:60-66):
                    null leaves a property unconstrained, and so does a 1 in
                    an optional "mask" list of 53 0/1 flags.
  POST /smiles2pv   {"smiles": "..."} -> {"pv": [53 floats]}, denormalized
                    (400 on an empty or non-string value)
  GET  /healthz     -> {"ok": true, "services": {...per-service stats}}

Run: python -m spmm_tpu_torch.cli.serve --checkpoint <reference .ckpt>
"""

from __future__ import annotations

import argparse
import json
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

N_PROPERTIES = 53


def parse_pv2smiles(req: dict, stats) -> tuple[np.ndarray, np.ndarray]:
    """Request body -> (normalized pv with masked slots zeroed, mask);
    raises ValueError / KeyError / TypeError on a malformed request."""
    vals = req["pv"]
    if not isinstance(vals, list) or len(vals) != N_PROPERTIES:
        raise ValueError(
            f"pv must be a list of {N_PROPERTIES} entries, got "
            f"{type(vals).__name__} of "
            f"{len(vals) if isinstance(vals, list) else '?'}")
    mask = np.asarray([v is None for v in vals], np.float32)
    if "mask" in req:
        m = req["mask"]
        if (not isinstance(m, list) or len(m) != N_PROPERTIES
                or any(x not in (0, 1, 0.0, 1.0, False, True) for x in m)):
            raise ValueError(f"mask must be a list of {N_PROPERTIES} 0/1 flags")
        mask = np.maximum(mask, np.asarray(m, np.float32))
    pv = np.asarray([0.0 if v is None else float(v) for v in vals], np.float32)
    if not req.get("normalized", False):
        if stats is None:
            raise ValueError("server has no normalization stats; send "
                             "normalized pv with \"normalized\": true")
        pv = stats.normalize(pv)
    # masked slots' values are inert; zero them after normalization
    return np.where(mask > 0, 0.0, pv), mask


def parse_smiles2pv(req: dict) -> str:
    """Request body -> the SMILES string; raises ValueError / KeyError on a
    malformed request."""
    smiles = req["smiles"]
    if not isinstance(smiles, str) or not smiles:
        raise ValueError("smiles must be a non-empty string")
    return smiles


def make_server(services: dict, host: str, port: int,
                stats=None) -> ThreadingHTTPServer:
    """HTTP server routing to ``services`` ({'pv2smiles': ...,
    'smiles2pv': ...}; a missing one answers 404).  ``stats``
    (PropertyStats) enables the raw-PV normalization.  Returns the server
    unstarted — call ``serve_forever()``."""
    # route -> (request body -> service item, service result -> reply body)
    routes = {
        "pv2smiles": (lambda req: parse_pv2smiles(req, stats),
                      lambda smiles: {"smiles": smiles}),
        "smiles2pv": (parse_smiles2pv,
                      lambda pv: {"pv": [float(x) for x in pv]}),
    }

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):   # one line per request is noise
            pass

        def _reply(self, code: int, payload: dict) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path != "/healthz":
                return self._reply(404, {"error": f"no route {self.path}"})
            self._reply(200, {"ok": True, "services": {
                name: dict(svc.stats) for name, svc in services.items()}})

        def do_POST(self):
            name = self.path.lstrip("/")
            svc, route = services.get(name), routes.get(name)
            if svc is None or route is None:
                return self._reply(404, {"error": f"no route {self.path}"})
            parse, reply = route
            # parse/validate THIS request: client errors -> 400
            try:
                raw = self.rfile.read(int(self.headers["Content-Length"]))
                item = parse(json.loads(raw))
            except (KeyError, ValueError, TypeError,
                    json.JSONDecodeError) as exc:
                return self._reply(400, {"error": str(exc)})
            # execute: a batch failure is a server error -> 500
            try:
                result = svc.submit(item).result()
            except Exception as exc:  # noqa: BLE001 — reported to the client
                return self._reply(500, {"error": f"{type(exc).__name__}: "
                                                  f"{exc}"})
            self._reply(200, reply(result))

    class Server(ThreadingHTTPServer):
        # a wave of concurrent clients must not overflow the listen backlog
        request_queue_size = 256
        daemon_threads = True

    return Server((host, port), Handler)


def main(argv=None):
    from spmm_tpu_torch.checkpoint.convert import load_spmm_checkpoint
    from spmm_tpu_torch.cli._common import (
        inference_devices, load_stats, make_tokenizer)
    from spmm_tpu_torch.models.spmm import SPMM
    from spmm_tpu_torch.serving import Pv2SmilesService, Smiles2PvService
    from spmm_tpu_torch.utils.device import resolve_device

    p = argparse.ArgumentParser()
    p.add_argument("--checkpoint", required=True,
                   help="reference {'state_dict': ...} .ckpt")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--device", default="cuda")
    p.add_argument("--k", type=int, default=2)
    p.add_argument("--stochastic", action="store_true",
                   help="sample beams multinomially (single-query mode: "
                        "k**2 stop, uniform pick among finished beams)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--max_wait_ms", type=float, default=25.0,
                   help="max time a request waits for a full batch, "
                        "measured from submission")
    args = p.parse_args(argv)

    dev = resolve_device(args.device)
    tok = make_tokenizer()
    stats = load_stats()
    model = load_spmm_checkpoint(SPMM(), args.checkpoint).to(dev).eval()
    devices, args.batch_size = inference_devices(dev, args.batch_size)
    services = {
        "pv2smiles": Pv2SmilesService(
            model, tok, k=args.k, stochastic=args.stochastic, seed=args.seed,
            batch_size=args.batch_size, max_wait_ms=args.max_wait_ms,
            device=dev, devices=devices),
        "smiles2pv": Smiles2PvService(
            model, tok, stats=stats, batch_size=args.batch_size,
            max_wait_ms=args.max_wait_ms, device=dev, devices=devices),
    }
    server = make_server(services, args.host, args.port, stats=stats)
    print(f"serving on http://{args.host}:{server.server_address[1]} "
          f"(POST /pv2smiles, POST /smiles2pv, GET /healthz)")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        for svc in services.values():
            svc.close()


if __name__ == "__main__":
    main()
