"""Proving server: the reference's six HTTP endpoints (main.rs:29-439).

The port's counterpart of the JAX package's server/app.py: the same
handler over the port's api, proving on the card. Start it with
`python -m webauthn_halo2_tpu_torch.server.app` (port 8000).

Same routes, JSON schemas, and hex conventions as the Rocket server:
  POST /setup                 {degree?}                         -> "keys generated"
  POST /prove                 ProveRequestBody                  -> proof hex
  POST /prove_evm             ProveRequestBody                  -> proof hex
  POST /verify                {verifying_key_path, proof}       -> "verified"/"rejected"
  POST /verify_evm            {verifying_key_path, proof}       -> "verified"/"rejected"
  POST /generate_evm_verifier {..paths..}                       -> artifacts

ProveRequestBody: {r, s, pubkey_x, pubkey_y, msghash: [u8;32] little-endian,
proving_key_path} (main.rs:39-47; the browser byte-reverses to LE,
index.tsx:287-294). Stdlib http.server keeps the dependency surface zero;
CORS is permissive like the reference (main.rs:441-449). Keys/SRS are
cached in memory across requests (fixing the reference's per-request
reload, SURVEY §3.2): one proving key per circuit, built once whichever
request or thread asks first.
"""
from __future__ import annotations

import json
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from .. import api

DEGREE = 17  # main.rs:17 parity


class Handler(BaseHTTPRequestHandler):
    server_version = "webauthn-halo2-tpu-torch/0.1"

    def _send(self, code: int, body: str, ctype="text/plain") -> None:
        data = body.encode()
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        self.send_header("Access-Control-Allow-Origin", "*")
        self.send_header("Access-Control-Allow-Headers", "*")
        self.send_header("Access-Control-Allow-Methods", "POST, OPTIONS")
        self.end_headers()
        self.wfile.write(data)

    def do_OPTIONS(self):  # CORS preflight
        self._send(200, "")

    def do_POST(self):
        try:
            length = int(self.headers.get("Content-Length", 0))
            body = json.loads(self.rfile.read(length) or b"{}")
            route = self.path.rstrip("/")
            if route == "/setup":
                degree = int(body.get("degree", DEGREE))
                api.download_keys(
                    degree, "./keys/proving_key.pk", "./keys/verifying_key.vk"
                )
                self._send(200, "keys generated")
            elif route in ("/prove", "/prove_evm"):
                fn = api.generate_proof if route == "/prove" else api.generate_proof_evm
                proof = fn(
                    bytes(body["r"]),
                    bytes(body["s"]),
                    bytes(body["pubkey_x"]),
                    bytes(body["pubkey_y"]),
                    bytes(body["msghash"]),
                    body.get("proving_key_path", ""),
                )
                self._send(200, proof.hex())
            elif route in ("/verify", "/verify_evm"):
                fn = api.verify if route == "/verify" else api.verify_evm
                ok = fn(
                    bytes.fromhex(body["proof"]),
                    body.get("verifying_key_path", ""),
                    # expose_msghash circuits: claimed public inputs
                    # (list of per-column int lists)
                    public_inputs=body.get("public_inputs"),
                )
                self._send(200, "verified" if ok else "rejected")
            elif route == "/generate_evm_verifier":
                # main.rs:376-409 parity: writes .code/.yul/.sol artifacts,
                # optionally dry-runs a proof in the bytecode EVM
                gas = api.generate_verifier(
                    body.get("verifying_key_path", ""),
                    body.get("sol_code_path", "verifier.sol"),
                    body.get("deploy_code_path", "verifier.code"),
                    body.get("yul_code_path", "verifier.yul"),
                    body.get("valid_proof_hex"),
                )
                msg = "generated evm verifier"
                if gas is not None:
                    msg += f" (dry-run gas: {gas})"
                self._send(200, msg)
            # --- bundler-lite: the demo's on-chain leg (index.tsx:296-429
            # against the in-repo EVM instead of Pimlico/Base Goerli) ---
            elif route == "/chain/sender":
                from . import bundler

                w = bundler.world()
                sender = w.sender_for(bytes.fromhex(body["public_key"]))
                self._send(200, json.dumps({"sender": f"0x{sender:040x}"}),
                           ctype="application/json")
            elif route == "/chain/submit_userop":
                from . import bundler

                w = bundler.world()
                receipt = w.submit(bytes.fromhex(body["public_key"]),
                                   bytes.fromhex(body["proof"]))
                self._send(200, json.dumps(receipt),
                           ctype="application/json")
            elif route == "/chain/receipt":
                from . import bundler

                w = bundler.world()
                r = w.receipt(body["userOpHash"])
                self._send(200 if r else 404,
                           json.dumps(r or {"error": "unknown userOpHash"}),
                           ctype="application/json")
            else:
                self._send(404, "unknown route")
        except Exception as e:  # noqa: BLE001 - match reference's 500 behavior
            traceback.print_exc()
            self._send(500, f"error: {e}")

    def log_message(self, fmt, *args):  # quiet default request log
        pass


def _prewarm() -> None:
    """Background warm-up so the FIRST /prove request is served at
    steady-state speed: the first proof of a process pays the build of the
    CUDA kernel libraries (nvcc, when build/kernels/ lacks them) and the
    first launches of every kernel and constant table; paying them at
    boot, off the request path, keeps the server responsive the moment
    the socket opens."""
    import threading
    import time

    def work():
        t0 = time.time()
        try:
            import secrets

            from ..fields.constants import P256_N
            from ..fields.ref_curve import ecdsa_keygen, ecdsa_sign

            sk, pub = ecdsa_keygen()
            m = secrets.randbelow(P256_N)
            r, s = ecdsa_sign(m, sk)

            def le(x):
                return int(x).to_bytes(32, "little")

            api.generate_proof(le(r), le(s), le(pub[0]), le(pub[1]), le(m))
            print(f"prewarm: proving path hot in {time.time()-t0:.0f}s",
                  flush=True)
        except Exception as e:  # noqa: BLE001 — warmup must never kill boot
            print(f"prewarm failed (server still up): {e}", flush=True)

    threading.Thread(target=work, daemon=True, name="prewarm").start()


def main(port: int = 8000, warm: bool = True) -> None:
    if warm:
        # boot-time keygen, like the reference's main() (main.rs:451-456)
        api.download_keys(DEGREE, "./keys/proving_key.pk", "./keys/verifying_key.vk")
        _prewarm()  # kernel build + first launches, off the request path
    srv = ThreadingHTTPServer(("0.0.0.0", port), Handler)
    print(f"proving server on :{port}")
    srv.serve_forever()


if __name__ == "__main__":
    main()
