"""WebAuthn client fixture (L7): the web demo's browser-side flow in Python.

The port's copy of the JAX package's client/webauthn.py, over the port's
fields/ref_curve.py, fields/constants.py and circuits/es256_circuit.py.

Reproduces what `web-demo/src/pages/index.tsx` does with real
authenticators, end to end and bit-for-bit:

* registration: P-256 keypair + credential, authenticatorData with
  attested credential data and a COSE_Key (CBOR) public key
  (index.tsx:443-498 / simplewebauthn);
* authentication: authenticatorData ‖ clientDataJSON signing flow —
  `msghash = SHA-256(authenticatorData ‖ SHA-256(clientDataJSON))`
  (index.tsx:186-197), DER ECDSA signature parsed to raw r‖s with
  leading-zero stripping (index.tsx:237-250);
* the proving-server byte convention: all five 32-byte inputs
  byte-REVERSED to little-endian (index.tsx:287-294, matching
  `Fp::from_bytes` — ecdsa_p256.rs:346-352);
* parsing: `parseAuthenticatorData` (index.tsx:67-131) including the
  minimal CBOR subset for COSE keys.

This is a test fixture and reference client, not an authenticator:
keys are software keys from fields/ref_curve.
"""
from __future__ import annotations

import base64
import hashlib
import json
import secrets
import struct
from dataclasses import dataclass

from ..fields.constants import P256_N
from ..fields.ref_curve import ecdsa_keygen, ecdsa_sign

# authenticatorData flags (WebAuthn §6.1)
FLAG_UP = 0x01  # user present
FLAG_UV = 0x04  # user verified
FLAG_AT = 0x40  # attested credential data included

AAGUID = bytes(16)


# ---------------------------------------------------------------------------
# minimal CBOR (the subset COSE keys / attestation objects use)
# ---------------------------------------------------------------------------

def cbor_encode(obj) -> bytes:
    def head(major: int, n: int) -> bytes:
        if n < 24:
            return bytes([(major << 5) | n])
        if n < 0x100:
            return bytes([(major << 5) | 24, n])
        if n < 0x10000:
            return bytes([(major << 5) | 25]) + struct.pack(">H", n)
        return bytes([(major << 5) | 26]) + struct.pack(">I", n)

    if isinstance(obj, int):
        if obj >= 0:
            return head(0, obj)
        return head(1, -1 - obj)
    if isinstance(obj, bytes):
        return head(2, len(obj)) + obj
    if isinstance(obj, str):
        b = obj.encode()
        return head(3, len(b)) + b
    if isinstance(obj, list):
        return head(4, len(obj)) + b"".join(cbor_encode(x) for x in obj)
    if isinstance(obj, dict):
        # canonical-ish: preserve insertion order (COSE keys are built
        # in the standard order below)
        return head(5, len(obj)) + b"".join(
            cbor_encode(k) + cbor_encode(v) for k, v in obj.items())
    raise TypeError(f"cbor: unsupported {type(obj)}")


def cbor_decode_first(data: bytes):
    """Decode the first CBOR item, returning (value, remaining) — the
    web demo's `decodeFirst` (cbor-x) role."""

    def item(b: bytes):
        ib = b[0]
        major, info = ib >> 5, ib & 0x1F
        off = 1
        if info < 24:
            n = info
        elif info == 24:
            n, off = b[1], 2
        elif info == 25:
            n, off = struct.unpack(">H", b[1:3])[0], 3
        elif info == 26:
            n, off = struct.unpack(">I", b[1:5])[0], 5
        else:
            raise ValueError("cbor: unsupported length")
        if major == 0:
            return n, b[off:]
        if major == 1:
            return -1 - n, b[off:]
        if major == 2:
            return b[off:off + n], b[off + n:]
        if major == 3:
            return b[off:off + n].decode(), b[off + n:]
        if major == 4:
            out = []
            rest = b[off:]
            for _ in range(n):
                v, rest = item(rest)
                out.append(v)
            return out, rest
        if major == 5:
            d = {}
            rest = b[off:]
            for _ in range(n):
                k, rest = item(rest)
                v, rest = item(rest)
                d[k] = v
            return d, rest
        raise ValueError(f"cbor: unsupported major {major}")

    return item(data)


# ---------------------------------------------------------------------------
# credential model
# ---------------------------------------------------------------------------

def b64url(b: bytes) -> str:
    return base64.urlsafe_b64encode(b).rstrip(b"=").decode()


@dataclass
class Credential:
    rp_id: str
    credential_id: bytes
    sk: int
    pk: tuple[int, int]
    counter: int = 0

    @property
    def cose_key(self) -> dict:
        """COSE_Key EC2/P-256/ES256: the web demo reads x,y from CBOR map
        keys -2/-3 (index.tsx:218-226)."""
        return {
            1: 2,   # kty: EC2
            3: -7,  # alg: ES256 (index.tsx:452-460 requests alg -7)
            -1: 1,  # crv: P-256
            -2: self.pk[0].to_bytes(32, "big"),
            -3: self.pk[1].to_bytes(32, "big"),
        }


def create_credential(rp_id: str = "webauthn-halo2-tpu.local") -> Credential:
    """Registration (index.tsx:443-498): new software P-256 keypair."""
    sk, pk = ecdsa_keygen()
    return Credential(rp_id, secrets.token_bytes(32), sk, pk)


def registration_authenticator_data(cred: Credential) -> bytes:
    """authenticatorData with attested credential data (flags AT|UV|UP)."""
    rp_hash = hashlib.sha256(cred.rp_id.encode()).digest()
    flags = FLAG_UP | FLAG_UV | FLAG_AT
    attested = (AAGUID + struct.pack(">H", len(cred.credential_id))
                + cred.credential_id + cbor_encode(cred.cose_key))
    return rp_hash + bytes([flags]) + struct.pack(">I", cred.counter) + attested


def parse_authenticator_data(data: bytes) -> dict:
    """parseAuthenticatorData parity (index.tsx:67-131)."""
    out = {
        "rpIdHash": data[:32],
        "flags": data[32],
        "counter": struct.unpack(">I", data[33:37])[0],
    }
    rest = data[37:]
    if out["flags"] & FLAG_AT:
        out["aaguid"] = rest[:16]
        (cid_len,) = struct.unpack(">H", rest[16:18])
        out["credentialId"] = rest[18:18 + cid_len]
        cose, rest2 = cbor_decode_first(rest[18 + cid_len:])
        out["credentialPublicKey"] = cose
        out["publicKey"] = (int.from_bytes(cose[-2], "big"),
                            int.from_bytes(cose[-3], "big"))
        rest = rest2
    if rest:
        out["extensionsData"] = rest
    return out


# ---------------------------------------------------------------------------
# authentication (assertion) flow
# ---------------------------------------------------------------------------

def der_encode_signature(r: int, s: int) -> bytes:
    """DER SEQUENCE(INTEGER r, INTEGER s) — what authenticators emit."""

    def der_int(v: int) -> bytes:
        b = v.to_bytes((v.bit_length() + 7) // 8 or 1, "big")
        if b[0] & 0x80:
            b = b"\0" + b
        return bytes([0x02, len(b)]) + b

    body = der_int(r) + der_int(s)
    return bytes([0x30, len(body)]) + body


def der_parse_signature(der: bytes) -> tuple[int, int]:
    """DER -> raw (r, s), stripping leading zeros (index.tsx:237-250)."""
    assert der[0] == 0x30
    i = 2
    assert der[i] == 0x02
    rlen = der[i + 1]
    r = int.from_bytes(der[i + 2:i + 2 + rlen], "big")
    i += 2 + rlen
    assert der[i] == 0x02
    slen = der[i + 1]
    s = int.from_bytes(der[i + 2:i + 2 + slen], "big")
    return r, s


@dataclass
class Assertion:
    authenticator_data: bytes
    client_data_json: bytes
    der_signature: bytes

    # derived values the client computes before calling the prover
    msghash: int
    r: int
    s: int


def authenticate(cred: Credential, challenge: bytes,
                 origin: str = "https://webauthn-halo2-tpu.local",
                 k: int | None = None) -> Assertion:
    """The assertion flow (index.tsx:155-294): sign
    SHA-256(authenticatorData ‖ SHA-256(clientDataJSON))."""
    cred.counter += 1
    rp_hash = hashlib.sha256(cred.rp_id.encode()).digest()
    auth_data = (rp_hash + bytes([FLAG_UP | FLAG_UV])
                 + struct.pack(">I", cred.counter))
    client_data = json.dumps({
        "type": "webauthn.get",
        "challenge": b64url(challenge),
        "origin": origin,
        "crossOrigin": False,
    }, separators=(",", ":")).encode()
    # index.tsx:186-197: msghash = SHA256(authData ‖ SHA256(clientDataJSON))
    inner = hashlib.sha256(client_data).digest()
    msghash = int.from_bytes(
        hashlib.sha256(auth_data + inner).digest(), "big") % P256_N
    r, s = ecdsa_sign(msghash, cred.sk, k)
    return Assertion(auth_data, client_data, der_encode_signature(r, s),
                     msghash, r, s)


def prove_request_body(assertion: Assertion, cred: Credential,
                       proving_key_path: str = "./keys/proving_key.pk"
                       ) -> dict:
    """The exact JSON the web demo POSTs to /prove_evm (index.tsx:287-294):
    every 32-byte big-endian value byte-REVERSED to little-endian arrays
    (ProveRequestBody, main.rs:39-47)."""

    def le(v: int) -> list[int]:
        return list(v.to_bytes(32, "little"))

    return {
        "r": le(assertion.r),
        "s": le(assertion.s),
        "msghash": le(assertion.msghash),
        "pubkey_x": le(cred.pk[0]),
        "pubkey_y": le(cred.pk[1]),
        "proving_key_path": proving_key_path,
    }


def verify_assertion_host(assertion: Assertion, cred: Credential) -> bool:
    """The demo's WebCrypto sanity check (index.tsx:263-269)."""
    from ..fields.ref_curve import ecdsa_verify

    return ecdsa_verify(assertion.msghash, assertion.r, assertion.s, cred.pk)


def es256_inputs_from_assertion(assertion: Assertion, cred: Credential):
    """Bridge to the ES256 circuit (in-circuit SHA-256): the assertion's
    raw authenticatorData + SHA-256(clientDataJSON) become the circuit's
    private witnesses — the full WebAuthn relation proved end to end
    (what the reference's es256.rs TODO'd)."""
    import hashlib as _hl

    from ..circuits.es256_circuit import ES256Inputs

    return ES256Inputs(
        r=assertion.r,
        s=assertion.s,
        authenticator_data=assertion.authenticator_data,
        client_data_hash=_hl.sha256(assertion.client_data_json).digest(),
        pk=cred.pk,
    )
