#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, one line each:
  1. build the CUDA kernels (webauthn_halo2_tpu_torch/csrc, nvcc, sm_90a);
  2. hold each kernel against its plain PyTorch version on the card, at the
     shapes of the main path, with exact equality of the words;
  3. keygen of the ECDSA-P256 circuit at the default CircuitParams (k=17);
  4. api.generate_proof on a fixed signature with a deterministic rng;
  5. api.verify accepts it and rejects a tampered copy; the port's verifier
     accepts results/proof_shplonk_k17.hex (made by the JAX package);
  6. every kernel launched during phases 3-5; a `kernels` JSON line with
     launches, times, bounds and the plain versions' times.
The last line is {"ok": true, "device": {...}}. Any failure exits non-zero
and prints no such line. Imports nothing of JAX and nothing of the JAX
package.
"""
from __future__ import annotations

import hashlib
import json
import os
import random
import subprocess
import sys
import time

import torch

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM bytes per second,
# and 32-bit integer multiply-adds per second. The integer rate is not in
# the data sheet's table: an SM issues 64 INT32 lanes per clock, half its
# 128 FP32 lanes, so it is half the 67 TFLOP/s float32 rate counted in
# instructions: 67e12 / 2 (FMA = 2 flops) / 2 = 16.75e12 IMAD/s.
HBM_BYTES_PER_S = 3.35e12
IMAD_PER_S = 16.75e12
# one 8-word CIOS Montgomery multiply: 64 a*b and 64 m*p word products,
# each a 32x32 -> 64-bit product (two IMADs: low and high half)
IMAD_PER_MONTMUL = 256
ELEM_BYTES = 32


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def _events_ms(fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _rand_words(spec, shape, gen: torch.Generator, dev) -> torch.Tensor:
    """Field elements as (8, *shape) int32 words, made on the card: seven
    random low words and a top word below p's top word, so every value is
    below p."""
    top = int(spec.p_words[7])
    low = torch.randint(-(1 << 31), 1 << 31, (7,) + tuple(shape), generator=gen,
                        device=dev, dtype=torch.int64)
    hi = torch.randint(0, top, (1,) + tuple(shape), generator=gen, device=dev,
                       dtype=torch.int64)
    return torch.cat([low, hi]).to(torch.int32)


def _max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item())


def phase_kernels(dev, gen):
    """Phase 2: each kernel against its plain version, exact words."""
    from webauthn_halo2_tpu_torch.fields.limbs import FR_SPEC
    from webauthn_halo2_tpu_torch.ops import modops as M
    from webauthn_halo2_tpu_torch.ops import ntt as N

    rows = {}
    # montmul at the prover's column (2^17) and extended (2^19) widths
    for logn in (17, 19):
        a = _rand_words(FR_SPEC, (1 << logn,), gen, dev)
        b = _rand_words(FR_SPEC, (1 << logn,), gen, dev)
        got = M.montmul_cuda(FR_SPEC, a, b)
        want = M.montmul_plain(FR_SPEC, a, b)
        torch.cuda.synchronize()
        err = _max_abs_err(got, want)
        log(f"[kernels] montmul (8, 2^{logn}): max_abs_err={err}")
        if err:
            fail(f"montmul kernel disagrees with its plain version at 2^{logn}")
        if logn == 19:
            n = 1 << logn
            rows["montmul"] = dict(
                err=err, shape=f"(8, 2^{logn})",
                ms=_events_ms(lambda: M.montmul_cuda(FR_SPEC, a, b), 50),
                plain_ms=_events_ms(lambda: M.montmul_plain(FR_SPEC, a, b), 3),
                bytes=3 * ELEM_BYTES * n, ops=IMAD_PER_MONTMUL * n)

    # full transforms at k=17, batch 1 and 9: kernels vs the stage loop
    k = 17
    for B in (1, 9):
        x = _rand_words(FR_SPEC, (B, 1 << k), gen, dev)
        for inverse in (False, True):
            got = N.ntt_fused(FR_SPEC, x, k, inverse)
            want = N._ntt_core(FR_SPEC, x, k, inverse, plain=True)
            torch.cuda.synchronize()
            err = _max_abs_err(got, want)
            log(f"[kernels] {'intt' if inverse else 'ntt'} k={k} batch={B}: "
                f"max_abs_err={err}")
            if err:
                fail(f"NTT kernels disagree with the stage loop (k={k}, B={B})")
        back = N.intt(FR_SPEC, N.ntt(FR_SPEC, x, k), k)
        if not torch.equal(back, x):
            fail(f"intt(ntt(x)) != x at k={k}, batch {B}")
        log(f"[kernels] intt(ntt(x)) == x at k={k} batch={B}")

    # each NTT kernel alone, at the quotient's conversion shape: a stack of
    # 19 columns on the extended domain 2^19
    ek, B = 19, 19
    n = 1 << ek
    x = _rand_words(FR_SPEC, (B, n), gen, dev)
    tw = N._twiddles_dev(ek, False, dev)
    log_t = N.T_LOG_MAX
    got = N.stage_a(FR_SPEC, x, tw, log_t)
    want = N.stage_a_plain(FR_SPEC, x, tw, log_t)
    torch.cuda.synchronize()
    err_a = _max_abs_err(got, want)
    log(f"[kernels] stage A (8, {B}, 2^{ek}) T=2^{log_t}: max_abs_err={err_a}")
    if err_a:
        fail("NTT stage A disagrees with its plain version")
    butterflies = B * (n // 2) * log_t
    rows["ntt_stage_a"] = dict(
        err=err_a, shape=f"(8, {B}, 2^{ek}), T=2^{log_t}",
        ms=_events_ms(lambda: N.stage_a(FR_SPEC, x, tw, log_t), 10),
        plain_ms=_events_ms(lambda: N.stage_a_plain(FR_SPEC, x, tw, log_t), 1),
        bytes=2 * ELEM_BYTES * B * n + ELEM_BYTES * ((1 << log_t) - 1),
        ops=IMAD_PER_MONTMUL * butterflies)
    s = log_t
    got = N.stage_b(FR_SPEC, x, tw, s)
    want = N.stage_b_plain(FR_SPEC, x, tw, s)
    torch.cuda.synchronize()
    err_b = _max_abs_err(got, want)
    log(f"[kernels] stage B (8, {B}, 2^{ek}) h=2^{s}: max_abs_err={err_b}")
    if err_b:
        fail("NTT stage B disagrees with its plain version")
    rows["ntt_stage_b"] = dict(
        err=err_b, shape=f"(8, {B}, 2^{ek}), h=2^{s}",
        ms=_events_ms(lambda: N.stage_b(FR_SPEC, x, tw, s), 20),
        plain_ms=_events_ms(lambda: N.stage_b_plain(FR_SPEC, x, tw, s), 2),
        bytes=2 * ELEM_BYTES * B * n + ELEM_BYTES * (1 << s),
        ops=IMAD_PER_MONTMUL * B * (n // 2))
    return rows


class _Seeded:
    """`randbelow` over a seeded generator, for ref_curve.ecdsa_keygen."""

    def __init__(self, seed: int):
        self.r = random.Random(seed)

    def randbelow(self, n: int) -> int:
        return self.r.randrange(n)


def _det_rng(seed: bytes):
    ctr = [0]

    def rng(nbytes: int) -> bytes:
        ctr[0] += 1
        return hashlib.blake2b(seed + ctr[0].to_bytes(8, "little"),
                               digest_size=nbytes).digest()

    return rng


def main() -> int:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a card")
    try:
        from webauthn_halo2_tpu_torch import api
        from webauthn_halo2_tpu_torch.circuits.ecdsa_circuit import CircuitParams
        from webauthn_halo2_tpu_torch.fields.ref_curve import (P256_CURVE,
                                                               ecdsa_keygen,
                                                               ecdsa_sign)
        from webauthn_halo2_tpu_torch.ops import kernels as K
        from webauthn_halo2_tpu_torch.ops import modops as M
        from webauthn_halo2_tpu_torch.ops import ntt as N
        from webauthn_halo2_tpu_torch.plonk import prover as PR
    except ImportError as e:
        fail(f"the port's package is not here: {e}")
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip().splitlines()
    card = smi[0] if smi else "nvidia-smi gave nothing"
    t_all = time.time()

    # 1. build
    t0 = time.time()
    K.build_all()
    log(f"[build] kernels {', '.join(K.SOURCES)} built in {time.time() - t0:.1f}s "
        f"(compiler reports: {K.BUILD_DIR}/*.log)")

    # 2. kernels against their plain versions
    t0 = time.time()
    rows = phase_kernels(dev, torch.Generator(device=dev).manual_seed(17))
    log(f"[kernels] all kernels equal their plain versions ({time.time() - t0:.1f}s)")

    # 3-5: the main path, with the launch counters from zero
    M.LAUNCHES["montmul"] = 0
    N.LAUNCHES["ntt_stage_a"] = 0
    N.LAUNCHES["ntt_stage_b"] = 0
    params = CircuitParams()
    t0 = time.time()
    pk = api.proving_key(params, device=dev)
    torch.cuda.synchronize()
    log(f"[keygen] k={params.degree} ECDSA circuit: {time.time() - t0:.1f}s "
        f"vk={pk.vk.transcript_repr:#x} "
        + json.dumps({k: round(v, 3) for k, v in pk.spans.items()}))

    sk, pub = ecdsa_keygen(rng=_Seeded(2024))
    m = _Seeded(4096).randbelow(P256_CURVE.n)
    r, s = ecdsa_sign(m, sk, k=1 + _Seeded(8192).randbelow(P256_CURVE.n - 1))

    def le(v):
        return int(v).to_bytes(32, "little")

    def counts():
        return {"montmul": M.LAUNCHES["montmul"],
                "ntt_stage_a": N.LAUNCHES["ntt_stage_a"],
                "ntt_stage_b": N.LAUNCHES["ntt_stage_b"]}

    after_keygen = counts()
    t0 = time.time()
    proof = api.generate_proof(le(r), le(s), le(pub[0]), le(pub[1]), le(m),
                               params=params, device=dev,
                               rng=_det_rng(b"chip_smoke"))
    prove_s = time.time() - t0
    spans = dict(PR.LAST_SPANS)
    per_proof = {k: v - after_keygen[k] for k, v in counts().items()}
    log(f"[prove] {len(proof)} bytes in {prove_s:.1f}s spans="
        + json.dumps({k: round(v, 3) for k, v in spans.items()}))

    t0 = time.time()
    if not api.verify(proof, params=params, device=dev):
        fail("api.verify rejected the port's own proof")
    bad = bytearray(proof)
    bad[len(bad) // 2] ^= 1
    if api.verify(bytes(bad), params=params, device=dev):
        fail("api.verify accepted a tampered proof")
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "results", "proof_shplonk_k17.hex")) as f:
        ref_hex = f.read().strip()
    jax_ok = api.verify_evm(bytes.fromhex(ref_hex), params=params,
                            scheme="shplonk", device=dev)
    log(f"[verify] own proof accepted, tampered rejected, "
        f"results/proof_shplonk_k17.hex accepted={jax_ok} ({time.time() - t0:.1f}s)")
    if not jax_ok:
        fail("the port's verifier rejected the JAX package's k=17 proof")

    # 6. counters and the kernels line
    launches = counts()
    log(f"[counters] launches during keygen+prove+verify: {json.dumps(launches)}; "
        f"keygen {json.dumps(after_keygen)}; one proof {json.dumps(per_proof)}")
    for name, count in launches.items():
        if count == 0:
            fail(f"kernel {name} was never launched on the main path")
    meta = {
        "montmul": ("webauthn_halo2_tpu_torch/csrc/montmul.cu",
                    "webauthn_halo2_tpu/ops/pallas_kernels.py:67"),
        "ntt_stage_a": ("webauthn_halo2_tpu_torch/csrc/ntt.cu",
                        "webauthn_halo2_tpu/ops/ntt_pallas.py:82"),
        "ntt_stage_b": ("webauthn_halo2_tpu_torch/csrc/ntt.cu",
                        "webauthn_halo2_tpu/ops/ntt_pallas.py:133"),
    }
    kernels = []
    for name, row in rows.items():
        t_bytes = row["bytes"] / HBM_BYTES_PER_S * 1e3
        t_ops = row["ops"] / IMAD_PER_S * 1e3
        kernels.append({
            "name": name, "route": "cuda", "source": meta[name][0],
            "replaces": meta[name][1], "launches": launches[name],
            "max_abs_err": row["err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None, "shape": row["shape"],
            "launches_per_proof": per_proof[name],
        })
    log(f"[total] {time.time() - t_all:.1f}s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
