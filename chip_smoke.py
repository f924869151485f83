#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Runs under WH2_TRACE (set unless it is set already): the phases read the
prover's and keygen's spans. The H100's ceilings and the kernels' work
counts come from webauthn_halo2_tpu_torch/utils/roofline.py.

Phases, one or more lines each:
  1. build the CUDA kernels (webauthn_halo2_tpu_torch/csrc, nvcc, sm_90a),
     one nvcc per source, all started together, and print each kernel's
     registers, stack frame and spill bytes from the compiler's report;
     beside them, in a thread, the host libraries of the verifier
     (csrc/host, g++);
  2. hold each kernel against its plain PyTorch version on the card, at the
     shapes of the main path, with exact equality of the words: montmul
     (random words at 2^17 and 2^19, edge words in Fr and Fq, a broadcast
     (8, 1) operand on either side, slices of a stacked (8, 3, n) tensor,
     ragged sizes; then its warm and cold times at (8, 2^19) from CUDA
     graph replays, with the SM clock and power draw; every other time but
     the int8 montmul's is from CUDA events over launches from Python:
     `timed_by`), NTT stage A
     at each launch shape of the proof's transforms ((1, 2^17), (1, 2^19),
     (19, 2^17), (19, 2^19)) with the tiles its schedule gives it, stage
     B, the v3 MSM kernels (interior, scan, combine) at n = 2^17,
     c = 13, 20 windows x 9 rows (the scan at the segment tails, the only
     positions it defines), the three again at the
     v1 route's 20 rows, the combine on mostly empty buckets (one row with
     one bucket, one with none) also against the host sum, plus degenerate
     MSMs that also meet the host oracle: small ones at n = 2^12, and at
     n = 2^17 columns with long nonzero segments (all ones, 0/1 selectors,
     16-bit values, zeros with 8 random tail rows) that also meet the
     serial engine; the fused EC add at the serial route's grow shape
     (R, K) and its scan's (R, 2K) with infinities on either side; the
     int8 tensor-core montmul (one mma tile against a host product first)
     against its plain version and the montmul kernel in Fr and Fq, edge
     words first, each at (8, 2^19), (8, 2^12), a ragged (8, 2^12 + 7) and
     (8, 16), driven through its entry point with the counts from zero,
     then timed from CUDA graph replays with the SM clock and power draw;
  3. a full k=17 MSM batch through the v3 pipeline equals the serial
     Pippenger on the card and the host oracle (sum k_i tau^i) G, and the
     v1 driver gives the same points;
  4. keygen of the ECDSA-P256 circuit at the default CircuitParams (k=17);
  5. api.generate_proof on a fixed signature with a deterministic rng, every
     commitment through the v3 pipeline, whose batches are recorded, and
     the shape of every montmul and NTT kernel launch;
  6. api.verify accepts it and rejects a tampered copy; the port's verifier
     accepts results/proof_shplonk_k17.hex (made by the JAX package); the
     proof and a flipped copy give the same verdicts through the native
     host verifier and the Python one, each timed; then
     the v3 MSM kernels on the proof's own six commit batches: each timed
     with its least work on that data (digit 0 excluded), per batch and
     summed over the proof (`proof_ms`, `proof_bound_ms`), the interior
     also one MSM at a time as the v1 route launches it; the combine
     checked against its plain version on every batch, the interior and
     scan on the advice batch and the last batch; the montmul and NTT
     kernels replayed at each of the proof's launch shapes, with a bound
     for each, summed over the proof's launches;
  7. the same proof with the serial Pippenger as the commit engine
     (plonk/keygen.MSM_ENGINE), every point add through the fused EC add,
     is byte-identical;
  8. the same proof through the v1 driver (interior and combine kernels,
     the plain boundary scan of fused EC adds, the device Horner) is
     byte-identical, and the scan kernels are not launched; the fused EC
     add's launch shapes on both routes are recorded and replayed, summed
     over each route's proof (`routes` of its row);
  9. the on-chain half at k=17 through api on the v3 route: download_keys
     into a new directory under build/, the in-memory keys dropped, the pk
     loaded from its file (size, save and load times) and a proof from it
     equal to phase 5's; generate_proof_evm (GWC over Keccak) with the
     launch counters from zero, its spans, launches and commit batches,
     each montmul and NTT launch shape and each commit batch the phase-5
     proof did not have against the plain versions; verify_evm accepts it,
     rejects a tampered copy and accepts results/proof_gwc_k17.hex, with
     the same verdicts on the native and the Python host paths; a
     SHPLONK proof over Keccak that verify_evm accepts; generate_verifier
     for both schemes, each Yul text equal to results/P256Verifier.yul and
     results/P256Verifier_shplonk.yul, deployed in the port's EVM, where the
     JAX package's proofs run at exactly the gas of results/evm_gas.json,
     the port's own within 0.5% of it, and tampered and truncated proofs
     revert, each call timed; the GWC verifier's verdicts and gas the same
     with the EVM's pairing and Keccak in Python;
 10. ES256 (tests/test_torch_mock.py, tests/test_torch_prover.py hold the
     JAX package's outputs it compares with): the circuit at k=17 (SHA-256
     of authenticator data and client-data hash in the circuit, then
     ECDSA-P256; two-column pair lookups) synthesised with the digest of
     the JAX package's synthesis; the mock prover on the card finds nothing
     on its witness and, with one SHA-256 cell plus one, the JAX package's
     findings; keygen (time, spans, commit batches, peak memory); a warm-up
     proof, then three proofs of fresh signatures from one seeded key, each
     timed and accepted by verify_proof, the first with its spans, launches,
     commit batches and peak memory; a flipped and a truncated proof
     rejected, with the same verdicts on the Python host path; the
     warm-up's rng again gives the same bytes; one rng proved at
     WH2_QUOTIENT_CHUNKS 1 and 4 gives the same bytes (each proof's peak
     memory and time, and each span's memory at its start and running peak
     at its end), the montmul on the windows' operands against its
     plain version; every montmul
     and NTT launch shape and commit batch the earlier phases did not check,
     against the plain versions; the K=6 two-column lookup circuit proved
     on the v3, v1 and serial routes, each proof equal to the JAX bytes;
     a JSON line of its numbers before the card's line;
 11. device SRS generation: generate_srs(17) on the card (its host scalars,
     window table, fixed-base multiplies and conversion to affine timed
     apart) equal to the committed k=17 SRS tensor for tensor; get_srs(18),
     a degree without a committed file, generated into a new directory under
     build/ in the port's format, reloaded equal, 64 seeded points of each
     table equal to the host multiples, and the pairing check
     e([tau]G1, G2) = e(G1, [tau]G2); its new montmul launch shapes (Fq)
     against the plain version;
 12. the proving server (webauthn_halo2_tpu_torch/server/app.py) on
     127.0.0.1 in a thread, in a new directory under build/: /setup, a
     WebAuthn assertion from the port's client through /prove, /verify,
     /prove_evm, /verify_evm and /generate_evm_verifier (Yul equal to
     results/P256Verifier.yul), then the bundler routes: the port's k=17 GWC
     proof unlocks a UserOperation in the port's EVM (counter 0 -> 1,
     account deployed), again (1 -> 2), results/proof_gwc_k17.hex (2 -> 3),
     a zeroed proof does not; one proving key for the whole phase;
     /verify and /verify_evm with the native and the Python host paths'
     verdicts equal; then, untraced, api.generate_proofs_batch (a stream a
     prover; 4 SHPLONK proofs verified, two byte-equal to the same
     requests proved alone, the batch's time over 4 proofs alone, one
     traced proof beside them, 2 GWC proofs verified, the 4 SHPLONK
     proofs again with one prover worker, byte-equal); a `serving` JSON
     line of its and phase 11's numbers;
 13. proving over ranks (webauthn_halo2_tpu_torch/parallel): four gloo
     ranks spawned on the one card (parallel/ranks.py, a file rendezvous
     in a new directory under build/, removed at the end; each rank's
     prints in its own log there, shown if it fails). Each rank holds
     sharded_ntt and sharded_intt at k=17 on 8 columns,
     sharded_coeff_to_extended from 17 to 19, sharded_msm on a full k=17
     column and batch_commit of 8 columns against the same functions on
     one device in that rank (the MSM also against the host oracle of
     phase 3); then keygen and api.generate_proof of phase 5's signature
     and rng with WH2_SHARDED=1, the launch counters, ROUTES and
     COLLECTIVES from zero: every rank's bytes equal phase 5's proof,
     api.verify accepts it on rank 0, every hooked call took the sharded
     route and rows 1-6 launched in each rank; each rank's keygen and
     proof seconds beside phases 4 and 5's, the collectives' calls, bytes
     and seconds a proof, and its peak memory. Rank 0 records the launch
     shapes and commit batches of its sharded primitives, keygen and proof
     (each rank's block is an MSM of n/D = 2^15 points, c = 11; the local
     transforms run at 2^15 and 2^17 over the stacks' columns), and holds
     every montmul and NTT shape phases 5 and 9 did not have, and every
     commit batch of another size, against the plain versions
     (`phase_new_launch_shapes`). Then a one-rank NCCL group runs the
     primitives at D = 1, the card's tensors handed to NCCL. Any rank's
     failure fails the run;
 14. data-parallel proving (webauthn_halo2_tpu_torch/parallel/batch.py,
     the port of the JAX system's scripts/launch_multihost.py), untraced:
     four fresh ECDSA-P256 signatures at k=17 proved in this process by
     api.generate_proofs_batch with four fixed deterministic rngs, then two
     gloo ranks spawned on the one card (a new directory under build/,
     removed at the end; each rank's log there, shown if it fails), each
     loading phase 9's key file and proving its round-robin two of the
     same four with the same rngs through batch.prove_shard, the launch
     counters from zero: every index's bytes equal the one-process proof,
     the ranks' vk digests are one and the key's, every proof verifies
     and a flipped byte does not, rows 1-6 launched in each rank; rank 0
     holds every launch shape and commit batch the earlier phases did not
     check against the plain versions (`phase_new_launch_shapes`); each
     rank's and the one process's proofs/s and peak memory. A line says
     whether api.generate_proof(device="cuda:1") from this process
     (current device 0) gave phase 5's bytes, or that it was skipped for
     want of a second card;
 15. the ECDSA circuit of auto_params(k) across the reference's degree
     range (phase_degrees): k = 11, whose 5,832 constants do not fit the
     one constants column of 2^11 rows, so api.download_keys raises
     ValueError as the JAX package's keygen does, and the kernels at the
     launch shapes a k = 11 proof would have, on random inputs, against
     their plain versions; k = 13, the widest circuit the reference keys
     (balanced placement), keyed by api.download_keys into ./keys of a new
     directory under build/, served by the port's server (/prove,
     /verify), proved from the manifest with api.generate_proof,
     verified on both host paths, a flipped proof rejected, and proved
     again on the serial route, byte-equal; k = 19,
     the deepest, its SRS generated on the card, keyed, proved and
     verified on both host paths. Every SRS's monomial points are the
     committed k=17 SRS's first points. Each launch shape and commit batch
     new to the run goes through phase_new_launch_shapes; rows 1-6 are
     timed over each proof beside their bounds; a `degrees` JSON line;
 16. the operator's path, in a new directory under build/ (removed at the
     end): (a) scripts/deploy_suite_torch.py with the stub verifier, then
     with the GWC verifier's deploy code that phase 9's generate_verifier
     wrote and phase 9's GWC proof (handleOps succeeds, the counter reads
     1, the suite's deploys, deposit and createAccount at the stub run's
     gas), and with one byte of that proof flipped (exits nonzero, naming
     handleOps); (b) scripts/profile_torch_keygen.py at k=17 in two child
     processes with WH2_KEY_DIR and WH2_SRS_DIR set to new empty
     directories: the first generates and saves the SRS on the card, makes
     and saves the key, the second loads both; each proves phase 5's
     signature with phase 5's rng (phase 5's bytes, the vk of phase 4) and
     prints its step table (wall and device seconds, launches, peak
     memory); then this process's api.proving_key loads the key from
     WH2_KEY_DIR and proves phase 5's bytes; the first child's launch
     counts are the `startup` path's; each child records the field and
     shape of its montmul and NTT launches, and every shape the earlier
     phases 4, 5 and 9 did not check goes through phase_new_launch_shapes
     in its field; (c) scripts/gc_torch_builds.py: --dry-run keeps every library
     this process loaded and lists a stale library planted under a made-up
     digest; without --dry-run that library goes, and a new process loads
     every current library without building one;
 17. every kernel of a path launched during that path's run (each run with
     the counts from zero; the proof launched the interior and the combine
     once a batch, the scan's tile and join kernels once each a batch), and
     the serial bucket sum did not run on the v3 route, rows 1-6 ran on
     the GWC, ES256, server, batch, sharded, data-parallel, degrees and
     start-up paths (the sharded and data-parallel paths' counts are rank
     0's, the start-up path's its first child's), and the
     montmul on the SRS path; a `kernels`
     JSON line with launches, times, bounds, the plain versions' times,
     for the MSM kernels their times and bounds over the proof's batches
     (the combine's also per batch), and for rows 1-3 the proof's launch
     shapes; then the `es256`, `serving`, `sharded`, `data_parallel`,
     `degrees` and `operator` lines, and a line
     with the card's name and power limit, the verification times on both
     host paths, the untraced batch and ES256's windowed quotient.
"""
from __future__ import annotations

import contextlib
import hashlib
import json
import os
import random
import re
import shutil
import subprocess
import sys
import threading
import time

import torch

try:  # the ceilings and work counts: webauthn_halo2_tpu_torch/utils/roofline.py
    from webauthn_halo2_tpu_torch.utils import roofline as RL
except ImportError:  # main() fails with the reason
    RL = None


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


def _graph_ms(fn, calls: int = 200, replays: int = 50) -> float:
    """ms a call of `fn`, from a CUDA graph of `calls` calls replayed
    `replays` times: the host's cost of a launch does not enter, which
    matters for kernels of a few tens of microseconds."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / (calls * replays)


def _clocks_during(fn) -> tuple:
    """(ms a call by `_graph_ms`, median SM clock MHz, median power W), with
    nvidia-smi sampling the card every 50 ms meanwhile."""
    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw", "--format=csv,noheader,nounits",
         "-lms", "50"], stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        time.sleep(0.2)
        ms = _graph_ms(fn)
    finally:
        smi.terminate()
        out, _ = smi.communicate(timeout=30)
    samples = [tuple(float(v) for v in line.split(",")) for line in out.splitlines()
               if line.count(",") == 1]
    if not samples:
        return ms, None, None

    def median(vals):
        return sorted(vals)[len(vals) // 2]

    return ms, median([c for c, _ in samples]), median([p for _, p in samples])


def _montmul_edge_words(spec) -> list:
    """0, 1, 2, p - 1, p - 2, words just below p, R mod p and R^2 mod p, and
    values with all-ones or all-zero low words."""
    p = spec.p
    r = (1 << 256) % p
    return [0, 1, 2, p - 1, p - 2, p - 3, p - (1 << 32), p - (1 << 128) - 1,
            p - 1 - (p >> 1), r, r * r % p, (1 << 224) - 1, (1 << 253),
            p >> 1, (p >> 32) << 32]


def phase_montmul(dev, gen) -> dict:
    """Phase 2, row 1: the montmul kernel against its plain version, exact
    words: random words at the prover's column (2^17) and extended (2^19)
    widths; every pair of edge words in Fr and Fq; a broadcast (8, 1)
    operand on either side; strided slices of a stacked (8, 3, n) tensor;
    ragged sizes. Then its time at (8, 2^19), warm (the same operands every
    call, 48 MB, which nearly fit the 50 MB L2) and cold (four operand sets
    in turn, 192 MB), from CUDA graph replays (`timed_by`), with the SM
    clock and power draw read beside each."""
    from webauthn_halo2_tpu_torch.fields.limbs import FQ_SPEC, FR_SPEC
    from webauthn_halo2_tpu_torch.ops import modops as M

    def check(what, a, b, spec=FR_SPEC):
        err = _max_abs_err(M.montmul_cuda(spec, a, b), M.montmul_plain(spec, a, b))
        torch.cuda.synchronize()
        log(f"[kernels] montmul {what}: max_abs_err={err}")
        if err:
            fail(f"montmul kernel disagrees with its plain version: {what}")
        return err

    errs = []
    for logn in (17, 19):
        a = _rand_words(FR_SPEC, (1 << logn,), gen, dev)
        b = _rand_words(FR_SPEC, (1 << logn,), gen, dev)
        errs.append(check(f"(8, 2^{logn}) random", a, b))
    for spec in (FR_SPEC, FQ_SPEC):
        vals = _montmul_edge_words(spec)
        pairs = [(x, y) for x in vals for y in vals]
        ea = torch.as_tensor(spec.encode([x for x, _ in pairs], mont=False)).to(dev)
        eb = torch.as_tensor(spec.encode([y for _, y in pairs], mont=False)).to(dev)
        errs.append(check(f"{spec.name} edge words, {len(pairs)} pairs", ea, eb, spec))
    n = 1 << 17
    a = _rand_words(FR_SPEC, (n,), gen, dev)
    c = _rand_words(FR_SPEC, (1,), gen, dev)
    errs.append(check("(8, 1) x (8, 2^17)", c, a))
    errs.append(check("(8, 2^17) x (8, 1)", a, c))
    stack = _rand_words(FR_SPEC, (3, n), gen, dev)
    errs.append(check("slices [:, 1] x [:, 2] of a stacked (8, 3, 2^17)",
                      stack[:, 1], stack[:, 2]))
    errs.append(check("slice [:, 2] of a stacked (8, 3, 2^17) x (8, 1)", stack[:, 2], c))
    for extra in (3, 2):
        r = _rand_words(FR_SPEC, (2, n + extra), gen, dev)
        errs.append(check(f"ragged (8, 2^17 + {extra})", r[:, 0], r[:, 1]))

    logn = 19
    n = 1 << logn
    sets = [(_rand_words(FR_SPEC, (n,), gen, dev), _rand_words(FR_SPEC, (n,), gen, dev))
            for _ in range(4)]
    a, b = sets[0]
    warm = _clocks_during(lambda: M.montmul_cuda(FR_SPEC, a, b))
    turn = [0]

    def cold():
        x, y = sets[turn[0] % len(sets)]
        turn[0] += 1
        return M.montmul_cuda(FR_SPEC, x, y)

    cold_t = _clocks_during(cold)
    log(f"[kernels] montmul (8, 2^{logn}): warm {warm[0]:.4f} ms "
        f"(SM {warm[1]} MHz, {warm[2]} W), cold {cold_t[0]:.4f} ms "
        f"(SM {cold_t[1]} MHz, {cold_t[2]} W)")
    return dict(err=max(errs), shape=f"(8, 2^{logn})", ms=warm[0], ms_cold=cold_t[0],
                timed_by="cuda_graph", clocks=dict(
                    warm_sm_mhz=warm[1], warm_power_w=warm[2],
                    cold_sm_mhz=cold_t[1], cold_power_w=cold_t[2]),
                plain_ms=_events_ms(lambda: M.montmul_plain(FR_SPEC, a, b), 3),
                **RL.montmul_work(n))


def phase_kernels(dev, gen):
    """Phase 2: each kernel against its plain version, exact words."""
    from webauthn_halo2_tpu_torch.fields.limbs import FR_SPEC
    from webauthn_halo2_tpu_torch.ops import ntt as N

    rows = {"montmul": phase_montmul(dev, gen)}

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

    # stage A at every launch shape of the proof's transforms, with the
    # tiles the schedule gives it; timed at the quotient's conversion
    # shape, a stack of 19 columns on the extended domain 2^19 (last)
    errs = []
    for B, ek in ((1, 17), (1, 19), (19, 17), (19, 19)):
        n = 1 << ek
        x = _rand_words(FR_SPEC, (B, n), gen, dev)
        tw = N._twiddles_dev(ek, False, dev)
        log_t, cq = N.stage_a_schedule(B, ek)
        got = N.stage_a(FR_SPEC, x, tw, log_t, cq)
        want = N.stage_a_plain(FR_SPEC, x, tw, log_t)
        torch.cuda.synchronize()
        errs.append(_max_abs_err(got, want))
        shape = f"(8, {B}, 2^{ek}), T=2^{log_t} (blocks of 2^{log_t - cq}, clusters of {1 << cq})"
        log(f"[kernels] stage A {shape}: max_abs_err={errs[-1]}")
        if errs[-1]:
            fail("NTT stage A disagrees with its plain version")
    rows["ntt_stage_a"] = dict(
        err=max(errs), shape=shape,
        ms=_events_ms(lambda: N.stage_a(FR_SPEC, x, tw, log_t, cq), 10),
        plain_ms=_events_ms(lambda: N.stage_a_plain(FR_SPEC, x, tw, log_t), 1),
        **RL.stage_a_work(B, n, log_t))
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
        **RL.stage_b_work(B, n, s))
    return rows


def _pt_err(a, b) -> int:
    return max(_max_abs_err(x, y) for x, y in zip(a, b))


def _least_work(sdig, bnd, seg, buckets, n: int, lanes: int) -> dict:
    """(bytes, operations) of the least work each v3 MSM kernel needs on
    this run's data, not what the kernels happen to do; digit 0 contributes
    nothing to a window sum, so its points are neither read nor added, and
    an add with an infinite operand is a select, no multiply."""
    from webauthn_halo2_tpu_torch.ops import msm as MS

    R = sdig.shape[0]
    nb = buckets.x.shape[-1]
    pt_bytes = 3 * RL.ELEM_BYTES
    # Interior: a madd where a step continues its run, digit != 0 only;
    # every digit read, the index and point of each nonzero step.
    nz = sdig != 0
    madds = int(((sdig[:, 1:] == sdig[:, :-1]) & nz[:, 1:]).sum().item())
    nz_steps = int(nz.sum().item())
    # Scan: per segment with digit != 0, one add per finite fragment beyond
    # its first finite one; the nonzero fragments read, each segment's
    # total written.
    m2 = seg.shape[1]
    opens = torch.ones_like(seg, dtype=torch.bool)
    opens[:, 1:] = seg[:, 1:] != seg[:, :-1]
    live = seg != 0
    finite = live & (bnd.z != 0).any(dim=0)
    gid = (torch.cumsum(opens.reshape(-1).to(torch.int64), 0) - 1)[finite.reshape(-1)]
    scan_adds = int(finite.sum().item()) - int(torch.unique(gid).numel())
    tails = int(MS._tail_mask(seg).sum().item())
    # Combine: sum_b b B_b by running sums, per row up to its top non-empty
    # bucket t: S_b = S_{b+1} + B_b (an add per non-empty bucket in 1..t
    # beyond the first) and sum_{b=1..t} S_b (t - 1 adds); no doublings.
    filled = (buckets.z != 0).any(dim=0)
    filled[:, 0] = False
    top = (filled * torch.arange(nb, device=filled.device)).max(dim=-1).values
    comb_adds = int(((filled.sum(dim=-1) - 1).clamp(min=0) + (top - 1).clamp(min=0)).sum().item())
    return {
        "msm_interior": dict(
            bytes=2 * RL.ELEM_BYTES * n + 4 * R * n + (4 + 2 * RL.ELEM_BYTES) * nz_steps
            + pt_bytes * R * (nb + 2 * lanes) + 8 * R * lanes,
            ops=RL.IMAD_PER_MADD * madds, madds=madds),
        "msm_scan": dict(
            bytes=pt_bytes * int(live.sum().item()) + 4 * R * m2 + pt_bytes * tails,
            ops=RL.IMAD_PER_JADD * scan_adds, adds=scan_adds,
            segments=int(opens.sum().item())),
        "msm_combine": dict(bytes=pt_bytes * R * (nb + 1), ops=RL.IMAD_PER_JADD * comb_adds),
    }


def _msm_stages(curve, pts, scalars, c: int, lanes: int, timed: bool = False,
                check: bool = True, iters: int = 5, check_combine: bool | None = None):
    """The v3 pipeline's three kernels on one batch, each (with `check`)
    against its plain version on the same inputs: exact words, the scan's
    at the segment tails, the only positions it defines. Returns a row per
    kernel (with `timed`, its ms a launch and its least work), the buckets
    after the scatter, and the window sums. `check_combine` (default:
    `check`) checks the combine alone."""
    from webauthn_halo2_tpu_torch.fields.limbs import FR_SPEC
    from webauthn_halo2_tpu_torch.ops import modops as M
    from webauthn_halo2_tpu_torch.ops import msm as MS
    from webauthn_halo2_tpu_torch.ops import msm_fused as MF

    _, B, n = scalars.shape
    nb = 1 << c
    digits = MS.scalar_digits(M.from_mont(FR_SPEC, scalars), c)
    nwin = digits.shape[0]
    R = nwin * B
    sdig, order = MF.sorted_stream(digits.reshape(R, n), lanes)
    S = n // lanes
    px, py = pts.x.contiguous(), pts.y.contiguous()
    args = (curve, px, py, sdig, order, nb)
    rows = {k: dict(err=None) for k in ("msm_interior", "msm_scan", "msm_combine")}
    buckets, bnd, seg = MF.interior_cuda(*args)
    if check:
        want = MF.interior_plain(*args)
        rows["msm_interior"]["err"] = max(_pt_err(buckets, want[0]), _pt_err(bnd, want[1]),
                                          _max_abs_err(seg, want[2]))
    merged = MF.scan_cuda(curve, bnd, seg)
    if check:
        tails = MS._tail_mask(seg)
        rows["msm_scan"]["err"] = _pt_err(*(_pts_at(p, tails) for p in (
            merged, MF.scan_plain(curve, bnd, seg))))
    MF.scatter_tails(buckets, merged, seg)
    wsums = MF.combine_cuda(curve, buckets)
    if check if check_combine is None else check_combine:
        rows["msm_combine"]["err"] = _pt_err(wsums, MF.combine_plain(curve, buckets))
    torch.cuda.synchronize()
    if not timed:
        return rows, buckets, wsums
    work = _least_work(sdig, bnd, seg, buckets, n, lanes)
    G, m = MF._combine_shape(nb)
    shape = f"n=2^{n.bit_length() - 1}, c={c}, R={R} ({nwin}x{B}), K={lanes}, S={S}"
    calls = {"msm_interior": lambda: MF.interior_cuda(*args),
             "msm_scan": lambda: MF.scan_cuda(curve, bnd, seg),
             "msm_combine": lambda: MF.combine_cuda(curve, buckets)}
    plains = {"msm_interior": lambda: MF.interior_plain(*args),
              "msm_scan": lambda: MF.scan_plain(curve, bnd, seg),
              "msm_combine": lambda: MF.combine_plain(curve, buckets)}
    P, q = MF._row_shape(G)
    shapes = {"msm_interior": f"{shape}, {work['msm_interior']['madds']} nonzero madds",
              "msm_scan": f"R={R}, {seg.shape[1]} fragments, {work['msm_scan']['segments']} "
                          f"segments, {work['msm_scan']['adds']} adds of two finite points",
              "msm_combine": f"R={R}, nb={nb}, m={m}, G={G}, P={P}, q={q}"}
    for name, row in rows.items():
        row.update(shape=shapes[name], bytes=work[name]["bytes"], ops=work[name]["ops"],
                   ms=_events_ms(calls[name], iters * (2 if name == "msm_scan" else 1)))
        if row["err"] is not None:
            row["plain_ms"] = _events_ms(plains[name], 1)
    return rows, buckets, wsums


def _pts_at(p, mask):
    """The points of a JPoint (8, *batch) where `mask` (batch) is true."""
    from webauthn_halo2_tpu_torch.ops import ec as E

    return E.JPoint(*(t[:, mask] for t in p))


def _ptxas_report(text: str) -> dict:
    """Registers, stack frame and spill bytes of each kernel in an
    `nvcc -Xptxas -v` report."""
    entries, props, entry, fn = {}, {}, None, None
    for line in text.splitlines():
        if m := re.search(r"Compiling entry function '(\w+)'", line):
            entry = m.group(1)
        elif m := re.search(r"Function properties for (\w+)", line):
            fn = m.group(1)
        elif m := re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                            r"(\d+) bytes spill loads", line):
            props[fn] = tuple(int(v) for v in m.groups())
        elif (m := re.search(r"Used (\d+) registers", line)) and entry is not None:
            entries[entry] = int(m.group(1))

    def name(mangled):  # _Z<len><name>...
        m = re.match(r"_Z(\d+)", mangled)
        return mangled[m.end():m.end() + int(m.group(1))] if m else mangled

    return {name(f): dict(registers=r, stack=props.get(f, (0,))[0],
                          spill_stores=props.get(f, (0, 0))[1],
                          spill_loads=props.get(f, (0, 0, 0))[2])
            for f, r in entries.items()}


def _tau() -> int:
    """tau of the committed dev SRS (plonk/srs: seed b"dev")."""
    from webauthn_halo2_tpu_torch.fields.constants import BN254_FR

    h = hashlib.blake2b(b"webauthn-halo2-tpu/dev-srs/dev", digest_size=64)
    return int.from_bytes(h.digest(), "little") % BN254_FR


def _oracle(ks: list) -> tuple:
    """sum_i k_i [tau^i] G = (sum_i k_i tau^i) G on the host."""
    from webauthn_halo2_tpu_torch.fields.constants import BN254_FR
    from webauthn_halo2_tpu_torch.fields.ref_curve import BN254_G1_CURVE as G

    tau, s, t = _tau(), 0, 1
    for k in ks:
        s = (s + k * t) % BN254_FR
        t = t * tau % BN254_FR
    return G.mul(s, G.g)


def phase_msm_kernels(dev, gen, srs, batch: int):
    """Phase 2, the v3 MSM kernels: at the main path's shapes (the SRS's
    n = 2^17 Lagrange bases, c = 13, 20 windows x `batch` rows, random
    scalars), then small degenerate cases at n = 2^12, each also against
    the host oracle, and cases with long nonzero segments at n = 2^17, each
    also against the host oracle and the serial engine."""
    from webauthn_halo2_tpu_torch.fields.constants import BN254_FR
    from webauthn_halo2_tpu_torch.fields.limbs import FR_SPEC
    from webauthn_halo2_tpu_torch.ops import ec as E
    from webauthn_halo2_tpu_torch.ops import msm as MS
    from webauthn_halo2_tpu_torch.ops import msm_fused as MF

    curve = E.BN254_CURVE
    n = srs.n
    c = MS._default_c(n)
    scal = _rand_words(FR_SPEC, (batch, n), gen, dev)
    rows, _, _ = _msm_stages(curve, srs.g_lag, scal, c, MF.lanes_for(n), timed=True)
    for name, row in rows.items():
        log(f"[kernels] {name} {row['shape']}: max_abs_err={row['err']}")
        if row["err"]:
            fail(f"{name} disagrees with its plain version at the main path's shape")
    log(f"[kernels] point-major copy of the bases, made at each interior launch "
        f"(n=2^{n.bit_length() - 1}): "
        f"{_events_ms(lambda: MF.point_major(srs.g_lag.x, srs.g_lag.y), 20):.4f} ms")

    # degenerate cases on the first 2^12 monomial bases
    ns = 1 << 12
    lanes = MF.lanes_for(ns)
    S = ns // lanes
    opens = [2 * (i // S) + (0 if i % S == 0 else 1) for i in range(ns)]
    cases = {
        "all equal": ([3] * ns, 13),
        "zeros": ([0] * ns, 13),
        "0, 1, r-1": ([(0, 1, BN254_FR - 1)[i % 3] for i in range(ns)], 13),
        "digits that only open a lane": (opens, 13),
        "0, 1, r-1 at c=7 (m=1)": ([(0, 1, BN254_FR - 1)[i % 3] for i in range(ns)], 7),
    }
    pts = E.JPoint(*(t[:, :ns].contiguous() for t in srs.g_mono))
    for name, (ks, cc) in cases.items():
        sc = torch.as_tensor(FR_SPEC.encode(ks)).to(dev)[:, None, :]
        crow, _, wsums = _msm_stages(curve, pts, sc, cc, lanes)
        got = MS._host_horner(curve, E.JPoint(*(t[:, :, None] for t in wsums)), cc)[0]
        errs = {k: v["err"] for k, v in crow.items()}
        ok = got == _oracle(ks) and MF.msm(curve, pts, sc[:, 0], cc) == got
        log(f"[kernels] degenerate '{name}' n=2^12 c={cc}: max_abs_err={errs} oracle={ok}")
        if any(errs.values()) or not ok:
            fail(f"v3 MSM kernels wrong on the degenerate case '{name}'")

    # long nonzero segments at the main path's n, as the circuit's columns
    # hold them, in one batch: segments that span every scan tile of a row
    rng = random.Random(11)
    cases = {"all ones": [1] * n,
             "0/1 selectors": [rng.randrange(2) for _ in range(n)],
             "16-bit values": [rng.randrange(1 << 16) for _ in range(n)],
             "zeros, 8 random tail rows": [0] * (n - 8) + [rng.randrange(BN254_FR) for _ in range(8)]}
    sc = torch.stack([torch.as_tensor(FR_SPEC.encode(ks)) for ks in cases.values()], dim=1).to(dev)
    crow, _, wsums = _msm_stages(curve, srs.g_mono, sc, c, MF.lanes_for(n))
    got = MS._host_horner(curve, E.JPoint(*(t.reshape(8, -1, len(cases)) for t in wsums)), c)
    serial = MS.msm_batch(curve, srs.g_mono, sc, c)
    errs = {k: v["err"] for k, v in crow.items()}
    for (name, ks), g, sv in zip(cases.items(), got, serial):
        ok = g == _oracle(ks) == sv
        log(f"[kernels] degenerate '{name}' n=2^{n.bit_length() - 1} c={c}: max_abs_err={errs} "
            f"oracle == serial engine == v3: {ok}")
        if any(errs.values()) or not ok:
            fail(f"v3 MSM kernels wrong on the degenerate case '{name}' at n={n}")
    return rows


def phase_proof_batches(srs, batches: list, lanes: int):
    """After the main path: the v3 kernels on the proof's own commit
    batches (advice, lookup, grand products, quotient pieces, SHPLONK h and
    W), each timed with its least work; the interior and the scan (and the
    combine) checked against their plain versions on the advice batch and
    the last (random-scalar) batch, the combine on every batch; the interior
    also at the v1 route's launches, one MSM (20 rows) at a time. Returns
    per-kernel sums over the proof, (ms, bound ms), and each batch's rows."""
    from webauthn_halo2_tpu_torch.fields.limbs import FR_SPEC
    from webauthn_halo2_tpu_torch.ops import ec as E
    from webauthn_halo2_tpu_torch.ops import modops as M
    from webauthn_halo2_tpu_torch.ops import msm as MS
    from webauthn_halo2_tpu_torch.ops import msm_fused as MF

    curve = E.BN254_CURVE
    n = srs.n
    c = MS._default_c(n)
    sums = {k: [0.0, 0.0] for k in ("msm_interior", "msm_scan", "msm_combine", "msm_interior_v1")}
    per_batch = []
    for i, (points, scalars) in enumerate(batches):
        check = i in (0, len(batches) - 1)
        rows, _, _ = _msm_stages(curve, points, scalars, c, lanes, timed=True, check=check,
                                 iters=3, check_combine=True)
        per_batch.append({k: dict(ms=r["ms"], bound_ms=RL.bound_ms(r)[0], err=r["err"],
                                  shape=r["shape"]) for k, r in rows.items()})
        for name, row in rows.items():
            sums[name][0] += row["ms"]
            sums[name][1] += RL.bound_ms(row)[0]
            if row["err"]:
                fail(f"{name} disagrees with its plain version on the proof's batch {i}")
        # row 7: the same interior work, one MSM at a time
        B = scalars.shape[1]
        digits = MS.scalar_digits(M.from_mont(FR_SPEC, scalars), c)
        px, py = points.x.contiguous(), points.y.contiguous()
        for b in range(B):
            sdig, order = MF.sorted_stream(digits[:, b], lanes)
            sums["msm_interior_v1"][0] += _events_ms(
                lambda: MF.interior_cuda(curve, px, py, sdig, order, 1 << c), 3)
        sums["msm_interior_v1"][1] += RL.bound_ms(rows["msm_interior"])[0]
        log(f"[proof batches] batch {i}: B={B} "
            + "; ".join(f"{k} {r['shape']}: {r['ms']:.4f} ms, bound {RL.bound_ms(r)[0]:.4f} ms"
                        + (f", max_abs_err={r['err']}" if r["err"] is not None else "")
                        for k, r in rows.items()))
    log("[proof batches] over the proof: " + json.dumps(
        {k: {"ms": v[0], "bound_ms": v[1]} for k, v in sums.items()}))
    return sums, per_batch


def phase_interior_v1(dev, gen, srs):
    """Phase 2, row 7: the interior kernel at the v1 route's launch shape,
    one MSM of 20 window rows (the v1 driver runs MSMs one at a time), with
    the scan and combine checked at that shape too."""
    from webauthn_halo2_tpu_torch.fields.limbs import FR_SPEC
    from webauthn_halo2_tpu_torch.ops import ec as E
    from webauthn_halo2_tpu_torch.ops import msm as MS
    from webauthn_halo2_tpu_torch.ops import msm_fused as MF

    n = srs.n
    scal = _rand_words(FR_SPEC, (1, n), gen, dev)
    rows, _, _ = _msm_stages(E.BN254_CURVE, srs.g_lag, scal, MS._default_c(n),
                             MF.lanes_for(n), timed=True)
    for name, row in rows.items():
        log(f"[kernels] {name} (v1 shape) {row['shape']}: max_abs_err={row['err']} "
            f"{row['ms']:.3f} ms")
        if row["err"]:
            fail(f"{name} disagrees with its plain version at the v1 route's shape")
    return rows["msm_interior"]


def phase_combine_sparse(dev, srs):
    """Phase 2, row 6: the combine kernels on buckets that are mostly empty
    (about 1 in 100 filled), where running and suffix sums repeat over long
    empty ranges, at the v1 route's R = 20 rows of 8192 buckets; row 0
    holds one non-empty bucket and row 1 none. Each bucket is the sum of
    two SRS points, no point in two buckets. Checked against the plain
    version (words) and the host sum sum_b b B_b (affine)."""
    from webauthn_halo2_tpu_torch.fields.ref_curve import BN254_G1_CURVE as G
    from webauthn_halo2_tpu_torch.ops import ec as E
    from webauthn_halo2_tpu_torch.ops import msm as MS
    from webauthn_halo2_tpu_torch.ops import msm_fused as MF

    curve = E.BN254_CURVE
    R, nb = 20, 1 << MS._default_c(srs.n)
    cpu = torch.Generator().manual_seed(23)
    fill = torch.rand(R, nb, generator=cpu) < 0.01
    fill[:, 0] = False
    fill[0] = False
    fill[0, nb - 1 - 1234] = True
    fill[1] = False
    k = int(fill.sum())
    perm = torch.randperm(srs.n, generator=cpu)[:2 * k].to(dev)
    sums = E.add_unsafe(curve, *(E.JPoint(*(c[:, i] for c in srs.g_lag))
                                 for i in (perm[:k], perm[k:])))
    inf = E.infinity((R, nb), curve, dev)
    buckets = E.JPoint(*(c.clone().contiguous() for c in inf))
    at = fill.to(dev)
    for b, v in zip(buckets, sums):
        b[:, at] = v
    got = MF.combine_cuda(curve, buckets)
    err = _pt_err(got, MF.combine_plain(curve, buckets))
    aff = E.to_affine_ints(curve, sums)
    rows, cols = torch.nonzero(fill, as_tuple=True)
    host = [None] * R
    for r, col, p in zip(rows.tolist(), cols.tolist(), aff):
        host[r] = G.add(host[r], G.mul(col, p))
    ok = E.to_affine_ints(curve, got) == host
    log(f"[kernels] msm_combine on mostly empty buckets (R={R}, nb={nb}, {k} filled; "
        f"row 0 one bucket, row 1 none): max_abs_err={err} host sum: {ok}")
    if err or not ok:
        fail("the combine kernels are wrong on mostly empty buckets")


def _launch_recorder(module, name: str, key, seen: list):
    """Wrap module.name so that each call first appends key(*args) to seen;
    returns a function that puts the original back."""
    orig = getattr(module, name)

    def wrapper(*args, **kw):
        seen.append(key(*args, **kw))
        return orig(*args, **kw)

    setattr(module, name, wrapper)
    return lambda: setattr(module, name, orig)


def _record_launch_shapes(shapes: dict, by_field: bool = False):
    """Record the shape of every montmul, NTT stage A and stage B launch into
    shapes["montmul"], ["ntt_stage_a"], ["ntt_stage_b"], each shape after
    its field's name when `by_field`; returns a function that stops it."""
    from webauthn_halo2_tpu_torch.ops import modops as M
    from webauthn_halo2_tpu_torch.ops import ntt as N

    def keyed(key):
        return (lambda spec, *a, **kw: (spec.name, *key(spec, *a, **kw))) if by_field else key

    restore = [
        _launch_recorder(M, "montmul_cuda", keyed(lambda spec, a, b, *_, **__: (
            max(a[0].numel(), b[0].numel(), torch.broadcast_shapes(a.shape, b.shape)[1:].numel()),
            a.numel() == 8, b.numel() == 8)), shapes["montmul"]),
        _launch_recorder(N, "stage_a", keyed(lambda spec, x, tw, log_t, cq=0: (
            x.shape[1], x.shape[2], log_t, cq)), shapes["ntt_stage_a"]),
        _launch_recorder(N, "stage_b", keyed(lambda spec, x, tw, s: (
            x.shape[1], x.shape[2], s)), shapes["ntt_stage_b"])]

    def stop():
        for undo in restore:
            undo()

    return stop


def phase_launch_shapes(dev, gen, shapes: dict, srs=None) -> dict:
    """Rows 1-3 and 8 on a proof's own launches: for each launch shape the
    proof gave the montmul and NTT kernels (the main path's) or the fused
    EC add (the serial and v1 routes'), recorded on its way, its count, its
    bound, and its time replayed on random operands (CUDA graph replays;
    the EC add on chip_smoke's operands, about a tenth infinite on each
    side); summed over the proof. Returns per kernel (ms, bound ms,
    histogram)."""
    from collections import Counter

    from webauthn_halo2_tpu_torch.fields.limbs import FR_SPEC
    from webauthn_halo2_tpu_torch.ops import ec as E
    from webauthn_halo2_tpu_torch.ops import modops as M
    from webauthn_halo2_tpu_torch.ops import ntt as N

    out = {}
    for name, seen in shapes.items():
        hist = Counter(seen)
        ms_sum = bound_sum = 0.0
        table = []
        for key, count in sorted(hist.items()):
            if name == "montmul":
                n, a_bc, b_bc = key
                a = _rand_words(FR_SPEC, (1 if a_bc else n,), gen, dev)
                b = _rand_words(FR_SPEC, (1 if b_bc else n,), gen, dev)
                fn = lambda: M.montmul_cuda(FR_SPEC, a, b)  # noqa: E731
                work = RL.montmul_work(n, 1 if a_bc else n, 1 if b_bc else n)
            elif name == "ec_add_unsafe":
                rows_, lanes = key
                p, q, adds = _ec_operands(srs, gen, dev, rows_, lanes)
                fn = lambda: E.add_unsafe_cuda(E.BN254_CURVE, p, q)  # noqa: E731
                work = RL.ec_add_work(rows_, lanes, adds)
            else:
                B, n, s = key[:3]
                x = _rand_words(FR_SPEC, (B, n), gen, dev)
                tw = N._twiddles_dev(n.bit_length() - 1, False, dev)
                if name == "ntt_stage_a":
                    fn = lambda: N.stage_a(FR_SPEC, x, tw, s, key[3])  # noqa: E731
                    work = RL.stage_a_work(B, n, s)
                else:
                    fn = lambda: N.stage_b(FR_SPEC, x, tw, s)  # noqa: E731
                    work = RL.stage_b_work(B, n, s)
            ms = _graph_ms(fn, calls=10, replays=5)
            bound = RL.bound_ms(work)[0]
            ms_sum += count * ms
            bound_sum += count * bound
            table.append(dict(shape=list(key), launches=count, ms=ms, bound_ms=bound))
            torch.cuda.empty_cache()
        out[name] = (ms_sum, bound_sum, table)
        log(f"[proof launches] {name}: {len(seen)} launches in {len(hist)} shapes, replayed "
            f"{ms_sum:.4f} ms against a bound of {bound_sum:.4f} ms; "
            + json.dumps(table))
    return out


def _ec_operands(srs, gen, dev, nrows: int, lanes: int):
    """Operands of the fused EC add at (8, nrows, lanes): Jacobian sums of
    two SRS points plus affine SRS points, about a tenth infinite on each
    side. Returns (p, q, number of adds of two finite points)."""
    from webauthn_halo2_tpu_torch.ops import ec as E

    curve = E.BN254_CURVE
    n = nrows * lanes
    N = srs.n
    i0 = torch.randint(0, N, (n,), generator=gen, device=dev)
    i1 = (i0 + 1 + torch.randint(0, N - 1, (n,), generator=gen, device=dev)) % N
    i2 = torch.randint(0, N, (n,), generator=gen, device=dev)

    def srs_pts(i):
        return E.JPoint(*(c[:, i] for c in srs.g_lag))

    p = E.add_unsafe(curve, srs_pts(i0), srs_pts(i1))
    q = srs_pts(i2)
    inf_p = torch.rand(n, generator=gen, device=dev) < 0.1
    inf_q = torch.rand(n, generator=gen, device=dev) < 0.1

    def shaped(pt, inf):
        z = torch.where(inf[None], 0, pt.z)
        return E.JPoint(*(c.reshape(8, nrows, lanes) for c in (pt.x, pt.y, z)))

    return shaped(p, inf_p), shaped(q, inf_q), int((~inf_p & ~inf_q).sum().item())


def phase_ec_add(dev, gen, srs, nrows: int, lanes: int):
    """Phase 2, row 8: the fused EC add against `add_unsafe` at the serial
    route's grow shape (8, R, K) and its boundary scan's (8, R, 2K), with
    infinities on either side; timed at the grow shape."""
    from webauthn_halo2_tpu_torch.ops import ec as E

    curve = E.BN254_CURVE
    errs = []
    for width in (2 * lanes, lanes):
        p, q, adds = _ec_operands(srs, gen, dev, nrows, width)
        got = E.add_unsafe_cuda(curve, p, q)
        want = E.add_unsafe(curve, p, q)
        torch.cuda.synchronize()
        errs.append(_pt_err(got, want))
        n_inf = [int((~(c.z != 0).any(dim=0)).sum()) for c in (p, q)]
        shape = (f"(8, {nrows}, {width}), {n_inf[0]} + {n_inf[1]} "
                 f"infinite operands, {adds} adds")
        log(f"[kernels] ec_add_unsafe {shape}: max_abs_err={errs[-1]}")
        if errs[-1]:
            fail("the fused EC add disagrees with add_unsafe")
    return dict(err=max(errs), shape=shape,
                ms=_events_ms(lambda: E.add_unsafe_cuda(curve, p, q), 20),
                plain_ms=_events_ms(lambda: E.add_unsafe(curve, p, q), 3),
                **RL.ec_add_work(nrows, lanes, adds))


def phase_mxu(dev, gen, logn: int = 19):
    """Phase 2, row 9: one m16n8k32 u8 tile against a host product, then
    the int8 tensor-core montmul, driven through its entry point with the
    count from zero and held against its plain version and the montmul
    kernel, in Fr and Fq, the edge words' pairs first: at (8, 2^logn) (more
    passes of the persistent tile loop than one), (8, 2^12), a ragged
    (8, 2^12 + 7) (a partial last tile) and (8, 16) (fewer tiles than
    warps). Then its time at (8, 2^logn) Fr
    from CUDA graph replays, with the SM clock and power draw, beside the
    montmul kernel's. Returns (row, launches)."""
    from webauthn_halo2_tpu_torch.fields.limbs import FQ_SPEC, FR_SPEC
    from webauthn_halo2_tpu_torch.ops import modops as M
    from webauthn_halo2_tpu_torch.ops import mxu_mod as X

    A = torch.randint(0, 256, (16, 32), generator=gen, device=dev).to(torch.uint8)
    B = torch.randint(0, 256, (8, 32), generator=gen, device=dev).to(torch.uint8)
    C = X.mma_tile(A, B)
    tile_err = _max_abs_err(C.cpu(), A.cpu().long() @ B.cpu().long().T)
    log(f"[kernels] mma.sync m16n8k32 u8 tile against a host product: max_abs_err={tile_err}")
    if tile_err:
        fail("the int8 mma tile disagrees with a host product")

    n = 1 << logn
    errs, launches = [], 0
    for spec, m in ((FQ_SPEC, 1 << 12), (FQ_SPEC, n), (FR_SPEC, n), (FR_SPEC, (1 << 12) + 7),
                    (FQ_SPEC, (1 << 12) + 7), (FR_SPEC, 16), (FQ_SPEC, 16)):
        a = _rand_words(spec, (m,), gen, dev)
        b = _rand_words(spec, (m,), gen, dev)
        p = spec.p
        edge = [0, 1, 2, p - 2, p - 1]
        pairs = [(x, y) for x in edge for y in edge][:m]
        a[:, :len(pairs)] = torch.as_tensor(spec.encode([x for x, _ in pairs], mont=False)).to(dev)
        b[:, :len(pairs)] = torch.as_tensor(spec.encode([y for _, y in pairs], mont=False)).to(dev)
        what = f"{spec.name} (8, {m}), {len(pairs)} edge pairs"
        X.LAUNCHES["mxu_montmul"] = 0
        got = X.mxu_montmul_rows(spec, a, b)
        launches = X.LAUNCHES["mxu_montmul"]
        err = max(_max_abs_err(got, X.mxu_montmul_rows_plain(spec, a, b)),
                  _max_abs_err(got, M.montmul_cuda(spec, a, b)))
        torch.cuda.synchronize()
        errs.append(err)
        log(f"[kernels] mxu_montmul {what}: max_abs_err={err} against its plain version "
            f"and the montmul kernel")
        if err:
            fail(f"the int8 montmul disagrees ({what})")
        if m == n and spec is FR_SPEC:
            timed = (a, b)
    a, b = timed
    ms, mhz, watts = _clocks_during(lambda: X.mxu_montmul_rows_cuda(FR_SPEC, a, b))
    mm_ms = _graph_ms(lambda: M.montmul_cuda(FR_SPEC, a, b))
    row = dict(err=max(errs), shape=f"(8, 2^{logn}), Fr, {X.INT8_MACS} int8 MACs and "
               f"{X.GLUE_OPS_TOTAL} 32-bit operations a multiply (the kernel adds "
               f"{X.DESIGN_OPS_TOTAL})", ms=ms, timed_by="cuda_graph",
               clocks=dict(sm_mhz=mhz, power_w=watts),
               plain_ms=_events_ms(lambda: X.mxu_montmul_rows_plain(FR_SPEC, a, b), 2),
               bytes=3 * RL.ELEM_BYTES * n, ops=2 * X.INT8_MACS * n, rate=RL.INT8_OPS_PER_S,
               glue_ops=X.GLUE_OPS_TOTAL * n)
    terms = RL.bound_terms(row)
    row["bound_terms_ms"] = terms
    log(f"[kernels] mxu_montmul (8, 2^{logn}): {ms:.4f} ms (SM {mhz} MHz, {watts} W) against "
        f"the montmul kernel's {mm_ms:.4f} ms, both from CUDA graph replays; bound "
        f"{json.dumps(terms)} ms")
    return row, launches


def phase_msm_batch(dev, gen, srs, batch: int):
    """Phase 3: a full k=17 batch through msm_fused on the card equals the
    serial Pippenger on the card and the host oracle."""
    from webauthn_halo2_tpu_torch.fields.limbs import FR_SPEC
    from webauthn_halo2_tpu_torch.ops import ec as E
    from webauthn_halo2_tpu_torch.ops import msm as MS
    from webauthn_halo2_tpu_torch.ops import msm_fused as MF
    from webauthn_halo2_tpu_torch.ops import msm_v1 as MV

    curve = E.BN254_CURVE
    scal = _rand_words(FR_SPEC, (batch, srs.n), gen, dev)
    t0 = time.time()
    fused = MF.msm_batch(curve, srs.g_mono, scal)
    t_fused = time.time() - t0
    t0 = time.time()
    serial = MS.msm_batch(curve, srs.g_mono, scal)
    t_serial = time.time() - t0
    ks = FR_SPEC.decode(scal.cpu().numpy())
    n = srs.n
    oracle = [_oracle(ks[b * n:(b + 1) * n]) for b in range(batch)]
    log(f"[msm] k=17 batch of {batch}: v3 pipeline {t_fused:.2f}s, serial "
        f"{t_serial:.2f}s; v3 == serial: {fused == serial}; v3 == oracle: "
        f"{fused == oracle}")
    if fused != serial or fused != oracle:
        fail("the v3 MSM pipeline disagrees with the serial Pippenger or the oracle")
    nv1 = 3
    t0 = time.time()
    v1 = MV.msm_batch(curve, srs.g_mono, scal[:, :nv1])
    log(f"[msm] k=17 batch of {nv1} through the v1 driver: {time.time() - t0:.2f}s; "
        f"v1 == v3 == oracle: {v1 == fused[:nv1] == oracle[:nv1]}")
    if v1 != fused[:nv1] or v1 != oracle[:nv1]:
        fail("the v1 MSM driver disagrees with the v3 pipeline or the oracle")


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


def _signed_message() -> tuple:
    """The fixed ECDSA-P256 signature the smoke run proves: r, s, the public
    key's x and y and the message, as 32-byte little-endian strings, the
    arguments of api.generate_proof."""
    from webauthn_halo2_tpu_torch.fields.ref_curve import (P256_CURVE, ecdsa_keygen,
                                                           ecdsa_sign)

    sk, pub = ecdsa_keygen(rng=_Seeded(2024))
    m = _Seeded(4096).randbelow(P256_CURVE.n)
    r, s = ecdsa_sign(m, sk, k=1 + _Seeded(8192).randbelow(P256_CURVE.n - 1))
    return tuple(int(v).to_bytes(32, "little") for v in (r, s, *pub, m))


def _record_window_sums(batches: list):
    """Make the v3 pipeline append each batch that reaches it (its bases and
    a copy of its scalars) to `batches`; returns a function that undoes it."""
    from webauthn_halo2_tpu_torch.ops import msm_fused as MF

    window_sums = MF.window_sums

    def recording(curve, points, scalars, c, lanes):
        batches.append((points, scalars.clone()))
        return window_sums(curve, points, scalars, c, lanes)

    MF.window_sums = recording

    def undo():
        MF.window_sums = window_sums

    return undo


ROOT = os.path.dirname(os.path.abspath(__file__))


def _flip(data: bytes) -> bytes:
    bad = bytearray(data)
    bad[len(bad) // 2] ^= 1
    return bytes(bad)


def _both_paths(what: str, verify, proof: bytes) -> dict:
    """`verify` on a valid proof and on a flipped copy, through the native
    host path and through the Python one: fails unless both answer
    (accepted, rejected). Returns the seconds of each call."""
    from webauthn_halo2_tpu_torch.utils.host_build import python_oracles

    out = {}
    for path in ("native", "python"):
        with python_oracles() if path == "python" else contextlib.nullcontext():
            verdicts, secs = [], []
            for data in (proof, _flip(proof)):
                t0 = time.time()
                verdicts.append(bool(verify(data)))
                secs.append(time.time() - t0)
        if verdicts != [True, False]:
            fail(f"{what}: the {path} host path answered {verdicts}, not [True, False]")
        out[path] = dict(valid_s=secs[0], tampered_s=secs[1])
    log(f"[verify] {what}: the native and the Python host paths accept the proof and "
        f"reject a flipped copy; seconds (valid, flipped) native "
        f"{out['native']['valid_s']:.4f}, {out['native']['tampered_s']:.4f}, Python "
        f"{out['python']['valid_s']:.4f}, {out['python']['tampered_s']:.4f}")
    return out


def _first_difference(a: str, b: str) -> str:
    for i, (x, y) in enumerate(zip(a.splitlines(), b.splitlines())):
        if x != y:
            return f"first differing line {i + 1}: {x[:160]!r} against {y[:160]!r}"
    return f"one text is a prefix of the other ({len(a)} and {len(b)} characters)"


def phase_keys_on_disk(api, params, signed, proof, dev):
    """Phase 9.1: download_keys into a new directory under build/ (the key
    file of the key in memory since phase 4), the in-memory keys dropped,
    the pk loaded from that file, and a proof from it equal to the main
    path's. Returns the directory and the pk and vk manifests' paths."""
    import glob
    import tempfile

    from webauthn_halo2_tpu_torch.plonk import pk_cache as PC

    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    key_dir = tempfile.mkdtemp(prefix="chip_smoke_keys_", dir=os.path.join(ROOT, "build"))
    pk_path = os.path.join(key_dir, "ecdsa_pk.json")
    vk_path = os.path.join(key_dir, "ecdsa_vk.json")
    # the file's own save and load, apart from the circuit's synthesis and
    # digest that precede them
    seconds = {"save_pk": [], "load_pk": []}
    originals = {name: getattr(PC, name) for name in seconds}

    def timed(name):
        def run(*args, **kw):
            t = time.time()
            out = originals[name](*args, **kw)
            torch.cuda.synchronize()
            seconds[name].append(time.time() - t)
            return out

        return run

    for name in seconds:
        setattr(PC, name, timed(name))
    try:
        t0 = time.time()
        api.download_keys(params.degree, pk_path, vk_path, params=params, device=dev)
        torch.cuda.synchronize()
        download_s = time.time() - t0
        api._PK_CACHE.clear()
        t0 = time.time()
        pk = api.proving_key(params, device=dev, cache_dir=key_dir)
        torch.cuda.synchronize()
        load_s = time.time() - t0
    finally:
        for name, orig in originals.items():
            setattr(PC, name, orig)
    files = glob.glob(os.path.join(key_dir, "*.torch.npz"))
    if len(files) != 1 or [len(v) for v in seconds.values()] != [1, 1] or pk.spans:
        fail(f"download_keys and proving_key wrote {files} and saved and loaded "
             f"{json.dumps(seconds)}, not one key file saved once and loaded once")
    size = os.path.getsize(files[0])
    t0 = time.time()
    again = api.generate_proof(*signed, proving_key_path=pk_path, device=dev,
                               rng=_det_rng(b"chip_smoke"))
    prove_s = time.time() - t0
    log(f"[keys] download_keys {download_s:.1f}s (circuit, the key kept in memory since "
        f"phase 4, and save), key file "
        f"{os.path.basename(files[0])} {size} bytes saved in {seconds['save_pk'][0]:.2f}s; "
        f"proving_key from the file {load_s:.2f}s (circuit, digest and load; the load "
        f"{seconds['load_pk'][0]:.2f}s); proof from the loaded pk in {prove_s:.1f}s: "
        f"identical bytes: {again == proof}")
    if again != proof:
        fail("the proof from the pk loaded from disk differs from the main path's")
    return key_dir, pk_path, vk_path


def phase_new_launch_shapes(dev, gen, tag: str, seen: dict, new: dict, srs=None,
                            seen_sizes=(), batches=(), spec=None, timed=None) -> int:
    """Each montmul and NTT launch shape in `new` that `seen` lacks, against
    its plain version on random words at that shape, exact; then the v3 MSM
    kernels, at the window and lanes of the batch's own n, on each commit
    batch of `batches` (bases, scalars) of another n than the SRS's or of
    a size not in `seen_sizes`, and on the last (random-scalar) batch,
    against theirs on that batch, each timed beside its least work (each
    batch's rows appended to `timed` when it is a list). The montmul
    runs in `spec` (default Fr). Returns how many shapes and batches were
    checked."""
    from webauthn_halo2_tpu_torch.fields.limbs import FR_SPEC
    from webauthn_halo2_tpu_torch.ops import ec as E
    from webauthn_halo2_tpu_torch.ops import modops as M
    from webauthn_halo2_tpu_torch.ops import msm as MS
    from webauthn_halo2_tpu_torch.ops import msm_fused as MF
    from webauthn_halo2_tpu_torch.ops import ntt as N

    spec = spec or FR_SPEC
    checked = 0
    for name, keys in new.items():
        for key in sorted(set(keys) - set(seen[name])):
            if name == "montmul":
                n, a_bc, b_bc = key
                a = _rand_words(spec, (1 if a_bc else n,), gen, dev)
                b = _rand_words(spec, (1 if b_bc else n,), gen, dev)
                got, want = M.montmul_cuda(spec, a, b), M.montmul_plain(spec, a, b)
            else:
                B, n, s = key[:3]
                x = _rand_words(FR_SPEC, (B, n), gen, dev)
                tw = N._twiddles_dev(n.bit_length() - 1, False, dev)
                if name == "ntt_stage_a":
                    got, want = N.stage_a(FR_SPEC, x, tw, s, key[3]), N.stage_a_plain(FR_SPEC, x, tw, s)
                else:
                    got, want = N.stage_b(FR_SPEC, x, tw, s), N.stage_b_plain(FR_SPEC, x, tw, s)
            err = _max_abs_err(got, want)
            log(f"[{tag}] {name} at the new launch shape {key}: max_abs_err={err}")
            if err:
                fail(f"{name} disagrees with its plain version at the {tag} path's shape {key}")
            checked += 1
    for i, (points, scalars) in enumerate(batches):
        n = scalars.shape[-1]
        if i != len(batches) - 1 and n == srs.n and scalars.shape[1] in seen_sizes:
            continue
        crow, _, _ = _msm_stages(E.BN254_CURVE, points, scalars, MS._default_c(n),
                                 MF.lanes_for(n), timed=True, iters=3)
        errs = {k: v["err"] for k, v in crow.items()}
        log(f"[{tag}] v3 MSM kernels on the commit batch {i} (B={scalars.shape[1]}, "
            f"n=2^{n.bit_length() - 1}): "
            f"max_abs_err={errs}; " + "; ".join(
                f"{k} {r['shape']}: {r['ms']:.4f} ms, bound {RL.bound_ms(r)[0]:.4f} ms, "
                f"plain {r['plain_ms']:.1f} ms" for k, r in crow.items()))
        if any(errs.values()):
            fail(f"the v3 MSM kernels disagree with their plain versions on the {tag} batch {i}")
        if timed is not None:
            timed.append(crow)
        checked += 1
        torch.cuda.empty_cache()
    return checked


def _test_definitions(name: str, *wanted: str) -> dict:
    """The top-level definitions `wanted` (functions and assignments) of
    tests/<name>, run without importing the file, which imports the JAX
    package: the stored JAX outputs and the circuits they were made from."""
    import ast

    path = os.path.join(ROOT, "tests", name)
    with open(path) as f:
        tree = ast.parse(f.read(), path)

    def named(node):
        if isinstance(node, ast.FunctionDef):
            return node.name
        if isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Name):
            return node.targets[0].id
        return None

    body = [node for node in tree.body if named(node) in wanted]
    if sorted(named(node) for node in body) != sorted(wanted):
        fail(f"tests/{name} lacks one of {wanted}")
    found: dict = {}
    exec(compile(ast.Module(body=body, type_ignores=[]), path, "exec"), found)
    return found


def _es256_signed(key_seed: int, msg_seed: int):
    """ES256Inputs: a fresh authenticator data and client-data hash from
    `msg_seed`, signed by the P-256 key made from `key_seed`."""
    from webauthn_halo2_tpu_torch.circuits.es256_circuit import AUTH_DATA_LEN, ES256Inputs
    from webauthn_halo2_tpu_torch.fields.ref_curve import (P256_CURVE, ecdsa_keygen,
                                                           ecdsa_sign)

    sk, pub = ecdsa_keygen(rng=_Seeded(key_seed))
    rng = random.Random(msg_seed)
    auth = bytes(rng.randrange(256) for _ in range(AUTH_DATA_LEN))
    cdh = bytes(rng.randrange(256) for _ in range(32))
    m = int.from_bytes(hashlib.sha256(auth + cdh).digest(), "big")
    r, s = ecdsa_sign(m, sk, k=1 + rng.randrange(P256_CURVE.n - 1))
    return ES256Inputs(r, s, auth, cdh, pub)


def _gb(nbytes: int) -> float:
    return round(nbytes / 1e9, 3)


def _span_memory(base: int):
    """Read device memory at each prover span (traced, so after its fences):
    allocated at its start and the running peak at its end, in GB above
    `base`. The first span whose end reaches the proof's peak sets it.
    Returns (readings, restore)."""
    from webauthn_halo2_tpu_torch.plonk import prover as PR

    enter_, exit_ = PR._Span.__enter__, PR._Span.__exit__
    readings = {}

    def enter(self):
        out = enter_(self)
        readings[self.name] = dict(start_gb=_gb(torch.cuda.memory_allocated() - base))
        return out

    def exit(self, *a):
        exit_(self, *a)
        readings[self.name]["peak_gb"] = _gb(torch.cuda.max_memory_allocated() - base)

    PR._Span.__enter__, PR._Span.__exit__ = enter, exit

    def restore():
        PR._Span.__enter__, PR._Span.__exit__ = enter_, exit_

    return readings, restore


def phase_es256(dev, gen, srs, seen_shapes: dict, seen_sizes: set, counts,
                zero_counts) -> tuple:
    """Phase 10: the ES256/WebAuthn circuit at k=17 (in-circuit SHA-256,
    two-column lookups). Its synthesis digest and the mock's findings on
    its witness and on the witness with one SHA-256 cell plus one equal the
    JAX package's (stored in tests/test_torch_mock.py), the mock's gates on
    the card; keygen, a warm-up proof and three timed proofs of fresh
    signatures from one seeded key (SHPLONK, Blake2b), each accepted by
    verify_proof, a flipped and a truncated one rejected, and a repeat of
    the warm-up under the same rng byte-equal, with the launch counts from
    zero over keygen, the timed proofs and their verifications; a proof and
    a flipped copy through the native and the Python host verifier, the
    same verdicts; one rng proved at WH2_QUOTIENT_CHUNKS 1 and 4, the same
    bytes, each proof's peak memory and time; each launch shape and commit
    batch of keygen, the first timed proof and the windowed one that
    phases 1-9 did not check, against the plain versions; the K=6
    two-column lookup circuit of tests/test_torch_prover.py proved on the
    v3, v1 and serial routes, each equal to the stored JAX bytes. Returns
    (the launch counts, the numbers for the summary line)."""
    from webauthn_halo2_tpu_torch.circuits.es256_circuit import ES256Circuit, ES256Inputs
    from webauthn_halo2_tpu_torch.ops import msm as MS
    from webauthn_halo2_tpu_torch.ops import msm_fused as MF
    from webauthn_halo2_tpu_torch.ops import msm_v1 as MV
    from webauthn_halo2_tpu_torch.plonk import cs as CS
    from webauthn_halo2_tpu_torch.plonk import keygen as KG
    from webauthn_halo2_tpu_torch.plonk import prover as PR
    from webauthn_halo2_tpu_torch.plonk.mock import mock_prove
    from webauthn_halo2_tpu_torch.plonk.pk_cache import synthesis_digest
    from webauthn_halo2_tpu_torch.plonk.srs import get_srs
    from webauthn_halo2_tpu_torch.plonk.verifier import verify_proof

    ref = _test_definitions("test_torch_mock.py", "TAMPER", "ES256_JAX")
    circ = ES256Circuit()
    k = circ.params.degree
    if k != srs.k:
        fail(f"ES256 runs at k={k}, the SRS at k={srs.k}")
    t0 = time.time()
    cs, fixed, advice, copies = circ.build(ES256Inputs.dummy())
    synth_s = time.time() - t0
    digest = synthesis_digest(cs, fixed, advice, copies)
    shape = dict(advice=cs.num_advice, fixed=cs.num_fixed,
                 lookups=[[lk.name, len(lk.inputs)] for lk in cs.lookups],
                 gates=len(cs.gates), degree=cs.degree(), perm_chunks=cs.num_perm_chunks(),
                 copies=len(copies))
    log(f"[es256] synthesis {synth_s:.1f}s: {json.dumps(shape)}; digest {digest}, the JAX "
        f"package's: {digest == ref['ES256_JAX']['digest']}")
    if digest != ref["ES256_JAX"]["digest"]:
        fail("the port's ES256 synthesis differs from the JAX package's")

    # the mock prover, its gates on the card
    col, row = ref["TAMPER"]
    bad = list(advice)
    bad[col] = list(advice[col])
    bad[col][row] += 1
    t0 = time.time()
    found = mock_prove(cs, k, fixed, advice, copies=copies, device=dev)
    mock_s = time.time() - t0
    tampered = mock_prove(cs, k, fixed, bad, copies=copies, device=dev)
    del bad
    log(f"[es256] mock_prove {mock_s:.1f}s: {found} on the witness; with advice {col} row "
        f"{row} plus one: {tampered}, the JAX package's: {tampered == ref['ES256_JAX']['tampered']}")
    if found or tampered != ref["ES256_JAX"]["tampered"]:
        fail("the port's mock prover's ES256 findings differ from the JAX package's")

    # keygen and the first timed proof: commit batches and launch shapes
    batches = []
    stop_batches = _record_window_sums(batches)
    shapes = {"montmul": [], "ntt_stage_a": [], "ntt_stage_b": []}
    stop_shapes = _record_launch_shapes(shapes)
    # device memory beside what the earlier phases left allocated
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.time()
    pk = KG.keygen(srs, cs, fixed, copies, device=dev)
    torch.cuda.synchronize()
    keygen_s = time.time() - t0
    keygen_peak = torch.cuda.max_memory_allocated() - base
    pk_bytes = torch.cuda.memory_allocated() - base
    keygen_launches = counts()
    n_keygen = len(batches)
    keygen_sizes = [sc.shape[1] for _, sc in batches]
    pk_spans = {k_: round(v, 3) for k_, v in pk.spans.items()}
    log(f"[es256] keygen {keygen_s:.1f}s, peak {_gb(keygen_peak)} GB and the pk "
        f"{_gb(pk_bytes)} GB beside {_gb(base)} GB allocated before; spans "
        + json.dumps(pk_spans)
        + f"; commit batches {keygen_sizes}; launches "
        + json.dumps(keygen_launches))

    def prove(adv, seed: bytes) -> bytes:
        return PR.create_proof(pk, adv, [], rng=_det_rng(seed), device=dev)

    stop_batches()
    stop_shapes()
    t0 = time.time()
    warm = prove(advice, b"chip_smoke es256")
    warm_s = time.time() - t0
    before = counts()
    timed = []
    for i in range(3):
        t0 = time.time()
        _, _, adv_i, _ = circ.build(_es256_signed(2025, 100 + i))
        build_s = time.time() - t0
        first = i == 0
        if first:
            stop_batches = _record_window_sums(batches)
            stop_shapes = _record_launch_shapes(shapes)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            at_start = counts()
            pk_base = torch.cuda.memory_allocated() - base
        t0 = time.time()
        proof = prove(adv_i, b"chip_smoke es256 %d" % i)
        prove_s = time.time() - t0
        entry = dict(synthesis_s=build_s, prove_s=prove_s, bytes=len(proof))
        if first:
            stop_batches()
            stop_shapes()
            # the pk included: a proof's peak as a lone prover would see it
            entry.update(peak_gb=_gb(torch.cuda.max_memory_allocated() - base),
                         resident_gb=_gb(pk_base),
                         spans={k_: round(v, 4) for k_, v in PR.LAST_SPANS.items()},
                         launches={k_: v - at_start[k_] for k_, v in counts().items()},
                         batches=[sc.shape[1] for _, sc in batches[n_keygen:]])
        t0 = time.time()
        ok = verify_proof(pk.vk, srs, proof, [])
        entry["verify_s"] = time.time() - t0
        entry["accepted"] = ok
        timed.append((proof, entry))
        log(f"[es256] proof {i} of a fresh signature: " + json.dumps(entry))
        if not ok:
            fail(f"verify_proof rejected the port's ES256 proof {i}")
    launches = {k_: v - before[k_] + keygen_launches[k_] for k_, v in counts().items()}
    proof = timed[0][0]
    if verify_proof(pk.vk, srs, _flip(proof), []) or verify_proof(pk.vk, srs, proof[:-32], []):
        fail("verify_proof accepted a flipped or truncated ES256 proof")
    again = prove(advice, b"chip_smoke es256")
    log(f"[es256] warm-up proof {warm_s:.1f}s; a flipped and a truncated proof rejected; "
        f"the warm-up's rng again gives the same bytes: {again == warm}")
    if again != warm:
        fail("two ES256 proofs under the same rng differ")
    if launches["serial_bucket_sums"]:
        fail("the ES256 path ran the serial bucket sum")
    host_paths = _both_paths("verify_proof (ES256)",
                             lambda data: verify_proof(pk.vk, srs, data, []), proof)

    # the windowed quotient: one rng at WH2_QUOTIENT_CHUNKS 1 and 4, equal
    # bytes; each proof's peak with the key, as peak_gb above; the windows'
    # launch shapes join the new shapes checked below
    windowed = {}
    saved_chunks = os.environ.get("WH2_QUOTIENT_CHUNKS")
    try:
        for chunks in (1, 4):
            os.environ["WH2_QUOTIENT_CHUNKS"] = str(chunks)
            stop_windows = _record_launch_shapes(shapes) if chunks > 1 else None
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            memory, stop_memory = _span_memory(base)
            t0 = time.time()
            try:
                data = prove(advice, b"chip_smoke es256 windows")
            finally:
                stop_memory()
            windowed[chunks] = dict(
                prove_s=time.time() - t0, peak_gb=_gb(torch.cuda.max_memory_allocated() - base),
                quotient_s=PR.LAST_SPANS.get("quotient (conversions + h)"),
                span_memory=memory, proof=data)
            if stop_windows:
                stop_windows()
    finally:
        if saved_chunks is None:
            os.environ.pop("WH2_QUOTIENT_CHUNKS", None)
        else:
            os.environ["WH2_QUOTIENT_CHUNKS"] = saved_chunks
    # the windows' operands: (8, C) slices at an offset of a column of an
    # (8, B, ext_n) stack, as the quotient reads them, against the plain version
    from webauthn_halo2_tpu_torch.fields.limbs import FR_SPEC
    from webauthn_halo2_tpu_torch.ops import modops as M

    ext_n = 1 << pk.vk.domain.extended_k
    C = ext_n // 4
    stack = _rand_words(FR_SPEC, (3, ext_n), gen, dev)
    for s0, s1 in ((C, 3 * C), (7, ext_n - C)):
        a, b = stack[:, 1, s0:s0 + C], stack[:, 2, s1:s1 + C]
        err = _max_abs_err(M.montmul_cuda(FR_SPEC, a, b), M.montmul_plain(FR_SPEC, a, b))
        log(f"[es256] montmul on (8, {C}) windows at {s0} and {s1} of a stacked "
            f"(8, 3, {ext_n}): max_abs_err={err}")
        if err:
            fail("the montmul kernel disagrees with its plain version on quotient windows")
    del stack
    same_bytes = windowed[1].pop("proof") == windowed[4]["proof"]
    accepted = verify_proof(pk.vk, srs, windowed[4].pop("proof"), [])
    log("[es256] windowed quotient, one rng: " + json.dumps(windowed)
        + f"; chunks 4 gives the bytes of chunks 1: {same_bytes}, verified: {accepted}")
    if not same_bytes or not accepted:
        fail("the ES256 proof at WH2_QUOTIENT_CHUNKS=4 differs from the one at 1, "
             "or does not verify")
    del pk, warm, again
    torch.cuda.empty_cache()

    # launch shapes and commit batches phases 1-9 did not check
    t0 = time.time()
    new = phase_new_launch_shapes(dev, gen, "es256", seen_shapes, shapes, srs, seen_sizes,
                                  batches)
    del batches
    torch.cuda.empty_cache()
    log(f"[es256] {new} new launch shapes and commit batches equal their plain versions "
        f"({time.time() - t0:.1f}s)")

    # the K=6 two-column lookup circuit on the three commit routes
    toy = _test_definitions("test_torch_prover.py", "K", "JAX_REF", "pair_inputs")
    want = toy["JAX_REF"]["pair"]
    cs6, fixed6, adv6, inst6, copies6 = toy["pair_inputs"](CS)
    srs6 = get_srs(toy["K"], device=dev)
    pk6 = KG.keygen(srs6, cs6, fixed6, copies6, device=dev)
    if pk6.vk.transcript_repr != want["transcript_repr"]:
        fail("the K=6 pair circuit's vk differs from the JAX package's")
    same = {}
    try:
        for route, engine in (("v3", MF), ("v1", MV), ("serial", MS)):
            KG.MSM_ENGINE = engine
            got = PR.create_proof(pk6, adv6, inst6, rng=_det_rng(want["seed"]), device=dev)
            same[route] = got.hex() == want["proof"]
    finally:
        KG.MSM_ENGINE = MF
    log(f"[es256] the K=6 pair circuit's proof equals the JAX bytes on the routes: "
        f"{json.dumps(same)}")
    if not all(same.values()):
        fail("the K=6 pair circuit's proof differs from the JAX package's on a route")
    summary = dict(synthesis_s=synth_s, mock_s=mock_s, keygen_s=keygen_s,
                   keygen_peak_gb=_gb(keygen_peak), pk_gb=_gb(pk_bytes),
                   warmup_s=warm_s, prove_s=[e["prove_s"] for _, e in timed],
                   verify_s=[e["verify_s"] for _, e in timed], peak_gb=timed[0][1]["peak_gb"],
                   bytes=len(proof),
                   batches=dict(keygen=keygen_sizes, proof=timed[0][1]["batches"]),
                   keygen_spans=pk_spans, proof_spans=timed[0][1]["spans"],
                   launches=launches, verify_host_paths=host_paths,
                   windowed_quotient=windowed)
    return launches, summary


def _precompile_seconds(srs) -> dict:
    """Seconds of one ecPairing of two pairs, one ecMul and one ecAdd as the
    port's EVM runs them (the pairing in the native library, the others in
    Python)."""
    from webauthn_halo2_tpu_torch.fields.pairing import pairing_check
    from webauthn_halo2_tpu_torch.fields.ref_curve import BN254_G1_CURVE as G

    t0 = time.time()
    ok = pairing_check([(G.g, srs.s_g2), (G.neg(G.g), srs.s_g2)])
    pairing_s = time.time() - t0
    if not ok:
        fail("the EVM's pairing check rejected e(g, s) e(-g, s) = 1")
    t0 = time.time()
    p = G.mul((1 << 253) + 12345, G.g)
    mul_s = time.time() - t0
    t0 = time.time()
    G.add(p, G.g)
    return dict(ec_pairing_2_s=pairing_s, ec_mul_s=mul_s, ec_add_s=time.time() - t0)


def phase_verifiers(api, key_dir: str, vk_path: str, dev, own: dict) -> dict:
    """Phase 9.4: generate_verifier for GWC and SHPLONK into `key_dir`; each
    Yul text equals the committed results/P256Verifier{,_shplonk}.yul, its
    .code file is compile_yul of that text; deployed in the port's EVM, it
    accepts results/proof_{gwc,shplonk}_k17.hex at exactly the gas of
    results/evm_gas.json and the port's own proof within 0.5% of it, and
    reverts on a flipped bit and on truncation; the GWC verifier gives the
    same verdicts and gas with the EVM's pairing and Keccak in Python.
    Returns per scheme the calls' gas and seconds."""
    from webauthn_halo2_tpu_torch.evm.machine import Chain
    from webauthn_halo2_tpu_torch.evm.yul_asm import compile_yul

    with open(os.path.join(ROOT, "results", "evm_gas.json")) as f:
        gas_ref = json.load(f)
    out = {}
    for scheme, suffix, gas_key in (("gwc", "", "verify_gas"),
                                    ("shplonk", "_shplonk", "verify_gas_shplonk")):
        base = os.path.join(key_dir, f"P256Verifier{suffix}")
        t0 = time.time()
        own_gas = api.generate_verifier(vk_path, base + ".sol", base + ".code", base + ".yul",
                                        valid_proof_hex=own[scheme].hex(), scheme=scheme,
                                        device=dev)
        gen_s = time.time() - t0
        with open(base + ".yul") as f:
            yul = f.read()
        with open(os.path.join(ROOT, "results", f"P256Verifier{suffix}.yul")) as f:
            committed = f.read()
        if yul != committed:
            log(f"[evm] {scheme}: the Yul differs from results/P256Verifier{suffix}.yul, "
                + _first_difference(yul, committed))
            fail(f"the port's {scheme} Yul differs from results/P256Verifier{suffix}.yul")
        with open(base + ".code") as f:
            code = bytes(json.load(f)["code"])
        t0 = time.time()
        deploy, runtime = compile_yul(committed)
        asm_s = time.time() - t0
        if code != deploy:
            fail(f"the {scheme} .code file is not compile_yul of the committed Yul")
        chain = Chain()
        t0 = time.time()
        addr, res = chain.create(0xD0, deploy)
        deploy_s = time.time() - t0
        if not res.success or chain.account(addr).code != runtime:
            fail(f"the {scheme} verifier did not deploy")
        with open(os.path.join(ROOT, "results", f"proof_{scheme}_k17.hex")) as f:
            jax_proof = bytes.fromhex(f.read().strip())
        calls = {}
        for name, data in (("jax", jax_proof), ("own", own[scheme]),
                           ("jax flipped", _flip(jax_proof)), ("jax truncated", jax_proof[:-32]),
                           ("own flipped", _flip(own[scheme])),
                           ("own truncated", own[scheme][:-32])):
            t0 = time.time()
            r = chain.call(0xD0, addr, data)
            calls[name] = dict(ok=r.success, gas=r.gas_used, s=round(time.time() - t0, 3))
        want = gas_ref[gas_key]
        calls["own"]["equals_jax_bytes"] = own[scheme] == jax_proof
        out[scheme] = dict(yul_bytes=len(yul), deploy_bytes=len(deploy), generate_s=gen_s,
                           compile_s=asm_s, deploy_s=deploy_s, deploy_gas=res.gas_used,
                           calls=calls)
        if scheme == "gwc":  # the EVM's native and Python host paths: verdicts and gas
            out[scheme]["host_paths"] = _both_paths(
                "the GWC verifier in the port's EVM",
                lambda data: chain.call(0xD0, addr, data).success, own[scheme])
            from webauthn_halo2_tpu_torch.utils.host_build import python_oracles

            with python_oracles():
                py_gas = chain.call(0xD0, addr, own[scheme]).gas_used
            if py_gas != calls["own"]["gas"]:
                fail(f"the GWC verifier ran the port's proof at {calls['own']['gas']} gas "
                     f"natively and {py_gas} on the Python host path")
        log(f"[evm] {scheme}: Yul equal to results/P256Verifier{suffix}.yul ({len(yul)} "
            f"characters), deploy code {len(deploy)} bytes; generate_verifier {gen_s:.1f}s "
            f"(own proof {own_gas} gas), compile_yul {asm_s:.2f}s, deployed in {deploy_s:.2f}s; "
            f"calls {json.dumps(calls)}; results/evm_gas.json {gas_key}={want}")
        if not (calls["jax"]["ok"] and calls["jax"]["gas"] == want):
            fail(f"the {scheme} verifier ran results/proof_{scheme}_k17.hex at "
                 f"{calls['jax']['gas']} gas (ok={calls['jax']['ok']}), not {want}")
        if not calls["own"]["ok"] or calls["own"]["gas"] != own_gas:
            fail(f"the {scheme} verifier rejected the port's own proof")
        if abs(calls["own"]["gas"] - want) > 0.005 * want:
            fail(f"the port's {scheme} proof ran at {calls['own']['gas']} gas, "
                 f"more than 0.5% from {want}")
        if any(c["ok"] for name, c in calls.items() if name not in ("jax", "own")):
            fail(f"the {scheme} verifier accepted a tampered or truncated proof")
    return out


# The largest commit batch of keygen and the proof (9 fixed and 9 sigma
# columns in keygen, 8 advice columns in the proof): phase 2 checks the MSM
# kernels at 20 windows x this many rows, and the main path must stay within.
def phase_srs(dev, gen, srs, seen_shapes: dict, counts, zero_counts) -> tuple:
    """Phase 11: device SRS generation. generate_srs(17) on the card, its
    host scalars, window table, fixed-base multiplies and conversion to
    affine timed apart, every tensor equal to the committed k=17 SRS as
    get_srs loaded it; then get_srs(18) into a new directory under build/,
    a degree without a committed file: generated, written in the port's
    format, reloaded equal with the in-memory entry dropped, 64 seeded
    indices of g_mono and g_lag equal to the host multiples of their host
    scalars, and e([tau]G1, G2) = e(G1, [tau]G2). The launch counts run
    from zero over both generations; each montmul launch shape the earlier
    phases did not check, against its plain version in Fq. Returns (the
    launch counts, the numbers for the summary line)."""
    import tempfile

    from webauthn_halo2_tpu_torch.fields.limbs import FQ_SPEC
    from webauthn_halo2_tpu_torch.fields.pairing import pairing_check
    from webauthn_halo2_tpu_torch.fields.ref_curve import BN254_G1_CURVE as G
    from webauthn_halo2_tpu_torch.ops import ec as E
    from webauthn_halo2_tpu_torch.plonk import srs as S

    def same(a, b) -> bool:
        return all(torch.equal(x, y) for x, y in zip(a, b))

    shapes = {"montmul": [], "ntt_stage_a": [], "ntt_stage_b": []}
    stop_shapes = _record_launch_shapes(shapes)
    zero_counts()
    t0 = time.time()
    g17 = S.generate_srs(srs.k, device=dev)
    torch.cuda.synchronize()
    gen17_s = time.time() - t0
    equal17 = (same(g17.g_mono, srs.g_mono) and same(g17.g_lag, srs.g_lag)
               and (g17.g2, g17.s_g2) == (srs.g2, srs.s_g2))
    spans17 = dict(g17.spans)
    log(f"[srs] generate_srs({srs.k}) on the card in {gen17_s:.2f}s "
        + json.dumps({k: round(v, 3) for k, v in spans17.items()})
        + f"; every tensor equal to artifacts/srs_bn254_k{srs.k}_646576.npz: {equal17}")
    if not equal17:
        fail(f"generate_srs({srs.k}) differs from the committed SRS")
    del g17
    k = srs.k + 1
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    cache_dir = tempfile.mkdtemp(prefix="chip_smoke_srs_", dir=os.path.join(ROOT, "build"))
    jax_path, port_path = S.srs_paths(k, b"dev", cache_dir)
    t0 = time.time()
    g18 = S.get_srs(k, cache_dir=cache_dir, device=dev)
    torch.cuda.synchronize()
    gen18_s = time.time() - t0
    launches = counts()
    stop_shapes()
    spans18 = dict(g18.spans)
    if not os.path.exists(port_path) or os.path.exists(jax_path) or not spans18:
        fail(f"get_srs({k}) did not generate and write {port_path} (and only it)")
    size = os.path.getsize(port_path)
    S._SRS_MEM_CACHE.pop((k, b"dev", str(dev)))
    t0 = time.time()
    again = S.get_srs(k, cache_dir=cache_dir, device=dev)
    torch.cuda.synchronize()
    reload_s = time.time() - t0
    reloaded = (again is not g18 and not again.spans and same(again.g_mono, g18.g_mono)
                and same(again.g_lag, g18.g_lag) and (again.g2, again.s_g2) == (g18.g2, g18.s_g2))
    t0 = time.time()
    powers, lag = S.srs_scalars(k)
    idx = sorted(random.Random(18).sample(range(1 << k), 64))
    host_ok = True
    for which, scalars in (("g_mono", powers), ("g_lag", lag)):
        pts = getattr(again, which)
        got = E.to_affine_ints(E.BN254_CURVE, E.JPoint(*(c[:, idx] for c in pts)))
        host_ok &= got == [G.mul(scalars[i], G.g) for i in idx]
    tau_g1 = E.to_affine_ints(E.BN254_CURVE, E.JPoint(*(c[:, 1:2] for c in again.g_mono)))[0]
    pairing_ok = pairing_check([(tau_g1, again.g2), (G.neg(G.g), again.s_g2)])
    host_s = time.time() - t0
    log(f"[srs] get_srs({k}) generated in {gen18_s:.2f}s "
        + json.dumps({k_: round(v, 3) for k_, v in spans18.items()})
        + f", wrote {os.path.basename(port_path)} ({size} bytes); reloaded in {reload_s:.2f}s, "
        f"equal: {reloaded}; 64 indices of g_mono and g_lag equal the host multiples: "
        f"{host_ok}; e([tau]G1, G2) = e(G1, [tau]G2): {pairing_ok} ({host_s:.1f}s); "
        f"launches {json.dumps(launches)}")
    if not (reloaded and host_ok and pairing_ok):
        fail(f"the generated k={k} SRS did not reload equal, or disagrees with the host")
    del g18, again
    S._SRS_MEM_CACHE.pop((k, b"dev", str(dev)))
    shutil.rmtree(cache_dir)
    if launches["serial_bucket_sums"]:
        fail("SRS generation ran the serial bucket sum")
    t0 = time.time()
    new = phase_new_launch_shapes(dev, gen, "srs", seen_shapes, shapes, spec=FQ_SPEC)
    log(f"[srs] {new} new montmul launch shapes (Fq) equal their plain versions "
        f"({time.time() - t0:.1f}s)")
    return launches, dict(generate_k17_s=gen17_s, k17_spans=spans17, generate_k18_s=gen18_s,
                          k18_spans=spans18, k18_file_bytes=size, k18_reload_s=reload_s,
                          host_checks_s=host_s, new_launch_shapes=new)


def _signed_request(key_seed: int, msg_seed: int) -> dict:
    """A ProveRequestBody-style dict (LE byte lists) of a fresh ECDSA-P256
    signature: the key from key_seed, the message and nonce from msg_seed."""
    from webauthn_halo2_tpu_torch.fields.ref_curve import (P256_CURVE, ecdsa_keygen,
                                                           ecdsa_sign)

    sk, pub = ecdsa_keygen(rng=_Seeded(key_seed))
    m = _Seeded(msg_seed).randbelow(P256_CURVE.n)
    r, s = ecdsa_sign(m, sk, k=1 + _Seeded(msg_seed + 1).randbelow(P256_CURVE.n - 1))
    return {name: list(int(v).to_bytes(32, "little"))
            for name, v in zip(("r", "s", "pubkey_x", "pubkey_y", "msghash"), (r, s, *pub, m))}


def phase_server(api, dev, counts, zero_counts) -> tuple:
    """Phase 12: the port's proving server and its on-chain leg, then
    batched proving. In a new directory under build/ (so ./keys/ lands
    there), the server's ThreadingHTTPServer on 127.0.0.1 in a thread, the
    in-memory keys and the bundler's chain dropped first: /setup (k=17),
    a WebAuthn assertion from the port's client with a seeded key, /prove
    and /verify (a flipped proof rejected), /prove_evm and /verify_evm,
    /generate_evm_verifier with that GWC proof (its Yul equal to
    results/P256Verifier.yul), /chain/sender twice, /chain/submit_userop
    with the port's proof (0 -> 1, account deployed), again (1 -> 2), with
    results/proof_gwc_k17.hex (2 -> 3) and a zeroed proof (not executed),
    /chain/receipt (200 and 404); one proving key built for all of it.
    /verify and /verify_evm also through the Python host verifier, with
    the native one's verdicts. Any other answer fails the run. Then, with
    WH2_TRACE off, generate_proofs_batch (a stream a prover): 4 SHPLONK
    requests, each verified, two proved again alone with the same rng and
    byte-equal, the batch's time over 4 such proofs alone, then one traced,
    and 2 GWC requests that verify_evm accepts. Returns (the server's
    launch counts, the batch's, the numbers for the summary line)."""
    import tempfile
    import threading
    import urllib.error
    import urllib.request

    from webauthn_halo2_tpu_torch.client import webauthn as wa
    from webauthn_halo2_tpu_torch.fields.ref_curve import P256_CURVE
    from webauthn_halo2_tpu_torch.plonk import pk_cache as PC
    from webauthn_halo2_tpu_torch.server import app, bundler

    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="chip_smoke_server_", dir=os.path.join(ROOT, "build"))
    # every key built or loaded in this phase, through whichever module
    built = {"keygen": 0, "load_pk": 0}
    originals = [(api, "keygen"), (PC, "keygen"), (PC, "load_pk")]
    saved = {(m, n): getattr(m, n) for m, n in originals}

    def counting(module, name):
        orig = saved[(module, name)]

        def run(*a, **kw):
            built["load_pk" if name == "load_pk" else "keygen"] += 1
            return orig(*a, **kw)

        return run

    for m, n in originals:
        setattr(m, n, counting(m, n))
    api._PK_CACHE.clear()
    bundler._WORLD = None
    cwd = os.getcwd()
    os.chdir(work)
    srv = app.ThreadingHTTPServer(("127.0.0.1", 0), app.Handler)
    thread = threading.Thread(target=srv.serve_forever, daemon=True, name="server")
    thread.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    route_s: dict = {}

    def post(route: str, body: dict, want_code: int = 200, record: bool = True) -> str:
        req = urllib.request.Request(base + route, data=json.dumps(body).encode(),
                                     headers={"Content-Type": "application/json"},
                                     method="POST")
        t0 = time.time()
        try:
            with urllib.request.urlopen(req, timeout=600) as r:
                code, text = r.status, r.read().decode()
        except urllib.error.HTTPError as e:
            code, text = e.code, e.read().decode()
        if record:
            route_s.setdefault(route, []).append(time.time() - t0)
        if code != want_code:
            fail(f"{route} answered {code} {text[:300]!r}, not {want_code}")
        return text

    try:
        zero_counts()
        if post("/setup", {"degree": 17}) != "keys generated":
            fail("/setup did not answer 'keys generated'")
        files = sorted(os.listdir(os.path.join(work, "keys")))
        if not {"proving_key.pk", "verifying_key.vk"} <= set(files) or not any(
                f.startswith("pk_k17_") and f.endswith(".torch.npz") for f in files):
            fail(f"/setup left {files} in ./keys, not the key file and both manifests")
        sk = 1 + _Seeded(31337).randbelow(P256_CURVE.n - 1)
        cred = wa.Credential("webauthn-halo2-tpu.local", bytes(range(32)), sk,
                             P256_CURVE.mul(sk, P256_CURVE.g))
        assertion = wa.authenticate(cred, b"chip_smoke server",
                                    k=1 + _Seeded(4242).randbelow(P256_CURVE.n - 1))
        if not wa.verify_assertion_host(assertion, cred):
            fail("the host rejected the client's own assertion")
        body = wa.prove_request_body(assertion, cred)
        vk = {"verifying_key_path": "./keys/verifying_key.vk"}
        proof_hex = post("/prove", body)
        verdicts = [post("/verify", {**vk, "proof": proof_hex}),
                    post("/verify", {**vk, "proof": _flip(bytes.fromhex(proof_hex)).hex()})]
        gwc_hex = post("/prove_evm", body)
        verdicts.append(post("/verify_evm", {**vk, "proof": gwc_hex}))
        log(f"[server] /setup, /prove ({len(proof_hex) // 2} bytes), /verify, /prove_evm "
            f"({len(gwc_hex) // 2} bytes), /verify_evm: {verdicts}")
        if verdicts != ["verified", "rejected", "verified"]:
            fail(f"/verify and /verify_evm answered {verdicts}")
        host_paths = {
            route: _both_paths(route, lambda data, route=route: post(
                route, {**vk, "proof": data.hex()}, record=False) == "verified",
                bytes.fromhex(data_hex))
            for route, data_hex in (("/verify", proof_hex), ("/verify_evm", gwc_hex))}
        msg = post("/generate_evm_verifier", {
            **vk, "sol_code_path": "verifier.sol", "deploy_code_path": "verifier.code",
            "yul_code_path": "verifier.yul", "valid_proof_hex": gwc_hex})
        found = re.fullmatch(r"generated evm verifier \(dry-run gas: (\d+)\)", msg)
        with open(os.path.join(ROOT, "results", "P256Verifier.yul")) as f:
            want_yul = f.read()
        with open("verifier.yul") as f:
            yul = f.read()
        log(f"[server] /generate_evm_verifier: {msg!r}; its Yul equals "
            f"results/P256Verifier.yul: {yul == want_yul}")
        if not found or yul != want_yul:
            fail("/generate_evm_verifier gave no dry-run gas, or Yul other than "
                 "results/P256Verifier.yul: " + _first_difference(yul, want_yul))
        dry_run_gas = int(found.group(1))
        pub = {"public_key": (cred.pk[0].to_bytes(32, "big")
                              + cred.pk[1].to_bytes(32, "big")).hex()}
        senders = [json.loads(post("/chain/sender", pub))["sender"] for _ in range(2)]
        if senders[0] != senders[1]:
            fail(f"/chain/sender gave {senders}")
        with open(os.path.join(ROOT, "results", "proof_gwc_k17.hex")) as f:
            jax_gwc = f.read().strip()
        receipts = [json.loads(post("/chain/submit_userop", {**pub, "proof": p}))
                    for p in (gwc_hex, gwc_hex, jax_gwc, "00" * (len(gwc_hex) // 2))]
        got = [(r["success"], r["accountDeployed"], r["counterBefore"], r["counterAfter"])
               for r in receipts]
        want = [(True, True, 0, 1), (True, False, 1, 2), (True, False, 2, 3),
                (False, False, 3, 3)]
        gas = [r["gasUsed"] for r in receipts]
        log(f"[server] /chain/submit_userop: (success, deployed, counter before, after) {got}; "
            f"gasUsed {gas}; sender {senders[0]}")
        if got != want or any(r["sender"] != senders[0] for r in receipts):
            fail(f"/chain/submit_userop gave {got}, not {want}")
        known = json.loads(post("/chain/receipt", {"userOpHash": receipts[0]["userOpHash"]}))
        post("/chain/receipt", {"userOpHash": "0x" + "00" * 32}, want_code=404)
        if known != receipts[0]:
            fail("/chain/receipt gave another receipt than /chain/submit_userop")
        server_launches = counts()
        if built != {"keygen": 1, "load_pk": 0}:
            fail(f"the server phase built or loaded {built}, not one proving key")
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(30)
        os.chdir(cwd)
        for (m, n), orig in saved.items():
            setattr(m, n, orig)
    shutil.rmtree(work)
    log(f"[server] one proving key for every route and the chain; launches "
        f"{json.dumps(server_launches)}; seconds a route "
        + json.dumps({k: [round(v, 3) for v in vs] for k, vs in route_s.items()}))

    # batched proving over the same key, untraced (no span fences), each
    # prover on its own stream; the same requests proved alone, untraced,
    # then one traced
    params = api.CircuitParams()
    reqs = [_signed_request(7000 + i, 7100 + i) for i in range(4)]

    def alone_proof(i: int) -> bytes:
        return api.generate_proof(*(bytes(reqs[i][k]) for k in (
            "r", "s", "pubkey_x", "pubkey_y", "msghash")), params=params, device=dev,
            rng=_det_rng(b"batch %d" % i))

    trace = os.environ.pop("WH2_TRACE", None)
    try:
        zero_counts()
        t0 = time.time()
        proofs = api.generate_proofs_batch(reqs, params=params, device=dev,
                                           rngs=[_det_rng(b"batch %d" % i) for i in range(4)])
        torch.cuda.synchronize()
        batch_s = time.time() - t0
        batch_launches = counts()
        single_s, alone = [], []
        for i in (0, 3):
            t0 = time.time()
            alone.append(alone_proof(i) == proofs[i])
            single_s.append(time.time() - t0)
        t0 = time.time()
        gwc_reqs = [_signed_request(7200 + i, 7300 + i) for i in range(2)]
        gwc = api.generate_proofs_batch(gwc_reqs, params=params, scheme="gwc", device=dev)
        gwc_batch_s = time.time() - t0
        # the same batch with one prover worker (witnesses still in their own)
        provers, api._PROVERS = api._PROVERS, 1
        try:
            t0 = time.time()
            one = api.generate_proofs_batch(reqs, params=params, device=dev,
                                            rngs=[_det_rng(b"batch %d" % i) for i in range(4)])
            torch.cuda.synchronize()
            one_worker_s = time.time() - t0
        finally:
            api._PROVERS = provers
        alone.append(one == proofs)
    finally:
        if trace is not None:
            os.environ["WH2_TRACE"] = trace
    t0 = time.time()
    alone.append(alone_proof(0) == proofs[0])
    traced_single_s = time.time() - t0
    accepted = [api.verify(p, params=params, device=dev) for p in proofs]
    gwc_ok = [api.verify_evm(p, params=params, device=dev) for p in gwc]
    ratio = batch_s / (4 * sum(single_s) / len(single_s))
    log(f"[batch] untraced, a stream a prover: 4 SHPLONK proofs in {batch_s:.2f}s (two "
        f"workers), each accepted: {accepted}; requests 0 and 3 proved alone with the same "
        f"rng in {[round(v, 2) for v in single_s]}s untraced and request 0 in "
        f"{traced_single_s:.2f}s traced, byte-equal (the last: the batch with one prover "
        f"worker): {alone}; the batch over 4 proofs alone: {ratio:.3f}x; with one prover "
        f"worker {one_worker_s:.2f}s, {one_worker_s / (4 * sum(single_s) / len(single_s)):.3f}x;"
        f" 2 GWC proofs in {gwc_batch_s:.2f}s, verify_evm: {gwc_ok}; "
        f"launches {json.dumps(batch_launches)}")
    if not all(accepted) or not all(alone) or not all(gwc_ok):
        fail("a batch proof was rejected or differs from the same request proved alone")
    summary = dict(route_s=route_s, dry_run_gas=dry_run_gas, receipts_gas=gas,
                   verify_host_paths=host_paths,
                   batch=dict(untraced=True, shplonk_4_s=batch_s, alone_s=single_s,
                              alone_mean_x4_s=4 * sum(single_s) / len(single_s),
                              batch_over_alone=ratio, traced_alone_s=traced_single_s,
                              one_worker_s=one_worker_s, gwc_2_s=gwc_batch_s))
    return server_launches, batch_launches, summary


def _counts() -> dict:
    """This process's launch counters (rows 1-6, 8, 9) and the serial
    bucket sum's calls."""
    from webauthn_halo2_tpu_torch.ops import ec as E
    from webauthn_halo2_tpu_torch.ops import modops as M
    from webauthn_halo2_tpu_torch.ops import msm as MS
    from webauthn_halo2_tpu_torch.ops import msm_fused as MF
    from webauthn_halo2_tpu_torch.ops import mxu_mod as X
    from webauthn_halo2_tpu_torch.ops import ntt as N

    return {"montmul": M.LAUNCHES["montmul"], "ntt_stage_a": N.LAUNCHES["ntt_stage_a"],
            "ntt_stage_b": N.LAUNCHES["ntt_stage_b"], **MF.LAUNCHES, **E.LAUNCHES,
            **X.LAUNCHES, "serial_bucket_sums": MS.CALLS["window_bucket_sum"]}


def _zero_counts() -> None:
    from webauthn_halo2_tpu_torch.ops import ec as E
    from webauthn_halo2_tpu_torch.ops import modops as M
    from webauthn_halo2_tpu_torch.ops import msm as MS
    from webauthn_halo2_tpu_torch.ops import msm_fused as MF
    from webauthn_halo2_tpu_torch.ops import mxu_mod as X
    from webauthn_halo2_tpu_torch.ops import ntt as N

    for table in (M.LAUNCHES, N.LAUNCHES, MF.LAUNCHES, E.LAUNCHES, X.LAUNCHES, MS.CALLS):
        for name in table:
            table[name] = 0


SHARDED_RANKS = 4
SHARDED_COLUMNS = 8
SHARDED_SEED = 1300


def _sharded_inputs(dev, n: int) -> torch.Tensor:
    """Phase 13's (8, SHARDED_COLUMNS, n) Montgomery Fr stack, the same on
    every rank and in the parent (one seeded generator on the card)."""
    from webauthn_halo2_tpu_torch.fields.limbs import FR_SPEC

    gen = torch.Generator(device=dev).manual_seed(SHARDED_SEED)
    return _rand_words(FR_SPEC, (SHARDED_COLUMNS, n), gen, dev)


def _sharded_primitives(mesh, srs, record=None) -> dict:
    """Each primitive of parallel/sharded.py at the slice's width (k=17,
    the extended domain 2^19, SHARDED_COLUMNS columns) against the same
    function on one device in this rank: equal results, and the time of
    a second call of each (the first builds the constant tables, under
    `record()` where given: it starts a recording and returns its stop)."""
    from webauthn_halo2_tpu_torch.fields.limbs import FR_SPEC
    from webauthn_halo2_tpu_torch.ops import ec as E
    from webauthn_halo2_tpu_torch.ops import ntt as N
    from webauthn_halo2_tpu_torch.parallel import sharded as S
    from webauthn_halo2_tpu_torch.plonk import keygen as KG
    from webauthn_halo2_tpu_torch.plonk.domain import Domain

    a = _sharded_inputs(mesh.device, srs.n)
    k, ext_k = srs.k, srs.k + 2
    out = {}

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.time()
        got = fn()
        torch.cuda.synchronize()
        return got, time.time() - t0

    for name, sharded, single in (
            ("ntt", lambda: S.sharded_ntt(mesh, a, k), lambda: N.ntt(FR_SPEC, a, k)),
            ("intt", lambda: S.sharded_intt(mesh, a, k), lambda: N.intt(FR_SPEC, a, k)),
            ("coeff_to_extended", lambda: S.sharded_coeff_to_extended(mesh, a, k, ext_k),
             lambda: Domain(k, ext_k).coeff_to_extended(a)),
            ("msm", lambda: S.sharded_msm(mesh, srs.g_mono, a[:, 0]),
             lambda: KG.MSM_ENGINE.msm(E.BN254_CURVE, srs.g_mono, a[:, 0])),
            ("batch_commit", lambda: S.batch_commit(mesh, srs.g_lag, a),
             lambda: KG.MSM_ENGINE.msm_batch(E.BN254_CURVE, srs.g_lag, a))):
        stop = record() if record else None
        sharded()
        if stop:
            stop()
        single()
        got, s = timed(sharded)
        want, one_s = timed(single)
        equal = torch.equal(got, want) if isinstance(got, torch.Tensor) else got == want
        out[name] = dict(equal=bool(equal), s=s, one_device_s=one_s)
        if name == "msm":
            out[name]["point"] = got
        del got, want
    return out


def _rank_log(log_dir: str, rank: int) -> None:
    """A rank's prints (spans, roofline) go to its own file in log_dir."""
    sys.stdout = sys.stderr = open(os.path.join(log_dir, f"rank{rank}.log"), "w", buffering=1)


def _recording(shapes: dict, batches: list):
    """Record montmul and NTT launch shapes into `shapes` and the v3
    pipeline's commit batches into `batches`; returns the stop."""
    stops = (_record_launch_shapes(shapes), _record_window_sums(batches))
    return lambda: [stop() for stop in stops]


def _sharded_rank(rank: int, size: int, log_dir: str, seen_shapes: dict,
                  seen_sizes: set) -> dict:
    """One of phase 13's ranks: the primitives, then keygen and a k=17
    proof of phase 5's signature and rng with WH2_SHARDED=1, the launch
    counters, ROUTES and COLLECTIVES from zero before keygen (the
    collectives also read apart for the proof). Rank 0 records the launch
    shapes and commit batches of the sharded primitives, keygen and the
    proof, and holds those not in `seen_shapes` and `seen_sizes` against
    their plain versions."""
    _rank_log(log_dir, rank)
    torch.set_num_threads(2)
    from webauthn_halo2_tpu_torch import api
    from webauthn_halo2_tpu_torch.circuits.ecdsa_circuit import CircuitParams
    from webauthn_halo2_tpu_torch.ops import kernels as K
    from webauthn_halo2_tpu_torch.parallel import sharded as S
    from webauthn_halo2_tpu_torch.plonk.srs import get_srs

    K.build_all()  # the parent's libraries, loaded
    mesh = S.make_mesh()  # cuda:(rank % cards): cuda:0 for every rank here
    dev = mesh.device
    torch.cuda.set_device(dev)
    params = CircuitParams()
    srs = get_srs(params.degree, device=dev)
    shapes = {name: [] for name in seen_shapes}
    batches = []
    record = (lambda: _recording(shapes, batches)) if rank == 0 else None
    prims = _sharded_primitives(mesh, srs, record)
    torch.cuda.empty_cache()

    os.environ["WH2_SHARDED"] = "1"
    _zero_counts()
    for table in (S.ROUTES, S.COLLECTIVES):
        table.update((name, 0) for name in table)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    stop = record() if record else None
    t0 = time.time()
    pk = api.proving_key(params, device=dev)
    torch.cuda.synchronize()
    keygen_s = time.time() - t0
    keygen_coll = dict(S.COLLECTIVES)
    S.COLLECTIVES.update((name, 0) for name in S.COLLECTIVES)
    t0 = time.time()
    proof = api.generate_proof(*_signed_message(), params=params, device=dev,
                               rng=_det_rng(b"chip_smoke"))
    prove_s = time.time() - t0
    if stop:
        stop()
    out = dict(rank=rank, mesh=[mesh.rank, mesh.size, str(dev), mesh.backend],
               primitives=prims, keygen_s=keygen_s, prove_s=prove_s, proof=proof,
               routes=dict(S.ROUTES), launches=_counts(),
               collectives=dict(keygen=keygen_coll, proof=dict(S.COLLECTIVES)),
               peak_gb=_gb(torch.cuda.max_memory_allocated(dev)),
               vk=pk.vk.transcript_repr)
    if rank == 0:
        out["verified"] = bool(api.verify(proof, params=params, device=dev))
        del pk
        torch.cuda.empty_cache()
        t0 = time.time()
        gen = torch.Generator(device=dev).manual_seed(SHARDED_SEED + 1)
        checked = phase_new_launch_shapes(dev, gen, "sharded", seen_shapes, shapes, srs,
                                          seen_sizes, batches)
        new = sum(len(set(keys) - set(seen_shapes[name])) for name, keys in shapes.items())
        out["new_launch_shapes"] = dict(shapes=new, batches=checked - new,
                                        s=time.time() - t0)
    return out


def _nccl_rank(rank: int, size: int, log_dir: str) -> dict:
    """Phase 13's one-rank NCCL group: the primitives at D = 1, the card's
    tensors handed to NCCL as they are."""
    _rank_log(log_dir, rank)
    from webauthn_halo2_tpu_torch.ops import kernels as K
    from webauthn_halo2_tpu_torch.parallel import sharded as S
    from webauthn_halo2_tpu_torch.plonk.srs import get_srs

    K.build_all()
    mesh = S.make_mesh()
    torch.cuda.set_device(mesh.device)
    srs = get_srs(17, device=mesh.device)
    return dict(mesh=[mesh.rank, mesh.size, str(mesh.device), mesh.backend],
                primitives=_sharded_primitives(mesh, srs))


def _rank_logs(log_dir: str) -> None:
    for name in sorted(os.listdir(log_dir)):
        if name.endswith(".log"):
            with open(os.path.join(log_dir, name)) as f:
                tail = f.read()[-3000:]
            print(f"--- {name} (tail) ---\n{tail}", file=sys.stderr, flush=True)


def sharded_group(backend: str, size: int, run_dir: str, dev, srs, proof: bytes,
                  keygen_s: float, prove_s: float, seen_shapes: dict | None = None,
                  seen_sizes: set = frozenset()) -> dict:
    """`size` ranks of `backend` (file rendezvous in run_dir), each through
    `_sharded_rank`: every primitive equal to one device, the sharded MSM
    also to the host oracle; every rank's proof equal to `proof`, verified
    on rank 0, every hooked call sharded (ROUTES) and rows 1-6 launched in
    each rank; on rank 0 every launch shape and commit batch of the path
    not in `seen_shapes` (None: none seen) and `seen_sizes` against the
    plain versions. Any failure of a rank fails the run. Returns the
    group's numbers, rank 0's launch counts under "launches" and the
    oracle point under "oracle"."""
    from webauthn_halo2_tpu_torch.fields.limbs import FR_SPEC
    from webauthn_halo2_tpu_torch.parallel.ranks import run_ranks

    seen = {name: sorted(set(keys)) for name, keys in (seen_shapes or dict(
        montmul=[], ntt_stage_a=[], ntt_stage_b=[])).items()}
    torch.cuda.empty_cache()
    t0 = time.time()
    try:
        ranks = run_ranks(_sharded_rank, size, os.path.join(run_dir, backend),
                          backend=backend, args=(run_dir, seen, set(seen_sizes)),
                          timeout=600)
    except Exception as e:  # noqa: BLE001 - every rank failure fails the run
        _rank_logs(run_dir)
        fail(f"the sharded ranks failed: {e}")
    ranks_s = time.time() - t0
    oracle = _oracle(FR_SPEC.decode(_sharded_inputs(dev, srs.n)[:, 0].cpu().numpy()))
    cards = torch.cuda.device_count()
    for r in ranks:
        bad = [name for name, p in r["primitives"].items() if not p["equal"]]
        if bad:
            fail(f"rank {r['rank']}: sharded {bad} differ from one device")
        if r["primitives"]["msm"].pop("point") != oracle:
            fail(f"rank {r['rank']}: the sharded MSM differs from the host oracle")
        want_mesh = [r["rank"], size, f"cuda:{r['rank'] % cards}", backend]
        if r["mesh"] != want_mesh:
            fail(f"rank {r['rank']}: mesh {r['mesh']}, not {want_mesh}")
        if r["proof"] != proof:
            fail(f"rank {r['rank']}: the sharded proof differs from phase 5's")
        routes = r["routes"]
        if (not all(routes[f"{w}_sharded"] for w in ("commits", "l2c", "c2e"))
                or any(routes[f"{w}_one_device"] for w in ("commits", "l2c", "c2e"))):
            fail(f"rank {r['rank']}: a hooked call stayed on one device: {routes}")
        for name in ("montmul", "ntt_stage_a", "ntt_stage_b", "msm_interior",
                     "msm_scan", "msm_combine"):
            if not r["launches"][name]:
                fail(f"rank {r['rank']}: kernel {name} was never launched on the sharded path")
        r.pop("proof")
    if not ranks[0]["verified"] or len({r["vk"] for r in ranks}) != 1:
        fail("api.verify rejected the sharded proof on rank 0, or the ranks' keys differ")
    log(f"[sharded] {size} {backend} ranks in {ranks_s:.1f}s: every primitive equals one "
        f"device, the MSM the oracle; every rank's proof equals phase 5's and verifies; "
        f"keygen s {[round(r['keygen_s'], 2) for r in ranks]} (one device: {keygen_s:.2f}), "
        f"proof s {[round(r['prove_s'], 2) for r in ranks]} (one device: {prove_s:.2f}); "
        "collectives a proof " + json.dumps([r["collectives"]["proof"] for r in ranks])
        + f"; peak GB {[r['peak_gb'] for r in ranks]}; routes {json.dumps(ranks[0]['routes'])}")
    new = ranks[0]["new_launch_shapes"]
    log(f"[sharded] rank 0: {new['shapes']} launch shapes and {new['batches']} commit batches "
        f"new to this path equal their plain versions ({new['s']:.1f}s)")
    return dict(ranks=size, backend=backend, columns=SHARDED_COLUMNS, seconds=ranks_s,
                new_launch_shapes=ranks[0]["new_launch_shapes"],
                one_device=dict(keygen_s=keygen_s, prove_s=prove_s),
                per_rank=[{key: r[key] for key in ("rank", "keygen_s", "prove_s", "peak_gb",
                                                   "collectives", "routes", "primitives")}
                          for r in ranks],
                launches=ranks[0]["launches"], oracle=oracle)


def phase_sharded(dev, srs, proof: bytes, keygen_s: float, prove_s: float,
                  seen_shapes: dict, seen_sizes: set) -> dict:
    """Phase 13: SHARDED_RANKS gloo ranks spawned on the one card
    (`sharded_group`, its new launch shapes and batches held against
    `seen_shapes` and `seen_sizes`), then a one-rank NCCL group runs the
    primitives at D = 1, the card's tensors handed to NCCL; in a new
    directory under build/, removed at the end."""
    import tempfile

    from webauthn_halo2_tpu_torch.parallel.ranks import run_ranks

    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    run_dir = tempfile.mkdtemp(prefix="chip_smoke_sharded_", dir=os.path.join(ROOT, "build"))
    try:
        out = sharded_group("gloo", SHARDED_RANKS, run_dir, dev, srs, proof, keygen_s, prove_s,
                            seen_shapes, seen_sizes)
        oracle = out.pop("oracle")
        t0 = time.time()
        try:
            nccl = run_ranks(_nccl_rank, 1, os.path.join(run_dir, "nccl"), backend="nccl",
                             args=(run_dir,), timeout=300)[0]
        except Exception as e:  # noqa: BLE001 - a failure fails the run
            _rank_logs(run_dir)
            fail(f"the one-rank NCCL group failed: {e}")
        nccl_s = time.time() - t0
        bad = [name for name, p in nccl["primitives"].items() if not p["equal"]]
        if bad or nccl["primitives"]["msm"].pop("point") != oracle:
            fail(f"the one-rank NCCL group's {bad or ['msm']} differ from one device or the oracle")
        if nccl["mesh"] != [0, 1, "cuda:0", "nccl"]:
            fail(f"the NCCL mesh is {nccl['mesh']}")
        log(f"[sharded] one-rank NCCL group in {nccl_s:.1f}s: every primitive equals one "
            "device")
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)
    out["nccl"] = dict(seconds=nccl_s, primitives=nccl["primitives"])
    return out


DP_RANKS = 2
DP_BATCH = 4


def _dp_requests() -> list:
    """Phase 14's four signatures (fresh keys and messages)."""
    return [_signed_request(14000 + i, 14100 + i) for i in range(DP_BATCH)]


def _dp_seed(i: int) -> bytes:
    """The prover rng's seed of phase 14's proof i."""
    return b"data parallel %d" % i


def _dp_rank(rank: int, size: int, log_dir: str, key_dir: str, seen_shapes: dict,
             seen_sizes: set) -> dict:
    """One of phase 14's ranks: the key from phase 9's file, then its
    round-robin share of the four signatures through batch.prove_shard,
    the launch counters from zero. The rank's thread keeps its current
    device (card 0): every launch goes to the key's card by its tensors.
    Rank 0 records the launch shapes and commit batches of its proofs and
    holds those not in `seen_shapes` and `seen_sizes` against their plain
    versions."""
    _rank_log(log_dir, rank)
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // size))
    from webauthn_halo2_tpu_torch import api
    from webauthn_halo2_tpu_torch.circuits.ecdsa_circuit import CircuitParams
    from webauthn_halo2_tpu_torch.ops import kernels as K
    from webauthn_halo2_tpu_torch.parallel import batch as B
    from webauthn_halo2_tpu_torch.parallel import sharded as S
    from webauthn_halo2_tpu_torch.plonk.srs import get_srs

    K.build_all()  # the parent's libraries, loaded
    dev = S.make_mesh().device  # cuda:(rank % cards): cuda:0 for both ranks here
    params = CircuitParams()
    t0 = time.time()
    pk = api.proving_key(params, device=dev, cache_dir=key_dir)
    torch.cuda.synchronize()
    load_s = time.time() - t0
    witnesses = api.request_witnesses(_dp_requests(), params)
    shapes = {name: [] for name in seen_shapes}
    batches = []
    _zero_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    stop = _recording(shapes, batches) if rank == 0 else None
    shard = B.prove_shard(pk, witnesses, [B.seeded_rng(_dp_seed(i)) for i in range(DP_BATCH)])
    if stop:
        stop()
    out = dict(rank=rank, device=str(dev), load_s=load_s, proofs=shard.proofs,
               records=shard.ranks, launches=_counts(),
               peak_gb=_gb(torch.cuda.max_memory_allocated(dev)),
               thread_device=torch.cuda.current_device())
    if rank == 0:
        t0 = time.time()
        gen = torch.Generator(device=dev).manual_seed(SHARDED_SEED + 14)
        srs = get_srs(params.degree, device=dev)
        checked = phase_new_launch_shapes(dev, gen, "dp", seen_shapes, shapes, srs,
                                          seen_sizes, batches)
        new = sum(len(set(keys) - set(seen_shapes[name])) for name, keys in shapes.items())
        out["new_launch_shapes"] = dict(shapes=new, batches=checked - new,
                                        s=time.time() - t0)
    return out


def phase_data_parallel(api, dev, key_dir: str, signed: tuple, proof: bytes,
                        seen_shapes: dict, seen_sizes: set) -> dict:
    """Phase 14, untraced: the four signatures proved in this process by
    api.generate_proofs_batch, then by DP_RANKS gloo ranks sharing the card
    (`_dp_rank`, phase 9's key file in `key_dir`), in a new directory
    under build/, removed at the end. Returns the numbers, rank 0's launch
    counts under "launches"."""
    import tempfile

    from webauthn_halo2_tpu_torch.circuits.ecdsa_circuit import CircuitParams
    from webauthn_halo2_tpu_torch.parallel.ranks import run_ranks

    params = CircuitParams()
    reqs = _dp_requests()
    seen = {name: sorted(set(keys)) for name, keys in seen_shapes.items()}
    trace = os.environ.pop("WH2_TRACE", None)  # the ranks inherit the environment
    run_dir = tempfile.mkdtemp(prefix="chip_smoke_dp_", dir=os.path.join(ROOT, "build"))
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.time()
        alone = api.generate_proofs_batch(reqs, params=params, device=dev,
                                          rngs=[_det_rng(_dp_seed(i)) for i in range(DP_BATCH)])
        torch.cuda.synchronize()
        one_s = time.time() - t0
        one_peak = _gb(torch.cuda.max_memory_allocated(dev))
        torch.cuda.empty_cache()
        t0 = time.time()
        try:
            ranks = run_ranks(_dp_rank, DP_RANKS, os.path.join(run_dir, "gloo"),
                              args=(run_dir, key_dir, seen, set(seen_sizes)), timeout=600)
        except Exception as e:  # noqa: BLE001 - every rank failure fails the run
            _rank_logs(run_dir)
            fail(f"the data-parallel ranks failed: {e}")
        ranks_s = time.time() - t0
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)
        if trace is not None:
            os.environ["WH2_TRACE"] = trace
    vk = api.proving_key(params, device=dev).vk.transcript_repr
    proved = {}
    for r in ranks:
        records = r["records"]
        if len({rec["vk"] for rec in records}) != 1 or records[0]["vk"] != vk:
            fail(f"rank {r['rank']}: the ranks' vk digests differ from each other or the key's")
        if r["device"] != "cuda:0" or r["thread_device"] != 0:
            fail(f"rank {r['rank']} proved on {r['device']}, its thread on {r['thread_device']}")
        for name in ("montmul", "ntt_stage_a", "ntt_stage_b", "msm_interior", "msm_scan",
                     "msm_combine"):
            if not r["launches"][name]:
                fail(f"rank {r['rank']}: kernel {name} was never launched on the dp path")
        proved.update(r["proofs"])
    if sorted(proved) != list(range(DP_BATCH)):
        fail(f"the ranks proved {sorted(proved)}, not each of 0..{DP_BATCH - 1} once")
    for i, p in proved.items():
        if p != alone[i]:
            fail(f"index {i}: the rank's proof differs from the one-process proof")
        if not api.verify(p, params=params, device=dev):
            fail(f"index {i}: api.verify rejected the rank's proof")
        if api.verify(_flip(p), params=params, device=dev):
            fail(f"index {i}: api.verify accepted a flipped proof")
    records = ranks[0]["records"]
    per_rank = [dict(rank=rec["rank"], indices=rec["indices"], prove_s=rec["prove_s"],
                     verify_s=rec["verify_s"],
                     proofs_per_s=len(rec["indices"]) / rec["prove_s"],
                     peak_gb=r["peak_gb"], load_s=r["load_s"])
                for rec, r in zip(records, ranks)]
    out = dict(ranks=DP_RANKS, batch=DP_BATCH, backend="gloo", untraced=True,
               one_process=dict(s=one_s, proofs_per_s=DP_BATCH / one_s, peak_gb=one_peak),
               proofs_per_s=DP_BATCH / max(rec["prove_s"] for rec in records),
               ranks_s=ranks_s, per_rank=per_rank,
               new_launch_shapes=ranks[0]["new_launch_shapes"], launches=ranks[0]["launches"])
    new = out["new_launch_shapes"]
    log(f"[dp] {DP_RANKS} gloo ranks on the card, each its round robin of {DP_BATCH} "
        f"signatures: every index equals the one-process proof, one vk digest "
        f"({vk:#x}), every proof verifies and a flipped byte does not; proofs/s "
        f"{out['proofs_per_s']:.4f} (ranks: "
        f"{[round(p['proofs_per_s'], 4) for p in per_rank]}) against "
        f"{out['one_process']['proofs_per_s']:.4f} in one process ({one_s:.2f}s); peak GB "
        f"{[p['peak_gb'] for p in per_rank]} (one process {one_peak}); the ranks "
        f"{ranks_s:.1f}s with the spawn; rank 0: {new['shapes']} launch shapes and "
        f"{new['batches']} commit batches new to this path equal their plain versions "
        f"({new['s']:.1f}s)")
    if torch.cuda.device_count() < 2:
        out["second_card"] = "skipped: one card"
        log("[dp] api.generate_proof(device=\"cuda:1\") from a thread on cuda:0: skipped "
            "for want of a second card (scripts/launch_multihost_torch.py checks it on "
            "four)")
    else:
        other = api.generate_proof(*signed, params=params, device="cuda:1",
                                   rng=_det_rng(b"chip_smoke"))
        out["second_card"] = dict(equal=other == proof,
                                  current_device=torch.cuda.current_device())
        log(f"[dp] api.generate_proof(device=\"cuda:1\") from a thread on cuda:0: "
            f"{json.dumps(out['second_card'])}")
        if other != proof or torch.cuda.current_device() != 0:
            fail("the proof on cuda:1 differs from phase 5's, or moved the thread's device")
    return out


COMMIT_BATCH = 9

KERNEL_META = {
    "montmul": ("webauthn_halo2_tpu_torch/csrc/montmul.cu",
                "webauthn_halo2_tpu/ops/pallas_kernels.py:67"),
    "ntt_stage_a": ("webauthn_halo2_tpu_torch/csrc/ntt.cu",
                    "webauthn_halo2_tpu/ops/ntt_pallas.py:82"),
    "ntt_stage_b": ("webauthn_halo2_tpu_torch/csrc/ntt.cu",
                    "webauthn_halo2_tpu/ops/ntt_pallas.py:133"),
    "msm_interior": ("webauthn_halo2_tpu_torch/csrc/msm.cu",
                     "webauthn_halo2_tpu/ops/msm_pallas.py:403"),
    "msm_scan": ("webauthn_halo2_tpu_torch/csrc/msm.cu",
                 "webauthn_halo2_tpu/ops/msm_pallas.py:492"),
    "msm_combine": ("webauthn_halo2_tpu_torch/csrc/combine.cu",
                    "webauthn_halo2_tpu/ops/msm_pallas.py:712"),
    "msm_interior_v1": ("webauthn_halo2_tpu_torch/csrc/msm.cu",
                        "webauthn_halo2_tpu/ops/msm_pallas.py:269"),
    "ec_add_unsafe": ("webauthn_halo2_tpu_torch/csrc/ec.cu",
                      "webauthn_halo2_tpu/ops/pallas_kernels.py:137"),
    "mxu_montmul": ("webauthn_halo2_tpu_torch/csrc/mxu.cu",
                    "webauthn_halo2_tpu/ops/mxu_mod.py:363"),
}
# Phase 15's degrees, from the reference's benchmark range k = 11 to 19: the
# deepest circuit; the widest one the reference circuit can key (at k = 11
# and 12 its one constants column, a row for each distinct constant, is
# longer than 2^k, and keygen refuses it in the JAX package as in the port);
# and k = 11, whose launch shapes are the widest, checked on random inputs.
DEGREE_DEEP = 19
DEGREE_WIDE = 13
DEGREE_REFUSED = 11


def _degree_srs(k: int, cache_dir: str, dev, srs17):
    """get_srs(k) generated into `cache_dir` (held in memory until popped),
    and its seconds; its first min(2^k, 2^17) monomial points must be the
    committed k=17 SRS's: they depend only on the seed."""
    from webauthn_halo2_tpu_torch.plonk import srs as S

    t0 = time.time()
    srs = S.get_srs(k, cache_dir=cache_dir, device=dev)
    torch.cuda.synchronize()
    seconds = time.time() - t0
    m = 1 << min(k, srs17.k)
    if not all(torch.equal(a[:, :m], b[:, :m]) for a, b in zip(srs.g_mono, srs17.g_mono)):
        fail(f"the k={k} SRS's monomial points are not the committed k=17 SRS's first {m}")
    return srs, seconds


def _msm_sums(rows: list) -> dict:
    """Each MSM kernel's ms and bound ms summed over timed batch rows."""
    out: dict = {}
    for crow in rows:
        for name, r in crow.items():
            ms, bound = out.get(name, (0.0, 0.0))
            out[name] = (ms + r["ms"], bound + RL.bound_ms(r)[0])
    return {name: dict(ms=ms, bound_ms=bound) for name, (ms, bound) in out.items()}


def _fits(params):
    """The circuit at `params` built from the dummy inputs; fails the run
    unless it fits at the first try (no AssertionError)."""
    from webauthn_halo2_tpu_torch.circuits.ecdsa_circuit import ECDSACircuit, ECDSAInputs

    try:
        return ECDSACircuit(params).build(ECDSAInputs.dummy())
    except AssertionError as e:
        fail(f"auto_params({params.degree}) does not fit at the first try: {e}")


def phase_degrees(api, dev, gen, signed, srs17, seen_shapes: dict, counts,
                  zero_counts) -> tuple:
    """Phase 15: the ECDSA circuit of auto_params(k) at the ends of the
    reference's degree range, in a new directory under build/ (removed at
    the end). k = 11: the build of 497 + 80 columns with balanced placement
    holds 5,832 constants in one column of 2^11 rows, and
    api.download_keys raises ValueError, as the JAX package's keygen does;
    the SRS is generated, and the kernels run at the launch shapes a k = 11
    proof would have, on random inputs, against their plain versions: the
    advice commit batch (497 + 80 columns, R = 37 x 577 rows), the
    quotient's transforms and montmul over its stack on the extended domain
    of 2^13. k = 13, the widest the reference keys (118 + 19 columns,
    balanced): the SRS generated; api.download_keys into ./keys of the work
    directory, the in-memory keys dropped; the port's server in a thread
    there: a WebAuthn assertion through /prove, /verify (a flipped proof
    rejected), as tests/test_server_e2e.py runs the JAX server at a degree
    other than 17; api.generate_proof of phase 5's signature with a
    deterministic rng from the manifest, api.verify on both host paths
    (a flipped proof rejected); the same proof on the serial route,
    byte-equal. (scripts/sweep_torch_degrees.py makes and checks a GWC
    proof at every degree.) k = 19 (2 + 1 columns, n = 2^19,
    an extended domain of 2^21): the SRS generated, keygen, the proof,
    api.verify on both host paths. Every SRS's monomial points are the
    committed k=17 SRS's first points. Every launch shape and commit batch
    of these runs that the earlier phases did not check goes through
    `phase_new_launch_shapes`; rows 1-3 are replayed at each proof's launch
    shapes and rows 4-6 timed on its commit batches, beside their bounds.
    The launch counts of the v3 runs (every kernel launched but the checks)
    are the "deg" path's, the serial proof's "deg_serial". Returns (those
    two, the numbers for the `degrees` line)."""
    import tempfile
    import threading
    import urllib.error
    import urllib.request

    from webauthn_halo2_tpu_torch.circuits.ecdsa_circuit import auto_params
    from webauthn_halo2_tpu_torch.client import webauthn as wa
    from webauthn_halo2_tpu_torch.fields.limbs import FQ_SPEC, FR_SPEC
    from webauthn_halo2_tpu_torch.fields.ref_curve import P256_CURVE
    from webauthn_halo2_tpu_torch.ops import msm as MS
    from webauthn_halo2_tpu_torch.ops import msm_fused as MF
    from webauthn_halo2_tpu_torch.ops import ntt as N
    from webauthn_halo2_tpu_torch.plonk import keygen as KG
    from webauthn_halo2_tpu_torch.plonk import srs as S
    from webauthn_halo2_tpu_torch.server import app

    api._PK_CACHE.clear()
    torch.cuda.empty_cache()
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="chip_smoke_degrees_", dir=os.path.join(ROOT, "build"))
    seen = {name: list(v) for name, v in seen_shapes.items()}
    deg: dict = {}
    summary: dict = {}

    def take():  # the v3 runs' launches so far into `deg`, then from zero
        for name, v in counts().items():
            deg[name] = deg.get(name, 0) + v
        zero_counts()

    def check_new(tag, shapes, srs, batches=(), sizes=(), timed=None, spec=None):
        """phase_new_launch_shapes against everything checked so far; the
        checks' own launches are not counted."""
        new = phase_new_launch_shapes(dev, gen, tag, seen, shapes, srs, sizes, batches,
                                      spec=spec, timed=timed)
        for name, keys in shapes.items():
            seen[name] = seen[name] + keys
        zero_counts()
        return new

    def replay(proof_shapes, timed):
        """Rows 1-3 replayed at the proof's launch shapes, rows 4-6 timed on
        its batches: {kernel: {ms, bound_ms}} over the proof."""
        out = {name: dict(ms=ms, bound_ms=bound) for name, (ms, bound, _) in
               phase_launch_shapes(dev, gen, proof_shapes).items()}
        out.update(_msm_sums(timed))
        zero_counts()
        return out

    srs_shapes = {"montmul": [], "ntt_stage_a": [], "ntt_stage_b": []}
    cwd = os.getcwd()
    try:
        zero_counts()
        # k = 11: not keyable; the widest launch shapes on random inputs
        k = DEGREE_REFUSED
        t0 = time.time()
        params = auto_params(k)
        cs, fixed, _advice, _copies = _fits(params)
        consts = len(fixed[params.num_advice])
        stop = _record_launch_shapes(srs_shapes)
        srs11, srs11_s = _degree_srs(k, work, dev, srs17)
        stop()
        try:
            api.download_keys(k, os.path.join(work, "k11", "proving_key.pk"),
                              os.path.join(work, "k11", "verifying_key.vk"), params=params,
                              device=dev)
            fail(f"api.download_keys keyed k={k}, whose constants column has {consts} rows")
        except ValueError as e:
            refusal = str(e)
        take()
        domain = KG._domain_for(cs, k)
        ek = domain.extended_k
        m_stack = (cs.num_advice + cs.num_instance + cs.num_perm_chunks()
                   + 5 * len(cs.lookups) + 1)
        log_t, cq = N.stage_a_schedule(m_stack, ek)
        wide = {"montmul": [(m_stack << ek, False, False)],
                "ntt_stage_a": [(m_stack, 1 << ek, log_t, cq)],
                "ntt_stage_b": [(m_stack, 1 << ek, s) for s in range(log_t, ek)]}
        wide_rows: list = []
        scalars = _rand_words(FR_SPEC, (cs.num_advice, srs11.n), gen, dev)
        new11 = check_new(f"deg k={k}", wide, srs11, [(srs11.g_lag, scalars)], timed=wide_rows)
        del scalars
        kernels11 = replay(wide, wide_rows)
        summary[k] = dict(
            num_advice=params.num_advice, num_lookup=params.num_lookup_advice,
            balance=params.balance_columns, n=1 << k, constants=consts,
            download_keys=refusal, srs_s=srs11_s, advice_batch=cs.num_advice,
            quotient_stack=m_stack, extended_k=ek, shapes_checked=new11,
            kernels_at_shapes=kernels11, seconds=time.time() - t0)
        log(f"[degrees] k={k}: {params.num_advice}+{params.num_lookup_advice} columns, "
            f"balanced; {consts} constants in one column of {1 << k} rows; download_keys "
            f"raised ValueError: {refusal}; SRS generated in {srs11_s:.2f}s; {new11} launch "
            f"shapes of a k={k} proof (the advice batch of {cs.num_advice} columns, the "
            f"quotient stack of {m_stack} on 2^{ek}) equal their plain versions: "
            + json.dumps(kernels11))
        del srs11
        S._SRS_MEM_CACHE.pop((k, b"dev", str(dev)))
        torch.cuda.empty_cache()

        # k = 13: the widest keyable circuit, through download_keys, the
        # server and api from the manifest; the serial route
        k = DEGREE_WIDE
        t0 = time.time()
        params = auto_params(k)
        _fits(params)
        stop = _record_launch_shapes(srs_shapes)
        srs13, srs13_s = _degree_srs(k, work, dev, srs17)
        stop()
        take()
        shapes = {"montmul": [], "ntt_stage_a": [], "ntt_stage_b": []}
        proof_shapes = {"montmul": [], "ntt_stage_a": [], "ntt_stage_b": []}
        batches: list = []
        stop_batches = _record_window_sums(batches)
        stop_shapes = _record_launch_shapes(shapes)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        os.chdir(work)
        pk_path, vk_path = "./keys/proving_key.pk", "./keys/verifying_key.vk"
        t1 = time.time()
        api.download_keys(k, pk_path, vk_path, params=params, device=dev)
        torch.cuda.synchronize()
        keygen_s = time.time() - t1
        api._PK_CACHE.clear()  # every later call reads the manifest and its key file
        keygen_batches = len(batches)
        srv = app.ThreadingHTTPServer(("127.0.0.1", 0), app.Handler)
        thread = threading.Thread(target=srv.serve_forever, daemon=True, name="server")
        thread.start()
        base_url = f"http://127.0.0.1:{srv.server_address[1]}"

        def post(route: str, body: dict) -> str:
            req = urllib.request.Request(base_url + route, data=json.dumps(body).encode(),
                                         headers={"Content-Type": "application/json"},
                                         method="POST")
            try:
                with urllib.request.urlopen(req, timeout=600) as r:
                    code, text = r.status, r.read().decode()
            except urllib.error.HTTPError as e:
                code, text = e.code, e.read().decode()
            if code != 200:
                fail(f"{route} at k={k} answered {code} {text[:300]!r}")
            return text

        try:
            sk = 1 + _Seeded(31337).randbelow(P256_CURVE.n - 1)
            cred = wa.Credential("webauthn-halo2-tpu.local", bytes(range(32)), sk,
                                 P256_CURVE.mul(sk, P256_CURVE.g))
            assertion = wa.authenticate(cred, b"chip_smoke degrees",
                                        k=1 + _Seeded(4242).randbelow(P256_CURVE.n - 1))
            t1 = time.time()
            proof_hex = post("/prove", wa.prove_request_body(assertion, cred))
            server_prove_s = time.time() - t1
            verdicts = [post("/verify", {"verifying_key_path": vk_path, "proof": proof_hex}),
                        post("/verify", {"verifying_key_path": vk_path,
                                         "proof": _flip(bytes.fromhex(proof_hex)).hex()})]
        finally:
            srv.shutdown()
            srv.server_close()
            thread.join(30)
        if verdicts != ["verified", "rejected"]:
            fail(f"/verify at k={k} answered {verdicts}, not ['verified', 'rejected']")
        mark = len(batches)
        stop_proof = _record_launch_shapes(proof_shapes)
        t1 = time.time()
        proof = api.generate_proof(*signed, proving_key_path=pk_path, device=dev,
                                   rng=_det_rng(b"chip_smoke degrees"))
        prove_s = time.time() - t1
        stop_proof()
        proof_batches = batches[mark:]
        host = _both_paths(f"api.verify (k={k})",
                           lambda data: api.verify(data, vk_path, device=dev), proof)
        peak = _gb(torch.cuda.max_memory_allocated() - base)
        stop_shapes()
        stop_batches()
        take()
        KG.MSM_ENGINE = MS
        try:
            t1 = time.time()
            serial_proof = api.generate_proof(*signed, proving_key_path=pk_path, device=dev,
                                              rng=_det_rng(b"chip_smoke degrees"))
            serial_s = time.time() - t1
        finally:
            KG.MSM_ENGINE = MF
        deg_serial = counts()
        zero_counts()
        os.chdir(cwd)
        if serial_proof != proof:
            fail(f"the serial route's k={k} proof differs from the v3 route's")
        if not deg_serial["ec_add_unsafe"] or deg_serial["msm_interior"]:
            fail(f"the serial route at k={k} launched {deg_serial}")
        sizes = {sc.shape[1] for _, sc in proof_batches}
        new13 = check_new(f"deg k={k}", shapes, srs13, batches[:keygen_batches])
        timed13: list = []
        new13 += check_new(f"deg k={k}", {}, srs13, proof_batches, timed=timed13)
        kernels13 = replay(proof_shapes, timed13)
        del batches, proof_batches
        summary[k] = dict(
            num_advice=params.num_advice, num_lookup=params.num_lookup_advice,
            balance=params.balance_columns, srs_s=srs13_s, keygen_s=keygen_s,
            server_prove_s=server_prove_s, prove_s=prove_s, proof_bytes=len(proof),
            server_proof_bytes=len(proof_hex) // 2, verify_host_paths=host,
            serial_s=serial_s, peak_gb=peak,
            commit_batches=sorted(sizes), shapes_checked=new13, kernels_over_proof=kernels13,
            seconds=time.time() - t0)
        log(f"[degrees] k={k}: {params.num_advice}+{params.num_lookup_advice} columns, "
            f"balanced; SRS {srs13_s:.2f}s, download_keys {keygen_s:.2f}s, /prove "
            f"{server_prove_s:.2f}s and /verify {verdicts}, a proof from the manifest "
            f"{prove_s:.2f}s ({len(proof)} bytes), the serial route's proof identical "
            f"({serial_s:.2f}s), peak {peak} GB; {new13} new "
            f"launch shapes and batches equal their plain versions; over the proof: "
            + json.dumps(kernels13))
        api._PK_CACHE.clear()
        del srs13
        S._SRS_MEM_CACHE.pop((k, b"dev", str(dev)))
        torch.cuda.empty_cache()

        # k = 19: the deepest circuit
        k = DEGREE_DEEP
        t0 = time.time()
        params = auto_params(k)
        _fits(params)
        stop = _record_launch_shapes(srs_shapes)
        srs19, srs19_s = _degree_srs(k, work, dev, srs17)
        stop()
        spans19 = dict(srs19.spans)
        take()
        shapes = {"montmul": [], "ntt_stage_a": [], "ntt_stage_b": []}
        proof_shapes = {"montmul": [], "ntt_stage_a": [], "ntt_stage_b": []}
        batches = []
        stop_batches = _record_window_sums(batches)
        stop_shapes = _record_launch_shapes(shapes)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t1 = time.time()
        api.proving_key(params, device=dev)
        torch.cuda.synchronize()
        keygen_s = time.time() - t1
        keygen_batches = len(batches)
        stop_proof = _record_launch_shapes(proof_shapes)
        t1 = time.time()
        proof = api.generate_proof(*signed, params=params, device=dev,
                                   rng=_det_rng(b"chip_smoke degrees"))
        prove_s = time.time() - t1
        stop_proof()
        host = _both_paths(f"api.verify (k={k})",
                           lambda data: api.verify(data, params=params, device=dev), proof)
        peak = _gb(torch.cuda.max_memory_allocated() - base)
        stop_shapes()
        stop_batches()
        take()
        new19 = check_new(f"deg k={k}", shapes, srs19, batches[:keygen_batches])
        timed19: list = []
        new19 += check_new(f"deg k={k}", {}, srs19, batches[keygen_batches:], timed=timed19)
        kernels19 = replay(proof_shapes, timed19)
        sizes = sorted({sc.shape[1] for _, sc in batches[keygen_batches:]})
        del batches
        summary[k] = dict(
            num_advice=params.num_advice, num_lookup=params.num_lookup_advice,
            balance=params.balance_columns, srs_s=srs19_s, srs_spans=spans19,
            keygen_s=keygen_s, prove_s=prove_s, proof_bytes=len(proof),
            verify_host_paths=host, peak_gb=peak, commit_batches=sizes,
            shapes_checked=new19, kernels_over_proof=kernels19, seconds=time.time() - t0)
        log(f"[degrees] k={k}: {params.num_advice}+{params.num_lookup_advice} columns; SRS "
            f"generated in {srs19_s:.2f}s " + json.dumps({n: round(v, 3) for n, v in
                                                          spans19.items()})
            + f", keygen {keygen_s:.2f}s, proof {prove_s:.2f}s ({len(proof)} bytes), peak "
            f"{peak} GB; {new19} new launch shapes and batches equal their plain versions; "
            "over the proof: " + json.dumps(kernels19))
        api._PK_CACHE.clear()
        del srs19
        S._SRS_MEM_CACHE.pop((k, b"dev", str(dev)))
        new_srs = check_new("deg SRS", srs_shapes, None, spec=FQ_SPEC)
        summary["srs_shapes_checked"] = new_srs
    finally:
        os.chdir(cwd)
        shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()
    return deg, deg_serial, summary


# Phase 16a: the rows of the deploy script's gas report that do not depend
# on the verifier (the verifier is deployed first, at the same address).
SUITE_ROWS = ("deploy EntryPoint", "deploy P256Account impl", "deploy P256AccountFactory",
              "deploy SponsorPaymaster", "deploy Counter", "paymaster.deposit(1 ETH)",
              "factory.createAccount")
GAS_ROW = re.compile(r"^  (?P<name>.+?)\s+(?P<gas>[0-9,]+)$")


def _run_script(name: str, *args, env=None, timeout: float = 300) -> tuple:
    """`python3 scripts/<name>.py args` from the root of the checkout: the
    finished process and its seconds."""
    t0 = time.time()
    run = subprocess.run([sys.executable, os.path.join(ROOT, "scripts", f"{name}.py"), *args],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=timeout)
    return run, time.time() - t0


def phase_deploy(work: str, gwc: bytes, gwc_code: str) -> dict:
    """Phase 16a: scripts/deploy_suite_torch.py with the stub verifier, then
    with the GWC verifier's deploy code that phase 9's generate_verifier
    wrote and phase 9's GWC proof (handleOps succeeds, the counter reads 1),
    the suite's rows equal to the stub run's; the same with one byte of the
    proof flipped exits nonzero naming handleOps."""
    code = os.path.join(work, "P256Verifier.code")
    with open(code, "w") as f:
        f.write(gwc_code)
    proofs = {}
    for name, data in (("gwc", gwc), ("flipped", _flip(gwc))):
        proofs[name] = os.path.join(work, f"proof_{name}.hex")
        with open(proofs[name], "w") as f:
            f.write(data.hex())
    runs = {"stub": _run_script("deploy_suite_torch")}
    for name in ("gwc", "flipped"):
        runs[name] = _run_script("deploy_suite_torch", "--verifier-code", code,
                                 "--proof", proofs[name])
    rows = {}
    for name in ("stub", "gwc"):
        run, _ = runs[name]
        if run.returncode or "counter incremented through handleOps: OK" not in run.stdout:
            log(run.stdout + run.stderr[-4000:])
            fail(f"the deploy script with the {name} verifier exited {run.returncode}")
        rows[name] = {m["name"]: int(m["gas"].replace(",", ""))
                      for m in map(GAS_ROW.match, run.stdout.splitlines()) if m}
    differ = {row: (rows["stub"].get(row), rows["gwc"].get(row)) for row in SUITE_ROWS
              if rows["stub"].get(row) is None or rows["stub"][row] != rows["gwc"].get(row)}
    if differ:
        fail(f"the deploy's suite rows differ between the stub and the GWC verifier: {differ}")
    flipped, _ = runs["flipped"]
    said = (flipped.stderr.strip().splitlines() or [""])[-1]
    if flipped.returncode == 0 or "handleOps" not in said:
        fail(f"the deploy with a flipped proof exited {flipped.returncode}: {said[:300]}")
    out = dict(rows=rows, seconds={name: s for name, (_, s) in runs.items()},
               flipped=said[:120], flipped_rc=flipped.returncode)
    log("[deploy] " + json.dumps(out))
    return out


def startup_child(argv: list) -> int:
    """Phase 16b's child process: scripts/profile_torch_keygen.py's main on
    `argv`, the field and shape of every montmul and NTT launch recorded
    into the record that --out names ("launch_shapes")."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "profile_torch_keygen", os.path.join(ROOT, "scripts", "profile_torch_keygen.py"))
    profile = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(profile)
    shapes = {"montmul": [], "ntt_stage_a": [], "ntt_stage_b": []}
    stop = _record_launch_shapes(shapes, by_field=True)
    try:
        rc = profile.main(argv)
    finally:
        stop()
    out = argv[argv.index("--out") + 1]
    with open(out) as f:
        record = json.load(f)
    record["launch_shapes"] = {name: sorted(set(keys)) for name, keys in shapes.items()}
    with open(out, "w") as f:
        json.dump(record, f)
    return rc


def _check_child_shapes(dev, gen, records: list, seen: dict) -> int:
    """Each launch shape of the start-up children that `seen` lacks, against
    its plain version in its own field (phase_new_launch_shapes). Returns
    how many were checked."""
    from webauthn_halo2_tpu_torch.fields.limbs import FQ_SPEC, FR_SPEC

    for name in seen:
        fields = {key[0] for r in records for key in r["launch_shapes"][name]}
        # phase_new_launch_shapes replays an NTT in Fr only
        if fields - ({FR_SPEC.name, FQ_SPEC.name} if name == "montmul" else {FR_SPEC.name}):
            fail(f"a start-up child launched {name} in {sorted(fields)}")
    checked = 0
    for spec in (FR_SPEC, FQ_SPEC):
        new = {name: [tuple(key[1:]) for r in records for key in r["launch_shapes"][name]
                      if key[0] == spec.name] for name in seen}
        checked += phase_new_launch_shapes(dev, gen, f"startup {spec.name}", seen, new,
                                           spec=spec)
    return checked


def phase_startup(api, params, dev, gen, signed, proof: bytes, vk_repr: int, seen: dict,
                  work: str) -> tuple:
    """Phase 16b: scripts/profile_torch_keygen.py at k=17 in two child
    processes (startup_child) with WH2_KEY_DIR and WH2_SRS_DIR set to new
    empty directories and phase 5's signature and rng. The first generates
    and saves the SRS, makes and saves the key and proves; the second loads
    both: the vk of both is phase 4's, both proofs are phase 5's bytes.
    Each launch shape of the children that `seen` lacks is held against its
    plain version in its field. Then this process's api.proving_key, its
    in-memory key dropped, loads the key from WH2_KEY_DIR (no keygen span)
    and proves phase 5's bytes. Returns the first child's kernel launches
    and the summary."""
    keys, srs_dir = os.path.join(work, "keys"), os.path.join(work, "srs")
    os.makedirs(keys)
    os.makedirs(srs_dir)
    env = dict(os.environ, WH2_KEY_DIR=keys, WH2_SRS_DIR=srs_dir)
    torch.cuda.empty_cache()  # the children share the card
    records = []
    for child in (1, 2):
        out = os.path.join(work, f"startup_{child}.json")
        t0 = time.time()
        run = subprocess.run(
            [sys.executable, "-c", "import sys, chip_smoke\n"
             "sys.exit(chip_smoke.startup_child(sys.argv[1:]))",
             "--degree", str(params.degree), "--signature", b"".join(signed).hex(),
             "--rng-seed", "chip_smoke", "--out", out],
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
        seconds = time.time() - t0
        if run.returncode:
            log(run.stdout[-2000:] + run.stderr[-6000:])
            fail(f"start-up child {child} exited {run.returncode}")
        table = run.stderr[run.stderr.find("start-up at"):run.stderr.find("record:")]
        log(f"[startup] child {child}, {seconds:.1f}s as a process:\n{table.rstrip()}")
        with open(out) as f:
            records.append(json.load(f) | {"process_s": seconds})
    first, second = records
    if (first["srs"], first["key"], second["srs"], second["key"]) != (
            "generated", "made", "loaded", "loaded"):
        fail(f"the children's SRS and key came {first['srs']}, {first['key']} and "
             f"{second['srs']}, {second['key']}, not generated, made and loaded, loaded")
    if (sorted(os.listdir(srs_dir)) != [os.path.basename(first["srs_file"])]
            or sorted(os.listdir(keys)) != [os.path.basename(first["key_file"])]):
        fail(f"WH2_SRS_DIR holds {os.listdir(srs_dir)} and WH2_KEY_DIR {os.listdir(keys)}")
    if {first["vk_transcript_repr"], second["vk_transcript_repr"]} != {hex(vk_repr)}:
        fail("a child's vk differs from phase 4's")
    if {first["proof_hex"], second["proof_hex"]} != {proof.hex()}:
        fail("a child's proof of phase 5's signature and rng differs from phase 5's bytes")
    t0 = time.time()
    shapes_checked = _check_child_shapes(dev, gen, records, seen)
    log(f"[startup] {shapes_checked} launch shapes of the children new to the run equal "
        f"their plain versions ({time.time() - t0:.1f}s)")
    saved = os.environ.get("WH2_KEY_DIR")
    os.environ["WH2_KEY_DIR"] = keys
    try:
        api._PK_CACHE.clear()
        t0 = time.time()
        pk = api.proving_key(params, device=dev)
        torch.cuda.synchronize()
        load_s = time.time() - t0
        again = api.generate_proof(*signed, params=params, device=dev,
                                   rng=_det_rng(b"chip_smoke"))
    finally:
        if saved is None:
            os.environ.pop("WH2_KEY_DIR")
        else:
            os.environ["WH2_KEY_DIR"] = saved
        api._PK_CACHE.clear()
    if pk.spans or pk.vk.transcript_repr != vk_repr:
        fail("api.proving_key did not load phase 4's key from WH2_KEY_DIR")
    if again != proof:
        fail("the proof from the key api.proving_key loaded from WH2_KEY_DIR differs")
    log(f"[startup] api.proving_key loaded the key from WH2_KEY_DIR in {load_s:.2f}s and "
        "proved phase 5's bytes")
    keep = ("srs", "key", "startup_s", "process_s", "steps", "reload", "keygen_spans",
            "key_file_bytes", "kernel_launches", "card", "nvidia_smi")
    summary = dict(children=[{k: r.get(k) for k in keep} for r in records],
                   second_over_first=second["startup_s"] / first["startup_s"],
                   api_proving_key_from_dir_s=load_s, new_launch_shapes=shapes_checked)
    return first["kernel_launches"], summary


def phase_cleaner(K, HB) -> dict:
    """Phase 16c: scripts/gc_torch_builds.py. With --dry-run it keeps every
    library this process loaded and lists a stale library planted under a
    made-up digest, deleting nothing; without, the planted files go, and a
    new process loads every current library without building one."""
    loaded = sorted({lib._name for lib in K._STATE.libs.values()}
                    | {lib._name for lib in HB._LIBS.values()})
    planted = [K.BUILD_DIR / f"libmontmul_0123456789abcdef{ext}" for ext in (".so", ".log")]
    if planted[0] in K.library_paths().values():
        fail("the made-up digest is the montmul library's own")
    for path in planted:
        path.write_bytes(b"a library of an older source")
    reports = {}
    for name, args in (("dry_run", ["--dry-run"]), ("run", [])):
        run, seconds = _run_script("gc_torch_builds", *args, timeout=120)
        if run.returncode:
            fail(f"gc_torch_builds {' '.join(args)} exited {run.returncode}: "
                 f"{run.stderr[-2000:]}")
        report = json.loads(run.stdout.splitlines()[-1])
        gone = set(report["stale"]) | set(report["orphaned"])
        if gone & set(loaded):
            fail(f"gc_torch_builds {' '.join(args)} would delete loaded libraries "
                 f"{sorted(gone & set(loaded))}")
        if not {str(p) for p in planted} <= set(report["stale"]):
            fail(f"gc_torch_builds {' '.join(args)} did not list the planted library: "
                 f"{report['stale']}")
        if name == "dry_run" and not all(p.exists() for p in planted):
            fail("gc_torch_builds --dry-run deleted a file")
        reports[name] = dict(seconds=seconds, stale=len(report["stale"]),
                             orphaned=len(report["orphaned"]),
                             freed_bytes=report["freed_bytes"], kept_bytes=report["kept_bytes"])
    if any(p.exists() for p in planted) or not all(os.path.exists(p) for p in loaded):
        fail("gc_torch_builds left the planted library or removed a loaded one")
    check = subprocess.run(
        [sys.executable, "-c", "import json\n"
         "from webauthn_halo2_tpu_torch.ops import kernels as K\n"
         "from webauthn_halo2_tpu_torch.utils import host_build as HB\n"
         "K.build_all(); HB.build_all()\n"
         "print(json.dumps({'built': K.BUILD_SECONDS, 'loaded': sorted("
         "[lib._name for lib in K._STATE.libs.values()] + "
         "[lib._name for lib in HB._LIBS.values()])}))"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    if check.returncode:
        fail(f"the current libraries did not load after the clean: {check.stderr[-2000:]}")
    after = json.loads(check.stdout.splitlines()[-1])
    if after["built"] or after["loaded"] != loaded:
        fail(f"after the clean a new process built {after['built']} and loaded "
             f"{after['loaded']}, not this process's {loaded} with no build")
    log(f"[gc] the dry run kept the {len(loaded)} loaded libraries and listed the planted one; "
        f"the clean removed it, and a new process loaded every library unbuilt: "
        + json.dumps(reports))
    return dict(reports, loaded_libraries=len(loaded))


def phase_operator(api, params, dev, gen, signed, proof: bytes, vk_repr: int, seen: dict,
                   gwc: bytes, gwc_code: str, K, HB) -> tuple:
    """Phase 16, in a new directory under build/ (removed at the end): the
    deploy (16a), the start-up from the key and SRS directories (16b) and
    the build cache's cleaner (16c). Returns the start-up's kernel launches
    and the summary."""
    import tempfile

    work = tempfile.mkdtemp(prefix="chip_smoke_operator_", dir=os.path.join(ROOT, "build"))
    try:
        t0 = time.time()
        deploy = phase_deploy(work, gwc, gwc_code)
        deploy["phase_s"] = time.time() - t0
        t0 = time.time()
        launches, startup = phase_startup(api, params, dev, gen, signed, proof, vk_repr, seen,
                                          work)
        startup["phase_s"] = time.time() - t0
        t0 = time.time()
        cleaner = phase_cleaner(K, HB)
        cleaner["phase_s"] = time.time() - t0
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return launches, dict(deploy=deploy, startup=startup, cleaner=cleaner)


# The path whose run counts each kernel's launches (default: the v3 main
# path) and the counter it reads there: row 7 is the interior kernel
# launched by the v1 driver; row 8 is every point add of the serial route.
KERNEL_PATH = {"msm_interior_v1": ("v1", "msm_interior"),
               "ec_add_unsafe": ("serial", "ec_add_unsafe"),
               "mxu_montmul": ("mxu", "mxu_montmul")}


def main() -> int:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a card")
    try:
        from webauthn_halo2_tpu_torch import api
        from webauthn_halo2_tpu_torch.circuits.ecdsa_circuit import CircuitParams
        from webauthn_halo2_tpu_torch.ops import ec as E
        from webauthn_halo2_tpu_torch.ops import kernels as K
        from webauthn_halo2_tpu_torch.ops import msm as MS
        from webauthn_halo2_tpu_torch.ops import msm_fused as MF
        from webauthn_halo2_tpu_torch.ops import msm_v1 as MV
        from webauthn_halo2_tpu_torch.plonk import keygen as KG
        from webauthn_halo2_tpu_torch.plonk import prover as PR
        from webauthn_halo2_tpu_torch.plonk.srs import get_srs
    except ImportError as e:
        fail(f"the port's package is not here: {e}")
    if RL is None:
        fail("the port's package is not here: no webauthn_halo2_tpu_torch.utils.roofline")
    from webauthn_halo2_tpu_torch.utils import host_build as HB

    # the phases read the prover's and keygen's spans, which only a traced
    # run records (phase 12 times its batch untraced)
    os.environ.setdefault("WH2_TRACE", "1")
    dev = torch.device("cuda", torch.cuda.current_device())  # as the port names a card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip().splitlines()
    card = smi[0] if smi else "nvidia-smi gave nothing"
    t_all = time.time()
    if KG.MSM_ENGINE is not MF:
        fail("the commit engine is not the v3 pipeline, the main path")

    # 1. build: the host libraries (g++) in a thread beside the kernels' nvcc
    t0 = time.time()
    host = {}

    def build_host():
        try:
            HB.build_all()
        except RuntimeError as e:
            host["error"] = str(e)
        host["s"] = time.time() - t0

    host_thread = threading.Thread(target=build_host, name="host build")
    host_thread.start()
    K.build_all()
    host_thread.join()
    if "error" in host:
        fail(f"the host libraries did not build: {host['error']}")
    log(f"[build] host libraries {', '.join(HB.SOURCES)} built with g++ beside the kernels "
        f"in {host['s']:.1f}s ({HB.BUILD_DIR})")
    log(f"[build] kernels {', '.join(K.SOURCES)} built in {time.time() - t0:.1f}s "
        f"(each from the start: {json.dumps({k: round(v, 1) for k, v in K.BUILD_SECONDS.items()})}; "
        f"compiler reports: {K.BUILD_DIR}/*.log)")
    for name in K.SOURCES:
        report = K._so_path(name).with_suffix(".log")
        if report.exists():
            log(f"[build] ptxas {name}.cu: {json.dumps(_ptxas_report(report.read_text()))}")

    # 2. kernels against their plain versions
    t0 = time.time()
    gen = torch.Generator(device=dev).manual_seed(17)
    rows = phase_kernels(dev, gen)
    params = CircuitParams()
    srs = get_srs(params.degree, device=dev)
    rows.update(phase_msm_kernels(dev, gen, srs, COMMIT_BATCH))
    rows["msm_interior_v1"] = phase_interior_v1(dev, gen, srs)
    phase_combine_sparse(dev, srs)
    nwin = -(-MS.SCALAR_BITS // MS._default_c(srs.n))
    rows["ec_add_unsafe"] = phase_ec_add(dev, gen, srs, nwin * COMMIT_BATCH,
                                         MS._default_lanes(srs.n))
    rows["mxu_montmul"], mxu_launches = phase_mxu(dev, gen)
    log(f"[kernels] all kernels equal their plain versions ({time.time() - t0:.1f}s)")

    # 3. a full k=17 MSM batch: v3 pipeline == serial Pippenger == oracle
    t0 = time.time()
    phase_msm_batch(dev, gen, srs, COMMIT_BATCH)
    log(f"[msm] done ({time.time() - t0:.1f}s)")

    # 4-6: the main path, with the launch counters from zero; the batches
    # that reach the v3 pipeline are recorded on the way (bases and a copy
    # of the scalars)
    batches = []
    stop_recording = _record_window_sums(batches)

    counts, zero_counts = _counts, _zero_counts
    zero_counts()
    t0 = time.time()
    pk = api.proving_key(params, device=dev)
    torch.cuda.synchronize()
    keygen_s = time.time() - t0
    log(f"[keygen] k={params.degree} ECDSA circuit: {keygen_s:.1f}s "
        f"vk={pk.vk.transcript_repr:#x} "
        + json.dumps({k: round(v, 3) for k, v in pk.spans.items()}))

    signed = _signed_message()

    def prove():
        return api.generate_proof(*signed, params=params, device=dev,
                                  rng=_det_rng(b"chip_smoke"))

    after_keygen = counts()
    keygen_batches = len(batches)
    launch_shapes = {"montmul": [], "ntt_stage_a": [], "ntt_stage_b": []}
    stop_shapes = _record_launch_shapes(launch_shapes)
    t0 = time.time()
    proof = prove()
    prove_s = time.time() - t0
    stop_shapes()
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
    verification = {"api.verify": _both_paths(
        "api.verify", lambda data: api.verify(data, params=params, device=dev), proof)}
    launches = counts()
    stop_recording()
    sizes = [sc.shape[1] for _, sc in batches]

    # the v3 kernels on the proof's own commit batches
    t0 = time.time()
    proof_sums, per_batch = phase_proof_batches(srs, batches[keygen_batches:],
                                                MF.lanes_for(srs.n))
    for name, (ms, bound) in proof_sums.items():
        rows[name].update(proof_ms=ms, proof_bound_ms=bound)
    rows["msm_combine"]["batches"] = [
        dict(rows=int(b["msm_combine"]["shape"].split(",")[0][2:]), ms=b["msm_combine"]["ms"],
             bound_ms=b["msm_combine"]["bound_ms"]) for b in per_batch]
    log(f"[proof batches] done ({time.time() - t0:.1f}s)")
    del batches
    for name, (ms, bound, table) in phase_launch_shapes(dev, gen, launch_shapes).items():
        rows[name].update(proof_ms=ms, proof_bound_ms=bound, proof_launch_shapes=table)
    log("[proof launches] NTT stages A and B over the proof: " + json.dumps({
        "ms": rows["ntt_stage_a"]["proof_ms"] + rows["ntt_stage_b"]["proof_ms"],
        "bound_ms": rows["ntt_stage_a"]["proof_bound_ms"]
        + rows["ntt_stage_b"]["proof_bound_ms"]}))

    # 7. the same proof on the serial route: byte for byte, every point add
    #    through the fused EC add
    # the fused EC add's launch shapes on each of the other two routes
    ec_shapes = {"serial": [], "v1": []}

    def prove_on(engine, route):
        KG.MSM_ENGINE = engine
        undo = _launch_recorder(E, "add_unsafe_cuda", lambda curve, p, q: tuple(
            torch.broadcast_shapes(*(t.shape for t in (*p, *q)))[1:]), ec_shapes[route])
        try:
            zero_counts()
            t0 = time.time()
            out = prove()
            return out, time.time() - t0, counts()
        finally:
            undo()
            KG.MSM_ENGINE = MF

    serial_proof, serial_s, serial = prove_on(MS, "serial")
    log(f"[serial] proof on the serial route in {serial_s:.1f}s: identical bytes: "
        f"{serial_proof == proof}; launches {json.dumps(serial)}")
    if serial_proof != proof:
        fail("the serial route's proof differs from the v3 route's")
    for name in ("serial_bucket_sums", "ec_add_unsafe"):
        if not serial[name]:
            fail(f"the serial route ran no {name}")

    # 8. the same proof through the v1 driver: byte for byte
    v1_proof, v1_s, v1 = prove_on(MV, "v1")
    log(f"[v1] proof on the v1 route in {v1_s:.1f}s: identical bytes: "
        f"{v1_proof == proof}; launches {json.dumps(v1)}")
    if v1_proof != proof:
        fail("the v1 route's proof differs from the v3 route's")
    for name in ("msm_interior", "msm_combine", "ec_add_unsafe"):
        if not v1[name]:
            fail(f"the v1 route launched no {name}")
    if v1["msm_scan"] or v1["serial_bucket_sums"]:
        fail("the v1 route ran the scan kernel or the serial bucket sum")

    # row 8 on each route's own launches, replayed
    routes = {}
    for route, seen in ec_shapes.items():
        ms, bound, table = phase_launch_shapes(
            dev, gen, {"ec_add_unsafe": seen}, srs)["ec_add_unsafe"]
        routes[route] = dict(launches=len(seen), ms=ms, bound_ms=bound, launch_shapes=table)
        log(f"[route launches] ec_add_unsafe on the {route} route: {len(seen)} launches, "
            f"replayed {ms:.4f} ms against a bound of {bound:.4f} ms")
    rows["ec_add_unsafe"]["routes"] = routes

    # 9. the on-chain half at k=17 through api, on the v3 route
    t9 = time.time()
    key_dir, pk_path, vk_path = phase_keys_on_disk(api, params, signed, proof, dev)
    #    the GWC/Keccak proof, with the launch counters from zero
    gwc_batches = []
    stop_recording = _record_window_sums(gwc_batches)
    gwc_shapes = {"montmul": [], "ntt_stage_a": [], "ntt_stage_b": []}
    stop_shapes = _record_launch_shapes(gwc_shapes)
    zero_counts()
    t0 = time.time()
    gwc = api.generate_proof_evm(*signed, proving_key_path=pk_path, device=dev,
                                 rng=_det_rng(b"chip_smoke"))
    gwc_s = time.time() - t0
    gwc_launches = counts()
    stop_shapes()
    stop_recording()
    gwc_spans = dict(PR.LAST_SPANS)
    gwc_sizes = [sc.shape[1] for _, sc in gwc_batches]
    log(f"[gwc] {len(gwc)} bytes in {gwc_s:.1f}s spans="
        + json.dumps({k: round(v, 3) for k, v in gwc_spans.items()})
        + f"; launches {json.dumps(gwc_launches)}; commit batches {gwc_sizes}; launch shapes "
        + json.dumps({k: len(v) for k, v in gwc_shapes.items()}))
    t0 = time.time()
    if not api.verify_evm(gwc, vk_path, device=dev):
        fail("api.verify_evm rejected the port's own GWC proof")
    if api.verify_evm(_flip(gwc), vk_path, device=dev):
        fail("api.verify_evm accepted a tampered GWC proof")
    with open(os.path.join(ROOT, "results", "proof_gwc_k17.hex")) as f:
        if not api.verify_evm(bytes.fromhex(f.read().strip()), vk_path, device=dev):
            fail("the port's verifier rejected the JAX package's k=17 GWC proof")
    log(f"[gwc] verify_evm: own proof accepted, tampered rejected, "
        f"results/proof_gwc_k17.hex accepted ({time.time() - t0:.1f}s)")
    verification["api.verify_evm"] = _both_paths(
        "api.verify_evm (GWC)", lambda data: api.verify_evm(data, vk_path, device=dev), gwc)
    n_gwc = len(gwc_sizes)
    want = {"msm_interior": n_gwc, "msm_combine": n_gwc, "msm_scan": 2 * n_gwc}
    if any(gwc_launches[k] != v for k, v in want.items()):
        fail(f"the GWC proof's v3 launches {gwc_launches} are not {want} for {n_gwc} batches")
    if gwc_launches["serial_bucket_sums"]:
        fail("the GWC proof ran the serial bucket sum")
    #    launch shapes and commit batches the v3 proof did not have, against
    #    the plain versions
    main_sizes = set(sizes[keygen_batches:])
    new_shapes = phase_new_launch_shapes(dev, gen, "gwc", launch_shapes, gwc_shapes, srs,
                                         main_sizes, gwc_batches)
    del gwc_batches
    log(f"[gwc] {new_shapes} new launch shapes and batches equal their plain versions")
    #    SHPLONK over Keccak
    t0 = time.time()
    shk = api.generate_proof_evm(*signed, proving_key_path=pk_path, scheme="shplonk",
                                 device=dev, rng=_det_rng(b"chip_smoke"))
    shk_s = time.time() - t0
    if not api.verify_evm(shk, vk_path, scheme="shplonk", device=dev):
        fail("api.verify_evm rejected the port's own SHPLONK/Keccak proof")
    log(f"[shplonk-keccak] {len(shk)} bytes in {shk_s:.1f}s, verify_evm accepted it")
    #    the verifiers in the port's EVM
    evm = phase_verifiers(api, key_dir, vk_path, dev, {"gwc": gwc, "shplonk": shk})
    with open(os.path.join(key_dir, "P256Verifier.code")) as f:  # phase 16's deploy
        gwc_code = f.read()
    precompiles = _precompile_seconds(srs)
    log(f"[onchain] done ({time.time() - t9:.1f}s): " + json.dumps(dict(
        gwc_proof_s=gwc_s, gwc_bytes=len(gwc), shplonk_keccak_s=shk_s,
        precompiles=precompiles, evm=evm)))

    # 10. ES256 at k=17, with the launch counters from zero
    t10 = time.time()
    seen = {name: launch_shapes[name] + gwc_shapes[name] for name in launch_shapes}
    es256_launches, es256 = phase_es256(dev, gen, srs, seen,
                                        main_sizes | set(gwc_sizes) | {COMMIT_BATCH},
                                        counts, zero_counts)
    log(f"[es256] done ({time.time() - t10:.1f}s)")

    # 11. SRS generation on the card, with the launch counters from zero
    t11 = time.time()
    srs_launches, srs_summary = phase_srs(dev, gen, srs, seen, counts, zero_counts)
    log(f"[srs] done ({time.time() - t11:.1f}s)")

    # 12. the proving server, the on-chain leg and batched proving
    t12 = time.time()
    server_launches, batch_launches, serving = phase_server(api, dev, counts, zero_counts)
    log(f"[server] done ({time.time() - t12:.1f}s)")
    serving["srs"] = srs_summary

    # 13. four gloo ranks on the card, both hooks on; a one-rank NCCL group
    t13 = time.time()
    sharded = phase_sharded(dev, srs, proof, keygen_s, prove_s, seen,
                            main_sizes | set(gwc_sizes) | {COMMIT_BATCH})
    log(f"[sharded] done ({time.time() - t13:.1f}s)")

    # 14. data-parallel proving: two gloo ranks on the card, phase 9's key file
    t14 = time.time()
    try:
        data_parallel = phase_data_parallel(api, dev, key_dir, signed, proof, seen,
                                            main_sizes | set(gwc_sizes) | {COMMIT_BATCH})
    finally:
        shutil.rmtree(key_dir)
    data_parallel["seconds"] = time.time() - t14
    log(f"[dp] done ({data_parallel['seconds']:.1f}s)")

    # 15. the circuit across the reference's degree range: k = 11, 13, 19
    t15 = time.time()
    deg_launches, deg_serial, degrees = phase_degrees(api, dev, gen, signed, srs, seen,
                                                      counts, zero_counts)
    degrees["seconds"] = time.time() - t15
    log(f"[degrees] done ({degrees['seconds']:.1f}s)")

    # 16. the operator's path: deploy, start-up from the key and SRS
    #     directories in two child processes, the build cache's cleaner
    t16 = time.time()
    startup_launches, operator = phase_operator(api, params, dev, gen, signed, proof,
                                                pk.vk.transcript_repr, seen, gwc, gwc_code,
                                                K, HB)
    operator["seconds"] = time.time() - t16
    log(f"[operator] done ({operator['seconds']:.1f}s)")

    # 17. counters and the kernels line
    log(f"[counters] launches during keygen+prove+verify: {json.dumps(launches)}; "
        f"keygen {json.dumps(after_keygen)}; one proof {json.dumps(per_proof)}; "
        f"commit batches {sizes}")
    if launches["serial_bucket_sums"]:
        fail("the default route ran the serial bucket sum")
    # one interior, one combine and two scan launches (tiles, join) a batch
    n_proof = len(sizes) - keygen_batches
    want = {"msm_interior": n_proof, "msm_combine": n_proof, "msm_scan": 2 * n_proof}
    if any(per_proof[k] != v for k, v in want.items()):
        fail(f"the proof's v3 launches {per_proof} are not {want} for {n_proof} batches")
    if max(sizes + gwc_sizes) > COMMIT_BATCH:
        fail(f"a commit batch of {max(sizes + gwc_sizes)} exceeds the {COMMIT_BATCH} "
             "checked in phase 2")
    by_path = {"v3": launches, "serial": serial, "v1": v1,
               "mxu": {"mxu_montmul": mxu_launches}, "gwc": gwc_launches,
               "es256": es256_launches, "srs": srs_launches, "server": server_launches,
               "batch": batch_launches, "sharded": sharded.pop("launches"),
               "dp": data_parallel.pop("launches"), "deg": deg_launches,
               "deg_serial": deg_serial, "startup": startup_launches}
    if srs_launches["montmul"] == 0:
        fail("kernel montmul was never launched on the srs path")
    for path in ("gwc", "es256", "server", "batch", "sharded", "dp", "deg", "startup"):
        for name in ("montmul", "ntt_stage_a", "ntt_stage_b", "msm_interior", "msm_scan",
                     "msm_combine"):
            if by_path[path][name] == 0:
                fail(f"kernel {name} was never launched on the {path} path")
    for name in KERNEL_META:
        path, counter = KERNEL_PATH.get(name, ("v3", name))
        if by_path[path][counter] == 0:
            fail(f"kernel {name} was never launched on its path ({path})")
    kernels = []
    for name, row in rows.items():
        path, counter = KERNEL_PATH.get(name, ("v3", name))
        bound, bound_by = RL.bound_ms(row)
        kernels.append({
            "name": name, "route": "cuda", "source": KERNEL_META[name][0],
            "replaces": KERNEL_META[name][1], "launches": by_path[path][counter],
            "max_abs_err": row["err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": bound, "bound_by": bound_by,
            "library_ms": None, "timed_by": row.get("timed_by", "cuda_events"),
            "proof_ms": row.get("proof_ms"),
            "proof_bound_ms": row.get("proof_bound_ms"), "shape": row["shape"], "path": path,
            "launches_by_path": {p: c.get(counter, 0) for p, c in by_path.items()
                                 if counter in c},
            "launches_per_proof": per_proof.get(counter) if path == "v3" else None,
            **{k: row[k] for k in ("batches", "ms_cold", "clocks", "proof_launch_shapes",
                                   "routes", "bound_terms_ms") if k in row},
        })
    log(f"[total] {time.time() - t_all:.1f}s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"es256": es256}), flush=True)
    print(json.dumps({"serving": serving}), flush=True)
    print(json.dumps({"sharded": sharded}), flush=True)
    print(json.dumps({"data_parallel": data_parallel}), flush=True)
    print(json.dumps({"degrees": degrees}), flush=True)
    print(json.dumps({"operator": operator}), flush=True)
    verification.update({"evm_call_gwc": evm["gwc"]["host_paths"],
                         "es256_verify_proof": es256["verify_host_paths"],
                         **serving["verify_host_paths"]})
    print(json.dumps({"card": card, "verification_host_paths": verification,
                      "batch": serving["batch"], "es256_windowed_quotient":
                      es256["windowed_quotient"]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
