"""KZG structured reference string: load, or generate on the device.

The committed SRS files (`artifacts/srs_bn254_k{k}_{seed hex}.npz`) hold the
JAX package's tensors: (3, 33, n) Jacobian coordinates in lazy 8-bit limbs
with Montgomery R = 2^264, plus the G2 points as ints. Loading normalises
the limbs on the host and re-encodes them as the port's words with
R = 2^256 (see convert.py).

For a degree without a committed file the SRS is generated as the JAX
package generates it: a deterministic dev tau derived from a seed hash (NOT
a production trusted setup), the G1 powers [tau^i]G and Lagrange points
[L_i(tau)]G computed on the device with an 8-bit fixed-base window table
(32 gathers and 31 complete adds a batch, every multiply through the
montmul kernel), then made affine with one batch inversion. Host Python
touches only the scalars, the table and G2. A generated SRS is saved in
the port's own format (`srs_bn254_k{k}_{seed hex}.torch.npz`: (3, 8, n)
words and a format tag) and never as a JAX file.
"""
from __future__ import annotations

import contextlib
import functools
import hashlib
import os
import sys
import threading
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..device import cached, fence, resolve, tracing
from ..fields.constants import BN254_FQ, BN254_FR, BN254_G1, BN254_G2_X, BN254_G2_Y
from ..fields.ref_curve import BN254_G1_CURVE
from ..fields.ref_field import batch_inv
from ..ops import ec as E
from ..ops import modops as M

DEFAULT_CACHE_DIR = os.path.join(os.path.dirname(__file__), "..", "..",
                                 "artifacts")
# where a generated SRS is saved when no cache_dir is given (the committed
# files' directory is never written)
DEFAULT_GEN_DIR = os.path.join(os.path.dirname(__file__), "..", "..",
                               "build", "srs")
FORMAT = b"webauthn-halo2-tpu-torch-srs-v1"
CHUNK = 1 << 16  # scalars a device batch (the JAX package's chunk)

L33 = 33  # the JAX package's limbs per element
B8 = 8
MASK8 = (1 << B8) - 1


@dataclass
class SRS:
    k: int
    tau_seed: bytes
    g_mono: E.JPoint  # [tau^i G], Montgomery affine words (8, n)
    g_lag: E.JPoint  # [L_i(tau) G]
    g2: tuple
    s_g2: tuple
    # generation phase -> seconds (empty for a loaded SRS)
    spans: dict = field(default_factory=dict, compare=False)

    @property
    def n(self) -> int:
        return 1 << self.k


def _normalize_host_limbs(a: np.ndarray, p: int) -> np.ndarray:
    """Exact host normalisation of lazy (33, n) limb arrays to canonical
    tight limbs (< p, every limb <= 255)."""
    a = a.astype(np.int64)
    out = np.empty_like(a)
    carry = np.zeros(a.shape[1:], dtype=np.int64)
    for i in range(L33):
        v = a[i] + carry
        out[i] = v & MASK8
        carry = v >> B8
    if carry.any():
        raise ValueError("limb value beyond 2^264: not a JAX field tensor")
    p_l = np.array([(p >> (B8 * i)) & MASK8 for i in range(L33)], dtype=np.int64)
    # a lazy value is below a small multiple of p: subtract p while >= p
    for _ in range(64):
        ge = np.ones(a.shape[1:], dtype=bool)
        decided = np.zeros(a.shape[1:], dtype=bool)
        for i in range(L33 - 1, -1, -1):
            gt = ~decided & (out[i] > p_l[i])
            lt = ~decided & (out[i] < p_l[i])
            ge = np.where(lt, False, ge)
            decided |= gt | lt
        if not ge.any():
            break
        borrow = np.zeros(a.shape[1:], dtype=np.int64)
        for i in range(L33):
            v = out[i] - np.where(ge, p_l[i], 0) - borrow
            borrow = (v < 0).astype(np.int64)
            out[i] = np.where(ge, v + (borrow << B8), out[i])
    return out.astype(np.int32)


def load_srs(path: str, device=None) -> SRS:
    from ..convert import point_from_jax

    dev = resolve(device)
    z = np.load(path, allow_pickle=True)
    g2 = z["g2"]
    sg2 = z["s_g2"]
    return SRS(
        int(z["k"]),
        bytes(z["seed"].tobytes()),
        point_from_jax(*z["g_mono"], device=dev),
        point_from_jax(*z["g_lag"], device=dev),
        (tuple(int(v) for v in g2[0]), tuple(int(v) for v in g2[1])),
        (tuple(int(v) for v in sg2[0]), tuple(int(v) for v in sg2[1])),
    )


# ---------------------------------------------------------------------------
# G2 host arithmetic (tiny: only tau*G2 is needed)
# ---------------------------------------------------------------------------
P = BN254_FQ


def _f2_add(a, b):
    return ((a[0] + b[0]) % P, (a[1] + b[1]) % P)


def _f2_sub(a, b):
    return ((a[0] - b[0]) % P, (a[1] - b[1]) % P)


def _f2_mul(a, b):
    return (
        (a[0] * b[0] - a[1] * b[1]) % P,
        (a[0] * b[1] + a[1] * b[0]) % P,
    )


def _f2_inv(a):
    d = pow(a[0] * a[0] + a[1] * a[1], -1, P)
    return (a[0] * d % P, (-a[1]) * d % P)


def g2_add(p1, p2):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    (x1, y1), (x2, y2) = p1, p2
    if x1 == x2:
        if (_f2_add(y1, y2)) == (0, 0):
            return None
        num = _f2_mul((3, 0), _f2_mul(x1, x1))
        den = _f2_inv(_f2_add(y1, y1))
    else:
        num = _f2_sub(y2, y1)
        den = _f2_inv(_f2_sub(x2, x1))
    lam = _f2_mul(num, den)
    x3 = _f2_sub(_f2_sub(_f2_mul(lam, lam), x1), x2)
    y3 = _f2_sub(_f2_mul(lam, _f2_sub(x1, x3)), y1)
    return (x3, y3)


def g2_mul(k, pt):
    acc, add = None, pt
    while k:
        if k & 1:
            acc = g2_add(acc, add)
        add = g2_add(add, add)
        k >>= 1
    return acc


G2_GEN = (BN254_G2_X, BN254_G2_Y)


# ---------------------------------------------------------------------------
# device fixed-base batch scalar multiplication
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=4)
def _window_table(base: tuple[int, int]) -> np.ndarray:
    """(3, 8, 32*256) Montgomery Jacobian words of d * 2^(8j) * base at
    slot j*256 + d, affine (z = 1), d == 0 the point at infinity (z = 0)."""
    pts: list[tuple[int, int] | None] = []
    block = base
    for j in range(32):
        acc = None
        for _ in range(256):
            pts.append(acc)
            acc = BN254_G1_CURVE.add(acc, block)
        for _ in range(8):
            block = BN254_G1_CURVE.add(block, block)
    jp = E.from_affine_ints(E.BN254_CURVE, pts)
    return np.stack([c.numpy() for c in jp])


def scalar_digits(scalars: list[int]) -> np.ndarray:
    """(32, n) int64 byte digits of scalars below 2^256, digit j = byte j
    little-endian (the JAX package's (s >> 8j) & 255)."""
    raw = b"".join(int(s).to_bytes(32, "little") for s in scalars)
    return np.frombuffer(raw, dtype=np.uint8).reshape(len(scalars), 32).T.astype(np.int64)


def _fixed_base_mul_dev(table: torch.Tensor, digits: torch.Tensor) -> E.JPoint:
    """table: (3, 8, 8192) on the device; digits: (32, n) -> sum over j of
    table[j*256 + digit_j], Jacobian, by complete adds."""

    def gather(j: int) -> E.JPoint:
        idx = digits[j] + 256 * j
        return E.JPoint(*(table[c][:, idx] for c in range(3)))

    acc = gather(0)
    for j in range(1, 32):
        acc = E.add(E.BN254_CURVE, acc, gather(j))
    return acc


def to_affine_batch(curve: E.CurveSpec, pts: E.JPoint) -> E.JPoint:
    """Batch Jacobian -> affine on the device: z becomes one (zero for the
    point at infinity, whose x and y become zero)."""
    f = curve.field
    zinv = M.batch_inverse(f, pts.z, axis=1)
    zi2 = M.montsquare(f, zinv)
    zi3 = M.montmul(f, zi2, zinv)
    x = M.montmul(f, pts.x, zi2)
    y = M.montmul(f, pts.y, zi3)
    inf = M.is_zero(f, pts.z)
    one = M.one_mont(f, x.device, x.ndim).expand(x.shape)
    z = torch.where(inf[None], torch.zeros_like(x), one)
    return E.JPoint(x, y, z)


@contextlib.contextmanager
def _span(seconds: dict, name: str, device):
    """Only under WH2_TRACE: the block fenced at both ends, its seconds
    added to seconds[name] and printed."""
    if not tracing():
        yield
        return
    fence(device)
    t0 = time.time()
    yield
    fence(device)
    dt = time.time() - t0
    seconds[name] = seconds.get(name, 0.0) + dt
    print(f"[span] {name}: {dt:.3f}s", file=sys.stderr, flush=True)


def fixed_base_msm_points(base: tuple[int, int], scalars: list[int],
                          chunk: int = CHUNK, device=None,
                          spans: dict | None = None) -> E.JPoint:
    """Host scalars -> device affine points [s_i * base], in chunks; the
    seconds of each step are added to `spans` under WH2_TRACE."""
    dev = resolve(device)
    spans = {} if spans is None else spans
    with _span(spans, "window table", dev):
        table = cached(("srs_window_table", base), lambda: _window_table(base), dev)
    outs = []
    for lo in range(0, len(scalars), chunk):
        with _span(spans, "fixed-base multiply", dev):
            digits = torch.as_tensor(scalar_digits(scalars[lo:lo + chunk])).to(dev)
            acc = _fixed_base_mul_dev(table, digits)
        with _span(spans, "to affine", dev):
            outs.append(to_affine_batch(E.BN254_CURVE, acc))
    return E.JPoint(*(torch.cat([o[c] for o in outs], dim=1) for c in range(3)))


def derive_tau(seed: bytes) -> int:
    h = hashlib.blake2b(b"webauthn-halo2-tpu/dev-srs/" + seed, digest_size=64)
    return int.from_bytes(h.digest(), "little") % BN254_FR


def srs_scalars(k: int, seed: bytes = b"dev") -> tuple[list[int], list[int]]:
    """The host scalars of the SRS: tau^i and L_i(tau), i < 2^k."""
    from ..ops.ntt import root_of_unity

    n = 1 << k
    r = BN254_FR
    tau = derive_tau(seed)
    powers = [1] * n
    for i in range(1, n):
        powers[i] = powers[i - 1] * tau % r
    # L_i(tau) = omega^i (tau^n - 1) / (n (tau - omega^i))  (barycentric)
    w = root_of_unity(k)
    wpow = [1] * n
    for i in range(1, n):
        wpow[i] = wpow[i - 1] * w % r
    zh = (pow(tau, n, r) - 1) % r
    if zh == 0:
        raise ValueError("tau landed in the domain; pick another seed")
    denoms = batch_inv([(tau - wi) % r for wi in wpow], r)
    ninv = pow(n, -1, r)
    lag = [wi * zh % r * d % r * ninv % r for wi, d in zip(wpow, denoms)]
    return powers, lag


def generate_srs(k: int, seed: bytes = b"dev", device=None) -> SRS:
    """The dev SRS of degree k on `device` (None: the card), equal to the
    JAX package's generate_srs point for point. Under WH2_TRACE its
    `spans` hold the seconds of its host scalars, window table, fixed-base
    multiplies and conversion to affine; untraced they stay empty."""
    dev = resolve(device)
    spans: dict[str, float] = {}
    with _span(spans, "host scalars", dev):
        powers, lag = srs_scalars(k, seed)
        s_g2 = g2_mul(derive_tau(seed), G2_GEN)
    g_mono = fixed_base_msm_points(BN254_G1, powers, device=dev, spans=spans)
    g_lag = fixed_base_msm_points(BN254_G1, lag, device=dev, spans=spans)
    fence(dev)  # the points are finished when it returns
    return SRS(k, seed, g_mono, g_lag, G2_GEN, s_g2, spans)


def _g2_bytes(pt) -> np.ndarray:
    return np.frombuffer(b"".join(int(c).to_bytes(32, "little") for xy in pt for c in xy),
                         np.uint8).reshape(2, 2, 32)


def _g2_of(raw: np.ndarray) -> tuple:
    return tuple(tuple(int.from_bytes(raw[i, j].tobytes(), "little") for j in range(2))
                 for i in range(2))


def save_port_srs(srs: SRS, path: str) -> None:
    """The port's SRS file: its (3, 8, n) words, k, seed, G2 points and a
    format tag; written to a temporary name, then moved into place."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    arrays = dict(
        format=np.frombuffer(FORMAT, np.uint8),
        k=np.int64(srs.k),
        seed=np.frombuffer(srs.tau_seed, np.uint8),
        g_mono=torch.stack(list(srs.g_mono)).cpu().numpy(),
        g_lag=torch.stack(list(srs.g_lag)).cpu().numpy(),
        g2=_g2_bytes(srs.g2),
        s_g2=_g2_bytes(srs.s_g2),
    )
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)


def load_port_srs(path: str, device=None) -> SRS:
    """An SRS file of the port's format onto `device`; raises ValueError for
    a file of another format."""
    dev = resolve(device)
    with np.load(path) as z:
        if "format" not in z.files or z["format"].tobytes() != FORMAT:
            raise ValueError(f"{path} is not an SRS file of this package's format")
        z = {name: z[name] for name in z.files}

    def point(name: str) -> E.JPoint:
        return E.JPoint(*torch.from_numpy(z[name]).to(dev).unbind(0))

    return SRS(int(z["k"]), z["seed"].tobytes(), point("g_mono"), point("g_lag"),
               _g2_of(z["g2"]), _g2_of(z["s_g2"]))


_SRS_MEM_CACHE: dict = {}
_SRS_LOCK = threading.Lock()


def srs_paths(k: int, seed: bytes = b"dev", cache_dir: str | None = None) -> tuple[str, str]:
    """(the JAX-format file, the port-format file) `get_srs` looks for: both
    in `cache_dir`; when it is None, both in $WH2_SRS_DIR (read at each
    call) if that is set, else the committed files' directory and
    build/srs/."""
    name = f"srs_bn254_k{k}_{seed.hex()}"
    cache_dir = cache_dir or os.environ.get("WH2_SRS_DIR")
    jax_dir = cache_dir or os.path.abspath(DEFAULT_CACHE_DIR)
    port_dir = cache_dir or os.path.abspath(DEFAULT_GEN_DIR)
    return (os.path.join(jax_dir, f"{name}.npz"),
            os.path.join(port_dir, f"{name}.torch.npz"))


def get_srs(k: int, seed: bytes = b"dev", cache_dir: str | None = None,
            device=None) -> SRS:
    """The SRS for degree k on `device`, kept in memory per device: the
    JAX-format file if there is one, else a file of the port's format, else
    generated on the device and saved in the port's format. Both files are
    looked for, and a generated SRS saved, where `srs_paths` says: in
    `cache_dir`, else in $WH2_SRS_DIR, else the committed files' directory
    for the JAX format and build/srs/ for the port's."""
    dev = resolve(device)
    key = (k, seed, str(dev))
    with _SRS_LOCK:
        if key not in _SRS_MEM_CACHE:
            jax_path, port_path = srs_paths(k, seed, cache_dir)
            if os.path.exists(jax_path):
                srs = load_srs(jax_path, dev)
            elif os.path.exists(port_path):
                srs = load_port_srs(port_path, dev)
            else:
                srs = generate_srs(k, seed, device=dev)
                save_port_srs(srs, port_path)
            _SRS_MEM_CACHE[key] = srs
        return _SRS_MEM_CACHE[key]
