"""Curve and field constants for bn254 (alt_bn128) and secp256r1 (NIST P-256).

These mirror the parameter sets consumed by the reference stack
(`halo2curves` bn256 + secp256r1; see SURVEY §L0,
halo2-circuits/src/ecc/ecdsa_p256.rs:27-28) but are defined from the public
curve standards, not copied code.
"""

# ---------------------------------------------------------------------------
# bn254 / alt_bn128 (the proof system curve: KZG commitments, pairings)
# ---------------------------------------------------------------------------

# Base field modulus q (coordinates of G1/G2)
BN254_FQ = 21888242871839275222246405745257275088696311157297823662689037894645226208583
# Scalar field modulus r (the PLONKish witness field, "Fr")
BN254_FR = 21888242871839275222246405745257275088548364400416034343698204186575808495617

# G1: y^2 = x^3 + 3 over Fq
BN254_B = 3
BN254_G1 = (1, 2)

# G2: y^2 = x^3 + 3/(9+u) over Fq2 = Fq[u]/(u^2+1)
BN254_G2_X = (
    10857046999023057135944570762232829481370756359578518086990519993285655852781,
    11559732032986387107991004021392285783925812861821192530917403151452391805634,
)
BN254_G2_Y = (
    8495653923123431417604973247489272438418190587263600148770280649306958101930,
    4082367875863433681332203403145435568316851327593401208105741076214120093531,
)

# Fr multiplicative generator and 2-adicity (for NTT roots of unity).
# r - 1 = 2^28 * t with t odd.
BN254_FR_GENERATOR = 7
BN254_FR_S = 28
BN254_FR_T = (BN254_FR - 1) >> BN254_FR_S
# Primitive 2^28-th root of unity: g^t
BN254_FR_ROOT_OF_UNITY = pow(BN254_FR_GENERATOR, BN254_FR_T, BN254_FR)
# DELTA = g^(2^S): generates the "extra" cosets used by the permutation argument
BN254_FR_DELTA = pow(BN254_FR_GENERATOR, 1 << BN254_FR_S, BN254_FR)

# bn curve parameter x ("t" in the literature): q, r are polynomials in x.
BN254_X = 4965661367192848881

# ---------------------------------------------------------------------------
# secp256r1 / NIST P-256 (the WebAuthn ES256 signature curve)
# ---------------------------------------------------------------------------

# Base field p (coordinates)
P256_P = 0xFFFFFFFF00000001000000000000000000000000FFFFFFFFFFFFFFFFFFFFFFFF
# Group order n (scalars; r, s, msghash live here)
P256_N = 0xFFFFFFFF00000000FFFFFFFFFFFFFFFFBCE6FAADA7179E84F3B9CAC2FC632551
P256_A = P256_P - 3
P256_B = 0x5AC635D8AA3A93E7B3EBBD55769886BC651D06B0CC53B0F63BCE3C3E27D2604B
P256_GX = 0x6B17D1F2E12C4247F8BCE6E563A440F277037D812DEB33A0F4A13945D898C296
P256_GY = 0x4FE342E2FE1A7F9B8EE7EB4A7C0F9E162BCE33576B315ECECBB6406837BF51F5
P256_G = (P256_GX, P256_GY)
