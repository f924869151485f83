// Native hashing for the transcript hot path (SURVEY §2.3: "Transcript
// hashing ... host C++ — sequential, so keep off the critical path").
//
// Implements Keccak-256 (the EVM transcript hash — EvmTranscript parity,
// ecdsa_p256.rs:329-377) from the Keccak specification, plus a batched
// entry point so the prover can hash many absorb-squeeze steps per call.
//
// Built at first use by utils/host_build.py into build/host/ and loaded
// via ctypes (utils/keccak.py); the pure-Python keccak256_py there stays
// as the correctness oracle, never as a fallback.

#include <cstdint>
#include <cstring>

namespace {

constexpr int ROUNDS = 24;

constexpr uint64_t RC[ROUNDS] = {
    0x0000000000000001ULL, 0x0000000000008082ULL, 0x800000000000808aULL,
    0x8000000080008000ULL, 0x000000000000808bULL, 0x0000000080000001ULL,
    0x8000000080008081ULL, 0x8000000000008009ULL, 0x000000000000008aULL,
    0x0000000000000088ULL, 0x0000000080008009ULL, 0x000000008000000aULL,
    0x000000008000808bULL, 0x800000000000008bULL, 0x8000000000008089ULL,
    0x8000000000008003ULL, 0x8000000000008002ULL, 0x8000000000000080ULL,
    0x000000000000800aULL, 0x800000008000000aULL, 0x8000000080008081ULL,
    0x8000000000008080ULL, 0x0000000080000001ULL, 0x8000000080008008ULL,
};

constexpr int ROT[24] = {1,  3,  6,  10, 15, 21, 28, 36, 45, 55, 2,  14,
                         27, 41, 56, 8,  25, 43, 62, 18, 39, 61, 20, 44};
constexpr int PI[24] = {10, 7,  11, 17, 18, 3, 5,  16, 8,  21, 24, 4,
                        15, 23, 19, 13, 12, 2, 20, 14, 22, 9,  6,  1};

inline uint64_t rotl(uint64_t x, int n) {
  return (x << n) | (x >> (64 - n));
}

void keccak_f1600(uint64_t st[25]) {
  for (int round = 0; round < ROUNDS; ++round) {
    // theta
    uint64_t bc[5];
    for (int i = 0; i < 5; ++i)
      bc[i] = st[i] ^ st[i + 5] ^ st[i + 10] ^ st[i + 15] ^ st[i + 20];
    for (int i = 0; i < 5; ++i) {
      uint64_t t = bc[(i + 4) % 5] ^ rotl(bc[(i + 1) % 5], 1);
      for (int j = 0; j < 25; j += 5) st[j + i] ^= t;
    }
    // rho + pi
    uint64_t t = st[1];
    for (int i = 0; i < 24; ++i) {
      uint64_t tmp = st[PI[i]];
      st[PI[i]] = rotl(t, ROT[i]);
      t = tmp;
    }
    // chi
    for (int j = 0; j < 25; j += 5) {
      uint64_t row[5];
      for (int i = 0; i < 5; ++i) row[i] = st[j + i];
      for (int i = 0; i < 5; ++i)
        st[j + i] = row[i] ^ ((~row[(i + 1) % 5]) & row[(i + 2) % 5]);
    }
    // iota
    st[0] ^= RC[round];
  }
}

}  // namespace

extern "C" {

// Keccak-256 (original padding 0x01, as used by Ethereum).
void wh2_keccak256(const uint8_t* data, uint64_t len, uint8_t out[32]) {
  uint64_t st[25];
  std::memset(st, 0, sizeof(st));
  const uint64_t rate = 136;  // 1088-bit rate
  uint64_t off = 0;
  while (len - off >= rate) {
    for (uint64_t i = 0; i < rate / 8; ++i) {
      uint64_t w;
      std::memcpy(&w, data + off + 8 * i, 8);
      st[i] ^= w;
    }
    keccak_f1600(st);
    off += rate;
  }
  uint8_t block[136];
  std::memset(block, 0, sizeof(block));
  std::memcpy(block, data + off, len - off);
  block[len - off] = 0x01;
  block[rate - 1] |= 0x80;
  for (uint64_t i = 0; i < rate / 8; ++i) {
    uint64_t w;
    std::memcpy(&w, block + 8 * i, 8);
    st[i] ^= w;
  }
  keccak_f1600(st);
  std::memcpy(out, st, 32);
}

// Batched: n messages of fixed stride; out = n x 32 bytes.
void wh2_keccak256_batch(const uint8_t* data, uint64_t stride, uint64_t len,
                         uint64_t n, uint8_t* out) {
  for (uint64_t i = 0; i < n; ++i)
    wh2_keccak256(data + i * stride, len, out + 32 * i);
}
}
