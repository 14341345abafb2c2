// csgn_host — native host-side library for the csgn_tpu framework.
//
// Written from scratch against the scheme spec (SURVEY.md §2a); no code is
// taken from the reference implementation.  Exposed via ctypes
// (csgn_tpu/native/binding.py).  Roles:
//
//   1. glibc-rand-compatible codec: bit-exact reproduction of the reference
//      library's randomized operations (encrypt, permutation generation) for
//      a pinned srand seed — the fast C twin of csgn_tpu.rng.GlibcRand +
//      csgn_tpu.refcompat (the pure-Python replay is O(n) interpreter
//      dispatches per bit; this runs the same sequence at native speed for
//      large golden sweeps).
//
//   2. Reference-semantics CPU oracle: packed-word add / multiply / decrypt /
//      permute on uint32 word-major buffers, used by differential tests to
//      cross-check the JAX pipeline from an independent implementation.
//
// Layout contract: packed uint32 words, MSB-first within the word; bit j of a
// chunk lives in word j/32 at shift 31-(j%32); W32 = 2*ceil(n/64) words per
// chunk (tail word zero when n%64 <= 32).  Buffers here are CHUNK-MAJOR
// (chunk index slowest) — the serialization layout; the JAX side transposes
// at the boundary.

#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// glibc rand() emulation (TYPE_3 additive-feedback generator, degree 31)
// ---------------------------------------------------------------------------

struct CsgnRand {
  uint32_t ring[31];
  int head;  // index of r[i-31]
};

static_assert(sizeof(CsgnRand) == 128, "keep POD layout stable for ctypes");

void csgn_srand(CsgnRand* st, uint32_t seed) {
  int32_t r[344];
  r[0] = (int32_t)(seed ? seed : 1);
  for (int i = 1; i < 31; i++) {
    // Schrage: 16807 * r[i-1] mod (2^31 - 1) without 64-bit overflow.
    int32_t hi = r[i - 1] / 127773;
    int32_t lo = r[i - 1] % 127773;
    int32_t word = 16807 * lo - 2836 * hi;
    if (word < 0) word += 2147483647;
    r[i] = word;
  }
  for (int i = 31; i < 34; i++) r[i] = r[i - 31];
  uint32_t u[344];
  for (int i = 0; i < 34; i++) u[i] = (uint32_t)r[i];
  for (int i = 34; i < 344; i++) u[i] = u[i - 31] + u[i - 3];
  for (int i = 0; i < 31; i++) st->ring[i] = u[313 + i];
  st->head = 0;
}

uint32_t csgn_rand(CsgnRand* st) {
  // next = r[i-31] + r[i-3]; ring holds the last 31 values.
  uint32_t v = st->ring[st->head] + st->ring[(st->head + 28) % 31];
  st->ring[st->head] = v;
  st->head = (st->head + 1) % 31;
  return v >> 1;
}

// ---------------------------------------------------------------------------
// Layout helpers
// ---------------------------------------------------------------------------

static inline uint64_t words32_for(uint64_t n) {
  return 2 * ((n + 63) / 64);
}

static inline void set_bit(uint32_t* chunk, uint64_t j, uint32_t bit) {
  uint32_t m = (uint32_t)1 << (31 - (j % 32));
  if (bit)
    chunk[j / 32] |= m;
  else
    chunk[j / 32] &= ~m;
}

static inline uint32_t get_bit(const uint32_t* chunk, uint64_t j) {
  return (chunk[j / 32] >> (31 - (j % 32))) & 1u;
}

// ---------------------------------------------------------------------------
// Reference-exact randomized operations
// ---------------------------------------------------------------------------

// Encrypt one bit into a packed chunk (out: uint32[words32_for(n)]), replaying
// the reference's exact rand() call sequence (SURVEY.md §2a encrypt
// invariant; call order per reference src/SecretKey.cpp:35-80).
void csgn_ref_encrypt(CsgnRand* st, uint32_t bit, const int32_t* s, uint64_t d,
                      uint64_t n, uint32_t* out) {
  uint64_t w32 = words32_for(n);
  std::memset(out, 0, w32 * sizeof(uint32_t));
  std::vector<uint8_t> is_secret(n, 0);
  for (uint64_t i = 0; i < d; i++) is_secret[(uint64_t)s[i]] = 1;

  if (bit & 1) {
    for (uint64_t i = 0; i < n; i++) {
      uint32_t b = is_secret[i] ? 1u : (csgn_rand(st) % 2);
      if (b) set_bit(out, i, 1);
    }
  } else {
    uint64_t forced = (uint64_t)s[csgn_rand(st) % d];
    uint32_t v = 0;
    bool v_unset = true;
    for (uint64_t i = 0; i < n; i++) {
      if (i == forced) continue;
      uint32_t b = csgn_rand(st) % 2;
      if (b) set_bit(out, i, 1);
      if (is_secret[i]) {
        if (v_unset) {
          v = b;
          v_unset = false;
        }
        v &= b;
      }
    }
    uint32_t fb = (v == 1) ? 0u : (csgn_rand(st) % 2);
    if (fb) set_bit(out, forced, 1);
  }
}

// Random permutation of [0, n) with the reference's rand() consumption
// (draw rand()%n until unused, per slot).  out: int32[n].
void csgn_ref_permutation(CsgnRand* st, uint64_t n, int32_t* out) {
  std::vector<uint8_t> used(n, 0);
  for (uint64_t i = 0; i < n; i++) {
    uint32_t r = csgn_rand(st) % (uint32_t)n;
    while (used[r]) r = csgn_rand(st) % (uint32_t)n;
    out[i] = (int32_t)r;
    used[r] = 1;
  }
}

// ---------------------------------------------------------------------------
// Packed-word homomorphic ops (chunk-major oracle)
// ---------------------------------------------------------------------------

// add: pure concatenation — caller concatenates buffers; nothing needed here.

// multiply: cross-product AND.  a: [t1, w32], b: [t2, w32],
// out: [t1*t2, w32] with out chunk i*t2 + j = a_i & b_j.
void csgn_mul(const uint32_t* a, uint64_t t1, const uint32_t* b, uint64_t t2,
              uint64_t w32, uint32_t* out) {
  for (uint64_t i = 0; i < t1; i++) {
    const uint32_t* ai = a + i * w32;
    for (uint64_t j = 0; j < t2; j++) {
      const uint32_t* bj = b + j * w32;
      uint32_t* o = out + (i * t2 + j) * w32;
      for (uint64_t k = 0; k < w32; k++) o[k] = ai[k] & bj[k];
    }
  }
}

// decrypt: parity over chunks of (chunk & mask) == mask.
uint32_t csgn_decrypt(const uint32_t* words, uint64_t chunks, uint64_t w32,
                      const uint32_t* mask) {
  uint32_t parity = 0;
  for (uint64_t c = 0; c < chunks; c++) {
    const uint32_t* ch = words + c * w32;
    uint32_t ok = 1;
    for (uint64_t k = 0; k < w32; k++) ok &= ((ch[k] & mask[k]) == mask[k]);
    parity ^= ok;
  }
  return parity;
}

// permute: out bit i = in bit perm[i], applied per chunk.
void csgn_permute(const uint32_t* words, uint64_t chunks, uint64_t n,
                  const int32_t* perm, uint32_t* out) {
  uint64_t w32 = words32_for(n);
  std::memset(out, 0, chunks * w32 * sizeof(uint32_t));
  for (uint64_t c = 0; c < chunks; c++) {
    const uint32_t* in = words + c * w32;
    uint32_t* o = out + c * w32;
    for (uint64_t i = 0; i < n; i++)
      if (get_bit(in, (uint64_t)perm[i])) set_bit(o, i, 1);
  }
}

}  // extern "C"
