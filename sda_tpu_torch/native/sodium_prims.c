/* The symmetric primitives of a libsodium sealed box and of the ChaCha20
 * mask expansion, in plain C with no library behind them.
 *
 * sda_tpu_torch binds no system library: the card's machine has no
 * libsodium. This file carries what _sdanative.c would otherwise call there
 * (crypto_core_hsalsa20, crypto_generichash, crypto_box_easy_afternm,
 * crypto_box_open_easy_afternm, crypto_stream_chacha20_xor_ic,
 * sodium_memzero), byte for byte as libsodium computes them:
 *
 *   - HSalsa20 and the Salsa20 block (20 rounds, 64-bit block counter);
 *   - XSalsa20 in the secretbox layout: the first 32 stream bytes key
 *     Poly1305, the message is XORed with the stream from byte 32 on;
 *   - Poly1305 (44/44/42-bit limbs) and a constant-time tag compare;
 *   - unkeyed BLAKE2b, any digest size up to 64 bytes (the sealed box's
 *     nonce is its 24-byte digest of epk || pk);
 *   - the djb ChaCha20 block: 64-bit counter in words 12-13, 8-byte nonce
 *     in words 14-15 (zero for the masks), as crypto_stream_chacha20 and
 *     csrc/chacha20.cu lay it out;
 *   - sda_wipe, a memset the compiler may not drop.
 *
 * No branch and no memory index depends on a secret. The plain versions are
 * crypto/sodium.py (sealed boxes) and ops/chacha.py (the keystream);
 * tests/test_torch_native.py holds this file against them and against
 * libsodium itself.
 */

#include <stddef.h>
#include <stdint.h>
#include <string.h>

static uint32_t ld32(const unsigned char *p) {
    return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
           ((uint32_t)p[3] << 24);
}

static void st32(unsigned char *p, uint32_t v) {
    p[0] = (unsigned char)v; p[1] = (unsigned char)(v >> 8);
    p[2] = (unsigned char)(v >> 16); p[3] = (unsigned char)(v >> 24);
}

static uint64_t ld64(const unsigned char *p) {
    return (uint64_t)ld32(p) | ((uint64_t)ld32(p + 4) << 32);
}

static void st64(unsigned char *p, uint64_t v) {
    st32(p, (uint32_t)v);
    st32(p + 4, (uint32_t)(v >> 32));
}

/* zero n bytes at p; the barrier keeps the stores from being elided */
static void sda_wipe(void *p, size_t n) {
    volatile unsigned char *v = (volatile unsigned char *)p;
    while (n--) *v++ = 0;
    __asm__ __volatile__("" : : "r"(p) : "memory");
}

/* ---------------- Salsa20 / HSalsa20 / XSalsa20 ---------------- */

#define ROTL32(v, c) (((v) << (c)) | ((v) >> (32 - (c))))

static const unsigned char SIGMA[16] = "expand 32-byte k";

static void salsa20_rounds(uint32_t x[16]) {
    int i;
    for (i = 0; i < 10; i++) {
        x[4] ^= ROTL32(x[0] + x[12], 7);   x[8] ^= ROTL32(x[4] + x[0], 9);
        x[12] ^= ROTL32(x[8] + x[4], 13);  x[0] ^= ROTL32(x[12] + x[8], 18);
        x[9] ^= ROTL32(x[5] + x[1], 7);    x[13] ^= ROTL32(x[9] + x[5], 9);
        x[1] ^= ROTL32(x[13] + x[9], 13);  x[5] ^= ROTL32(x[1] + x[13], 18);
        x[14] ^= ROTL32(x[10] + x[6], 7);  x[2] ^= ROTL32(x[14] + x[10], 9);
        x[6] ^= ROTL32(x[2] + x[14], 13);  x[10] ^= ROTL32(x[6] + x[2], 18);
        x[3] ^= ROTL32(x[15] + x[11], 7);  x[7] ^= ROTL32(x[3] + x[15], 9);
        x[11] ^= ROTL32(x[7] + x[3], 13);  x[15] ^= ROTL32(x[11] + x[7], 18);
        x[1] ^= ROTL32(x[0] + x[3], 7);    x[2] ^= ROTL32(x[1] + x[0], 9);
        x[3] ^= ROTL32(x[2] + x[1], 13);   x[0] ^= ROTL32(x[3] + x[2], 18);
        x[6] ^= ROTL32(x[5] + x[4], 7);    x[7] ^= ROTL32(x[6] + x[5], 9);
        x[4] ^= ROTL32(x[7] + x[6], 13);   x[5] ^= ROTL32(x[4] + x[7], 18);
        x[11] ^= ROTL32(x[10] + x[9], 7);  x[8] ^= ROTL32(x[11] + x[10], 9);
        x[9] ^= ROTL32(x[8] + x[11], 13);  x[10] ^= ROTL32(x[9] + x[8], 18);
        x[12] ^= ROTL32(x[15] + x[14], 7); x[13] ^= ROTL32(x[12] + x[15], 9);
        x[14] ^= ROTL32(x[13] + x[12], 13); x[15] ^= ROTL32(x[14] + x[13], 18);
    }
}

/* the Salsa20 input: constants on the diagonal, key in words 1-4 and
 * 11-14, the 16-byte input (nonce || counter) in words 6-9 */
static void salsa20_state(uint32_t x[16], const unsigned char key[32],
                          const unsigned char in[16]) {
    int i;
    x[0] = ld32(SIGMA); x[5] = ld32(SIGMA + 4);
    x[10] = ld32(SIGMA + 8); x[15] = ld32(SIGMA + 12);
    for (i = 0; i < 4; i++) {
        x[1 + i] = ld32(key + 4 * i);
        x[11 + i] = ld32(key + 16 + 4 * i);
        x[6 + i] = ld32(in + 4 * i);
    }
}

/* HSalsa20(key, 16-byte input) -> 32-byte subkey: the rounds without the
 * feed-forward, words 0, 5, 10, 15, 6, 7, 8, 9 */
static void sda_hsalsa20(unsigned char out[32], const unsigned char in[16],
                         const unsigned char key[32]) {
    uint32_t x[16];
    salsa20_state(x, key, in);
    salsa20_rounds(x);
    st32(out, x[0]); st32(out + 4, x[5]); st32(out + 8, x[10]); st32(out + 12, x[15]);
    st32(out + 16, x[6]); st32(out + 20, x[7]); st32(out + 24, x[8]); st32(out + 28, x[9]);
    sda_wipe(x, sizeof x);
}

/* one 64-byte Salsa20 block at a 64-bit block counter */
static void salsa20_block(unsigned char out[64], const unsigned char key[32],
                          const unsigned char nonce8[8], uint64_t counter) {
    uint32_t x[16], s[16];
    unsigned char in[16];
    int i;
    memcpy(in, nonce8, 8);
    st64(in + 8, counter);
    salsa20_state(s, key, in);
    memcpy(x, s, sizeof x);
    salsa20_rounds(x);
    for (i = 0; i < 16; i++) st32(out + 4 * i, x[i] + s[i]);
    sda_wipe(x, sizeof x);
    sda_wipe(s, sizeof s);
}

/* out = in XOR the Salsa20 stream of (key, nonce8) from block `counter`
 * on; the state is set up once and the scratch wiped once */
static void salsa20_xor(unsigned char *out, const unsigned char *in, size_t len,
                        const unsigned char key[32], const unsigned char nonce8[8],
                        uint64_t counter) {
    uint32_t s[16], x[16];
    unsigned char in16[16], block[64];
    size_t i;
    memcpy(in16, nonce8, 8);
    st64(in16 + 8, counter);
    salsa20_state(s, key, in16);
    while (len > 0) {
        size_t take = len < 64 ? len : 64;
        memcpy(x, s, sizeof x);
        salsa20_rounds(x);
        if (take == 64) {
            for (i = 0; i < 16; i++) st32(out + 4 * i, ld32(in + 4 * i) ^ (x[i] + s[i]));
        } else {
            for (i = 0; i < 16; i++) st32(block + 4 * i, x[i] + s[i]);
            for (i = 0; i < take; i++) out[i] = in[i] ^ block[i];
        }
        out += take; in += take; len -= take;
        if (++s[8] == 0) ++s[9]; /* the 64-bit block counter, words 8-9 */
    }
    sda_wipe(x, sizeof x);
    sda_wipe(s, sizeof s);
    sda_wipe(block, sizeof block);
}

/* XSalsa20 under (key, 24-byte nonce) in the secretbox layout: block 0's
 * first 32 bytes go to polykey, and out = in XOR stream[32 : 32 + len] */
static void xsalsa20_secretbox_xor(unsigned char *out, const unsigned char *in,
                                   size_t len, unsigned char polykey[32],
                                   const unsigned char nonce[24],
                                   const unsigned char key[32]) {
    unsigned char subkey[32], block[64];
    size_t i, take;
    sda_hsalsa20(subkey, nonce, key);
    salsa20_block(block, subkey, nonce + 16, 0);
    memcpy(polykey, block, 32);
    take = len < 32 ? len : 32;
    for (i = 0; i < take; i++) out[i] = in[i] ^ block[32 + i];
    salsa20_xor(out + take, in + take, len - take, subkey, nonce + 16, 1);
    sda_wipe(subkey, sizeof subkey);
    sda_wipe(block, sizeof block);
}

/* ---------------- Poly1305 ---------------- */

static void sda_poly1305(unsigned char tag[16], const unsigned char *m, size_t mlen,
                         const unsigned char key[32]) {
    const uint64_t M44 = 0xfffffffffffULL, M42 = 0x3ffffffffffULL;
    uint64_t r0, r1, r2, s1, s2, h0 = 0, h1 = 0, h2 = 0, t0, t1, c, g0, g1, g2;
    __uint128_t d0, d1, d2;
    t0 = ld64(key);
    t1 = ld64(key + 8);
    r0 = t0 & 0xffc0fffffffULL;
    r1 = ((t0 >> 44) | (t1 << 20)) & 0xfffffc0ffffULL;
    r2 = (t1 >> 24) & 0x00ffffffc0fULL;
    s1 = r1 * (5 << 2);
    s2 = r2 * (5 << 2);
    while (mlen > 0) {
        unsigned char block[16];
        uint64_t hibit;
        size_t n;
        if (mlen >= 16) {
            memcpy(block, m, 16);
            hibit = 1ULL << 40;
            n = 16;
        } else {
            memset(block, 0, 16);
            memcpy(block, m, mlen);
            block[mlen] = 1;
            hibit = 0;
            n = mlen;
        }
        t0 = ld64(block);
        t1 = ld64(block + 8);
        h0 += t0 & M44;
        h1 += ((t0 >> 44) | (t1 << 20)) & M44;
        h2 += ((t1 >> 24) & M42) | hibit;
        d0 = (__uint128_t)h0 * r0 + (__uint128_t)h1 * s2 + (__uint128_t)h2 * s1;
        d1 = (__uint128_t)h0 * r1 + (__uint128_t)h1 * r0 + (__uint128_t)h2 * s2;
        d2 = (__uint128_t)h0 * r2 + (__uint128_t)h1 * r1 + (__uint128_t)h2 * r0;
        c = (uint64_t)(d0 >> 44); h0 = (uint64_t)d0 & M44;
        d1 += c; c = (uint64_t)(d1 >> 44); h1 = (uint64_t)d1 & M44;
        d2 += c; c = (uint64_t)(d2 >> 42); h2 = (uint64_t)d2 & M42;
        h0 += c * 5; c = h0 >> 44; h0 &= M44;
        h1 += c;
        m += n;
        mlen -= n;
    }
    /* full carry */
    c = h1 >> 44; h1 &= M44;
    h2 += c; c = h2 >> 42; h2 &= M42;
    h0 += c * 5; c = h0 >> 44; h0 &= M44;
    h1 += c; c = h1 >> 44; h1 &= M44;
    h2 += c; c = h2 >> 42; h2 &= M42;
    h0 += c * 5; c = h0 >> 44; h0 &= M44;
    h1 += c;
    /* g = h - p = h + 5 - 2^130; keep g when it did not borrow */
    g0 = h0 + 5; c = g0 >> 44; g0 &= M44;
    g1 = h1 + c; c = g1 >> 44; g1 &= M44;
    g2 = h2 + c - (1ULL << 42);
    c = (g2 >> 63) - 1; /* all ones when h >= p */
    g0 &= c; g1 &= c; g2 &= c;
    c = ~c;
    h0 = (h0 & c) | g0;
    h1 = (h1 & c) | g1;
    h2 = (h2 & c) | g2;
    /* h + s mod 2^128 */
    t0 = ld64(key + 16);
    t1 = ld64(key + 24);
    h0 += t0 & M44; c = h0 >> 44; h0 &= M44;
    h1 += (((t0 >> 44) | (t1 << 20)) & M44) + c; c = h1 >> 44; h1 &= M44;
    h2 += ((t1 >> 24) & M42) + c; h2 &= M42;
    st64(tag, h0 | (h1 << 44));
    st64(tag + 8, (h1 >> 20) | (h2 << 24));
}

/* 0 when the 16-byte tags are equal; no early exit */
static int tag_differs(const unsigned char a[16], const unsigned char b[16]) {
    unsigned int d = 0;
    int i;
    for (i = 0; i < 16; i++) d |= (unsigned int)(a[i] ^ b[i]);
    return (int)((d + 0xffU) >> 8) & 1;
}

/* crypto_secretbox_easy: out = tag (16) || ciphertext (len) */
static void sda_secretbox(unsigned char *out, const unsigned char *m, size_t len,
                          const unsigned char nonce[24], const unsigned char key[32]) {
    unsigned char polykey[32];
    xsalsa20_secretbox_xor(out + 16, m, len, polykey, nonce, key);
    sda_poly1305(out, out + 16, len, polykey);
    sda_wipe(polykey, sizeof polykey);
}

/* crypto_secretbox_open_easy: box = tag (16) || ciphertext (len); writes the
 * plaintext only after the tag verified. Returns 0, or -1 on a bad tag. */
static int sda_secretbox_open(unsigned char *out, const unsigned char *box, size_t len,
                              const unsigned char nonce[24], const unsigned char key[32]) {
    unsigned char subkey[32], block[64], tag[16];
    int bad;
    sda_hsalsa20(subkey, nonce, key);
    salsa20_block(block, subkey, nonce + 16, 0);
    sda_poly1305(tag, box + 16, len, block);
    bad = tag_differs(tag, box);
    sda_wipe(subkey, sizeof subkey);
    sda_wipe(block, sizeof block);
    if (bad) return -1;
    {
        unsigned char polykey[32];
        xsalsa20_secretbox_xor(out, box + 16, len, polykey, nonce, key);
        sda_wipe(polykey, sizeof polykey);
    }
    return 0;
}

/* ---------------- BLAKE2b (unkeyed) ---------------- */

static const uint64_t BLAKE2B_IV[8] = {
    0x6a09e667f3bcc908ULL, 0xbb67ae8584caa73bULL, 0x3c6ef372fe94f82bULL,
    0xa54ff53a5f1d36f1ULL, 0x510e527fade682d1ULL, 0x9b05688c2b3e6c1fULL,
    0x1f83d9abfb41bd6bULL, 0x5be0cd19137e2179ULL,
};

static const unsigned char BLAKE2B_SIGMA[12][16] = {
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15},
    {14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3},
    {11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4},
    {7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8},
    {9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13},
    {2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9},
    {12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11},
    {13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10},
    {6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5},
    {10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0},
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15},
    {14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3},
};

#define ROTR64(v, c) (((v) >> (c)) | ((v) << (64 - (c))))
#define B2B_G(a, b, c, d, x, y)         \
    do {                                \
        v[a] = v[a] + v[b] + (x);       \
        v[d] = ROTR64(v[d] ^ v[a], 32); \
        v[c] = v[c] + v[d];             \
        v[b] = ROTR64(v[b] ^ v[c], 24); \
        v[a] = v[a] + v[b] + (y);       \
        v[d] = ROTR64(v[d] ^ v[a], 16); \
        v[c] = v[c] + v[d];             \
        v[b] = ROTR64(v[b] ^ v[c], 63); \
    } while (0)

static void blake2b_compress(uint64_t h[8], const unsigned char block[128],
                             uint64_t t, int last) {
    uint64_t v[16], m[16];
    int i;
    for (i = 0; i < 16; i++) m[i] = ld64(block + 8 * i);
    for (i = 0; i < 8; i++) {
        v[i] = h[i];
        v[8 + i] = BLAKE2B_IV[i];
    }
    v[12] ^= t; /* byte counts stay below 2^64: the high word is 0 */
    if (last) v[14] = ~v[14];
    for (i = 0; i < 12; i++) {
        const unsigned char *s = BLAKE2B_SIGMA[i];
        B2B_G(0, 4, 8, 12, m[s[0]], m[s[1]]);
        B2B_G(1, 5, 9, 13, m[s[2]], m[s[3]]);
        B2B_G(2, 6, 10, 14, m[s[4]], m[s[5]]);
        B2B_G(3, 7, 11, 15, m[s[6]], m[s[7]]);
        B2B_G(0, 5, 10, 15, m[s[8]], m[s[9]]);
        B2B_G(1, 6, 11, 12, m[s[10]], m[s[11]]);
        B2B_G(2, 7, 8, 13, m[s[12]], m[s[13]]);
        B2B_G(3, 4, 9, 14, m[s[14]], m[s[15]]);
    }
    for (i = 0; i < 8; i++) h[i] ^= v[i] ^ v[8 + i];
}

/* crypto_generichash with no key: outlen in 1..64 */
static void sda_blake2b(unsigned char *out, size_t outlen, const unsigned char *in,
                        size_t inlen) {
    uint64_t h[8];
    unsigned char block[128], full[64];
    uint64_t t = 0;
    int i;
    for (i = 0; i < 8; i++) h[i] = BLAKE2B_IV[i];
    h[0] ^= 0x01010000ULL ^ (uint64_t)outlen;
    while (inlen > 128) {
        t += 128;
        blake2b_compress(h, in, t, 0);
        in += 128;
        inlen -= 128;
    }
    memset(block, 0, sizeof block);
    memcpy(block, in, inlen);
    t += inlen;
    blake2b_compress(h, block, t, 1);
    for (i = 0; i < 8; i++) st64(full + 8 * i, h[i]);
    memcpy(out, full, outlen);
}

/* ---------------- ChaCha20 (djb layout) ---------------- */

#define CHACHA_QR(a, b, c, d)            \
    do {                                 \
        x[a] += x[b]; x[d] ^= x[a]; x[d] = ROTL32(x[d], 16); \
        x[c] += x[d]; x[b] ^= x[c]; x[b] = ROTL32(x[b], 12); \
        x[a] += x[b]; x[d] ^= x[a]; x[d] = ROTL32(x[d], 8);  \
        x[c] += x[d]; x[b] ^= x[c]; x[b] = ROTL32(x[b], 7);  \
    } while (0)

/* the 16 keystream words of block `counter` under a 32-byte key and an
 * all-zero 8-byte nonce, in keystream (little-endian word) order */
static void sda_chacha20_block(uint32_t out[16], const uint32_t key[8], uint64_t counter) {
    uint32_t x[16], s[16];
    int i;
    s[0] = ld32(SIGMA); s[1] = ld32(SIGMA + 4); s[2] = ld32(SIGMA + 8); s[3] = ld32(SIGMA + 12);
    for (i = 0; i < 8; i++) s[4 + i] = key[i];
    s[12] = (uint32_t)counter;
    s[13] = (uint32_t)(counter >> 32);
    s[14] = 0;
    s[15] = 0;
    memcpy(x, s, sizeof x);
    for (i = 0; i < 10; i++) {
        CHACHA_QR(0, 4, 8, 12); CHACHA_QR(1, 5, 9, 13);
        CHACHA_QR(2, 6, 10, 14); CHACHA_QR(3, 7, 11, 15);
        CHACHA_QR(0, 5, 10, 15); CHACHA_QR(1, 6, 11, 12);
        CHACHA_QR(2, 7, 8, 13); CHACHA_QR(3, 4, 9, 14);
    }
    for (i = 0; i < 16; i++) out[i] = x[i] + s[i];
}
