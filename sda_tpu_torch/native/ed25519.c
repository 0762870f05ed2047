/* Constant-time key generation and Ed25519 signing: the X25519 public key
 * of a box secret key, and Ed25519 seed keypairs and detached signatures,
 * byte-equal to libsodium's crypto_box_keypair, crypto_sign_seed_keypair
 * and crypto_sign_detached (which the reference binds) and to the plain
 * Python of crypto/sodium.py.
 *
 * Every scalar multiplication here is by the fixed base point, so it runs
 * on the comb table that the seals' ephemeral keys use (curve25519_comb.c,
 * built once under pthread_once in _sdanative.c): 64 mixed additions whose
 * table rows are scanned in full with arithmetic masks. Ed25519 needs the
 * Edwards encoding of the result (y, with the sign of x in bit 255), taken
 * from the ge_p3 before any Montgomery u conversion; X25519 needs u, which
 * sda_comb_scalarmult_u returns.
 *
 * Scalars: X25519 and Ed25519 clamp their secret scalars alike (clear the
 * low 3 bits and bit 255, set bit 254). The signing nonce r and the
 * challenge k are 512-bit hashes reduced mod L, and S = r + k a mod L; the
 * reduction works on 64 signed byte-weight limbs with a fixed schedule
 * (the shape of TweetNaCl's modL), with no branch or load on a secret.
 *
 * SHA-512 (FIPS 180-4) is written here in plain C. Verification is public
 * and stays in Python.
 */

#include <pthread.h>
#include <stdint.h>
#include <string.h>

/* ---- SHA-512 ---- */

static const uint64_t SHA512_K[80] = {
    0x428a2f98d728ae22ULL, 0x7137449123ef65cdULL, 0xb5c0fbcfec4d3b2fULL,
    0xe9b5dba58189dbbcULL, 0x3956c25bf348b538ULL, 0x59f111f1b605d019ULL,
    0x923f82a4af194f9bULL, 0xab1c5ed5da6d8118ULL, 0xd807aa98a3030242ULL,
    0x12835b0145706fbeULL, 0x243185be4ee4b28cULL, 0x550c7dc3d5ffb4e2ULL,
    0x72be5d74f27b896fULL, 0x80deb1fe3b1696b1ULL, 0x9bdc06a725c71235ULL,
    0xc19bf174cf692694ULL, 0xe49b69c19ef14ad2ULL, 0xefbe4786384f25e3ULL,
    0x0fc19dc68b8cd5b5ULL, 0x240ca1cc77ac9c65ULL, 0x2de92c6f592b0275ULL,
    0x4a7484aa6ea6e483ULL, 0x5cb0a9dcbd41fbd4ULL, 0x76f988da831153b5ULL,
    0x983e5152ee66dfabULL, 0xa831c66d2db43210ULL, 0xb00327c898fb213fULL,
    0xbf597fc7beef0ee4ULL, 0xc6e00bf33da88fc2ULL, 0xd5a79147930aa725ULL,
    0x06ca6351e003826fULL, 0x142929670a0e6e70ULL, 0x27b70a8546d22ffcULL,
    0x2e1b21385c26c926ULL, 0x4d2c6dfc5ac42aedULL, 0x53380d139d95b3dfULL,
    0x650a73548baf63deULL, 0x766a0abb3c77b2a8ULL, 0x81c2c92e47edaee6ULL,
    0x92722c851482353bULL, 0xa2bfe8a14cf10364ULL, 0xa81a664bbc423001ULL,
    0xc24b8b70d0f89791ULL, 0xc76c51a30654be30ULL, 0xd192e819d6ef5218ULL,
    0xd69906245565a910ULL, 0xf40e35855771202aULL, 0x106aa07032bbd1b8ULL,
    0x19a4c116b8d2d0c8ULL, 0x1e376c085141ab53ULL, 0x2748774cdf8eeb99ULL,
    0x34b0bcb5e19b48a8ULL, 0x391c0cb3c5c95a63ULL, 0x4ed8aa4ae3418acbULL,
    0x5b9cca4f7763e373ULL, 0x682e6ff3d6b2b8a3ULL, 0x748f82ee5defb2fcULL,
    0x78a5636f43172f60ULL, 0x84c87814a1f0ab72ULL, 0x8cc702081a6439ecULL,
    0x90befffa23631e28ULL, 0xa4506cebde82bde9ULL, 0xbef9a3f7b2c67915ULL,
    0xc67178f2e372532bULL, 0xca273eceea26619cULL, 0xd186b8c721c0c207ULL,
    0xeada7dd6cde0eb1eULL, 0xf57d4f7fee6ed178ULL, 0x06f067aa72176fbaULL,
    0x0a637dc5a2c898a6ULL, 0x113f9804bef90daeULL, 0x1b710b35131c471bULL,
    0x28db77f523047d84ULL, 0x32caab7b40c72493ULL, 0x3c9ebe0a15c9bebcULL,
    0x431d67c49c100d4cULL, 0x4cc5d4becb3e42b6ULL, 0x597f299cfc657e2aULL,
    0x5fcb6fab3ad6faecULL, 0x6c44198c4a475817ULL,
};

typedef struct {
    uint64_t h[8];
    uint64_t total;          /* bytes hashed so far */
    unsigned char buf[128];
    size_t fill;
} sha512_ctx;

static uint64_t sha512_ror(uint64_t x, int n) { return (x >> n) | (x << (64 - n)); }

static uint64_t sha512_load(const unsigned char *p)
{
    uint64_t v = 0;
    int i;
    for (i = 0; i < 8; i++) v = (v << 8) | p[i];
    return v;
}

static void sha512_block(uint64_t h[8], const unsigned char *p)
{
    uint64_t w[80], a, b, c, d, e, f, g, k, t1, t2;
    int i;
    for (i = 0; i < 16; i++) w[i] = sha512_load(p + 8 * i);
    for (i = 16; i < 80; i++) {
        uint64_t s0 = sha512_ror(w[i - 15], 1) ^ sha512_ror(w[i - 15], 8) ^ (w[i - 15] >> 7);
        uint64_t s1 = sha512_ror(w[i - 2], 19) ^ sha512_ror(w[i - 2], 61) ^ (w[i - 2] >> 6);
        w[i] = w[i - 16] + s0 + w[i - 7] + s1;
    }
    a = h[0]; b = h[1]; c = h[2]; d = h[3]; e = h[4]; f = h[5]; g = h[6]; k = h[7];
    for (i = 0; i < 80; i++) {
        t1 = k + (sha512_ror(e, 14) ^ sha512_ror(e, 18) ^ sha512_ror(e, 41))
             + ((e & f) ^ (~e & g)) + SHA512_K[i] + w[i];
        t2 = (sha512_ror(a, 28) ^ sha512_ror(a, 34) ^ sha512_ror(a, 39))
             + ((a & b) ^ (a & c) ^ (b & c));
        k = g; g = f; f = e; e = d + t1; d = c; c = b; b = a; a = t1 + t2;
    }
    h[0] += a; h[1] += b; h[2] += c; h[3] += d; h[4] += e; h[5] += f; h[6] += g; h[7] += k;
    sda_wipe(w, sizeof w);
}

static void sha512_init(sha512_ctx *c)
{
    static const uint64_t iv[8] = {
    0x6a09e667f3bcc908ULL,
    0xbb67ae8584caa73bULL,
    0x3c6ef372fe94f82bULL,
    0xa54ff53a5f1d36f1ULL,
    0x510e527fade682d1ULL,
    0x9b05688c2b3e6c1fULL,
    0x1f83d9abfb41bd6bULL,
    0x5be0cd19137e2179ULL,
    };
    memcpy(c->h, iv, sizeof iv);
    c->total = 0;
    c->fill = 0;
}

static void sha512_update(sha512_ctx *c, const unsigned char *m, size_t n)
{
    c->total += n;
    if (c->fill) {
        size_t take = 128 - c->fill < n ? 128 - c->fill : n;
        memcpy(c->buf + c->fill, m, take);
        c->fill += take; m += take; n -= take;
        if (c->fill < 128) return;
        sha512_block(c->h, c->buf);
        c->fill = 0;
    }
    for (; n >= 128; m += 128, n -= 128) sha512_block(c->h, m);
    memcpy(c->buf, m, n);
    c->fill = n;
}

static void sha512_final(sha512_ctx *c, unsigned char out[64])
{
    uint64_t bits = c->total << 3;
    int i;
    c->buf[c->fill++] = 0x80;
    if (c->fill > 112) {
        memset(c->buf + c->fill, 0, 128 - c->fill);
        sha512_block(c->h, c->buf);
        c->fill = 0;
    }
    /* a 128-bit length whose top 64 bits hold the bytes' top 3 bits */
    memset(c->buf + c->fill, 0, 120 - c->fill);
    c->buf[119] = (unsigned char)(c->total >> 61);
    for (i = 0; i < 8; i++) c->buf[120 + i] = (unsigned char)(bits >> (56 - 8 * i));
    sha512_block(c->h, c->buf);
    for (i = 0; i < 64; i++) out[i] = (unsigned char)(c->h[i / 8] >> (56 - 8 * (i % 8)));
    sda_wipe(c, sizeof *c);
}

/* ---- scalars mod L = 2^252 + 27742317777372353535851937790883648493 ---- */

static const int64_t SC_L[32] = {
    0xed, 0xd3, 0xf5, 0x5c, 0x1a, 0x63, 0x12, 0x58, 0xd6, 0x9c, 0xf7, 0xa2, 0xde, 0xf9, 0xde, 0x14,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0x10,
};

/* r = x mod L, x as 64 signed limbs of weight 256^i: fold each limb from
 * the 63rd down to the 32nd into the ones below it (2^256 = -16 (L - 2^252)
 * mod L), fold the top nibble once, then carry into bytes */
static void sc_modl(unsigned char r[32], int64_t x[64])
{
    int64_t carry;
    int i, j;
    for (i = 63; i >= 32; --i) {
        carry = 0;
        for (j = i - 32; j < i - 12; ++j) {
            x[j] += carry - 16 * x[i] * SC_L[j - (i - 32)];
            carry = (x[j] + 128) >> 8;
            x[j] -= carry * 256;
        }
        x[j] += carry;
        x[i] = 0;
    }
    carry = 0;
    for (j = 0; j < 32; j++) {
        x[j] += carry - (x[31] >> 4) * SC_L[j];
        carry = x[j] >> 8;
        x[j] &= 255;
    }
    for (j = 0; j < 32; j++) x[j] -= carry * SC_L[j];
    for (i = 0; i < 32; i++) {
        x[i + 1] += x[i] >> 8;
        r[i] = (unsigned char)(x[i] & 255);
    }
}

/* r = s mod L for a 64-byte little-endian s (ref10's sc_reduce) */
static void sc_reduce64(unsigned char r[32], const unsigned char s[64])
{
    int64_t x[64];
    int i;
    for (i = 0; i < 64; i++) x[i] = s[i];
    sc_modl(r, x);
    sda_wipe(x, sizeof x);
}

/* s = (c + a b) mod L for 32-byte a, b, c (ref10's sc_muladd) */
static void sc_muladd(unsigned char s[32], const unsigned char a[32], const unsigned char b[32],
                      const unsigned char c[32])
{
    int64_t x[64];
    int i, j;
    for (i = 0; i < 64; i++) x[i] = i < 32 ? c[i] : 0;
    for (i = 0; i < 32; i++)
        for (j = 0; j < 32; j++) x[i + j] += (int64_t)a[i] * b[j];
    sc_modl(s, x);
    sda_wipe(x, sizeof x);
}

/* ---- the base point's multiples, Edwards-encoded ---- */

/* acc = scalar * B on the base comb table, scalar < 2^255 */
static void ge_scalarmult_base(ge_p3 *acc, const unsigned char scalar[32])
{
    signed char e[COMB_DIGITS];
    ge_niels sel;
    int i;
    pthread_once(&g_base_once, build_base_table);
    comb_recode(e, scalar);
    ge_identity(acc);
    for (i = 0; i < COMB_DIGITS; i++) {
        niels_select(&sel, g_base_table.t[i], e[i]);
        ge_madd(acc, acc, &sel);
    }
    sda_wipe(e, sizeof e);
    sda_wipe(&sel, sizeof sel);
}

/* the Ed25519 encoding of p: y, with x's low bit in bit 255 */
static void ge_p3_tobytes(unsigned char s[32], const ge_p3 *p)
{
    fe zinv, x, y;
    unsigned char xb[32];
    fe_invert(&zinv, &p->Z);
    fe_mul(&x, &p->X, &zinv);
    fe_mul(&y, &p->Y, &zinv);
    fe_tobytes(s, &y);
    fe_tobytes(xb, &x);
    s[31] ^= (unsigned char)((xb[0] & 1) << 7);
}

/* ---- entry points ---- */

/* pk = X25519(sk, 9): crypto_box_keypair's public half */
void sda_box_public_key(const uint8_t *sk, uint8_t *pk)
{
    unsigned char e[32];
    clamp(e, sk);
    pthread_once(&g_base_once, build_base_table);
    sda_comb_scalarmult_u(pk, &g_base_table, e);
    sda_wipe(e, sizeof e);
}

/* az = SHA-512(seed), its first half clamped: the secret scalar a and the
 * nonce prefix */
static void sign_expand(unsigned char az[64], const unsigned char seed[32])
{
    sha512_ctx c;
    sha512_init(&c);
    sha512_update(&c, seed, 32);
    sha512_final(&c, az);
    az[0] &= 248; az[31] &= 127; az[31] |= 64;
}

/* vk = a B, sk = seed || vk: crypto_sign_seed_keypair */
void sda_sign_seed_keypair(const uint8_t *seed, uint8_t *vk, uint8_t *sk)
{
    unsigned char az[64];
    ge_p3 A;
    sign_expand(az, seed);
    ge_scalarmult_base(&A, az);
    ge_p3_tobytes(vk, &A);
    memmove(sk, seed, 32);
    memcpy(sk + 32, vk, 32);
    sda_wipe(az, sizeof az);
    sda_wipe(&A, sizeof A);
}

/* sig = R || S over m under sk = seed || vk: crypto_sign_detached, with
 * r = SHA-512(prefix || m) mod L, R = r B, k = SHA-512(R || vk || m) mod L
 * and S = r + k a mod L (vk is the key's own second half, as libsodium
 * takes it) */
void sda_sign_detached(const uint8_t *m, int64_t mlen, const uint8_t *sk, uint8_t *sig)
{
    unsigned char az[64], h[64], r[32], k[32];
    sha512_ctx c;
    ge_p3 R;
    sign_expand(az, sk);
    sha512_init(&c);
    sha512_update(&c, az + 32, 32);
    sha512_update(&c, m, (size_t)mlen);
    sha512_final(&c, h);
    sc_reduce64(r, h);
    ge_scalarmult_base(&R, r);
    ge_p3_tobytes(sig, &R);
    sha512_init(&c);
    sha512_update(&c, sig, 32);
    sha512_update(&c, sk + 32, 32);
    sha512_update(&c, m, (size_t)mlen);
    sha512_final(&c, h);
    sc_reduce64(k, h);
    sc_muladd(sig + 32, k, az, r);
    sda_wipe(az, sizeof az);
    sda_wipe(h, sizeof h);
    sda_wipe(r, sizeof r);
    sda_wipe(k, sizeof k);
    sda_wipe(&R, sizeof R);
}
