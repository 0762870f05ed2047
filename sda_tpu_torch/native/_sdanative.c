/* sda_tpu_torch's native batch layer: bulk varints, batched sealed boxes and
 * ChaCha20 mask expansion (the counterpart of sda_tpu/native/_sdanative.c).
 *
 * The reference layer is a CPython extension over libsodium. This one is a
 * plain C library with no Python.h and no library behind it: the sealed
 * box's symmetric half comes from sodium_prims.c, the X25519 half from
 * curve25519_comb.c (comb tables and a Montgomery ladder); ed25519.c (key
 * generation and signing on the same comb table) and bignum.c (Montgomery
 * modexp over the pool below) are included at the end of this file, and
 * native/__init__.py builds the five files as one translation unit with
 * the host's C compiler and binds it with ctypes, which releases the GIL
 * for the whole call.
 *
 * Calling conventions:
 *   - a batch of byte strings is one concatenated buffer plus n + 1 int64
 *     offsets; outputs go to one caller-allocated buffer at its own offsets;
 *   - ephemeral secret keys come from the caller (32 bytes each, clamped
 *     here), so a test can fix them and hold the output byte for byte
 *     against the plain version;
 *   - batch entry points split the batch into contiguous chunks over a
 *     pthread pool and return -1, or the lowest failing index whatever the
 *     thread count.
 *
 * Wire formats are the reference's:
 *   - varint: zigzag(i64) then little-endian base-128 with continuation
 *     bits (integer-encoding crate semantics);
 *   - sealed box: crypto_box_seal, epk (32) || tag (16) || ciphertext, with
 *     nonce blake2b(epk || pk, 24) and key HSalsa20(X25519(esk, pk), 0).
 */

#include <pthread.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#include "sodium_prims.c"
#include "curve25519_comb.c"

#define SEALBYTES 48 /* epk (32) + Poly1305 tag (16) */
#define SDA_COMB_MIN_BATCH 8
#define SDA_MAX_THREADS 64

#define SDA_ERR_KEYS (-2)  /* wrong number of ephemeral keys for the path */
#define SDA_ERR_NOMEM (-3) /* a table or scratch allocation failed */

/* ---------------- varint ---------------- */

/* zigzag-LEB128 of n int64 values into out (room for 10 bytes per value);
 * returns the bytes written */
int64_t sda_varint_encode(const int64_t *vals, int64_t n, uint8_t *out) {
    int64_t i, pos = 0;
    for (i = 0; i < n; i++) {
        uint64_t z = ((uint64_t)vals[i] << 1) ^ (uint64_t)(vals[i] >> 63);
        while (z >= 0x80) {
            out[pos++] = (uint8_t)(z | 0x80);
            z >>= 7;
        }
        out[pos++] = (uint8_t)z;
    }
    return pos;
}

#define SDA_VARINT_TRUNCATED (-1)
#define SDA_VARINT_TOO_LONG (-2)

/* the number of varints in a stream, or SDA_VARINT_TRUNCATED when the last
 * byte carries a continuation bit, or SDA_VARINT_TOO_LONG when one spans
 * more than 10 bytes (the plain decoder's checks, in its order) */
int64_t sda_varint_count(const uint8_t *in, int64_t len) {
    int64_t i, count = 0, run = 0, longest = 0;
    if (len == 0) return 0;
    if (in[len - 1] & 0x80) return SDA_VARINT_TRUNCATED;
    for (i = 0; i < len; i++) {
        run++;
        if (!(in[i] & 0x80)) {
            if (run > longest) longest = run;
            count++;
            run = 0;
        }
    }
    return longest > 10 ? SDA_VARINT_TOO_LONG : count;
}

/* decode a stream that sda_varint_count accepted into out (its count);
 * bits past the 64th of a 10-byte varint drop, as in the plain decoder */
void sda_varint_decode(const uint8_t *in, int64_t len, int64_t *out) {
    int64_t i = 0, k = 0;
    while (i < len) {
        uint64_t z = 0;
        int shift = 0;
        for (;;) {
            uint8_t b = in[i++];
            z |= ((uint64_t)(b & 0x7F)) << shift;
            if (!(b & 0x80)) break;
            shift += 7;
        }
        out[k++] = (int64_t)((z >> 1) ^ (~(z & 1) + 1)); /* unzigzag */
    }
}

/* ---------------- the pool ----------------
 *
 * run_chunked calls fn(ctx, lo, hi) over contiguous chunks of [0, n), one
 * chunk per thread, and returns the lowest index any chunk reported (or -1).
 * A chunk's first failure is its lowest, so the result does not depend on
 * the thread count or on the interleaving. */

typedef int64_t (*range_fn)(void *ctx, int64_t lo, int64_t hi);

typedef struct {
    range_fn fn;
    void *ctx;
    int64_t lo, hi, fail;
} chunk_t;

static void *chunk_worker(void *arg) {
    chunk_t *c = (chunk_t *)arg;
    c->fail = c->fn(c->ctx, c->lo, c->hi);
    return NULL;
}

static int64_t run_chunked(range_fn fn, void *ctx, int64_t n, int n_threads) {
    chunk_t jobs[SDA_MAX_THREADS];
    pthread_t tids[SDA_MAX_THREADS];
    int started[SDA_MAX_THREADS];
    int64_t chunk, first = -1;
    int t;
    if (n <= 0) return -1;
    if (n_threads < 1) n_threads = 1;
    if (n_threads > SDA_MAX_THREADS) n_threads = SDA_MAX_THREADS;
    if (n_threads > n) n_threads = (int)n;
    if (n_threads == 1) return fn(ctx, 0, n);
    chunk = (n + n_threads - 1) / n_threads;
    for (t = 0; t < n_threads; t++) {
        int64_t lo = t * chunk, hi = lo + chunk < n ? lo + chunk : n;
        chunk_t c = {fn, ctx, lo, lo < hi ? hi : lo, -1};
        jobs[t] = c;
        started[t] = pthread_create(&tids[t], NULL, chunk_worker, &jobs[t]) == 0;
        if (!started[t]) chunk_worker(&jobs[t]); /* run it on this thread */
    }
    for (t = 0; t < n_threads; t++) {
        if (started[t]) pthread_join(tids[t], NULL);
        if (jobs[t].fail >= 0 && (first < 0 || jobs[t].fail < first)) first = jobs[t].fail;
    }
    return first;
}

/* ---------------- sealed boxes ---------------- */

static comb_table g_base_table; /* esk * G, built once per process */
static pthread_once_t g_base_once = PTHREAD_ONCE_INIT;

static void build_base_table(void) { sda_comb_table_base(&g_base_table); }

static int is_zero32(const unsigned char *p) {
    unsigned char acc = 0;
    int i;
    for (i = 0; i < 32; i++) acc |= p[i];
    return acc == 0;
}

static void clamp(unsigned char e[32], const unsigned char esk[32]) {
    memcpy(e, esk, 32);
    e[0] &= 248; e[31] &= 127; e[31] |= 64;
}

static const unsigned char BASE_U[32] = {9};
static const unsigned char ZERO16[16] = {0};

/* X25519 on the ladder, one inversion: the per-item path */
static void ladder_u(unsigned char out[32], const unsigned char scalar[32],
                     const unsigned char point[32]) {
    fe x, z, zinv, u;
    sda_x25519_ladder_frac(&x, &z, scalar, point);
    fe_invert(&zinv, &z);
    fe_mul(&u, &x, &zinv);
    fe_tobytes(out, &u);
}

/* the box for one message once X25519 is done: out = epk || tag || c.
 * Returns 0, or -1 for a zero shared secret (crypto_box_beforenm's
 * failure, which a small-order recipient key gives). */
static int compose_box(unsigned char *out, const unsigned char *m, size_t mlen,
                       const unsigned char epk[32], const unsigned char pk[32],
                       const unsigned char shared[32]) {
    unsigned char k[32], nonce[24], hin[64];
    if (is_zero32(shared)) return -1;
    sda_hsalsa20(k, ZERO16, shared);
    memcpy(hin, epk, 32);
    memcpy(hin + 32, pk, 32);
    sda_blake2b(nonce, sizeof nonce, hin, sizeof hin);
    memcpy(out, epk, 32);
    sda_secretbox(out + 32, m, mlen, nonce, k);
    sda_wipe(k, sizeof k);
    return 0;
}

/* crypto_box_seal under a given ephemeral secret, both scalarmults on the
 * ladder */
static int seal_one(unsigned char *out, const unsigned char *m, size_t mlen,
                    const unsigned char pk[32], const unsigned char esk[32]) {
    unsigned char e[32], epk[32], shared[32];
    int rc;
    clamp(e, esk);
    ladder_u(epk, e, BASE_U);
    ladder_u(shared, e, pk);
    rc = compose_box(out, m, mlen, epk, pk, shared);
    sda_wipe(e, sizeof e);
    sda_wipe(shared, sizeof shared);
    return rc;
}

/* crypto_box_seal_open once X25519 is done: box = epk || tag || c */
static int open_composed(unsigned char *out, const unsigned char *box, size_t blen,
                         const unsigned char pk[32], const unsigned char shared[32]) {
    unsigned char k[32], nonce[24], hin[64];
    int rc;
    if (is_zero32(shared)) return -1;
    sda_hsalsa20(k, ZERO16, shared);
    memcpy(hin, box, 32);
    memcpy(hin + 32, pk, 32);
    sda_blake2b(nonce, sizeof nonce, hin, sizeof hin);
    rc = sda_secretbox_open(out, box + 32, blen - SEALBYTES, nonce, k);
    sda_wipe(k, sizeof k);
    return rc;
}

typedef struct {
    const uint8_t *in;
    const int64_t *in_off;
    uint8_t *out;
    const int64_t *out_off;
    const unsigned char *pk, *sk, *esks;
    const comb_table *pt; /* the recipient's table: comb path, else NULL */
} batch_ctx;

#define ITEM(ctx, i) ((ctx)->in + (ctx)->in_off[i])
#define ITEM_LEN(ctx, i) ((size_t)((ctx)->in_off[(i) + 1] - (ctx)->in_off[i]))
#define OUT(ctx, i) ((ctx)->out + (ctx)->out_off[i])

static int64_t seal_items(void *arg, int64_t lo, int64_t hi) {
    batch_ctx *c = (batch_ctx *)arg;
    int64_t i;
    for (i = lo; i < hi; i++)
        if (seal_one(OUT(c, i), ITEM(c, i), ITEM_LEN(c, i), c->pk, c->esks + 32 * i) != 0)
            return i;
    return -1;
}

/* seal items [lo, hi) to one recipient on the comb tables: 64 + 64 mixed
 * additions per item and one batch inversion for the chunk */
static int64_t comb_seal_items(void *arg, int64_t lo, int64_t hi) {
    batch_ctx *c = (batch_ctx *)arg;
    int64_t n = hi - lo, i, fail = -1;
    fe *num = malloc(sizeof(fe) * (size_t)n * 2);
    fe *den = malloc(sizeof(fe) * (size_t)n * 2);
    fe *scr = malloc(sizeof(fe) * (size_t)n * 2);
    unsigned char *us = malloc((size_t)n * 64); /* per item: epk || shared */
    unsigned char e[32];
    if (!num || !den || !scr || !us) {
        free(num); free(den); free(scr); free(us);
        return seal_items(arg, lo, hi); /* the ladder needs no scratch */
    }
    for (i = 0; i < n; i++) {
        clamp(e, c->esks + 32 * (lo + i));
        sda_comb_scalarmult_frac(&num[2 * i], &den[2 * i], &g_base_table, e);
        sda_comb_scalarmult_frac(&num[2 * i + 1], &den[2 * i + 1], c->pt, e);
    }
    sda_wipe(e, sizeof e);
    sda_comb_finalize_u(us, num, den, scr, (int)(n * 2));
    for (i = 0; i < n; i++) {
        if (compose_box(OUT(c, lo + i), ITEM(c, lo + i), ITEM_LEN(c, lo + i), us + 64 * i,
                        c->pk, us + 64 * i + 32) != 0) {
            fail = lo + i;
            break;
        }
    }
    sda_wipe(us, (size_t)n * 64);
    sda_wipe(num, sizeof(fe) * (size_t)n * 2);
    sda_wipe(den, sizeof(fe) * (size_t)n * 2);
    free(num); free(den); free(scr); free(us);
    return fail;
}

/* 1 when a batch of `total` boxes to these C recipient keys takes the comb
 * path: at least SDA_COMB_MIN_BATCH boxes and every key lifts to a curve
 * point. The caller draws its ephemeral keys by this answer. */
int sda_seal_uses_comb(const uint8_t *pks, int64_t C, int64_t total) {
    int64_t c;
    if (total < SDA_COMB_MIN_BATCH || C <= 0) return 0;
    for (c = 0; c < C; c++)
        if (!sda_comb_lifts(pks + 32 * c)) return 0;
    return 1;
}

/* seal n messages to pk, message i under ephemeral secret esks[32 i].
 * Returns -1, the lowest failing index, or SDA_ERR_NOMEM. */
int64_t sda_seal_batch(const uint8_t *in, const int64_t *in_off, int64_t n,
                       const uint8_t *pk, const uint8_t *esks, uint8_t *out,
                       const int64_t *out_off, int n_threads) {
    batch_ctx c = {in, in_off, out, out_off, pk, NULL, esks, NULL};
    comb_table *pt = NULL;
    int64_t fail;
    if (sda_seal_uses_comb(pk, 1, n)) {
        pt = malloc(sizeof *pt);
        if (!pt) return SDA_ERR_NOMEM;
        pthread_once(&g_base_once, build_base_table);
        sda_comb_table_from_u(pt, pk);
        c.pt = pt;
        fail = run_chunked(comb_seal_items, &c, n, n_threads);
    } else {
        fail = run_chunked(seal_items, &c, n, n_threads);
    }
    free(pt);
    return fail;
}

/* open items [lo, hi): one ladder each with the division deferred into one
 * batch inversion for the chunk. Items shorter than a sealed box fail. */
static int64_t open_items(void *arg, int64_t lo, int64_t hi) {
    batch_ctx *c = (batch_ctx *)arg;
    int64_t n = hi - lo, i, fail = -1;
    fe *num = malloc(sizeof(fe) * (size_t)n);
    fe *den = malloc(sizeof(fe) * (size_t)n);
    fe *scr = malloc(sizeof(fe) * (size_t)n);
    unsigned char *us = malloc((size_t)n * 32);
    if (!num || !den || !scr || !us) {
        free(num); free(den); free(scr); free(us);
        for (i = lo; i < hi; i++) {
            unsigned char shared[32];
            int rc;
            if (ITEM_LEN(c, i) < SEALBYTES) return i;
            ladder_u(shared, c->sk, ITEM(c, i));
            rc = open_composed(OUT(c, i), ITEM(c, i), ITEM_LEN(c, i), c->pk, shared);
            sda_wipe(shared, sizeof shared);
            if (rc != 0) return i;
        }
        return -1;
    }
    for (i = 0; i < n; i++) {
        if (ITEM_LEN(c, lo + i) < SEALBYTES) {
            fe_1(&num[i]); fe_1(&den[i]); /* a placeholder: the item fails below */
            continue;
        }
        sda_x25519_ladder_frac(&num[i], &den[i], c->sk, ITEM(c, lo + i));
    }
    sda_comb_finalize_u(us, num, den, scr, (int)n);
    for (i = 0; i < n; i++) {
        if (ITEM_LEN(c, lo + i) < SEALBYTES ||
            open_composed(OUT(c, lo + i), ITEM(c, lo + i), ITEM_LEN(c, lo + i), c->pk,
                          us + 32 * i) != 0) {
            fail = lo + i;
            break;
        }
    }
    sda_wipe(us, (size_t)n * 32);
    sda_wipe(num, sizeof(fe) * (size_t)n);
    sda_wipe(den, sizeof(fe) * (size_t)n);
    free(num); free(den); free(scr); free(us);
    return fail;
}

/* open n sealed boxes addressed to (pk, sk); plaintext i goes to
 * out + out_off[i]. Returns -1 or the lowest index that is shorter than a
 * sealed box, yields a zero shared secret or fails its tag: the inputs
 * crypto_box_seal_open rejects. */
int64_t sda_open_batch(const uint8_t *in, const int64_t *in_off, int64_t n,
                       const uint8_t *pk, const uint8_t *sk, uint8_t *out,
                       const int64_t *out_off, int n_threads) {
    batch_ctx c = {in, in_off, out, out_off, pk, sk, NULL, NULL};
    return run_chunked(open_items, &c, n, n_threads);
}

/* ---------------- committee sealing ----------------
 *
 * P participants x C clerks: message p * C + c is sealed to clerk key c.
 * On the comb path one ephemeral key per PARTICIPANT is shared across its C
 * boxes (nonce = blake2b(epk || pk_c) and key = HSalsa20(esk * pk_c) both
 * differ per clerk, so no nonce/key pair repeats), which takes the X25519
 * cost per box from two scalarmults to (1 + 1/C) comb multiplications. The
 * C boxes of one participation are linked publicly by the participation
 * record itself, so the shared epk tells nothing new. The scalarmults split
 * over participants, then the boxes over (p, c) items, so a single
 * participant's C boxes still spread over the pool. Below the comb batch,
 * or when a clerk key does not lift, every box has its own ephemeral key
 * and seals on the ladder. */

typedef struct {
    batch_ctx b;
    int64_t C;
    const comb_table *pts; /* C tables */
    unsigned char *us;     /* per participant: epk || shared_0 .. shared_{C-1} */
} part_ctx;

static int64_t part_scalarmults(void *arg, int64_t lo, int64_t hi) {
    part_ctx *c = (part_ctx *)arg;
    int64_t C = c->C, per = 1 + C, nP = hi - lo, nf = nP * per, p, k;
    fe *num = malloc(sizeof(fe) * (size_t)nf);
    fe *den = malloc(sizeof(fe) * (size_t)nf);
    fe *scr = malloc(sizeof(fe) * (size_t)nf);
    unsigned char e[32];
    if (!num || !den || !scr) {
        free(num); free(den); free(scr);
        return lo; /* any index: the caller reports SDA_ERR_NOMEM */
    }
    for (p = 0; p < nP; p++) {
        int64_t b = p * per;
        clamp(e, c->b.esks + 32 * (lo + p));
        sda_comb_scalarmult_frac(&num[b], &den[b], &g_base_table, e);
        for (k = 0; k < C; k++)
            sda_comb_scalarmult_frac(&num[b + 1 + k], &den[b + 1 + k], &c->pts[k], e);
    }
    sda_wipe(e, sizeof e);
    sda_comb_finalize_u(c->us + 32 * lo * per, num, den, scr, (int)nf);
    sda_wipe(num, sizeof(fe) * (size_t)nf);
    sda_wipe(den, sizeof(fe) * (size_t)nf);
    free(num); free(den); free(scr);
    return -1;
}

static int64_t part_boxes(void *arg, int64_t lo, int64_t hi) {
    part_ctx *c = (part_ctx *)arg;
    int64_t per = 1 + c->C, i;
    for (i = lo; i < hi; i++) {
        int64_t p = i / c->C, k = i % c->C;
        const unsigned char *u = c->us + 32 * p * per;
        if (compose_box(OUT(&c->b, i), ITEM(&c->b, i), ITEM_LEN(&c->b, i), u,
                        c->b.pk + 32 * k, u + 32 * (1 + k)) != 0)
            return i;
    }
    return -1;
}

static int64_t part_items(void *arg, int64_t lo, int64_t hi) {
    part_ctx *c = (part_ctx *)arg;
    int64_t i;
    for (i = lo; i < hi; i++)
        if (seal_one(OUT(&c->b, i), ITEM(&c->b, i), ITEM_LEN(&c->b, i),
                     c->b.pk + 32 * (i % c->C), c->b.esks + 32 * i) != 0)
            return i;
    return -1;
}

/* seal a P x C share matrix to C clerk keys (pks: C * 32 bytes). n_esks is
 * the number of ephemeral keys given: P on the comb path, P * C on the
 * ladder path (sda_seal_uses_comb says which), else SDA_ERR_KEYS. Returns
 * -1, the lowest failing flat index p * C + c, or an SDA_ERR code. */
int64_t sda_seal_participations(const uint8_t *in, const int64_t *in_off, int64_t P,
                                int64_t C, const uint8_t *pks, const uint8_t *esks,
                                int64_t n_esks, uint8_t *out, const int64_t *out_off,
                                int n_threads) {
    part_ctx c;
    int64_t total = P * C, k, fail;
    int comb = sda_seal_uses_comb(pks, C, total);
    if (total <= 0) return -1;
    if (n_esks != (comb ? P : total)) return SDA_ERR_KEYS;
    memset(&c, 0, sizeof c);
    c.b.in = in; c.b.in_off = in_off; c.b.out = out; c.b.out_off = out_off;
    c.b.pk = pks; c.b.esks = esks;
    c.C = C;
    if (!comb) return run_chunked(part_items, &c, total, n_threads);
    {
        comb_table *pts = malloc(sizeof(comb_table) * (size_t)C);
        unsigned char *us = malloc((size_t)P * (size_t)(1 + C) * 32);
        if (!pts || !us) {
            free(pts); free(us);
            return SDA_ERR_NOMEM;
        }
        pthread_once(&g_base_once, build_base_table);
        for (k = 0; k < C; k++) sda_comb_table_from_u(&pts[k], pks + 32 * k);
        c.pts = pts;
        c.us = us;
        fail = run_chunked(part_scalarmults, &c, P, n_threads);
        if (fail == -1) fail = run_chunked(part_boxes, &c, total, n_threads);
        else fail = SDA_ERR_NOMEM;
        sda_wipe(us, (size_t)P * (size_t)(1 + C) * 32);
        free(pts); free(us);
    }
    return fail;
}

/* ---------------- ChaCha20 mask expansion ----------------
 *
 * Bit-identical to ops/chacha.py expand_seed: the djb ChaCha20 keystream
 * (zero nonce, 64-bit block counter from 0), words taken in order as u64
 * pairs (w[2i] << 32) | w[2i+1], rejected at or above the rand-0.3
 * gen_range zone u64::MAX - u64::MAX % m, reduced mod m. */

static void expand_key(const unsigned char *key_bytes, int64_t dim, uint64_t m,
                       int64_t *vals, int64_t *acc) {
    uint32_t key[8], w[16];
    uint64_t zone = ~(uint64_t)0 - (~(uint64_t)0 % m), counter = 0;
    int64_t i = 0;
    int j;
    for (j = 0; j < 8; j++) key[j] = ld32(key_bytes + 4 * j);
    while (i < dim) {
        sda_chacha20_block(w, key, counter++);
        for (j = 0; j < 16 && i < dim; j += 2) {
            uint64_t v = ((uint64_t)w[j] << 32) | (uint64_t)w[j + 1];
            uint64_t r;
            if (v >= zone) continue;
            r = v % m;
            if (acc) {
                uint64_t s = (uint64_t)acc[i] + r; /* < 2^64: both < m <= 2^63 */
                acc[i] = (int64_t)(s % m);
            } else {
                vals[i] = (int64_t)r;
            }
            i++;
        }
    }
    sda_wipe(key, sizeof key);
    sda_wipe(w, sizeof w);
}

/* one 32-byte key -> out[dim] in [0, m), 0 < m <= 2^63 */
void sda_chacha_expand(const uint8_t *key, int64_t dim, uint64_t m, int64_t *out) {
    expand_key(key, dim, m, out, NULL);
}

/* the elementwise sum mod m of n keys' expansions (n * 32 key bytes) */
void sda_chacha_combine(const uint8_t *keys, int64_t n, int64_t dim, uint64_t m,
                        int64_t *out) {
    int64_t s;
    memset(out, 0, (size_t)dim * sizeof *out);
    for (s = 0; s < n; s++) expand_key(keys + 32 * s, dim, m, NULL, out);
}

/* ---------------- key generation, signing, modexp ----------------
 * included here, after the pool and the base table they use */

#include "ed25519.c"
#include "bignum.c"
