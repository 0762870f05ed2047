/* Modular exponentiation over 64-bit limbs (counterpart of
 * sda_tpu/native/bignum.py, which binds OpenSSL's BN_mod_exp): Montgomery
 * multiplication in the CIOS form with unsigned __int128 products, and a
 * fixed 5-bit window. The modulus must be odd, as every Paillier n^2 and
 * every Miller-Rabin candidate that reaches here is.
 *
 * Numbers are little-endian uint64 limb arrays; a base has the modulus's
 * limb count and is below the modulus (the Python side reduces it). The
 * window schedule depends only on the exponent's length: every window
 * squares five times and multiplies once, by the table's entry 0 (one) when
 * its digit is 0. Table lookups index by the digit: Paillier's modexps need
 * no constant time (ops/paillier.py's threat model), and no secret key
 * passes through here on a path that does.
 *
 * sda_mod_exp_batch computes the Montgomery constants once per modulus and
 * splits the bases over the pthread pool of _sdanative.c; each base is
 * raised by exactly one thread, so the result does not depend on the
 * thread count.
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#define BN_WINDOW 5
#define BN_TABLE (1 << BN_WINDOW)

#define SDA_ERR_EVEN (-4) /* the modulus is even (or zero) */

typedef struct {
    int64_t n;          /* limbs */
    const uint64_t *m;  /* the modulus, odd */
    uint64_t m0inv;     /* -m^-1 mod 2^64 */
    uint64_t *one;      /* R mod m, R = 2^(64 n) */
    uint64_t *r2;       /* R^2 mod m */
} mont_ctx;

/* out = a b / R mod m for a, b < m; t is n + 2 limbs of scratch; out may
 * alias a or b */
static void mont_mul(uint64_t *out, const uint64_t *a, const uint64_t *b, const mont_ctx *c,
                     uint64_t *t)
{
    const int64_t n = c->n;
    const uint64_t *m = c->m;
    unsigned __int128 acc;
    uint64_t carry, q, borrow, keep;
    int64_t i, j;
    memset(t, 0, sizeof(uint64_t) * (size_t)(n + 2));
    for (i = 0; i < n; i++) {
        uint64_t bi = b[i];
        carry = 0;
        for (j = 0; j < n; j++) {
            acc = (unsigned __int128)a[j] * bi + t[j] + carry;
            t[j] = (uint64_t)acc;
            carry = (uint64_t)(acc >> 64);
        }
        acc = (unsigned __int128)t[n] + carry;
        t[n] = (uint64_t)acc;
        t[n + 1] = (uint64_t)(acc >> 64);
        q = t[0] * c->m0inv;
        acc = (unsigned __int128)q * m[0] + t[0];
        carry = (uint64_t)(acc >> 64);
        for (j = 1; j < n; j++) {
            acc = (unsigned __int128)q * m[j] + t[j] + carry;
            t[j - 1] = (uint64_t)acc;
            carry = (uint64_t)(acc >> 64);
        }
        acc = (unsigned __int128)t[n] + carry;
        t[n - 1] = (uint64_t)acc;
        t[n] = t[n + 1] + (uint64_t)(acc >> 64);
    }
    /* t < 2m: out = t - m unless that borrows past t's top limb */
    borrow = 0;
    for (j = 0; j < n; j++) {
        uint64_t d = t[j] - m[j];
        uint64_t b2 = (t[j] < m[j]) | (d < borrow);
        out[j] = d - borrow;
        borrow = b2;
    }
    keep = (uint64_t)0 - (uint64_t)(borrow > t[n]); /* all ones: t < m */
    for (j = 0; j < n; j++) out[j] = (t[j] & keep) | (out[j] & ~keep);
}

/* x = 2 x mod m for x < m */
static void mod_double(uint64_t *x, const uint64_t *m, int64_t n)
{
    uint64_t top = x[n - 1] >> 63, borrow = 0;
    int64_t j;
    int ge = 1; /* (top:x) >= m, equality included */
    for (j = n - 1; j > 0; j--) x[j] = (x[j] << 1) | (x[j - 1] >> 63);
    x[0] <<= 1;
    if (!top)
        for (j = n - 1; j >= 0; j--)
            if (x[j] != m[j]) {
                ge = x[j] > m[j];
                break;
            }
    if (!ge) return;
    for (j = 0; j < n; j++) {
        uint64_t d = x[j] - m[j];
        uint64_t b2 = (x[j] < m[j]) | (d < borrow);
        x[j] = d - borrow;
        borrow = b2;
    }
}

/* fill the constants of c for the n-limb odd modulus m; returns 0, or
 * SDA_ERR_NOMEM */
static int mont_setup(mont_ctx *c, const uint64_t *m, int64_t n)
{
    uint64_t inv = 1;
    int64_t i;
    int k;
    c->n = n;
    c->m = m;
    for (k = 0; k < 6; k++) inv *= 2 - m[0] * inv; /* Newton: m inv = 1 mod 2^64 */
    c->m0inv = (uint64_t)0 - inv;
    c->one = calloc((size_t)n, sizeof(uint64_t));
    c->r2 = calloc((size_t)n, sizeof(uint64_t));
    if (!c->one || !c->r2) {
        free(c->one); free(c->r2);
        return SDA_ERR_NOMEM;
    }
    /* 1 mod m, doubled 64 n times is R mod m, 64 n more is R^2 mod m */
    c->one[0] = 1;
    if (n == 1 && m[0] == 1) c->one[0] = 0;
    for (i = 0; i < 64 * n; i++) mod_double(c->one, m, n);
    memcpy(c->r2, c->one, sizeof(uint64_t) * (size_t)n);
    for (i = 0; i < 64 * n; i++) mod_double(c->r2, m, n);
    return 0;
}

static void mont_free(mont_ctx *c)
{
    free(c->one);
    free(c->r2);
}

static int exp_bit(const uint64_t *e, int64_t bit)
{
    return (int)((e[bit / 64] >> (bit % 64)) & 1);
}

/* out = base^e mod m (base < m) with scratch of (BN_TABLE + 2) n + 2 limbs */
static void mont_pow(uint64_t *out, const uint64_t *base, const uint64_t *e, int64_t ne,
                     const mont_ctx *c, uint64_t *scratch)
{
    const int64_t n = c->n;
    uint64_t *table = scratch, *acc = scratch + BN_TABLE * n, *t = acc + n;
    int64_t bits = 64 * ne, w, windows;
    int d, b;
    while (bits > 0 && !exp_bit(e, bits - 1)) bits--;
    /* table[d] = base^d R mod m */
    memcpy(table, c->one, sizeof(uint64_t) * (size_t)n);
    mont_mul(table + n, base, c->r2, c, t);
    for (d = 2; d < BN_TABLE; d++) mont_mul(table + d * n, table + (d - 1) * n, table + n, c, t);
    memcpy(acc, c->one, sizeof(uint64_t) * (size_t)n);
    windows = (bits + BN_WINDOW - 1) / BN_WINDOW;
    for (w = windows - 1; w >= 0; w--) {
        d = 0;
        for (b = BN_WINDOW - 1; b >= 0; b--) {
            int64_t bit = w * BN_WINDOW + b;
            d = (d << 1) | (bit < bits ? exp_bit(e, bit) : 0);
        }
        if (w != windows - 1)
            for (b = 0; b < BN_WINDOW; b++) mont_mul(acc, acc, acc, c, t);
        mont_mul(acc, acc, table + d * n, c, t);
    }
    /* out of the Montgomery domain: acc 1 / R mod m */
    memset(table, 0, sizeof(uint64_t) * (size_t)n);
    table[0] = 1;
    mont_mul(out, acc, table, c, t);
}

static size_t pow_scratch_limbs(int64_t n) { return (size_t)((BN_TABLE + 2) * n + 2); }

/* out = base^e mod m, every number little-endian limbs: base and out n
 * limbs (base < m), e ne limbs. Returns 0, SDA_ERR_EVEN or SDA_ERR_NOMEM. */
int64_t sda_mod_exp(const uint64_t *base, const uint64_t *e, int64_t ne, const uint64_t *m,
                    int64_t n, uint64_t *out)
{
    mont_ctx c;
    uint64_t *scratch;
    if (n < 1 || !(m[0] & 1)) return SDA_ERR_EVEN;
    if (mont_setup(&c, m, n) != 0) return SDA_ERR_NOMEM;
    scratch = malloc(sizeof(uint64_t) * pow_scratch_limbs(n));
    if (!scratch) {
        mont_free(&c);
        return SDA_ERR_NOMEM;
    }
    mont_pow(out, base, e, ne, &c, scratch);
    free(scratch);
    mont_free(&c);
    return 0;
}

typedef struct {
    const uint64_t *bases, *e;
    int64_t ne;
    const mont_ctx *c;
    uint64_t *out;
} pow_batch_ctx;

static int64_t pow_items(void *arg, int64_t lo, int64_t hi)
{
    pow_batch_ctx *p = (pow_batch_ctx *)arg;
    int64_t n = p->c->n, i;
    uint64_t *scratch = malloc(sizeof(uint64_t) * pow_scratch_limbs(n));
    if (!scratch) return lo;
    for (i = lo; i < hi; i++) mont_pow(p->out + i * n, p->bases + i * n, p->e, p->ne, p->c, scratch);
    free(scratch);
    return -1;
}

/* out[i] = bases[i]^e mod m for count bases of n limbs each, over
 * n_threads threads. Returns 0, SDA_ERR_EVEN or SDA_ERR_NOMEM. */
int64_t sda_mod_exp_batch(const uint64_t *bases, int64_t count, const uint64_t *e, int64_t ne,
                          const uint64_t *m, int64_t n, uint64_t *out, int n_threads)
{
    mont_ctx c;
    pow_batch_ctx p;
    int64_t fail;
    if (n < 1 || !(m[0] & 1)) return SDA_ERR_EVEN;
    if (count <= 0) return 0;
    if (mont_setup(&c, m, n) != 0) return SDA_ERR_NOMEM;
    p.bases = bases; p.e = e; p.ne = ne; p.c = &c; p.out = out;
    fail = run_chunked(pow_items, &p, count, n_threads);
    mont_free(&c);
    return fail == -1 ? 0 : SDA_ERR_NOMEM;
}
